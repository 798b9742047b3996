"""Symbol — the symbolic graph API.

Counterpart of ``mxnet_tpu/symbol.py``: ``Variable`` (with ``shape``,
``dtype``, ``init`` and ``attr``), ``Group``, op functions generated
from the port's registry (a variadic op counts its inputs into
``num_args``), ``+``/``-``/``*``/``/``/``**`` of two symbols or of a
symbol and a number (the scalar ops, ``-s`` as ``_mul_scalar(-1)``),
outputs by index or name, ``get_internals``/``get_children``,
``list_arguments``/``list_outputs``/``list_auxiliary_states``,
``infer_shape``/``infer_shape_partial``/``infer_type``, ``attr``/
``attr_dict``, ``debug_str``, ``_topo``, ``bind``, ``simple_bind`` and
``eval``, ``zeros``/``ones``/``arange``, and the JSON form
(``tojson``/``save``, ``load_json``/``load``, ``mxnet_tpu/symbol.py:
437-465, 631-655``), which each package loads from the other.  A
Symbol is a DAG of nodes, each a variable (``op=None``) or an operator
application; the executor lowers it to one Python function over
tensors, and autograd differentiates it.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .attribute import AttrScope
from .base import (MXNetError, attr_shape, attrs_to_str, not_ported,
                   numeric_types)
from .name import NameManager
from . import ops as _ops  # noqa: F401  (registers the port's ops)
from .ops import registry as _reg

__all__ = ["Symbol", "Variable", "Group", "var", "load", "load_json",
           "zeros", "ones", "arange"]

# the generated op functions (slice, sum, max, ...) shadow builtins in
# this module's namespace; code here uses these
_py_slice = slice

# the node attrs that are not operator parameters (the JAX package's
# ``_META_ATTRS``): kept in ``_Node._meta`` by ``load_json``
_META_ATTRS = {
    "ctx_group", "lr_mult", "wd_mult", "__init__", "__shape__", "__dtype__",
    "force_mirroring", "__force_mirroring__",
}


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "_meta")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, str],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op  # None for variables
        self.name = name
        self.attrs = attrs  # operator parameter attrs (strings)
        self.inputs = inputs
        self._meta: Dict[str, str] = {}  # lr_mult, __init__, __shape__ ...

    @property
    def is_variable(self):
        return self.op is None

    def opdef(self):
        return _reg.get_op(self.op)

    def num_outputs(self) -> int:
        if self.is_variable:
            return 1
        return len(self.opdef().output_names(self.attrs))

    def aux_names(self) -> List[str]:
        if self.is_variable:
            return []
        return [f"{self.name}_{a}"
                for a in self.opdef().auxiliary_names(self.attrs)]


def _topo_order(heads: Sequence[_Node]) -> List[_Node]:
    seen = set()
    order: List[_Node] = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for h in heads:
        visit(h)
    return order


class Symbol:
    """A (possibly multi-output) symbolic expression."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    # -- structure ---------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _head_nodes(self) -> List[_Node]:
        out, seen = [], set()
        for n, _ in self._outputs:
            if id(n) not in seen:
                seen.add(id(n))
                out.append(n)
        return out

    def _topo(self) -> List[_Node]:
        return _topo_order(self._head_nodes())

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                outs = node.opdef().output_names(node.attrs)
                names.append(f"{node.name}_{outs[idx]}")
        return names

    def list_auxiliary_states(self) -> List[str]:
        names = []
        for n in self._topo():
            names.extend(n.aux_names())
        return names

    def __repr__(self):
        return f"<Symbol {self.name or 'Grouped'}>"

    # -- attributes ----------------------------------------------------------
    def attr(self, key: str) -> Optional[str]:
        """Attribute ``key`` of the (first) output's node: a symbol
        attribute (``lr_mult``, ``__shape__``, ...) or an operator
        parameter; None when it has none."""
        node = self._outputs[0][0]
        return node._meta.get(key) or node.attrs.get(key)

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        ret = {}
        for n in self._topo():
            d = dict(n.attrs)
            d.update(n._meta)
            if d:
                ret[n.name] = d
        return ret

    def get_internals(self) -> "Symbol":
        """Every output of every node (variables included) as one grouped
        symbol, indexable by output name."""
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs())])

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of the (first) output's node, grouped; None for a
        variable."""
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index) -> "Symbol":
        """One output by position or name, or a slice of them."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"cannot find output {index!r} in {names}")
            index = names.index(index)
        if isinstance(index, _py_slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op_name, scalar_op, rscalar_op=None, rev=False):
        """``op_name`` of two symbols; with a number, ``scalar_op`` (or
        ``rscalar_op`` for the reflected form) with attr ``scalar``, as
        the JAX package builds it (``mxnet_tpu/symbol.py:240-260``)."""
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if rev else (self, other)
            return _create_symbol(op_name, [lhs, rhs], {})
        if isinstance(other, numeric_types):
            name = rscalar_op if (rev and rscalar_op) else scalar_op
            return _create_symbol(name, [self], {"scalar": str(float(other))})
        raise TypeError(f"unsupported operand {type(other)}")

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    def __radd__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar", rev=True)

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar",
                           "_rminus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar",
                           "_rminus_scalar", rev=True)

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar", rev=True)

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar",
                           "_rdiv_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar",
                           "_rdiv_scalar", rev=True)

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar", "_rpower_scalar")

    def __neg__(self):
        return self._binop(-1.0, "elemwise_mul", "_mul_scalar")

    # -- shape / type inference ------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes given by
        position or name; (None, None, None) when underdetermined."""
        return self._infer_shape(False, args, kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape`` that returns what it could infer, None in
        place of each shape it could not."""
        return self._infer_shape(True, args, kwargs)

    def _infer_shape(self, partial, args, kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})

        nodes = self._topo()
        shapes: Dict[Tuple[int, int], Optional[tuple]] = {}
        aux_shapes: Dict[str, Optional[tuple]] = {}
        var_shapes: Dict[str, Optional[tuple]] = {}
        for n in nodes:
            if n.is_variable:
                s = known.get(n.name)
                if s is None and "__shape__" in n._meta:
                    s = attr_shape(n._meta["__shape__"])
                var_shapes[n.name] = s

        changed = True
        iters = 0
        while changed and iters < 4:
            changed = False
            iters += 1
            for n in nodes:
                if n.is_variable:
                    shapes[(id(n), 0)] = var_shapes.get(n.name)
                    continue
                op = n.opdef()
                if op.infer_shape is None:
                    raise not_ported(f"shape inference of {op.name}")
                in_shapes = [shapes.get((id(i), ix)) for i, ix in n.inputs]
                ins, outs, auxs = op.infer_shape(n.attrs, in_shapes)
                # write back newly determined input shapes (weights)
                for (inode, iidx), s_new in zip(n.inputs, ins):
                    if shapes.get((id(inode), iidx)) is None \
                            and s_new is not None:
                        shapes[(id(inode), iidx)] = tuple(s_new)
                        if inode.is_variable \
                                and var_shapes.get(inode.name) is None:
                            var_shapes[inode.name] = tuple(s_new)
                            changed = True
                for oi, s_out in enumerate(outs or []):
                    if shapes.get((id(n), oi)) is None and s_out is not None:
                        shapes[(id(n), oi)] = tuple(s_out)
                        changed = True
                for aname, s_aux in zip(n.aux_names(), auxs or []):
                    if s_aux is not None:
                        aux_shapes[aname] = tuple(s_aux)

        arg_shapes = [var_shapes.get(n) for n in arg_names]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._outputs]
        aux_list = [aux_shapes.get(a) for a in self.list_auxiliary_states()]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            return None, None, None
        return arg_shapes, out_shapes, aux_list

    # ops whose inputs deliberately do not share the node dtype
    _TYPE_HETERO_INPUTS = {
        "Embedding": {0},       # token ids; the weight drives the dtype
        "take": {1}, "batch_take": {1}, "one_hot": {0},
        "SoftmaxOutput": {1}, "Softmax": {1}, "SoftmaxCELoss": {1},
        "LinearRegressionOutput": {1}, "LogisticRegressionOutput": {1},
        "MAERegressionOutput": {1}, "SVMOutput": {1},
        "SequenceLast": {1}, "SequenceMask": {1}, "SequenceReverse": {1},
        "ROIPooling": {1},
    }
    # ops whose output dtype comes from an attr, not the inputs
    _TYPE_FROM_ATTR = ("Cast", "cast", "argmax", "argmin", "argsort",
                       "_zeros", "_ones", "_full", "_arange", "one_hot")

    def infer_type(self, *args, **kwargs):
        """Graph dtype inference, forward and backward: a known dtype
        flows to outputs and into untyped homogeneous inputs; variables
        may pin one with ``dtype=``.  Types are dtype names
        ("float32", "bfloat16", ...); the default is float32."""
        from .ndarray import dtype_name

        arg_names = self.list_arguments()
        known: Dict[str, str] = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                known[n] = dtype_name(t)
        known.update({k: dtype_name(v) for k, v in kwargs.items()
                      if v is not None})
        default = "float32"
        nodes = self._topo()
        dtypes: Dict[Tuple[int, int], str] = {}
        for n in nodes:
            if n.is_variable:
                # Variable(dtype=...) keeps its pin in _meta; a loaded
                # symbol's in its attrs
                dt = known.get(n.name, n._meta.get(
                    "__dtype__", n.attrs.get("__dtype__")))
                if dt is not None:
                    dtypes[(id(n), 0)] = dt

        for _ in range(len(nodes)):  # fixed point (graphs are DAGs)
            changed = False
            for n in nodes:
                if n.is_variable:
                    continue
                hetero = self._TYPE_HETERO_INPUTS.get(n.op, set())
                homo_in = [dtypes.get((id(i), ix))
                           for slot, (i, ix) in enumerate(n.inputs)
                           if slot not in hetero]
                node_dt = next((d for d in homo_in if d is not None), None)
                if node_dt is None:
                    node_dt = next(
                        (dtypes[(id(n), i)] for i in range(n.num_outputs())
                         if (id(n), i) in dtypes), None)
                if n.op in self._TYPE_FROM_ATTR:
                    node_dt = dtype_name(n.attrs.get("dtype", "float32"))
                if node_dt is None:
                    continue
                for i in range(n.num_outputs()):
                    if (id(n), i) not in dtypes:
                        dtypes[(id(n), i)] = node_dt
                        changed = True
                if n.op not in self._TYPE_FROM_ATTR:
                    for slot, (i, ix) in enumerate(n.inputs):
                        if slot not in hetero and (id(i), ix) not in dtypes:
                            dtypes[(id(i), ix)] = node_dt
                            changed = True
            if not changed:
                break

        arg_types = [dtypes.get((id(n), 0), default)
                     for n in nodes if n.is_variable]
        out_types = [dtypes.get((id(n), i), default)
                     for n, i in self._outputs]
        aux_types = [default] * len(self.list_auxiliary_states())
        return arg_types, out_types, aux_types

    # -- JSON ------------------------------------------------------------------
    def tojson(self) -> str:
        """The graph as the JAX package's ``Symbol.tojson`` writes it (the
        nnvm JSON layout: nodes in topological order, ``arg_nodes``,
        ``heads``)."""
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_variable else n.op,
                "name": n.name,
                "inputs": [[node_ids[id(i)], ix, 0] for i, ix in n.inputs],
            }
            attrs = dict(n.attrs)
            attrs.update(n._meta)
            if attrs:
                entry["attr"] = attrs
            jnodes.append(entry)
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[node_ids[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_version": ["int", 901],
                      "framework": ["str", "mxnet_tpu"]},
        }, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self) -> str:
        """One line a node in topological order: its op (``Variable``),
        name, inputs and parameters, as the JAX package prints them."""
        return "\n".join(
            f"{'Variable' if n.is_variable else n.op} {n.name}("
            + ", ".join(f"{i.name}[{ix}]" for i, ix in n.inputs)
            + f") {n.attrs}" for n in self._topo())

    # -- binding ---------------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, shared_exec=None):
        """An ``Executor`` over the caller's arrays (``mxnet_tpu/symbol.py:
        469``): ``args``, ``args_grad`` and ``aux_states`` are lists in
        ``list_arguments()`` / ``list_auxiliary_states()`` order or dicts
        by name; gradients land in the ``args_grad`` arrays themselves.
        ``shared_exec`` is taken for the reference's signature: the
        caller's arrays are bound as given, so nothing is shared."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` (name → NDArray) on ``ctx`` and run forward
        once → the outputs."""
        from .context import current_context

        return self.bind(ctx or current_context(), kwargs).forward()

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        from .executor import simple_bind

        return simple_bind(self, ctx, grad_req=grad_req,
                           type_dict=type_dict, shared_exec=shared_exec,
                           **kwargs)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs) -> Symbol:
    """A variable symbol.  ``init`` is an initializer (or its JSON dump)
    that ``Module.init_params`` uses for this variable alone."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = _Node(None, name, {}, [])
    node._meta.update(AttrScope.current().get(attr) or {})
    if shape is not None:
        node._meta["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        node._meta["lr_mult"] = str(lr_mult)
    if wd_mult is not None:
        node._meta["wd_mult"] = str(wd_mult)
    if dtype is not None:
        from .ndarray import dtype_name

        node._meta["__dtype__"] = dtype_name(dtype)
    if init is not None:
        node._meta["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            node._meta[k] = str(v)
        else:
            raise ValueError(f"Variable() got unsupported attribute {k!r}; "
                             "only __dunder__ attrs are accepted")
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """Group symbols into one multi-output symbol."""
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def _create_symbol(op_name: str, input_syms: List[Symbol],
                   attrs: Dict[str, str], name: Optional[str] = None,
                   attr: Optional[Dict[str, str]] = None) -> Symbol:
    op = _reg.get_op(op_name)
    name = NameManager.current().get(name, op.name.lower())
    inputs: List[Tuple[_Node, int]] = []
    for s in input_syms:
        inputs.extend(s._outputs)
    node = _Node(op.name, name, attrs, inputs)
    node._meta.update(AttrScope.current().get(attr) or {})
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_symbol_function(op_name: str):
    op = _reg.get_op(op_name)

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        attrs = attrs_to_str({k: v for k, v in kwargs.items()
                              if not isinstance(v, Symbol)})
        input_names = op.input_names(attrs)
        inputs: List[Symbol] = [a for a in args if isinstance(a, Symbol)]
        for iname in input_names[len(inputs):]:
            if iname in sym_kwargs:
                inputs.append(sym_kwargs.pop(iname))
        if sym_kwargs:
            raise MXNetError(f"{op_name}: unknown inputs {sorted(sym_kwargs)}"
                             f"; expected {input_names}")
        if not inputs and input_names:
            raise MXNetError(f"operator {op_name} requires inputs "
                             f"{input_names}")
        # trailing parameters (weight/bias/gamma/beta) become variables
        if len(inputs) < len(input_names):
            name = name or NameManager.current().get(None, op.name.lower())
            for iname in input_names[len(inputs):]:
                inputs.append(Variable(f"{name}_{iname}"))
        # a variadic op (add_n, Concat) counts its inputs into num_args
        if "num_args" not in attrs and callable(op.arg_names):
            attrs["num_args"] = str(len(inputs))
            if op.input_names(attrs) != [f"arg{i}"
                                         for i in range(len(inputs))]:
                del attrs["num_args"]
        return _create_symbol(op_name, inputs, attrs, name=name, attr=attr)

    fn.__name__ = op_name
    fn.__doc__ = op.doc
    return fn


def load_json(json_str: str) -> Symbol:
    """The Symbol of a ``tojson`` string (either package's, or the legacy
    form with a ``param`` dict per node).  An op the port does not
    register raises here, naming it."""
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        op = jn["op"]
        attrs = dict(jn.get("attr", jn.get("attrs", {})) or {})
        attrs.update(jn.get("param", {}) or {})  # the legacy form
        meta = {k: attrs.pop(k) for k in list(attrs) if k in _META_ATTRS}
        if op != "null":
            try:
                op = _reg.get_op(op).name
            except MXNetError:
                raise MXNetError(
                    f"operator {op!r} (node {jn['name']!r} of a symbol "
                    f"file) is not registered in mxnet_tpu_torch") from None
        node = _Node(None if op == "null" else op, jn["name"], attrs,
                     [(nodes[i[0]], i[1]) for i in jn["inputs"]])
        node._meta = meta
        nodes.append(node)
    heads = data.get("heads", [[len(nodes) - 1, 0, 0]])
    return Symbol([(nodes[h[0]], h[1]) for h in heads])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def zeros(shape, dtype="float32", **kwargs) -> Symbol:
    """A ``_zeros`` node of ``shape``."""
    return _create_symbol("_zeros", [], attrs_to_str({"shape": shape,
                                                      "dtype": dtype}))


def ones(shape, dtype="float32", **kwargs) -> Symbol:
    """A ``_ones`` node of ``shape``."""
    return _create_symbol("_ones", [], attrs_to_str({"shape": shape,
                                                     "dtype": dtype}))


def arange(start, stop=None, step=1.0, repeat=1, name=None,
           dtype="float32") -> Symbol:
    """An ``_arange`` node: ``start, start + step, ...`` below ``stop``
    (``[0, start)`` without it), each ``repeat`` times
    (``mxnet_tpu/symbol.py:624``)."""
    return _create_symbol("_arange", [], attrs_to_str(
        {"start": start, "stop": stop, "step": step, "repeat": repeat,
         "dtype": dtype}), name=name)


def _init_symbol_module():
    mod = sys.modules[__name__]
    for opname in _reg.list_ops():
        if not hasattr(mod, opname):
            setattr(mod, opname, _make_symbol_function(opname))


_init_symbol_module()
