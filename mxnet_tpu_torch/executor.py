"""Executor — binds a Symbol to arrays and runs it.

Counterpart of ``mxnet_tpu/executor.py``: ``build_graph_fn``
(``:47-85``) lowers the Symbol DAG to one Python function over tensors,
and ``Executor.forward(is_train=True)`` runs it under autograd.
``backward(out_grads=None)`` seeds loss heads with ones (their backward
ignores the seed), fills ``grad_dict`` and honours ``grad_req``
``write``/``add``/``null`` (``:91-126``, ``:267-360``);
``copy_params_from``, ``reshape`` and ``debug_str`` (``:382-427``).

Randomness (``:55``, ``:69-70``, ``:278``): ``forward`` draws one step
key from ``random.next_key``, and every node registered ``needs_rng``
gets its own generator on its data's device, seeded with
``random.sub_key(step_key, node_index)``, ``node_index`` its position in
``symbol._topo()``.  The backward walks the forward's autograd graph,
so a mask is drawn once a forward and the backward reuses it.

Where the JAX package jits one fused forward+backward XLA program, the
port runs eagerly: forward records the autograd graph of the arguments
that need a gradient, and backward walks it once.  ``_run`` and
``_backprop`` are the two halves over the bound arrays, which the
Module's fused step (``module/fused_step.py``) runs as one function,
with ``random.Streams`` in place of the step key.

``MXNET_BACKWARD_DO_MIRROR=1`` (read at bind; ``:127-132``, where the
JAX executor wraps the training forward in ``jax.checkpoint``) runs
the training forward under ``torch.utils.checkpoint`` (non-reentrant):
it keeps no activation but the inputs, and ``_backprop`` runs the
forward again before it walks the graph, so each kernel's forward runs
twice a step (B1's forward launches double; the backward launches stay).
The aux states are written back once, after the first run (the
recomputation's are dropped).  A random node's draws are the one thing
kept: a graph with random nodes is checkpointed selectively
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``), so
every seeded random op (``torch.Tag.nondeterministic_seeded``) hands
the recomputation the tensor the forward drew.  Its own seed
(``sub_key(step_key, i)``) would redraw the same tensor from a fresh
generator, but the fused step's persistent generators (``Streams``),
registered with a CUDA graph, cannot be rewound inside a capture.

``set_monitor_callback(fn)`` taps the forward (``:366-379``, where the
JAX executor runs a second program over ``get_internals()``): the same
run hands every node's output, variables included, to ``fn(name,
NDArray)`` in the order and under the names of
``get_internals().list_outputs()``.

Both halves run with cuDNN held to its deterministic algorithms
(``_cudnn_algorithms``): its default ones (a weight gradient split
over atomic adds) sum in no fixed order, so two runs of one step, eager
or under a CUDA graph, part by more than float32's rounding after a few
steps of a BatchNorm net; with them one step gives one result, and the
eager and graphed steps are equal bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from . import engine as _engine
from . import random as _random
from .base import MXNetError, get_env
from .context import Context
from .ndarray import NDArray, torch_dtype, zeros as nd_zeros
from .ops.registry import OpContext, get_op

__all__ = ["Executor", "simple_bind", "build_graph_fn"]


@contextlib.contextmanager
def _cudnn_algorithms():
    """cuDNN kept to its deterministic algorithms while the graph runs
    (the setting is the process's: restored after)."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = before


def _keep_random_draws():
    """Selective-checkpoint contexts that keep what every seeded random
    op draws in the forward for the recomputation, and recompute the
    rest."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        if torch.Tag.nondeterministic_seeded in op.tags:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def build_graph_fn(symbol):
    """Lower a Symbol DAG into ``f(arg_dict, aux_dict, rng, is_train,
    device=None, tap=None) -> (outputs, new_aux_dict)`` over tensors
    (``tap(values)``, when given, sees every node output at the end, a
    dict keyed ``(id(node), output index)``).  ``rng`` is
    the step key (an int; None draws ``random.next_key()``): node ``i``
    of ``_topo()`` registered ``needs_rng`` draws from a generator seeded
    with ``random.sub_key(rng, i)`` on its first input's device.  With a
    ``random.Streams`` it draws from that one's persistent generator
    keyed ``sub_key(streams.base_key, i)``.  A node without inputs
    (``_arange``, a sampler) runs on ``device``, by default the
    arguments' (the CPU when there are none)."""
    nodes = symbol._topo()
    out_refs = [(id(n), i) for n, i in symbol._outputs]

    def fn(arg_dict, aux_dict, rng, is_train: bool, device=None, tap=None):
        if device is None:
            device = next((t.device for t in arg_dict.values()),
                          torch.device("cpu"))
        vals: Dict[tuple, Any] = {}
        new_aux: Dict[str, Any] = {}
        for index, n in enumerate(nodes):
            if n.is_variable:
                vals[(id(n), 0)] = arg_dict[n.name]
                continue
            op = n.opdef()
            inputs = [vals[(id(i), ix)] for i, ix in n.inputs]
            aux_names = n.aux_names()
            where = inputs[0].device if inputs else device
            op_ctx = OpContext(is_train=is_train, device=where)
            if op.needs_rng:
                if isinstance(rng, _random.Streams):
                    op_ctx.key = _random.sub_key(rng.base_key, index)
                    op_ctx.rng = rng.generator(op_ctx.key, where)
                    op_ctx.streams = rng
                else:
                    if rng is None:
                        rng = _random.next_key()
                    op_ctx.key = _random.sub_key(rng, index)
                    op_ctx.rng = _random.key_generator(op_ctx.key, where)
            if aux_names:
                outs, aux_out = op.compute(op_ctx, n.attrs, inputs,
                                           [aux_dict[a] for a in aux_names])
                new_aux.update(zip(aux_names, aux_out))
            else:
                outs = op.compute(op_ctx, n.attrs, inputs, [])
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for i, o in enumerate(outs):
                vals[(id(n), i)] = o
        if tap is not None:
            tap(vals)
        return [vals[r] for r in out_refs], new_aux

    return fn


def _req_dict(grad_req, names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(names, grad_req))
    return {n: grad_req.get(n, "null") for n in names}


class Executor:
    """A bound graph: ``arg_dict``/``grad_dict``/``aux_dict`` of
    NDArrays on one device, ``forward``/``backward``/``outputs``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        self.arg_dict: Dict[str, NDArray] = self._to_dict(
            args, self.arg_names, "args")
        self.aux_dict: Dict[str, NDArray] = self._to_dict(
            aux_states, self.aux_names, "aux_states") \
            if self.aux_names else {}

        self.grad_req = _req_dict(grad_req, self.arg_names)
        for n, r in self.grad_req.items():
            if r not in ("write", "add", "null"):
                raise MXNetError(f"grad_req {r!r} for {n!r} (write, add "
                                 f"or null)")
        self.grad_dict: Dict[str, NDArray] = {} if args_grad is None \
            else self._to_dict(args_grad, self.arg_names, "args_grad",
                               allow_missing=True)
        for n in self.arg_names:
            if n not in self.grad_dict:
                self.grad_req[n] = "null"
        self._grad_names = [n for n in self.arg_names
                            if self.grad_req[n] != "null"]
        self._graph_fn = build_graph_fn(symbol)
        self._do_mirror = bool(get_env("MXNET_BACKWARD_DO_MIRROR", 0, int))
        self._has_rng = any(not n.is_variable and get_op(n.op).needs_rng
                            for n in symbol._topo())
        # the monitor's callback and (name, value key) of every internal
        # output, in get_internals() order
        self._monitor_callback = None
        self._monitor_refs = None
        self.outputs_cache: List[NDArray] = []
        # (outputs with their autograd graph, the leaves that need grad)
        self._train_graph = None

    def _to_dict(self, values, names, what, allow_missing=False):
        if values is None:
            raise MXNetError(f"{what} must be provided")
        if isinstance(values, dict):
            d = {}
            for n in names:
                if n in values:
                    d[n] = values[n]
                elif not allow_missing:
                    raise MXNetError(f"{what} missing entry for {n!r}")
            return d
        values = list(values)
        if len(values) != len(names):
            raise MXNetError(f"{what} length {len(values)} != expected "
                             f"{len(names)}")
        return {n: v for n, v in zip(names, values) if v is not None}

    def _outputs_all_loss_heads(self) -> bool:
        """True when all-ones head gradients are safe: every output is a
        loss head, whose backward ignores the head gradient."""
        return all(not node.is_variable
                   and get_op(node.op).loss_head(node.attrs)
                   for node, _ in self._symbol._outputs)

    @property
    def outputs(self) -> List[NDArray]:
        return self.outputs_cache

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self.aux_names]

    def _write_inputs(self, kwargs):
        """Copy ``kwargs`` into the bound arguments of those names."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown forward argument {k!r}")
            self.arg_dict[k][:] = v

    def _run(self, is_train, rng):
        """The graph over the bound arrays, the aux states written back
        → (outputs, leaves): with ``is_train`` the arguments that need a
        gradient are traced, and ``leaves`` maps their names to the
        traced tensors; otherwise ``leaves`` is None.  ``rng`` as in
        ``build_graph_fn``."""
        trace = bool(is_train) and bool(self._grad_names)
        args = {}
        leaves = {}
        for n, a in self.arg_dict.items():
            t = a._data
            if trace and n in self._grad_names:
                t = t.detach().requires_grad_(True)
                leaves[n] = t
            args[n] = t
        aux = {n: a._data for n, a in self.aux_dict.items()}
        tapped = {}
        tap = None
        if self._monitor_callback is not None:
            def tap(vals):
                if not tapped:  # the forward's, not a recomputation's
                    tapped.update(vals)
        device = self._ctx.torch_device()
        with torch.set_grad_enabled(trace), _cudnn_algorithms():
            if trace and self._do_mirror:
                outs, new_aux = self._mirrored(args, aux, rng, leaves,
                                               device, tap)
            else:
                outs, new_aux = self._graph_fn(args, aux, rng,
                                               bool(is_train), device, tap)
        for name, val in new_aux.items():
            if val is not self.aux_dict[name]._data:  # an op left it as is
                self.aux_dict[name][:] = val
        if tap is not None:
            for name, key in self._monitor_refs:
                self._monitor_callback(
                    name, NDArray(tapped[key].detach(), self._ctx))
        return outs, (leaves if trace else None)

    def _mirrored(self, args, aux, rng, leaves, device, tap):
        """The training forward under ``torch.utils.checkpoint``: run now
        keeping only its inputs, and again in the backward."""
        from torch.utils.checkpoint import checkpoint

        names = list(leaves)

        def forward(*traced):
            full = dict(args)
            full.update(zip(names, traced))
            return self._graph_fn(full, aux, rng, True, device, tap)

        kwargs = {"context_fn": _keep_random_draws} if self._has_rng \
            else {}
        return checkpoint(forward, *[leaves[n] for n in names],
                          use_reentrant=False, preserve_rng_state=False,
                          **kwargs)

    def _backprop(self, outs, leaves, heads):
        """Walk the traced graph of ``outs`` once from ``heads`` and
        write each leaf's gradient into ``grad_dict`` per ``grad_req``."""
        names = list(leaves)
        # an output that depends on no parameter (a MakeLoss over a
        # target, grad_scale 0) contributes nothing
        live = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        with _cudnn_algorithms():
            grads = torch.autograd.grad(
                [o for o, _ in live], [leaves[n] for n in names],
                grad_outputs=[h for _, h in live], allow_unused=True) \
                if live else [None] * len(names)
        with torch.no_grad():
            for name, g in zip(names, grads):
                dst = self.grad_dict[name]._data
                if g is None:  # the output does not depend on it
                    if self.grad_req[name] == "write":
                        dst.zero_()
                elif self.grad_req[name] == "add":
                    dst.add_(g.to(dst.dtype))
                else:
                    dst.copy_(g)

    def forward(self, is_train: bool = False, **kwargs):
        """Write ``kwargs`` into the bound arguments and run the graph;
        with ``is_train`` the arguments that need a gradient are traced
        for ``backward``."""
        self._write_inputs(kwargs)
        self._train_graph = None
        outs, leaves = self._run(is_train, _random.next_key())
        if leaves is not None:
            self._train_graph = (outs, leaves)
        self.outputs_cache = [NDArray(o.detach(), self._ctx) for o in outs]
        _engine.sync_if_naive(self.outputs_cache)
        return self.outputs_cache

    def backward(self, out_grads=None):
        """Gradients of the last ``forward(is_train=True)`` into
        ``grad_dict`` per ``grad_req``.  Without ``out_grads`` every
        output must be a loss head; the graph is walked once."""
        if not self._grad_names:
            return
        if self._train_graph is None:
            raise MXNetError("backward() called before forward(is_train="
                             "True), or twice for one forward")
        outs, leaves = self._train_graph
        if out_grads is None:
            if not self._outputs_all_loss_heads():
                raise MXNetError(
                    "backward() without out_grads requires every output to "
                    "be a loss head (SoftmaxOutput/SoftmaxCELoss); pass "
                    "explicit out_grads for non-loss outputs")
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise MXNetError(f"out_grads has {len(out_grads)} entries "
                                 f"for {len(outs)} outputs")
            heads = [g._data if isinstance(g, NDArray)
                     else torch.as_tensor(g) for g in out_grads]
            heads = [h.to(device=o.device, dtype=o.dtype)
                     for h, o in zip(heads, outs)]
        self._train_graph = None
        self._backprop(outs, leaves, heads)
        _engine.sync_if_naive([self.grad_dict[n] for n in self._grad_names])

    def forward_backward(self, **kwargs):
        outs = self.forward(is_train=True, **kwargs)
        self.backward()
        return outs

    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` for every internal output of each
        later forward (None removes it)."""
        self._monitor_callback = callback
        if callback is not None and self._monitor_refs is None:
            internals = self._symbol.get_internals()
            self._monitor_refs = [
                (name, (id(node), i)) for name, (node, i) in
                zip(internals.list_outputs(), internals._outputs)]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Write ``arg_params`` (and ``aux_params``), name → NDArray or
        array, into the bound arrays of those names, each keeping its
        device and dtype (``mxnet_tpu/executor.py:382``).  A name the
        executor lacks raises unless ``allow_extra_params``."""
        for params, bound, what in ((arg_params, self.arg_dict, "arguments"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux states")):
            for k, v in params.items():
                if k in bound:
                    bound[k][:] = v
                elif not allow_extra_params:
                    raise MXNetError(f"Found name {k!r} not in executor "
                                     f"{what}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs) -> "Executor":
        """A new executor for the input shapes in ``kwargs``: an array
        whose shape stays is the same NDArray (the parameters are
        shared), one whose shape changes is a fresh zero array, which
        only a name in ``kwargs`` may have unless ``partial_shaping``
        (``mxnet_tpu/executor.py:397``)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("insufficient shapes for reshape")

        def keep_or_new(old, shape):
            return old if tuple(old.shape) == tuple(shape) \
                else nd_zeros(shape, self._ctx, old._data.dtype)

        new_args, new_grads = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            old = self.arg_dict[name]
            if tuple(old.shape) != tuple(shape) and not partial_shaping \
                    and name not in kwargs:
                raise MXNetError(f"reshape changed shape of {name!r}; pass "
                                 f"partial_shaping=True")
            new_args[name] = keep_or_new(old, shape)
            if name in self.grad_dict:
                new_grads[name] = keep_or_new(self.grad_dict[name], shape)
        new_aux = {name: keep_or_new(self.aux_dict[name], shape)
                   for name, shape in zip(self.aux_names, aux_shapes or [])}
        return Executor(self._symbol, self._ctx, new_args, new_grads or None,
                        self.grad_req, new_aux or None)

    def debug_str(self) -> str:
        """The bound symbol's ``debug_str``."""
        return self._symbol.debug_str()


def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                shared_exec=None, **kwargs) -> Executor:
    """Allocate every array from the inferred shapes and types on
    ``ctx`` and bind.  With ``shared_exec``, an argument, gradient or aux
    array whose name, shape and dtype match the donor's is the donor's
    NDArray object itself (one storage for the parameters of bucketed
    executors); the others are fresh."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError(f"cannot infer shapes from {kwargs}")
    arg_types, _, aux_types = symbol.infer_type(**(type_dict or {}))
    arg_names = symbol.list_arguments()
    ctx = ctx if isinstance(ctx, Context) else Context(ctx)
    req = _req_dict(grad_req, arg_names)

    def alloc(pool, name, shape, dt):
        old = None if shared_exec is None \
            else getattr(shared_exec, pool).get(name)
        if old is not None and old.shape == tuple(shape) \
                and old._data.dtype == torch_dtype(dt):
            return old
        return nd_zeros(shape, ctx, dt)

    args, args_grad = {}, {}
    for name, shape, dt in zip(arg_names, arg_shapes, arg_types):
        args[name] = alloc("arg_dict", name, shape, dt)
        if req.get(name, "null") != "null":
            args_grad[name] = alloc("grad_dict", name, shape, dt)
    aux = {name: alloc("aux_dict", name, shape, dt)
           for name, shape, dt in zip(symbol.list_auxiliary_states(),
                                      aux_shapes, aux_types)}
    return Executor(symbol, ctx, args, args_grad or None, req, aux or None)
