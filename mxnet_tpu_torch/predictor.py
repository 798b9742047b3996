"""Standalone inference: the predict API and exported artifacts.

Counterpart of ``mxnet_tpu/predictor.py`` (the reference's C predict
API, ``c_predict_api.cc``, and its amalgamation):

* ``Predictor`` — the ``MXPredCreate / SetInput / Forward / GetOutput``
  workflow over a saved ``(symbol.json, .params)`` checkpoint (either
  package's files: the formats are the same bytes): the executor's
  graph function over weights held on the context's device, run without
  gradients, with no Module, optimizer or iterator.
* ``export_model`` / ``load_exported`` — the amalgamation: the JAX
  package's artifact layout (a magic, an 8-byte header length, a JSON
  header naming the inputs, their shapes and dtypes and the outputs)
  under the port's own magic, followed by a ``torch.export.save``
  program with the weights embedded.  A graph of plain ops loads and
  runs with ``torch`` alone.  A graph that reaches one of the port's
  hand-written kernels raises at export: tracing would record the
  kernel's plain version in its place (ROADMAP.md queue A item 13).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Predictor", "export_model", "load_exported"]

_MAGIC = b"MXTORCHEXP1"


def _tensor(v, device, dtype=None) -> torch.Tensor:
    """An NDArray, tensor or array as a tensor on ``device``."""
    from .ndarray import NDArray

    if isinstance(v, NDArray):
        t = v._data
    elif isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.from_numpy(np.array(v))
    return t.detach().to(device=device, dtype=dtype or t.dtype, copy=True)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host (bf16 as float32, as
    ``NDArray.asnumpy``)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _split_params(params, aux_names):
    """{(kind, name): value} from a ``.params`` path (``arg:`` / ``aux:``
    prefixes) or an in-memory dict (aux states recognized by name)."""
    from . import ndarray as nd

    if isinstance(params, (str, bytes)):
        out = {}
        for k, v in nd.load(params).items():
            tag, name = k.split(":", 1) if ":" in k else ("arg", k)
            out[("aux" if tag == "aux" else "arg", name)] = v
        return out
    aux_set = set(aux_names)
    return {(("aux" if k in aux_set else "arg"), k): v
            for k, v in params.items()}


def kernel_ops(symbol):
    """The op names of ``symbol``'s nodes that reach a hand-written
    kernel of the port (registered ``kernel=``: ``ops/registry.py``)."""
    found = []
    for n in symbol._topo():
        if n.is_variable:
            continue
        op = n.opdef()
        if op.launches_kernel(n.attrs) and op.name not in found:
            found.append(op.name)
    return found


class Predictor:
    """The reference's ``MXPredCreate`` workflow (``c_predict_api.cc``).

    ``symbol``: a Symbol, a ``-symbol.json`` path or a JSON string;
    ``params``: a dict of arrays (aux states recognized by name) or a
    ``.params`` path (``arg:`` / ``aux:`` prefixes); ``input_shapes``:
    {name: shape}, the inputs are exactly these names (every other
    argument must come from ``params``: a missing or misshapen one
    raises); ``ctx``: the device the weights live on and the forward
    runs on (default ``current_context()``, ``gpu(0)``); ``input_dtypes``:
    {name: dtype} (default float32)."""

    def __init__(self, symbol, params, input_shapes, ctx=None,
                 input_dtypes=None):
        from . import symbol as sym_mod
        from .context import current_context
        from .executor import build_graph_fn

        if isinstance(symbol, str):
            symbol = sym_mod.load(symbol) if os.path.exists(symbol) \
                else sym_mod.load_json(symbol)
        self._symbol = symbol
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        params = _split_params(params, aux_names)
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        self._input_names = [n for n in arg_names if n in input_shapes]
        input_dtypes = input_dtypes or {}
        arg_shapes, _, aux_shapes = symbol.infer_shape(
            **{n: tuple(s) for n, s in input_shapes.items()})
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from the given inputs")

        def get(kind, name, shape):
            v = params.get((kind, name))
            if v is None:
                raise MXNetError(f"missing parameter {name!r}")
            t = _tensor(v, self._device)
            if tuple(t.shape) != tuple(shape):
                raise MXNetError(f"param {name!r} shape {tuple(t.shape)} != "
                                 f"expected {tuple(shape)}")
            return t

        self._weights = {n: get("arg", n, s)
                         for n, s in zip(arg_names, arg_shapes)
                         if n not in self._input_names}
        self._aux = {n: get("aux", n, s)
                     for n, s in zip(aux_names, aux_shapes)}
        shapes = dict(zip(arg_names, arg_shapes))
        self._input_shapes = {n: tuple(shapes[n]) for n in self._input_names}
        self._input_dtypes = {n: np.dtype(input_dtypes.get(n, np.float32))
                              for n in self._input_names}
        self.output_names = symbol.list_outputs()
        self._graph_fn = build_graph_fn(symbol)
        self._fn = self.forward_closure()
        self._inputs = {}
        self._outputs = None

    def set_params(self, params):
        """Swap the weights and aux states in place: ``params`` is a
        name → array dict (extra names ignored) holding every served
        name at its bound shape, else it raises and installs nothing.
        The values are copied into the tensors the forward reads, so a
        closure or a CUDA graph made before the swap serves the new
        weights."""
        served = {**self._weights, **self._aux}
        new = {}
        for name, old in served.items():
            v = params.get(name)
            if v is None:
                raise MXNetError(f"set_params: missing parameter {name!r}")
            t = _tensor(v, old.device, old.dtype)
            if t.shape != old.shape:
                raise MXNetError(f"set_params: param {name!r} shape "
                                 f"{tuple(t.shape)} != bound "
                                 f"{tuple(old.shape)}")
            new[name] = t
        with torch.no_grad():
            for name, t in new.items():
                served[name].copy_(t)
        self._outputs = None

    def forward_closure(self):
        """``forward({input_name: tensor}) -> [output tensors]`` over the
        served weights: the executor's graph function at inference
        (``is_train=False``, a fixed step key, no gradient, cuDNN held to
        its deterministic algorithms as the executor holds it).  Any
        batch size: ``serving.InferenceEngine`` captures one a bucket."""
        from .executor import _cudnn_algorithms

        graph_fn, weights, aux = self._graph_fn, self._weights, self._aux
        device = self._device

        def forward(inputs):
            full = dict(weights)
            full.update(inputs)
            with torch.no_grad(), _cudnn_algorithms():
                outs, _ = graph_fn(full, aux, 0, False, device)
            return outs

        return forward

    # -- the reference's workflow ---------------------------------------
    def set_input(self, name, data):
        """MXPredSetInput."""
        if name not in self._input_shapes:
            raise MXNetError(f"unknown input {name!r}; inputs are "
                             f"{sorted(self._input_shapes)}")
        arr = np.asarray(getattr(data, "asnumpy", lambda: data)(),
                         dtype=self._input_dtypes[name])
        if tuple(arr.shape) != self._input_shapes[name]:
            raise MXNetError(f"input {name!r} shape {arr.shape} != bound "
                             f"{self._input_shapes[name]}")
        self._inputs[name] = _tensor(arr, self._device)

    def forward(self, **inputs):
        """MXPredForward; inputs may also be passed as keywords."""
        for k, v in inputs.items():
            self.set_input(k, v)
        missing = set(self._input_shapes) - set(self._inputs)
        if missing:
            raise MXNetError(f"inputs not set: {sorted(missing)}")
        self._outputs = self._fn(self._inputs)
        return self

    def get_output(self, index=0) -> np.ndarray:
        """MXPredGetOutput, as numpy."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return _host(self._outputs[index])

    @staticmethod
    def from_checkpoint(prefix, epoch, input_shapes, ctx=None,
                        input_dtypes=None):
        """Load ``prefix-symbol.json`` and ``prefix-%04d.params``."""
        return Predictor(f"{prefix}-symbol.json",
                         "%s-%04d.params" % (prefix, epoch), input_shapes,
                         ctx=ctx, input_dtypes=input_dtypes)


class _Frozen(torch.nn.Module):
    """The forward ``torch.export`` traces: the inputs positionally, the
    weights and aux states as buffers (embedded in the program)."""

    def __init__(self, graph_fn, input_names, weights, aux):
        super().__init__()
        self._graph_fn, self._names = graph_fn, list(input_names)
        self._w, self._a = list(weights), list(aux)
        for i, t in enumerate(list(weights.values()) + list(aux.values())):
            self.register_buffer(f"p{i}", t)

    def forward(self, *inputs):
        bufs = [getattr(self, f"p{i}")
                for i in range(len(self._w) + len(self._a))]
        full = dict(zip(self._w, bufs[:len(self._w)]))
        full.update(zip(self._names, inputs))
        aux = dict(zip(self._a, bufs[len(self._w):]))
        outs, _ = self._graph_fn(full, aux, 0, False, torch.device("cpu"))
        return tuple(outs)


def export_model(symbol, arg_params, aux_params, input_shapes, path=None,
                 input_dtypes=None) -> bytes:
    """Serialize the frozen forward as a standalone artifact: the header
    then a ``torch.export`` program over the inputs (in argument order)
    with the weights embedded, traced on the CPU.  Returns the bytes and
    writes them to ``path`` when given.  A graph whose ops reach a
    kernel of the port raises, naming them."""
    from .executor import build_graph_fn

    found = kernel_ops(symbol)
    if found:
        raise MXNetError(
            f"export_model: the graph reaches the port's hand-written "
            f"kernels through {found}; tracing would record their plain "
            f"versions instead (exporting kernel graphs: ROADMAP.md queue "
            f"A item 13)")
    cpu = torch.device("cpu")
    arg_names = symbol.list_arguments()
    input_names = [n for n in arg_names if n in input_shapes]
    input_dtypes = {n: np.dtype((input_dtypes or {}).get(n, np.float32))
                    for n in input_names}
    weights = {n: _tensor(v, cpu) for n, v in arg_params.items()
               if n in arg_names and n not in input_names}
    aux = {n: _tensor(v, cpu) for n, v in (aux_params or {}).items()}
    module = _Frozen(build_graph_fn(symbol), input_names, weights, aux)
    example = tuple(torch.zeros(tuple(input_shapes[n]),
                                dtype=torch.from_numpy(
                                    np.zeros(0, input_dtypes[n])).dtype)
                    for n in input_names)
    with torch.no_grad():
        program = torch.export.export(module, example, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = json.dumps({
        "inputs": input_names,
        "input_shapes": {n: list(input_shapes[n]) for n in input_names},
        "input_dtypes": {n: input_dtypes[n].name for n in input_names},
        "outputs": symbol.list_outputs()}).encode()
    blob = (_MAGIC + len(header).to_bytes(8, "little") + header
            + buf.getvalue())
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes):
    """An exported artifact → (call_fn, meta): ``call_fn(*inputs)``
    (tensors, in ``meta["inputs"]`` order) returns the outputs.  Needs
    only torch:

        raw = open(p, 'rb').read()
        n = int.from_bytes(raw[11:19], 'little')
        fn = torch.export.load(io.BytesIO(raw[19 + n:])).module()
    """
    raw = (open(path_or_bytes, "rb").read()
           if isinstance(path_or_bytes, str) else bytes(path_or_bytes))
    if not raw.startswith(_MAGIC):
        raise MXNetError("not an mxnet_tpu_torch exported artifact")
    off = len(_MAGIC)
    hlen = int.from_bytes(raw[off:off + 8], "little")
    meta = json.loads(raw[off + 8:off + 8 + hlen].decode())
    program = torch.export.load(io.BytesIO(raw[off + 8 + hlen:]))
    return program.module(), meta
