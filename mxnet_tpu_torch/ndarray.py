"""NDArray — the imperative tensor, over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``, holding what the training
path touches: creation (``array``, ``zeros``, ``empty``, ``ones``,
``full``, ``arange``), ``concatenate``, ``asnumpy``, ``wait_to_read``,
``shape``/``dtype``/``context``, ``copy``/``copyto``/``as_in_context``,
``astype``, ``reshape``, ``T``, ``__setitem__`` (how initializers,
``set_params`` and batches write), ``__getitem__`` and ``slice``,
elementwise arithmetic (``%`` floor modulo, ``**``), comparisons giving
0/1 in the array's dtype, ``onehot_encode``, ``waitall``, ``save``/
``load`` (the JAX package's binary format, byte for byte), and the
imperative op namespace: every registered op is ``nd.<name>``
(``imperative_invoke``; forward only, outputs on the inputs' context,
an op without inputs on ``ctx``), with ``uniform``/``normal``/
``random_*`` taking the JAX package's signatures.

An NDArray is a mutable handle on one tensor on one explicit device
(its context).  Writes go into that tensor in place (``x[:] = v``,
``+=``), where the JAX package swaps an immutable buffer; whatever holds
the tensor sees the new value.  Values keep the handle's device and
dtype: a write from another device or dtype is copied and cast.
"""

from __future__ import annotations

import struct
import sys
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .base import MXNetError, attrs_to_str, numeric_types
from .context import Context, cpu, current_context

__all__ = ["NDArray", "array", "zeros", "empty", "ones", "full", "arange",
           "concatenate", "onehot_encode", "waitall", "uniform", "normal",
           "random_uniform", "random_normal", "torch_dtype", "dtype_name",
           "save", "load", "imperative_invoke", "HostBF16",
           "tensor_from_numpy", "tensor_to_host"]

_py_slice = slice

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8,
           "uint16": torch.uint16, "uint32": torch.uint32,
           "bool": torch.bool}
# what ``array`` makes of a 64-bit non-float source when no dtype is
# given: the JAX package runs without x64, so its arrays hold 32 bits
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype) -> str:
    """Canonical name ("float32", "bfloat16", ...) of a dtype given as a
    name, a numpy dtype or type, or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise MXNetError(f"dtype {dtype} is not supported")
        return _NAMES[dtype]
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError(f"dtype {name!r} is not supported; known: "
                         f"{sorted(_DTYPES)}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype_name(dtype)]


def _np_dtype(tdt: torch.dtype):
    """numpy dtype of a torch dtype; bfloat16, which numpy lacks, reads
    back as float32."""
    name = _NAMES.get(tdt, "float32")
    return np.dtype("float32" if name == "bfloat16" else name)


class HostBF16:
    """A bfloat16 array on the host as its bits (``bits``, a uint16
    numpy array): numpy has no bfloat16 of its own, and the port never
    imports ``ml_dtypes``.  ``checkpoint.dumps`` pickles it as an
    ``ml_dtypes.bfloat16`` array; ``checkpoint.loads`` reads such an
    array back as one."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits).view(np.uint16)

    shape = property(lambda self: self.bits.shape)
    dtype = property(lambda self: "bfloat16")

    def tensor(self) -> torch.Tensor:
        """The array as a CPU bfloat16 tensor (a copy)."""
        return torch.from_numpy(self.bits.view(np.int16).copy()) \
            .view(torch.bfloat16)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor copy of a host array: numpy (an ``ml_dtypes``
    bfloat16 array, recognized by its dtype's name, is read through its
    uint16 bits), a ``HostBF16``, or anything ``np.asarray`` takes."""
    if isinstance(arr, HostBF16):
        return arr.tensor()
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return HostBF16(arr.view(np.uint16)).tensor()
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def tensor_to_host(t: torch.Tensor):
    """A host copy of ``t``: a numpy array, or a ``HostBF16`` for
    bfloat16 (the bits, never a widened float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return HostBF16(t.contiguous().view(torch.int16).numpy().copy())
    return t.numpy().copy()


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data", "_ctx", "writable")

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None,
                 writable: bool = True):
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch.Tensor, got "
                            f"{type(data)}")
        self._data = data
        if ctx is None:
            ctx = cpu() if data.device.type == "cpu" \
                else Context("gpu", data.device.index or 0)
        self._ctx = ctx
        self.writable = writable

    # -- properties --------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype (bfloat16 arrays report float32, what
        ``asnumpy`` gives)."""
        return _np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    def __repr__(self):
        return f"<NDArray {'x'.join(map(str, self.shape))} @{self._ctx}>"

    def __len__(self):
        return self.shape[0]

    # -- sync / conversion -------------------------------------------------
    def wait_to_read(self):
        """Block until the work queued on this array's device is done
        (``mxnet_tpu/ndarray.py:106``)."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        return self.asnumpy().reshape(-1)[0]

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone(), self._ctx)

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """A copy on ``other`` (a Context), or written into ``other``
        (an NDArray, keeping its device and dtype)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        if not isinstance(other, NDArray):
            raise TypeError(f"copyto target must be NDArray or Context, "
                            f"got {type(other)}")
        other[:] = self
        return other

    # -- mutation ----------------------------------------------------------
    def _as_tensor(self, value) -> torch.Tensor:
        """``value`` on this array's device, in its dtype."""
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            return value.detach().to(device=self._data.device,
                                     dtype=self._data.dtype)
        arr = value if isinstance(value, HostBF16) else np.asarray(value)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return tensor_from_numpy(arr).to(device=self._data.device,
                                         dtype=self._data.dtype)

    def __setitem__(self, key, value):
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        with torch.no_grad():
            if isinstance(value, numeric_types):
                self._data[key] = value
                return
            v = self._as_tensor(value)
            if key == _py_slice(None) or key is Ellipsis:
                self._data.copy_(v.expand(self._data.shape)
                                 if v.shape != self._data.shape else v)
            else:
                self._data[key] = v

    def __getitem__(self, key) -> "NDArray":
        """Basic indexing gives a view, as MXNet's slicing does: a write
        through it reaches this array."""
        return NDArray(self._data[key], self._ctx)

    def slice(self, start: int, stop: int) -> "NDArray":
        return NDArray(self._data[start:stop], self._ctx)

    def reshape(self, shape) -> "NDArray":
        """A view of ``shape``, with ``Reshape``'s special codes (0, -1,
        -2, -3, -4)."""
        from .ops.matrix import _infer_reshape_shape

        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return NDArray(self._data.reshape(
            _infer_reshape_shape(self.shape, shape)), self._ctx)

    def astype(self, dtype) -> "NDArray":
        """A copy in ``dtype`` (a name, numpy or torch dtype)."""
        return NDArray(self._data.to(torch_dtype(dtype), copy=True),
                       self._ctx)

    def as_in_context(self, context: Context) -> "NDArray":
        """This array when it lies on ``context``, else a copy there."""
        return self if context == self._ctx else self.copyto(context)

    @property
    def T(self) -> "NDArray":
        """The transpose (the axes reversed)."""
        return transpose(self)

    # -- arithmetic ----------------------------------------------------------
    def _other(self, o):
        if isinstance(o, NDArray):
            return o._data
        if isinstance(o, np.ndarray):
            return tensor_from_numpy(o).to(self._data.device)
        return o

    def _binop(self, o, fn, rev=False):
        a, b = self._data, self._other(o)
        return NDArray(fn(b, a) if rev else fn(a, b), self._ctx)

    def __add__(self, o): return self._binop(o, torch.add)
    def __radd__(self, o): return self._binop(o, torch.add, rev=True)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __rsub__(self, o): return self._binop(o, lambda a, b: b - a)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __rmul__(self, o): return self._binop(o, torch.mul, rev=True)
    def __truediv__(self, o): return self._binop(o, torch.div)
    def __rtruediv__(self, o): return self._binop(o, lambda a, b: b / a)
    def __mod__(self, o): return self._binop(o, torch.remainder)
    def __pow__(self, o): return self._binop(o, torch.pow)
    def __neg__(self): return NDArray(-self._data, self._ctx)

    # comparisons give 0/1 in this array's dtype (``mxnet_tpu/ndarray.py:
    # 273-284``), so an NDArray hashes by identity
    def _cmp(self, o, fn):
        return self._binop(o, lambda a, b: fn(a, b).to(self._data.dtype))

    def __eq__(self, o):
        if isinstance(o, (NDArray, int, float, np.ndarray)):
            return self._cmp(o, torch.eq)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray, int, float, np.ndarray)):
            return self._cmp(o, torch.ne)
        return NotImplemented

    def __gt__(self, o): return self._cmp(o, torch.gt)
    def __ge__(self, o): return self._cmp(o, torch.ge)
    def __lt__(self, o): return self._cmp(o, torch.lt)
    def __le__(self, o): return self._cmp(o, torch.le)

    def __hash__(self):
        return id(self)

    def _inplace(self, o, name):
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        with torch.no_grad():
            getattr(self._data, name)(self._other(o))
        return self

    def __iadd__(self, o): return self._inplace(o, "add_")
    def __isub__(self, o): return self._inplace(o, "sub_")
    def __imul__(self, o): return self._inplace(o, "mul_")
    def __itruediv__(self, o): return self._inplace(o, "div_")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def _ctx(ctx: Optional[Context]) -> Tuple[Context, torch.device]:
    ctx = ctx if ctx is not None else current_context()
    return ctx, ctx.torch_device()


def array(source_array, ctx: Optional[Context] = None,
          dtype=None) -> NDArray:
    """A copy of ``source_array`` (numpy-like, NDArray or tensor) on
    ``ctx``.  Unless ``dtype`` says otherwise, a 64-bit numpy-like
    source narrows to 32 bits as in the JAX package: float64 to float32,
    int64 to int32, uint64 to uint32."""
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = tensor_from_numpy(source_array)
        if dtype is None:
            src = src.to(_NARROW.get(src.dtype, src.dtype))
    ctx, dev = _ctx(ctx)
    tdt = torch_dtype(dtype) if dtype is not None else src.dtype
    return NDArray(src.to(device=dev, dtype=tdt, copy=True), ctx)


def full(shape, val, ctx: Optional[Context] = None,
         dtype="float32") -> NDArray:
    """An array of ``shape`` filled with ``val`` (``mxnet_tpu/ndarray.py:
    353``)."""
    ctx, dev = _ctx(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.full(shape, val, dtype=torch_dtype(dtype),
                              device=dev), ctx)


def zeros(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    return full(shape, 0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    return full(shape, 1, ctx, dtype)


def empty(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    """Zeros, as in the JAX package, whose arrays are never
    uninitialized."""
    return full(shape, 0, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx: Optional[Context] = None,
           dtype="float32") -> NDArray:
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` when
    ``stop`` is None), each value ``repeat`` times, computed as numpy's
    ``arange`` in ``dtype`` (``mxnet_tpu/ndarray.py:360``)."""
    lo, hi = (0, start) if stop is None else (start, stop)
    vals = np.arange(lo, hi, step, dtype=np.dtype(dtype_name(dtype)))
    if repeat > 1:
        vals = np.repeat(vals, repeat)
    return array(vals, ctx=ctx, dtype=dtype)


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """Write the one-hot rows of ``indices`` (depth ``out.shape[1]``)
    into ``out`` (``mxnet_tpu/ndarray.py:372``)."""
    idx = indices._data.long().to(out._data.device)
    depth = out.shape[1]
    out[:] = (idx[:, None] == torch.arange(depth, device=idx.device))
    return out


def waitall() -> None:
    """Block until the work queued on every CUDA device is done
    (``mxnet_tpu/ndarray.py:401``); CPU work is done when it returns."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    """The arrays joined along ``axis``, on the first one's context
    (``mxnet_tpu/ndarray.py:368``); the result is always a new array."""
    return NDArray(torch.cat([a._data for a in arrays], dim=axis),
                   arrays[0]._ctx)


# ---------------------------------------------------------------------------
# save / load (``mxnet_tpu/ndarray.py:418-489``): the magic number, a flag
# for a dict or a list, the count, then per entry its name (dict form)
# and the array: dtype code, ndim, the shape as int64s, the raw bytes
# ---------------------------------------------------------------------------

_NDARRAY_MAGIC = 0x112
_DTYPE_TO_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                  "int32": 4, "int8": 5, "int64": 6, "bfloat16": 7, "bool": 8}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}


def _write_array(f, arr) -> None:
    if isinstance(arr, NDArray):
        t = arr._data.detach()
    elif isinstance(arr, torch.Tensor):
        t = arr.detach()
    else:
        t = tensor_from_numpy(arr)
    name = _NAMES.get(t.dtype)
    if name not in _DTYPE_TO_CODE:
        t, name = t.float(), "float32"
    t = t.contiguous().cpu()
    # numpy has no bfloat16 without ml_dtypes: its bits as int16
    raw = t.view(torch.int16) if name == "bfloat16" else t
    f.write(struct.pack("<II", _DTYPE_TO_CODE[name], t.ndim))
    f.write(struct.pack(f"<{t.ndim}q", *t.shape))
    f.write(raw.numpy().tobytes())


def _read(f, n: int, fname: str) -> bytes:
    """``n`` bytes of ``fname``, or an error naming it (no ``try``: a
    short or foreign file is found by its lengths and codes)."""
    buf = f.read(n)
    if len(buf) != n:
        raise MXNetError(f"corrupt or truncated NDArray file {fname!r}: "
                         f"{len(buf)} of {n} bytes")
    return buf


def _read_array(f, fname: str) -> NDArray:
    code, ndim = struct.unpack("<II", _read(f, 8, fname))
    if code not in _CODE_TO_DTYPE:
        raise MXNetError(f"corrupt NDArray file {fname!r}: dtype code "
                         f"{code}")
    shape = struct.unpack(f"<{ndim}q", _read(f, 8 * ndim, fname))
    name = _CODE_TO_DTYPE[code]
    dt = np.dtype("int16" if name == "bfloat16" else name)
    n = int(np.prod(shape)) if shape else 1
    buf = _read(f, n * dt.itemsize, fname)
    t = torch.from_numpy(np.frombuffer(buf, dtype=dt).reshape(shape).copy())
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return NDArray(t, cpu())


def save(fname: str, data) -> None:
    """Write a list of arrays or a name → array dict (NDArrays, tensors
    or numpy arrays) to ``fname`` in the JAX package's ``nd.save``
    format; a dtype the format lacks is written as float32."""
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        data = [data]
    if not isinstance(data, (dict, list, tuple)):
        raise MXNetError(f"cannot save type {type(data)}")
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", _NDARRAY_MAGIC))
        f.write(struct.pack("<B", int(isinstance(data, dict))))
        f.write(struct.pack("<Q", len(data)))
        if isinstance(data, dict):
            for k, v in data.items():
                kb = k.encode("utf-8")
                f.write(struct.pack("<I", len(kb)))
                f.write(kb)
                _write_array(f, v)
        else:
            for v in data:
                _write_array(f, v)


def load(fname: str):
    """The list or dict ``save`` wrote, as NDArrays on the CPU (callers
    copy them onto their device, e.g. with ``set_params``)."""
    with open(fname, "rb") as f:
        magic, = struct.unpack("<Q", _read(f, 8, fname))
        if magic != _NDARRAY_MAGIC:
            raise MXNetError(f"invalid NDArray file {fname}")
        has_names, = struct.unpack("<B", _read(f, 1, fname))
        count, = struct.unpack("<Q", _read(f, 8, fname))
        if not has_names:
            return [_read_array(f, fname) for _ in range(count)]
        out: Dict[str, NDArray] = {}
        for _ in range(count):
            klen, = struct.unpack("<I", _read(f, 4, fname))
            key = _read(f, klen, fname).decode("utf-8")
            out[key] = _read_array(f, fname)
        return out


# ---------------------------------------------------------------------------
# imperative invoke + the generated op namespace (``mxnet_tpu/ndarray.py:
# 496-560``)
# ---------------------------------------------------------------------------


def imperative_invoke(op_name: str, *args, out=None, is_train: bool = False,
                      **kwargs) -> Union[NDArray, List[NDArray]]:
    """Run registered op ``op_name`` on NDArrays, forward only.  Keyword
    arguments are its attrs (``ctx`` and ``name`` aside); NDArrays past
    the op's formal inputs are its aux states, written back in place.
    Outputs lie on the inputs' context (``ctx`` when there are none);
    ``out`` receives them instead of new arrays."""
    nd_inputs = [a for a in args if isinstance(a, NDArray)]
    ctx = kwargs.pop("ctx", None)
    if ctx is None:
        ctx = nd_inputs[0]._ctx if nd_inputs else current_context()
    kwargs.pop("name", None)
    attrs = attrs_to_str({k: v for k, v in kwargs.items() if v is not None})
    op = _reg.get_op(op_name)
    n_formal = len(op.input_names(attrs))
    nd_aux = nd_inputs[n_formal:] if op.auxiliary_names(attrs) else []
    nd_inputs = nd_inputs[:n_formal]
    with torch.no_grad():
        outs, new_aux = _reg.invoke(
            op_name, [a._data for a in nd_inputs], attrs, is_train=is_train,
            aux=[a._data for a in nd_aux],
            device=None if nd_inputs else ctx.torch_device())
    for dst, src in zip(nd_aux, new_aux):
        dst[:] = src
    results = [NDArray(o, ctx) for o in outs]
    if out is not None:
        for dst, src in zip(out if isinstance(out, (list, tuple)) else [out],
                            results):
            dst[:] = src
        return out
    return results[0] if len(results) == 1 else results


def _make_ndarray_function(op_name: str):
    op = _reg.get_op(op_name)

    def fn(*args, **kwargs):
        # positional NDArrays, or inputs by name (data=...)
        pos = list(args)
        named = op.input_names(attrs_to_str(
            {k: v for k, v in kwargs.items() if not isinstance(v, NDArray)}))
        for name in named:
            if name in kwargs:
                pos.append(kwargs.pop(name))
        return imperative_invoke(op_name, *pos, **kwargs)

    fn.__name__ = op_name
    fn.__doc__ = op.doc
    return fn


def _init_ndarray_module():
    """``nd.<op>`` for every registered op whose name is free (``array``,
    ``zeros`` and the other creation functions keep their names), and a
    sampler ``_sample_<x>`` also as ``nd.<x>`` where that is free when
    the sorted names reach it: ``nd.exponential``, and ``nd.gamma``,
    which is the sampler, not the unary op, as in the JAX package."""
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_ndarray_function(name))
        short = name[len("_sample_"):]
        if name.startswith("_sample_") and not hasattr(mod, short):
            setattr(mod, short, _make_ndarray_function(name))


# the ops import this module's dtype helpers, so the registry comes last
from .ops import registry as _reg  # noqa: E402

_init_ndarray_module()


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, out=None,
            dtype="float32") -> NDArray:
    """Uniform draws in [low, high) of ``shape`` on ``ctx`` (``out``'s
    context when only ``out`` is given; ``_sample_uniform``)."""
    if ctx is None and out is not None:
        ctx = out.context
    return imperative_invoke("_sample_uniform", low=low, high=high,
                             shape=shape, dtype=dtype, ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, out=None,
           dtype="float32") -> NDArray:
    """Gaussian draws of ``shape`` on ``ctx`` (``out``'s context when
    only ``out`` is given; ``_sample_normal``)."""
    if ctx is None and out is not None:
        ctx = out.context
    return imperative_invoke("_sample_normal", loc=loc, scale=scale,
                             shape=shape, dtype=dtype, ctx=ctx, out=out)


random_uniform = uniform
random_normal = normal
