"""User-written operators — the RTC surface of the port.

Counterpart of ``mxnet_tpu/rtc.py``.  The reference let users write
CUDA kernel text from Python and launch it on NDArrays
(``python/mxnet/rtc.py``; ``src/common/mxrtc.cc:13-76`` compiled it
with NVRTC).  The JAX package's equivalent is a Pallas kernel
(``pallas_op``); the port's is the reference's own model again: the user
writes a ``__global__`` kernel in CUDA C++, the framework builds it with
``nvcc`` at first use (``_build.build_sources``) and launches it on the
inputs' stream (``cuda_op``).  A kernel in a Python kernel language, as
Pallas is, is a Triton kernel (``triton_op``): the user writes a
``@triton.jit`` function, Triton compiles it at first use.  Whatever is
registered is exposed everywhere a built-in op appears:

* imperatively: ``mt.nd.<name>(x, y)``;
* symbolically: ``mt.sym.<name>(a, b)``, through ``bind``/``forward``/
  ``backward`` and ``Module``;
* differentiably: a user VJP (itself free to launch a kernel) becomes a
  ``torch.autograd.Function`` that saves the inputs and recomputes from
  them, as the JAX package's ``jax.custom_vjp`` does.  Without one,
  autograd differentiates through a ``register_op`` function built from
  differentiable torch ops, while a ``cuda_op`` needs the explicit VJP
  to train and raises when differentiated.

``cuda_kernel`` follows the rule of ``ops/cuda_kernels.py``: a CPU tensor
goes to the user's ``plain`` PyTorch version (a CPU call without one
raises); a CUDA tensor launches the kernel or raises.  Nothing falls
back and nothing is compiled at import or registration; ``triton`` is
imported at a Triton kernel's first CUDA call and nowhere else.
``LAUNCHES`` counts each kernel's successful launches, nowhere else.

Worked examples: ``mxnet_tpu_torch/examples/user_cuda_kernel.py`` and
``mxnet_tpu_torch/examples/user_triton_kernel.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import math
import os
import re
import sys
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .base import MXNetError
from .ndarray import dtype_name, torch_dtype
from .ops import cuda_kernels as _ck
from .ops import registry as _reg

__all__ = ["register_op", "cuda_kernel", "cuda_op", "triton_kernel",
           "triton_op", "LAUNCHES", "reset_launch_counts"]

LAUNCHES: Dict[str, int] = {}

# the most arguments a user kernel takes (pointers and scalars together)
MAX_KERNEL_ARGS = 256
# appended to the user's source: one launcher with a plain C interface,
# called with one array of 64-bit values: the grid and block dims, the
# dynamic shared memory bytes, the stream, then the kernel's n arguments
# in order, at which it points cudaLaunchKernel's argument array
_LAUNCHER = """

// ---- launcher generated by mxnet_tpu_torch.rtc for {kernel} ----
#include <cuda_runtime.h>
extern "C" int mxrtc_launch(const long long* vals, int n) {{
  void* args[{max_args}];
  if (n < 0 || n > {max_args}) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) args[i] = const_cast<long long*>(vals + 8 + i);
  const void* fn = (const void*)({kernel});
  const unsigned int smem = (unsigned int)vals[6];
  if (smem > 48u * 1024u) {{
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }}
  const dim3 grid((unsigned int)vals[0], (unsigned int)vals[1],
                  (unsigned int)vals[2]);
  const dim3 block((unsigned int)vals[3], (unsigned int)vals[4],
                   (unsigned int)vals[5]);
  cudaError_t err = cudaLaunchKernel(fn, grid, block, args, (size_t)smem,
                                     (cudaStream_t)vals[7]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}}
extern "C" const char* mxrtc_error_string(int err) {{
  return cudaGetErrorString((cudaError_t)err);
}}
"""
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_i64 = ctypes.c_longlong


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _expose(name: str) -> None:
    """Make a freshly registered op ``mt.nd.<name>`` and
    ``mt.sym.<name>`` (the generated namespaces are filled at import;
    late registrations attach here)."""
    from . import ndarray as _nd
    from . import symbol as _sym

    setattr(_nd, name, _nd._make_ndarray_function(name))
    setattr(_sym, name, _sym._make_symbol_function(name))


def _check_name(name: str) -> None:
    if name in _reg._OPS:
        raise MXNetError(f"operator {name!r} already registered")
    from . import ndarray as _nd
    from . import symbol as _sym

    if hasattr(_nd, name) or hasattr(_sym, name):
        # would clobber a module-level API function (zeros, array,
        # Variable, ...) through _expose's setattr
        raise MXNetError(
            f"{name!r} collides with an existing mt.nd/mt.sym API name")


def _with_vjp(name: str, fn: Callable, vjp: Callable) -> Callable:
    """``fn`` as an autograd Function whose backward is ``vjp(inputs,
    out_grads)``: it saves the inputs only and the VJP recomputes what
    it needs from them."""

    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        out = fn(*inputs)
        return tuple(out) if isinstance(out, list) else out

    def backward(ctx, *out_grads):
        saved = ctx.saved_tensors
        gs = vjp(tuple(saved), tuple(out_grads))
        if not isinstance(gs, (list, tuple)):
            gs = (gs,)
        if len(gs) != len(saved):
            raise MXNetError(f"vjp for {name!r} returned {len(gs)} gradients "
                             f"for {len(saved)} inputs")
        return tuple(gs)

    fn_cls = type(f"UserOp_{name}", (torch.autograd.Function,),
                  {"forward": staticmethod(forward),
                   "backward": staticmethod(backward)})
    return fn_cls.apply


def register_op(name: str,
                fn: Callable,
                arg_names: Sequence[str] = ("data",),
                infer_shape: Optional[Callable] = None,
                vjp: Optional[Callable] = None,
                doc: str = ""):
    """Register a user function over tensors as a named operator
    (``mxnet_tpu/rtc.py:48``).

    Parameters
    ----------
    name : str
        Operator name; becomes ``mt.nd.<name>`` / ``mt.sym.<name>``.
        Must not collide with a registered op or an API name.
    fn : callable
        ``fn(*inputs) -> output`` (or a tuple of outputs) on
        ``torch.Tensor``s; it may launch kernels (``cuda_kernel``).
    arg_names : sequence of str
        Formal input names (symbol composition, auto-Variables).
    infer_shape : callable, optional
        ``infer_shape(*in_shapes) -> out_shape | [out_shapes]``;
        defaults to the first input's shape.
    vjp : callable, optional
        ``vjp(inputs, out_grads) -> input_grads`` over tuples; recompute
        what you need from the inputs.  ``fn`` then runs inside a
        ``torch.autograd.Function`` whose backward calls it.  Without
        it autograd differentiates through ``fn``.
    doc : str
        Docstring of the generated functions.
    """
    _check_name(name)
    compute_fn = fn if vjp is None else _with_vjp(name, fn, vjp)
    n_args = len(arg_names)

    def compute(op_ctx, attrs, inputs, aux):
        if len(inputs) != n_args:
            raise MXNetError(
                f"{name} expects {n_args} inputs ({list(arg_names)}), "
                f"got {len(inputs)}")
        out = compute_fn(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def shape_infer(attrs, in_shapes):
        if infer_shape is None:
            outs = [in_shapes[0]]
        else:
            if any(s is None for s in in_shapes):
                return in_shapes, [None], []
            out = infer_shape(*in_shapes)
            outs = list(out) if out and isinstance(out[0], (list, tuple)) \
                else [tuple(out)]
            outs = [tuple(o) for o in outs]
        return in_shapes, outs, []

    # a user op may launch user kernels (cuda_op and triton_op register
    # through here)
    _reg.register(name, arg_names=tuple(arg_names), infer_shape=shape_infer,
                  kernel=True,
                  doc=doc or f"user-registered op (mxnet_tpu_torch.rtc) — "
                  f"reference capability: python/mxnet/rtc.py")(compute)
    _expose(name)
    return _reg.get_op(name)


# ---------------------------------------------------------------------------
# user CUDA kernels
# ---------------------------------------------------------------------------


def _dims(v, what: str) -> Tuple[int, int, int]:
    dims = (v,) if isinstance(v, int) else tuple(int(d) for d in v)
    if not 1 <= len(dims) <= 3 or any(d < 0 or d >= 2 ** 31 for d in dims):
        raise MXNetError(f"{what} {v!r}: one to three non-negative ints")
    return dims + (1,) * (3 - len(dims))


def _pack_args(head: Sequence[int], pointers: Sequence[int],
               scalars: Sequence[int]):
    """One launch as one array of 64-bit values: ``head`` (grid and
    block dims, dynamic shared memory bytes, the stream), then the
    kernel's arguments, the pointers and then the scalars, at whose
    slots the generated launcher points ``cudaLaunchKernel``'s ``void**
    args``.  One array a call, so calls from several threads share
    nothing."""
    vals = [*head, *pointers, *scalars]
    return (_i64 * len(vals))(*vals)


def _out_specs(spec) -> Tuple[list, bool]:
    """(list of (shape, torch dtype), single) from ``out_like``'s
    callable result: ``(shape, dtype)`` or a list of them."""
    single = (isinstance(spec, (tuple, list)) and len(spec) == 2
              and isinstance(spec[0], (tuple, list, torch.Size))
              and not isinstance(spec[1], (tuple, list)))
    specs = [spec] if single else list(spec)
    return [(tuple(int(d) for d in s), torch_dtype(dt)) for s, dt in specs], \
        single


class _UserKernel:
    """What the two routes of a user kernel share (``cuda_kernel``,
    ``triton_kernel``): the name, which keys ``LAUNCHES`` and may not be
    a built-in kernel's; the output specs from ``out_like``; the checks
    of a call's inputs; and the plain route, ``plain(*inputs)``, that a
    CPU tensor takes."""

    route = ""

    def __init__(self, kernel: str, name: Optional[str], out_like, plain,
                 dtype):
        if not _IDENT.match(kernel):
            raise MXNetError(f"kernel {kernel!r} is not a C identifier")
        self.name = name or kernel
        if not _IDENT.match(self.name):
            raise MXNetError(f"kernel name {self.name!r}: letters, digits "
                             f"and _ only")
        if self.name in _ck.LAUNCHES:
            raise MXNetError(f"kernel name {self.name!r} is a built-in "
                             f"kernel's; name the user kernel otherwise")
        if not callable(out_like) and not isinstance(out_like, int):
            raise MXNetError("out_like: an input index or a callable")
        self.kernel = kernel
        self.out_like, self.plain = out_like, plain
        self.dtype = None if dtype is None else torch_dtype(dtype)
        self._plans: Dict[tuple, tuple] = {}
        LAUNCHES.setdefault(self.name, 0)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} ({self.kernel})>"

    def output_specs(self, inputs) -> Tuple[list, bool]:
        if callable(self.out_like):
            return _out_specs(self.out_like(*inputs))
        x = inputs[self.out_like]
        return [(tuple(x.shape), x.dtype)], True

    def _check_inputs(self, inputs) -> torch.device:
        if not inputs:
            raise MXNetError(f"{self.name}: takes at least one input tensor")
        for i, t in enumerate(inputs):
            if not isinstance(t, torch.Tensor):
                raise MXNetError(f"{self.name}: input {i} is a {type(t)}, "
                                 f"not a torch.Tensor")
            if self.dtype is not None and t.dtype != self.dtype:
                raise MXNetError(
                    f"{self.name}: input {i} is {dtype_name(t.dtype)}; the "
                    f"kernel takes {dtype_name(self.dtype)}")
        devs = {t.device for t in inputs}
        if len(devs) != 1:
            raise MXNetError(f"{self.name}: inputs on several devices {devs}")
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            raise MXNetError(
                f"{self.name}: an input requires a gradient, which a kernel "
                f"call would drop; register it with rtc.{self.route.lower()}"
                f"_op(..., vjp=) to differentiate through it")
        dev = devs.pop()
        if dev.type not in ("cpu", "cuda"):
            raise MXNetError(f"{self.name}: no kernel for device {dev}")
        return dev

    def _plain_call(self, inputs, specs, single):
        if self.plain is None:
            raise MXNetError(
                f"{self.name}: CPU tensors need plain=, the kernel's plain "
                f"PyTorch version; the {self.route} kernel runs only on a "
                f"CUDA device")
        out = self.plain(*inputs)
        outs = [out] if single else list(out)
        got = [(tuple(o.shape), o.dtype) for o in outs]
        if got != specs:
            raise MXNetError(f"{self.name}: plain version gave {got}, "
                             f"out_like says {specs}")
        return out


class cuda_kernel(_UserKernel):
    """A callable on tensors that launches the ``__global__`` function
    ``kernel`` of the CUDA C++ text ``source``; what ``pallas_op``'s
    inner function does (``mxnet_tpu/rtc.py:165-198``).
    ``kernel(*inputs)`` returns the output tensor, or a tuple when
    ``out_like`` gives several.

    The kernel's arguments, in order: a pointer to each input, a pointer
    to each output, then a ``long long`` for each value of
    ``scalars(*inputs)`` (default: the element count of output 0).
    Inputs must be of ``dtype`` and on one device; they are made
    contiguous.  Outputs are new ``torch.empty`` tensors: ``out_like``
    is an input index (that input's shape and dtype) or a callable of
    the inputs returning ``(shape, dtype)`` or a list of them (several
    outputs).  ``grid``: None (``ceil(n / threads)`` blocks over output
    0's n elements), a tuple, or a callable of the inputs; ``block``: an
    int or a 3-tuple; ``shared_mem``: dynamic shared memory bytes.

    What those callables give is fixed by the inputs' shapes, dtype and
    device, as ``pallas_op``'s ``out_like`` and ``grid`` see shapes only
    at trace time: each of ``out_like``, ``grid`` and ``scalars`` is
    called once per (shapes, dtype, device) key, and later calls with
    the same key reuse the output specs, launch dims and scalars
    (``plan``).  A launch packs its dims, stream, pointers and scalars
    into one array for the generated launcher; the device's context is
    entered only when the inputs' device is not the current one.

    A CPU tensor goes to ``plain(*inputs)``, which must give what
    ``out_like`` says; a CUDA tensor builds the source at the first call
    (``nvcc``; a failure raises with the compiler's output) and launches
    the kernel on the current stream, or raises.  ``name`` (default
    ``kernel``; not a built-in kernel's) keys ``LAUNCHES`` and the built
    library."""

    route = "CUDA"

    def __init__(self, source: str, kernel: str, out_like=0, grid=None,
                 block=256, shared_mem: int = 0,
                 scalars: Optional[Callable] = None,
                 plain: Optional[Callable] = None, dtype="float32",
                 name: Optional[str] = None):
        super().__init__(kernel, name, out_like, plain, dtype)
        self.text = source + _LAUNCHER.format(kernel=kernel,
                                              max_args=MAX_KERNEL_ARGS)
        self.grid, self.scalars = grid, scalars
        self.block = _dims(block, "block")
        self.shared_mem = int(shared_mem)
        self._lib = self._entry = None

    def launch_dims(self, inputs, specs):
        """(grid, block) for outputs of ``specs`` (``output_specs``):
        ``grid`` as given (or called on the inputs), else ``ceil(n /
        threads a block)`` blocks along x over output 0's n elements.
        None when every output is empty (nothing to launch); a grid
        without blocks for a non-empty output raises."""
        if self.grid is None:
            threads = self.block[0] * self.block[1] * self.block[2]
            grid = (math.ceil(math.prod(specs[0][0]) / threads), 1, 1)
        else:
            g = self.grid(*inputs) if callable(self.grid) else self.grid
            grid = _dims(g, f"{self.name}: grid")
        if 0 in grid:
            if any(math.prod(s) for s, _ in specs):
                raise MXNetError(f"{self.name}: grid {grid} launches no "
                                 f"block, but an output is not empty")
            return None
        return grid, self.block

    def plan(self, inputs, dev: torch.device) -> tuple:
        """(output specs, single, launch dims, scalars) for inputs of
        these shapes on ``dev``, computed at a key's first call and
        cached.  The dims are (gx, gy, gz, bx, by, bz, shared memory
        bytes), None when every output is empty; on the CPU dims and
        scalars are None."""
        key = (tuple(t.shape for t in inputs), self.dtype, dev)
        plan = self._plans.get(key)
        if plan is None:
            specs, single = self.output_specs(inputs)
            dims = scal = None
            if dev.type == "cuda":
                dims = self.launch_dims(inputs, specs)
                if dims is not None:
                    scal = tuple(self.scalars(*inputs)) \
                        if self.scalars is not None \
                        else (math.prod(specs[0][0]),)
                    n = len(inputs) + len(specs) + len(scal)
                    if n > MAX_KERNEL_ARGS:
                        raise MXNetError(
                            f"{self.name}: {n} kernel arguments (the "
                            f"launcher takes up to {MAX_KERNEL_ARGS})")
                    dims = (*dims[0], *dims[1], self.shared_mem)
            plan = self._plans[key] = (specs, single, dims, scal)
        return plan

    def __call__(self, *inputs: torch.Tensor):
        dev = self._check_inputs(inputs)
        specs, single, dims, scal = self.plan(inputs, dev)
        if dev.type == "cpu":
            return self._plain_call(inputs, specs, single)
        outs = [torch.empty(s, dtype=dt, device=dev) for s, dt in specs]
        if dims is None:  # every output empty: nothing to compute
            return outs[0] if single else tuple(outs)
        xs = [t.contiguous() for t in inputs]
        ptrs = [t.data_ptr() for t in xs + outs]
        entry = self._load()
        if dev.index == torch.cuda.current_device():
            err = self._launch(entry, dims, ptrs, scal, dev.index)
        else:
            with torch.cuda.device(dev):
                err = self._launch(entry, dims, ptrs, scal, dev.index)
        del xs
        if err != 0:
            msg = self._lib.mxrtc_error_string(err).decode()
            raise MXNetError(f"{self.name}: kernel launch failed with CUDA "
                             f"error {err} ({msg})")
        LAUNCHES[self.name] += 1
        return outs[0] if single else tuple(outs)

    @staticmethod
    def _launch(entry, dims, ptrs, scal, index) -> int:
        """One launch on the device's current stream (its raw handle,
        without a ``torch.cuda.Stream`` object a call)."""
        stream = torch._C._cuda_getCurrentRawStream(index)
        args = _pack_args((*dims, stream), ptrs, scal)
        return entry(args, len(ptrs) + len(scal))

    def _load(self):
        if self._entry is None:
            lib = _build.library_for_source(self.name, self.text)
            entry = lib.mxrtc_launch
            entry.argtypes = [ctypes.POINTER(_i64), ctypes.c_int]
            entry.restype = ctypes.c_int
            lib.mxrtc_error_string.argtypes = [ctypes.c_int]
            lib.mxrtc_error_string.restype = ctypes.c_char_p
            self._lib, self._entry = lib, entry
        return self._entry


def _no_vjp(name: str, what: str = "cuda_op") -> Callable:
    def vjp(inputs, out_grads):
        raise MXNetError(
            f"{what} {name!r} has no vjp: a raw kernel has no derivative "
            f"autograd can take; pass vjp= to differentiate through it")

    return vjp


def cuda_op(name: str, source: str, kernel: str,
            arg_names: Sequence[str] = ("data",), out_like=0, grid=None,
            block=256, shared_mem: int = 0,
            scalars: Optional[Callable] = None,
            plain: Optional[Callable] = None, dtype="float32",
            vjp: Optional[Callable] = None,
            infer_shape: Optional[Callable] = None, doc: str = ""):
    """Register a user CUDA kernel as a named operator:
    ``register_op(name, cuda_kernel(...), ...)``, as ``pallas_op`` is
    ``register_op`` over a ``pallas_call`` (``mxnet_tpu/rtc.py:143``).
    The kernel's launches count under ``name``.  Without ``vjp`` the op
    runs forward, and differentiating through it raises."""
    _check_name(name)
    fn = cuda_kernel(source, kernel, out_like=out_like, grid=grid,
                     block=block, shared_mem=shared_mem, scalars=scalars,
                     plain=plain, dtype=dtype, name=name)
    op = register_op(name, fn, arg_names=arg_names, infer_shape=infer_shape,
                     vjp=vjp or _no_vjp(name), doc=doc or
                     f"user CUDA kernel op (mxnet_tpu_torch.rtc.cuda_op)")
    op.kernel = fn
    return op



# ---------------------------------------------------------------------------
# user Triton kernels
# ---------------------------------------------------------------------------


class triton_kernel(_UserKernel):
    """A callable on tensors that launches the ``@triton.jit`` function
    ``kernel`` of the Python module text ``source``; the port's
    counterpart of ``pallas_op``'s inner function, in a Python kernel
    language as Pallas is (``mxnet_tpu/rtc.py:165-198``).
    ``kernel(*inputs)`` returns the output tensor, or a tuple when
    ``out_like`` gives several.

    The kernel's arguments, in order: each input, each output (Triton
    takes tensors as pointers), the element count of output 0, then
    ``meta`` as keywords: its ``tl.constexpr`` values and, if given,
    ``num_warps``/``num_stages``.  Inputs must lie on one device; they
    are made contiguous.  Outputs are new ``torch.empty`` tensors, as
    ``cuda_kernel``'s: ``out_like`` is an input index or a callable of
    the inputs returning ``(shape, dtype)`` or a list of them.
    ``grid``: None (``ceil(n / meta["BLOCK"])`` programs over output 0's
    n elements), a tuple, or ``grid(*inputs, meta) -> tuple``; computed
    once per (shapes, dtypes, device) key (``plan``).

    A CPU tensor goes to ``plain(*inputs)``.  At the first call on a
    CUDA tensor ``triton`` is imported (its absence raises, naming the
    kernel), the text is written to ``mxnet_tpu_torch/build/`` (Triton's
    ``jit`` reads its function's source from a file) and imported from
    there, and Triton compiles the kernel for the inputs' types; the
    launch runs on the current stream.  Nothing is imported or compiled
    before that.  ``name`` (default ``kernel``; not a built-in kernel's)
    keys ``LAUNCHES``."""

    route = "Triton"

    def __init__(self, source: str, kernel: str, out_like=0, grid=None,
                 meta: Optional[Dict] = None,
                 plain: Optional[Callable] = None,
                 name: Optional[str] = None):
        super().__init__(kernel, name, out_like, plain, None)
        self.text, self.grid, self.meta = source, grid, dict(meta or {})
        self._fn = None

    def launch_grid(self, inputs, specs):
        """The launch grid for outputs of ``specs`` (``output_specs``),
        as a 3-tuple; None when every output is empty (nothing to
        launch), and a grid without programs for a non-empty output
        raises."""
        if self.grid is None:
            if "BLOCK" not in self.meta:
                raise MXNetError(f"{self.name}: grid=None takes "
                                 f"meta['BLOCK'], the elements a program")
            grid = (math.ceil(math.prod(specs[0][0])
                              / int(self.meta["BLOCK"])),)
        else:
            grid = self.grid(*inputs, self.meta) if callable(self.grid) \
                else self.grid
        grid = _dims(grid, f"{self.name}: grid")
        if 0 in grid:
            if any(math.prod(s) for s, _ in specs):
                raise MXNetError(f"{self.name}: grid {grid} launches no "
                                 f"program, but an output is not empty")
            return None
        return grid

    def plan(self, inputs, dev: torch.device) -> tuple:
        """(output specs, single, grid) for inputs of these shapes and
        dtypes on ``dev``, computed at a key's first call and cached; the
        grid is None on the CPU."""
        key = (tuple(t.shape for t in inputs),
               tuple(t.dtype for t in inputs), dev)
        plan = self._plans.get(key)
        if plan is None:
            specs, single = self.output_specs(inputs)
            grid = self.launch_grid(inputs, specs) if dev.type == "cuda" \
                else None
            plan = self._plans[key] = (specs, single, grid)
        return plan

    def __call__(self, *inputs: torch.Tensor):
        dev = self._check_inputs(inputs)
        specs, single, grid = self.plan(inputs, dev)
        if dev.type == "cpu":
            return self._plain_call(inputs, specs, single)
        outs = [torch.empty(s, dtype=dt, device=dev) for s, dt in specs]
        if grid is None:  # every output empty: nothing to compute
            return outs[0] if single else tuple(outs)
        xs = [t.contiguous() for t in inputs]
        fn = self._load()
        n = math.prod(specs[0][0])
        if dev.index == torch.cuda.current_device():
            fn[grid](*xs, *outs, n, **self.meta)
        else:
            with torch.cuda.device(dev):
                fn[grid](*xs, *outs, n, **self.meta)
        LAUNCHES[self.name] += 1
        return outs[0] if single else tuple(outs)

    def _load(self):
        """The ``@triton.jit`` function, imported at the first CUDA call
        from the source written under ``_build.BUILD_DIR``."""
        if self._fn is not None:
            return self._fn
        # no try here: a kernel that cannot load raises, never falls back
        if not (sys.modules.get("triton") if "triton" in sys.modules
                else importlib.util.find_spec("triton")):
            raise MXNetError(
                f"{self.name}: a Triton kernel needs the triton package at "
                f"its first CUDA call, and it is not installed")
        import triton  # noqa: F401  (the kernel module imports it)
        digest = hashlib.sha256(self.text.encode()).hexdigest()[:16]
        path = _build.BUILD_DIR / f"triton_{self.name}-{digest}.py"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}."
                                 f"{threading.get_ident()}.tmp")
            tmp.write_text(self.text)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(
            f"mxnet_tpu_torch_triton_{self.name}_{digest}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        fn = getattr(module, self.kernel, None)
        if fn is None or not hasattr(fn, "run"):
            raise MXNetError(f"{self.name}: the source defines no "
                             f"@triton.jit function {self.kernel!r}")
        self._fn = fn
        return fn


def triton_op(name: str, source: str, kernel: str,
              arg_names: Sequence[str] = ("data",), out_like=0, grid=None,
              meta: Optional[Dict] = None, plain: Optional[Callable] = None,
              vjp: Optional[Callable] = None,
              infer_shape: Optional[Callable] = None, doc: str = ""):
    """Register a user Triton kernel as a named operator:
    ``register_op(name, triton_kernel(...), ...)``, the port's
    ``pallas_op`` in a Python kernel language (``mxnet_tpu/rtc.py:143``).
    ``source`` is the text of a module holding the ``@triton.jit``
    function ``kernel``; ``grid`` a tuple or ``grid(*inputs, meta)``;
    ``meta`` the ``tl.constexpr`` values.  The kernel's launches count
    under ``name``.  Without ``vjp`` the op runs forward, and
    differentiating through it raises."""
    _check_name(name)
    fn = triton_kernel(source, kernel, out_like=out_like, grid=grid,
                       meta=meta, plain=plain, name=name)
    op = register_op(name, fn, arg_names=arg_names, infer_shape=infer_shape,
                     vjp=vjp or _no_vjp(name, "triton_op"), doc=doc or
                     f"user Triton kernel op (mxnet_tpu_torch.rtc.triton_op)")
    op.kernel = fn
    return op
