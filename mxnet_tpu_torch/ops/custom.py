"""The ``Custom`` operator — user Python ops inside the graph.

Counterpart of ``mxnet_tpu/ops/custom.py``: a ``CustomOpProp`` subclass
registered under a name (``operator.register``) is instantiated per
(op_type, kwargs), supplies the argument/output/aux names and shape
inference, and creates the ``CustomOp`` whose ``forward``/``backward``
run Python over NDArrays.

Where the JAX package enters host Python through ``jax.pure_callback``
and hands the user host copies, the port calls the user's code directly
with NDArrays over the op's own tensors, on the op's device, as the
reference does on a GPU; ``with ctx:`` is the op's context while it
runs, so ``nd.array(...)`` in user code lands there.  The gradient is a
``torch.autograd.Function`` whose backward calls ``CustomOp.backward``
with the saved inputs, outputs and the aux state the forward left.
Outputs are new arrays the framework allocates and the user writes; aux
states are handed over as copies and come back as new values, which
the executor writes into the bound aux arrays, so no user write lands in
a tensor autograd has saved.  The user's Python runs at every call, so
the op is registered ``capturable=False``: a Module whose symbol holds
it runs its fused step without a CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu, gpu
from ..ndarray import NDArray, dtype_name, torch_dtype
from .registry import register

# name -> CustomOpProp subclass (filled by mxnet_tpu_torch.operator.register)
_PROPS: Dict[str, type] = {}

# attrs the framework may add around user kwargs
_FRAMEWORK_ATTRS = ("op_type", "num_args", "name", "ctx", "is_train", "out")


@functools.lru_cache(maxsize=1024)
def _cached_prop(op_type, kwarg_items):
    cls = _PROPS.get(op_type)
    if cls is None:
        raise MXNetError(f"custom op type {op_type!r} is not registered "
                         "(use mxnet_tpu_torch.operator.register)")
    return cls(**dict(kwarg_items))


def _make_prop(attrs):
    """One CustomOpProp per (op_type, user kwargs), memoized, as the
    reference keeps one prop per node."""
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom op requires an op_type attr")
    kwargs = tuple(sorted((k, v) for k, v in attrs.items()
                          if k not in _FRAMEWORK_ATTRS))
    return _cached_prop(op_type, kwargs)


def _custom_arg_names(attrs):
    return [str(n) for n in _make_prop(attrs).list_arguments()]


def _custom_aux_names(attrs):
    return [str(n) for n in _make_prop(attrs).list_auxiliary_states()]


def _custom_out_names(attrs):
    return [str(n) for n in _make_prop(attrs).list_outputs()]


def _custom_infer_shape(attrs, in_shapes):
    prop = _make_prop(attrs)
    if any(s is None for s in in_shapes):
        return in_shapes, None, None
    ins, outs, auxs = prop.infer_shape([list(s) for s in in_shapes])
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in (auxs or [])])


def _custom_is_loss(attrs):
    """need_top_grad=False: the op makes its own gradient, a loss head
    (reference: declare_backward_dependency)."""
    return not _make_prop(attrs).need_top_grad_


def _context(t: torch.Tensor):
    return cpu() if t.device.type == "cpu" else gpu(t.device.index or 0)


class _CustomFn(torch.autograd.Function):
    """Inputs and aux states in; outputs and the new aux states out.  The
    new aux states carry no gradient."""

    @staticmethod
    def forward(ctx, run, n_in, *tensors):
        outs, new_aux = run.forward(tensors[:n_in], tensors[n_in:])
        ctx.run, ctx.n_in, ctx.n_out = run, n_in, len(outs)
        ctx.save_for_backward(*tensors[:n_in], *outs, *new_aux)
        if new_aux:
            ctx.mark_non_differentiable(*new_aux)
        return (*outs, *new_aux)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n_in, n_out = ctx.n_in, ctx.n_out
        ins, outs = saved[:n_in], saved[n_in:n_in + n_out]
        aux = saved[n_in + n_out:]
        in_grads = ctx.run.backward(ins, outs, grads[:n_out], aux)
        return (None, None, *in_grads, *([None] * len(aux)))


class _Run:
    """One execution of a Custom node: the prop, the user's CustomOp
    instance (created once, shared by the forward and its backward) and
    the device its NDArrays live on."""

    def __init__(self, prop, is_train, inputs):
        self.prop = prop
        self.is_train = is_train
        self.in_shapes = [list(x.shape) for x in inputs]
        self.ctx = _context(inputs[0])
        self._op = None

    def op(self):
        if self._op is None:
            self._op = self.prop.create_operator(self.ctx, self.in_shapes)
        return self._op

    def _wrap(self, tensors, writable=True):
        return [NDArray(t, self.ctx, writable=writable) for t in tensors]

    def forward(self, ins, aux):
        _, out_shapes, _ = self.prop.infer_shape(
            [list(s) for s in self.in_shapes])
        _, out_types, _ = self.prop.infer_type([_user_dtype(x) for x in ins])
        dev = ins[0].device
        outs = [torch.zeros(tuple(s), dtype=torch_dtype(d), device=dev)
                for s, d in zip(out_shapes, out_types)]
        new_aux = [a.detach().clone() for a in aux]
        with self.ctx:
            self.op().forward(self.is_train, ["write"] * len(outs),
                              self._wrap(ins, writable=False),
                              self._wrap(outs), self._wrap(new_aux))
        return outs, new_aux

    def backward(self, ins, outs, out_grads, aux):
        in_grads = [torch.zeros_like(x) for x in ins]
        out_grads = [torch.zeros_like(o) if g is None else g
                     for g, o in zip(out_grads, outs)]
        with self.ctx:
            self.op().backward(["write"] * len(ins),
                               self._wrap(out_grads, writable=False),
                               self._wrap(ins, writable=False),
                               self._wrap(outs, writable=False),
                               self._wrap(in_grads),
                               self._wrap(aux, writable=False))
        return in_grads


def _user_dtype(t: torch.Tensor):
    """What a prop's ``infer_type`` sees of a tensor's type: a numpy
    dtype, as in the JAX package (bfloat16, which numpy lacks, by
    name)."""
    name = dtype_name(t.dtype)
    return name if name == "bfloat16" else np.dtype(name)


@register("Custom",
          arg_names=_custom_arg_names,
          aux_names=_custom_aux_names,
          out_names=_custom_out_names,
          infer_shape=_custom_infer_shape,
          is_loss=_custom_is_loss, capturable=False,
          doc="Apply a registered CustomOp (reference: operator.py Custom)")
def _custom_compute(op_ctx, attrs, inputs, aux):
    run = _Run(_make_prop(attrs), bool(op_ctx.is_train), inputs)
    res = _CustomFn.apply(run, len(inputs), *inputs, *aux)
    n_aux = len(aux)
    outs = list(res[:len(res) - n_aux])
    if n_aux:
        return outs, list(res[len(res) - n_aux:])
    return outs
