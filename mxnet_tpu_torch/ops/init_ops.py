"""Init ops, nodes without inputs: ``_zeros``, ``_ones``, ``_full`` and
``_arange`` (with ``repeat``).

Counterpart of ``mxnet_tpu/ops/init_ops.py:20-70``.  The output is made
on the node's device (``OpContext.device``: the executor's context, or
the eager call's) by a device fill, never a copy from the host, so a
CUDA graph can hold it.
"""

from __future__ import annotations

import math

import torch

from ..base import attr_float, attr_int, attr_shape
from ..ndarray import torch_dtype
from .registry import register

__all__ = []


def _dtype(attrs):
    return torch_dtype(attrs.get("dtype", "float32"))


def _shape_infer(attrs, in_shapes):
    return [], [attr_shape(attrs.get("shape"))], []


def _filled(value_of):
    def compute(op_ctx, attrs, inputs, aux):
        return [torch.full(attr_shape(attrs.get("shape")), value_of(attrs),
                           dtype=_dtype(attrs), device=op_ctx.device)]

    return compute


register("_zeros", arg_names=(), infer_shape=_shape_infer,
         doc="Zeros of attrs['shape'] in attrs['dtype']")(
    _filled(lambda attrs: 0))
register("_ones", arg_names=(), infer_shape=_shape_infer,
         doc="Ones of attrs['shape'] in attrs['dtype']")(
    _filled(lambda attrs: 1))
register("_full", arg_names=(), infer_shape=_shape_infer,
         doc="attrs['value'] over attrs['shape'] in attrs['dtype']")(
    _filled(lambda attrs: attr_float(attrs.get("value"))))


def _arange_vals(attrs):
    start = attr_float(attrs.get("start", 0))
    stop_s = attrs.get("stop")
    stop = None if stop_s in (None, "None", "") else attr_float(stop_s)
    step = attr_float(attrs.get("step", 1.0))
    if stop is None:
        start, stop = 0.0, start
    return start, stop, step, attr_int(attrs.get("repeat", 1))


def _arange_infer(attrs, in_shapes):
    start, stop, step, repeat = _arange_vals(attrs)
    return [], [(max(0, math.ceil((stop - start) / step)) * repeat,)], []


@register("_arange", arg_names=(), infer_shape=_arange_infer,
          doc="start, start + step, ... below stop ([0, start) without "
              "stop), each repeated attrs['repeat'] times")
def _arange(op_ctx, attrs, inputs, aux):
    start, stop, step, repeat = _arange_vals(attrs)
    out = torch.arange(start, stop, step, dtype=_dtype(attrs),
                       device=op_ctx.device)
    return [out.repeat_interleave(repeat) if repeat > 1 else out]
