"""Elementwise ops of the training path: ``Cast``, ``elemwise_add``,
``elemwise_sub`` and ``elemwise_mul`` (what ``Symbol``'s ``+``, ``-``
and ``*`` build), ``broadcast_add`` and ``broadcast_mul``.

Counterpart of ``mxnet_tpu/ops/elemwise.py:107,124-163,172-174``.
"""

from __future__ import annotations

import torch

from ..ndarray import torch_dtype
from .registry import broadcast_shape_infer, register, same_shape_infer

__all__ = []


@register("Cast", arg_names=("data",), infer_shape=same_shape_infer(1, 1),
          aliases=("cast",), doc="Cast to attrs['dtype']")
def _cast(op_ctx, attrs, inputs, aux):
    return [inputs[0].to(torch_dtype(attrs["dtype"]))]


def _binary(name, aliases, fn, what):
    def compute(op_ctx, attrs, inputs, aux):
        return [fn(inputs[0], inputs[1])]

    register(name, arg_names=("lhs", "rhs"),
             infer_shape=same_shape_infer(2, 1), aliases=aliases,
             doc=f"Elementwise {what} of two same-shape inputs")(compute)


_binary("elemwise_add", ("_plus", "_add"), torch.add, "sum")
_binary("elemwise_sub", ("_minus", "_sub"), torch.sub, "difference")
_binary("elemwise_mul", ("_mul",), torch.mul, "product")


@register("broadcast_add", arg_names=("lhs", "rhs"),
          infer_shape=broadcast_shape_infer, aliases=("broadcast_plus",),
          doc="Sum with numpy broadcasting")
def _broadcast_add(op_ctx, attrs, inputs, aux):
    return [inputs[0] + inputs[1]]


@register("broadcast_mul", arg_names=("lhs", "rhs"),
          infer_shape=broadcast_shape_infer,
          doc="Product with numpy broadcasting")
def _broadcast_mul(op_ctx, attrs, inputs, aux):
    return [inputs[0] * inputs[1]]
