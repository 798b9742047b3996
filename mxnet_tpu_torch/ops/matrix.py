"""Shape ops: ``Reshape`` (alias ``reshape``) with MXNet's special codes,
``Flatten``, ``transpose``, ``expand_dims`` and ``Concat``.

Counterpart of ``mxnet_tpu/ops/matrix.py:23-125,260-287``, with its own copy of
``_infer_reshape_shape``.  ``transpose`` returns a contiguous tensor, so
the op after it (the RNN's input projection, a ``Reshape``) reads
memory in its own order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import attr_bool, attr_int, attr_shape
from .registry import register

__all__ = []


def _infer_reshape_shape(src, target, reverse=False):
    """The output shape of ``Reshape(shape=target)`` on ``src``: 0 copies
    a dim, -1 infers one, -2 copies the rest, -3 merges two, -4 splits
    one into the next two codes (one may be -1); ``reverse`` matches the
    codes from the right."""
    src = list(src)
    target = list(target)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    src_idx = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif t == -1:
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src[src_idx]
            src_idx += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 2
        else:
            out.append(t)
            if src_idx < len(src):
                src_idx += 1
        i += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(src)) if src else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = out[::-1]
    return tuple(int(d) for d in out)


def _reshape_target(attrs):
    target = attr_shape(attrs.get("shape"))
    if not target and "target_shape" in attrs:  # legacy attr
        target = attr_shape(attrs.get("target_shape"))
    return target, attr_bool(attrs.get("reverse"), False)


def _reshape_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    return in_shapes, [_infer_reshape_shape(s, *_reshape_target(attrs))], []


@register("Reshape", arg_names=("data",), aliases=("reshape",),
          infer_shape=_reshape_infer,
          doc="Reshape with the 0/-1/-2/-3/-4 special codes")
def _reshape(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x.reshape(_infer_reshape_shape(x.shape, *_reshape_target(attrs)))]


@register("Flatten", arg_names=("data",), aliases=("flatten",),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None
                  else (s[0][0], int(np.prod(s[0][1:])))], []),
          doc="Flatten to (batch, everything else)")
def _flatten(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x.reshape(x.shape[0], -1)]


def _transpose_axes(attrs, ndim):
    return attr_shape(attrs.get("axes")) or tuple(reversed(range(ndim)))


def _transpose_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(s[a] for a in _transpose_axes(attrs, len(s)))], []


@register("transpose", arg_names=("data",), infer_shape=_transpose_infer,
          doc="Permute the axes (default: reverse them); contiguous result")
def _transpose(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x.permute(_transpose_axes(attrs, x.ndim)).contiguous()]


def _expand_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    ax = attr_int(attrs.get("axis"))
    if ax < 0:
        ax += len(s) + 1
    return in_shapes, [tuple(s[:ax]) + (1,) + tuple(s[ax:])], []


@register("expand_dims", arg_names=("data",), infer_shape=_expand_infer,
          doc="Insert a size-1 axis at attrs['axis']")
def _expand_dims(op_ctx, attrs, inputs, aux):
    return [inputs[0].unsqueeze(attr_int(attrs.get("axis")))]


def _concat_args(attrs):
    return [f"arg{i}" for i in range(attr_int(attrs.get("num_args", 1)))]


def _concat_infer(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        return in_shapes, [None], []
    dim = attr_int(attrs.get("dim", 1))
    out = list(in_shapes[0])
    out[dim] = sum(s[dim] for s in in_shapes)
    return in_shapes, [tuple(out)], []


@register("Concat", arg_names=_concat_args, aliases=("concat",),
          infer_shape=_concat_infer,
          doc="Concatenate the num_args inputs along attrs['dim']")
def _concat(op_ctx, attrs, inputs, aux):
    return [torch.cat(inputs, dim=attr_int(attrs.get("dim", 1)))]
