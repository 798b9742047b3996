"""Shape ops: ``Reshape`` (alias ``reshape``) with MXNet's special codes,
``Flatten``, ``transpose``, ``expand_dims``, ``Concat``, ``Pad`` (alias
``pad``), ``space_to_depth`` and ``depth_to_space``.

Counterpart of ``mxnet_tpu/ops/matrix.py:23-125,260-287,343-353,
372-470``, with its own copy of ``_infer_reshape_shape``.  ``transpose``
returns a contiguous tensor, so the op after it (the RNN's input
projection, a ``Reshape``) reads memory in its own order.  The JAX
package lowers ``space_to_depth``/``depth_to_space`` as a one-hot
convolution, for the TPU's layouts (``:372-392``); here they are a
reshape and a permute, the same channel orders: ``depth_major``, out
channel ``(by * block + bx) * C + c`` (MXNet's), and ``group_major``,
``c * block^2 + by * block + bx`` (``F.pixel_unshuffle``'s).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, attr_bool, attr_int, attr_shape
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


def _pad_pairs(attrs):
    pw = attr_shape(attrs.get("pad_width"))
    return [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]


def _pad_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    pads = _pad_pairs(attrs)
    return in_shapes, [tuple(d + lo + hi for d, (lo, hi) in
                             zip(s, pads))], []


def _pad_index(n, lo, hi, mode, device):
    """Source index of every padded position along an axis of ``n``:
    ``edge`` repeats the end, ``reflect`` mirrors about it (numpy's
    modes, periodic past one reflection)."""
    idx = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return idx.clamp(0, n - 1)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


@register("Pad", arg_names=("data",), aliases=("pad",),
          infer_shape=_pad_infer,
          doc="constant/edge/reflect padding; pad_width has a (before, "
              "after) pair for every axis")
def _pad(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    mode = attrs.get("mode", "constant")
    pads = _pad_pairs(attrs)
    if mode == "constant":
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return [F.pad(x, flat, value=float(attrs.get("constant_value", 0)
                                           or 0))]
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"Pad mode {mode!r} (constant, edge or reflect)")
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            x = x.index_select(axis, _pad_index(x.shape[axis], lo, hi, mode,
                                                x.device))
    return [x]


def _s2d_order(attrs):
    order = attrs.get("channel_order", "depth_major")
    if order not in ("depth_major", "group_major"):
        raise MXNetError(f"channel_order {order!r} (depth_major or "
                         f"group_major)")
    return order


def _s2d_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    b = attr_int(attrs.get("block_size"))
    pad = attr_shape(attrs.get("pad")) or (0, 0)
    n, c, h, w = s
    return in_shapes, [(n, c * b * b, (h + 2 * pad[0]) // b,
                        (w + 2 * pad[1]) // b)], []


@register("space_to_depth", arg_names=("data",), infer_shape=_s2d_infer,
          doc="Blocks of block_size x block_size pixels into channels, "
              "after zero padding by pad; rows and columns past the last "
              "whole block are dropped")
def _space_to_depth(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    b = attr_int(attrs.get("block_size"))
    order = _s2d_order(attrs)
    ph, pw = attr_shape(attrs.get("pad")) or (0, 0)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    n, c, h, w = x.shape
    h, w = h // b, w // b
    x = x[:, :, :h * b, :w * b].reshape(n, c, h, b, w, b)
    perm = (0, 3, 5, 1, 2, 4) if order == "depth_major" \
        else (0, 1, 3, 5, 2, 4)
    return [x.permute(perm).reshape(n, c * b * b, h, w)]


def _d2s_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    b = attr_int(attrs.get("block_size"))
    n, c, h, w = s
    return in_shapes, [(n, c // (b * b), h * b, w * b)], []


@register("depth_to_space", arg_names=("data",), infer_shape=_d2s_infer,
          doc="The inverse of space_to_depth (without its padding)")
def _depth_to_space(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    b = attr_int(attrs.get("block_size"))
    order = _s2d_order(attrs)
    n, cb, h, w = x.shape
    c = cb // (b * b)
    if order == "depth_major":
        x = x.reshape(n, b, b, c, h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        x = x.reshape(n, c, b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return [x.reshape(n, c, h * b, w * b)]
