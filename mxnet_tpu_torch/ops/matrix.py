"""Shape ops: ``Reshape`` (alias ``reshape``) with MXNet's special codes,
``Flatten``, ``transpose``, ``expand_dims``, ``Concat``, ``Pad`` (alias
``pad``), ``space_to_depth`` and ``depth_to_space``; ``slice``/``crop``,
``slice_axis``, ``flip``/``reverse``, ``dot``, ``batch_dot``,
``SliceChannel``/``split``, ``SwapAxis``, ``repeat`` and ``tile``.

Counterpart of ``mxnet_tpu/ops/matrix.py``, with its own copy of
``_infer_reshape_shape``.  ``dot`` is ``jnp.dot`` (numpy's rule for N-D
operands: the last axis of lhs against the second to last of rhs) and
``dot``/``batch_dot`` give lhs's dtype, as the JAX ops' float32
accumulation cast back; ``SwapAxis`` and ``SliceChannel`` give views.
``transpose`` returns a contiguous tensor, so the op after it (the
RNN's input projection, a ``Reshape``) reads memory in its own order.  The JAX
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


# -- slicing, products, splitting (``mxnet_tpu/ops/matrix.py:141-370``) ----


def _slice_bounds(attrs, shape):
    """(begin, end) of every axis ``slice`` cuts, as Python slices take
    them (negative from the end)."""
    begin = attr_shape(attrs.get("begin"))
    end = attr_shape(attrs.get("end"))
    return [slice(b, e).indices(shape[i])[:2]
            for i, (b, e) in enumerate(zip(begin, end))]


def _slice_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    out = list(s)
    for i, (b, e) in enumerate(_slice_bounds(attrs, s)):
        out[i] = max(0, e - b)
    return in_shapes, [tuple(out)], []


@register("slice", arg_names=("data",), aliases=("crop",),
          infer_shape=_slice_infer,
          doc="x[begin[0]:end[0], begin[1]:end[1], ...] over the leading "
              "len(begin) axes")
def _slice(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x[tuple(slice(b, e) for b, e in _slice_bounds(attrs, x.shape))]]


def _slice_axis_bounds(attrs, shape):
    axis = attr_int(attrs.get("axis")) % len(shape)
    n = shape[axis]
    begin = attr_int(attrs.get("begin"))
    e = attrs.get("end")
    end = n if e in (None, "None", "") else attr_int(e)
    return axis, begin + n if begin < 0 else begin, end + n if end < 0 \
        else end


def _slice_axis_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    axis, begin, end = _slice_axis_bounds(attrs, s)
    out = list(s)
    out[axis] = end - begin
    return in_shapes, [tuple(out)], []


@register("slice_axis", arg_names=("data",), infer_shape=_slice_axis_infer,
          doc="[begin, end) along attrs['axis'] (end None: to the end)")
def _slice_axis(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    axis, begin, end = _slice_axis_bounds(attrs, x.shape)
    return [x.narrow(axis, begin, end - begin)]


@register("flip", arg_names=("data",), aliases=("reverse",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="Reverse along the axes attrs['axis']")
def _flip(op_ctx, attrs, inputs, aux):
    return [torch.flip(inputs[0], attr_shape(attrs.get("axis")))]


def _swap_last(x):
    return x.transpose(-1, -2) if x.ndim > 1 else x


def _dot_operands(attrs, a, b):
    if attr_bool(attrs.get("transpose_a"), False):
        a = _swap_last(a)
    if attr_bool(attrs.get("transpose_b"), False):
        b = _swap_last(b)
    return a, b


def _dot_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    a2, b2 = (tuple(s[:-2]) + (s[-1], s[-2]) if flag and len(s) > 1
              else tuple(s) for s, flag in (
                  (a, attr_bool(attrs.get("transpose_a"), False)),
                  (b, attr_bool(attrs.get("transpose_b"), False))))
    if len(a2) == 1 and len(b2) == 1:
        return in_shapes, [(1,)], []
    if len(b2) == 1:
        return in_shapes, [a2[:-1]], []
    return in_shapes, [a2[:-1] + b2[:-2] + b2[-1:]], []


@register("dot", arg_names=("lhs", "rhs"), infer_shape=_dot_infer,
          doc="numpy's dot (jnp.dot): the last axis of lhs against the "
              "second to last of rhs (its only one when 1-D); transpose_a/"
              "_b swap an operand's last two axes; 1-D . 1-D has shape "
              "(1,); the result in lhs's dtype")
def _dot(op_ctx, attrs, inputs, aux):
    a, b = _dot_operands(attrs, *inputs)
    out = torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))
    out = out.to(inputs[0].dtype)
    return [out.reshape(1) if out.ndim == 0 else out]


def _batch_dot_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    m = a[2] if attr_bool(attrs.get("transpose_a"), False) else a[1]
    n = b[1] if attr_bool(attrs.get("transpose_b"), False) else b[2]
    return in_shapes, [(a[0], m, n)], []


@register("batch_dot", arg_names=("lhs", "rhs"),
          infer_shape=_batch_dot_infer,
          doc="Batched (b, m, k) x (b, k, n) product, transpose_a/_b; the "
              "result in lhs's dtype")
def _batch_dot(op_ctx, attrs, inputs, aux):
    a, b = _dot_operands(attrs, *inputs)
    return [torch.bmm(a, b).to(inputs[0].dtype)]


def _split_geometry(attrs, ndim):
    return (attr_int(attrs.get("num_outputs", 1)),
            attr_int(attrs.get("axis", 1)) % ndim,
            attr_bool(attrs.get("squeeze_axis"), False))


def _slice_channel_infer(attrs, in_shapes):
    s = in_shapes[0]
    n = attr_int(attrs.get("num_outputs", 1))
    if s is None:
        return in_shapes, [None] * n, []
    n, axis, squeeze = _split_geometry(attrs, len(s))
    out = list(s)
    out[axis] = s[axis] // n
    if squeeze and out[axis] == 1:
        del out[axis]
    return in_shapes, [tuple(out)] * n, []


@register("SliceChannel", arg_names=("data",),
          aliases=("slice_channel", "split"),
          out_names=lambda attrs: [f"output{i}" for i in range(
              attr_int(attrs.get("num_outputs", 1)))],
          infer_shape=_slice_channel_infer,
          doc="num_outputs equal parts along attrs['axis'] (1); "
              "squeeze_axis drops that axis when the parts have size 1")
def _slice_channel(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    n, axis, squeeze = _split_geometry(attrs, x.ndim)
    if x.shape[axis] % n:
        raise MXNetError(f"SliceChannel: axis {axis} of {tuple(x.shape)} "
                         f"does not split into {n} equal parts")
    outs = torch.split(x, x.shape[axis] // n, dim=axis)
    if squeeze:
        if x.shape[axis] != n:
            raise MXNetError(f"SliceChannel: squeeze_axis needs parts of "
                             f"size 1, not {x.shape[axis] // n}")
        outs = [o.squeeze(axis) for o in outs]
    return list(outs)


def _swap_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    d1, d2 = attr_int(attrs.get("dim1", 0)), attr_int(attrs.get("dim2", 0))
    out = list(s)
    out[d1], out[d2] = out[d2], out[d1]
    return in_shapes, [tuple(out)], []


@register("SwapAxis", arg_names=("data",), aliases=("swapaxes",),
          infer_shape=_swap_infer, doc="Swap axes dim1 and dim2 (a view)")
def _swapaxis(op_ctx, attrs, inputs, aux):
    return [inputs[0].transpose(attr_int(attrs.get("dim1", 0)),
                                attr_int(attrs.get("dim2", 0)))]


def _repeat_axis(attrs):
    ax = attrs.get("axis")
    return None if ax in (None, "None", "") else attr_int(ax)


def _repeat_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    reps = attr_int(attrs.get("repeats", 1))
    axis = _repeat_axis(attrs)
    if axis is None:
        return in_shapes, [(int(np.prod(s)) * reps,)], []
    out = list(s)
    out[axis] *= reps
    return in_shapes, [tuple(out)], []


@register("repeat", arg_names=("data",), infer_shape=_repeat_infer,
          doc="Repeat each element attrs['repeats'] times along "
              "attrs['axis'] (of the flattened input by default)")
def _repeat(op_ctx, attrs, inputs, aux):
    return [torch.repeat_interleave(inputs[0],
                                    attr_int(attrs.get("repeats", 1)),
                                    dim=_repeat_axis(attrs))]


def _tile_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    reps = attr_shape(attrs.get("reps"))
    n = max(len(s), len(reps))
    s2 = (1,) * (n - len(s)) + tuple(s)
    r2 = (1,) * (n - len(reps)) + tuple(reps)
    return in_shapes, [tuple(a * b for a, b in zip(s2, r2))], []


@register("tile", arg_names=("data",), infer_shape=_tile_infer,
          doc="numpy's tile by attrs['reps']")
def _tile(op_ctx, attrs, inputs, aux):
    return [torch.tile(inputs[0], attr_shape(attrs.get("reps")))]
