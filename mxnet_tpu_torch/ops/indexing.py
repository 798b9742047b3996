"""Indexing ops: ``Embedding``, ``take``, ``batch_take``, ``one_hot`` and
``where``.

Counterpart of ``mxnet_tpu/ops/indexing.py:20-113``; gradients of the
gathers are autograd's scatter-adds.  Float ids are truncated toward
zero, as the JAX ops' ``astype(int32)``.
"""

from __future__ import annotations

import torch

from ..base import MXNetError, attr_float, attr_int
from ..ndarray import torch_dtype
from .registry import register

__all__ = ["embedding", "take"]


def embedding(data: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` (vocab, d) at the ids in ``data`` (any shape;
    float ids, as the JAX package's symbols carry them, are truncated
    toward zero).  As ``jnp.take`` in fill mode: an id in [-V, 0) wraps
    to the row counted from the end, and an id outside [-V, V) gives a
    row of NaN whose weight gradient is dropped.  Masks on a clamped
    index, so a CUDA tensor needs no host sync and trips no device
    assert."""
    idx = data.long()
    V = weight.shape[0]
    inside = (idx >= -V) & (idx < V)
    rows = weight[torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)]
    return torch.where(inside[..., None], rows, float("nan"))


def take(a: torch.Tensor, indices: torch.Tensor, axis: int = 0,
         mode: str = "clip") -> torch.Tensor:
    """``a`` indexed along ``axis`` by ``indices``; out-of-range ids
    clip (default) or wrap."""
    n = a.shape[axis]
    idx = indices.long()
    if mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise MXNetError(f"take: mode {mode!r} (clip or wrap)")
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = a.shape[:axis % a.ndim] + idx.shape + a.shape[axis % a.ndim + 1:]
    return out.reshape(shape)


def _embedding_infer(attrs, in_shapes):
    d, w = in_shapes
    if w is None:
        w = (attr_int(attrs.get("input_dim")), attr_int(attrs.get("output_dim")))
    if d is None:
        return [d, w], [None], []
    return [d, w], [tuple(d) + (w[1],)], []


@register("Embedding", arg_names=("data", "weight"),
          infer_shape=_embedding_infer,
          doc="Embedding lookup: rows of weight at the ids in data")
def _embedding_op(op_ctx, attrs, inputs, aux):
    return [embedding(inputs[0], inputs[1])]


def _take_infer(attrs, in_shapes):
    a, idx = in_shapes
    if a is None or idx is None:
        return in_shapes, [None], []
    axis = attr_int(attrs.get("axis", 0))
    return in_shapes, [tuple(a[:axis]) + tuple(idx) + tuple(a[axis + 1:])], []


@register("take", arg_names=("a", "indices"), infer_shape=_take_infer,
          doc="a indexed along attrs['axis'] (0) by indices; mode clip "
              "(default) or wrap")
def _take_op(op_ctx, attrs, inputs, aux):
    return [take(inputs[0], inputs[1], axis=attr_int(attrs.get("axis", 0)),
                 mode=attrs.get("mode", "clip"))]


@register("batch_take", arg_names=("a", "indices"),
          infer_shape=lambda attrs, s: (s, [s[1]], []),
          doc="a[i, indices[i]] for every row i of a 2-D a; an index in "
              "[-C, 0) counts from the end, one outside [-C, C) gives NaN "
              "(jnp.take_along_axis's fill)")
def _batch_take(op_ctx, attrs, inputs, aux):
    a, idx = inputs
    idx = idx.long()
    C = a.shape[1]
    inside = (idx >= -C) & (idx < C)
    col = torch.where(idx < 0, idx + C, idx).clamp(0, C - 1)
    picked = a.gather(1, col[:, None])[:, 0]
    if not a.is_floating_point():
        return [picked]
    return [torch.where(inside, picked, float("nan"))]


def _one_hot_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(s) + (attr_int(attrs.get("depth")),)], []


@register("one_hot", arg_names=("indices",), infer_shape=_one_hot_infer,
          doc="on_value where the last axis (of size depth) equals the "
              "index, off_value elsewhere (an index outside [0, depth) "
              "gives a row of off_value), in attrs['dtype']")
def _one_hot(op_ctx, attrs, inputs, aux):
    idx = inputs[0].long()
    depth = attr_int(attrs.get("depth"))
    on = attr_float(attrs.get("on_value", 1.0))
    off = attr_float(attrs.get("off_value", 0.0))
    dt = torch_dtype(attrs.get("dtype", "float32"))
    hot = (idx[..., None] == torch.arange(depth, device=idx.device)).to(dt)
    return [(hot * (on - off) + off).to(dt)]


def _where_infer(attrs, in_shapes):
    c, x, y = in_shapes
    known = x or y
    return [c, known, known], [known], []


@register("where", arg_names=("condition", "x", "y"),
          infer_shape=_where_infer,
          doc="x where condition != 0, else y; a condition of fewer axes "
              "selects whole trailing blocks")
def _where(op_ctx, attrs, inputs, aux):
    cond, x, y = inputs
    if cond.ndim < x.ndim:
        cond = cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim))
    return [torch.where(cond != 0, x, y)]
