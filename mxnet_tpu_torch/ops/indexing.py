"""Indexing ops: ``Embedding`` and ``take``.

Counterpart of ``mxnet_tpu/ops/indexing.py:20,42``; ``Embedding`` is
registered as an op (its weight gradient is autograd's scatter-add).
"""

from __future__ import annotations

import torch

from ..base import MXNetError, attr_int
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
