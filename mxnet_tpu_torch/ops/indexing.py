"""Indexing ops: ``Embedding`` and ``take``.

Counterpart of ``mxnet_tpu/ops/indexing.py:20,42``.
"""

from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["embedding", "take"]


def embedding(data: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` (vocab, d) at the ids in ``data`` (any shape;
    float ids, as the JAX package's symbols carry them, are truncated
    to integers)."""
    return weight[data.long()]


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
