"""Ordering ops: ``sort``, ``argsort`` and ``topk``.

Counterpart of ``mxnet_tpu/ops/ordering.py:17-99``.  All three stand on
``torch.sort(stable=True)``: ``jnp.sort``/``jnp.argsort`` are stable and
``lax.top_k`` puts the lower index first among ties, where
``torch.topk``'s order at ties is not defined.  A descending ``sort``/
``argsort`` is the ascending one flipped, as the JAX ops build it (tied
indices then come last first); ``topk`` sorts descending (ascending
with ``is_ascend``) stably.  Indices come back as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import attr_bool, attr_int
from .registry import register

__all__ = []


def _axis(attrs, ndim, default=-1):
    ax = attrs.get("axis", default)
    if ax in (None, "None", ""):
        return None
    return attr_int(ax, default) % ndim


def _sorted(attrs, x):
    """(ascending values, their indices, axis) of ``x`` along the axis of
    ``attrs``; a flattened ``x`` along 0 for axis None."""
    ax = _axis(attrs, x.ndim)
    if ax is None:
        x, ax = x.reshape(-1), 0
    vals, idx = torch.sort(x, dim=ax, stable=True)
    return vals, idx, ax


def _sort_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None or _axis(attrs, len(s)) is not None:
        return in_shapes, [s], []
    return in_shapes, [(int(np.prod(s)),)], []


@register("sort", arg_names=("data",), infer_shape=_sort_infer,
          doc="Sort along attrs['axis'] (-1; None flattens), ascending "
              "unless is_ascend=False")
def _sort(op_ctx, attrs, inputs, aux):
    vals, _, ax = _sorted(attrs, inputs[0])
    if not attr_bool(attrs.get("is_ascend"), True):
        vals = torch.flip(vals, (ax,))
    return [vals]


@register("argsort", arg_names=("data",), infer_shape=_sort_infer,
          doc="The indices that sort along attrs['axis'], as float32")
def _argsort(op_ctx, attrs, inputs, aux):
    _, idx, ax = _sorted(attrs, inputs[0])
    if not attr_bool(attrs.get("is_ascend"), True):
        idx = torch.flip(idx, (ax,))
    return [idx.float()]


def _topk_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    ret_typ = attrs.get("ret_typ", "indices")
    out = list(s)
    if ret_typ != "mask":
        out[_axis(attrs, len(s))] = attr_int(attrs.get("k", 1))
    out = tuple(out)
    return in_shapes, [out, out] if ret_typ == "both" else [out], []


@register("topk", arg_names=("data",), infer_shape=_topk_infer,
          out_names=lambda attrs: ["value", "indices"]
          if attrs.get("ret_typ") == "both" else ["output"],
          doc="The k largest (is_ascend: smallest) along attrs['axis']: "
              "ret_typ indices (float32, the default), value, both, or a "
              "0/1 mask in the input's dtype")
def _topk(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    ax = _axis(attrs, x.ndim)
    k = attr_int(attrs.get("k", 1))
    ret_typ = attrs.get("ret_typ", "indices")
    descending = not attr_bool(attrs.get("is_ascend"), False)
    moved = x.movedim(ax, -1)
    idx = torch.sort(moved, dim=-1, descending=descending,
                     stable=True)[1][..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(moved).scatter_(-1, idx, 1.0)
        return [mask.movedim(-1, ax)]
    vals = torch.gather(moved, -1, idx).movedim(-1, ax)
    idx = idx.movedim(-1, ax).float()
    if ret_typ == "value":
        return [vals]
    if ret_typ == "both":
        return [vals, idx]
    return [idx]
