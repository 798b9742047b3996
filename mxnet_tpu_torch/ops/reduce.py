"""Reductions and broadcast-to ops: ``sum``/``mean``/``prod``/``max``/
``min``/``nansum``/``nanprod`` (and the ``*_axis`` aliases),
``argmax``/``argmin``, ``norm``, ``argmax_channel``, ``broadcast_to``
and ``broadcast_axis``.

Counterpart of ``mxnet_tpu/ops/reduce.py:17-117``.  As there, a
reduction to a scalar gives shape (1,), indices come back as float32,
and ``max``/``min`` split the gradient evenly among tied maxima
(``torch.amax``'s rule, ``jnp.max``'s); integer sums keep their dtype.
"""

from __future__ import annotations

import torch

from ..base import attr_bool, attr_int, attr_shape
from .registry import register

__all__ = []


def _parse_axis(attrs, ndim):
    """The reduced axes (non-negative) of attrs['axis'], None for all."""
    ax = attrs.get("axis")
    if ax is None or str(ax) in ("", "()", "[]", "None"):
        return None
    s = str(ax)
    axes = attr_shape(ax) if ("," in s or s.startswith("(")) \
        else (attr_int(ax),)
    return tuple(a % ndim for a in axes)


def _reduce_shape(in_shape, axis, keepdims):
    axes = tuple(range(len(in_shape))) if axis is None else axis
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(in_shape))
    out = tuple(s for i, s in enumerate(in_shape) if i not in axes)
    return out if out else (1,)


def _prod(x, axes, keepdims):
    # torch.prod takes one dim: reduce the axes from the last down
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _float(fn):
    """``fn`` over a float view of an integer input (``jnp.mean`` of an
    integer array is float32)."""
    return lambda x, axes, k: fn(x if x.is_floating_point() else x.float(),
                                 axes, k)


def _same_dtype(fn):
    """``fn`` cast back to the input's dtype (``jnp.sum`` keeps int32,
    ``torch.sum`` widens to int64)."""
    return lambda x, axes, k: fn(x, axes, k).to(x.dtype)


_REDUCE = {
    "sum": _same_dtype(lambda x, a, k: torch.sum(x, dim=a, keepdim=k)),
    "mean": _float(lambda x, a, k: torch.mean(x, dim=a, keepdim=k)),
    "prod": _same_dtype(_prod),
    "max": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
    "nansum": _same_dtype(lambda x, a, k: torch.nansum(x, dim=a,
                                                       keepdim=k)),
    "nanprod": _same_dtype(lambda x, a, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), a, k)),
}
_REDUCE_ALIASES = {"sum": ("sum_axis",), "max": ("max_axis",),
                   "min": ("min_axis",)}


def _reduce_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], []
    keepdims = attr_bool(attrs.get("keepdims"), False)
    return in_shapes, [_reduce_shape(s, _parse_axis(attrs, len(s)),
                                     keepdims)], []


def _make_reduce(name, fn):
    def compute(op_ctx, attrs, inputs, aux):
        x = inputs[0]
        axes = _parse_axis(attrs, x.ndim)
        if axes is None:
            axes = tuple(range(x.ndim))
        out = fn(x, axes, attr_bool(attrs.get("keepdims"), False))
        return [out.reshape(1) if out.ndim == 0 else out]

    register(name, arg_names=("data",), infer_shape=_reduce_infer,
             aliases=_REDUCE_ALIASES.get(name, ()),
             doc=f"Reduction {name} over attrs['axis'] (all axes by "
                 f"default), keepdims optional")(compute)


for _n, _f in _REDUCE.items():
    _make_reduce(_n, _f)


def _make_index_reduce(name, fn):
    def compute(op_ctx, attrs, inputs, aux):
        x = inputs[0]
        axes = _parse_axis(attrs, x.ndim)
        if axes is None:
            out = fn(x.reshape(-1), 0)
        else:
            out = fn(x, axes[0])
            if attr_bool(attrs.get("keepdims"), False):
                out = out.unsqueeze(axes[0])
        return [(out.reshape(1) if out.ndim == 0 else out).float()]

    register(name, arg_names=("data",), infer_shape=_reduce_infer,
             doc=f"{name} along attrs['axis'] (of the flattened input by "
                 f"default), as float32; the first of tied values")(compute)


_make_index_reduce("argmax", lambda x, a: torch.argmax(x, dim=a))
_make_index_reduce("argmin", lambda x, a: torch.argmin(x, dim=a))


@register("norm", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [(1,)], []),
          doc="The L2 norm of all elements, shape (1,)")
def _norm(op_ctx, attrs, inputs, aux):
    return [torch.sqrt(torch.sum(torch.square(inputs[0]))).reshape(1)]


@register("argmax_channel", arg_names=("data",),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None else tuple(s[0][:1])], []),
          doc="argmax over axis 1, as float32")
def _argmax_channel(op_ctx, attrs, inputs, aux):
    return [torch.argmax(inputs[0], dim=1).float()]


def _broadcast_to_shape(attrs, shape):
    target = attr_shape(attrs.get("shape"))
    return tuple(shape[i] if t == 0 else t for i, t in enumerate(target))


@register("broadcast_to", arg_names=("data",),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None
                  else _broadcast_to_shape(attrs, s[0])], []),
          doc="Broadcast to attrs['shape'] (0 keeps an axis)")
def _broadcast_to(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x.expand(_broadcast_to_shape(attrs, x.shape))]


def _broadcast_axis_shape(attrs, shape):
    out = list(shape)
    for a, size in zip(attr_shape(attrs.get("axis")),
                       attr_shape(attrs.get("size"))):
        out[a] = size
    return tuple(out)


@register("broadcast_axis", arg_names=("data",), aliases=("broadcast_axes",),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None
                  else _broadcast_axis_shape(attrs, s[0])], []),
          doc="Broadcast the size-1 axes attrs['axis'] to attrs['size']")
def _broadcast_axis(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return [x.expand(_broadcast_axis_shape(attrs, x.shape))]
