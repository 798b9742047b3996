"""Spatial ops: ``ROIPooling``, ``GridGenerator``, ``SpatialTransformer``,
``BilinearSampler`` and ``Correlation``.

Counterpart of ``mxnet_tpu/ops/spatial.py:33-295``, written as the JAX
ops compute, so their numbers are the JAX ones (not ``F.grid_sample``'s
or a ``roi_pool``'s):

- ``ROIPooling`` rounds each box's corners (half to even) after
  ``spatial_scale``, cuts it into ``pooled_size`` bins of
  floor/ceil edges, and max-pools each bin as a masked maximum over the
  image (an empty bin gives 0; tied maxima share the gradient);
- bilinear sampling maps a grid in [-1, 1] onto pixel centres with the
  corners aligned (``(g + 1) * (size - 1) / 2``) and reads 0 for each of
  the four neighbours that lies outside the image;
- the affine grid is ``jnp.linspace(-1, 1, n)``'s arithmetic;
- every division is a true division (``_div``), as XLA's: on a CUDA
  tensor torch divides by a Python number through its reciprocal, one
  unit off in the last place, which moves a bin edge or a grid point
  that lands on an integer;
- ``Correlation`` is FlowNet's: a loop over the displacements of
  kernel-window products (or absolute differences) averaged over
  kernel * kernel * channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, attr_bool, attr_float, attr_int, attr_shape
from .registry import register

__all__ = []


def _div(x, d):
    """x / d for a number d, correctly rounded on every device."""
    return x / x.new_full((), d)


def _roi_pooling_infer(attrs, in_shapes):
    d, r = in_shapes
    if d is None or r is None:
        return in_shapes, [None], []
    ph, pw = attr_shape(attrs.get("pooled_size"), (1, 1))
    return in_shapes, [(r[0], d[1], ph, pw)], []


def _bin_edges(lo, extent, n, pos):
    """(R, n, size) True where pixel ``pos`` lies in bin i of each box:
    rows [floor(lo + i * extent / n), ceil(lo + (i + 1) * extent / n))."""
    width = _div(extent, n)
    i = torch.arange(n, dtype=torch.float32, device=lo.device)
    start = torch.floor(lo[:, None] + i * width[:, None])
    end = torch.ceil(lo[:, None] + (i + 1.0) * width[:, None])
    return (pos >= start[..., None]) & (pos < end[..., None])


@register("ROIPooling", arg_names=("data", "rois"),
          infer_shape=_roi_pooling_infer,
          doc="Max pooling of each box (batch index, x1, y1, x2, y2) of "
              "rois into pooled_size bins")
def _roi_pooling(op_ctx, attrs, inputs, aux):
    data, rois = inputs
    ph, pw = attr_shape(attrs.get("pooled_size"), (1, 1))
    scale = attr_float(attrs.get("spatial_scale", 1.0), 1.0)
    _, _, H, W = data.shape
    r = rois.float()
    x1, y1, x2, y2 = (torch.round(r[:, j] * scale) for j in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1.0, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1.0, 1.0)
    dev = data.device
    rows = _bin_edges(y1, rh, ph, torch.arange(H, dtype=torch.float32,
                                               device=dev))
    cols = _bin_edges(x1, rw, pw, torch.arange(W, dtype=torch.float32,
                                               device=dev))
    mask = rows[:, :, None, :, None] & cols[:, None, :, None, :]
    img = data[r[:, 0].long()]                          # (R, C, H, W)
    neg = torch.finfo(data.dtype).min
    vals = torch.where(mask[:, None], img[:, :, None, None], neg)
    out = torch.amax(vals, dim=(-2, -1))                # (R, C, ph, pw)
    empty = ~mask.any(dim=-1).any(dim=-1)
    return [torch.where(empty[:, None], 0.0, out).to(data.dtype)]


def _bilinear_sample(img, gx, gy):
    """img (B, C, H, W); gx, gy (B, Ho, Wo) in [-1, 1] -> (B, C, Ho, Wo),
    zero outside the image."""
    B, C, H, W = img.shape
    x = (gx + 1.0) * (W - 1) / 2.0
    y = (gy + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    flat = img.reshape(B, C, H * W)

    def gather(yy, xx):
        inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long())
        v = torch.gather(flat, 2, idx.reshape(B, 1, -1).expand(B, C, -1))
        v = v.reshape(B, C, *gx.shape[1:])
        return torch.where(inside[:, None], v, 0.0)

    dx, dy = dx[:, None], dy[:, None]
    return (gather(y0, x0) * (1 - dx) * (1 - dy)
            + gather(y0, x0 + 1) * dx * (1 - dy)
            + gather(y0 + 1, x0) * (1 - dx) * dy
            + gather(y0 + 1, x0 + 1) * dx * dy)


def _linspace(n, device):
    """``jnp.linspace(-1, 1, n)`` in float32, its arithmetic: start * (1
    - step) + stop * step with step = i / (n - 1), the end point
    exact."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    step = _div(torch.arange(n - 1, dtype=torch.float32, device=device),
                n - 1)
    return torch.cat([-1.0 * (1 - step) + step,
                      torch.ones(1, device=device)])


def _affine_grid(theta, h, w):
    """theta (B, 6), a row-major 2 x 3 matrix each -> gx, gy (B, h, w)."""
    xt = _linspace(w, theta.device)
    yt = _linspace(h, theta.device)
    gy_t, gx_t = torch.meshgrid(yt, xt, indexing="ij")
    t = theta.reshape(-1, 2, 3)[:, :, :, None, None]
    gx = t[:, 0, 0] * gx_t + t[:, 0, 1] * gy_t + t[:, 0, 2]
    gy = t[:, 1, 0] * gx_t + t[:, 1, 1] * gy_t + t[:, 1, 2]
    return gx, gy


def _grid_generator_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if str(attrs.get("transform_type", "affine")) == "affine":
        h, w = attr_shape(attrs.get("target_shape"), (0, 0))
        if h == 0 or w == 0:
            raise MXNetError("GridGenerator(affine) needs target_shape")
        return in_shapes, [(d[0], 2, h, w)], []
    return in_shapes, [d], []


@register("GridGenerator", arg_names=("data",),
          infer_shape=_grid_generator_infer,
          doc="A (B, 2, h, w) sampling grid in [-1, 1] from affine "
              "parameters (B, 6) and target_shape, or from a (B, 2, H, "
              "W) pixel flow (warp)")
def _grid_generator(op_ctx, attrs, inputs, aux):
    data = inputs[0]
    ttype = str(attrs.get("transform_type", "affine"))
    if ttype == "affine":
        h, w = attr_shape(attrs.get("target_shape"), (0, 0))
        return [torch.stack(_affine_grid(data, h, w), dim=1)]
    if ttype != "warp":
        raise MXNetError(f"unknown transform_type {ttype!r}")
    _, _, H, W = data.shape
    ys = torch.arange(H, dtype=torch.float32, device=data.device)
    xs = torch.arange(W, dtype=torch.float32, device=data.device)
    base_y, base_x = torch.meshgrid(ys, xs, indexing="ij")
    gx = _div((data[:, 0] + base_x) * 2.0, max(W - 1, 1)) - 1.0
    gy = _div((data[:, 1] + base_y) * 2.0, max(H - 1, 1)) - 1.0
    return [torch.stack([gx, gy], dim=1)]


def _target_hw(attrs, d):
    h, w = attr_shape(attrs.get("target_shape"), (0, 0))
    return (d[2], d[3]) if h == 0 or w == 0 else (h, w)


@register("SpatialTransformer", arg_names=("data", "loc"),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None
                  else (s[0][0], s[0][1]) + _target_hw(attrs, s[0])], []),
          doc="Bilinear sampling of data on the affine grid of loc (B, 6) "
              "at target_shape (the input's by default)")
def _spatial_transformer(op_ctx, attrs, inputs, aux):
    data, loc = inputs
    if str(attrs.get("transform_type", "affine")) != "affine" \
            or str(attrs.get("sampler_type", "bilinear")) != "bilinear":
        raise MXNetError("SpatialTransformer supports affine + bilinear")
    h, w = _target_hw(attrs, data.shape)
    return [_bilinear_sample(data, *_affine_grid(loc, h, w))]


@register("BilinearSampler", arg_names=("data", "grid"),
          infer_shape=lambda attrs, s: (
              s, [None if s[0] is None or s[1] is None
                  else (s[0][0], s[0][1], s[1][2], s[1][3])], []),
          doc="Bilinear sampling of data at grid (B, 2, Ho, Wo), x then "
              "y in [-1, 1]")
def _bilinear_sampler(op_ctx, attrs, inputs, aux):
    data, grid = inputs
    return [_bilinear_sample(data, grid[:, 0], grid[:, 1])]


def _corr_geometry(attrs, h, w):
    kernel = attr_int(attrs.get("kernel_size", 1), 1)
    max_disp = attr_int(attrs.get("max_displacement", 1), 1)
    stride1 = attr_int(attrs.get("stride1", 1), 1)
    stride2 = attr_int(attrs.get("stride2", 1), 1)
    pad = attr_int(attrs.get("pad_size", 0), 0)
    border = max_disp + (kernel - 1) // 2
    top_h = int(math.ceil(float(h + 2 * pad - 2 * border) / stride1))
    top_w = int(math.ceil(float(w + 2 * pad - 2 * border) / stride1))
    grid_radius = max_disp // stride2
    return (kernel, max_disp, stride1, stride2, pad, top_h, top_w,
            grid_radius, 2 * grid_radius + 1)


def _correlation_infer(attrs, in_shapes):
    d1 = in_shapes[0]
    if d1 is None:
        return in_shapes, [None], []
    geo = _corr_geometry(attrs, d1[2], d1[3])
    return in_shapes, [(d1[0], geo[-1] ** 2, geo[5], geo[6])], []


@register("Correlation", arg_names=("data1", "data2"),
          infer_shape=_correlation_infer,
          doc="FlowNet's correlation of data1's windows with data2's at "
              "each displacement up to max_displacement (stride2 apart)")
def _correlation(op_ctx, attrs, inputs, aux):
    d1, d2 = inputs
    _, C, H, W = d1.shape
    (kernel, max_disp, stride1, stride2, pad, top_h, top_w, grid_radius,
     grid_width) = _corr_geometry(attrs, H, W)
    multiply = attr_bool(attrs.get("is_multiply", True), True)
    p1 = F.pad(d1, (pad, pad, pad, pad))
    p2 = F.pad(d2, (pad, pad, pad, pad))
    dev = d1.device
    y1 = torch.arange(top_h, device=dev) * stride1 + max_disp
    x1 = torch.arange(top_w, device=dev) * stride1 + max_disp

    def window(p, dy, dx):
        return p[:, :, (y1 + dy)[:, None], (x1 + dx)[None, :]]

    a_win = {(kh, kw): window(p1, kh, kw)
             for kh in range(kernel) for kw in range(kernel)}
    chans = []
    for ti in range(grid_width * grid_width):
        s2o = (ti % grid_width - grid_radius) * stride2
        s2p = (ti // grid_width - grid_radius) * stride2
        acc = 0.0
        for (kh, kw), a in a_win.items():
            b = window(p2, s2p + kh, s2o + kw)
            acc = acc + (torch.sum(a * b, dim=1) if multiply
                         else torch.sum(torch.abs(a - b), dim=1))
        chans.append(_div(acc, kernel * kernel * C))
    return [torch.stack(chans, dim=1)]
