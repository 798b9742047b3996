"""Dense, convolution, pooling, normalization and activation ops, and
the loss heads.

Counterpart of the ``FullyConnected`` (``:50``), ``Activation``
(``:98``), ``Convolution`` (``:201-295``), ``Pooling`` (``:367-428``),
``BatchNorm`` (``:431-529``), ``LayerNorm`` (``:532``),
``L2Normalization`` (``:608``), ``SoftmaxOutput`` (``:669-768``),
``SoftmaxCELoss`` (``:770-832``) and ``MakeLoss`` (``:878-909``) ops of
``mxnet_tpu/ops/nn.py``.  The matmul and the convolution go to torch,
as the JAX package leaves them to XLA outside any Pallas kernel.

The loss heads keep the reference convention: their backward is
``(p - onehot) * grad_scale`` (``MakeLoss``: ``grad_scale``) from what
the forward saved, with ignored rows zeroed, and the incoming gradient
is ignored (so the executor may seed them with ones).  A label outside
[0, C), such as an ignore label of -1, is never used as an index.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..base import (MXNetError, attr_bool, attr_float, attr_int, attr_shape,
                    not_ported)
from .registry import register

__all__ = ["fully_connected", "layer_norm", "gelu", "fused_mean_var",
           "batch_norm", "softmax_ce_loss", "softmax_output", "make_loss"]


def fully_connected(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` over the last dim (``flatten=False``);
    weight is (out, in), the JAX package's layout."""
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer normalization over the last dim, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() \
        + beta.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(x, approximate=False)``."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


# ---------------------------------------------------------------------------
# registered ops
# ---------------------------------------------------------------------------


def _weight_bias_args(attrs):
    if attr_bool(attrs.get("no_bias"), False):
        return ["data", "weight"]
    return ["data", "weight", "bias"]


def _fc_infer(attrs, in_shapes):
    no_bias = attr_bool(attrs.get("no_bias"), False)
    num_hidden = attr_int(attrs.get("num_hidden"))
    flatten = attr_bool(attrs.get("flatten"), True)
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if flatten or len(d) <= 2:
        in_dim = 1
        for x in d[1:]:
            in_dim *= int(x)
        out = (d[0], num_hidden)
    else:
        in_dim = int(d[-1])
        out = tuple(d[:-1]) + (num_hidden,)
    w = (num_hidden, in_dim)
    ins = [tuple(d), w] if no_bias else [tuple(d), w, (num_hidden,)]
    return ins, [out], []


@register("FullyConnected", arg_names=_weight_bias_args,
          infer_shape=_fc_infer, doc="Dense layer: x @ weight.T + bias")
def _fully_connected_op(op_ctx, attrs, inputs, aux):
    data = inputs[0]
    if attr_bool(attrs.get("flatten"), True) and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    bias = None if attr_bool(attrs.get("no_bias"), False) else inputs[2]
    return [fully_connected(data, inputs[1], bias)]


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign, "gelu": gelu}


@register("Activation", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="relu/sigmoid/tanh/softrelu/softsign, and gelu (exact erf)")
def _activation_op(op_ctx, attrs, inputs, aux):
    act = attrs.get("act_type", "relu")
    if act not in _ACTIVATIONS:
        raise MXNetError(f"unknown act_type {act}")
    return [_ACTIVATIONS[act](inputs[0])]


# -- convolution and pooling (NCHW; torch's convolution, as the JAX package
# leaves it to lax.conv_general_dilated outside any Pallas kernel) ----------


def _spatial_attrs(attrs, nd):
    kernel = attr_shape(attrs.get("kernel"))
    stride = attr_shape(attrs.get("stride")) or (1,) * nd
    dilate = attr_shape(attrs.get("dilate")) or (1,) * nd
    pad = attr_shape(attrs.get("pad")) or (0,) * nd
    return kernel, stride, dilate, pad


def _conv_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    nd = len(d) - 2
    kernel, stride, dilate, pad = _spatial_attrs(attrs, nd)
    nf = attr_int(attrs.get("num_filter"))
    groups = attr_int(attrs.get("num_group", 1), 1)
    w = (nf, d[1] // groups) + tuple(kernel)
    no_bias = attr_bool(attrs.get("no_bias"), False)
    ins = [tuple(d), w] + ([] if no_bias else [(nf,)])
    spatial = tuple(
        (d[2 + i] + 2 * pad[i] - (dilate[i] * (kernel[i] - 1) + 1))
        // stride[i] + 1 for i in range(nd))
    return ins, [(d[0], nf) + spatial], []


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", arg_names=_weight_bias_args,
          infer_shape=_conv_infer,
          doc="N-D convolution over NC(D)HW data, (O, I/groups, *k) weights")
def _convolution_op(op_ctx, attrs, inputs, aux):
    data, weight = inputs[0], inputs[1]
    nd = data.ndim - 2
    if nd not in _CONV:
        raise MXNetError(f"Convolution over {nd} spatial dims (1-3)")
    _, stride, dilate, pad = _spatial_attrs(attrs, nd)
    bias = None if attr_bool(attrs.get("no_bias"), False) else inputs[2]
    return [_CONV[nd](data, weight, bias, stride=stride, padding=pad,
                      dilation=dilate,
                      groups=attr_int(attrs.get("num_group", 1), 1))]


def _pool_window(attrs, spatial):
    """(kernel, stride, [(lo, hi) pads]) of a Pooling over ``spatial``:
    ``global_pool`` covers it whole; the ``full`` convention (ceil
    division) widens only the upper pad."""
    nd = len(spatial)
    kernel, stride, _, pad = _spatial_attrs(attrs, nd)
    if attr_bool(attrs.get("global_pool"), False):
        return tuple(spatial), (1,) * nd, [(0, 0)] * nd
    full = attrs.get("pooling_convention", "valid") == "full"
    pads = []
    for i in range(nd):
        hi = pad[i]
        if full:
            insz = spatial[i] + 2 * pad[i]
            out = -(-(insz - kernel[i]) // stride[i]) + 1
            hi += max(0, (out - 1) * stride[i] + kernel[i] - insz)
        pads.append((pad[i], hi))
    return tuple(kernel), tuple(stride), pads


def _pool_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    kernel, stride, pads = _pool_window(attrs, d[2:])
    spatial = tuple((d[2 + i] + lo + hi - kernel[i]) // stride[i] + 1
                    for i, (lo, hi) in enumerate(pads))
    return in_shapes, [tuple(d[:2]) + spatial], []


@register("Pooling", arg_names=("data",), infer_shape=_pool_infer,
          doc="max/avg/sum pooling, valid/full conventions, global_pool")
def _pooling_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    kernel, stride, pads = _pool_window(attrs, x.shape[2:])
    one_d = x.ndim == 3
    if one_d:  # torch pools 1-D windows as 2-D ones of width 1
        x, kernel, stride = x[..., None], kernel + (1,), stride + (1,)
        pads = pads + [(0, 0)]
    # pad explicitly (torch pads only symmetrically, and its ceil mode
    # divides edge windows by a clipped count): -inf for max, 0 for the
    # sums, so avg divides by the whole kernel area, padding included
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat, value=-math.inf if pool_type == "max" else 0.0)
    if pool_type == "max":
        pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
        out = pool(x, kernel, stride)
    else:
        pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
        out = pool(x, kernel, stride,
                   divisor_override=1 if pool_type == "sum" else None)
    return [out[..., 0] if one_d else out]


def fused_mean_var(xf: torch.Tensor, in_dtype: torch.dtype, dims,
                   shift_index):
    """Batch statistics as ``_fused_mean_var`` of ``mxnet_tpu/ops/nn.py:
    431-457`` computes them, over ``dims`` of ``xf`` (the input in float32,
    or in float64 for a float64 input, which the JAX package, without
    64-bit mode, never sees): the
    mean and the biased variance ``max(E[x^2] - E[x]^2, 0)``.  Every
    input dtype but bfloat16 is first shifted by a detached sample of
    each channel, ``xf[shift_index]``, which lies inside the data's
    range, so ``E[x^2] - E[x]^2`` cannot cancel catastrophically where
    |mean| >> std; bfloat16 (8 mantissa bits cannot hold such a spread)
    is unshifted, as there."""
    # torch.maximum, not clamp: at a tie the gradient splits in half, as
    # jnp.maximum's does
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    if in_dtype == torch.bfloat16:
        mean = xf.mean(dim=dims)
        mean_sq = xf.square().mean(dim=dims)
        return mean, torch.maximum(mean_sq - mean.square(), zero)
    shift = xf[shift_index].detach()
    xs = xf - shift
    mean_s = xs.mean(dim=dims)
    var = torch.maximum(xs.square().mean(dim=dims) - mean_s.square(), zero)
    return mean_s + shift.reshape(-1), var


def batch_norm(x, gamma, beta, moving_mean, moving_var, is_train: bool,
               eps: float = 1e-3, momentum: float = 0.9,
               fix_gamma: bool = True, use_global_stats: bool = False):
    """BatchNorm over channel axis 1 → (out, mean, var, new_mean,
    new_var), the port of ``_batch_norm`` (``mxnet_tpu/ops/nn.py:
    465-514``).  In training (without ``use_global_stats``) the batch
    statistics of ``fused_mean_var`` normalize, in the aux dtype, and
    the new moving statistics ``moving * momentum + stat * (1 -
    momentum)`` come back detached (statistics in float32, float64 for a
    float64 input); otherwise the moving statistics are
    constants and come back as they are.  ``fix_gamma`` puts ones in
    gamma's place, so gamma's gradient is zero.  The normalization runs
    in the dtype the operands promote to (float32 statistics promote a
    bfloat16 input) and the output is cast to the input's dtype.

    Not ``F.batch_norm``: its running variance is the unbiased one, its
    momentum is ``1 - momentum`` here, and it updates the running
    tensors in place inside the autograd graph."""
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if is_train and not use_global_stats:
        dims = (0,) + tuple(range(2, x.ndim))
        shift_index = (slice(0, 1), slice(None)) \
            + (slice(0, 1),) * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = fused_mean_var(xf, x.dtype, dims, shift_index)
        mean = mean.to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
        new_mean = (moving_mean * momentum + mean * (1 - momentum)).detach()
        new_var = (moving_var * momentum + var * (1 - momentum)).detach()
    else:
        mean, var = moving_mean.detach(), moving_var.detach()
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (x - mean.reshape(bshape)) * inv.reshape(bshape) \
        * gamma.reshape(bshape) + beta.reshape(bshape)
    return out.to(x.dtype), mean, var, new_mean, new_var


def _bn_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], [None, None]
    c = (d[1],)
    outs = [tuple(d)]
    if attr_bool(attrs.get("output_mean_var"), False):
        outs += [c, c]
    return [tuple(d), c, c], outs, [c, c]


def _bn_outs(attrs):
    if attr_bool(attrs.get("output_mean_var"), False):
        return ["output", "mean", "var"]
    return ["output"]


@register("BatchNorm", arg_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"), out_names=_bn_outs,
          infer_shape=_bn_infer,
          doc="Batch normalization over axis 1 with the moving statistics "
              "as aux states")
def _batch_norm_op(op_ctx, attrs, inputs, aux):
    x, gamma, beta = inputs
    out, mean, var, new_mean, new_var = batch_norm(
        x, gamma, beta, *aux, is_train=op_ctx.is_train,
        eps=attr_float(attrs.get("eps", 1e-3), 1e-3),
        momentum=attr_float(attrs.get("momentum", 0.9), 0.9),
        fix_gamma=attr_bool(attrs.get("fix_gamma"), True),
        use_global_stats=attr_bool(attrs.get("use_global_stats"), False))
    outs = [out]
    if attr_bool(attrs.get("output_mean_var"), False):
        # the moving statistics are the aux storage itself: an output
        # gets its own copy
        outs += [mean.clone(), var.clone()] if new_mean is aux[0] \
            else [mean, var]
    return outs, [new_mean, new_var]


def _ln_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    axis = attr_int(attrs.get("axis", -1), -1) % len(d)
    c = (d[axis],)
    return [tuple(d), c, c], [tuple(d)], []


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          infer_shape=_ln_infer,
          doc="Layer normalization over the last axis")
def _layer_norm_op(op_ctx, attrs, inputs, aux):
    x, gamma, beta = inputs
    if attr_int(attrs.get("axis", -1), -1) % x.ndim != x.ndim - 1:
        raise not_ported("LayerNorm over an axis other than the last")
    if attr_bool(attrs.get("output_mean_var"), False):
        raise not_ported("LayerNorm(output_mean_var=True)")
    return [layer_norm(x, gamma, beta,
                       eps=attr_float(attrs.get("eps", 1e-5), 1e-5))]


_L2_AXES = {"instance": lambda nd: tuple(range(1, nd)),
            "channel": lambda nd: (1,),
            "spatial": lambda nd: tuple(range(2, nd))}


@register("L2Normalization", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="x / sqrt(sum(x^2) + eps) over the instance, channel or "
              "spatial axes")
def _l2_normalization_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    mode = attrs.get("mode", "instance")
    if mode not in _L2_AXES:
        raise MXNetError(f"unknown L2Normalization mode {mode}")
    eps = attr_float(attrs.get("eps", 1e-10), 1e-10)
    norm = torch.sqrt(x.square().sum(dim=_L2_AXES[mode](x.ndim), keepdim=True)
                      + eps)
    return [x / norm]


# -- loss heads ---------------------------------------------------------------


def _sub_onehot_(grad, lab, dim):
    """``grad -= one_hot(lab)`` along ``dim`` in place, ``lab`` holding a
    size-1 ``dim``.  A label outside [0, C) — an ignore label such as -1
    — subtracts nothing, as ``jax.nn.one_hot`` gives it a zero row; it
    is clamped into range only to be a valid index."""
    C = grad.shape[dim]
    inside = ((lab >= 0) & (lab < C)).to(grad.dtype)
    grad.scatter_add_(dim, lab.clamp(0, C - 1), -inside)


class _SoftmaxCELoss(torch.autograd.Function):
    """Per-row cross entropy of logits (..., V) against integer-valued
    labels (...); backward (p - onehot) * grad_scale rebuilt from the
    saved logits and lse."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, use_ignore, ignore_label):
        x = data.float()
        lse = torch.logsumexp(x, dim=-1)
        lab = label.long()
        C = x.shape[-1]
        # take_along_axis wraps a label in [-C, 0) to the class counted
        # from the end and gives NaN for a label outside [-C, C); the
        # clamp only makes such a label a valid index
        safe = torch.where(lab < 0, lab + C, lab).clamp(0, C - 1)
        loss = lse - torch.gather(x, -1, safe[..., None])[..., 0]
        loss = torch.where((lab >= -C) & (lab < C), loss, float("nan"))
        if use_ignore:
            loss = torch.where(lab == int(ignore_label), 0.0, loss)
        ctx.save_for_backward(data, lse, label)
        ctx.cfg = (grad_scale, use_ignore, ignore_label)
        return loss

    @staticmethod
    def backward(ctx, _g):
        data, lse, label = ctx.saved_tensors
        grad_scale, use_ignore, ignore_label = ctx.cfg
        lab = label.long()[..., None]
        grad = torch.exp(data.float() - lse[..., None])
        _sub_onehot_(grad, lab, -1)
        grad.mul_(grad_scale)
        if use_ignore:
            grad.masked_fill_(lab == int(ignore_label), 0.0)
        return grad.to(data.dtype), None, None, None, None


def softmax_ce_loss(data, label, grad_scale: float = 1.0,
                    use_ignore: bool = False, ignore_label: float = -1.0):
    """Fused softmax cross entropy: logits (..., V), labels (...) →
    per-row loss (...) float32; ignored rows give zero loss and zero
    gradient."""
    return _SoftmaxCELoss.apply(data, label, float(grad_scale),
                                bool(use_ignore), float(ignore_label))


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax probabilities; backward (p - onehot) * scale from the
    saved probabilities."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, use_ignore, ignore_label,
                mode, normalization):
        if mode == "multi_output":
            out = torch.softmax(data, dim=1)
        elif mode == "preserve_shape":
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, use_ignore, ignore_label, mode, normalization)
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        grad_scale, use_ignore, ignore_label, mode, normalization = ctx.cfg
        if mode == "multi_output":  # classes on axis 1, labels (B, ...)
            grad = out.clone()
            lab = label.long().unsqueeze(1)
            axis = 1
        else:
            grad = (out.reshape(-1, out.shape[-1]) if mode == "preserve_shape"
                    else out.reshape(out.shape[0], -1)).clone()
            lab = label.reshape(-1, 1).long()
            axis = -1
        _sub_onehot_(grad, lab, axis)
        valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
        if use_ignore:
            valid = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * valid
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid":
            scale = scale / torch.clamp(valid.sum(), min=1.0)
        grad = (grad * scale).reshape(out.shape)
        return grad.to(out.dtype), None, None, None, None, None, None


def softmax_output(data, label, grad_scale: float = 1.0,
                   use_ignore: bool = False, ignore_label: float = -1.0,
                   preserve_shape: bool = False,
                   normalization: str = "null", multi_output: bool = False):
    """Softmax loss head: probabilities over axis 1 with labels (B, ...)
    (``multi_output``), over the last axis (``preserve_shape``) or over
    all but the batch axis."""
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError(f"SoftmaxOutput: normalization {normalization!r}")
    mode = "multi_output" if multi_output else \
        "preserve_shape" if preserve_shape else "flat"
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                bool(use_ignore), float(ignore_label), mode,
                                normalization)


def _softmax_output_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if attr_bool(attrs.get("multi_output"), False):
        lab = (d[0],) + tuple(d[2:])
    elif attr_bool(attrs.get("preserve_shape"), False):
        lab = tuple(d[:-1])
    else:
        lab = (d[0],)
    return [tuple(d), lab], [tuple(d)], []


@register("SoftmaxOutput", arg_names=("data", "label"), aliases=("Softmax",),
          is_loss=True, infer_shape=_softmax_output_infer,
          doc="Softmax loss head; backward = (p - onehot)*scale, ignoring "
              "the head gradient")
def _softmax_output_op(op_ctx, attrs, inputs, aux):
    return [softmax_output(
        inputs[0], inputs[1],
        grad_scale=attr_float(attrs.get("grad_scale", 1.0), 1.0),
        use_ignore=attr_bool(attrs.get("use_ignore"), False),
        ignore_label=attr_float(attrs.get("ignore_label", -1.0), -1.0),
        preserve_shape=attr_bool(attrs.get("preserve_shape"), False),
        normalization=attrs.get("normalization", "null"),
        multi_output=attr_bool(attrs.get("multi_output"), False))]


def _softmax_ce_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    lab = tuple(d[:-1])
    return [tuple(d), lab], [lab], []


@register("SoftmaxCELoss", arg_names=("data", "label"), is_loss=True,
          infer_shape=_softmax_ce_infer,
          doc="Fused softmax cross-entropy loss head: logits (..., V) + "
              "labels (...) -> per-row loss (...)")
def _softmax_ce_op(op_ctx, attrs, inputs, aux):
    return [softmax_ce_loss(
        inputs[0], inputs[1],
        grad_scale=attr_float(attrs.get("grad_scale", 1.0), 1.0),
        use_ignore=attr_bool(attrs.get("use_ignore"), False),
        ignore_label=attr_float(attrs.get("ignore_label", -1.0), -1.0))]


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward ``grad_scale`` everywhere (divided by
    the batch, or by the count of entries above ``valid_thresh``),
    whatever the incoming gradient."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(data)
        ctx.cfg = (grad_scale, normalization, valid_thresh)
        return data.clone()

    @staticmethod
    def backward(ctx, _g):
        data, = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.cfg
        scale = torch.tensor(grad_scale, dtype=data.dtype, device=data.device)
        if normalization == "batch":
            scale = scale / data.shape[0]
        elif normalization == "valid":
            valid = (data > valid_thresh).to(data.dtype).sum()
            scale = scale / torch.clamp(valid, min=1.0)
        return scale.expand(data.shape).clone(), None, None, None


def make_loss(data, grad_scale: float = 1.0, normalization: str = "null",
              valid_thresh: float = 0.0):
    """Treat ``data`` as a loss: its value passes through, its backward
    is ``grad_scale`` (normalized by ``batch`` or ``valid`` count)."""
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError(f"MakeLoss: normalization {normalization!r}")
    return _MakeLoss.apply(data, float(grad_scale), normalization,
                           float(valid_thresh))


@register("MakeLoss", arg_names=("data",), aliases=("make_loss",),
          infer_shape=lambda attrs, s: (s, [s[0]], []), is_loss=True,
          doc="Treat the input as a loss: backward = grad_scale")
def _make_loss_op(op_ctx, attrs, inputs, aux):
    return [make_loss(
        inputs[0], grad_scale=attr_float(attrs.get("grad_scale", 1.0), 1.0),
        normalization=attrs.get("normalization", "null"),
        valid_thresh=attr_float(attrs.get("valid_thresh", 0.0), 0.0))]
