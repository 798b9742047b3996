"""Dense, convolution, pooling, normalization, activation and dropout
ops, the resampling ops of the CNN families, and the loss heads.

Counterpart of the ``FullyConnected`` (``:50``), ``Activation``
(``:98``), ``LeakyReLU`` (``:121-165``), ``SoftmaxActivation``
(``:185-193``), ``Convolution`` (``:201-295``), ``Deconvolution``
(``:298-365``), ``Pooling`` (``:367-428``), ``BatchNorm``
(``:431-529``), ``LayerNorm`` (``:532``), ``InstanceNorm``
(``:584-605``), ``L2Normalization`` (``:608``), ``LRN`` (``:627-651``),
``Dropout`` (``:654-671``), ``SoftmaxOutput`` (``:669-768``),
``SoftmaxCELoss`` (``:770-832``), ``MakeLoss`` (``:878-909``),
``UpSampling`` (``:981-1040``), ``Crop`` (``:1043-1078``), ``softmax``
and ``log_softmax`` (``:168-182``), the regression heads (``:848-875``),
``SVMOutput`` (``:912-958``), ``softmax_cross_entropy`` (``:962``),
``SequenceLast``/``Mask``/``Reverse`` (``:1081-1145``) and
``IdentityAttachKLSparseReg`` (``:1148``) ops of ``mxnet_tpu/ops/nn.py``.
``LayerNorm`` takes any axis and ``output_mean_var`` (its float32 mean
and 1/sqrt(var + eps), the JAX op's "std").  The matmul and the
convolutions go to torch, as the JAX package leaves them to XLA outside
any Pallas kernel.

Randomness: ``Dropout``'s keep mask comes from ``draw_mask`` and
rrelu's slopes from ``draw_slopes``, each over the generator the
executor hands the node (``OpContext.rng``); tests replace these two
functions to inject the JAX package's own draws.

The loss heads keep the reference convention: their backward is
``(p - onehot) * grad_scale`` (``MakeLoss``: ``grad_scale``; the
regression heads ``grad_scale * (out - label)`` over the elements of a
sample, MAE its sign; ``SVMOutput`` the hinge's) from what the forward
saved, with ignored rows zeroed, and the incoming gradient is ignored
(so the executor may seed them with ones).  A label outside
[0, C), such as an ignore label of -1, is never used as an index.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, attr_bool, attr_float, attr_int, attr_shape
from .registry import register

__all__ = ["fully_connected", "layer_norm", "gelu", "fused_mean_var",
           "batch_norm", "softmax_ce_loss", "softmax_output", "make_loss",
           "draw_mask", "draw_slopes", "dropout"]


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


def draw_slopes(generator: torch.Generator, shape, lower: float,
                upper: float, device) -> torch.Tensor:
    """rrelu's negative slopes: float32 uniforms in [lower, upper) of
    ``shape`` from ``generator``, computed as ``jax.random.uniform``
    scales its bits (``max(lower, u * (upper - lower) + lower)``, the
    bounds and their difference in float32)."""
    lo, hi = np.float32(lower), np.float32(upper)
    u = torch.rand(shape, generator=generator, device=device)
    return (u * float(hi - lo) + float(lo)).clamp_min(float(lo))


def _lrelu_args(attrs):
    if attrs.get("act_type", "leaky") == "prelu":
        return ["data", "gamma"]
    return ["data"]


def _lrelu_infer(attrs, in_shapes):
    d = in_shapes[0]
    if attrs.get("act_type", "leaky") == "prelu":
        g = in_shapes[1] if len(in_shapes) > 1 else None
        if g is None and d is not None:
            g = (d[1],)
        return [d, g], [d], []
    return [d], [d], []


@register("LeakyReLU", arg_names=_lrelu_args, needs_rng=True,
          infer_shape=_lrelu_infer,
          doc="leaky/elu/prelu/gelu/rrelu; rrelu draws one slope a (batch, "
              "channel) in training, their mean otherwise")
def _leaky_relu_op(op_ctx, attrs, inputs, aux):
    act = attrs.get("act_type", "leaky")
    x = inputs[0]
    slope = attr_float(attrs.get("slope", 0.25), 0.25)
    if act == "leaky":
        return [torch.where(x > 0, x, slope * x)]
    if act == "elu":
        return [torch.where(x > 0, x, slope * torch.expm1(x))]
    if act == "prelu":
        gamma = inputs[1].reshape((1, -1) + (1,) * (x.ndim - 2))
        return [torch.where(x > 0, x, gamma * x)]
    if act == "gelu":
        return [gelu(x)]
    if act == "rrelu":
        lo = attr_float(attrs.get("lower_bound", 0.125), 0.125)
        hi = attr_float(attrs.get("upper_bound", 0.334), 0.334)
        if op_ctx.is_train:
            s = draw_slopes(op_ctx.rng, x.shape[:2], lo, hi, x.device)
            s = s.reshape(x.shape[:2] + (1,) * (x.ndim - 2)).to(x.dtype)
        else:
            s = (lo + hi) / 2.0
        return [torch.where(x > 0, x, s * x)]
    raise MXNetError(f"unknown LeakyReLU act_type {act}")


@register("SoftmaxActivation", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="softmax over the channel axis (mode=channel) or over all "
              "but the batch axis (instance)")
def _softmax_activation_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if attrs.get("mode", "instance") == "channel":
        return [torch.softmax(x, dim=1)]
    return [torch.softmax(x.reshape(x.shape[0], -1), dim=-1)
            .reshape(x.shape)]


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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconvolution(data, weight, bias, stride, dilate, pad, adj, groups):
    """Transposed convolution with the reference's (C_in,
    num_filter/groups, *k) weight (``conv_transpose``'s own layout):
    the full transposed output, then ``pad`` cut from each side of every
    spatial axis and ``adj`` added at its end (rows past the full output
    are zero before the bias), so any ``adj`` works, where
    ``output_padding`` must stay below the stride or the dilation."""
    nd = data.ndim - 2
    out = _CONV_T[nd](data, weight, None, stride=stride, dilation=dilate,
                      groups=groups)
    flat = [p for i in reversed(range(nd)) for p in (-pad[i],
                                                     adj[i] - pad[i])]
    if any(flat):
        out = F.pad(out, flat)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _deconv_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    nd = len(d) - 2
    kernel, stride, dilate, pad = _spatial_attrs(attrs, nd)
    adj = attr_shape(attrs.get("adj")) or (0,) * nd
    nf = attr_int(attrs.get("num_filter"))
    groups = attr_int(attrs.get("num_group", 1), 1)
    w = (d[1], nf // groups) + tuple(kernel)
    no_bias = attr_bool(attrs.get("no_bias"), True)
    ins = [tuple(d), w] + ([] if no_bias else [(nf,)])
    spatial = tuple(stride[i] * (d[2 + i] - 1) + dilate[i] * (kernel[i] - 1)
                    + 1 - 2 * pad[i] + adj[i] for i in range(nd))
    return ins, [(d[0], nf) + spatial], []


# the argument list follows ``no_bias`` (default False) as Convolution's
# does, while the bias is added only under an explicit no_bias=False:
# the JAX op's defaults, kept as they are
@register("Deconvolution", arg_names=_weight_bias_args,
          infer_shape=_deconv_infer,
          doc="N-D transposed convolution, (C_in, num_filter/groups, *k) "
              "weights; adj extends the output's end")
def _deconvolution_op(op_ctx, attrs, inputs, aux):
    data, weight = inputs[0], inputs[1]
    nd = data.ndim - 2
    if nd not in _CONV_T:
        raise MXNetError(f"Deconvolution over {nd} spatial dims (1-3)")
    _, stride, dilate, pad = _spatial_attrs(attrs, nd)
    adj = attr_shape(attrs.get("adj")) or (0,) * nd
    bias = None if attr_bool(attrs.get("no_bias"), True) else inputs[2]
    return [deconvolution(data, weight, bias, stride, dilate, pad, adj,
                          attr_int(attrs.get("num_group", 1), 1))]


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
    outs = [tuple(d)]
    if attr_bool(attrs.get("output_mean_var"), False):
        red = tuple(s for i, s in enumerate(d) if i != axis)
        outs += [red, red]
    return [tuple(d), c, c], outs, []


def _ln_outs(attrs):
    if attr_bool(attrs.get("output_mean_var"), False):
        return ["output", "mean", "std"]
    return ["output"]


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          out_names=_ln_outs, infer_shape=_ln_infer,
          doc="Layer normalization over attrs['axis'] (the last by "
              "default); output_mean_var adds the float32 mean and "
              "1/sqrt(var + eps) (the JAX op's 'std'), the axis dropped")
def _layer_norm_op(op_ctx, attrs, inputs, aux):
    x, gamma, beta = inputs
    eps = attr_float(attrs.get("eps", 1e-5), 1e-5)
    ax = attr_int(attrs.get("axis", -1), -1) % x.ndim
    with_stats = attr_bool(attrs.get("output_mean_var"), False)
    if ax == x.ndim - 1 and not with_stats:
        return [layer_norm(x, gamma, beta, eps=eps)]
    xf = x.float()
    mean = xf.mean(dim=ax, keepdim=True)
    var = (xf - mean).square().mean(dim=ax, keepdim=True)
    inv = torch.rsqrt(var + eps)
    bshape = [1] * x.ndim
    bshape[ax] = x.shape[ax]
    out = (xf - mean) * inv * gamma.reshape(bshape).float() \
        + beta.reshape(bshape).float()
    outs = [out.to(x.dtype)]
    if with_stats:
        outs += [mean.squeeze(ax), inv.squeeze(ax)]
    return outs


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


def _in_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    c = (d[1],)
    return [tuple(d), c, c], [tuple(d)], []


@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          infer_shape=_in_infer,
          doc="Instance normalization over the spatial axes, biased "
              "variance")
def _instance_norm_op(op_ctx, attrs, inputs, aux):
    x, gamma, beta = inputs
    eps = attr_float(attrs.get("eps", 1e-3), 1e-3)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    return [(x - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape)]


@register("LRN", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="Local response normalization across channels: x * (knorm "
              "+ alpha / nsize * window sum of x^2) ^ -beta")
def _lrn_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    # F.local_response_norm pads the channel window (nsize // 2,
    # (nsize - 1) // 2), the JAX op's, and wants a spatial axis
    out = F.local_response_norm(
        x if x.ndim > 2 else x[..., None],
        attr_int(attrs.get("nsize", 5), 5),
        alpha=attr_float(attrs.get("alpha", 1e-4), 1e-4),
        beta=attr_float(attrs.get("beta", 0.75), 0.75),
        k=attr_float(attrs.get("knorm", 2.0), 2.0))
    return [out if x.ndim > 2 else out[..., 0]]


def draw_mask(generator: torch.Generator, keep: float, shape,
              device) -> torch.Tensor:
    """A dropout keep mask of ``shape``: True with probability ``keep``,
    a float32 uniform from ``generator`` below ``keep``, as
    ``jax.random.bernoulli`` draws it."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, p: float, generator: torch.Generator):
    """Inverted dropout of ``x`` in training: ``where(mask, x / keep,
    0)`` in ``x``'s dtype, ``keep = 1 - p`` rounded to that dtype (the
    JAX op divides by a weakly typed Python float), the mask from
    ``draw_mask``.  The rounded ``keep`` is a host scalar: a device
    tensor made from it would be a synchronizing copy a call."""
    keep = 1.0 - p
    mask = draw_mask(generator, keep, x.shape, x.device)
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype).item(),
                       0.0)


@register("Dropout", arg_names=("data",), needs_rng=True,
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="Inverted dropout in training; the identity otherwise or at "
              "p <= 0")
def _dropout_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    p = attr_float(attrs.get("p", 0.5), 0.5)
    if not op_ctx.is_train or p <= 0.0:
        return [x]
    return [dropout(x, p, op_ctx.rng)]


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
        scale = torch.full((), grad_scale, dtype=data.dtype,
                           device=data.device)
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


# -- resampling ---------------------------------------------------------------


def _upsampling_args(attrs):
    n = attr_int(attrs.get("num_args", 1), 1)
    if attrs.get("sample_type", "nearest") == "bilinear":
        return ["data", "weight"]
    return [f"arg{i}" for i in range(n)] if n > 1 else ["data"]


def _bilinear_window(scale):
    """(kernel, pad) of the depthwise transposed convolution that is
    bilinear upsampling by ``scale`` (the reference's upsampling.cc)."""
    return 2 * scale - scale % 2, -(-(scale - 1) // 2)


def _upsampling_infer(attrs, in_shapes):
    scale = attr_int(attrs.get("scale", 2), 2)
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if attrs.get("sample_type", "nearest") == "bilinear":
        k, _ = _bilinear_window(scale)
        nf = attr_int(attrs.get("num_filter", d[1]), d[1])
        return ([tuple(d), (nf, 1, k, k)],
                [(d[0], nf, d[2] * scale, d[3] * scale)], [])
    out_c = sum(s[1] for s in in_shapes if s is not None) \
        if len(in_shapes) > 1 else d[1]
    return in_shapes, [(d[0], out_c, d[2] * scale, d[3] * scale)], []


@register("UpSampling", arg_names=_upsampling_args,
          infer_shape=_upsampling_infer,
          doc="Nearest upsampling (several inputs concatenated over "
              "channels) or bilinear, a depthwise Deconvolution whose "
              "weight input is trainable")
def _upsampling_op(op_ctx, attrs, inputs, aux):
    scale = attr_int(attrs.get("scale", 2), 2)
    if attrs.get("sample_type", "nearest") == "bilinear":
        k, pad = _bilinear_window(scale)
        nf = attr_int(attrs.get("num_filter", inputs[0].shape[1]),
                      inputs[0].shape[1])
        return [deconvolution(inputs[0], inputs[1], None, (scale, scale),
                              (1, 1), (pad, pad), (0, 0), nf)]
    # the output is the first input's size times scale; every input is
    # repeated up to it
    oh, ow = inputs[0].shape[2] * scale, inputs[0].shape[3] * scale
    outs = [x.repeat_interleave(oh // x.shape[2], dim=2)
            .repeat_interleave(ow // x.shape[3], dim=3) for x in inputs]
    return [torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]]


def _crop_args(attrs):
    n = attr_int(attrs.get("num_args", 1), 1)
    return ["data", "crop_like"] if n == 2 else ["data"]


def _crop_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if len(in_shapes) == 2 and in_shapes[1] is not None:
        th, tw = in_shapes[1][2], in_shapes[1][3]
    else:
        th, tw = attr_shape(attrs.get("h_w"))
    return in_shapes, [(d[0], d[1], th, tw)], []


@register("Crop", arg_names=_crop_args, infer_shape=_crop_infer,
          doc="Spatial crop to h_w or to crop_like's size, at offset or "
              "centred")
def _crop_op(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if len(inputs) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = attr_shape(attrs.get("h_w"))
    if attr_bool(attrs.get("center_crop"), False):
        oy, ox = (x.shape[2] - th) // 2, (x.shape[3] - tw) // 2
    else:
        oy, ox = attr_shape(attrs.get("offset")) or (0, 0)
    return [x[:, :, oy:oy + th, ox:ox + tw]]


# -- softmax, the regression and SVM heads, the sequence ops (``mxnet_tpu/
# ops/nn.py:168-182, 848-985, 1081-1170``) -----------------------------------


@register("softmax", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="softmax(data / temperature) along attrs['axis'] (-1)")
def _softmax_op(op_ctx, attrs, inputs, aux):
    t = attr_float(attrs.get("temperature", 1.0)) or 1.0
    x = inputs[0]
    if t != 1.0:  # a true division, as jnp's (see elemwise._with_scalar)
        x = x / x.new_full((), t)
    return [torch.softmax(x, dim=attr_int(attrs.get("axis", -1), -1))]


@register("log_softmax", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="log-softmax along attrs['axis'] (-1)")
def _log_softmax_op(op_ctx, attrs, inputs, aux):
    return [torch.log_softmax(inputs[0],
                              dim=attr_int(attrs.get("axis", -1), -1))]


class _LossHead(torch.autograd.Function):
    """A loss head: ``forward(data)`` out, and ``grad(out, label)`` as the
    backward in place of the derivative: the incoming gradient is
    ignored (the reference's loss-head rule) and the label gets none."""

    @staticmethod
    def forward(ctx, data, label, forward, grad):
        out = forward(data)
        ctx.save_for_backward(out, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        return ctx.grad(out, label).to(out.dtype), None, None, None


def _regression(forward, grad):
    """A regression head: ``forward(data)`` out, backward ``grad(out,
    label reshaped to out) * grad_scale / (elements a sample)``."""

    def head(data, label, grad_scale):
        scale = grad_scale / max(1, int(np.prod(data.shape[1:])))
        return _LossHead.apply(
            data, label, forward,
            lambda out, lab: grad(out, lab.reshape(out.shape)) * scale)

    return head


_REGRESSION = {
    "LinearRegressionOutput": _regression(torch.clone, torch.sub),
    "LogisticRegressionOutput": _regression(torch.sigmoid, torch.sub),
    "MAERegressionOutput": _regression(
        torch.clone, lambda o, l: torch.sign(o - l)),
}


def _regression_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    return [tuple(d), tuple(d)], [tuple(d)], []


def _make_regression(name, head):
    def compute(op_ctx, attrs, inputs, aux):
        return [head(inputs[0], inputs[1],
                     attr_float(attrs.get("grad_scale", 1.0), 1.0))]

    register(name, arg_names=("data", "label"), is_loss=True,
             infer_shape=_regression_infer,
             doc=f"{name}: backward grad_scale * (out - label) / (elements "
                 f"a sample) (MAE: its sign), ignoring the head "
                 f"gradient")(compute)


for _n, _h in _REGRESSION.items():
    _make_regression(_n, _h)


@register("SVMOutput", arg_names=("data", "label"), is_loss=True,
          infer_shape=lambda attrs, s: (
              s, [s[0]], []) if s[0] is None
          else ([tuple(s[0]), (s[0][0],)], [tuple(s[0])], []),
          doc="SVM loss head: data out; backward the hinge's, L2 "
              "-2 y reg * max(margin - y * data, 0) or L1 (use_linear) "
              "-y reg where the margin is violated")
def _svm_output_op(op_ctx, attrs, inputs, aux):
    margin = attr_float(attrs.get("margin", 1.0), 1.0)
    reg = attr_float(attrs.get("regularization_coefficient", 1.0), 1.0)
    linear = attr_bool(attrs.get("use_linear"), False)

    def grad(d, lab):
        # y = +1 for the label's class, -1 elsewhere
        hot = lab.long()[:, None] == torch.arange(d.shape[1],
                                                  device=d.device)
        y = 2 * hot.to(d.dtype) - 1
        if linear:
            return -y * ((margin - y * d) > 0).to(d.dtype) * reg
        return -2.0 * y * torch.clamp_min(margin - y * d, 0.0) * reg

    return [_LossHead.apply(inputs[0], inputs[1], torch.clone, grad)]


@register("softmax_cross_entropy", arg_names=("data", "label"),
          infer_shape=lambda attrs, s: (s, [(1,)], []),
          doc="The summed cross entropy of softmax over the last axis "
              "against integer-valued labels (every leading axis), shape "
              "(1,); an ordinary differentiable op, not a loss head")
def _softmax_cross_entropy(op_ctx, attrs, inputs, aux):
    data, label = inputs
    logp = torch.log_softmax(data, dim=-1)
    nll = -torch.gather(logp, -1, label.long()[..., None])
    return [torch.sum(nll).reshape(1)]


def _seq_args(attrs):
    if attr_bool(attrs.get("use_sequence_length"), False):
        return ["data", "sequence_length"]
    return ["data"]


def _seq_lengths(attrs, in_shapes):
    d = in_shapes[0]
    if not attr_bool(attrs.get("use_sequence_length"), False):
        return [d]
    return [d, None if d is None else (d[1],)]


@register("SequenceLast", arg_names=_seq_args,
          infer_shape=lambda attrs, s: (
              _seq_lengths(attrs, s),
              [None if s[0] is None else tuple(s[0][1:])], []),
          doc="The last step of (T, B, ...) data, or step "
              "sequence_length - 1 (clipped into [0, T)) of each sequence")
def _sequence_last(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if not attr_bool(attrs.get("use_sequence_length"), False):
        return [x[-1]]
    idx = (inputs[1].long() - 1).clamp(0, x.shape[0] - 1)
    return [x[idx, torch.arange(x.shape[1], device=x.device)]]


def _steps_before(x, lengths):
    """(T, B, 1, ...) True where step t < the sequence's length."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    mask = t < lengths.long()[None, :]
    return mask.reshape(mask.shape + (1,) * (x.ndim - 2))


@register("SequenceMask", arg_names=_seq_args,
          infer_shape=lambda attrs, s: (_seq_lengths(attrs, s), [s[0]], []),
          doc="attrs['value'] past each sequence's length")
def _sequence_mask(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if not attr_bool(attrs.get("use_sequence_length"), False):
        return [x]
    value = attr_float(attrs.get("value", 0.0), 0.0)
    return [torch.where(_steps_before(x, inputs[1]), x, value).to(x.dtype)]


@register("SequenceReverse", arg_names=_seq_args,
          infer_shape=lambda attrs, s: (_seq_lengths(attrs, s), [s[0]], []),
          doc="Each sequence's first sequence_length steps reversed, the "
              "rest in place (all steps without lengths)")
def _sequence_reverse(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if not attr_bool(attrs.get("use_sequence_length"), False):
        return [torch.flip(x, (0,))]
    lengths = inputs[1].long()
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    src = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return [torch.gather(x, 0, src)]


class _KLSparseReg(torch.autograd.Function):
    """Identity; backward adds the KL sparseness penalty's gradient
    ``penalty * (-target / rho + (1 - target) / (1 - rho))``, rho the
    batch mean of sigmoid(x)."""

    @staticmethod
    def forward(ctx, x, target, penalty):
        ctx.save_for_backward(x)
        ctx.cfg = (target, penalty)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        target, penalty = ctx.cfg
        rho = torch.sigmoid(x).mean(dim=0, keepdim=True)
        pen = penalty * (-target / rho + (1 - target) / (1 - rho))
        return g + pen, None, None


@register("IdentityAttachKLSparseReg", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="Identity whose backward adds a KL sparseness penalty")
def _identity_kl(op_ctx, attrs, inputs, aux):
    return [_KLSparseReg.apply(
        inputs[0], attr_float(attrs.get("sparseness_target", 0.1), 0.1),
        attr_float(attrs.get("penalty", 0.001), 0.001))]
