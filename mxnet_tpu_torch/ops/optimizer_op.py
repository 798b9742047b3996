"""Optimizer updates as imperative ops: ``sgd_update``, ``sgd_mom_update``
and ``adam_update``, functional: they return the new weight (and
states), which the caller assigns (``out=``).

Counterpart of ``mxnet_tpu/ops/optimizer_op.py:20-81``, its formulas:
the gradient rescaled by rescale_grad and clipped to +-clip_gradient
(when positive); SGD adds wd * w to it; Adam takes its moments from the
decay-free gradient and decays the weight directly.  The ``Optimizer``
classes (``optimizer.py``) run their own segments and do not use these.
"""

from __future__ import annotations

import torch

from ..base import attr_float
from .registry import register

__all__ = []


def _prep_grad(grad, attrs):
    g = grad * attr_float(attrs.get("rescale_grad", 1.0), 1.0)
    clip = attr_float(attrs.get("clip_gradient", -1.0), -1.0)
    return torch.clamp(g, -clip, clip) if clip > 0 else g


def _same_as_inputs(n_out):
    def infer(attrs, in_shapes):
        known = next((s for s in in_shapes if s is not None), None)
        return in_shapes, [known] * n_out, []

    return infer


@register("sgd_update", arg_names=("weight", "grad"),
          infer_shape=_same_as_inputs(1),
          doc="w - lr * (clip(rescale_grad * grad) + wd * w)")
def _sgd_update(op_ctx, attrs, inputs, aux):
    w, grad = inputs
    g = _prep_grad(grad, attrs) + attr_float(attrs.get("wd", 0.0), 0.0) * w
    return [w - attr_float(attrs.get("lr"), 0.01) * g]


@register("sgd_mom_update", arg_names=("weight", "grad", "mom"),
          out_names=("weight", "mom"), infer_shape=_same_as_inputs(2),
          doc="mom' = momentum * mom - lr * (clip(rescale_grad * grad) + "
              "wd * w); w' = w + mom'")
def _sgd_mom_update(op_ctx, attrs, inputs, aux):
    w, grad, mom = inputs
    g = _prep_grad(grad, attrs) + attr_float(attrs.get("wd", 0.0), 0.0) * w
    new_mom = attr_float(attrs.get("momentum", 0.0), 0.0) * mom \
        - attr_float(attrs.get("lr"), 0.01) * g
    return [w + new_mom, new_mom]


@register("adam_update", arg_names=("weight", "grad", "mean", "var"),
          out_names=("weight", "mean", "var"),
          infer_shape=_same_as_inputs(3),
          doc="Adam without bias correction: the moments of the clipped, "
              "rescaled gradient; w' = (1 - lr * wd) * w - lr * mean' / "
              "(sqrt(var') + epsilon)")
def _adam_update(op_ctx, attrs, inputs, aux):
    w, grad, mean, var = inputs
    lr = attr_float(attrs.get("lr"), 0.001)
    beta1 = attr_float(attrs.get("beta1", 0.9), 0.9)
    beta2 = attr_float(attrs.get("beta2", 0.999), 0.999)
    eps = attr_float(attrs.get("epsilon", 1e-8), 1e-8)
    wd = attr_float(attrs.get("wd", 0.0), 0.0)
    g = _prep_grad(grad, attrs)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    new_w = (1.0 - lr * wd) * w - lr * new_mean / (torch.sqrt(new_var) + eps)
    return [new_w, new_mean, new_var]
