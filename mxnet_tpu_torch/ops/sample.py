"""Random sampling ops, nodes without inputs that draw: ``_sample_uniform``
(``uniform``, ``_random_uniform``), ``_sample_normal`` (``normal``,
``_random_normal``), ``_sample_gamma`` (``_random_gamma``) and
``_sample_exponential`` (``_random_exponential``).

Counterpart of ``mxnet_tpu/ops/sample.py:31-67``.  The JAX ops draw from
threefry keys, which torch's generators cannot reproduce, so the port
holds their shapes, dtypes and distributions, not their values.  Each
draws float32 from the node's generator (``OpContext.rng``: the
executor's per-node generator, the fused step's persistent stream, or
the device's for an eager call) on the node's device, then casts to
attrs['dtype'].  Nothing synchronizes with the host, so a CUDA graph
holds them and each replay draws anew.
"""

from __future__ import annotations

import torch

from ..base import attr_float, attr_shape
from ..ndarray import torch_dtype
from .registry import register

__all__ = ["gamma_draw"]

# rounds of the gamma sampler's rejection step drawn at once: each
# candidate is accepted with probability >= 0.95 (alpha >= 1), so all
# rounds fail with probability < 0.05 ** 12 ~ 2.4e-16 an element
GAMMA_ROUNDS = 12


def _shape_infer(attrs, in_shapes):
    return [], [attr_shape(attrs.get("shape"))], []


def _uniform(op_ctx, shape):
    return torch.rand(shape, generator=op_ctx.rng, device=op_ctx.device)


def _normal(op_ctx, shape):
    return torch.randn(shape, generator=op_ctx.rng, device=op_ctx.device)


def gamma_draw(generator, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(alpha, 1) float32 draws by Marsaglia and Tsang's method, its
    rejection loop unrolled into ``GAMMA_ROUNDS`` candidates an element
    (the first accepted one is kept; all are drawn, so the work and the
    generator's advance do not depend on the data).  alpha < 1 draws
    Gamma(alpha + 1) and scales by U ** (1 / alpha)."""
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    shape = tuple(shape)
    z = torch.randn((GAMMA_ROUNDS,) + shape, generator=generator,
                    device=device)
    u = torch.rand((GAMMA_ROUNDS,) + shape, generator=generator,
                   device=device)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z
                    + d * (1.0 - v + torch.log(v.clamp_min(1e-30))))
    first = torch.argmax(ok.to(torch.uint8), dim=0, keepdim=True)
    out = d * torch.gather(v, 0, first)[0]
    if boost:
        ub = torch.rand(shape, generator=generator, device=device)
        out = out * ub ** (1.0 / alpha)
    return out


_SAMPLERS = {
    "_sample_uniform": (
        ("uniform", "_random_uniform"),
        lambda ctx, shape, attrs: _uniform(ctx, shape)
        * (attr_float(attrs.get("high", 1.0)) - attr_float(
            attrs.get("low", 0.0))) + attr_float(attrs.get("low", 0.0)),
        "Uniform draws in [low, high)"),
    "_sample_normal": (
        ("normal", "_random_normal"),
        lambda ctx, shape, attrs: _normal(ctx, shape)
        * attr_float(attrs.get("scale", 1.0))
        + attr_float(attrs.get("loc", 0.0)),
        "Gaussian draws of mean loc and deviation scale"),
    "_sample_gamma": (
        ("_random_gamma",),
        lambda ctx, shape, attrs: gamma_draw(
            ctx.rng, attr_float(attrs.get("alpha", 1.0)), shape, ctx.device)
        * attr_float(attrs.get("beta", 1.0)),
        "Gamma draws of shape alpha and scale beta"),
    "_sample_exponential": (
        ("_random_exponential",),
        lambda ctx, shape, attrs: -torch.log1p(-_uniform(ctx, shape))
        / attr_float(attrs.get("lam", 1.0)),
        "Exponential draws of rate lam"),
}


def _make_sampler(name, aliases, draw, doc):
    def compute(op_ctx, attrs, inputs, aux):
        shape = attr_shape(attrs.get("shape"))
        return [draw(op_ctx, shape, attrs).to(
            torch_dtype(attrs.get("dtype", "float32")))]

    register(name, arg_names=(), needs_rng=True, aliases=aliases,
             infer_shape=_shape_infer,
             doc=f"{doc} of attrs['shape'] in attrs['dtype']")(compute)


for _n, (_a, _d, _doc) in _SAMPLERS.items():
    _make_sampler(_n, _a, _d, _doc)
