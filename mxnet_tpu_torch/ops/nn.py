"""Dense, normalization and activation ops of the transformer LM.

Counterpart of the ``FullyConnected`` (``flatten=False``), ``LayerNorm``
and ``Activation(act_type="gelu")`` ops of ``mxnet_tpu/ops/nn.py``.
The matmul goes to ``torch.matmul``, as the JAX package leaves it to
XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fully_connected", "layer_norm", "gelu"]


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
