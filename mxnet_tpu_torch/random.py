"""Sampler keying: one counter-based draw per (engine seed, stream seed,
absolute position).

Counterpart of the keying in ``mxnet_tpu/serving.py:sample_tokens``,
where each draw uses ``fold_in(fold_in(base_key, stream_seed),
position)``.  Here the three integers are mixed on the host into one
64-bit seed for an explicit ``torch.Generator`` on the logits' device
(Philox on CUDA, a counter-based generator), so a stream samples the
same tokens whatever batch it rides in.  The bits differ from JAX's
threefry; only the keying contract carries over.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["stream_key", "gumbel_noise"]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_key(engine_seed: int, stream_seed: int, position: int) -> int:
    """A 63-bit generator seed for the draw of ``stream_seed`` at
    ``position`` under ``engine_seed``: distinct triples give unrelated
    seeds, equal triples the same seed."""
    k = _splitmix64(int(engine_seed) & _MASK64)
    k = _splitmix64(k ^ (int(stream_seed) & _MASK64))
    k = _splitmix64(k ^ (int(position) & _MASK64))
    return k >> 1


def gumbel_noise(keys: Sequence[int], n: int,
                 device: torch.device) -> torch.Tensor:
    """(len(keys), n) float32 standard Gumbel noise, row ``i`` drawn
    from a generator seeded with ``keys[i]`` on ``device``."""
    rows = []
    for k in keys:
        g = torch.Generator(device=device)
        g.manual_seed(int(k))
        u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
        rows.append(u)
    u = torch.stack(rows)
    # u in [0, 1): u == 0 maps to -inf (never the argmax), u < 1 always
    return -torch.log(-torch.log(u))
