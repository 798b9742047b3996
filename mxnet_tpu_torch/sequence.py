"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``mxnet_tpu/sequence.py``.  The sequence axis of
(B, T, H, D) tensors is cut into ``sp`` shards, one per device of a
``SequenceMesh``:

* ``ring_attention``: each shard keeps its Q block and the K/V blocks
  travel around the ring, hop by hop; each hop's partial online-softmax
  state (``blockwise_attention_partial``, the ``flash_attention_partial``
  kernel) is merged into the shard's own (``attention_state_merge``), so
  no shard ever holds the (T, T) scores.
* ``ulysses_attention``: an all-to-all re-shards sequence ↔ heads, each
  device attends over the full sequence for H/sp heads, and a second
  all-to-all brings the output back.

The JAX package runs both inside ``shard_map``, one program for every
device of a ``Mesh``.  Here one process drives the shards in turn (a
single controller, as JAX's): shard i's tensors live on
``mesh.devices[i]``, and a hop's K/V rotation or an all-to-all is
``Tensor.to(device)``, which autograd differentiates.  The list may name
one device more than once, the counterpart of the JAX tests' virtual CPU
mesh: then every hop runs on that device and the rotation moves no
bytes.  Gradients flow through autograd: the partial kernel's backward
(``flash_attention_bwd``) once a hop, plus the merges' own tensor ops.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .base import MXNetError
from .context import Context, current_context
from .ops.attention import (attention_state_init, attention_state_merge,
                            blockwise_attention,
                            blockwise_attention_partial,
                            normalize_attention_state)

__all__ = ["SequenceMesh", "sequence_mesh", "ring_attention",
           "ulysses_attention"]


class SequenceMesh:
    """A 1-D mesh over the sequence-parallel axis: ``devices``, one
    ``torch.device`` per shard (repeats allowed), under ``axis_name``."""

    def __init__(self, devices: Sequence[torch.device], axis_name: str):
        self.devices: List[torch.device] = list(devices)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"SequenceMesh({self.axis_name}={self.size}, "
                f"devices={[str(d) for d in self.devices]})")


def _torch_device(d) -> torch.device:
    return d.torch_device() if isinstance(d, Context) else torch.device(d)


def sequence_mesh(sp: Optional[int] = None, devices=None,
                  axis_name: str = "sp") -> SequenceMesh:
    """A 1-D mesh over the sequence-parallel axis: the first ``sp``
    (default: all) of ``devices`` (torch devices, their names, or
    ``Context``s; repeats allowed).  ``devices=None`` is the current
    context's device, once, so ``sp`` > 1 names its devices, e.g.
    ``sequence_mesh(4, ["cuda:0"] * 4)``."""
    devices = [_torch_device(d) for d in (
        devices if devices is not None else [current_context()])]
    sp = sp or len(devices)
    if sp > len(devices):
        raise MXNetError(f"sp={sp} exceeds {len(devices)} devices")
    return SequenceMesh(devices[:sp], axis_name)


def _shards(name: str, x: torch.Tensor, mesh: SequenceMesh, what: str):
    """x (B, T, H, D) cut along T into ``mesh.size`` shards, shard i on
    ``mesh.devices[i]``."""
    if x.ndim != 4:
        raise MXNetError(f"{name} wants (B, T, H, D) tensors; {what} is "
                         f"{tuple(x.shape)}")
    sp = mesh.size
    if x.shape[1] % sp:
        raise MXNetError(f"{name}: {what}'s sequence length {x.shape[1]} is "
                         f"not divisible by sp={sp}")
    return [c.to(d) for c, d in zip(x.chunk(sp, dim=1), mesh.devices)]


def _check_axis(name: str, mesh: SequenceMesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise MXNetError(f"{name}: axis {axis_name!r} is not the mesh's "
                         f"({mesh.axis_name!r})")


def ring_attention(q, k, v, mesh: SequenceMesh, axis_name: str = "sp",
                   causal: bool = False, block_size: int = 512,
                   q_offset: int = 0) -> torch.Tensor:
    """Sequence-parallel attention: (B, Tq, H, D) q and (B, Tkv, H, D)
    k/v global tensors, both T axes cut into ``mesh.size`` shards;
    returns the (B, Tq, H, D) output on q's device.

    Shard i holds q's and k/v's i-th blocks on ``mesh.devices[i]``.  Hop
    0 attends its own K/V; at hops 1..sp-1 every shard receives the K/V
    its left neighbour held (``Tensor.to``), so at hop j it holds shard
    ``(i - j) % sp``'s, attends it with ``kv_offset`` = that block's
    first position minus its own first query's, and merges.  Under
    ``causal`` a block wholly past the shard's last query is skipped,
    the local one too (the JAX ring computes hop 0 always; with a
    ``q_offset`` the local block can lie wholly in the future, and its
    all-masked state merges as a no-op).

    ``q_offset`` is the absolute K/V position of q[0]: 0 for
    self-attention, or the start of one chunk of a long prompt whose
    gathered K/V history is k/v (the decode-time layout, Tq != Tkv).
    Rows equal the same rows of a full causal forward."""
    _check_axis("ring_attention", mesh, axis_name)
    q_offset = int(q_offset)
    sp = mesh.size
    qs = _shards("ring_attention", q, mesh, "q")
    ks = _shards("ring_attention", k, mesh, "k")
    vs = _shards("ring_attention", v, mesh, "v")
    t_q, t_kv = qs[0].shape[1], ks[0].shape[1]

    def attend(i, k_cur, v_cur, src):
        kv_off = src * t_kv - (q_offset + i * t_q)  # k start - q start
        return blockwise_attention_partial(qs[i], k_cur, v_cur,
                                           causal=causal,
                                           block_size=block_size,
                                           kv_offset=kv_off)

    states = [None] * sp
    k_cur, v_cur = ks, vs
    for j in range(sp):
        if j:  # rotate (send right): shard i receives shard i-1's block
            k_cur = [k_cur[(i - 1) % sp].to(mesh.devices[i])
                     for i in range(sp)]
            v_cur = [v_cur[(i - 1) % sp].to(mesh.devices[i])
                     for i in range(sp)]
        for i in range(sp):
            src = (i - j) % sp
            if causal and src * t_kv > q_offset + i * t_q + t_q - 1:
                continue  # no key of this block is visible to the shard
            part = attend(i, k_cur[i], v_cur[i], src)
            # the first block a shard attends is its state: merging it
            # into the empty state would give the same bits
            states[i] = part if states[i] is None \
                else attention_state_merge(*states[i], *part)
    states = [s if s is not None else attention_state_init(x)
              for s, x in zip(states, qs)]
    outs = [normalize_attention_state(o, m, l, q.dtype) for o, m, l in states]
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def ulysses_attention(q, k, v, mesh: SequenceMesh, axis_name: str = "sp",
                      causal: bool = False, block_size: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses): T cut into shards in
    and out, heads cut during the attention itself.  Device i gathers
    the full sequence of heads [i*H/sp, (i+1)*H/sp) from every shard
    (the all-to-all), attends, and the output's heads go back to the
    shards.  H must be divisible by ``mesh.size``.  ``q_offset`` as in
    :func:`ring_attention`: with it, or with Tq != Tkv, each device
    attends through the partial-state kernel with ``kv_offset =
    -q_offset``; plain self-attention goes through ``blockwise_attention``
    (the normalized kernels)."""
    _check_axis("ulysses_attention", mesh, axis_name)
    q_offset = int(q_offset)
    sp = mesh.size
    H = q.shape[2] if q.ndim == 4 else 0
    if H % sp:
        raise MXNetError(f"ulysses needs heads ({H}) divisible by sp ({sp})")
    shards = [_shards("ulysses_attention", x, mesh, w)
              for x, w in ((q, "q"), (k, "k"), (v, "v"))]

    def seq_to_heads(xs):
        # device i: every shard's heads of group i, the full sequence
        return [torch.cat([x.chunk(sp, dim=2)[i].to(d) for x in xs], dim=1)
                for i, d in enumerate(mesh.devices)]

    qf, kf, vf = (seq_to_heads(xs) for xs in shards)
    plain = q_offset == 0 and q.shape[1] == k.shape[1]
    outs = []
    for i in range(sp):
        if plain:
            outs.append(blockwise_attention(qf[i], kf[i], vf[i],
                                            causal=causal,
                                            block_size=block_size))
        else:
            o, m, l = blockwise_attention_partial(
                qf[i], kf[i], vf[i], causal=causal,
                block_size=block_size or 512, kv_offset=-q_offset)
            outs.append(normalize_attention_state(o, m, l, q.dtype))
    # back: shard j takes its rows of every device's heads
    back = [torch.cat([o.chunk(sp, dim=1)[j].to(d) for o in outs], dim=2)
            for j, d in enumerate(mesh.devices)]
    return torch.cat([b.to(q.device) for b in back], dim=1)
