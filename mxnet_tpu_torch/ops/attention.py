"""Attention ops of the serving path: packed-QKV prefill, paged cache
writes and paged decode.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layouts are the JAX
package's: qkv (B, S, 3*H*D) packed [q | k | v], pools (P, KVB, H, D),
block tables (B, MB) int32 with page 0 as scratch, lengths (B,) int32.

The JAX ops return new pools (buffer donation makes the update in place
under jit, ``serving.py:2045-2047``).  Here the pools are written in
place with ``index_put_``: the functions mutate the pools they are
given and return the same tensors.

``blockwise_attention_partial`` / ``normalize_attention_state`` are the
plain reference of the kernels: the online-softmax body of the JAX lax
path, in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from . import cuda_kernels as ck

__all__ = ["blockwise_attention_partial", "normalize_attention_state",
           "paged_cache_update", "paged_prefill_write",
           "paged_decode_attention", "qkv_self_attention",
           "qkv_self_attention_prefill", "qkv_paged_attention_decode"]


def blockwise_attention_partial(q, k, v, causal: bool = False,
                                block_size: int = 512,
                                lengths: Optional[torch.Tensor] = None):
    """Online-softmax attention over K/V blocks, un-normalized state.

    q (B, Tq, H, D), k/v (B, Tk, H, D) → (o (B, H, Tq, D), m, l
    (B, H, Tq)) in float32, ``out = o / l``.  ``lengths`` (B,) replaces
    the causal mask with the per-stream visibility ``k_pos <
    lengths[b]`` (the decode contract: the single query sits at
    ``lengths[b] - 1``).  A row with nothing visible keeps m = -inf,
    l = 0, o = 0."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    block = min(int(block_size), Tk)
    nblocks = -(-Tk // block)
    qf = q.float()
    dev = q.device
    o = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Tq, device=dev)
    for j in range(nblocks):
        lo, hi = j * block, min((j + 1) * block, Tk)
        k_j = k[:, lo:hi].float()
        v_j = v[:, lo:hi].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_j) * scale
        k_pos = torch.arange(lo, hi, device=dev)
        if lengths is not None:
            mask = k_pos[None, None, None, :] \
                < lengths.to(dev)[:, None, None, None]
        elif causal:
            mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
        else:
            mask = torch.ones((1, 1, 1, hi - lo), dtype=torch.bool,
                              device=dev)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows (m_new = -inf) must not give exp(-inf + inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_j)
        m = m_new
    return o, m, l


def normalize_attention_state(o, m, l, dtype) -> torch.Tensor:
    """(o, m, l) partial state → (B, Tq, H, D) attention output."""
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def _check_qkv_packing(last_dim: int, num_heads: int, shape) -> None:
    """Reject a qkv last dim that is not a positive multiple of
    3*num_heads (which also rejects d_head = 0)."""
    if last_dim % (3 * num_heads) or last_dim < 3 * num_heads:
        raise MXNetError(
            f"QKVSelfAttention: qkv last dim {last_dim} does not pack "
            f"3*num_heads*d_head with num_heads={num_heads}; expected "
            f"(B, T, 3*num_heads*d_head) laid out as contiguous thirds "
            f"[q | k | v] (got shape {tuple(shape)})")


def _unpack_qkv(qkv: torch.Tensor, H: int):
    """Views q, k, v (B, S, H, D) of the packed qkv, and D."""
    B, S, HD3 = qkv.shape
    _check_qkv_packing(HD3, H, qkv.shape)
    D = HD3 // (3 * H)
    q, k, v = (x.unflatten(-1, (H, D)) for x in qkv.split(H * D, dim=-1))
    return q, k, v, D


def _check_decode_step_shape(op_name: str, qkv_shape) -> None:
    if qkv_shape[1] != 1:
        raise MXNetError(
            f"{op_name} feeds ONE query position per step; got qkv "
            f"{tuple(qkv_shape)}")


def paged_cache_update(k_pool, v_pool, k_t, v_t, block_table, lengths):
    """Write the current token's K/V (B, 1, H, D) into the pools at
    position ``lengths - 1``, in place.  Streams with lengths == 0
    (padded batch slots) write to the scratch page 0."""
    KVB = k_pool.shape[1]
    lengths = lengths.long()
    pos = torch.clamp(lengths - 1, min=0)
    rows = torch.arange(block_table.shape[0], device=block_table.device)
    live = lengths > 0
    page = torch.where(live, block_table[rows, pos // KVB].long(), 0)
    slot = torch.where(live, pos % KVB, 0)
    k_pool.index_put_((page, slot), k_t[:, 0].to(k_pool.dtype))
    v_pool.index_put_((page, slot), v_t[:, 0].to(v_pool.dtype))
    return k_pool, v_pool


def _paged_write_coords(block_table, lengths, T: int, KVB: int):
    """(page, slot, live) scatter coordinates for a (B, T, ...) run of
    tokens at positions 0..T-1; rows at or past ``lengths[b]`` (padding)
    route to the scratch page 0."""
    B = block_table.shape[0]
    pos = torch.arange(T, device=block_table.device)[None, :].expand(B, T)
    live = pos < lengths.long()[:, None]
    page = torch.where(
        live, torch.gather(block_table.long(), 1,
                           torch.clamp(pos // KVB,
                                       max=block_table.shape[1] - 1)), 0)
    slot = torch.where(live, pos % KVB, 0)
    return page, slot, live


def paged_prefill_write(k, v, k_pool, v_pool, block_table, lengths):
    """Write a prompt's K/V (B, T, H, D) into the pools through each
    stream's block table, in place; positions >= lengths[b] land on the
    scratch page 0."""
    KVB = k_pool.shape[1]
    page, slot, _ = _paged_write_coords(block_table, lengths, k.shape[1],
                                        KVB)
    k_pool.index_put_((page, slot), k.to(k_pool.dtype))
    v_pool.index_put_((page, slot), v.to(v_pool.dtype))
    return k_pool, v_pool


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths):
    """q (B, 1, H, D) → (B, 1, H, D) over the paged cache through the
    ``paged_attention_decode`` kernel (its plain version on the CPU)."""
    out = ck.paged_attention_decode(q[:, 0], k_pool, v_pool, block_table,
                                    lengths)
    return out[:, None]


def qkv_self_attention(qkv, num_heads: int, causal: bool = False,
                       block_size: int = 0) -> torch.Tensor:
    """Self-attention off the fused QKV projection: qkv (B, T, 3*H*D)
    → (B, T, H*D), through the ``flash_mha_packed`` kernel."""
    if qkv.ndim != 3:
        raise MXNetError("QKVSelfAttention expects (B, T, 3*H*D)")
    out, _ = ck.flash_mha_packed(qkv, num_heads, causal=causal,
                                 block_size=block_size or 512)
    return out


def qkv_self_attention_prefill(qkv, num_heads: int, block_size: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Causal self-attention that also returns the (B, T, H, D) key and
    value state for the cache: (output (B, T, H*D), k, v)."""
    if qkv.ndim != 3:
        raise MXNetError("QKVSelfAttentionPrefill expects (B, T, 3*H*D)")
    _, k, v, _ = _unpack_qkv(qkv, num_heads)
    out = qkv_self_attention(qkv, num_heads, causal=True,
                             block_size=block_size)
    return out, k, v


def qkv_paged_attention_decode(qkv, k_pool, v_pool, block_table, lengths,
                               num_heads: int):
    """One decode step over the paged cache: qkv (B, 1, 3*H*D) of the
    current token at position lengths-1 → (output (B, 1, H*D), k_pool,
    v_pool), the pools written in place with the token's K/V first."""
    _check_decode_step_shape("QKVPagedAttentionDecode", qkv.shape)
    q, k_t, v_t, D = _unpack_qkv(qkv, num_heads)
    paged_cache_update(k_pool, v_pool, k_t, v_t, block_table, lengths)
    out = paged_decode_attention(q, k_pool, v_pool, block_table, lengths)
    B = qkv.shape[0]
    return out.reshape(B, 1, num_heads * D), k_pool, v_pool
