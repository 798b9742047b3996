"""Attention ops of the serving and training paths: packed-QKV self
attention (differentiable), ``DotProductAttention`` over separate q, k,
v (differentiable), prefill, paged cache writes (raw and
quantize-on-write), paged decode, the speculative verify window, the
suffix prefill over cached prefix pages (a prefix-cache hit or one
chunk of a chunked prefill, on the ``flash_attention_partial``
kernel), and the JAX package's ten serving operators over them.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layouts are the JAX
package's: qkv (B, S, 3*H*D) packed [q | k | v], q/k/v (B, T, H, D)
('BTHD') or (B, H, T, D) ('BHTD'), pools (P, KVB, H, D), block tables
(B, MB) int32 with page 0 as scratch, lengths (B,) int32.

The JAX ops return new pools (buffer donation makes the update in place
under jit, ``serving.py:2045-2047``).  Here the pools are written in
place with ``index_put_``: the functions mutate the pools they are
given and return the same tensors.

``_blockwise_attention_partial_plain`` / ``normalize_attention_state``
are the plain reference of the kernels: the online-softmax body of the
JAX lax path, in float32.  ``blockwise_attention_partial`` is the
partial-state API of ``mxnet_tpu.sequence``'s ring and Ulysses
attention, on the ``flash_attention_partial`` kernels through
``_FlashPartialFn``, with ``attention_state_init`` and
``attention_state_merge``.

``_FlashMHAPackedFn`` is the counterpart of the JAX package's
``jax.custom_vjp`` around ``flash_mha_packed``
(``pallas_kernels._flash_mha_packed_fn``): its forward saves (qkv, o,
lse) and its backward runs the backward kernels, each routed like every
kernel wrapper (a CUDA tensor launches the kernel, a CPU tensor runs the
plain version).  ``_FlashMHAFn`` is the same around ``flash_mha``
(``pallas_kernels._flash_mha_fn``), saving (q, k, v, o, lse).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError, attr_bool, attr_int
from . import cuda_kernels as ck
from .registry import register

__all__ = ["blockwise_attention", "blockwise_attention_partial",
           "normalize_attention_state", "attention_state_init",
           "attention_state_merge",
           "paged_cache_update", "paged_prefill_write",
           "paged_decode_attention", "qkv_self_attention",
           "qkv_self_attention_prefill", "qkv_paged_attention_decode",
           "quantize_kv", "dequantize_kv", "paged_prefill_write_q",
           "paged_cache_update_q", "paged_decode_attention_q",
           "qkv_paged_attention_decode_q", "paged_verify_attention",
           "qkv_paged_verify_attend", "prefix_suffix_attention",
           "qkv_paged_prefill_attend", "qkv_paged_prefill_attend_q",
           "cache_update", "qkv_self_attention_decode"]


def _blockwise_attention_partial_plain(q, k, v, causal: bool = False,
                                       block_size: int = 512,
                                       kv_offset: int = 0,
                                       lengths: Optional[torch.Tensor] = None,
                                       kv_len: Optional[torch.Tensor] = None):
    """Online-softmax attention over K/V blocks, un-normalized state: the
    plain body of every attention kernel (the counterpart of the JAX
    package's ``_blockwise_attention_partial_lax``).  It launches nothing,
    on any device.

    q (B, Tq, H, D), k/v (B, Tk, H, D) → (o (B, H, Tq, D), m, l
    (B, H, Tq)) in float32, ``out = o / l``.  ``kv_offset`` is the
    absolute position of k[0] minus that of q[0]: under ``causal`` key j
    is visible to row i when ``j + kv_offset <= i``.  ``lengths`` (B,)
    replaces the causal mask with the per-stream visibility ``k_pos <
    lengths[b]`` (the decode contract: the single query sits at
    ``lengths[b] - 1``).  ``kv_len`` (B,) hides keys ``k_pos >=
    kv_len[b]`` on top of whichever mask applies (the kernel's per-row
    key limit).  A row with nothing visible keeps m = -inf, l = 0,
    o = 0."""
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
            mask = (k_pos + kv_offset)[None, None, None, :] \
                <= q_pos[None, None, :, None]
        else:
            mask = torch.ones((1, 1, 1, hi - lo), dtype=torch.bool,
                              device=dev)
        if kv_len is not None:
            mask = mask & (k_pos[None, None, None, :]
                           < kv_len.to(dev)[:, None, None, None])
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


class _FlashPartialFn(torch.autograd.Function):
    """The partial-state attention with its backward kernels: forward
    ``flash_attention_partial`` → (o, m, l), saving (q, k, v, m) and
    ``kv_offset``; backward ``flash_attention_bwd`` on the cotangents of
    o and l → (dq, dk, dv).  The counterpart of the JAX package's
    ``jax.custom_vjp`` ``_flash_partial_fn``.

    m's cotangent is dropped, exactly as there, and m is marked
    non-differentiable, so autograd spends nothing on it.  Why that is
    exact (``pallas_kernels.py``'s derivation): every consumer of the
    partial state (``normalize_attention_state``, the ring's
    ``attention_state_merge``) is invariant under the rescaling (o, m,
    l) -> (o e^{-c}, m + c, l e^{-c}), which makes the cotangent
    identity m_bar = o_bar·o + l_bar·l hold, and the argmax-subgradient
    terms of m cancel exactly.  The backward therefore treats m as a
    constant: ds_ij = p_ij * (o_bar_i · v_j + l_bar_i), with p_ij =
    exp(q_i·k_j·scale - m_i) under the same masks as the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_size, kv_offset):
        o, m, l = ck.flash_attention_partial(q, k, v, causal, block_size,
                                             kv_offset)
        ctx.save_for_backward(q, k, v, m)
        ctx.cfg = (causal, block_size, kv_offset)
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, dl):
        q, k, v, m = ctx.saved_tensors
        causal, block_size, kv_offset = ctx.cfg
        dq, dk, dv = ck.flash_attention_bwd(q, k, v, m, do, dl, causal,
                                            block_size, kv_offset)
        return dq, dk, dv, None, None, None


def blockwise_attention_partial(q, k, v, causal: bool = False,
                                block_size: int = 512, kv_offset: int = 0):
    """Online-softmax attention over K/V, un-normalized state, through the
    ``flash_attention_partial`` kernel (and its backward kernels when a
    gradient is asked for).

    q (B, Tq, H, D), k/v (B, Tk, H, D) → (o (B, H, Tq, D), m, l
    (B, H, Tq)) in float32 with ``out = o / l`` once every partial state
    is merged (``attention_state_merge``, ``normalize_attention_state``).
    ``kv_offset``, a Python int, is the absolute position of k[0] minus
    that of q[0] (the ring rotation's causal masking across shards); on
    the card it is a kernel argument.  ``block_size`` is the plain
    version's key block; the kernel tiles on its own."""
    return _FlashPartialFn.apply(q, k, v, bool(causal), int(block_size),
                                 kv_offset)


def attention_state_init(q):
    """Empty online-softmax state for q (B, Tq, H, D) → (o, m, l): o
    (B, H, Tq, D) and l zeros, m -inf, float32 on q's device."""
    B, Tq, H, D = q.shape
    o = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    return o, torch.full_like(l, -math.inf), l


def attention_state_merge(o, m, l, o2, m2, l2):
    """Combine two partial online-softmax states (ring accumulation);
    exact when either side is empty (m = -inf): that side's weight is
    0, never exp(-inf + inf)."""
    m_new = torch.maximum(m, m2)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a1 = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), 0.0)
    return (o * a1[..., None] + o2 * a2[..., None], m_new,
            l * a1 + l2 * a2)


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
    page, slot = _token_coords(block_table, lengths, k_pool.shape[1])
    k_pool.index_put_((page, slot), k_t[:, 0].to(k_pool.dtype))
    v_pool.index_put_((page, slot), v_t[:, 0].to(v_pool.dtype))
    return k_pool, v_pool


def _token_coords(block_table, lengths, KVB: int):
    """(page, slot) of each stream's position ``lengths - 1``; streams
    with lengths == 0 map to the scratch page 0."""
    lengths = lengths.long()
    pos = torch.clamp(lengths - 1, min=0)
    rows = torch.arange(block_table.shape[0], device=block_table.device)
    live = lengths > 0
    page = torch.where(live, block_table[rows, pos // KVB].long(), 0)
    slot = torch.where(live, pos % KVB, 0)
    return page, slot


def _paged_write_coords(block_table, lengths, T: int, KVB: int,
                        start=None):
    """(page, slot, live) scatter coordinates for a (B, T, ...) run of
    tokens whose first row sits at position ``start[b]`` (a (B,) tensor,
    or an int for every row; default 0, the whole-prompt prefill); rows
    at or past ``lengths[b]`` (padding) route to the scratch page 0."""
    B = block_table.shape[0]
    pos = torch.arange(T, device=block_table.device)[None, :].expand(B, T)
    if isinstance(start, torch.Tensor):
        pos = pos + start.long()[:, None]
    elif start is not None:
        pos = pos + int(start)
    live = pos < lengths.long()[:, None]
    page = torch.where(
        live, torch.gather(block_table.long(), 1,
                           torch.clamp(pos // KVB,
                                       max=block_table.shape[1] - 1)), 0)
    slot = torch.where(live, pos % KVB, 0)
    return page, slot, live


def paged_prefill_write(k, v, k_pool, v_pool, block_table, lengths,
                        start=None):
    """Write a prompt's (with ``start``: a window's) K/V (B, T, H, D)
    into the pools through each stream's block table, in place;
    positions >= lengths[b] land on the scratch page 0."""
    KVB = k_pool.shape[1]
    page, slot, _ = _paged_write_coords(block_table, lengths, k.shape[1],
                                        KVB, start)
    k_pool.index_put_((page, slot), k.to(k_pool.dtype))
    v_pool.index_put_((page, slot), v.to(v_pool.dtype))
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# quantized pages: int8 / fp8 codes with one float32 scale per (slot, head)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor, qdtype: torch.dtype):
    """Quantize K or V state (..., H, D) to int8 or float8_e4m3fn with
    one float32 scale per (..., H): scale = max|x| / qmax over the D
    lanes (1.0 where that max is 0), int8 codes round half to even and
    clip to +-127, fp8 codes are the nearest e4m3 value.  Returns
    (codes, scale), the JAX package's ``quantize_kv``."""
    from ..kv_cache import KV_QMAX

    qmax = KV_QMAX["int8"] if qdtype == torch.int8 else KV_QMAX["fp8"]
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = x32 / scale[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(qdtype)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: float32 values."""
    return q.float() * scale[..., None]


def _put_codes(pool, coords, codes):
    """``pool[coords] = codes`` in place; an fp8 pool is written through
    its uint8 view (the same bytes), which every device can scatter."""
    if pool.dtype == torch.float8_e4m3fn:
        pool.view(torch.uint8).index_put_(coords, codes.view(torch.uint8))
    else:
        pool.index_put_(coords, codes)


def paged_prefill_write_q(k, v, k_pool, v_pool, k_scale, v_scale,
                          block_table, lengths, start=None):
    """Quantize-on-write form of :func:`paged_prefill_write`: codes land
    in the int8/fp8 pools, their scales in the (P, KVB, H) scale pools,
    all in place."""
    KVB = k_pool.shape[1]
    page, slot, _ = _paged_write_coords(block_table, lengths, k.shape[1],
                                        KVB, start)
    kq, ks = quantize_kv(k, k_pool.dtype)
    vq, vs = quantize_kv(v, v_pool.dtype)
    _put_codes(k_pool, (page, slot), kq)
    _put_codes(v_pool, (page, slot), vq)
    k_scale.index_put_((page, slot), ks)
    v_scale.index_put_((page, slot), vs)
    return k_pool, v_pool, k_scale, v_scale


def paged_cache_update_q(k_pool, v_pool, k_scale, v_scale, k_t, v_t,
                         block_table, lengths):
    """Quantize-on-write form of :func:`paged_cache_update`: the token's
    K/V quantizes against its own per-head scale; slots written before
    are untouched."""
    page, slot = _token_coords(block_table, lengths, k_pool.shape[1])
    kq, ks = quantize_kv(k_t[:, 0], k_pool.dtype)   # (B, H, D), (B, H)
    vq, vs = quantize_kv(v_t[:, 0], v_pool.dtype)
    _put_codes(k_pool, (page, slot), kq)
    _put_codes(v_pool, (page, slot), vq)
    k_scale.index_put_((page, slot), ks)
    v_scale.index_put_((page, slot), vs)
    return k_pool, v_pool, k_scale, v_scale


def paged_decode_attention_q(q, k_pool, v_pool, k_scale, v_scale,
                             block_table, lengths):
    """q (B, 1, H, D) → (B, 1, H, D) over quantized pages through the
    ``paged_attention_decode_quant`` kernel (its plain version on the
    CPU)."""
    out = ck.paged_attention_decode_quant(q[:, 0], k_pool, v_pool, k_scale,
                                          v_scale, block_table, lengths)
    return out[:, None]


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths):
    """q (B, 1, H, D) → (B, 1, H, D) over the paged cache through the
    ``paged_attention_decode`` kernel (its plain version on the CPU)."""
    out = ck.paged_attention_decode(q[:, 0], k_pool, v_pool, block_table,
                                    lengths)
    return out[:, None]


class _FlashMHAPackedFn(torch.autograd.Function):
    """Packed-QKV flash attention with its backward kernels: forward
    ``flash_mha_packed`` → o, saving (qkv, o, lse); backward
    ``flash_mha_packed_bwd`` → dqkv, packed like qkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, block_size):
        o, lse = ck.flash_mha_packed(qkv, num_heads, causal=causal,
                                     block_size=block_size)
        ctx.save_for_backward(qkv, o, lse)
        ctx.cfg = (num_heads, causal, block_size)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        num_heads, causal, block_size = ctx.cfg
        dqkv = ck.flash_mha_packed_bwd(qkv, o, lse, do, num_heads,
                                       causal=causal, block_size=block_size)
        return dqkv, None, None, None


def qkv_self_attention(qkv, num_heads: int, causal: bool = False,
                       block_size: int = 0) -> torch.Tensor:
    """Self-attention off the fused QKV projection: qkv (B, T, 3*H*D)
    → (B, T, H*D), through the ``flash_mha_packed`` kernel, and back
    through its backward kernels when a gradient is asked for."""
    if qkv.ndim != 3:
        raise MXNetError("QKVSelfAttention expects (B, T, 3*H*D)")
    out, _ = _FlashMHAPackedFn.apply(qkv, int(num_heads), bool(causal),
                                     int(block_size or 512))
    return out


def _qkv_infer(attrs, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, None, None
    if len(s) != 3:
        raise MXNetError(
            f"QKVSelfAttention wants a 3-D qkv (B, T, 3*num_heads*d_head); "
            f"got {s}")
    _check_qkv_packing(s[2], attr_int(attrs.get("num_heads", 1), 1), s)
    return in_shapes, [(s[0], s[1], s[2] // 3)], []


@register("QKVSelfAttention", arg_names=("qkv",), infer_shape=_qkv_infer,
          kernel=True,
          doc="Self-attention straight off the fused QKV projection: qkv "
              "(B, T, 3*H*D) packed [q|k|v] -> (B, T, H*D), on the "
              "flash_mha_packed kernels; attrs: num_heads, causal, "
              "block_size")
def _qkv_attention_op(op_ctx, attrs, inputs, aux):
    return [qkv_self_attention(
        inputs[0], attr_int(attrs.get("num_heads", 1), 1),
        causal=attr_bool(attrs.get("causal", False), False),
        block_size=attr_int(attrs.get("block_size", 0), 0))]


class _FlashMHAFn(torch.autograd.Function):
    """Normalized attention over separate q, k, v with its backward
    kernels: forward ``flash_mha`` → o, saving (q, k, v, o, lse);
    backward ``flash_mha_bwd`` → (dq, dk, dv) in the inputs' layouts."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_size):
        o, lse = ck.flash_mha(q, k, v, causal=causal, block_size=block_size)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, block_size)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, block_size = ctx.cfg
        dq, dk, dv = ck.flash_mha_bwd(q, k, v, o, lse, do, causal=causal,
                                      block_size=block_size)
        return dq, dk, dv, None, None


def _lanes_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def blockwise_attention(q, k, v, causal: bool = False, block_size: int = 0,
                        layout: str = "BTHD") -> torch.Tensor:
    """Normalized attention through the ``flash_mha`` kernels (forward,
    and backward when a gradient is asked for).

    layout 'BTHD': q (B, Tq, H, D), k/v (B, Tk, H, D) in and out;
    'BHTD': (B, H, T, D).  Either way the kernels read (B, H, T, D)
    views through their strides: no transpose is copied, and the output
    comes back in the input's layout.  ``block_size`` (0: 512) is the
    plain version's key block."""
    if layout not in ("BTHD", "BHTD"):
        raise MXNetError(f"unknown attention layout {layout!r}")
    if layout == "BTHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    q, k, v = (_lanes_contiguous(x) for x in (q, k, v))
    out, _ = _FlashMHAFn.apply(q, k, v, bool(causal),
                               int(block_size or 512))
    return out.transpose(1, 2) if layout == "BTHD" else out


def _attention_infer(attrs, in_shapes):
    q = in_shapes[0]
    if q is None:
        return in_shapes, None, None
    return in_shapes, [tuple(q)], []


@register("DotProductAttention", arg_names=("query", "key", "value"),
          infer_shape=_attention_infer, aliases=("MultiHeadAttention",),
          kernel=True,
          doc="Fused blockwise multi-head attention: (B, T, H, D) "
              "q/k/v -> (B, T, H, D) on the flash_mha kernels; attrs: "
              "causal, block_size, layout ('BTHD' default | 'BHTD')")
def _attention_op(op_ctx, attrs, inputs, aux):
    q, k, v = inputs
    if q.ndim != 4:
        raise MXNetError("DotProductAttention expects 4-D inputs")
    return [blockwise_attention(
        q, k, v, causal=attr_bool(attrs.get("causal", False), False),
        block_size=attr_int(attrs.get("block_size", 0), 0),
        layout=str(attrs.get("layout", "BTHD")))]


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


def _pool_set(pools):
    """(k_pool, v_pool, k_scale, v_scale) of one layer's pools: two raw
    pools, or two quantized pools and their scales."""
    if len(pools) == 2:
        return pools[0], pools[1], None, None
    if len(pools) == 4:
        return tuple(pools)
    raise MXNetError(f"a layer's pools are [k, v] or [k, v, k_scale, "
                     f"v_scale]; got {len(pools)} tensors")


def qkv_paged_attention_decode_q(qkv, k_pool, v_pool, k_scale, v_scale,
                                 block_table, lengths, num_heads: int):
    """:func:`qkv_paged_attention_decode` over quantized pools: the
    token's K/V quantizes on write, then the query reads every cached
    token (its own included) back through the codes and scales.
    Returns the output (B, 1, H*D); the pools are written in place."""
    _check_decode_step_shape("QKVPagedAttentionDecodeQ", qkv.shape)
    q, k_t, v_t, D = _unpack_qkv(qkv, num_heads)
    paged_cache_update_q(k_pool, v_pool, k_scale, v_scale, k_t, v_t,
                         block_table, lengths)
    out = paged_decode_attention_q(q, k_pool, v_pool, k_scale, v_scale,
                                   block_table, lengths)
    B = qkv.shape[0]
    return out.reshape(B, 1, num_heads * D)


# ---------------------------------------------------------------------------
# speculative verify: W = 1 + k queries per stream in one step
# ---------------------------------------------------------------------------


def paged_verify_attention(q, k_pool, v_pool, block_table, start,
                           k_scale=None, v_scale=None):
    """q (B, W, H, D) at positions ``start[b] + w`` (the window's K/V
    already in the pools) → (B, W, H, D) through the
    ``paged_attention_verify`` kernel (with scales:
    ``paged_attention_verify_quant``); row w equals the decode step at
    ``lengths = start + 1 + w`` over the same pool bytes."""
    return ck.paged_attention_verify(q, k_pool, v_pool, block_table, start,
                                     k_scale, v_scale)


def qkv_paged_verify_attend(qkv, pools, block_table, start, lengths,
                            num_heads: int):
    """One verify step over the paged cache: qkv (B, W, 3*H*D) holds the
    pending token and the drafts at positions ``start[b] + w``.  Their
    K/V is written through the block table at offset ``start`` (rows at
    or past ``lengths[b]``, the padding, land on the scratch page 0;
    quantized pools quantize on write), then every query reads the
    cache back through the pools under the mask k_pos < start + 1 + w,
    its own window keys included, as the decode step reads its own
    token.  ``pools`` is one layer's [k, v] or [k, v, k_scale, v_scale],
    written in place.  Returns (B, W, H*D)."""
    if qkv.ndim != 3:
        raise MXNetError("QKVPagedVerifyAttend expects (B, W, 3*H*D)")
    q, k, v, D = _unpack_qkv(qkv, num_heads)
    k_pool, v_pool, k_scale, v_scale = _pool_set(pools)
    if k_scale is None:
        paged_prefill_write(k, v, k_pool, v_pool, block_table, lengths,
                            start=start)
    else:
        paged_prefill_write_q(k, v, k_pool, v_pool, k_scale, v_scale,
                              block_table, lengths, start=start)
    out = paged_verify_attention(q, k_pool, v_pool, block_table, start,
                                 k_scale, v_scale)
    B, W = qkv.shape[0], qkv.shape[1]
    return out.reshape(B, W, num_heads * D)


# ---------------------------------------------------------------------------
# suffix prefill: the uncached suffix of a prompt over its cached prefix
# ---------------------------------------------------------------------------


def prefix_suffix_attention(q, k_suf, v_suf, kg, vg, start,
                            block: int) -> torch.Tensor:
    """Attention of a suffix prefill, through the
    ``flash_attention_partial`` kernel (its plain version on the CPU).

    q/k_suf/v_suf (B, Ts, H, D) are the uncached suffix at absolute
    positions ``start[b] + i``; kg/vg (B, C, H, D) the table's pages
    gathered from the pools (dequantized for int8/fp8 pages), whose first
    ``start[b]`` slots hold the cached prefix (the rest is the suffix's
    own pages and stale bytes).  ``start`` is a (B,) int32 tensor on q's
    device.  The JAX package's two scans of ``prefix_suffix_attention``
    as two B8 launches: the prefix, non-causal under the per-row key
    limit ``kv_len = start`` (a row with ``start = 0`` gets the exact
    empty state), and the raw suffix, causal at ``kv_offset = 0``; their
    states merge (``attention_state_merge``) and normalize.  The suffix
    attends its own K/V raw, as the full forward would.  ``block`` (the
    page size) is the plain version's key block, the JAX scans' blocks.
    Returns (B, Ts, H, D) in q's dtype."""
    dtype = q.dtype
    if kg.dtype != dtype:
        # dequantized (float32) prefix pages: the softmax runs in float32
        # over float32 operands, as the JAX lax body promotes them
        wide = torch.promote_types(kg.dtype, dtype)
        q, k_suf, v_suf, kg, vg = (x.to(wide) for x in
                                   (q, k_suf, v_suf, kg, vg))
    pre = ck.flash_attention_partial(q, kg, vg, False, block, 0,
                                     kv_len=start)
    suf = ck.flash_attention_partial(q, k_suf, v_suf, True, block, 0)
    return normalize_attention_state(*attention_state_merge(*pre, *suf),
                                     dtype)


def _suffix_start(start, KVB: int, B: int, device) -> torch.Tensor:
    """``start`` (the tokens already cached: a (B,) integer tensor, or an
    int for every row, which must be a non-negative multiple of the page
    size) as a (B,) int32 tensor on ``device``.  A tensor's values are
    not read back to the host (they stay on the card, and a CUDA graph
    replays them): the caller keeps them block-aligned, as the JAX op's
    callers do."""
    if isinstance(start, torch.Tensor):
        if start.shape != (B,):
            raise MXNetError(f"QKVPagedPrefillAttend: start must be ({B},); "
                             f"got {tuple(start.shape)}")
        return start.to(device=device, dtype=torch.int32)
    start = int(start)
    if start < 0 or start % KVB:
        raise MXNetError(f"QKVPagedPrefillAttend: start {start} must be a "
                         f"non-negative multiple of the page size {KVB}")
    return torch.full((B,), start, dtype=torch.int32, device=device)


def qkv_paged_prefill_attend(qkv, k_pool, v_pool, block_table, start,
                             lengths, num_heads: int) -> torch.Tensor:
    """Suffix prefill over a paged cache whose first ``start[b]`` tokens
    (block-aligned) of row b are cached: qkv (B, Ts, 3*H*D) holds the
    uncached suffix at positions ``start[b] + i``.  Its K/V is written
    through the block table at offset ``start`` (rows at or past
    ``lengths[b]``, the total tokens, land on the scratch page 0), then
    its queries attend the table's pages (all MB of them, a fixed width,
    masked to ``start``) plus the raw suffix causally
    (:func:`prefix_suffix_attention`).  ``start`` is a (B,) int32
    tensor, or an int for every row.  The pools are written in place;
    returns (B, Ts, H*D)."""
    q, k, v, D = _unpack_qkv(qkv, num_heads)
    B, Ts = qkv.shape[0], qkv.shape[1]
    KVB = k_pool.shape[1]
    start = _suffix_start(start, KVB, B, qkv.device)
    paged_prefill_write(k, v, k_pool, v_pool, block_table, lengths,
                        start=start)
    idx = block_table.long()
    C = idx.shape[1] * KVB
    kg = ck.gather_pages(k_pool, idx).reshape(B, C, num_heads, D)
    vg = ck.gather_pages(v_pool, idx).reshape(B, C, num_heads, D)
    out = prefix_suffix_attention(q, k, v, kg.to(q.dtype), vg.to(q.dtype),
                                  start, KVB)
    return out.reshape(B, Ts, num_heads * D)


def qkv_paged_prefill_attend_q(qkv, k_pool, v_pool, k_scale, v_scale,
                               block_table, start, lengths,
                               num_heads: int) -> torch.Tensor:
    """:func:`qkv_paged_prefill_attend` over int8/fp8 pools: the suffix
    quantizes on write, the table's pages dequantize on gather, and the
    suffix attends its own K/V raw (pre-quantization), float32 softmax
    throughout.  Returns (B, Ts, H*D); the pools are written in place."""
    q, k, v, D = _unpack_qkv(qkv, num_heads)
    B, Ts = qkv.shape[0], qkv.shape[1]
    KVB = k_pool.shape[1]
    start = _suffix_start(start, KVB, B, qkv.device)
    paged_prefill_write_q(k, v, k_pool, v_pool, k_scale, v_scale,
                          block_table, lengths, start=start)
    idx = block_table.long()
    kg = ck.gather_dequant(k_pool, k_scale, idx)
    vg = ck.gather_dequant(v_pool, v_scale, idx)
    out = prefix_suffix_attention(q, k, v, kg, vg, start, KVB)
    return out.reshape(B, Ts, num_heads * D)


# ---------------------------------------------------------------------------
# the serving operators (mxnet_tpu/ops/attention.py:556-990): the JAX
# package's names, arguments, outputs and attributes.  The JAX ops return
# new pools; these write the pools they are given in place and return
# those same tensors as their new_* outputs, so a caller that feeds the
# outputs back as the next inputs gets the JAX semantics.
# ---------------------------------------------------------------------------


def cache_update(cache_k, cache_v, k_t, v_t, lengths):
    """Write the current token's K/V (B, 1, H, D) into contiguous
    (B, C, H, D) caches at position ``lengths - 1``, in place; streams
    with lengths == 0 (padded slots) write slot 0, whose reads are all
    masked."""
    pos = torch.clamp(lengths.long() - 1, min=0)
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k.index_put_((rows, pos), k_t[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, pos), v_t[:, 0].to(cache_v.dtype))
    return cache_k, cache_v


def qkv_self_attention_decode(qkv, cache_k, cache_v, lengths,
                              num_heads: int, block_size: int = 0):
    """One decode step over contiguous caches: qkv (B, 1, 3*H*D) of the
    token at position ``lengths[b] - 1`` → (B, 1, H*D).  The token's K/V
    is written into the caches in place first, then its query attends
    keys ``k_pos < lengths[b]`` on the ``flash_attention_partial``
    kernel with the per-row key limit ``kv_len = lengths`` (the JAX
    ``decode_attention``)."""
    _check_decode_step_shape("QKVSelfAttentionDecode", qkv.shape)
    q, k_t, v_t, D = _unpack_qkv(qkv, num_heads)
    lengths = lengths.to(torch.int32)
    cache_update(cache_k, cache_v, k_t, v_t, lengths)
    o, m, l = ck.flash_attention_partial(
        q, cache_k.to(q.dtype), cache_v.to(q.dtype), False,
        block_size or 512, 0, kv_len=lengths)
    out = normalize_attention_state(o, m, l, q.dtype)
    return out.reshape(qkv.shape[0], 1, num_heads * D)


def _heads(attrs) -> int:
    return attr_int(attrs.get("num_heads", 1), 1)


def _ints(*tensors):
    """The serving ops' integer inputs (block tables, lengths, starts) as
    int32, as the JAX ops cast them (a bound float variable included)."""
    return [t.to(torch.int32) for t in tensors]


def _shape(s):
    return tuple(s) if s is not None else None


def _qkv_prefill_infer(attrs, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, None, None
    H = _heads(attrs)
    if len(s) != 3:
        raise MXNetError(f"QKVSelfAttentionPrefill wants a 3-D qkv (B, T, "
                         f"3*num_heads*d_head); got {s}")
    _check_qkv_packing(s[2], H, s)
    D = s[2] // (3 * H)
    return in_shapes, [(s[0], s[1], s[2] // 3), (s[0], s[1], H, D),
                       (s[0], s[1], H, D)], []


@register("QKVSelfAttentionPrefill", arg_names=("qkv",),
          kernel=True,
          out_names=("output", "key", "value"),
          infer_shape=_qkv_prefill_infer,
          doc="Causal self-attention off the fused QKV projection that also "
              "returns the (B, T, H, D) key/value state for a KV cache, on "
              "the flash_mha_packed kernel; attrs: num_heads, block_size")
def _qkv_prefill_op(op_ctx, attrs, inputs, aux):
    (qkv,) = inputs
    out, k, v = qkv_self_attention_prefill(
        qkv, _heads(attrs), attr_int(attrs.get("block_size", 0), 0))
    return [out, k, v]


def _qkv_decode_infer(attrs, in_shapes):
    qkv, ck_, cv, _ = in_shapes
    if qkv is None or ck_ is None:
        return in_shapes, None, None
    _check_qkv_packing(qkv[2], _heads(attrs), qkv)
    _check_decode_step_shape("QKVSelfAttentionDecode", qkv)
    return in_shapes, [(qkv[0], 1, qkv[2] // 3), tuple(ck_),
                       tuple(cv if cv is not None else ck_)], []


@register("QKVSelfAttentionDecode",
          kernel=True,
          arg_names=("qkv", "cache_k", "cache_v", "lengths"),
          out_names=("output", "new_cache_k", "new_cache_v"),
          infer_shape=_qkv_decode_infer,
          doc="One decode step over contiguous (B, C, H, D) caches: qkv "
              "(B, 1, 3*H*D) at position lengths-1, lengths (B,) counting "
              "it -> output (B, 1, H*D) and the caches, written in place; "
              "flash_attention_partial with kv_len = lengths; attrs: "
              "num_heads, block_size")
def _qkv_decode_op(op_ctx, attrs, inputs, aux):
    qkv, cache_k, cache_v, lengths = inputs
    out = qkv_self_attention_decode(
        qkv, cache_k, cache_v, lengths, _heads(attrs),
        attr_int(attrs.get("block_size", 0), 0))
    return [out, cache_k, cache_v]


def _qkv_paged_infer(attrs, in_shapes):
    qkv, kp, vp = in_shapes[:3]
    if qkv is None or kp is None:
        return in_shapes, None, None
    _check_qkv_packing(qkv[2], _heads(attrs), qkv)
    _check_decode_step_shape("QKVPagedAttentionDecode", qkv)
    return in_shapes, [(qkv[0], 1, qkv[2] // 3), tuple(kp),
                       tuple(vp if vp is not None else kp)], []


@register("QKVPagedAttentionDecode",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "block_table", "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool"),
          infer_shape=_qkv_paged_infer,
          doc="One decode step over the paged KV cache: qkv (B, 1, 3*H*D), "
              "pools (P, KVB, H, D), block_table (B, MB), lengths (B,) -> "
              "output (B, 1, H*D) and the pools, written in place; the "
              "paged_attention_decode kernel; attrs: num_heads")
def _qkv_paged_decode_op(op_ctx, attrs, inputs, aux):
    qkv, k_pool, v_pool, block_table, lengths = inputs
    block_table, lengths = _ints(block_table, lengths)
    out, _, _ = qkv_paged_attention_decode(qkv, k_pool, v_pool, block_table,
                                           lengths, _heads(attrs))
    return [out, k_pool, v_pool]


def _paged_write_infer(attrs, in_shapes):
    kp, vp = in_shapes[2], in_shapes[3]
    if kp is None:
        return in_shapes, None, None
    return in_shapes, [tuple(kp), tuple(vp if vp is not None else kp)], []


@register("PagedCacheWrite",
          arg_names=("key", "value", "k_pool", "v_pool", "block_table",
                     "lengths"),
          out_names=("new_k_pool", "new_v_pool"),
          infer_shape=_paged_write_infer,
          doc="Write a prompt's (B, T, H, D) key/value state into the paged "
              "pools through the block table, in place; positions >= "
              "lengths[b] land on the scratch page 0")
def _paged_write_op(op_ctx, attrs, inputs, aux):
    k, v, k_pool, v_pool, block_table, lengths = inputs
    block_table, lengths = _ints(block_table, lengths)
    paged_prefill_write(k, v, k_pool, v_pool, block_table, lengths)
    return [k_pool, v_pool]


def _paged_write_q_infer(attrs, in_shapes):
    kp, vp, ks, vs = in_shapes[2:6]
    if kp is None:
        return in_shapes, None, None
    return in_shapes, [tuple(kp), tuple(vp if vp is not None else kp),
                       _shape(ks), _shape(vs if vs is not None else ks)], []


@register("PagedCacheWriteQ",
          arg_names=("key", "value", "k_pool", "v_pool", "k_scale",
                     "v_scale", "block_table", "lengths"),
          out_names=("new_k_pool", "new_v_pool", "new_k_scale",
                     "new_v_scale"),
          infer_shape=_paged_write_q_infer,
          doc="PagedCacheWrite for int8/fp8 pools: the state quantizes on "
              "write, its (P, KVB, H) float32 scales beside it, in place")
def _paged_write_q_op(op_ctx, attrs, inputs, aux):
    k, v, k_pool, v_pool, k_scale, v_scale, block_table, lengths = inputs
    block_table, lengths = _ints(block_table, lengths)
    paged_prefill_write_q(k, v, k_pool, v_pool, k_scale, v_scale,
                          block_table, lengths)
    return [k_pool, v_pool, k_scale, v_scale]


def _qkv_paged_q_infer(attrs, in_shapes):
    qkv, kp, vp, ks, vs = in_shapes[:5]
    if qkv is None or kp is None:
        return in_shapes, None, None
    _check_qkv_packing(qkv[2], _heads(attrs), qkv)
    _check_decode_step_shape("QKVPagedAttentionDecodeQ", qkv)
    return in_shapes, [(qkv[0], 1, qkv[2] // 3), tuple(kp),
                       tuple(vp if vp is not None else kp), _shape(ks),
                       _shape(vs)], []


@register("QKVPagedAttentionDecodeQ",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "k_scale", "v_scale",
                     "block_table", "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool", "new_k_scale",
                     "new_v_scale"),
          infer_shape=_qkv_paged_q_infer,
          doc="QKVPagedAttentionDecode over int8/fp8 pools: the token "
              "quantizes on write, attention dequantizes inside the "
              "paged_attention_decode_quant kernel; attrs: num_heads")
def _qkv_paged_decode_q_op(op_ctx, attrs, inputs, aux):
    qkv, k_pool, v_pool, k_scale, v_scale, block_table, lengths = inputs
    block_table, lengths = _ints(block_table, lengths)
    out = qkv_paged_attention_decode_q(qkv, k_pool, v_pool, k_scale,
                                       v_scale, block_table, lengths,
                                       _heads(attrs))
    return [out, k_pool, v_pool, k_scale, v_scale]


def _qkv_window_infer(attrs, in_shapes):
    """The prefill-attend and verify ops: output (B, T, H*D) and the
    pools (with their scales when quantized)."""
    qkv, kp, vp = in_shapes[:3]
    if qkv is None or kp is None:
        return in_shapes, None, None
    _check_qkv_packing(qkv[2], _heads(attrs), qkv)
    outs = [(qkv[0], qkv[1], qkv[2] // 3), tuple(kp),
            tuple(vp if vp is not None else kp)]
    if len(in_shapes) == 8:
        outs += [_shape(in_shapes[3]), _shape(in_shapes[4])]
    return in_shapes, outs, []


@register("QKVPagedPrefillAttend",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "block_table", "start",
                     "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool"),
          infer_shape=_qkv_window_infer,
          doc="Suffix prefill over a prefix-shared paged cache: qkv (B, Ts, "
              "3*H*D) holds the uncached suffix at positions start[b]+i; "
              "its K/V is written at that offset, its queries attend the "
              "table's pages under the key limit start and the raw suffix "
              "causally (two flash_attention_partial launches).  start (B,) "
              "cached tokens, lengths (B,) total tokens; attrs: num_heads")
def _qkv_prefill_attend_op(op_ctx, attrs, inputs, aux):
    qkv, k_pool, v_pool, block_table, start, lengths = inputs
    block_table, start, lengths = _ints(block_table, start, lengths)
    out = qkv_paged_prefill_attend(qkv, k_pool, v_pool, block_table, start,
                                   lengths, _heads(attrs))
    return [out, k_pool, v_pool]


@register("QKVPagedPrefillAttendQ",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "k_scale", "v_scale",
                     "block_table", "start", "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool", "new_k_scale",
                     "new_v_scale"),
          infer_shape=_qkv_window_infer,
          doc="QKVPagedPrefillAttend over int8/fp8 pools: the suffix "
              "quantizes on write, the cached prefix dequantizes on gather, "
              "the suffix attends its own K/V raw; attrs: num_heads")
def _qkv_prefill_attend_q_op(op_ctx, attrs, inputs, aux):
    (qkv, k_pool, v_pool, k_scale, v_scale, block_table, start,
     lengths) = inputs
    block_table, start, lengths = _ints(block_table, start, lengths)
    out = qkv_paged_prefill_attend_q(qkv, k_pool, v_pool, k_scale, v_scale,
                                     block_table, start, lengths,
                                     _heads(attrs))
    return [out, k_pool, v_pool, k_scale, v_scale]


@register("QKVPagedVerifyAttend",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "block_table", "start",
                     "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool"),
          infer_shape=_qkv_window_infer,
          doc="Speculative-verify step over the paged cache: qkv (B, W, "
              "3*H*D) at positions start[b]+i, written at that offset, each "
              "query under the mask k_pos < start+1+i on the "
              "paged_attention_verify kernel; attrs: num_heads")
def _qkv_verify_op(op_ctx, attrs, inputs, aux):
    qkv, k_pool, v_pool, block_table, start, lengths = inputs
    block_table, start, lengths = _ints(block_table, start, lengths)
    out = qkv_paged_verify_attend(qkv, [k_pool, v_pool], block_table, start,
                                  lengths, _heads(attrs))
    return [out, k_pool, v_pool]


@register("QKVPagedVerifyAttendQ",
          kernel=True,
          arg_names=("qkv", "k_pool", "v_pool", "k_scale", "v_scale",
                     "block_table", "start", "lengths"),
          out_names=("output", "new_k_pool", "new_v_pool", "new_k_scale",
                     "new_v_scale"),
          infer_shape=_qkv_window_infer,
          doc="QKVPagedVerifyAttend over int8/fp8 pools: the window "
              "quantizes on write and every query reads the dequantized "
              "cache (paged_attention_verify_quant); attrs: num_heads")
def _qkv_verify_q_op(op_ctx, attrs, inputs, aux):
    (qkv, k_pool, v_pool, k_scale, v_scale, block_table, start,
     lengths) = inputs
    block_table, start, lengths = _ints(block_table, start, lengths)
    out = qkv_paged_verify_attend(qkv, [k_pool, v_pool, k_scale, v_scale],
                                  block_table, start, lengths, _heads(attrs))
    return [out, k_pool, v_pool, k_scale, v_scale]
