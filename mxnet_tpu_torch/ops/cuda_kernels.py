"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py`` for the two kernels
of the serving path:

* ``flash_mha_packed`` — packed-QKV flash attention forward
  (``csrc/flash_mha_packed.cu``, replacing ``_mhap_fwd``);
* ``paged_attention_decode`` — one query per stream against pages
  gathered through a block table (``csrc/paged_attention_decode.cu``).

Every wrapper follows one rule: a tensor on the CPU goes to the plain
PyTorch version beside it; a tensor on a CUDA device launches the
kernel or raises.  There is no fallback from the kernel to the plain
version and no switch that routes CUDA tensors to it.  ``LAUNCHES``
counts kernel launches (one per successful launch, nowhere else), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["flash_mha_packed", "flash_mha_packed_plain",
           "paged_attention_decode", "paged_attention_decode_plain",
           "LAUNCHES", "reset_launch_counts", "SUPPORTED_HEAD_DIMS"]

LAUNCHES: Dict[str, int] = {"flash_mha_packed": 0,
                            "paged_attention_decode": 0}

# head widths the kernels are instantiated for (csrc/*.cu)
SUPPORTED_HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp = ctypes.c_void_p
_i = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load(name, argtypes):
    lib = _build.library(name)
    fn = getattr(lib, name if name != "flash_mha_packed"
                 else "flash_mha_packed_fwd")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise MXNetError(f"{name}: kernel launch failed with CUDA error "
                         f"{err} (cudaGetLastError)")


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True: launch the kernel (all on one CUDA device); False: the
    plain version (all on the CPU); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError(f"{name}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise MXNetError(f"{name}: no kernel for device {dev}")
    return True


# ---------------------------------------------------------------------------
# flash_mha_packed
# ---------------------------------------------------------------------------


def flash_mha_packed_plain(qkv: torch.Tensor, num_heads: int,
                           causal: bool = False, block_size: int = 512
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: unpack, blockwise online softmax in fp32 over
    ``block_size`` key blocks, normalize.  Returns (o (B, T, H*D) in
    qkv's dtype, lse (B, T, H) float32, natural log)."""
    from .attention import (_unpack_qkv, blockwise_attention_partial,
                            normalize_attention_state)

    B, T, _ = qkv.shape
    q, k, v, D = _unpack_qkv(qkv, num_heads)
    o, m, l = blockwise_attention_partial(q, k, v, causal=causal,
                                          block_size=block_size or 512)
    out = normalize_attention_state(o, m, l, qkv.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).transpose(1, 2)
    return out.reshape(B, T, num_heads * D), lse.contiguous()


def flash_mha_packed(qkv: torch.Tensor, num_heads: int,
                     causal: bool = False, block_size: int = 512
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-QKV attention: qkv (B, T, 3*H*D) laid out [q | k | v] with
    head h on lanes [h*D, (h+1)*D) of each third → (o (B, T, H*D) in
    qkv's dtype, lse (B, T, H) float32 in natural-log units).

    ``block_size`` is the plain version's online-softmax block (the
    JAX lax path's ``block_size``); the kernel tiles on its own."""
    from .attention import _check_qkv_packing

    if qkv.ndim != 3:
        raise MXNetError(f"flash_mha_packed wants (B, T, 3*H*D); got "
                         f"{tuple(qkv.shape)}")
    _check_qkv_packing(qkv.shape[2], num_heads, qkv.shape)
    if not _route("flash_mha_packed", qkv):
        return flash_mha_packed_plain(qkv, num_heads, causal, block_size)
    B, T, HD3 = qkv.shape
    H = int(num_heads)
    D = HD3 // (3 * H)
    if qkv.dtype not in _DTYPE_CODE:
        raise MXNetError(f"flash_mha_packed: dtype {qkv.dtype} (the "
                         f"kernel takes float32 and bfloat16)")
    if D not in SUPPORTED_HEAD_DIMS:
        raise MXNetError(f"flash_mha_packed: head dim {D} (the kernel "
                         f"is built for {SUPPORTED_HEAD_DIMS})")
    if not qkv.is_contiguous():
        raise MXNetError("flash_mha_packed: qkv must be contiguous")
    fn = _load("flash_mha_packed",
               [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp])
    o = torch.empty((B, T, H * D), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), B, T, H, D,
                 int(bool(causal)), _DTYPE_CODE[qkv.dtype], stream)
    _check_launch(err, "flash_mha_packed")
    LAUNCHES["flash_mha_packed"] += 1
    return o, lse


# ---------------------------------------------------------------------------
# paged_attention_decode
# ---------------------------------------------------------------------------


def paged_attention_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the table's pages into a (B, MB*KVB, H, D)
    cache and run the blockwise body with block == KVB and the
    per-stream length mask.  (B, H, D) in q's dtype."""
    from .attention import (blockwise_attention_partial,
                            normalize_attention_state)

    B, MB = block_table.shape
    KVB, H, D = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    idx = block_table.long()
    kg = k_pool[idx].reshape(B, MB * KVB, H, D)
    vg = v_pool[idx].reshape(B, MB * KVB, H, D)
    o, m, l = blockwise_attention_partial(q[:, None], kg, vg, causal=True,
                                          block_size=KVB, lengths=lengths)
    return normalize_attention_state(o, m, l, q.dtype)[:, 0]


def paged_attention_decode(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, D) at position lengths-1; k_pool/v_pool (P, KVB, H, D);
    block_table (B, MB) int32 page ids (page 0 = scratch); lengths (B,)
    int32 counting the current token → (B, H, D) in q's dtype.  A
    stream with lengths == 0 gets zeros.

    q may be a view with any batch stride (the query third of a packed
    qkv); its head and lane strides must be D and 1."""
    if q.ndim != 3 or k_pool.ndim != 4 or block_table.ndim != 2 \
            or lengths.ndim != 1:
        raise MXNetError(
            f"paged_attention_decode wants q (B, H, D), pools "
            f"(P, KVB, H, D), table (B, MB), lengths (B,); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(block_table.shape)}, {tuple(lengths.shape)}")
    B, H, D = q.shape
    KVB = k_pool.shape[1]
    if tuple(k_pool.shape[2:]) != (H, D) \
            or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != B or lengths.shape[0] != B:
        raise MXNetError(
            f"paged_attention_decode: shapes disagree: q {tuple(q.shape)}"
            f", k_pool {tuple(k_pool.shape)}, v_pool "
            f"{tuple(v_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if not _route("paged_attention_decode", q, k_pool, v_pool,
                  block_table, lengths):
        return paged_attention_decode_plain(q, k_pool, v_pool, block_table,
                                            lengths)
    MB = block_table.shape[1]
    pair = (_DTYPE_CODE.get(q.dtype), _DTYPE_CODE.get(k_pool.dtype))
    if pair not in ((0, 0), (0, 1), (1, 1)) or v_pool.dtype != k_pool.dtype:
        raise MXNetError(
            f"paged_attention_decode: q {q.dtype} over pools "
            f"{k_pool.dtype}/{v_pool.dtype} (the kernel takes fp32/fp32, "
            f"fp32/bf16 and bf16/bf16)")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError("paged_attention_decode: block_table and lengths "
                         "must be int32")
    if D not in SUPPORTED_HEAD_DIMS:
        raise MXNetError(f"paged_attention_decode: head dim {D} (the "
                         f"kernel is built for {SUPPORTED_HEAD_DIMS})")
    if q.stride(2) != 1 or q.stride(1) != D:
        raise MXNetError("paged_attention_decode: q's head and lane "
                         "strides must be D and 1")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise MXNetError(f"paged_attention_decode: {name} must be "
                             f"contiguous")
    fn = _load("paged_attention_decode",
               [_vp, ctypes.c_long, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                _i, _i, _i, _i, _vp])
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), q.stride(0), k_pool.data_ptr(),
                 v_pool.data_ptr(), block_table.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, H, D, KVB, MB,
                 pair[0], pair[1], stream)
    _check_launch(err, "paged_attention_decode")
    LAUNCHES["paged_attention_decode"] += 1
    return out
