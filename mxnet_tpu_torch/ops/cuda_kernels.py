"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py`` for the kernels of
the serving and training paths:

* ``flash_mha_packed`` — packed-QKV flash attention forward
  (``csrc/flash_mha_packed.cu``, replacing ``_mhap_fwd``);
* ``flash_mha_packed_bwd`` — its backward, a dq kernel and a dk/dv
  kernel (``csrc/flash_mha_packed_bwd.cu``, replacing ``_mhap_bwd``);
* ``flash_mha`` — normalized attention over three separate q, k, v
  tensors of any head width up to ``FLASH_MHA_MAX_HEAD_DIM``, Tq and Tk
  free (``csrc/flash_mha.cu``, replacing ``_mha_fwd``), and
  ``flash_mha_bwd``, its dq kernel and kv-block-outer dk/dv kernel on
  the tensor cores (``csrc/flash_mha_bwd.cu``, replacing ``_mha_bwd``);
* ``flash_attention_partial`` — the un-normalized online-softmax state
  (o, m, l) over q, k, v with a key offset ``kv_offset`` in the causal
  mask and an optional per-row key limit ``kv_len`` read from device
  memory (the suffix prefill, the contiguous-cache decode), every hop of
  ``sequence.ring_attention``
  (``csrc/flash_attention_partial.cu``, replacing
  ``flash_attention_partial``), and ``flash_attention_bwd``, its dq
  kernel and kv-block-outer dk/dv kernel with m held constant
  (``csrc/flash_attention_partial_bwd.cu``, replacing
  ``flash_attention_bwd``);
* ``paged_attention_decode`` — one query per stream against pages
  gathered through a block table (``csrc/paged_attention_decode.cu``);
* ``paged_attention_decode_quant`` — the same over int8/fp8 pages with
  per-(slot, head) float32 scales (``csrc/paged_attention_decode_quant.cu``,
  replacing ``paged_attention_decode_quant``);
* ``paged_attention_verify`` — W queries per stream under the diagonal
  mask of a speculative verify window, over raw pages, and its quantized
  instantiation ``paged_attention_verify_quant``
  (``csrc/paged_attention_verify.cu``, replacing
  ``paged_attention_verify`` and the lax ``paged_verify_attention_q``);
* ``lstm_scan`` — the float32 LSTM recurrence over a whole sequence in
  one launch (``csrc/lstm_scan.cu``, replacing ``_lstm_pallas_fwd``): a
  thread-block cluster holds the recurrent weight in shared memory for
  every step where it fits, an L2-streaming kernel above that size;
* ``nms`` — greedy non-maximum suppression over score-sorted detection
  rows: a parallel suppression mask, then a sweep one round a 64-row
  block (``csrc/nms.cu``, replacing ``nms`` and its body
  ``_nms_kernel``).

The paged entry points launch one kernel (``csrc/paged_attention.cuh``,
a cluster of CTAs a (stream, head), decode its one-row case): verify row
w equals the decode kernel at ``lengths = start + 1 + w`` bit for bit,
raw and quantized alike.

``ops/attention.py`` wraps each attention forward and its backward in
one ``torch.autograd.Function``, and ``ops/rnn.py`` wraps ``lstm_scan``
with its remat backward; the forward wrappers here refuse an input that
requires a gradient, since the kernel's output carries none.

Every wrapper follows one rule: a tensor on the CPU goes to the plain
PyTorch version beside it; a tensor on a CUDA device launches the
kernel or raises.  There is no fallback from the kernel to the plain
version and no switch that routes CUDA tensors to it.  ``LAUNCHES``
counts kernel launches (one per successful launch, nowhere else), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import numbers
from typing import Dict, Tuple

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["flash_mha_packed", "flash_mha_packed_plain",
           "flash_mha_packed_bwd", "flash_mha_packed_bwd_plain",
           "launch_flash_mha_packed_bwd", "flash_mha", "flash_mha_plain",
           "flash_mha_bwd", "flash_mha_bwd_plain", "launch_flash_mha_bwd",
           "FLASH_MHA_MAX_HEAD_DIM", "flash_attention_partial",
           "flash_attention_partial_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "launch_flash_attention_bwd",
           "paged_attention_decode", "paged_attention_decode_plain",
           "paged_attention_decode_quant",
           "paged_attention_decode_quant_plain", "gather_pages",
           "gather_dequant",
           "paged_attention_verify", "paged_attention_verify_plain",
           "lstm_scan", "lstm_scan_plain", "LSTM_MAX_HIDDEN", "nms",
           "nms_plain", "nms_workspace_bytes", "NMS_WORKSPACE_BUDGET",
           "NMS_FUSED_MAX_ROWS", "LAUNCHES", "reset_launch_counts",
           "HEAD_DIM_BUCKETS"]

LAUNCHES: Dict[str, int] = {"flash_mha_packed": 0,
                            "flash_mha_packed_bwd_dq": 0,
                            "flash_mha_packed_bwd_dkv": 0,
                            "flash_mha": 0,
                            "flash_mha_bwd_dq": 0,
                            "flash_mha_bwd_dkv": 0,
                            "paged_attention_decode": 0,
                            "paged_attention_decode_quant": 0,
                            "paged_attention_verify": 0,
                            "paged_attention_verify_quant": 0,
                            "lstm_scan": 0,
                            "nms": 0,
                            "flash_attention_partial": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0}

# the head-width buckets every attention kernel is instantiated for: a head
# of width D runs the smallest bucket >= D, its lanes past D masked
HEAD_DIM_BUCKETS = (32, 64, 96, 128)
# the widest head the attention kernels take; a wider one raises
FLASH_MHA_MAX_HEAD_DIM = HEAD_DIM_BUCKETS[-1]
# the largest LSTM hidden size lstm_scan takes (its L2-streaming kernel:
# one thread per hidden unit)
LSTM_MAX_HIDDEN = 1024
# nms with force_suppress off: the largest A of the one-launch path (the
# mask in shared memory; csrc/nms.cu's kFusedMaxRows), and the most device
# memory a call's mask workspace takes: above it the images run in
# groups.  An A whose one image's mask exceeds it (A > 92,672) is refused
# with force on or off
NMS_FUSED_MAX_ROWS = 256
NMS_WORKSPACE_BUDGET = 1 << 30
# the attention kernels' dtype codes (their dtype / q_dtype / kv_dtype
# argument); every attention kernel takes the three
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = "float32, bfloat16 and float16"
# quantized page codes of the kernels' kv_code argument
_QUANT_CODE = {torch.int8: 2, torch.float8_e4m3fn: 3}
_vp = ctypes.c_void_p
_i = ctypes.c_int
_strides = ctypes.POINTER(ctypes.c_longlong)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load(source, name, argtypes):
    """Entry point ``name`` of the library built from ``csrc/<source>.cu``."""
    fn = getattr(_build.library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise MXNetError(f"{name}: kernel launch failed with CUDA error "
                         f"{err} (cudaGetLastError)")


def _check_head_dim(name: str, D: int) -> None:
    """The attention kernels take head widths up to
    ``FLASH_MHA_MAX_HEAD_DIM``, in ``HEAD_DIM_BUCKETS``."""
    if D > FLASH_MHA_MAX_HEAD_DIM:
        raise MXNetError(f"{name}: head dim {D} (the kernels take up to "
                         f"FLASH_MHA_MAX_HEAD_DIM = {FLASH_MHA_MAX_HEAD_DIM})")


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
    from .attention import (_blockwise_attention_partial_plain, _unpack_qkv,
                            normalize_attention_state)

    B, T, _ = qkv.shape
    q, k, v, D = _unpack_qkv(qkv, num_heads)
    o, m, l = _blockwise_attention_partial_plain(
        q, k, v, causal=causal, block_size=block_size or 512)
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
    JAX lax path's ``block_size``); the kernel tiles on its own.

    No gradient flows through this call: an input that requires one
    raises.  ``ops.attention.qkv_self_attention`` is the differentiable
    form (forward and backward kernels in one
    ``torch.autograd.Function``)."""
    from .attention import _check_qkv_packing

    if qkv.ndim != 3:
        raise MXNetError(f"flash_mha_packed wants (B, T, 3*H*D); got "
                         f"{tuple(qkv.shape)}")
    _check_qkv_packing(qkv.shape[2], num_heads, qkv.shape)
    if qkv.requires_grad and torch.is_grad_enabled():
        raise MXNetError(
            "flash_mha_packed: qkv requires a gradient, which this call "
            "would drop; use ops.attention.qkv_self_attention, whose "
            "autograd Function runs the backward kernels")
    if not _route("flash_mha_packed", qkv):
        return flash_mha_packed_plain(qkv, num_heads, causal, block_size)
    B, T, HD3 = qkv.shape
    H = int(num_heads)
    D = HD3 // (3 * H)
    if qkv.dtype not in _DTYPE_CODE:
        raise MXNetError(f"flash_mha_packed: dtype {qkv.dtype} (the "
                         f"kernel takes {_DTYPE_NAMES})")
    _check_head_dim("flash_mha_packed", D)
    if not qkv.is_contiguous():
        raise MXNetError("flash_mha_packed: qkv must be contiguous")
    fn = _load("flash_mha_packed", "flash_mha_packed_fwd",
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
# flash_mha_packed backward
# ---------------------------------------------------------------------------


def flash_mha_packed_bwd_plain(qkv: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               num_heads: int, causal: bool = False,
                               block_size: int = 512) -> torch.Tensor:
    """Plain version of the backward: the kernels' blockwise formulas in
    float32 over ``block_size`` query and key blocks (no autograd).

    p = exp(q.k^T*scale - lse) (causal positions 0), Delta =
    rowsum(do*o), ds = p*(do.v^T - Delta); dq = ds.k*scale, dk =
    ds^T.q*scale, dv = p^T.do.  Returns dqkv (B, T, 3*H*D) packed
    [dq | dk | dv] in qkv's dtype."""
    from .attention import _unpack_qkv

    B, T, _ = qkv.shape
    H = int(num_heads)
    q, k, v, D = _unpack_qkv(qkv, H)
    q, k, v = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(D)
    dof = do.float().unflatten(-1, (H, D))
    delta = (dof * o.float().unflatten(-1, (H, D))).sum(-1)  # (B, T, H)
    lse = lse.float()
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    block = max(1, min(int(block_size or 512), T))
    pos = torch.arange(T, device=qkv.device)
    for i0 in range(0, T, block):
        i1 = min(i0 + block, T)
        q_i, do_i = q[:, i0:i1], dof[:, i0:i1]
        lse_i = lse[:, i0:i1].transpose(1, 2)[..., None]    # (B, H, bq, 1)
        delta_i = delta[:, i0:i1].transpose(1, 2)[..., None]
        for j0 in range(0, i1 if causal else T, block):
            j1 = min(j0 + block, T)
            k_j, v_j = k[:, j0:j1], v[:, j0:j1]
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j) * scale
            p = torch.exp(s - lse_i)
            if causal:
                p = torch.where(pos[j0:j1][None, :] <= pos[i0:i1][:, None],
                                p, 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", do_i, v_j)
            ds = p * (dp - delta_i)
            dq[:, i0:i1] += torch.einsum("bhqk,bkhd->bqhd", ds, k_j) * scale
            dk[:, j0:j1] += torch.einsum("bhqk,bqhd->bkhd", ds, q_i) * scale
            dv[:, j0:j1] += torch.einsum("bhqk,bqhd->bkhd", p, do_i)
    return torch.cat([x.flatten(2) for x in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


def flash_mha_packed_bwd(qkv: torch.Tensor, o: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor, num_heads: int,
                         causal: bool = False, block_size: int = 512
                         ) -> torch.Tensor:
    """Backward of ``flash_mha_packed``: qkv (B, T, 3*H*D), its forward
    output o (B, T, H*D) and lse (B, T, H), and the cotangent do of o →
    dqkv (B, T, 3*H*D) packed like qkv, in qkv's dtype.

    On a CUDA device two kernels write one buffer: the dq kernel its
    first third, the dk/dv kernel the other two."""
    if qkv.ndim != 3:
        raise MXNetError(f"flash_mha_packed_bwd wants qkv (B, T, 3*H*D); "
                         f"got {tuple(qkv.shape)}")
    B, T, HD3 = qkv.shape
    H = int(num_heads)
    from .attention import _check_qkv_packing

    _check_qkv_packing(HD3, H, qkv.shape)
    D = HD3 // (3 * H)
    if o.shape != (B, T, H * D) or do.shape != (B, T, H * D) \
            or lse.shape != (B, T, H):
        raise MXNetError(
            f"flash_mha_packed_bwd: shapes disagree: qkv "
            f"{tuple(qkv.shape)}, o {tuple(o.shape)}, lse "
            f"{tuple(lse.shape)}, do {tuple(do.shape)}")
    if not _route("flash_mha_packed_bwd", qkv, o, lse, do):
        return flash_mha_packed_bwd_plain(qkv, o, lse, do, H, causal,
                                          block_size)
    if qkv.dtype not in _DTYPE_CODE or o.dtype != qkv.dtype:
        raise MXNetError(f"flash_mha_packed_bwd: qkv {qkv.dtype} / o "
                         f"{o.dtype} (the kernels take {_DTYPE_NAMES}, "
                         f"one for both)")
    if lse.dtype != torch.float32:
        raise MXNetError("flash_mha_packed_bwd: lse must be float32")
    _check_head_dim("flash_mha_packed_bwd", D)
    do = do.to(qkv.dtype).contiguous()
    for name, t in (("qkv", qkv), ("o", o), ("lse", lse)):
        if not t.is_contiguous():
            raise MXNetError(f"flash_mha_packed_bwd: {name} must be "
                             f"contiguous")
    dqkv = torch.empty_like(qkv)
    for part in ("dq", "dkv"):
        launch_flash_mha_packed_bwd(part, qkv, o, lse, do, dqkv, H, causal)
    return dqkv


def launch_flash_mha_packed_bwd(part: str, qkv, o, lse, do, dqkv,
                                num_heads: int, causal: bool) -> None:
    """Launch one of the two backward kernels on inputs
    ``flash_mha_packed_bwd`` has checked (CUDA, contiguous, one dtype,
    D up to ``FLASH_MHA_MAX_HEAD_DIM``): ``part`` "dq" writes dqkv's
    first third, "dkv" the other two.  Counts the launch."""
    B, T, HD3 = qkv.shape
    H = int(num_heads)
    name = f"flash_mha_packed_bwd_{part}"
    fn = _load("flash_mha_packed_bwd", name,
               [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dqkv.data_ptr(), B, T, H, HD3 // (3 * H),
                 int(bool(causal)), _DTYPE_CODE[qkv.dtype], stream)
    _check_launch(err, name)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# flash_mha: normalized attention over separate q, k, v, and its backward
# ---------------------------------------------------------------------------


def _bhtd(x: torch.Tensor) -> torch.Tensor:
    """A (BH, T, D) tensor as a (BH, 1, T, D) view; (B, H, T, D) as is."""
    return x[:, None] if x.ndim == 3 else x


def _check_mha(name: str, q, k, v) -> None:
    """What both packages' flash_mha take: q (BH, Tq, D) or (B, H, Tq,
    D), k and v of q's rank and leading dims with one Tk, v's head
    width q's (the TPU kernel reads v in blocks of q's D), one dtype."""
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise MXNetError(f"{name} wants q, k, v (BH, T, D) or (B, H, T, D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    lead = q.shape[:-2]
    if k.shape[:-2] != lead or v.shape[:-2] != lead \
            or v.shape[-2] != k.shape[-2] or k.shape[-1] != q.shape[-1]:
        raise MXNetError(f"{name}: shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if v.shape[-1] != q.shape[-1]:
        raise MXNetError(f"{name}: v's head width {v.shape[-1]} differs "
                         f"from q's {q.shape[-1]}; the kernels read v in "
                         f"blocks of q's head width, as the TPU kernel")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"{name}: q, k, v dtypes differ ({q.dtype}, "
                         f"{k.dtype}, {v.dtype})")


def _check_mha_launch(name: str, D: int, dtype, *tensors) -> None:
    """What the CUDA kernels take beyond ``_check_mha``."""
    if dtype not in _DTYPE_CODE:
        raise MXNetError(f"{name}: dtype {dtype} (the kernels take "
                         f"{_DTYPE_NAMES})")
    _check_head_dim(name, D)
    if any(t.stride(-1) != 1 for t in tensors):
        raise MXNetError(f"{name}: the head lanes (last axis) of q, k and v "
                         f"must be contiguous")


def _layout_args(*tensors) -> ctypes.Array:
    """(batch, head, row) element strides of each (B, H, T, D) view."""
    vals = [t.stride(i) for t in tensors for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_size: int = 512
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the blockwise online softmax in fp32 over
    ``block_size`` key blocks (``_blockwise_attention_partial_plain``),
    then normalized.  Returns (o of q's shape in q's dtype, lse of q's shape
    without its last axis, float32, natural log)."""
    from .attention import (_blockwise_attention_partial_plain,
                            normalize_attention_state)

    q4, k4, v4 = (_bhtd(x).transpose(1, 2) for x in (q, k, v))
    o, m, l = _blockwise_attention_partial_plain(
        q4, k4, v4, causal=causal, block_size=block_size or 512)
    out = normalize_attention_state(o, m, l, q.dtype).transpose(1, 2)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out.reshape(q.shape), lse.reshape(q.shape[:-1])


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, block_size: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized attention: q (BH, Tq, D) or (B, H, Tq, D), k and v
    (..., Tk, D) → (o like q, in q's dtype; lse q.shape[:-1] float32 in
    natural-log units).  Causal: the mask k_pos <= q_pos aligned at
    position 0 (a row at q_pos >= Tk sees every key).

    Any strides with contiguous lanes: the kernel reads each tensor
    through its own (batch, head, row) strides, so (B, H, T, D) views
    of BTHD tensors need no copy, and o takes q's layout.
    ``block_size`` is the plain version's online-softmax block (the JAX
    lax path's); the kernel tiles on its own.

    No gradient flows through this call: an input that requires one
    raises.  ``ops.attention.blockwise_attention`` is the differentiable
    form (forward and backward kernels in one autograd Function)."""
    _check_mha("flash_mha", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise MXNetError(
            "flash_mha: an input requires a gradient, which this call "
            "would drop; use ops.attention.blockwise_attention, whose "
            "autograd Function runs the backward kernels")
    if not _route("flash_mha", q, k, v):
        return flash_mha_plain(q, k, v, causal, block_size)
    D = q.shape[-1]
    _check_mha_launch("flash_mha", D, q.dtype, q, k, v)
    q4, k4, v4 = (_bhtd(x) for x in (q, k, v))
    B, H, Tq, _ = q4.shape
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    fn = _load("flash_mha", "flash_mha_fwd",
               [_vp, _vp, _vp, _vp, _vp, _strides, _i, _i, _i, _i, _i, _i,
                _i, _vp])
    strides = _layout_args(q4, k4, v4, _bhtd(o))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), strides, B, H, Tq, k4.shape[2], D,
                 int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _check_launch(err, "flash_mha")
    LAUNCHES["flash_mha"] += 1
    return o, lse


def flash_mha_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                        block_size: int = 512):
    """Plain version of the backward: the kernels' blockwise formulas in
    float32 over ``block_size`` query and key blocks, with separate
    query and key positions (no autograd).

    p = exp(q.k^T*scale - lse), 0 where k_pos > q_pos under ``causal``
    (aligned at position 0); Delta = rowsum(do*o) in float32; ds =
    p*(do.v^T - Delta); dq = ds.k*scale, dk = ds^T.q*scale, dv = p^T.do,
    with p and ds rounded to the inputs' dtype before their products, as
    the TPU kernels cast them.  Returns (dq, dk, dv) in q's, k's and v's
    shapes and dtype."""
    dt = q.dtype
    rnd = (lambda x: x) if dt == torch.float32 \
        else (lambda x: x.to(dt).float())
    q4, k4, v4, o4, do4 = (_bhtd(x) for x in (q, k, v, o, do))
    Tq, Tk, D = q4.shape[2], k4.shape[2], q4.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = q4.float(), k4.float(), v4.float()
    dof = do4.to(dt).float()
    delta = (do4.float() * o4.float()).sum(-1)          # (B, H, Tq)
    lse4 = lse.reshape(q4.shape[:3]).float()
    dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
    block = max(1, int(block_size or 512))
    q_pos = torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    for i0 in range(0, Tq, block):
        i1 = min(i0 + block, Tq)
        q_i, do_i = qf[:, :, i0:i1], dof[:, :, i0:i1]
        lse_i = lse4[:, :, i0:i1, None]
        delta_i = delta[:, :, i0:i1, None]
        # causal: key blocks wholly past the block's last query are skipped
        for j0 in range(0, min(Tk, i1) if causal else Tk, block):
            j1 = min(j0 + block, Tk)
            k_j, v_j = kf[:, :, j0:j1], vf[:, :, j0:j1]
            p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q_i, k_j) * scale
                          - lse_i)
            if causal:
                p = torch.where(k_pos[None, j0:j1] <= q_pos[i0:i1, None],
                                p, 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do_i, v_j)
            ds = rnd(p * (dp - delta_i))
            dq[:, :, i0:i1] += torch.einsum("bhqk,bhkd->bhqd", ds, k_j) \
                * scale
            dk[:, :, j0:j1] += torch.einsum("bhqk,bhqd->bhkd", ds, q_i) \
                * scale
            dv[:, :, j0:j1] += torch.einsum("bhqk,bhqd->bhkd", rnd(p), do_i)
    return tuple(g.to(dt).reshape(x.shape)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool = False, block_size: int = 512):
    """Backward of ``flash_mha``: q, k, v, its output o and lse, and the
    cotangent do of o → (dq, dk, dv), each in its input's shape, dtype
    and layout.

    On a CUDA device Delta = rowsum(do*o) is computed here in float32,
    outside the kernels as the JAX code does, then two kernels run: dq,
    and dk/dv, kv-block-outer (each gradient row written once by one
    block: no atomics, deterministic)."""
    _check_mha("flash_mha_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:-1]:
        raise MXNetError(
            f"flash_mha_bwd: shapes disagree: q {tuple(q.shape)}, o "
            f"{tuple(o.shape)}, lse {tuple(lse.shape)}, do "
            f"{tuple(do.shape)}")
    if not _route("flash_mha_bwd", q, k, v, o, lse, do):
        return flash_mha_bwd_plain(q, k, v, o, lse, do, causal, block_size)
    _check_mha_launch("flash_mha_bwd", q.shape[-1], q.dtype, q, k, v)
    if o.dtype != q.dtype or lse.dtype != torch.float32:
        raise MXNetError(f"flash_mha_bwd: o {o.dtype} / lse {lse.dtype} "
                         f"(o in q's dtype {q.dtype}, lse float32)")
    delta = (do.float() * o.float()).sum(-1).contiguous()
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch_flash_mha_bwd("dq", q, k, v, do, lse, delta, (dq,), causal)
    launch_flash_mha_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), causal)
    return dq, dk, dv


def launch_flash_mha_bwd(part: str, q, k, v, do, lse, delta, outs,
                         causal: bool) -> None:
    """Launch one of the two backward kernels on inputs ``flash_mha_bwd``
    has checked (CUDA, one dtype, lanes contiguous, do in q's dtype, lse
    and delta contiguous float32): ``part`` "dq" writes ``outs`` (dq,),
    "dkv" writes (dk, dv).  Counts the launch."""
    name = f"flash_mha_bwd_{part}"
    q4, k4, v4, do4 = (_bhtd(x) for x in (q, k, v, do))
    B, H, Tq, D = q4.shape
    fn = _load("flash_mha_bwd", name,
               [_vp] * (6 + len(outs)) + [_strides, _i, _i, _i, _i, _i, _i,
                                           _i, _vp])
    strides = _layout_args(q4, k4, v4, do4, *(_bhtd(t) for t in outs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), strides, B, H, Tq,
                 k4.shape[2], D, int(bool(causal)), _DTYPE_CODE[q.dtype],
                 stream)
    _check_launch(err, name)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# flash_attention_partial: the un-normalized partial state, and its backward
# ---------------------------------------------------------------------------


def _kv_offset(name: str, kv_offset) -> int:
    """``kv_offset`` as the int32 the kernels take as an argument: a
    Python (or numpy) int; a tensor raises, since reading one back to
    the host would stall the card."""
    if isinstance(kv_offset, torch.Tensor):
        raise MXNetError(f"{name}: kv_offset must be a Python int (a kernel "
                         f"argument), not a tensor")
    if not isinstance(kv_offset, numbers.Integral):
        raise MXNetError(f"{name}: kv_offset must be an int; got "
                         f"{type(kv_offset).__name__}")
    off = int(kv_offset)
    if not -2 ** 31 <= off < 2 ** 31:
        raise MXNetError(f"{name}: kv_offset {off} outside int32")
    return off


def _check_partial(name: str, q, k, v) -> None:
    """What both packages' partial-state attention takes: q (B, Tq, H, D),
    k and v (B, Tk, H, D) of one shape, one dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError(f"{name} wants q (B, Tq, H, D), k and v (B, Tk, H, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or tuple(k.shape[2:]) != (H, D) \
            or v.shape != k.shape:
        raise MXNetError(f"{name}: shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"{name}: q, k, v dtypes differ ({q.dtype}, "
                         f"{k.dtype}, {v.dtype})")


def _check_kv_len(name: str, kv_len, B: int) -> None:
    """``kv_len``: None, or a (B,) integer tensor of per-row key limits."""
    if kv_len is None:
        return
    if not isinstance(kv_len, torch.Tensor) or kv_len.shape != (B,) \
            or kv_len.dtype not in (torch.int32, torch.int64):
        raise MXNetError(f"{name}: kv_len must be a ({B},) int32 tensor; got "
                         f"{getattr(kv_len, 'shape', type(kv_len).__name__)}"
                         f" {getattr(kv_len, 'dtype', '')}")


def flash_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = False,
                                  block_size: int = 512, kv_offset: int = 0,
                                  kv_len=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version: the blockwise online softmax in fp32 over
    ``block_size`` key blocks (``_blockwise_attention_partial_plain``)."""
    from .attention import _blockwise_attention_partial_plain

    return _blockwise_attention_partial_plain(q, k, v, causal, block_size,
                                              kv_offset, kv_len=kv_len)


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            block_size: int = 512, kv_offset: int = 0,
                            kv_len=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Un-normalized attention state: q (B, Tq, H, D), k and v (B, Tk, H,
    D) → (o (B, H, Tq, D), m, l (B, H, Tq)), float32 for every input
    dtype, ``out = o / l`` after the states are merged.  ``kv_offset``
    (an int: the position of k[0] minus that of q[0]) shifts the causal
    mask to ``k_pos + kv_offset <= q_pos``; ``kv_len`` (a (B,) int32
    tensor on q's device, or None) hides keys ``j >= kv_len[b]`` from
    row b's queries on top of that (the JAX lax body's ``lengths=``
    mask; the kernel reads it from device memory, so a CUDA graph may
    record the launch).  A row that sees no key is m = -inf, l = 0,
    o = 0.

    Any strides with contiguous lanes (the kernel reads each tensor
    through its own strides).  ``block_size`` is the plain version's
    key block; the kernel tiles on its own.  No gradient flows through
    this call: an input that requires one raises
    (``ops.attention.blockwise_attention_partial`` is the differentiable
    form, without ``kv_len``)."""
    _check_partial("flash_attention_partial", q, k, v)
    koff = _kv_offset("flash_attention_partial", kv_offset)
    _check_kv_len("flash_attention_partial", kv_len, q.shape[0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise MXNetError(
            "flash_attention_partial: an input requires a gradient, which "
            "this call would drop; use ops.attention."
            "blockwise_attention_partial, whose autograd Function runs the "
            "backward kernels")
    lim = () if kv_len is None else (kv_len,)
    if not _route("flash_attention_partial", q, k, v, *lim):
        return flash_attention_partial_plain(q, k, v, causal, block_size,
                                             koff, kv_len)
    B, Tq, H, D = q.shape
    _check_mha_launch("flash_attention_partial", D, q.dtype, q, k, v)
    if kv_len is not None:
        kv_len = kv_len.to(torch.int32).contiguous()
    o = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = _load("flash_attention_partial", "flash_attention_partial_fwd",
               [_vp] * 6 + [_strides] + [_i] * 7 + [_vp, _i, _vp])
    strides = _layout_args(*(x.transpose(1, 2) for x in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 m.data_ptr(), l.data_ptr(), strides, B, H, Tq, k.shape[1],
                 D, int(bool(causal)), koff,
                 None if kv_len is None else kv_len.data_ptr(),
                 _DTYPE_CODE[q.dtype], stream)
    _check_launch(err, "flash_attention_partial")
    LAUNCHES["flash_attention_partial"] += 1
    return o, m, l


def flash_attention_bwd_plain(q, k, v, m, do, dl, causal: bool = False,
                              block_size: int = 512, kv_offset: int = 0):
    """Plain version of the backward: the kernels' formulas in float32,
    key block by key block (``block_size`` keys; no autograd).

    m held constant (m_safe = 0 where m = -inf); p = exp(q.k^T*scale -
    m_safe) under the forward's masks; ds = p*(do.v^T + dl); dq =
    ds.k*scale, dk = ds^T.q*scale, dv = p^T.do, with ds rounded to the
    inputs' dtype before its products, as the TPU kernels cast it.
    Returns (dq, dk, dv) in q's, k's and v's shapes and dtype."""
    dt = q.dtype
    rnd = (lambda x: x) if dt == torch.float32 \
        else (lambda x: x.to(dt).float())
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # BHTD
    ob = do.float()
    lb = dl.float()[..., None]
    m_safe = torch.where(torch.isfinite(m), m, 0.0).float()[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    q_pos = torch.arange(Tq, device=q.device)
    block = max(1, int(block_size or 512))
    for j0 in range(0, Tk, block):
        j1 = min(j0 + block, Tk)
        k_j, v_j = kf[:, :, j0:j1], vf[:, :, j0:j1]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, k_j) * scale
                      - m_safe)
        if causal:
            k_pos = torch.arange(j0, j1, device=q.device) + kv_offset
            p = torch.where(k_pos[None, :] <= q_pos[:, None], p, 0.0)
        ds = rnd(p * (torch.einsum("bhqd,bhkd->bhqk", ob, v_j) + lb))
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, k_j) * scale
        dk[:, :, j0:j1] = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        dv[:, :, j0:j1] = torch.einsum("bhqk,bhqd->bhkd", p, ob)
    return tuple(g.transpose(1, 2).to(dt) for g in (dq, dk, dv))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        m: torch.Tensor, do, dl, causal: bool = False,
                        block_size: int = 512, kv_offset: int = 0):
    """Backward of ``flash_attention_partial``: q, k, v, its row max m
    (B, H, Tq), and the cotangents do of o (B, H, Tq, D) and dl of l
    (B, H, Tq) (``None``: zeros) → (dq, dk, dv), each in its input's
    shape and dtype.  m's cotangent is not taken: it cancels exactly
    (``ops.attention._FlashPartialFn``).

    On a CUDA device two kernels run: dq, and dk/dv, kv-block-outer
    (each gradient row written once by one block: no atomics)."""
    _check_partial("flash_attention_bwd", q, k, v)
    B, Tq, H, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    do = torch.zeros((B, H, Tq, D), **f32) if do is None else do
    dl = torch.zeros((B, H, Tq), **f32) if dl is None else dl
    if m.shape != (B, H, Tq) or dl.shape != (B, H, Tq) \
            or do.shape != (B, H, Tq, D):
        raise MXNetError(
            f"flash_attention_bwd: shapes disagree: q {tuple(q.shape)}, m "
            f"{tuple(m.shape)}, do {tuple(do.shape)}, dl {tuple(dl.shape)}")
    koff = _kv_offset("flash_attention_bwd", kv_offset)
    if not _route("flash_attention_bwd", q, k, v, m, do, dl):
        return flash_attention_bwd_plain(q, k, v, m, do, dl, causal,
                                         block_size, koff)
    _check_mha_launch("flash_attention_bwd", D, q.dtype, q, k, v)
    m, do, dl = (x.float().contiguous() for x in (m, do, dl))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch_flash_attention_bwd("dq", q, k, v, m, do, dl, (dq,), causal, koff)
    launch_flash_attention_bwd("dkv", q, k, v, m, do, dl, (dk, dv), causal,
                               koff)
    return dq, dk, dv


def launch_flash_attention_bwd(part: str, q, k, v, m, do, dl, outs,
                               causal: bool, kv_offset: int) -> None:
    """Launch one of the two backward kernels on inputs
    ``flash_attention_bwd`` has checked (CUDA, one dtype, lanes
    contiguous; m, do and dl contiguous float32): ``part`` "dq" writes
    ``outs`` (dq,), "dkv" writes (dk, dv).  Counts the launch."""
    name = f"flash_attention_bwd_{part}"
    B, Tq, H, D = q.shape
    fn = _load("flash_attention_partial_bwd", name,
               [_vp] * (6 + len(outs)) + [_strides] + [_i] * 8 + [_vp])
    strides = _layout_args(*(x.transpose(1, 2) for x in (q, k, v, *outs)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                 do.data_ptr(), dl.data_ptr(), *(t.data_ptr() for t in outs),
                 strides, B, H, Tq, k.shape[1], D, int(bool(causal)),
                 kv_offset, _DTYPE_CODE[q.dtype], stream)
    _check_launch(err, name)
    LAUNCHES[name] += 1


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
    from .attention import (_blockwise_attention_partial_plain,
                            normalize_attention_state)

    B, MB = block_table.shape
    KVB, H, D = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    idx = block_table.long()
    kg = k_pool[idx].reshape(B, MB * KVB, H, D)
    vg = v_pool[idx].reshape(B, MB * KVB, H, D)
    o, m, l = _blockwise_attention_partial_plain(
        q[:, None], kg, vg, causal=True, block_size=KVB, lengths=lengths)
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
    _check_paged_launch("paged_attention_decode", q, D,
                        (k_pool, v_pool, block_table, lengths), block_table,
                        lengths)
    pair = _raw_pair("paged_attention_decode", q, k_pool, v_pool)
    fn = _load("paged_attention_decode", "paged_attention_decode",
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


# ---------------------------------------------------------------------------
# paged_attention_decode_quant
# ---------------------------------------------------------------------------


def gather_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` along the page axis; an fp8 pool is gathered through
    its uint8 view (the same bytes), which every device indexes."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[idx].view(pool.dtype)
    return pool[idx]


def gather_dequant(pool, scale, idx):
    """(B, MB*KVB, H, D) float32 values of the table's pages."""
    from .attention import dequantize_kv

    B, MB = idx.shape
    KVB, H, D = pool.shape[1], pool.shape[2], pool.shape[3]
    return dequantize_kv(gather_pages(pool, idx).reshape(B, MB * KVB, H, D),
                         scale[idx].reshape(B, MB * KVB, H))


def paged_attention_decode_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       block_table, lengths):
    """Plain version: gather the table's pages and their scales,
    dequantize to float32 (``dequantize_kv``), then the blockwise body
    with block == KVB and the per-stream length mask.  (B, H, D) in q's
    dtype."""
    from .attention import (_blockwise_attention_partial_plain,
                            normalize_attention_state)

    idx = block_table.long()
    kg = gather_dequant(k_pool, k_scale, idx)
    vg = gather_dequant(v_pool, v_scale, idx)
    o, m, l = _blockwise_attention_partial_plain(
        q[:, None], kg, vg, causal=True, block_size=k_pool.shape[1],
        lengths=lengths)
    return normalize_attention_state(o, m, l, q.dtype)[:, 0]


def _check_quant_pools(name, k_pool, v_pool, k_scale, v_scale):
    if k_pool.dtype not in _QUANT_CODE or v_pool.dtype != k_pool.dtype:
        raise MXNetError(f"{name}: pools {k_pool.dtype}/{v_pool.dtype} (the "
                         f"kernel takes int8 or float8_e4m3fn, one for both)")
    want = tuple(k_pool.shape[:3])
    for sname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise MXNetError(f"{name}: {sname} must be float32 {want} "
                             f"(P, KVB, H); got {t.dtype} "
                             f"{tuple(t.shape)}")


def paged_attention_decode_quant(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """``paged_attention_decode`` over quantized pages: k_pool/v_pool
    (P, KVB, H, D) int8 or float8_e4m3fn codes, k_scale/v_scale
    (P, KVB, H) float32 per-(slot, head) scales; each element is
    ``float(code) * scale``.  q (B, H, D) float32, bfloat16 or float16, with any
    batch stride → (B, H, D) in q's dtype; lengths == 0 gives zeros."""
    if q.ndim != 3 or k_pool.ndim != 4 or block_table.ndim != 2 \
            or lengths.ndim != 1:
        raise MXNetError(
            f"paged_attention_decode_quant wants q (B, H, D), pools "
            f"(P, KVB, H, D), table (B, MB), lengths (B,); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(block_table.shape)}, {tuple(lengths.shape)}")
    B, H, D = q.shape
    if tuple(k_pool.shape[2:]) != (H, D) or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != B or lengths.shape[0] != B:
        raise MXNetError(
            f"paged_attention_decode_quant: shapes disagree: q "
            f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
            f"{tuple(v_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    _check_quant_pools("paged_attention_decode_quant", k_pool, v_pool,
                       k_scale, v_scale)
    if not _route("paged_attention_decode_quant", q, k_pool, v_pool,
                  k_scale, v_scale, block_table, lengths):
        return paged_attention_decode_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, block_table, lengths)
    _check_paged_launch("paged_attention_decode_quant", q, D,
                        (k_pool, v_pool, k_scale, v_scale, block_table,
                         lengths), block_table, lengths)
    fn = _load("paged_attention_decode_quant", "paged_attention_decode_quant",
               [_vp, ctypes.c_long, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                _i, _i, _i, _i, _i, _i, _vp])
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), q.stride(0), k_pool.data_ptr(),
                 v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, H, D, k_pool.shape[1], block_table.shape[1],
                 _DTYPE_CODE[q.dtype], _QUANT_CODE[k_pool.dtype], stream)
    _check_launch(err, "paged_attention_decode_quant")
    LAUNCHES["paged_attention_decode_quant"] += 1
    return out


def _raw_pair(name, q, k_pool, v_pool):
    """(q, pool) dtype codes of a raw-page kernel: fp32 q over fp32,
    bf16 or fp16 pools, bf16/bf16 or fp16/fp16."""
    pair = (_DTYPE_CODE.get(q.dtype), _DTYPE_CODE.get(k_pool.dtype))
    if pair not in ((0, 0), (0, 1), (0, 2), (1, 1), (2, 2)) \
            or v_pool.dtype != k_pool.dtype:
        raise MXNetError(
            f"{name}: q {q.dtype} over pools {k_pool.dtype}/{v_pool.dtype} "
            f"(the kernel takes fp32/fp32, fp32/bf16, fp32/fp16, bf16/bf16 "
            f"and fp16/fp16)")
    return pair


def _check_paged_launch(name, q, D, tensors, block_table, ints):
    """What every paged kernel needs of its CUDA inputs: q float32,
    bfloat16 or float16 with head and lane strides D and 1, int32 table
    and lengths/start, contiguous pools, scales and ints, D up to
    ``FLASH_MHA_MAX_HEAD_DIM``."""
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{name}: q {q.dtype} (the kernel takes "
                         f"{_DTYPE_NAMES})")
    if block_table.dtype != torch.int32 or ints.dtype != torch.int32:
        raise MXNetError(f"{name}: the block table and the per-stream "
                         f"lengths/start must be int32")
    _check_head_dim(name, D)
    if q.stride(-1) != 1 or q.stride(-2) != D:
        raise MXNetError(f"{name}: q's head and lane strides must be D "
                         f"and 1")
    for t in tensors:
        if not t.is_contiguous():
            raise MXNetError(f"{name}: pools, scales, table and "
                             f"lengths/start must be contiguous")


# ---------------------------------------------------------------------------
# paged_attention_verify (raw and quantized pages)
# ---------------------------------------------------------------------------


def paged_attention_verify_plain(q, k_pool, v_pool, block_table, start,
                                 k_scale=None, v_scale=None):
    """Plain version: row w is the plain decode (with scales: the plain
    quantized decode) at ``lengths = start + 1 + w``, so on any device
    verify row w equals the decode step bit for bit.  (B, W, H, D) in
    q's dtype."""
    start = start.to(torch.int32)
    rows = []
    for w in range(q.shape[1]):
        lengths = start + (1 + w)
        if k_scale is None:
            rows.append(paged_attention_decode_plain(
                q[:, w], k_pool, v_pool, block_table, lengths))
        else:
            rows.append(paged_attention_decode_quant_plain(
                q[:, w], k_pool, v_pool, k_scale, v_scale, block_table,
                lengths))
    return torch.stack(rows, dim=1)


def paged_attention_verify(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           start: torch.Tensor,
                           k_scale: torch.Tensor = None,
                           v_scale: torch.Tensor = None) -> torch.Tensor:
    """Speculative-verify attention: q (B, W, H, D), the window's queries
    at positions ``start[b] + w`` (their K/V already in the pools);
    pools (P, KVB, H, D); block_table (B, MB) int32; start (B,) int32
    tokens cached before the window → (B, W, H, D) in q's dtype, row w
    under the mask ``k_pos < start + 1 + w``.

    Raw fp32/bf16/fp16 pools launch ``paged_attention_verify``; int8/fp8
    pools with their (P, KVB, H) float32 scales launch
    ``paged_attention_verify_quant``.  q may be a strided view (the
    query third of a packed qkv): head and lane strides D and 1."""
    if q.ndim != 4 or k_pool.ndim != 4 or block_table.ndim != 2 \
            or start.ndim != 1:
        raise MXNetError(
            f"paged_attention_verify wants q (B, W, H, D), pools "
            f"(P, KVB, H, D), table (B, MB), start (B,); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(block_table.shape)}, {tuple(start.shape)}")
    B, W, H, D = q.shape
    if tuple(k_pool.shape[2:]) != (H, D) or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != B or start.shape[0] != B:
        raise MXNetError(
            f"paged_attention_verify: shapes disagree: q {tuple(q.shape)}, "
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, start {tuple(start.shape)}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise MXNetError("paged_attention_verify: give both scales or none")
    name = "paged_attention_verify_quant" if quant \
        else "paged_attention_verify"
    extra = (k_scale, v_scale) if quant else ()
    if quant:
        _check_quant_pools(name, k_pool, v_pool, k_scale, v_scale)
    if not _route(name, q, k_pool, v_pool, block_table, start, *extra):
        return paged_attention_verify_plain(q, k_pool, v_pool, block_table,
                                            start, k_scale, v_scale)
    _check_paged_launch(name, q, D, (k_pool, v_pool, block_table, start,
                                     *extra), block_table, start)
    if quant:
        codes = (_DTYPE_CODE[q.dtype], _QUANT_CODE[k_pool.dtype])
        fn = _load("paged_attention_verify", name,
                   [_vp, ctypes.c_long, ctypes.c_long, _vp, _vp, _vp, _vp,
                    _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp])
    else:
        codes = _raw_pair(name, q, k_pool, v_pool)
        fn = _load("paged_attention_verify", name,
                   [_vp, ctypes.c_long, ctypes.c_long, _vp, _vp, _vp, _vp,
                    _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp])
    out = torch.empty((B, W, H, D), dtype=q.dtype, device=q.device)
    pools = [k_pool.data_ptr(), v_pool.data_ptr()] \
        + [t.data_ptr() for t in extra]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), q.stride(0), q.stride(1), *pools,
                 block_table.data_ptr(), start.data_ptr(), out.data_ptr(),
                 B, W, H, D, k_pool.shape[1], block_table.shape[1], *codes,
                 stream)
    _check_launch(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# lstm_scan
# ---------------------------------------------------------------------------


def lstm_scan_plain(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                    ut: torch.Tensor):
    """Plain version: the step-by-step recurrence with ``ops/rnn.py``'s
    own LSTM cell (so the forward and the remat backward cannot drift
    apart), ``pre = xw[t] + h @ ut``.  Differentiable."""
    from .rnn import _cell_step, _scan

    cell = _cell_step("lstm", h0.shape[-1])
    (hT, cT), y = _scan(lambda carry, x_t: cell(carry, x_t + carry[0] @ ut),
                        (h0, c0), xw, reverse=False)
    return y, hT, cT


def lstm_scan(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              ut: torch.Tensor):
    """LSTM recurrence: xw (T, B, 4H) the input projection with both
    biases, gates [i | f | g | o]; h0, c0 (B, H); ut (H, 4H) the
    recurrent weight transposed → (y (T, B, H), hT, cT), float32.

    No gradient flows through this call: an input that requires one
    raises.  ``ops.rnn._LSTMScanFn`` is the differentiable form."""
    if xw.ndim != 3 or h0.ndim != 2 or c0.ndim != 2 or ut.ndim != 2:
        raise MXNetError(
            f"lstm_scan wants xw (T, B, 4H), h0/c0 (B, H), ut (H, 4H); got "
            f"{tuple(xw.shape)}, {tuple(h0.shape)}, {tuple(c0.shape)}, "
            f"{tuple(ut.shape)}")
    T, B, G = xw.shape
    H = h0.shape[1]
    if G != 4 * H or h0.shape != (B, H) or c0.shape != (B, H) \
            or ut.shape != (H, G):
        raise MXNetError(
            f"lstm_scan: shapes disagree: xw {tuple(xw.shape)}, h0 "
            f"{tuple(h0.shape)}, c0 {tuple(c0.shape)}, ut {tuple(ut.shape)}")
    tensors = (xw, h0, c0, ut)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise MXNetError(
            "lstm_scan: an input requires a gradient, which this call would "
            "drop; use the RNN op, whose autograd Function rematerializes "
            "the backward")
    if not _route("lstm_scan", *tensors):
        return lstm_scan_plain(xw, h0, c0, ut)
    if any(t.dtype != torch.float32 for t in tensors):
        raise MXNetError(f"lstm_scan: dtypes {[t.dtype for t in tensors]} "
                         f"(the kernel takes float32)")
    if H > LSTM_MAX_HIDDEN:
        raise MXNetError(f"lstm_scan: hidden size {H} (the kernel takes up "
                         f"to {LSTM_MAX_HIDDEN})")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("lstm_scan: xw, h0, c0 and ut must be contiguous")
    fn = _load("lstm_scan", "lstm_scan",
               [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp])
    y = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    hT = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    cT = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xw.data_ptr(), h0.data_ptr(), c0.data_ptr(), ut.data_ptr(),
                 y.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, B, H, stream)
    _check_launch(err, "lstm_scan")
    LAUNCHES["lstm_scan"] += 1
    return y, hT, cT


# ---------------------------------------------------------------------------
# nms
# ---------------------------------------------------------------------------


def nms_plain(rows: torch.Tensor, nms_threshold: float,
              force_suppress: bool) -> torch.Tensor:
    """Plain version: A rounds over all images at once, with the
    kernel's arithmetic op for op (no fused multiply-add), so the kernel
    equals it bit for bit."""
    out = rows.clone()
    cls = out[:, :, 0]  # a view: suppression writes into out
    l, t, r, b = (rows[:, :, k] for k in range(2, 6))
    area = (r - l) * (b - t)
    later = torch.arange(rows.shape[1], device=rows.device)
    thr = float(torch.tensor(nms_threshold, dtype=torch.float32))
    for i in range(rows.shape[1] - 1):
        cls_i = cls[:, i:i + 1].clone()
        w = torch.clamp(torch.minimum(r, r[:, i:i + 1])
                        - torch.maximum(l, l[:, i:i + 1]), min=0.0)
        h = torch.clamp(torch.minimum(b, b[:, i:i + 1])
                        - torch.maximum(t, t[:, i:i + 1]), min=0.0)
        inter = w * h
        union = (area + area[:, i:i + 1]) - inter
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                          0.0)
        kill = (cls_i >= 0) & (later > i) & (cls >= 0) & (iou >= thr)
        if not force_suppress:
            kill &= cls == cls_i
        cls.masked_fill_(kill, -1.0)
    return out


def nms_workspace_bytes(A: int) -> int:
    """Bytes of one image's suppression mask: A rows of ceil(A / 64)
    64-bit words."""
    return A * -(-A // 64) * 8


def nms(rows: torch.Tensor, nms_threshold: float,
        force_suppress: bool) -> torch.Tensor:
    """Greedy NMS over score-sorted rows (B, A, 6) [cls, score, l, t, r,
    b] float32: in order of i, a live row (cls >= 0) suppresses every
    later live row of its class (any class under ``force_suppress``)
    whose IoU with it is at least ``nms_threshold`` by setting its cls
    to -1.  Returns a new tensor; columns 1-5 pass through.

    On the card: under ``force_suppress`` one launch that tests only the
    survivors' pairs.  Otherwise A <= ``NMS_FUSED_MAX_ROWS`` runs one
    launch with the mask in shared memory, and a larger A computes the
    mask into a workspace of ``nms_workspace_bytes(A)`` an image, then
    sweeps it: the workspace, at most ``NMS_WORKSPACE_BUDGET`` bytes, is
    allocated on the rows' stream and the images run in groups of as
    many as it holds.  One call counts one launch, whatever the
    groups."""
    if rows.ndim != 3 or rows.shape[2] != 6:
        raise MXNetError(f"nms wants rows (B, A, 6); got "
                         f"{tuple(rows.shape)}")
    if not _route("nms", rows):
        return nms_plain(rows, nms_threshold, force_suppress)
    if rows.dtype != torch.float32:
        raise MXNetError(f"nms: dtype {rows.dtype} (the kernel takes "
                         f"float32)")
    if not rows.is_contiguous():
        raise MXNetError("nms: rows must be contiguous")
    B, A, _ = rows.shape
    if B == 0 or A == 0:
        raise MXNetError(f"nms: no rows ({tuple(rows.shape)})")
    per_image = nms_workspace_bytes(A)
    if per_image > NMS_WORKSPACE_BUDGET:
        raise MXNetError(f"nms: A = {A} rows (one image's suppression mask, "
                         f"{per_image} bytes, exceeds NMS_WORKSPACE_BUDGET)")
    workspace = None
    if not force_suppress and A > NMS_FUSED_MAX_ROWS:
        workspace = torch.empty(
            min(B, NMS_WORKSPACE_BUDGET // per_image) * per_image,
            dtype=torch.uint8, device=rows.device)
    out = _nms_launch(rows, nms_threshold, force_suppress, workspace)
    LAUNCHES["nms"] += 1
    return out


def _nms_launch(rows: torch.Tensor, nms_threshold: float,
                force_suppress: bool,
                workspace: torch.Tensor | None) -> torch.Tensor:
    """B7's kernels on contiguous float32 CUDA rows (B, A, 6), counting
    no launch: under ``force_suppress`` the survivors' kernel; else with
    a ``workspace`` (8-byte aligned, on the rows' device) the mask and
    the sweep, the images in groups of as many as it holds, and without
    one the fused launch (A <= ``NMS_FUSED_MAX_ROWS``)."""
    B, A, _ = rows.shape
    group, ws = B, 0
    if workspace is not None and not force_suppress:
        group = min(B, workspace.nbytes // nms_workspace_bytes(A))
        ws = workspace.data_ptr()
    fn = _load("nms", "nms", [_vp, _vp, _vp, _i, _i, ctypes.c_float, _i,
                              _vp])
    out = torch.empty_like(rows)
    step = A * 6 * rows.element_size()  # bytes of one image's rows
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b in range(0, B, group):
            err = fn(rows.data_ptr() + b * step, out.data_ptr() + b * step,
                     ws, min(group, B - b), A, float(nms_threshold),
                     int(bool(force_suppress)), stream)
            _check_launch(err, "nms")
    return out
