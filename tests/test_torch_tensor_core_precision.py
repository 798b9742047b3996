"""Why the tensor-core kernels split fp32 into TF32 pairs, shown on the CPU.

``csrc/flash_mha_packed.cu`` and ``csrc/flash_mha_packed_bwd.cu`` (B1's
forward and backward), ``csrc/flash_mha.cu`` and
``csrc/flash_mha_bwd.cu`` (B5's forward and backward),
``csrc/flash_attention_partial.cu`` (B8) and
``csrc/flash_attention_partial_bwd.cu`` (B9) run every product on the
H100's tensor cores (``csrc/tensor_core.cuh``). fp32 operands go in as
split TF32: ``big = tf32(x)``, ``small = tf32(x - big)``, each rounded
as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero, 10 stored
mantissa bits), and a product is ``big.small + small.big + big.big``
accumulated in fp32. A bf16 operand is exact in TF32, so a product of an
fp32 operand with a bf16 one needs two. bf16 products run on bf16 tensor
cores, which multiply exactly and accumulate in fp32. P is rounded to
bf16 before the bf16 P.V of B1's, B5's and B8's forward and before B1's
and B5's backward's P^T.dO; B9 keeps P in fp32; the backwards round dS to
the input dtype before dS.K and dS^T.q, as the TPU kernels do.

This file emulates those products in torch on the CPU (fp32 matmuls over
TF32-valued operands, whose products are exact in fp32) at B1's prefill
and training shape (1, 1024, 12 heads, 64, causal), at B5's head width
128 and a Tq != Tk causal case (256 queries, 1024 keys), forward and
backward, and at a (1, 12, 512, 512, 64) ring hop of B8 and B9, from
seeded numpy inputs, and holds the result against the plain versions
``flash_mha_packed_plain``, ``flash_mha_packed_bwd_plain``,
``flash_mha_plain``, ``flash_mha_bwd_plain``,
``flash_attention_partial_plain`` and ``flash_attention_bwd_plain`` with
``chip_smoke.py``'s tolerances: the
split scheme lands within half of ``TOL["float32"]`` and of ``BWD_TOL``;
one TF32 product alone does not land within them. B1's and B5's bf16
backward, with P and dS rounded, are also held against the JAX package's
``flash_mha_packed`` and ``flash_mha`` backward (``jax.vjp`` through its
Pallas kernels in interpret mode), and B8's bf16 state against the JAX
``flash_attention_partial`` (its Pallas kernel in interpret mode).  B8's
per-row key limit (``kv_len``) is emulated the same way, causal and not,
at the limit's edges, and its plain version is held against the JAX lax
body's ``lengths=`` mask.  The emulation takes the softmax over
whole rows; the kernels' online softmax over key tiles rescales the same
products.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import cuda_kernels as ck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (TOL, BWD_TOL)

TOL, BWD_TOL = chip_smoke.TOL, chip_smoke.BWD_TOL
LOG2E = 1.4426950408889634


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32: to nearest, ties away from
    zero, on the 13 low mantissa bits (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm_split(a, b, exact_a=False, exact_b=False):
    """a @ b as the kernels' split-TF32 products: three, or two where one
    operand is exact in TF32 (it came from bf16)."""
    if exact_a:
        bb, bs = split(b)
        return a @ bs + a @ bb
    ab, as_ = split(a)
    if exact_b:
        return as_ @ b + ab @ b
    bb, bs = split(b)
    return ab @ bs + as_ @ bb + ab @ bb


def mm_tf32(a, b, **_):
    """a @ b as ONE TF32 product: each operand rounded to TF32."""
    return tf32(a) @ tf32(b)


def randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def b1_forward(qkv, H, mm):
    """B1's forward, causal, with the products of ``mm`` and the rounding
    of qkv's dtype → (o in qkv's dtype, lse (B, T, H) natural log)."""
    B, T, _ = qkv.shape
    D = qkv.shape[2] // (3 * H)
    bf16 = qkv.dtype == torch.bfloat16
    q, k, v = (x.float().unflatten(-1, (H, D)).transpose(1, 2)
               for x in qkv.split(H * D, dim=-1))
    prod = (lambda a, b: a @ b) if bf16 else mm
    s = prod(q, k.transpose(-1, -2)) * (LOG2E / math.sqrt(D))
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    s = torch.where(causal, s, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() @ v if bf16 else mm(p, v)
    o = (pv / l).transpose(1, 2).reshape(B, T, H * D).to(qkv.dtype)
    lse = ((m + torch.log2(l)) * math.log(2.0))[..., 0].transpose(1, 2)
    return o, lse


def b1_backward(qkv, o, lse, do, H, mm):
    """B1's backward, causal, with the products of ``mm`` (fp32) or bf16
    products with P and dS rounded to bf16 (bf16) → dqkv (B, T, 3*H*D)
    in qkv's dtype."""
    B, T, _ = qkv.shape
    D = qkv.shape[2] // (3 * H)
    dt = qkv.dtype
    bf16 = dt == torch.bfloat16
    rnd = (lambda x: x.to(dt).float()) if bf16 else (lambda x: x)
    prod = (lambda a, b: a @ b) if bf16 else mm
    heads = (lambda x: x.float().unflatten(-1, (H, D)).transpose(1, 2))
    q, k, v = (heads(x) for x in qkv.split(H * D, dim=-1))
    of, dof = heads(o), heads(do)
    scale = 1.0 / math.sqrt(D)
    lse2 = lse.float().transpose(1, 2)[..., None] * LOG2E   # (B, H, T, 1)
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    s = prod(q, k.transpose(-1, -2))
    p = torch.where(causal, torch.exp2(s * (scale * LOG2E) - lse2), 0.0)
    dp = prod(dof, v.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = rnd(p * (dp - delta))
    dq = prod(ds, k) * scale
    dk = prod(ds.transpose(-1, -2), q) * scale
    dv = prod(rnd(p).transpose(-1, -2), dof)
    return torch.cat([g.transpose(1, 2).flatten(2) for g in (dq, dk, dv)],
                     dim=-1).to(dt)


def b5_forward(q, k, v, causal, mm):
    """B5's forward on (B, H, T, D) tensors, the causal mask aligned at
    position 0, with the products of ``mm`` and the rounding of q's dtype
    → (o in q's dtype, lse (B, H, Tq) natural log)."""
    Tq, Tk, D = q.shape[2], k.shape[2], q.shape[3]
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf = (x.float() for x in (q, k, v))
    prod = (lambda a, b: a @ b) if bf16 else mm
    s = prod(qf, kf.transpose(-1, -2)) * (LOG2E / math.sqrt(D))
    if causal:
        mask = torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None]
        s = torch.where(mask, s, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() @ vf if bf16 else mm(p, vf)
    o = (pv / l).to(q.dtype)
    lse = ((m + torch.log2(l)) * math.log(2.0))[..., 0]
    return o, lse


def b5_backward(q, k, v, o, lse, do, causal, mm):
    """B5's backward on (B, H, T, D) tensors, the causal mask aligned at
    position 0, Delta = rowsum(do * o) in float32 as the wrapper takes
    it, with the products of ``mm`` (fp32) or bf16 products with P
    rounded to do's dtype and dS to k's (bf16) → (dq, dk, dv) in the
    inputs' dtype."""
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    rnd = (lambda x: x.to(dt).float()) if bf16 else (lambda x: x)
    prod = (lambda a, b: a @ b) if bf16 else mm
    Tq, Tk, D = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = prod(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None] * LOG2E)
    if causal:
        mask = torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None]
        p = torch.where(mask, p, 0.0)
    dp = prod(dof, vf.transpose(-1, -2))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = rnd(p * (dp - delta))
    dq = prod(ds, kf) * scale
    dk = prod(ds.transpose(-1, -2), qf) * scale
    dv = prod(rnd(p).transpose(-1, -2), dof)
    return tuple(g.to(dt) for g in (dq, dk, dv))


def b8_forward(q, k, v, koff, mm, kv_len=None, causal=True):
    """B8 (causal or not, key offset koff, per-row key limit ``kv_len``)
    on BTHD tensors with the products of ``mm`` and the rounding of q's
    dtype → the un-normalized state (o (B, H, Tq, D), m (B, H, Tq)
    natural units, l (B, H, Tq)), float32; a row that sees no key: m =
    -inf, l = 0, o = 0."""
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[3]
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # BHTD
    prod = (lambda a, b: a @ b) if bf16 else mm
    s = prod(qf, kf.transpose(-1, -2)) * (LOG2E / math.sqrt(D))
    mask = (torch.arange(Tk) + koff)[None, :] <= torch.arange(Tq)[:, None] \
        if causal else torch.ones((Tq, Tk), dtype=torch.bool)
    mask = mask[None, None]
    if kv_len is not None:
        mask = mask & (torch.arange(Tk)[None, :] < kv_len[:, None])[
            :, None, None, :]
    s = torch.where(mask, s, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1)
    o = p.to(torch.bfloat16).float() @ vf if bf16 else mm(p, vf)
    return o, m[..., 0] * math.log(2.0), l


def _b8_errors(got, ref):
    """chip_smoke.check_partial's measures: the rows that see no key
    hold exactly the plain state (m = -inf, l = 0, o = 0); m's error
    and l's relative error over the others; o / l's max error."""
    (o, m, l), (po, pm, pl) = got, ref
    empty = torch.isinf(pm)
    assert torch.equal(torch.isinf(m), empty)
    assert not o[empty].any() and not l[empty].any()
    seen = ~empty
    m_err = (m[seen] - pm[seen]).abs().max().item()
    l_err = ((l[seen] - pl[seen]).abs() / pl[seen]).max().item()
    norm = (o / l.clamp(min=1e-30)[..., None]
            - po / pl.clamp(min=1e-30)[..., None]).abs().max().item()
    return norm, m_err, l_err, int(empty.sum())


def _b8_inputs(dtype, seed=13):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    return tuple(randn(rng, 1, 512, 12, 64).to(dt) for _ in range(3))


# the past hop (nothing masked), the diagonal, and a hop whose first 128
# rows see no key
B8_OFFSETS = (-512, 0, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("koff", B8_OFFSETS)
def test_b8_split_tf32_within_half_the_tolerance(dtype, koff):
    """B8 at a (1, 12, 512, 512, 64) ring hop: fp32 split TF32 within
    TOL/2 of ``flash_attention_partial_plain`` on o / l, m within the
    check's 1e-4 and l within its 1e-5 relative; bf16 with P rounded
    before P.V within the chip's bf16 TOL; the empty rows exact."""
    q, k, v = _b8_inputs(dtype)
    ref = ck.flash_attention_partial_plain(q, k, v, True, 512, koff)
    norm, m_err, l_err, empty = _b8_errors(b8_forward(q, k, v, koff,
                                                      mm_split), ref)
    assert empty == (12 * koff if koff > 0 else 0)
    limit = TOL[dtype] / 2 if dtype == "float32" else TOL[dtype]
    assert norm <= limit and m_err <= 1e-4 and l_err <= 1e-5, \
        (dtype, koff, norm, m_err, l_err)


def test_b8_one_tf32_product_misses_the_tolerance():
    """One TF32 product for Q.K^T and one for P.V at the past hop: o / l
    misses TOL["float32"], which is why the fp32 path splits."""
    q, k, v = _b8_inputs("float32")
    ref = ck.flash_attention_partial_plain(q, k, v, True, 512, -512)
    norm, _, _, _ = _b8_errors(b8_forward(q, k, v, -512, mm_tf32), ref)
    assert norm > TOL["float32"], norm


@pytest.mark.parametrize("koff", B8_OFFSETS)
def test_b8_bf16_state_against_the_jax_reference(monkeypatch, koff):
    """The JAX package's bf16 ``flash_attention_partial`` (its Pallas
    kernel in interpret mode, which rounds P to bf16 before P.V) against
    the kernel's rounding (``b8_forward``) and the port's plain version:
    o / l within the chip's bf16 TOL, m and l within the check's
    limits, the rows that see no key exact."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    q, k, v = _b8_inputs("bfloat16")
    as_jax = (lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    ref = tuple(torch.from_numpy(np.array(x)) for x in
                pk.flash_attention_partial(*(as_jax(x) for x in (q, k, v)),
                                           True, 512, koff))
    for got in (b8_forward(q, k, v, koff, None),
                ck.flash_attention_partial_plain(q, k, v, True, 512, koff)):
        norm, m_err, l_err, _ = _b8_errors(got, ref)
        assert norm <= TOL["bfloat16"] and m_err <= 1e-4 \
            and l_err <= 1e-5, (koff, norm, m_err, l_err)


# B8's per-row key limit (the suffix prefill's prefix launch, the
# contiguous-cache decode): empty, one key, a 64-key tile's edges, all
# keys and past them, over 256 keys
B8_KV_LEN = (0, 1, 63, 64, 65, 200, 256, 300)


def _b8_limit_inputs(dtype, seed=14):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    B = len(B8_KV_LEN)
    return (tuple(randn(rng, B, T, 4, 64).to(dt) for T in (128, 256, 256))
            + (torch.tensor(B8_KV_LEN, dtype=torch.int32),))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_b8_key_limit_split_tf32_within_half_the_tolerance(dtype, causal):
    """B8 with ``kv_len`` at the limits of ``B8_KV_LEN`` (causal at key
    offset -128, so the limit and the causal mask both bind): fp32 split
    TF32 within TOL/2 of the plain version, bf16 within the chip's bf16
    TOL, the rows that see no key (``kv_len`` 0) the exact empty
    state."""
    q, k, v, lim = _b8_limit_inputs(dtype)
    koff = -128 if causal else 0
    ref = ck.flash_attention_partial_plain(q, k, v, causal, 64, koff,
                                           kv_len=lim)
    norm, m_err, l_err, empty = _b8_errors(
        b8_forward(q, k, v, koff, mm_split, lim, causal), ref)
    assert empty == 4 * 128  # the kv_len 0 row, every head and query
    limit = TOL[dtype] / 2 if dtype == "float32" else TOL[dtype]
    assert norm <= limit and m_err <= 1e-4 and l_err <= 1e-5, \
        (dtype, causal, norm, m_err, l_err)


@pytest.mark.parametrize("causal", [False, True])
def test_b8_key_limit_plain_against_the_jax_lax_body(causal):
    """The plain version's key limit against the JAX lax body
    (``_blockwise_attention_partial_lax``): non-causal against its
    ``lengths=`` mask; causal (limit and causal mask together) against
    its causal scan over each row's first ``kv_len[b]`` keys, the row
    with no key against the exact empty state.  o / l within
    ``TOL["float32"]``, m's -inf pattern equal."""
    from mxnet_tpu.ops.attention import _blockwise_attention_partial_lax

    q, k, v, lim = _b8_limit_inputs("float32")
    koff = -128 if causal else 0
    o, m, l = ck.flash_attention_partial_plain(q, k, v, causal, 64, koff,
                                               kv_len=lim)
    got = (o / l.clamp(min=1e-30)[..., None]).numpy()
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    for b, n in enumerate(B8_KV_LEN):
        if n == 0:
            assert torch.isinf(m[b]).all() and not l[b].any() \
                and not o[b].any()
            continue
        if causal:
            n = min(n, k.shape[1])
            jo, jm, jl = _blockwise_attention_partial_lax(
                qj[b:b + 1], kj[b:b + 1, :n], vj[b:b + 1, :n], True, 64,
                koff)
        else:
            jo, jm, jl = _blockwise_attention_partial_lax(
                qj[b:b + 1], kj[b:b + 1], vj[b:b + 1], False, 64, 0,
                lengths=jnp.asarray([n], jnp.int32))
        want = np.asarray(jo) / np.maximum(np.asarray(jl), 1e-30)[..., None]
        assert np.array_equal(np.isinf(np.asarray(jm)), torch.isinf(
            m[b:b + 1]).numpy())
        np.testing.assert_allclose(got[b:b + 1], want, rtol=0,
                                   atol=TOL["float32"])


def b9_backward(q, k, v, m, ob, lb, koff, mm):
    """B9 (causal, key offset koff) with the products of ``mm`` and the
    rounding of q's dtype → (dq, dk, dv) in the inputs' shapes and
    dtype."""
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    rnd = (lambda x: x.to(dt).float()) if bf16 else (lambda x: x)
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # BHTD
    m_safe = torch.where(torch.isfinite(m), m, 0.0)[..., None]
    mask = (torch.arange(Tk) + koff)[None, :] <= torch.arange(Tq)[:, None]
    exact = (lambda a, b: a @ b) if bf16 else mm
    s = exact(qf, kf.transpose(-1, -2))
    p = torch.where(mask, torch.exp(s * scale - m_safe), 0.0)
    dp = mm(ob, vf.transpose(-1, -2), exact_b=bf16)
    ds = rnd(p * (dp + lb[..., None]))
    dq = exact(ds, kf) * scale
    dk = exact(ds.transpose(-1, -2), qf) * scale
    dv = mm(p.transpose(-1, -2), ob)
    return tuple(g.transpose(1, 2).to(dt) for g in (dq, dk, dv))


@pytest.fixture(scope="module")
def b1_case():
    rng = np.random.RandomState(9)
    qkv = randn(rng, 1, 1024, 3 * 12 * 64)
    return qkv, {dt: ck.flash_mha_packed_plain(qkv.to(dt), 12, causal=True)
                 for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_forward_split_tf32_within_half_the_tolerance(b1_case, dtype):
    """fp32: split TF32 within TOL/2 of the plain version (o, and lse to
    the check's 10 x TOL/2).  bf16: bf16 products with P rounded to bf16
    before P.V within the chip's bf16 TOL (both outputs are rounded to
    bf16, one ulp of which is 0.0156 at |o| >= 2)."""
    qkv, plain = b1_case
    dt = getattr(torch, dtype)
    po, plse = plain[dt]
    o, lse = b1_forward(qkv.to(dt), 12, mm_split)
    err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    limit = TOL[dtype] / 2 if dtype == "float32" else TOL[dtype]
    assert err <= limit, (dtype, err)
    assert lse_err <= TOL["float32"] * 10 / 2, (dtype, lse_err)


def test_b1_forward_one_tf32_product_misses_the_tolerance(b1_case):
    """One TF32 product keeps ~3 decimal digits: o misses TOL["float32"],
    which is why the fp32 path splits."""
    qkv, plain = b1_case
    o, _ = b1_forward(qkv, 12, mm_tf32)
    err = (o - plain[torch.float32][0]).abs().max().item()
    assert err > TOL["float32"], err


def _b9_inputs(dtype, koff, seed=12):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    q, k, v = (randn(rng, 1, 512, 12, 64).to(dt) for _ in range(3))
    ob = randn(rng, 1, 12, 512, 64)
    lb = randn(rng, 1, 12, 512)
    _, m, _ = ck.flash_attention_partial_plain(q, k, v, True, 512, koff)
    return q, k, v, m, ob, lb


def _b9_errors(dtype, koff, mm):
    """Each gradient's max error against the plain version, over the
    check's tolerance: BWD_TOL * max(1, peak) in fp32, BWD_TOL * peak in
    bf16."""
    args = _b9_inputs(dtype, koff)
    ref = ck.flash_attention_bwd_plain(*args, causal=True, block_size=512,
                                       kv_offset=koff)
    got = b9_backward(*args, koff, mm)
    out = []
    for a, r in zip(got, ref):
        peak = r.float().abs().max().item()
        tol = BWD_TOL[dtype] * (max(1.0, peak) if dtype == "float32"
                                else peak)
        out.append((a.float() - r.float()).abs().max().item() / tol)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("koff", [0, -512])
def test_b9_split_tf32_within_half_the_tolerance(dtype, koff):
    """dq, dk and dv of the diagonal hop (koff 0) and a past hop (koff
    -512, nothing masked) within half of the check's tolerance."""
    ratios = _b9_errors(dtype, koff, mm_split)
    assert max(ratios) <= 0.5, (dtype, koff, ratios)


def test_b9_one_tf32_product_misses_the_tolerance():
    """One TF32 product for each fp32 product: some gradient misses
    BWD_TOL at the past hop."""
    ratios = _b9_errors("float32", -512, mm_tf32)
    assert max(ratios) > 1.0, ratios


def test_tf32_rounding_is_to_nearest_ties_away():
    """tf32() as cvt.rna.tf32.f32: 13 low bits cleared, rounded to the
    nearest, a tie away from zero; split() leaves about 2^-22 behind."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4])
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp]
    assert tf32(one).item() == 1.0
    rng = np.random.RandomState(0)
    y = randn(rng, 4096)
    big, small = split(y)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    rel = ((big.double() + small.double() - y.double()).abs()
           / y.double().abs()).max().item()
    assert rel <= 2.0 ** -21


def _bwd_tol(ref, dtype):
    peak = ref.float().abs().max().item()
    return BWD_TOL[dtype] * (max(1.0, peak) if dtype == "float32" else peak)


def _thirds_over_tol(got, ref, dtype):
    """The error of each third of dqkv (dq, dk, dv) over the check's
    tolerance for that kernel's output (chip_smoke.check_backward: one
    tolerance from the peak of the whole reference)."""
    tol = _bwd_tol(ref, dtype)
    n = ref.shape[-1] // 3
    return [(got[..., i * n:(i + 1) * n].float()
             - ref[..., i * n:(i + 1) * n].float()).abs().max().item() / tol
            for i in range(3)]


@pytest.fixture(scope="module")
def b1_bwd_case():
    """B1's training shape at batch 1: (1, 1024, 12 heads, 64), causal;
    o and lse from the plain forward in each dtype."""
    rng = np.random.RandomState(10)
    qkv = randn(rng, 1, 1024, 3 * 12 * 64)
    do = randn(rng, 1, 1024, 12 * 64)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x, g = qkv.to(dt), do.to(dt)
        o, lse = ck.flash_mha_packed_plain(x, 12, causal=True)
        out[dt] = (x, o, lse, g, ck.flash_mha_packed_bwd_plain(
            x, o, lse, g, 12, causal=True))
    return out


def test_b1_backward_split_tf32_within_half_the_tolerance(b1_bwd_case):
    """fp32: the five products (q.k^T, do.v^T, ds.k, ds^T.q, p^T.do) in
    split TF32 land within half of BWD_TOL on dq, dk and dv."""
    qkv, o, lse, do, ref = b1_bwd_case[torch.float32]
    got = b1_backward(qkv, o, lse, do, 12, mm_split)
    ratios = _thirds_over_tol(got, ref, "float32")
    assert max(ratios) <= 0.5, ratios


def test_b1_backward_one_tf32_product_misses_the_tolerance(b1_bwd_case):
    """One TF32 product for each of the five: some gradient misses
    BWD_TOL, which is why the fp32 path splits."""
    qkv, o, lse, do, ref = b1_bwd_case[torch.float32]
    got = b1_backward(qkv, o, lse, do, 12, mm_tf32)
    ratios = _thirds_over_tol(got, ref, "float32")
    assert max(ratios) > 1.0, ratios


def test_b1_backward_bf16_rounding_within_the_tolerance(b1_bwd_case):
    """bf16: every product on bf16 tensor cores, P rounded to bf16 before
    P^T.dO and dS before dS.K and dS^T.q, within the chip's bf16
    BWD_TOL of the plain version (which rounds neither)."""
    qkv, o, lse, do, ref = b1_bwd_case[torch.bfloat16]
    got = b1_backward(qkv, o, lse, do, 12, None)
    ratios = _thirds_over_tol(got, ref, "bfloat16")
    assert max(ratios) <= 1.0, ratios


def test_b1_bf16_backward_against_the_jax_reference(monkeypatch):
    """The JAX package's bf16 ``flash_mha_packed`` backward (``jax.vjp``
    through its Pallas kernels in interpret mode, which round P and dS
    to bf16 before their products) against the port's plain bf16
    backward and against the kernels' rounding (``b1_backward``), both
    on the port's plain forward: each within the chip's bf16 BWD_TOL."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    H, T, D = 2, 256, 64
    rng = np.random.RandomState(11)
    qkv = randn(rng, 1, T, 3 * H * D).to(torch.bfloat16)
    do = randn(rng, 1, T, H * D).to(torch.bfloat16)
    as_jax = (lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    _, vjp = jax.vjp(lambda x: pk.flash_mha_packed(
        x, H, causal=True, block_size=128), as_jax(qkv))
    (ref,) = vjp(as_jax(do))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    o, lse = ck.flash_mha_packed_plain(qkv, H, causal=True)
    plain = ck.flash_mha_packed_bwd_plain(qkv, o, lse, do, H, causal=True)
    kernel = b1_backward(qkv, o, lse, do, H, None)
    for got in (plain, kernel):
        ratios = _thirds_over_tol(got, ref, "bfloat16")
        assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 512, 512, 128),
                                   (1, 12, 256, 1024, 64)])
def test_b5_forward_split_tf32_within_half_the_tolerance(shape, dtype):
    """B5's forward, causal, at head width 128 and at Tq != Tk (the
    diagonal at q_pos = k_pos, 256 queries over 1024 keys), on BTHD
    views: fp32 split TF32 within TOL/2 of ``flash_mha_plain`` (lse to
    the check's 10 x TOL/2); bf16 with P rounded before P.V within the
    chip's bf16 TOL."""
    B, H, Tq, Tk, D = shape
    rng = np.random.RandomState(Tq + D)
    dt = getattr(torch, dtype)
    q, k, v = (randn(rng, B, T, H, D).to(dt).transpose(1, 2)
               for T in (Tq, Tk, Tk))
    po, plse = ck.flash_mha_plain(q, k, v, causal=True)
    o, lse = b5_forward(q, k, v, True, mm_split)
    err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    limit = TOL[dtype] / 2 if dtype == "float32" else TOL[dtype]
    assert err <= limit, (dtype, err)
    assert lse_err <= TOL["float32"] * 10 / 2, (dtype, lse_err)


def test_b5_forward_one_tf32_product_misses_the_tolerance():
    """At head width 128, one TF32 product for Q.K^T and one for P.V
    misses TOL["float32"]."""
    rng = np.random.RandomState(128)
    q, k, v = (randn(rng, 1, 512, 4, 128).transpose(1, 2)
               for _ in range(3))
    po, _ = ck.flash_mha_plain(q, k, v, causal=True)
    o, _ = b5_forward(q, k, v, True, mm_tf32)
    assert (o - po).abs().max().item() > TOL["float32"]


def _b5_bwd_case(shape, dtype):
    """Seeded BTHD inputs as (B, H, T, D) views, o and lse from the plain
    forward, and the plain backward."""
    B, H, Tq, Tk, D = shape
    rng = np.random.RandomState(Tq + Tk + D)
    dt = getattr(torch, dtype)
    q, k, v, do = (randn(rng, B, T, H, D).to(dt).transpose(1, 2)
                   for T in (Tq, Tk, Tk, Tq))
    o, lse = ck.flash_mha_plain(q, k, v, causal=True)
    ref = ck.flash_mha_bwd_plain(q, k, v, o, lse, do, causal=True)
    return (q, k, v, o, lse, do), ref


def _b5_over_tol(got, ref, dtype):
    """dq, dk and dv's max errors over chip_smoke.check_mha's tolerance:
    the dq kernel's from dq's peak, the dk/dv kernel's from the larger
    peak of the two."""
    tq = _bwd_tol(ref[0], dtype)
    tkv = max(_bwd_tol(ref[1], dtype), _bwd_tol(ref[2], dtype))
    return [(a.float() - r.float()).abs().max().item() / t
            for a, r, t in zip(got, ref, (tq, tkv, tkv))]


B5_BWD_SHAPES = [(1, 4, 512, 512, 128), (1, 12, 256, 1024, 64)]


@pytest.mark.parametrize("shape", B5_BWD_SHAPES)
def test_b5_backward_split_tf32_within_half_the_tolerance(shape):
    """fp32: B5's five products in split TF32, causal, at head width 128
    and at Tq != Tk (256 queries over 1024 keys), on BTHD views, land
    within half of BWD_TOL on dq, dk and dv."""
    args, ref = _b5_bwd_case(shape, "float32")
    ratios = _b5_over_tol(b5_backward(*args, True, mm_split), ref,
                          "float32")
    assert max(ratios) <= 0.5, ratios


def test_b5_backward_one_tf32_product_misses_the_tolerance():
    """One TF32 product for each of the five: some gradient misses
    BWD_TOL, which is why the fp32 path splits."""
    args, ref = _b5_bwd_case(B5_BWD_SHAPES[0], "float32")
    ratios = _b5_over_tol(b5_backward(*args, True, mm_tf32), ref,
                          "float32")
    assert max(ratios) > 1.0, ratios


@pytest.mark.parametrize("shape", B5_BWD_SHAPES)
def test_b5_backward_bf16_rounding_within_the_tolerance(shape):
    """bf16: every product on bf16 tensor cores, P rounded to do's dtype
    before P^T.dO and dS to k's before dS.K and dS^T.Q, within the
    chip's bf16 BWD_TOL of the plain version."""
    args, ref = _b5_bwd_case(shape, "bfloat16")
    ratios = _b5_over_tol(b5_backward(*args, True, None), ref, "bfloat16")
    assert max(ratios) <= 1.0, ratios


def test_b5_bf16_backward_against_the_jax_reference(monkeypatch):
    """The JAX package's bf16 ``flash_mha`` backward (``jax.vjp`` through
    its Pallas kernels in interpret mode, which round P and dS to bf16
    before their products) against the port's plain bf16 backward and
    against the kernels' rounding (``b5_backward``), both on the port's
    plain forward, causal, (BH, T, D) = (2, 256, 64): each within the
    chip's bf16 BWD_TOL."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    BH, T, D = 2, 256, 64
    rng = np.random.RandomState(13)
    q, k, v, do = (randn(rng, BH, T, D).to(torch.bfloat16)
                   for _ in range(4))
    as_jax = (lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    _, vjp = jax.vjp(lambda a, b, c: pk.flash_mha(
        a, b, c, causal=True, block_size=128), *map(as_jax, (q, k, v)))
    ref = [torch.from_numpy(np.array(g.astype(jnp.float32)))
           for g in vjp(as_jax(do))]
    o, lse = ck.flash_mha_plain(q, k, v, causal=True)
    plain = ck.flash_mha_bwd_plain(q, k, v, o, lse, do, causal=True)
    kernel = [g[:, 0] for g in b5_backward(
        *(x[:, None] for x in (q, k, v, o, lse, do)), True, None)]
    for got in (plain, kernel):
        ratios = _b5_over_tol(got, ref, "bfloat16")
        assert max(ratios) <= 1.0, ratios
