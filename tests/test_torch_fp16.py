"""fp16 in the port's attention kernels, its LM and its serving engine,
against the JAX package on the CPU.

The CUDA kernels take float16 beside float32 and bfloat16 (dtype code
2); on the CPU each wrapper runs its plain version, which computes in
float32 from the fp16 inputs and rounds the output to fp16.  Here every
plain version of rows 1-9 of PERF.md's table runs on fp16 inputs against
the JAX package's function on the same fp16 values: B1, B5, B8 and B9
forward and backward against the Pallas kernels in interpret mode
(``MXNET_PALLAS=1``; the backward through ``jax.vjp``), the paged decode
(fp16 and fp32 queries over fp16 pages), the quantized decode and the
quantized verify (fp16 queries over int8 and fp8 codes) against the lax
paths and the Pallas decode.  Then one SGD step of
``transformer_lm(..., dtype="float16")`` through both packages'
``Module``, and the greedy chains of ``DecodeEngine(dtype="float16")``
against the JAX engine's.

Tolerances are in fp16's unit roundoff U = 2^-11 (11 significand bits)
of the largest reference value: the TPU kernels round P (and dS in the
backward) to fp16 before their products where the plain versions keep
fp32, which moves an output by a few U; ``chip_smoke.TOL`` and
``BWD_TOL`` (bf16's scaled by 2^-3) hold on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer_lm as jax_transformer_lm
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.attention import (paged_decode_attention_q,
                                     paged_verify_attention_q,
                                     quantize_kv as jax_quantize_kv)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (TOL, BWD_TOL)

torch.set_num_threads(1)

U = 2.0 ** -11
F16 = torch.float16
# an output of the attention kernels: P rounded to fp16 on one side, a
# few roundings of o's terms; the backward chains more (dS too)
FWD_UNITS, BWD_UNITS = 8, 16
KVB = 4


def _h(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(F16)


def _jx(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.float16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, units, what):
    """|got - want| within ``units`` U of the largest reference value."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    tol = units * U * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {units} U max|ref| = {tol}"


def test_dtype_codes_take_float16():
    assert ck._DTYPE_CODE[torch.float16] == 2
    assert chip_smoke.TOL["float16"] == chip_smoke.TOL["bfloat16"] / 8
    assert chip_smoke.BWD_TOL["float16"] == chip_smoke.BWD_TOL["bfloat16"] / 8


# ---------------------------------------------------------------------------
# rows 1 and 3: B1 forward and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_b1_fp16_against_the_pallas_kernels(monkeypatch, causal):
    """B1's plain forward and backward in fp16 against the JAX package's
    ``flash_mha_packed`` (its Pallas kernels in interpret mode; the
    backward through ``jax.vjp``) on the same fp16 qkv: o within
    ``FWD_UNITS`` U, dqkv within ``BWD_UNITS`` U of the largest JAX
    value; outputs fp16."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    rng = np.random.RandomState(40 + causal)
    B, T, H, D = 1, 80, 2, 32
    qkv, do = _h(rng, B, T, 3 * H * D), _h(rng, B, T, H * D)
    o, lse = ck.flash_mha_packed(qkv, H, causal=causal)
    assert o.dtype == F16 and lse.dtype == torch.float32
    ref, vjp = jax.vjp(lambda x: pk.flash_mha_packed(
        x, H, causal=causal, block_size=128), _jx(qkv))
    _close(o, _np(ref), FWD_UNITS, "B1 forward")
    (dref,) = vjp(_jx(do))
    got = ck.flash_mha_packed_bwd(qkv, o, lse, do, H, causal=causal)
    assert got.dtype == F16
    _close(got, _np(dref), BWD_UNITS, "B1 backward")


# ---------------------------------------------------------------------------
# rows 6 and 7: B5 forward and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 64, 64, 32, True),
                                   (1, 2, 48, 96, 16, False)])
def test_b5_fp16_against_the_pallas_kernels(monkeypatch, shape):
    """B5's plain forward and backward in fp16 on (B * H, T, D) tensors
    (the JAX kernel's layout) against the JAX ``flash_mha`` (Pallas,
    interpret) and its ``jax.vjp``: o within ``FWD_UNITS`` U, dq, dk and
    dv within ``BWD_UNITS`` U."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    B, H, Tq, Tk, D, causal = shape
    rng = np.random.RandomState(Tq + Tk)
    q, k, v = (_h(rng, B * H, T, D) for T in (Tq, Tk, Tk))
    do = _h(rng, B * H, Tq, D)
    o, lse = ck.flash_mha(q, k, v, causal)
    assert o.dtype == F16
    ref, vjp = jax.vjp(lambda a, b, c: pk.flash_mha(
        a, b, c, causal=causal, block_size=128), _jx(q), _jx(k), _jx(v))
    _close(o, _np(ref), FWD_UNITS, "B5 forward")
    grads = ck.flash_mha_bwd(q, k, v, o, lse, do, causal)
    for name, got, want in zip("qkv", grads, vjp(_jx(do))):
        assert got.dtype == F16
        _close(got, _np(want), BWD_UNITS, f"B5 d{name}")


# ---------------------------------------------------------------------------
# rows 8 and 9: B8 and B9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("koff", [-64, 0, 24])
def test_b8_b9_fp16_against_the_pallas_kernels(monkeypatch, koff):
    """B8's plain partial state and B9's plain backward in fp16 at a ring
    hop's key offset against the JAX ``flash_attention_partial`` and
    ``flash_attention_bwd`` (Pallas, interpret): o / l within
    ``FWD_UNITS`` U, m to 1e-4 with the same -inf rows, l to 1e-5
    relative; dq, dk, dv within ``BWD_UNITS`` U."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    rng = np.random.RandomState(100 + koff)
    B, T, H, D = 1, 64, 2, 32
    q, k, v = (_h(rng, B, T, H, D) for _ in range(3))
    o, m, l = ck.flash_attention_partial(q, k, v, True, 512, koff)
    jo, jm, jl = (_np(x) for x in pk.flash_attention_partial(
        _jx(q), _jx(k), _jx(v), True, 512, koff))
    m_, jm_ = m.numpy(), jm
    np.testing.assert_array_equal(np.isinf(m_), np.isinf(jm_))
    seen = ~np.isinf(jm_)
    assert np.abs(m_[seen] - jm_[seen]).max() <= 1e-4
    assert (np.abs(l.numpy()[seen] - jl[seen]) / jl[seen]).max() <= 1e-5
    norm = o.numpy() / np.maximum(l.numpy(), 1e-30)[..., None]
    jnorm = jo / np.maximum(jl, 1e-30)[..., None]
    _close(norm, jnorm, FWD_UNITS, "B8 o / l")
    ob = torch.from_numpy(rng.standard_normal((B, H, T, D))
                          .astype(np.float32))
    lb = torch.from_numpy(rng.standard_normal((B, H, T)).astype(np.float32))
    got = ck.flash_attention_bwd(q, k, v, m, ob, lb, True, 512, koff)
    want = pk.flash_attention_bwd(_jx(q), _jx(k), _jx(v), jnp.asarray(jm),
                                  jnp.asarray(ob.numpy()),
                                  jnp.asarray(lb.numpy()), True, 512, koff)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == F16
        _close(g, _np(w), BWD_UNITS, f"B9 d{name}")


# ---------------------------------------------------------------------------
# rows 2, 4, 5 and 5q: the paged kernels
# ---------------------------------------------------------------------------

def _paged(rng, B=4, H=2, D=16, P=12, MB=3):
    table = np.array([[5, 2, 9], [1, 7, 3], [0, 0, 0], [8, 4, 11]],
                     np.int32)[:B]
    lengths = np.array([9, 5, 0, 12], np.int32)[:B]
    raw = [rng.standard_normal((P, KVB, H, D)).astype(np.float32)
           for _ in range(2)]
    return table, lengths, raw


@pytest.mark.parametrize("qdtype", ["float16", "float32"])
def test_paged_decode_over_fp16_pages_against_pallas(monkeypatch, qdtype):
    """The plain decode over fp16 pages (fp16 queries, and an fp32 model's
    queries) against the JAX Pallas ``paged_attention_decode`` on the same
    values: within ``FWD_UNITS`` U, the empty stream exactly zero, the
    output in q's dtype."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    rng = np.random.RandomState(7)
    table, lengths, (kp, vp) = _paged(rng)
    q = torch.from_numpy(rng.standard_normal((4, 2, 16)).astype(np.float32)
                         ).to(getattr(torch, qdtype))
    k16, v16 = (torch.from_numpy(x).to(F16) for x in (kp, vp))
    out = ck.paged_attention_decode(q, k16, v16, torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    assert out.dtype == q.dtype
    jq = _jx(q) if qdtype == "float16" else jnp.asarray(q.numpy())
    ref = _np(pk.paged_attention_decode(
        jq, _jx(k16), _jx(v16), jnp.asarray(table), jnp.asarray(lengths)))
    _close(out, ref, FWD_UNITS, f"decode {qdtype}/fp16")
    assert not out[2].float().abs().max()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_paged_quant_fp16_queries_against_jax(monkeypatch, kv):
    """fp16 queries over int8 / fp8 codes: the plain quantized decode
    against the JAX Pallas ``paged_attention_decode_quant`` and the lax
    ``paged_decode_attention_q``, and the plain quantized verify against
    the lax ``paged_verify_attention_q``, on the JAX package's codes and
    scales: within ``FWD_UNITS`` U; every verify row equals the plain
    quantized decode at start + 1 + w."""
    rng = np.random.RandomState(8)
    table, lengths, (kp, vp) = _paged(rng)
    qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv]
    codes = [jax_quantize_kv(jnp.asarray(x), qdt) for x in (kp, vp)]
    (jk, jks), (jv, jvs) = codes
    tdt = getattr(torch, chip_smoke.KV_TORCH[kv])
    kc, vc = (torch.from_numpy(np.asarray(c).view(np.int8 if kv == "int8"
                                                 else np.uint8)).view(tdt)
              for c, _ in codes)
    ks, vs = (torch.from_numpy(np.asarray(s)) for _, s in codes)
    q = _h(rng, 4, 2, 16)
    t_table, t_len = torch.from_numpy(table), torch.from_numpy(lengths)
    out = ck.paged_attention_decode_quant(q, kc, vc, ks, vs, t_table, t_len)
    assert out.dtype == F16
    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = _np(pk.paged_attention_decode_quant(
        _jx(q), jk, jv, jks, jvs, jnp.asarray(table), jnp.asarray(lengths)))
    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = _np(paged_decode_attention_q(
        _jx(q)[:, None], jk, jv, jks, jvs, jnp.asarray(table),
        jnp.asarray(lengths)))[:, 0]
    for ref, what in ((pallas, "Pallas"), (lax, "lax")):
        _close(out, ref, FWD_UNITS, f"{kv} decode against {what}")
    W = 3
    start = np.array([6, 2, 0, 9], np.int32)
    qw = _h(rng, 4, W, 2, 16)
    ver = ck.paged_attention_verify(qw, kc, vc, t_table,
                                    torch.from_numpy(start), ks, vs)
    assert ver.dtype == F16
    ref = _np(paged_verify_attention_q(
        _jx(qw), jk, jv, jks, jvs, jnp.asarray(table), jnp.asarray(start)))
    live = np.array([True, True, False, True])  # row 2: a padded slot
    _close(ver.float().numpy()[live], ref[live], FWD_UNITS,
           f"{kv} verify against lax")
    for w in range(W):
        dec = ck.paged_attention_decode_quant(
            qw[:, w], kc, vc, ks, vs, t_table,
            torch.from_numpy(start + 1 + w))
        assert torch.equal(ver[:, w], dec)


def test_paged_verify_over_fp16_pages_against_pallas(monkeypatch):
    """The plain raw verify over fp16 pages under fp16 queries against the
    JAX Pallas ``paged_attention_verify``: within ``FWD_UNITS`` U; each
    row equals the plain decode at start + 1 + w."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    rng = np.random.RandomState(9)
    table, _, (kp, vp) = _paged(rng)
    k16, v16 = (torch.from_numpy(x).to(F16) for x in (kp, vp))
    W = 3
    start = np.array([6, 2, 0, 9], np.int32)
    q = _h(rng, 4, W, 2, 16)
    t_table, t_start = torch.from_numpy(table), torch.from_numpy(start)
    out = ck.paged_attention_verify(q, k16, v16, t_table, t_start)
    ref = _np(pk.paged_attention_verify(_jx(q), _jx(k16), _jx(v16),
                                        jnp.asarray(table),
                                        jnp.asarray(start)))
    live = np.array([True, True, False, True])
    _close(out.float().numpy()[live], ref[live], FWD_UNITS,
           "fp16 verify against Pallas")
    for w in range(W):
        dec = ck.paged_attention_decode(q[:, w], k16, v16, t_table,
                                        t_start + 1 + w)
        assert torch.equal(out[:, w], dec)


def test_paged_writes_keep_fp16_pools():
    """The serving path's pool writes store fp16 K/V as it comes (an fp16
    model) and round an fp32 model's K/V to fp16 once."""
    rng = np.random.RandomState(10)
    pools = [torch.zeros((6, KVB, 2, 8), dtype=F16) for _ in range(2)]
    table = torch.tensor([[2, 4]], dtype=torch.int32)
    k32 = torch.from_numpy(rng.standard_normal((1, 6, 2, 8))
                           .astype(np.float32))
    tatt.paged_prefill_write(k32, k32 * 2, *pools, table,
                             torch.tensor([6], dtype=torch.int32))
    got = torch.cat([pools[0][2], pools[0][4][:2]])
    assert pools[0].dtype == F16
    assert torch.equal(got, k32[0].to(F16))


# ---------------------------------------------------------------------------
# the fp16 LM: one Module step against the JAX Module
# ---------------------------------------------------------------------------

V, T, B = 61, 16, 4
# the gradient chain of the fp16 LM through two blocks: as bf16's
# (tests/test_torch_bf16.py), a gradient may drift by 16 U of its
# largest value
GRAD_ROUNDINGS = 16


def _lm_batch(pkg, ctx, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(0, V, (B, T)).astype(np.float32)
    return pkg.io.DataBatch([pkg.nd.array(X, ctx=ctx)],
                            [pkg.nd.array(Y, ctx=ctx)])


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -14))) - 10)


def test_fp16_lm_sgd_step_as_jax(monkeypatch):
    """One SGD step (lr 0.5, momentum 0.9) of ``transformer_lm(...,
    dtype="float16")`` through both packages' fused step from the JAX
    module's parameters: the parameter dtypes agree (``tok_embed_weight``
    float32, the rest fp16), the per-token loss within 2 U of the
    largest, each new weight within one fp16 ulp of the JAX weight plus
    lr times ``GRAD_ROUNDINGS`` U of the largest gradient, and every
    weight moved."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    kw = dict(num_layers=2, num_heads=2, d_model=32, head="ce",
              dtype="float16")
    js, ts = jax_transformer_lm(V, T, **kw), mt.models.transformer_lm(
        V, T, **kw)
    lr = 0.5
    opt = {"learning_rate": lr, "momentum": 0.9}
    jm = mx.mod.Module(js, context=mx.cpu())
    jm.bind(data_shapes=[mx.io.DataDesc("data", (B, T))],
            label_shapes=[mx.io.DataDesc("softmax_label", (B, T))])
    mx.random.seed(0)
    jm.init_params(mx.initializer.Xavier())
    start = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}
    jm.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tm = mt.mod.Module(ts, context=mt.cpu())
    tm.bind(data_shapes=[mt.io.DataDesc("data", (B, T))],
            label_shapes=[mt.io.DataDesc("softmax_label", (B, T))])
    tm.init_params(arg_params=start)
    tm.init_optimizer(optimizer="sgd", optimizer_params=opt)
    for m, pkg, ctx in ((jm, mx, mx.cpu()), (tm, mt, mt.cpu())):
        m.forward_backward(_lm_batch(pkg, ctx))
        m.update()
    jo = np.asarray(jm.get_outputs()[0].asnumpy(), np.float32)
    _close(tm.get_outputs()[0]._data.float().numpy(), jo, 2,
           "per-token loss")
    jp, tp = jm.get_params()[0], tm.get_params()[0]
    moved = 0
    for n, a in jp.items():
        assert mt.ndarray.dtype_name(tp[n]._data.dtype) == str(a.dtype), n
        want = np.asarray(a.asnumpy(), np.float32)
        got = tp[n]._data.float().numpy()
        g_bound = np.abs(want - start[n].astype(np.float32)).max() / lr
        tol = _ulp(want) + lr * GRAD_ROUNDINGS * U * g_bound
        assert np.all(np.abs(got - want) <= tol), n
        moved += int(np.any(got != start[n].astype(np.float32)))
    assert moved == len(jp)
    assert str(jp["tok_embed_weight"].dtype) == "float32"
    assert str(jp["layer0_qkv_weight"].dtype) == "float16"


# ---------------------------------------------------------------------------
# DecodeEngine(dtype="float16") against the JAX engine
# ---------------------------------------------------------------------------

# the logits of the fp16 LM: the port runs fp16 activations, the JAX
# engine fp16 weights against float32 activations (as for bf16,
# tests/test_torch_bf16.py): a few U of the row's largest logit apart
LOGIT_ROUNDINGS = 8


def _fp16_lm(fp16_weights):
    import torch_serving_parity as sp

    host, _ = sp.make_lm(0)
    if fp16_weights:
        host = {k: (v if k == "tok_embed_weight" else v.astype(np.float16))
                for k, v in host.items()}
    return sp, host


@pytest.mark.parametrize("mode", [
    (False, dict(dtype="float16")),
    (True, dict(dtype="float16")),
    (True, dict(dtype="float16", spec_tokens=4)),
], ids=["fp32_model_fp16_pages", "fp16_lm", "fp16_lm_spec"])
def test_fp16_engine_greedy_chains_as_jax(mode):
    """``DecodeEngine(dtype="float16")`` (fp16 pages) serving the fp32 LM
    and the fp16 LM (plain, and with ``spec_tokens=4``) against the JAX
    engine: the port keeps the parameters' dtypes and its pools are fp16;
    the greedy chains are equal up to each chain's first position whose
    JAX full-forward top-2 margin is within ``LOGIT_ROUNDINGS`` U of the
    row's largest logit, and at least half of all tokens are compared."""
    fp16_weights, kw = mode
    sp, host = _fp16_lm(fp16_weights)
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(1, V, n).astype(np.int32), 10)
            for n in (3, 6, 9, 12)]
    ref, _ = sp.serve(mx.DecodeEngine, host, jobs, prefix_cache=0,
                      ctx=mx.cpu(), **kw)
    with mt.DecodeEngine(host, **sp.engine_kw(ctx=mt.cpu(), **kw)) as eng:
        params = dict(eng._model.named_parameters())
        want = F16 if fp16_weights else torch.float32
        assert {p.dtype for n, p in params.items()
                if n != "tok_embed_weight"} == {want}
        assert {p.dtype for p in eng._pools} == {F16}
        outs = [np.asarray(f.result(timeout=300))
                for f in [eng.submit(p, k) for p, k in jobs]]
    compared = 0
    for (prompt, _), r, got in zip(jobs, ref, outs):
        rows = sp.jax_full_rows(host, prompt, r)
        for i in range(len(r)):
            top2 = np.sort(rows[i])[-2:]
            if top2[1] - top2[0] <= LOGIT_ROUNDINGS * U * np.abs(
                    rows[i]).max():
                break
            assert got[i] == r[i], (mode, prompt, i, r, got)
            compared += 1
    assert compared * 2 >= sum(len(r) for r in ref), compared
