"""The port's quantized KV pages (int8 / fp8-e4m3 codes with one float32
scale per slot and head) against the JAX package.

* ``quantize_kv`` codes and scales equal JAX's bit for bit on the same
  inputs, and the quantize-on-write scatters leave the same pool bytes.
* The plain version of ``paged_attention_decode_quant`` (B3) matches the
  Pallas kernel in interpret mode and the lax path at rtol=atol=1e-5
  (both dequantize the same bytes; the sums run in other orders).
* ``TransformerLM.prefill``/``decode`` over quantized pools match
  ``transformer_lm_prefill``/``_decode(kv_dtype=...)``.
* The int8/fp8 engines match the JAX engine's greedy chains wherever the
  JAX quantized chain's top-2 logit margin exceeds ``QMARGIN`` = 1e-2
  (``torch_serving_parity.py`` says why).  With identical codes the
  logits agree to ~1e-6, which the op- and model-level tests hold at
  1e-5.
"""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kv_cache import pool_device_bytes as jax_pool_bytes
from mxnet_tpu.models.transformer import (transformer_lm_decode,
                                          transformer_lm_prefill)
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kv_cache
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from torch_serving_parity import (D, DM, EDGE_D, EDGE_LENGTHS, EDGE_W, H,
                                  KVB, L, TOL, V, assert_chains_agree,
                                  edge_tables, edge_verify_starts, engine_kw,
                                  fresh_pools, jax_graph, make_lm,
                                  pool_bytes as _bytes, run_graph, serve)

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

QDTYPES = ("int8", "fp8")
JNP = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _tdt(name):
    return kv_cache.kv_storage_dtype(name)


def _to_torch(a, name):
    """JAX/numpy codes → a torch tensor of the same bytes."""
    raw = np.ascontiguousarray(np.asarray(a)).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(_tdt(name))


@pytest.fixture(scope="module")
def lm():
    return make_lm()


# ---------------------------------------------------------------------------
# quantize / dequantize and the quantized writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", QDTYPES)
def test_quantize_kv_codes_and_scales_equal_jax(name):
    """Codes and scales are bit-equal: both sides compute amax/qmax and
    x/scale in float32, int8 rounds half to even (torch.round and
    jnp.round both do) and clips, fp8 rounds to nearest even.  No code
    is off by one on these inputs."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, H, D) * rng.uniform(0.01, 30, (3, 5, H, 1))) \
        .astype(np.float32)
    x[0, 0, 0] = 0.0                        # all-zero row: scale 1
    x[1, 1, 1, :3] = [127.0, 2.5, -3.5]     # int8 ties at +-x.5
    x[1, 1, 1, 3:] = 0.0
    qt, st = tatt.quantize_kv(torch.from_numpy(x), _tdt(name))
    qj, sj = jatt.quantize_kv(jnp.asarray(x), JNP[name])
    assert qt.dtype == _tdt(name) and st.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0, 0, 0].item() == 1.0
    if name == "int8":
        assert qt[1, 1, 1, :3].tolist() == [127, 2, -4]  # half to even
    back = tatt.dequantize_kv(qt, st).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jatt.dequantize_kv(qj, sj)))
    qmax = kv_cache.KV_QMAX[name]
    assert np.all(np.abs(back - x) <= np.asarray(sj)[..., None]
                  * (0.5 if name == "int8" else qmax / 16) + 1e-6)


def test_fp8_encoding_matches_ml_dtypes():
    vals = np.array([0.1, 1.3, 447.9, -3.2, 448.0, 2 ** -9], np.float32)
    t = torch.from_numpy(vals).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(
        t.view(torch.uint8).numpy(),
        vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


@pytest.mark.parametrize("name", QDTYPES)
def test_quantized_writes_leave_jax_pool_bytes(name):
    rng = np.random.RandomState(1)
    P, B, T = 9, 2, 6
    k = rng.randn(B, T, H, D).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32) * 3
    table = np.array([[7, 2, 5], [4, 8, 0]], np.int32)
    lengths = np.array([6, 3], np.int32)
    start = np.array([3, 1], np.int32)
    zeros = np.zeros((P, KVB, H, D), np.float32)
    ones = np.ones((P, KVB, H), np.float32)

    def port_pools():
        return [torch.zeros((P, KVB, H, D), dtype=_tdt(name)),
                torch.zeros((P, KVB, H, D), dtype=_tdt(name)),
                torch.from_numpy(ones.copy()), torch.from_numpy(ones.copy())]

    def jax_pools():
        z = jnp.asarray(zeros).astype(JNP[name])
        return [z, z, jnp.asarray(ones), jnp.asarray(ones)]

    # a prompt from position 0, then a window at offset start
    for st in (None, start):
        tp = port_pools()
        got = tatt.paged_prefill_write_q(
            torch.from_numpy(k), torch.from_numpy(v), *tp,
            torch.from_numpy(table), torch.from_numpy(lengths + (
                0 if st is None else st)),
            start=None if st is None else torch.from_numpy(st))
        assert all(a is b for a, b in zip(got, tp))  # in place
        want = jatt.paged_prefill_write_q(
            jnp.asarray(k), jnp.asarray(v), *jax_pools(), jnp.asarray(table),
            jnp.asarray(lengths + (0 if st is None else st)),
            start=None if st is None else jnp.asarray(st))
        # page 0 takes every padding row: which duplicate lands there is
        # left to each scatter, and no read sees it unmasked
        for a, b in zip(tp, want):
            np.testing.assert_array_equal(_bytes(a)[1:], _bytes(b)[1:])

    # one decode-step token per stream; a padded slot writes to page 0
    tp = port_pools()
    kt, vt = k[:, :1].copy(), v[:, :1].copy()
    tl = np.array([5, 0], np.int32)
    tatt.paged_cache_update_q(*tp, torch.from_numpy(kt), torch.from_numpy(vt),
                              torch.from_numpy(table), torch.from_numpy(tl))
    want = jatt.paged_cache_update_q(*jax_pools(), jnp.asarray(kt),
                                     jnp.asarray(vt), jnp.asarray(table),
                                     jnp.asarray(tl))
    for a, b in zip(tp, want):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


# ---------------------------------------------------------------------------
# B3: the plain quantized decode against Pallas (interpret) and lax
# ---------------------------------------------------------------------------


def _quant_case(name, seed=3):
    rng = np.random.RandomState(seed)
    B, P, MB = 4, 10, 3
    q = rng.randn(B, H, D).astype(np.float32)
    kq, ks = jatt.quantize_kv(jnp.asarray(rng.randn(P, KVB, H, D)
                                          .astype(np.float32)), JNP[name])
    vq, vs = jatt.quantize_kv(jnp.asarray(rng.randn(P, KVB, H, D)
                                          .astype(np.float32) * 2), JNP[name])
    # fragmented tables; row 2 empty (lengths 0); row 3 ends on a page
    # boundary; row 0 ends mid-page
    table = np.array([[5, 2, 9], [1, 7, 3], [0, 0, 0], [8, 4, 0]], np.int32)
    lengths = np.array([9, 5, 0, 8], np.int32)
    return q, (kq, vq, ks, vs), table, lengths


@pytest.mark.parametrize("name", QDTYPES)
def test_decode_quant_plain_vs_pallas_and_lax(monkeypatch, name):
    q, (kq, vq, ks, vs), table, lengths = _quant_case(name)
    out = ck.paged_attention_decode_quant(
        torch.from_numpy(q), _to_torch(kq, name), _to_torch(vq, name),
        torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    args = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(table),
            jnp.asarray(lengths))

    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    pallas = np.asarray(pk.paged_attention_decode_quant(*args))
    np.testing.assert_allclose(out, pallas, **TOL)

    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(jatt.paged_decode_attention_q(
        args[0][:, None], *args[1:]))[:, 0]
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[2], np.zeros_like(out[2]))


# the partition's edge cases of test_torch_spec.py: head widths 32, 48 and
# 128, lengths on page boundaries, shorter than a page and empty; windows
# of 1, 2 and 9 rows
@pytest.mark.parametrize("Dh", EDGE_D)
@pytest.mark.parametrize("name", QDTYPES)
def test_decode_quant_plain_vs_pallas_and_lax_at_partition_edges(
        monkeypatch, name, Dh):
    lengths = np.array(EDGE_LENGTHS, np.int32)
    table, P = edge_tables(lengths, 21)
    rng = np.random.RandomState(Dh + 1)
    q = rng.randn(len(lengths), H, Dh).astype(np.float32)
    kq, ks = jatt.quantize_kv(jnp.asarray(
        rng.randn(P, KVB, H, Dh).astype(np.float32)), JNP[name])
    vq, vs = jatt.quantize_kv(jnp.asarray(
        rng.randn(P, KVB, H, Dh).astype(np.float32) * 2), JNP[name])
    out = ck.paged_attention_decode_quant(
        torch.from_numpy(q), _to_torch(kq, name), _to_torch(vq, name),
        torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    args = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(table),
            jnp.asarray(lengths))
    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = np.asarray(pk.paged_attention_decode_quant(*args))
    np.testing.assert_allclose(out, pallas, **TOL)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(jatt.paged_decode_attention_q(
        args[0][:, None], *args[1:]))[:, 0]
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[0], np.zeros_like(out[0]))  # empty


@pytest.mark.parametrize("Dh", EDGE_D)
@pytest.mark.parametrize("W", EDGE_W)
@pytest.mark.parametrize("name", QDTYPES)
def test_quant_verify_plain_vs_lax_at_partition_edges(name, W, Dh):
    start = edge_verify_starts(W)
    lengths = start + W
    lengths[-1] = 0
    table, P = edge_tables(lengths, 22)
    rng = np.random.RandomState(W * 100 + Dh)
    q = rng.randn(len(start), W, H, Dh).astype(np.float32)
    kq, ks = jatt.quantize_kv(jnp.asarray(
        rng.randn(P, KVB, H, Dh).astype(np.float32)), JNP[name])
    vq, vs = jatt.quantize_kv(jnp.asarray(
        rng.randn(P, KVB, H, Dh).astype(np.float32) * 3), JNP[name])
    pools = [_to_torch(kq, name), _to_torch(vq, name),
             torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs))]
    qt, t = torch.from_numpy(q), torch.from_numpy(table)
    out = ck.paged_attention_verify(qt, pools[0], pools[1], t,
                                    torch.from_numpy(start), *pools[2:])
    lax = np.asarray(jatt.paged_verify_attention_q(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(table),
        jnp.asarray(start)))
    np.testing.assert_allclose(out.numpy(), lax, **TOL)
    assert np.all(np.isfinite(out.numpy()))
    for w in range(W):  # every row the quantized decode step, bit for bit
        dec = ck.paged_attention_decode_quant(
            qt[:, w], *pools, t, torch.from_numpy(start + 1 + w))
        assert torch.equal(out[:, w], dec), w


@pytest.mark.parametrize("name", QDTYPES)
def test_decode_quant_reads_scales_by_slot_and_head(name):
    """A scale stride mistake would pass every fp32 check: scaling one
    live (slot, head) row's K and V scales changes only that head's
    output, and garbage past the lengths changes nothing."""
    q, (kq, vq, ks, vs), table, lengths = _quant_case(name, seed=4)
    pools = [_to_torch(kq, name), _to_torch(vq, name),
             torch.from_numpy(np.asarray(ks).copy()),
             torch.from_numpy(np.asarray(vs).copy())]
    t, n = torch.from_numpy(table), torch.from_numpy(lengths)
    ref = ck.paged_attention_decode_quant(torch.from_numpy(q), *pools, t, n)
    pools[3][2, 1, 1] *= 4.0    # row 0's page 2, slot 1, head 1: live
    pools[2][9, 1:, :] = 1e4     # row 0's last page past its length
    pools[3][0] = 1e4            # the scratch page
    got = ck.paged_attention_decode_quant(torch.from_numpy(q), *pools, t, n)
    diff = (got - ref).abs().amax(dim=-1)
    assert diff[0, 1] > 1e-3
    assert diff[0, 0] == 0 and diff[1:].max() == 0


# ---------------------------------------------------------------------------
# TransformerLM over quantized pools against the JAX graphs
# ---------------------------------------------------------------------------


def _assert_pools_close(t_pools, j_pools):
    """Scales at rtol=atol=1e-5; codes equal but for rare neighbours
    (adjacent int8 codes, or adjacent e4m3 bit patterns): the K/V the
    two packages quantize differ by float summation order, and a value
    on a rounding boundary may round either way.  Page 0 is scratch."""
    for tp, jp in zip(t_pools, j_pools):
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       **TOL)
            continue
        a = _bytes(tp)[1:].view(np.int8 if tp.dtype == torch.int8
                                else np.uint8).astype(np.int32)
        b = _bytes(jp)[1:].view(np.int8 if tp.dtype == torch.int8
                                else np.uint8).astype(np.int32)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() <= 0.01, (a != b).sum()


@pytest.mark.parametrize("name", QDTYPES)
def test_transformer_prefill_decode_quant_match_jax_graphs(lm, name):
    host, port = lm
    pre = jax_graph(transformer_lm_prefill, host, name, paged=True)
    dec = jax_graph(transformer_lm_decode, host, name, paged=True)
    rng = np.random.RandomState(1)
    P = 12
    t_pools, j_pools = fresh_pools(name, P)
    seq = rng.randint(1, V, size=13).astype(np.int32)
    p0 = 6
    table = np.array([[7, 2, 11, 5]], np.int32)
    tokens = np.pad(seq[:p0], (0, 2))[None]
    feeds = dict(data=tokens, positions=np.arange(8, dtype=np.int32)[None],
                 lengths=np.array([p0], np.int32), block_table=table[:, :2])
    j_logits, j_pools = run_graph(pre, feeds, j_pools)
    t_logits = port.prefill(*(torch.from_numpy(feeds[k]) for k in
                              ("data", "positions", "lengths",
                               "block_table")), t_pools)
    # prefill attends raw K/V: its logits do not see the quantization
    np.testing.assert_allclose(t_logits.numpy()[0, :p0], j_logits[0, :p0],
                               **TOL)
    _assert_pools_close(t_pools, j_pools)
    for t in range(p0, len(seq)):
        feeds = dict(data=seq[None, t:t + 1],
                     positions=np.array([[t]], np.int32),
                     lengths=np.array([t + 1], np.int32), block_table=table)
        j_logits, j_pools = run_graph(dec, feeds, j_pools)
        t_logits = port.decode(*(torch.from_numpy(feeds[k]) for k in
                                 ("data", "positions", "lengths",
                                  "block_table")), t_pools)
        np.testing.assert_allclose(t_logits.numpy()[0, 0], j_logits[0, 0],
                                   err_msg=f"decode step t={t}", **TOL)
        _assert_pools_close(t_pools, j_pools)


def test_pool_stride_is_checked(lm):
    _, port = lm
    pools = [torch.zeros((4, KVB, H, D), dtype=torch.int8)
             for _ in range(2 * L)]
    with pytest.raises(mt.MXNetError, match=r"\[k_0, v_0, ks_0, vs_0"):
        port.decode(torch.zeros((1, 1), dtype=torch.int32),
                    torch.zeros((1, 1), dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32),
                    torch.ones((1, 1), dtype=torch.int32), pools)


# ---------------------------------------------------------------------------
# the quantized engines against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", QDTYPES)
def test_quantized_engine_matches_jax_engine(lm, name):
    host, _ = lm
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(1, V, size=n).astype(np.int32), m)
            for n, m in ((5, 10), (9, 7), (3, 12))]
    j_outs, _ = serve(mx.DecodeEngine, host, jobs, prefix_cache=0,
                       kv_dtype=name)
    t_outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                        kv_dtype=name)
    assert_chains_agree(host, jobs, j_outs, t_outs, name)
    assert st["kv_dtype"] == name and st["generations"] == 3


@pytest.mark.parametrize("name", QDTYPES)
def test_quantized_pools_layout_and_bytes(lm, name, monkeypatch):
    host, _ = lm
    monkeypatch.setenv("MXNET_SERVING_KV_DTYPE", name)
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), cache_blocks=9)) as eng:
        pools = eng._pools
        assert len(pools) == 4 * L
        assert pools[0].dtype == _tdt(name) and pools[1].dtype == _tdt(name)
        assert pools[2].shape == (9, KVB, H) and torch.all(pools[2] == 1)
        st = eng.stats()
        out = eng.generate(np.array([3, 17, 42], np.int32), 5)
    assert out.shape == (5,) and np.all((out >= 0) & (out < V))
    want = jax_pool_bytes(9, KVB, L, H, DM, kv_dtype=name)
    assert st["pool_bytes"] == want == kv_cache.pool_device_bytes(
        9, KVB, L, H, DM, kv_dtype=name)
    # (D + 4) bytes a slot-head against 4 * D in fp32
    assert kv_cache.pool_device_bytes(9, KVB, L, H, DM) \
        == want * 4 * D // (D + 4)


def test_quantized_engine_under_preemption_requantizes(lm):
    """A preempted int8 stream re-prefills prompt + progress and
    re-quantizes it; every chain still comes out whole and the pool is
    empty at the end."""
    host, _ = lm
    jobs = [(np.arange(1, 6, dtype=np.int32), 14),
            (np.arange(7, 12, dtype=np.int32), 14),
            (np.arange(13, 18, dtype=np.int32), 14)]
    outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                      kv_dtype="int8", max_streams=3, cache_blocks=10)
    assert st["preempted"] > 0 and st["cache_util"] == 0.0
    assert st["prefills"] == 3 + st["preempted"]
    for o in outs:
        assert o.shape == (14,) and np.all((o >= 0) & (o < V))
