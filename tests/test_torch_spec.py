"""The port's speculative decoding against the JAX package.

* ``NgramProposer`` and ``trim_blocks`` give JAX's outputs.
* The plain version of ``paged_attention_verify`` (B4) matches the Pallas
  kernel in interpret mode and the lax ``paged_verify_attention`` at
  rtol=atol=1e-5; over int8/fp8 pools it matches the lax
  ``paged_verify_attention_q``.  Row w of the plain verify equals the
  plain decode at ``start + 1 + w`` bit for bit.
* ``TransformerLM.verify`` matches ``transformer_lm_verify`` (fp32, int8,
  fp8 pools).
* ``verify_sample``: greedy rows emit argmax, rows with no draft equal
  ``serving.sample_tokens`` bit for bit, the accept/resample marginal is
  the target distribution (chi-square), and a padded window column is
  never taken for a draft.
* The engine with ``spec_tokens`` (fp32 and int8 pages) matches the JAX
  engine's greedy chains (margins in ``torch_serving_parity.py``),
  including under preemption and with eos mid-window.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kv_cache import trim_blocks as jax_trim_blocks
from mxnet_tpu.models.transformer import transformer_lm_verify
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import invoke
from mxnet_tpu.speculative import NgramProposer as JaxNgram
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kv_cache import kv_storage_dtype, trim_blocks
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serving import sample_tokens
from mxnet_tpu_torch.speculative import (NgramProposer, make_proposer,
                                         verify_sample)
from torch_serving_parity import (D, EDGE_D, EDGE_LENGTHS, EDGE_W, H, KVB,
                                  L, TOL, V, OracleProposer,
                                  assert_chains_agree, edge_tables,
                                  edge_verify_starts, engine_kw,
                                  fresh_pools, jax_graph, make_lm,
                                  pool_bytes, repetitive_prompt, run_graph,
                                  serve)

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

JNP = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# proposer and page rollback
# ---------------------------------------------------------------------------


def test_ngram_proposer_matches_jax(monkeypatch):
    p, j = NgramProposer(), JaxNgram()
    ctx = np.array([1, 2, 3, 4, 1, 2, 3], np.int32)
    np.testing.assert_array_equal(p.propose(ctx, 4), [4, 1, 2, 3])
    np.testing.assert_array_equal(p.propose(ctx, 2), [4, 1])
    ctx2 = np.array([5, 9, 1, 5, 7, 2, 5], np.int32)  # most recent wins
    np.testing.assert_array_equal(p.propose(ctx2, 2), [7, 2])
    assert p.propose(np.arange(1, 9, dtype=np.int32), 4).size == 0
    rng = np.random.RandomState(0)
    for _ in range(200):
        n = rng.randint(1, 40)
        c = rng.randint(0, rng.randint(2, 9), size=n).astype(np.int32)
        for k in (0, 1, 3):
            np.testing.assert_array_equal(p.propose(c, k), j.propose(c, k))
    for mx_, mn in ((2, 2), (4, 1)):
        a, b = NgramProposer(mx_, mn), JaxNgram(mx_, mn)
        c = np.tile(rng.randint(0, 5, size=7), 3).astype(np.int32)
        np.testing.assert_array_equal(a.propose(c, 5), b.propose(c, 5))
    with pytest.raises(mt.MXNetError, match="min_ngram"):
        NgramProposer(1, 2)
    with pytest.raises(mt.MXNetError, match="unknown speculative"):
        make_proposer("banana")
    # the draft-LM proposer is ported: without its checkpoint it raises
    # naming the variable (tests/test_torch_draft_lm.py holds the rest)
    monkeypatch.delenv("MXNET_SERVING_DRAFT_CKPT", raising=False)
    with pytest.raises(mt.MXNetError, match="MXNET_SERVING_DRAFT_CKPT"):
        make_proposer("draft_lm")


def test_trim_blocks_matches_jax():
    for blocks, tokens in (([7, 9, 12], 5), ([7, 9], 8), ([7], 9),
                           ([3, 1, 4, 5], 0), ([], 3), ([2, 6, 8], 12)):
        assert trim_blocks(list(blocks), tokens, 4) \
            == jax_trim_blocks(list(blocks), tokens, 4)


# ---------------------------------------------------------------------------
# B4: the plain verify against Pallas (interpret) and lax
# ---------------------------------------------------------------------------


def _verify_case(seed=5, W=4):
    rng = np.random.RandomState(seed)
    B, P = 3, 9
    kp = rng.randn(P, KVB, H, D).astype(np.float32)
    vp = rng.randn(P, KVB, H, D).astype(np.float32)
    # row 0 ends mid-page, row 1 on a page boundary; row 2 is a padded
    # batch row (start 0, table of scratch pages)
    table = np.array([[2, 5, 1, 7], [4, 3, 0, 0], [0, 0, 0, 0]], np.int32)
    start = np.array([9, 4, 0], np.int32)
    q = rng.randn(B, W, H, D).astype(np.float32)
    return q, kp, vp, table, start


def test_verify_plain_vs_pallas_and_lax(monkeypatch):
    q, kp, vp, table, start = _verify_case()
    out = ck.paged_attention_verify(*(_t(x) for x in (q, kp, vp, table,
                                                       start))).numpy()
    args = [jnp.asarray(x) for x in (q, kp, vp, table, start)]
    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = np.asarray(pk.paged_attention_verify(*args))
    np.testing.assert_allclose(out, pallas, **TOL)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(jatt.paged_verify_attention(*args))
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))


def _quant_pools(name, kp, vp):
    kq, ks = jatt.quantize_kv(jnp.asarray(kp), JNP[name])
    vq, vs = jatt.quantize_kv(jnp.asarray(vp), JNP[name])
    jax_pools = (kq, vq, ks, vs)
    dt = kv_storage_dtype(name)
    port = [torch.from_numpy(pool_bytes(kq).copy()).view(dt),
            torch.from_numpy(pool_bytes(vq).copy()).view(dt), _t(ks), _t(vs)]
    return jax_pools, port


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quant_verify_plain_vs_lax(name):
    q, kp, vp, table, start = _verify_case(seed=6)
    (kq, vq, ks, vs), port = _quant_pools(name, kp, vp * 3)
    out = ck.paged_attention_verify(_t(q), port[0], port[1], _t(table),
                                    _t(start), port[2], port[3]).numpy()
    lax = np.asarray(jatt.paged_verify_attention_q(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(table),
        jnp.asarray(start)))
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("name", ["fp32", "int8", "fp8"])
def test_verify_row_equals_decode_bitwise(name):
    """The port's verify contract on its plain versions: row w is the
    decode step at lengths = start + 1 + w, bit for bit (the card holds
    the kernels to the same, in chip_smoke.py)."""
    q, kp, vp, table, start = _verify_case(seed=7, W=5)
    if name == "fp32":
        pools, scales = [_t(kp), _t(vp)], []
    else:
        _, p4 = _quant_pools(name, kp, vp)
        pools, scales = p4[:2], p4[2:]
    qt = _t(q)
    out = ck.paged_attention_verify(qt, *pools, _t(table), _t(start),
                                    *scales)
    for w in range(q.shape[1]):
        lengths = _t(start + 1 + w)
        if scales:
            dec = ck.paged_attention_decode_quant(qt[:, w], *pools, *scales,
                                                  _t(table), lengths)
        else:
            dec = ck.paged_attention_decode(qt[:, w], *pools, _t(table),
                                            lengths)
        assert torch.equal(out[:, w], dec), w


# ---------------------------------------------------------------------------
# B2 and B4 at the edges of the kernels' work partition, against Pallas
# (interpret) and lax: windows of 1, 2 and 9 rows (9: more than one pass of
# eight rows), head widths 32, 48 (below its bucket) and 128, starts on
# page boundaries, a stream shorter than a page, a padded batch row and
# (decode) an empty stream
# ---------------------------------------------------------------------------

def _edge_verify_case(W, Dh, seed=11):
    start = edge_verify_starts(W)
    lengths = start + W
    lengths[-1] = 0  # the padded row's table: scratch pages
    table, P = edge_tables(lengths, seed)
    rng = np.random.RandomState(seed + W + Dh)
    kp = rng.randn(P, KVB, H, Dh).astype(np.float32)
    vp = rng.randn(P, KVB, H, Dh).astype(np.float32)
    q = rng.randn(len(start), W, H, Dh).astype(np.float32)
    return q, kp, vp, table, start


@pytest.mark.parametrize("Dh", EDGE_D)
@pytest.mark.parametrize("W", EDGE_W)
def test_verify_plain_vs_pallas_and_lax_at_partition_edges(monkeypatch, W,
                                                           Dh):
    q, kp, vp, table, start = _edge_verify_case(W, Dh)
    out = ck.paged_attention_verify(*(_t(x) for x in (q, kp, vp, table,
                                                       start))).numpy()
    args = [jnp.asarray(x) for x in (q, kp, vp, table, start)]
    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = np.asarray(pk.paged_attention_verify(*args))
    np.testing.assert_allclose(out, pallas, **TOL)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(jatt.paged_verify_attention(*args))
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("Dh", EDGE_D)
@pytest.mark.parametrize("W", EDGE_W)
def test_verify_row_equals_decode_bitwise_at_partition_edges(W, Dh):
    q, kp, vp, table, start = _edge_verify_case(W, Dh, seed=13)
    qt, pools = _t(q), [_t(kp), _t(vp)]
    out = ck.paged_attention_verify(qt, *pools, _t(table), _t(start))
    for w in range(W):
        dec = ck.paged_attention_decode(qt[:, w], *pools, _t(table),
                                        _t(start + 1 + w))
        assert torch.equal(out[:, w], dec), w


@pytest.mark.parametrize("Dh", EDGE_D)
def test_decode_plain_vs_pallas_and_lax_at_partition_edges(monkeypatch, Dh):
    lengths = np.array(EDGE_LENGTHS, np.int32)
    table, P = edge_tables(lengths, 12)
    rng = np.random.RandomState(Dh)
    q = rng.randn(len(lengths), H, Dh).astype(np.float32)
    kp = rng.randn(P, KVB, H, Dh).astype(np.float32)
    vp = rng.randn(P, KVB, H, Dh).astype(np.float32)
    out = ck.paged_attention_decode(*(_t(x) for x in (q, kp, vp, table,
                                                       lengths))).numpy()
    args = [jnp.asarray(x) for x in (q, kp, vp, table, lengths)]
    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = np.asarray(pk.paged_attention_decode(*args))
    np.testing.assert_allclose(out, pallas, **TOL)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(jatt.paged_decode_attention(args[0][:, None],
                                                 *args[1:]))[:, 0]
    np.testing.assert_allclose(out, lax, **TOL)
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[0], np.zeros_like(out[0]))  # empty


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_qkv_verify_attend_matches_registry(monkeypatch, name):
    """The window's K/V lands at offset start (padding rows on page 0)
    and the queries read it back through the pools: pools equal the JAX
    op's, outputs at 1e-5.  The JAX op runs under jit, where XLA turns
    the division by the constant qmax into a multiply by its reciprocal,
    so a few scales come out one ulp apart (the eager JAX function is
    bit-equal, test_torch_kvquant.py) and a code next to a rounding
    boundary may land on its neighbour."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    rng = np.random.RandomState(8)
    B, W, P = 3, 4, 10
    qkv = rng.randn(B, W, 3 * H * D).astype(np.float32)
    table = np.array([[3, 6, 9], [1, 4, 0], [0, 0, 0]], np.int32)
    start = np.array([5, 2, 0], np.int32)
    lengths = start + np.array([4, 2, 0], np.int32)  # live rows 4, 2, 0
    if name == "fp32":
        kp = rng.randn(P, KVB, H, D).astype(np.float32)
        vp = rng.randn(P, KVB, H, D).astype(np.float32)
        j_in, t_pools = [jnp.asarray(kp), jnp.asarray(vp)], [_t(kp), _t(vp)]
        op = "QKVPagedVerifyAttend"
    else:
        j_in, t_pools = _quant_pools(name, rng.randn(P, KVB, H, D)
                                     .astype(np.float32),
                                     rng.randn(P, KVB, H, D)
                                     .astype(np.float32))
        j_in = list(j_in)
        op = "QKVPagedVerifyAttendQ"
    outs, _ = invoke(op, [jnp.asarray(qkv), *j_in, jnp.asarray(table),
                          jnp.asarray(start), jnp.asarray(lengths)],
                     {"num_heads": H})
    got = tatt.qkv_paged_verify_attend(_t(qkv), t_pools, _t(table),
                                       _t(start), _t(lengths), H)
    assert got.shape == (B, W, H * D)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(outs[0])[:2],
                               **TOL)
    for tp, jp in zip(t_pools, outs[1:]):
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       rtol=1e-6, atol=0)
        else:
            a = tp.numpy()[1:].astype(np.int32)
            b = np.asarray(jp)[1:].astype(np.int32)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.01


# ---------------------------------------------------------------------------
# TransformerLM.verify against transformer_lm_verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp32", "int8", "fp8"])
def test_transformer_verify_matches_jax_graph(lm, name):
    host, port = lm
    ver = jax_graph(transformer_lm_verify, host, name)
    rng = np.random.RandomState(2)
    P, W = 12, 4
    t_pools, j_pools = fresh_pools(name, P)
    # stale values in the fp32 pools: masks and padding keep them out
    if name == "fp32":
        for i, tp in enumerate(t_pools):
            tp.copy_(torch.randn(tp.shape, generator=torch.Generator()
                                 .manual_seed(3 + i)))
        j_pools = [jnp.asarray(tp.numpy()) for tp in t_pools]
    feeds = dict(data=rng.randint(1, V, size=(3, W)).astype(np.int32),
                 positions=np.array([[6, 7, 8, 9], [2, 3, 4, 5],
                                     [0, 1, 2, 3]], np.int32),
                 start=np.array([6, 2, 0], np.int32),
                 lengths=np.array([10, 4, 0], np.int32),
                 block_table=np.array([[7, 2, 11], [5, 9, 0], [0, 0, 0]],
                                      np.int32))
    j_logits, j_pools = run_graph(ver, feeds, j_pools)
    t_logits = port.verify(*(_t(feeds[k]) for k in
                             ("data", "positions", "start", "lengths",
                              "block_table")), t_pools)
    assert t_logits.shape == (3, W, V)
    # live rows: 4 of stream 0, 2 of stream 1
    np.testing.assert_allclose(t_logits.numpy()[0], j_logits[0], **TOL)
    np.testing.assert_allclose(t_logits.numpy()[1, :2], j_logits[1, :2],
                               **TOL)
    for tp, jp in zip(t_pools, j_pools):
        a, b = pool_bytes(tp)[1:], pool_bytes(jp)[1:]
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(a.view(np.float32), b.view(np.float32),
                                       **TOL)
        else:  # neighbouring codes at rounding boundaries, rarely
            assert (a != b).mean() <= 0.01


# ---------------------------------------------------------------------------
# the verify sampler
# ---------------------------------------------------------------------------


def test_verify_sample_greedy_and_zero_draft_rows_match_sample_tokens():
    rng = np.random.RandomState(1)
    B, W, Vs = 5, 4, 23
    logits = torch.from_numpy(rng.randn(B, W, Vs).astype(np.float32) * 2)
    fed = rng.randint(0, Vs, size=(B, W)).astype(np.int32)
    wlive = np.array([4, 1, 2, 3, 4], np.int32)
    temps = np.array([0.0, 0.7, 1.3, 0.0, 0.9], np.float32)
    seeds = np.array([3, 9, 4, 1, 7], np.int64)
    steps0 = np.array([10, 4, 6, 2, 0], np.int64)
    out = verify_sample(logits, fed, wlive, temps, seeds, steps0, 5)
    assert out.dtype == torch.int32 and out.shape == (B, W)
    greedy = torch.argmax(logits, dim=-1)
    for b in np.nonzero(temps == 0)[0]:
        assert torch.equal(out[b], greedy[b].to(torch.int32))
    # rows with no draft: the stream's last live row and its pad rows
    for j in range(W):
        plain = sample_tokens(logits[:, j], temps, seeds, steps0 + j, 5)
        for b in range(B):
            if temps[b] > 0 and j + 1 >= wlive[b]:
                assert out[b, j] == plain[b], (b, j)


def test_verify_sample_keeps_the_target_distribution():
    Vs, N, temp, draft = 13, 3000, 0.7, 4
    row = np.random.RandomState(11).randn(Vs).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.tile(row, (N, 2, 1)))
    fed = np.tile(np.array([[0, draft]], np.int32), (N, 1))
    temps = np.full(N, temp, np.float32)
    seeds = np.arange(N, dtype=np.int64)
    steps0 = np.zeros(N, np.int64)
    emit = verify_sample(logits, fed, np.full(N, 2), temps, seeds, steps0,
                         0).numpy()
    p = np.exp(row / temp - np.max(row / temp))
    p /= p.sum()
    # row 0 verified the draft by accept / resample; its marginal is the
    # target distribution (chi-square, df = 12; fixed seeds, so the
    # statistic is deterministic)
    obs = np.bincount(emit[:, 0], minlength=Vs)
    chi2 = float(np.sum((obs - N * p) ** 2 / (N * p)))
    assert chi2 < 32.9, chi2  # p = 0.001 critical value for df = 12
    assert 0 < np.sum(emit[:, 0] == draft) < N
    # acceptance alone: accepted drafts are about p(draft) of all rows
    assert abs(np.mean(emit[:, 0] == draft) - p[draft]) < 0.05
    # row 1 has no draft: the plain sampler's draw at position 1
    plain = sample_tokens(logits[:, 1], temps, seeds, steps0 + 1, 0).numpy()
    np.testing.assert_array_equal(emit[:, 1], plain)

    # a stream whose window is shorter than W: its pad column is not a
    # draft of token 0, so its bonus row is the plain draw and its draft
    # row is what a W = 2 batch gives
    logits3 = torch.from_numpy(np.tile(row, (N, 3, 1)))
    fed3 = np.tile(np.array([[0, draft, 0]], np.int32), (N, 1))
    emit3 = verify_sample(logits3, fed3, np.full(N, 2), temps, seeds,
                          steps0, 0).numpy()
    np.testing.assert_array_equal(emit3[:, 0], emit[:, 0])
    np.testing.assert_array_equal(emit3[:, 1], plain)


# ---------------------------------------------------------------------------
# the engine with speculation
# ---------------------------------------------------------------------------


def _spec_jobs(seed=0):
    rng = np.random.RandomState(seed)
    return [(repetitive_prompt(rng, n=14), 12),
            (repetitive_prompt(rng, n=9, motif=3), 10),
            (rng.randint(1, V, size=6).astype(np.int32), 8)]


def _oracle(host, jobs, wrong_every=3, wrong_at=-1, **over):
    """An OracleProposer over the port's own non-speculative chains."""
    chains, _ = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(), **over)
    return OracleProposer(jobs, chains, wrong_every, wrong_at), chains


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_spec_engine_matches_jax_engine(lm, name):
    """Both engines verify the same drafts (accepted and rejected ones);
    their chains agree with each other and with the plain engine."""
    host, _ = lm
    jobs = _spec_jobs()
    prop, plain = _oracle(host, jobs, kv_dtype=name)
    j_outs, _ = serve(mx.DecodeEngine, host, jobs, prefix_cache=0,
                      spec_tokens=3, kv_dtype=name, proposer=prop)
    t_outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                       spec_tokens=3, kv_dtype=name, proposer=prop)
    assert_chains_agree(host, jobs, j_outs, t_outs, name)
    for a, b in zip(plain, t_outs):  # greedy: speculation changes nothing
        np.testing.assert_array_equal(a, b)
    assert st["spec_steps"] > 0
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert st["accepted_token_rate"] == pytest.approx(
        st["spec_accepted"] / st["spec_proposed"], abs=1e-3)
    assert st["tokens_per_step"] > 1.5
    assert st["spec_tokens"] == 3 and st["proposer"] == "OracleProposer"
    assert st["tokens"] == sum(m for _, m in jobs)
    # one device-to-host copy per prefill and per step
    assert st["d2h_syncs"] == st["prefills"] + st["steps"]
    assert st["cache_util"] == 0.0


def test_ngram_spec_engine_matches_jax_engine(lm):
    """The default n-gram proposer: its drafts (mostly rejected on a
    random-weight model) run the verify path of both engines."""
    host, _ = lm
    jobs = _spec_jobs(1)
    j_outs, _ = serve(mx.DecodeEngine, host, jobs, prefix_cache=0,
                      spec_tokens=3)
    t_outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                       spec_tokens=3)
    assert_chains_agree(host, jobs, j_outs, t_outs)
    assert st["spec_steps"] > 0 and st["spec_proposed"] > 0
    assert st["proposer"] == "ngram"


def test_spec_greedy_equals_plain_engine_and_eos_cuts_mid_window(lm):
    host, _ = lm
    prompt = repetitive_prompt(np.random.RandomState(0))
    jobs = [(prompt, 12)]
    prop, (ref,) = _oracle(host, jobs, wrong_every=4)
    eos = int(ref[5])
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu())) as e:
        want = e.generate(prompt, 12, eos_id=eos)
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), spec_tokens=3,
                                           proposer=prop)) as e:
        got = e.generate(prompt, 12)
        cut = e.generate(prompt, 12, eos_id=eos)
        st = e.stats()
        e.reset_stats()
        st2 = e.stats()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(cut, want)
    assert cut[-1] == eos and len(cut) < 12
    assert st["spec_steps"] > 0 and st["spec_accepted"] > 0
    for k in ("spec_steps", "spec_proposed", "spec_accepted", "tokens",
              "steps"):
        assert st2[k] == 0, k
    assert st2["accepted_token_rate"] == 0.0


def test_spec_under_preemption_matches_jax_engine(lm):
    """Verify windows grow streams by up to 1 + k tokens; with a small
    pool the youngest stream is preempted, re-prefilled and resumed."""
    host, _ = lm
    rng = np.random.RandomState(4)
    jobs = [(repetitive_prompt(rng, n=6, motif=2), 14),
            (repetitive_prompt(rng, n=6, motif=3), 14),
            (repetitive_prompt(rng, n=6, motif=2), 14)]
    over = dict(max_streams=3, cache_blocks=10)
    prop, _ = _oracle(host, jobs)
    j_outs, _ = serve(mx.DecodeEngine, host, jobs, prefix_cache=0, **over)
    t_outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                       spec_tokens=3, proposer=prop, **over)
    assert st["preempted"] > 0 and st["spec_accepted"] > 0
    assert st["cache_util"] == 0.0
    assert_chains_agree(host, jobs, j_outs, t_outs)


def test_spec_rolls_back_pages_of_rejected_drafts(lm):
    host, _ = lm
    rng = np.random.RandomState(3)
    jobs = [(repetitive_prompt(rng, n=15, motif=4), 16),
            (repetitive_prompt(rng, n=7, motif=2), 16)]
    # the first draft wrong at every other step: a 5-row window commits
    # 1 token and leaves pages it grew into holding rejected writes
    prop, plain = _oracle(host, jobs, wrong_every=2, wrong_at=0)
    outs, st = serve(mt.DecodeEngine, host, jobs, ctx=mt.cpu(),
                     spec_tokens=4, proposer=prop)
    for a, b in zip(plain, outs):
        np.testing.assert_array_equal(a, b)
    assert st["spec_proposed"] > st["spec_accepted"] > 0
    assert st["spec_pages_rolled_back"] > 0
    assert st["cache_util"] == 0.0


def test_spec_temperature_reproducible_across_batching(lm):
    host, _ = lm
    prompt = repetitive_prompt(np.random.RandomState(5), n=10, motif=3)
    kw = engine_kw(ctx=mt.cpu(), spec_tokens=3, seed=11)
    with mt.DecodeEngine(host, **kw) as e:
        alone = e.generate(prompt, 10, temperature=0.8, seed=5)
    with mt.DecodeEngine(host, **kw) as e:
        futs = [e.submit(prompt[:7], 9, temperature=0.5),
                e.submit(prompt, 10, temperature=0.8, seed=5),
                e.submit(np.array([1, 2, 1, 2, 1], np.int32), 6)]
        batched = futs[1].result(timeout=120)
        [f.result(timeout=120) for f in futs]
        st = e.stats()
    np.testing.assert_array_equal(alone, batched)
    assert st["spec_steps"] > 0


class _NeverDrafts:
    def propose(self, ctx, k):
        return np.empty(0, np.int32)


def test_temperature_stream_without_drafts_equals_plain_engine(lm):
    """A stream that never drafts draws the plain sampler's tokens
    whether it runs alone on a plain engine or in verify steps beside a
    drafting stream (its rows take the no-draft path)."""
    host, _ = lm

    class _MarkerProposer:
        def __init__(self):
            self.inner = NgramProposer()

        def propose(self, ctx, k):
            if int(ctx[0]) != 1:
                return np.empty(0, np.int32)
            return self.inner.propose(ctx, k)

    rng = np.random.RandomState(12)
    x = rng.randint(2, V, size=9).astype(np.int32)
    y = np.concatenate([[1], np.tile(rng.randint(2, V, size=3), 6)]) \
        .astype(np.int32)[:13]
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu())) as e:
        want = e.generate(x, 10, temperature=0.9, seed=5)
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), spec_tokens=3,
                                           proposer=_MarkerProposer())) as e:
        fy = e.submit(y, 14, temperature=0.9, seed=9)
        fx = e.submit(x, 10, temperature=0.9, seed=5)
        got = fx.result(timeout=120)
        fy.result(timeout=120)
        st = e.stats()
    assert st["spec_proposed"] > 0 and st["proposer"] == "_MarkerProposer"
    np.testing.assert_array_equal(want, got)
    # a proposer that never drafts: every step is the plain step
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), spec_tokens=2,
                                           proposer=_NeverDrafts())) as e:
        got2 = e.generate(x, 10, temperature=0.9, seed=5)
        assert e.stats()["spec_steps"] == 0
    np.testing.assert_array_equal(want, got2)


def test_spec_env_validation(lm, monkeypatch):
    host, _ = lm
    kw = engine_kw(ctx=mt.cpu())
    monkeypatch.setenv("MXNET_SERVING_SPEC_TOKENS", "banana")
    with pytest.raises(mt.MXNetError, match="SPEC_TOKENS"):
        mt.DecodeEngine(host, **kw)
    monkeypatch.setenv("MXNET_SERVING_SPEC_TOKENS", "-1")
    with pytest.raises(mt.MXNetError, match="SPEC_TOKENS"):
        mt.DecodeEngine(host, **kw)
    monkeypatch.setenv("MXNET_SERVING_SPEC_TOKENS", "2")
    monkeypatch.setenv("MXNET_SERVING_PROPOSER", "banana")
    with pytest.raises(mt.MXNetError, match="PROPOSER"):
        mt.DecodeEngine(host, **kw)
    monkeypatch.setenv("MXNET_SERVING_PROPOSER", "ngram")
    with mt.DecodeEngine(host, **kw) as e:
        st = e.stats()
    assert st["spec_tokens"] == 2 and st["proposer"] == "ngram"
    monkeypatch.delenv("MXNET_SERVING_PROPOSER")
    with pytest.raises(mt.MXNetError, match="propose"):
        mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), spec_tokens=2,
                                          proposer=object()))
    with pytest.raises(mt.MXNetError, match=">= 0"):
        mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), spec_tokens=-1))
