"""The port's ``DecodeEngine`` executables, ``warmup()``, the pipelined
fetch and ``swap_params`` against the JAX engine on the CPU, and its CUDA
graphs on the card.

On the CPU each executable (``serving._Executable``: the decode, verify,
miss-prefill and suffix-prefill buckets) runs its function uncaptured over the int8
input buffers it owns, so these tests cover the buffer plumbing and the
bookkeeping the card's CUDA graphs share: ``compiles`` (keys and counts
as the JAX engine's for the same requests, and after ``warmup()``),
the pipelined two-step fetch (``d2h_syncs_saved``, the tokens of an
engine that cannot pipeline), ``swap_params`` / ``get_params`` (the JAX
engine's rules, mirrored from ``tests/test_decode.py``), and tokens
bit for bit equal to the path before the executables (each forward on
tensors fed anew, one step an iteration) for greedy and temperature
rows, over int8 pages, with speculation and with adapters.  Tests
marked ``cuda`` run the graphed engine against ``_graphs=False`` on the
card and skip here.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

import torch_serving_parity as sp

torch.set_num_threads(1)

V = sp.V


@pytest.fixture(scope="module")
def lm():
    host, _ = sp.make_lm(0)
    return host


def _port(host, **kw):
    return mt.DecodeEngine(host, **sp.engine_kw(ctx=mt.cpu(), **kw))


def _jax(host, **kw):
    return mx.DecodeEngine(host, **sp.engine_kw(**kw))


# ---------------------------------------------------------------------------
# swap_params / get_params (tests/test_decode.py's, both engines)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["jax", "port"])
def test_swap_params_identity_and_validation(lm, engine):
    """Mirror of ``test_decode_swap_params_identity_and_validation``:
    identical weights give an identical generation without a new
    executable; a missing or mis-shaped parameter refuses loudly
    ("missing", "shape") and installs nothing."""
    make = _jax if engine == "jax" else _port
    eng = make(lm)
    try:
        p = np.arange(1, 6, dtype=np.int32)
        before = eng.submit(p, 5).result(120)
        assert np.array_equal(eng.submit(p, 5).result(120), before)
        eng.swap_params(lm)
        compiles_before = dict(eng.compiles)
        after = eng.submit(p, 5).result(120)
        assert np.array_equal(before, after)
        assert dict(eng.compiles) == compiles_before
        name = eng._param_names[0]
        with pytest.raises((mx.MXNetError, mt.MXNetError), match="missing"):
            eng.swap_params({name: lm[name]})
        bad = dict(lm)
        bad[name] = np.zeros((3, 3), np.float32)
        with pytest.raises((mx.MXNetError, mt.MXNetError), match="shape"):
            eng.swap_params(bad)
        assert np.array_equal(eng.submit(p, 5).result(120), before)
    finally:
        eng.close(timeout=30)


def test_swap_params_serves_new_weights_as_jax(lm):
    """Other weights swapped in (float64 values, cast to the served
    float32): both engines' next greedy chains are a fresh engine's over
    those weights, ``compiles`` unchanged, and ``get_params`` returns
    them; the two packages' chains agree by the margin rule.  The port's
    prefix cache drops its chains at a swap (their pages hold the old
    weights' K/V): the repeated prompt misses and follows the new
    weights too, over the executables built before the swap (the hit's
    suffix-prefill one among them)."""
    other, _ = sp.make_lm(1)
    p = np.arange(2, 11, dtype=np.int32)
    outs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(other, prefix_cache=0) as fresh:
            want = fresh.generate(p, 8)
        with make(lm, prefix_cache=0) as eng:
            eng.generate(p, 8)
            compiles = dict(eng.compiles)
            eng.swap_params({k: v.astype(np.float64) for k, v in
                             other.items()})
            got = eng.generate(p, 8)
            snap = eng.get_params()
            assert dict(eng.compiles) == compiles
        np.testing.assert_array_equal(got, want)
        for k, v in other.items():
            assert np.asarray(snap[k]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(snap[k]), v)
        outs[name] = got
    sp.assert_chains_agree(other, [(p, 8)], [outs["jax"]], [outs["port"]])
    with _port(lm) as eng:
        first = eng.generate(p, 8)
        np.testing.assert_array_equal(eng.generate(p, 8), first)  # a hit
        compiles = dict(eng.compiles)
        assert eng.stats()["prefix_hits"] == 1
        assert any(k[0] == "prefix_prefill" for k in compiles)
        eng.swap_params(other)
        eng.reset_stats()
        np.testing.assert_array_equal(eng.generate(p, 8), outs["port"])
        assert eng.stats()["prefix_hits"] == 0
        assert dict(eng.compiles) == compiles


# ---------------------------------------------------------------------------
# the pipelined fetch (tests/test_speculative.py's, both engines)
# ---------------------------------------------------------------------------

def test_d2h_pipeline_counts_saved_syncs(lm):
    """Mirror of ``test_d2h_pipeline_counts_saved_syncs``: the plain
    decode path double-buffers the (B,) fetch when the next step's batch
    is provably this one's: the same output, fewer hard syncs; the port's
    counts are the JAX engine's for the same request."""
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, V, size=9).astype(np.int32)
    counts = {}
    for name, make in (("jax", _jax), ("port", _port)):
        e = make(lm)
        try:
            out = e.generate(prompt, 16)
            st = e.stats()
        finally:
            e.close()
        assert st["d2h_syncs_saved"] > 0
        assert st["d2h_syncs"] > st["d2h_syncs_saved"]
        e0 = make(lm, max_streams=1, decode_buckets=[1])
        try:
            ref = e0.generate(prompt, 16)
        finally:
            e0.close()
        np.testing.assert_array_equal(ref, out)
        counts[name] = (st["d2h_syncs"], st["d2h_syncs_saved"], st["steps"])
    assert counts["port"] == counts["jax"]


def test_pipeline_held_back_where_the_batch_may_change(lm):
    """No pair where a stream may end inside it (an eos id, or fewer than
    two tokens left), or while speculating (a pair would skip a
    proposal); the tokens stay those of the pipelined engine."""
    prompt = np.arange(3, 12, dtype=np.int32)
    with _port(lm) as e:
        free = e.generate(prompt, 12)
    for kw, sub in (({}, dict(eos_id=-1)), (dict(spec_tokens=2), {})):
        with _port(lm, **kw) as e:
            got = e.generate(prompt, 12, **sub)
            st = e.stats()
        assert st["d2h_syncs_saved"] == 0
        assert st["d2h_syncs"] == st["prefills"] + st["steps"]
        np.testing.assert_array_equal(got, free)


# ---------------------------------------------------------------------------
# compiles: keys and counts as the JAX engine's
# ---------------------------------------------------------------------------

def _traffic(seed=11):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, V, size=n).astype(np.int32), m)
            for n, m in ((3, 9), (7, 4), (2, 13), (5, 6), (9, 10), (4, 3))]


@pytest.mark.parametrize("kw", [{}, dict(spec_tokens=2),
                                dict(prefill_chunk=4)],
                         ids=["plain", "spec", "chunked"])
def test_compiles_as_jax(lm, kw):
    """The same requests (streams joining and retiring over four seats;
    with speculation, repetitive prompts that draft; with chunks of one
    page, the suffix-prefill executables) build the same executables as
    the JAX engine compiles, each once, in ``eng.compiles`` and
    ``stats()["compiles"]`` alike."""
    if "spec_tokens" in kw:
        rng = np.random.RandomState(4)
        jobs = [(sp.repetitive_prompt(rng, n=n, motif=3), 8)
                for n in (9, 12, 6)]
    else:
        jobs = _traffic()
    got = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(lm, prefix_cache=0, **kw) as eng:
            outs = [f.result(timeout=300)
                    for f in [eng.submit(p, n) for p, n in jobs]]
            got[name] = (dict(eng.compiles), eng.stats())
        assert [len(o) for o in outs] == [n for _, n in jobs]
    (jc, jst), (tc, tst) = got["jax"], got["port"]
    assert tc == jc and all(v == 1 for v in tc.values())
    assert tst["compiles"] == jst["compiles"] == {str(k): 1 for k in jc}
    assert any(k[0] == "verify" for k in tc) == ("spec_tokens" in kw)
    assert any(k[0] == "prefix_prefill" for k in tc) \
        == ("prefill_chunk" in kw)


def test_warmup_builds_the_jax_matrix(lm):
    """``warmup()`` builds every prefill bucket, every (bb, mb) decode
    and verify bucket and every (tp, mb) suffix-prefill bucket whose
    table holds the suffix once, the keys of the JAX engine's
    ``warmup()``; serving afterwards builds nothing."""
    got = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(lm, spec_tokens=2) as eng:
            eng.warmup()
            got[name] = dict(eng.compiles)
            if name == "port":
                st = eng.stats()
                for p, n in _traffic():
                    eng.generate(p, n)
                assert dict(eng.compiles) == got["port"]
                assert not st["graphs"]["graphs_on"]
                assert st["graphs"]["executables"] == len(got["port"])
    jax_keys = got["jax"]
    assert got["port"] == jax_keys and set(jax_keys.values()) == {1}
    assert sum(k[0] == "prefix_prefill" for k in jax_keys) == sum(
        mb * sp.KVB >= tp for tp in st["prefill_buckets"]
        for mb in st["cache_buckets"]) > 0
    cells = len(st["decode_buckets"]) * len(st["cache_buckets"])
    assert sum(k[0] == "verify" for k in jax_keys) \
        == sum(k[0] == "decode" for k in jax_keys) == cells
    assert sum(k[0] == "prefill" for k in jax_keys) \
        == len(st["prefill_buckets"])


# ---------------------------------------------------------------------------
# the executables against the path before them
# ---------------------------------------------------------------------------

class _Fresh:
    """An executable as the engine ran a forward before its executables:
    every call on tensors fed anew, one host-to-device copy a call."""

    def __init__(self, engine, fn, feeds):
        self.engine, self.fn = engine, fn
        self.names = [n for n, _ in feeds]
        self.graphed, self.graph = False, None

    def feed(self, **arrays):
        self.bufs = {n: torch.from_numpy(np.asarray(arrays[n], np.int32))
                     .to(self.engine._device) for n in self.names}

    def run(self):
        return self.fn(self.bufs)


class _PreExecutable(mt.DecodeEngine):
    """The engine before its executables: fresh tensors a forward, no
    executable kept, and (submitted with an eos id no token equals) one
    step an iteration, no pipelined fetch."""

    def _executable(self, key, fn, feeds):
        return _Fresh(self, fn, feeds)


def _mixed_jobs(rng, n=6):
    return [(rng.randint(1, V, size=k).astype(np.int32), m, t)
            for k, m, t in zip(rng.randint(2, 12, size=n),
                               rng.randint(3, 12, size=n),
                               [0.0, 0.8, 0.0, 0.5, 0.0, 0.9][:n])]


@pytest.mark.parametrize("mode", ["fp32", "int8", "spec", "adapters",
                                  "prefix", "chunked"])
def test_executables_equal_the_pre_executable_path(lm, mode):
    """Six requests, greedy and sampled, through the engine and through
    ``_PreExecutable`` (each forward on tensors fed anew, one step an
    iteration): every token equal, over fp32 pages, int8 pages, with
    ``spec_tokens=2`` (repetitive prompts, so verify steps run), with
    two adapters of rank buckets 8 and 16 beside plain streams, with
    prompts that share an 8-token prefix (prefix hits: the
    ``("prefix_prefill", tp, mb)`` executables) and with chunked prefill
    (every chunk one of those executables)."""
    rng = np.random.RandomState({"fp32": 1, "int8": 2, "spec": 3,
                                 "adapters": 4, "prefix": 5,
                                 "chunked": 6}[mode])
    jobs = _mixed_jobs(rng)
    kw, names = {}, [None] * len(jobs)
    if mode == "prefix":
        shared = rng.randint(1, V, size=2 * sp.KVB).astype(np.int32)
        jobs = [(np.concatenate([shared, p]), m, t) for p, m, t in jobs]
    elif mode == "chunked":
        kw = dict(prefill_chunk=sp.KVB)
    elif mode == "int8":
        kw = dict(kv_dtype="int8")
    elif mode == "spec":
        kw = dict(spec_tokens=2)
        jobs = [(sp.repetitive_prompt(rng, n=9, motif=3), m, t)
                for _, m, t in jobs]
    elif mode == "adapters":
        names = ["a8", None, "b16", "a8", None, "b16"]
    outs = {}
    for cls in (mt.DecodeEngine, _PreExecutable):
        extra = {}
        if mode == "adapters":
            pool = mt.AdapterPool(num_layers=sp.L, d_model=sp.DM, slots=2,
                                  rank_buckets=(8, 16), ctx=mt.cpu())
            extra["adapters"] = pool
        with cls(lm, **sp.engine_kw(ctx=mt.cpu(), seed=3, **kw,
                                    **extra)) as eng:
            if mode == "adapters":
                arng = np.random.RandomState(9)
                for nm, r in (("a8", 8), ("b16", 12)):
                    eng.publish_adapter(nm, arng.randn(sp.L, sp.DM, r) * 0.3,
                                        arng.randn(sp.L, r, 3 * sp.DM) * 0.3)
            sub = dict(eos_id=-1) if cls is _PreExecutable else {}
            futs = [eng.submit(p, m, temperature=t, adapter=a, **sub)
                    for (p, m, t), a in zip(jobs, names)]
            outs[cls] = [f.result(timeout=300) for f in futs]
            st = eng.stats()
            if cls is mt.DecodeEngine:
                assert st["graphs"]["executables"] == len(st["compiles"]) > 0
                if mode == "spec":
                    assert st["spec_steps"] > 0
                if mode == "adapters":
                    assert any("lora" in k for k in st["compiles"])
                if mode in ("prefix", "chunked"):
                    assert st["prefix_hits" if mode == "prefix"
                              else "prefill_chunks"] > 0
                    assert any("prefix_prefill" in k for k in st["compiles"])
    for a, b in zip(outs[mt.DecodeEngine], outs[_PreExecutable]):
        np.testing.assert_array_equal(a, b)


def test_executable_feeds_are_checked(lm):
    """An executable takes exactly its feeds, in one copy of one flat
    buffer."""
    with _port(lm) as eng:
        exe = eng._decode_exe(2, 4)
        assert exe is eng._decode_exe(2, 4)
        assert set(exe.bufs) == {"tokens", "positions", "lengths", "table"}
        with pytest.raises(mt.MXNetError, match="feeds"):
            exe.feed(tokens=np.zeros((2, 1), np.int32))
        exe.feed(tokens=np.ones((2, 1), np.int32),
                 positions=np.full((2, 1), 3, np.int32),
                 lengths=np.array([4, 0], np.int32),
                 table=np.arange(8, dtype=np.int32).reshape(2, 4))
        assert exe.bufs["table"].tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert exe.bufs["lengths"].dtype == torch.int32
        # one flat buffer of bytes, each feed on a 16-byte boundary
        assert exe.buf.dtype == torch.uint8
        assert exe.buf.numel() == 16 + 16 + 16 + 32


# ---------------------------------------------------------------------------
# on the card: the graphs
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs exist only there); "
                    "the CPU runs the same executables uncaptured above")
    torch.backends.cuda.matmul.allow_tf32 = False
    return mt.gpu(0)


def _card_engine(lm, ctx, **kw):
    return mt.DecodeEngine(lm, **sp.engine_kw(ctx=ctx, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(spec_tokens=2)],
                         ids=["fp32", "int8", "spec"])
def test_graphed_engine_equals_eager_on_the_card(card, lm, kw):
    """The same traffic through the graphed engine and ``_graphs=False``:
    every token equal, every executable captured once."""
    rng = np.random.RandomState(5)
    jobs = _mixed_jobs(rng)
    if "spec_tokens" in kw:
        jobs = [(sp.repetitive_prompt(rng, n=9, motif=3), m, t)
                for _, m, t in jobs]
    outs, stats = [], []
    for graphs in (True, False):
        with _card_engine(lm, card, seed=3, _graphs=graphs, **kw) as eng:
            outs.append([f.result(timeout=300) for f in [
                eng.submit(p, m, temperature=t) for p, m, t in jobs]])
            stats.append(eng.stats())
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    g = stats[0]["graphs"]
    assert g["graphs_on"] and g["captures"] == g["executables"] \
        == len(stats[0]["compiles"]) > 0
    assert not stats[1]["graphs"]["graphs_on"]


@pytest.mark.cuda
def test_warmup_captures_every_bucket_once_on_the_card(card, lm):
    with _card_engine(lm, card, spec_tokens=2) as eng:
        eng.warmup()
        st = eng.stats()
        assert st["graphs"]["captures"] == len(st["compiles"]) > 0
        assert set(st["compiles"].values()) == {1}
        for p, n in _traffic():
            eng.generate(p, n)
        assert eng.stats()["compiles"] == st["compiles"]


@pytest.mark.cuda
def test_swap_params_keeps_the_graphs_on_the_card(card, lm):
    other, _ = sp.make_lm(1)
    p = np.arange(2, 11, dtype=np.int32)
    with _card_engine(other, card) as fresh:
        want = fresh.generate(p, 8)
    with _card_engine(lm, card) as eng:
        eng.generate(p, 8)
        before = eng.stats()["graphs"]["captures"]
        eng.swap_params(other)
        np.testing.assert_array_equal(eng.generate(p, 8), want)
        assert eng.stats()["graphs"]["captures"] == before

