"""The port's prefix cache against the JAX package on the CPU.

* The allocator and the radix index: each case of
  ``tests/test_prefix_cache.py`` is one op sequence written once and run
  through both packages (``BlockAllocator``, ``PrefixIndex``,
  ``PrefixCache``); after every step the two logs must hold the same
  return values, pages, refcounts, free lists, parked sets, index trees
  (keys, pages, LRU stamps) and ``stats()``, and the same errors.
* The engine: ``mt.DecodeEngine`` at its defaults (the prefix cache on)
  beside ``mx.DecodeEngine(prefix_cache=1)`` on the same requests: the
  same prefix counters at every stage, and greedy chains equal up to
  each chain's first near-tie (``MARGIN`` / ``QMARGIN`` of
  ``torch_serving_parity.py``).  A miss prefills on B1's plain version
  and a hit's suffix on B8's, so a hit is held to the margin rule, not
  bit for bit.  Within the port what is exact stays exact: two sampled
  streams sharing a full hit equal their solo runs bit for bit.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.kv_cache as jkv
import mxnet_tpu.prefix_cache as jpc
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.kv_cache as tkv
import mxnet_tpu_torch.prefix_cache as tpc
from torch_serving_parity import (V, assert_chains_agree, engine_kw,
                                  make_lm)

torch.set_num_threads(1)

PKGS = {
    "jax": dict(BlockAllocator=jkv.BlockAllocator,
                blocks_for_tokens=jkv.blocks_for_tokens,
                bucket_ladder=jkv.bucket_ladder,
                PrefixIndex=jpc.PrefixIndex, PrefixCache=jpc.PrefixCache,
                Error=mx.MXNetError),
    "port": dict(BlockAllocator=tkv.BlockAllocator,
                 blocks_for_tokens=tkv.blocks_for_tokens,
                 bucket_ladder=tkv.bucket_ladder,
                 PrefixIndex=tpc.PrefixIndex, PrefixCache=tpc.PrefixCache,
                 Error=mt.MXNetError),
}


def _toks(*vals):
    return np.asarray(vals, np.int32)


class _Log:
    """What one package did: each ``rec`` appends a canonical record."""

    def __init__(self, pkg):
        self.pkg, self.out = pkg, []

    def __getitem__(self, name):
        return PKGS[self.pkg][name]

    def rec(self, label, value):
        self.out.append((label, _canon(value)))

    def raises(self, label, fn, *args, **kw):
        try:
            fn(*args, **kw)
        except self["Error"] as e:
            self.out.append((label, "raised", type(e).__name__))
            return
        self.out.append((label, "no error"))

    def alloc_state(self, label, a):
        self.rec(label, {"free": list(a._free), "refs": dict(a._refs),
                         "parked": sorted(a._parked),
                         "owners": dict(a._owner),
                         "free_blocks": a.free_blocks,
                         "used": a.used_blocks,
                         "free_list": a.free_list_blocks,
                         "parked_n": a.parked_blocks,
                         "shared": a.shared_blocks,
                         "util": a.utilization()})

    def cache_state(self, label, pc):
        self.alloc_state(label + " allocator", pc.allocator)
        self.rec(label + " stats", pc.stats())
        self.rec(label + " tree", _tree(pc.index))
        self.rec(label + " page_node", sorted(pc._page_node))


def _canon(v):
    if isinstance(v, list) and v and hasattr(v[0], "page"):
        return ("nodes", [n.page for n in v])
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, list):
        return [_canon(x) for x in v]
    return v


def _tree(ix):
    """Every node of the index: (path of keys, page, stamp), sorted."""
    out, stack = [], [((k,), n) for k, n in ix._root.items()]
    while stack:
        path, n = stack.pop()
        out.append((path, n.page, n.stamp))
        stack.extend((path + (k,), c) for k, c in n.children.items())
    return sorted(out), len(ix), ix._clock


# ---------------------------------------------------------------------------
# the op sequences (tests/test_prefix_cache.py:31-221, and the salt)
# ---------------------------------------------------------------------------


def seq_zero_token_edges(m):
    m.rec("bft 0/4", m["blocks_for_tokens"](0, 4))
    m.rec("bft 0/1", m["blocks_for_tokens"](0, 1))
    m.raises("bft -1", m["blocks_for_tokens"], -1, 4)
    a = m["BlockAllocator"](5, 4)
    m.rec("alloc 0", a.alloc(0, owner="s"))
    m.alloc_state("after alloc 0", a)
    m.raises("ladder 0", m["bucket_ladder"], 0)
    m.raises("ladder -3", m["bucket_ladder"], -3)


def seq_share_release_park_revive(m):
    a = m["BlockAllocator"](6, 4)
    (p,) = a.alloc(1, owner="A")
    m.rec("page", p)
    m.rec("share", a.share(p))
    m.alloc_state("shared", a)
    m.rec("release", a.release(p))
    m.rec("park", a.release(p, park=True))
    m.alloc_state("parked", a)
    m.rec("is_parked", a.is_parked(p))
    a.revive(p, owner="B")
    m.alloc_state("revived", a)
    m.raises("reclaim live", a.reclaim, p)
    a.release(p, park=True)
    a.reclaim(p)
    m.alloc_state("reclaimed", a)
    m.raises("revive free", a.revive, p)
    m.raises("release free", a.release, p)
    m.raises("share free", a.share, p)


def seq_free_of_shared_raises(m):
    a = m["BlockAllocator"](6, 4)
    (p,) = a.alloc(1, owner="A")
    a.share(p)
    m.raises("free shared", a.free, [p])
    m.alloc_state("unchanged", a)
    a.release(p)
    a.free([p])
    m.alloc_state("freed", a)
    m.raises("double free", a.free, [p])
    (q,) = a.alloc(1, owner="B")
    a.release(q, park=True)
    a.free([q])  # a parked page frees as a reclaim
    m.alloc_state("parked freed", a)
    m.raises("scratch", a.free, [0])


def seq_index_match_insert_remove(m):
    ix = m["PrefixIndex"](4)
    t = _toks(*range(1, 13))
    m.rec("empty", ix.match(t))
    m.rec("insert", ix.insert(t, [5, 6, 7], 3))
    m.rec("match", ix.match(t))
    t2 = np.concatenate([t[:8], _toks(99, 98, 97, 96)])
    m.rec("diverge", ix.match(t2))
    m.rec("7 tokens", ix.match(t[:7]))
    m.rec("duplicate", ix.insert(t, [50, 60, 70], 3))
    m.rec("tree", _tree(ix))
    m.raises("interior", ix.remove, ix.match(t)[0])
    ix.remove(ix.match(t)[-1])
    m.rec("after remove", ix.match(t))
    m.rec("leaves", sorted(n.page for n in ix.leaves()))
    m.rec("tree after", _tree(ix))
    m.raises("bad block", m["PrefixIndex"], 0)


def seq_attach_register_release_evict(m):
    a = m["BlockAllocator"](8, 4)
    pc = m["PrefixCache"](a, policy="lru")
    t = _toks(*range(1, 11))
    pages = pc.alloc(3, owner="A")
    pc.register(t, pages)
    m.cache_state("registered", pc)
    m.rec("peek", pc.peek(t))
    m.rec("attach B", pc.attach(t, owner="B"))
    m.cache_state("attached", pc)
    pc.release(pages[:2])  # B lets go: A's references survive
    m.cache_state("B released", pc)
    pc.release(pages)      # A retires: indexed pages park
    m.cache_state("A released", pc)
    m.rec("peek parked", pc.peek(t))
    cached, got = pc.attach(t, owner="C")
    m.rec("revive", (cached, got))
    pc.release(got)
    m.rec("alloc 6", pc.alloc(6, owner="D"))
    m.cache_state("pressure", pc)


def seq_eviction_lru_order(m):
    a = m["BlockAllocator"](10, 4)
    pc = m["PrefixCache"](a, policy="lru")
    t1, t2 = _toks(*range(1, 9)), _toks(*range(21, 29))
    pa = pc.alloc(2, "A")
    pc.register(t1, pa)
    pb = pc.alloc(2, "B")
    pc.register(t2, pb)
    pc.release(pa)
    pc.release(pb)
    m.rec("peek", pc.peek(t2))  # a peek touches nothing
    cached, got = pc.attach(t1, "C")
    pc.release(got)
    for i in range(3):
        m.rec(f"evict {i}", pc.evict(1))
        m.rec(f"chain A {i}", pc.index.match(t1, touch=False))
        m.rec(f"chain B {i}", pc.index.match(t2, touch=False))
        m.cache_state(f"evicted {i}", pc)
    m.rec("evict all", pc.evict(10))
    m.cache_state("empty", pc)


def seq_policy_off(m):
    a = m["BlockAllocator"](6, 4)
    pc = m["PrefixCache"](a, policy="off")
    t = _toks(*range(1, 9))
    pages = pc.alloc(2, "A")
    pc.register(t, pages)
    m.rec("cow while indexed", pc.needs_cow(pages[0]))
    pc.release(pages)
    m.cache_state("released", pc)
    m.rec("evict", pc.evict(2))
    m.raises("bad policy", m["PrefixCache"], a, policy="banana")


def seq_needs_cow(m):
    a = m["BlockAllocator"](6, 4)
    pc = m["PrefixCache"](a, policy="lru")
    (private,) = pc.alloc(1, "A")
    m.rec("private", pc.needs_cow(private))
    (shared,) = pc.alloc(1, "A")
    a.share(shared)
    m.rec("shared", pc.needs_cow(shared))
    (indexed,) = pc.alloc(1, "B")
    pc.register(_toks(1, 2, 3, 4), [indexed])
    m.rec("indexed", pc.needs_cow(indexed))
    pc.note_cow()
    m.cache_state("after", pc)
    pc.reset_counters()
    m.cache_state("reset", pc)


def seq_salt_invalidate_detach(m):
    """Salted chains live in their own namespace; ``invalidate_salt``
    drops them (reclaiming parked pages) and ``detach`` un-indexes a
    chain whose holder keeps it."""
    a = m["BlockAllocator"](12, 4)
    pc = m["PrefixCache"](a, policy="lru")
    t = _toks(*range(1, 9))
    plain = pc.alloc(2, "P")
    pc.register(t, plain)
    salted = pc.alloc(2, "S")
    pc.register(t, salted, salt=b"adapter-x")
    m.rec("peek plain", pc.peek(t))
    m.rec("peek salted", pc.peek(t, salt=b"adapter-x"))
    m.rec("peek other", pc.peek(t, salt=b"adapter-y"))
    pc.release(salted)
    m.cache_state("salted parked", pc)
    m.rec("invalidate", pc.invalidate_salt(b"adapter-x"))
    m.rec("invalidate none", pc.invalidate_salt(b""))
    m.cache_state("invalidated", pc)
    m.rec("detach", pc.detach(plain[:1]))
    m.cache_state("detached", pc)
    pc.release(plain)
    m.cache_state("released", pc)


SEQUENCES = [seq_zero_token_edges, seq_share_release_park_revive,
             seq_free_of_shared_raises, seq_index_match_insert_remove,
             seq_attach_register_release_evict, seq_eviction_lru_order,
             seq_policy_off, seq_needs_cow, seq_salt_invalidate_detach]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_op_sequence_matches_jax(seq):
    logs = {}
    for pkg in PKGS:
        m = _Log(pkg)
        seq(m)
        logs[pkg] = m.out
    assert len(logs["port"]) == len(logs["jax"])
    for got, want in zip(logs["port"], logs["jax"]):
        assert got == want


# ---------------------------------------------------------------------------
# the engine, against the JAX engine with its prefix cache on
# ---------------------------------------------------------------------------

# counters both engines report (PrefixCache.stats and the engine's)
PREFIX_KEYS = ("prefix_hits", "prefix_hit_tokens", "prefix_full_hits",
               "cow_copies", "evictions", "indexed_blocks", "cached_blocks",
               "shared_blocks", "cache_blocks_cached", "prefills",
               "prefill_tokens", "generations", "prefix_cache",
               "prefix_hit_rate", "cache_util")


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _engines(host, **over):
    """(JAX engine with the prefix cache on, the port's at its
    defaults) over the same weights."""
    return (mx.DecodeEngine(host, **engine_kw(prefix_cache=1, **over)),
            mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), **over)))


def _pick(st):
    return {k: st[k] for k in PREFIX_KEYS}


def test_engine_defaults_to_the_prefix_cache(lm):
    with mt.DecodeEngine(lm[0], **engine_kw(ctx=mt.cpu())) as eng:
        st = eng.stats()
    assert st["prefix_cache"] == 1 and st["prefix_hits"] == 0
    assert st["cached_blocks"] == 0 and st["prefix_hit_rate"] == 0.0


def test_engine_smoke_hit_attach_diverge_evict(lm):
    """Miss, suffix-only hit, full hit (one COW), then a disjoint prompt
    whose growth evicts the parked chain: the same counters as the JAX
    engine at every stage."""
    host, _ = lm
    shared = np.arange(1, 9, dtype=np.int32)
    pa = np.concatenate([shared, [11, 12, 13]]).astype(np.int32)
    pb = np.concatenate([shared, [21, 22]]).astype(np.int32)
    big = np.arange(40, 56, dtype=np.int32)
    jobs = [(pa, 4), (pb, 4), (shared, 4), (big, 4)]
    runs = {}
    je, te = _engines(host, cache_blocks=7)
    for name, eng in (("jax", je), ("port", te)):
        with eng:
            outs, stages = [], []
            for p, n in jobs:
                outs.append(eng.generate(p, n))
                stages.append(_pick(eng.stats()))
            runs[name] = outs, stages
    assert runs["port"][1] == runs["jax"][1]
    st = runs["port"][1]
    assert st[0]["prefix_hits"] == 0 and st[0]["prefill_tokens"] == 11
    assert st[0]["cache_blocks_cached"] == 2
    assert st[1]["prefix_hits"] == 1 and st[1]["prefill_tokens"] == 13
    assert st[2]["prefix_full_hits"] == 1 and st[2]["cow_copies"] == 1
    assert st[2]["prefills"] == 2
    assert st[3]["evictions"] >= 1 and st[3]["cache_util"] == 0.0
    assert_chains_agree(host, jobs, runs["jax"][0], runs["port"][0])


def test_engine_hit_chains_agree_with_jax(lm):
    """A miss, a suffix-only hit and a full hit on fp32 pages: the
    port's greedy chains equal the JAX engine's by the margin rule, and
    the port's hit-time TTFT split is reported."""
    host, _ = lm
    shared = np.arange(1, 9, dtype=np.int32)
    jobs = [(np.concatenate([shared, [11, 12, 13]]).astype(np.int32), 8),
            (np.concatenate([shared, [21, 22]]).astype(np.int32), 8),
            (shared, 8)]
    je, te = _engines(host)
    outs = {}
    for name, eng in (("jax", je), ("port", te)):
        with eng:
            outs[name] = [eng.generate(p, n) for p, n in jobs]
            st = eng.stats()
        assert st["prefix_hits"] == 2 and st["prefix_full_hits"] == 1
    assert st["ttft_hit_p50_ms"] is not None
    assert st["ttft_miss_p50_ms"] is not None
    assert_chains_agree(host, jobs, outs["jax"], outs["port"])


def test_engine_cow_isolation_diverging_streams(lm):
    """Two sampled streams sharing a full-hit prefix each equal their
    solo runs bit for bit (the port on the CPU), and the shared page's
    bytes are unchanged by the copies."""
    host, _ = lm
    shared = np.arange(2, 10, dtype=np.int32)
    solo = {}
    for sd in (7, 8):
        with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), seed=3)) as e:
            solo[sd] = e.generate(shared, 6, temperature=0.8, seed=sd)
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), seed=3)) as eng:
        eng.generate(shared, 2)  # seeds the cache, retires
        chain = [n.page for n in eng._prefix.index.match(shared, touch=False)]
        before = [p[chain[-1]].clone() for p in eng._pools]
        f1 = eng.submit(shared, 6, temperature=0.8, seed=7)
        f2 = eng.submit(shared, 6, temperature=0.8, seed=8)
        g1, g2 = f1.result(120), f2.result(120)
        after = [p[chain[-1]] for p in eng._pools]
        st = eng.stats()
    np.testing.assert_array_equal(g1, solo[7])
    np.testing.assert_array_equal(g2, solo[8])
    assert st["prefix_hits"] >= 2 and st["cow_copies"] >= 2
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_engine_preemption_frees_only_private_refs(lm):
    """Two 11-token prompts sharing 8 tokens in 8 usable pages: they
    coexist only through sharing, and 12 new tokens each (the JAX
    case's 10 fit both exactly) make decode growth preempt one, which
    comes back as a prefix hit; every page comes back, and the chains
    agree with the JAX engine's."""
    host, _ = lm
    shared = np.arange(3, 11, dtype=np.int32)
    jobs = [(np.concatenate([shared, [31, 32, 33]]).astype(np.int32), 12),
            (np.concatenate([shared, [41, 42, 43]]).astype(np.int32), 12)]
    je, te = _engines(host, cache_blocks=9, max_streams=2)
    outs, stats = {}, {}
    for name, eng in (("jax", je), ("port", te)):
        with eng:
            futs = [eng.submit(p, n) for p, n in jobs]
            outs[name] = [f.result(120) for f in futs]
            stats[name] = eng.stats()
    st = stats["port"]
    assert st["prefix_hits"] >= 2 and st["generations"] == 2
    assert st["preempted"] >= 1 and stats["jax"]["preempted"] >= 1
    assert st["cache_util"] == 0.0
    assert st["cache_blocks_free"] == 8  # free + parked = capacity
    assert_chains_agree(host, jobs, outs["jax"], outs["port"])


def test_engine_prefix_cache_off_matches_legacy(lm):
    """``prefix_cache=0``: no sharing counters, a repeated prompt
    prefills again, and the chain is the one the port served before the
    cache: equal to the JAX engine's (cache off) by the margin rule and
    to the port's own cache-on miss bit for bit."""
    host, _ = lm
    p = np.arange(1, 9, dtype=np.int32)
    outs, stats = {}, {}
    for name, eng in (
            ("jax", mx.DecodeEngine(host, **engine_kw(prefix_cache=0))),
            ("port", mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(),
                                                       prefix_cache=0)))):
        with eng:
            outs[name] = [eng.generate(p, 4), eng.generate(p, 4)]
            stats[name] = eng.stats()
    for st in stats.values():
        assert st["prefix_cache"] == 0 and "prefix_hits" not in st
        assert st["prefill_tokens"] == 16 and st["cache_blocks_cached"] == 0
    np.testing.assert_array_equal(outs["port"][0], outs["port"][1])
    with mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu())) as eng:
        np.testing.assert_array_equal(eng.generate(p, 4), outs["port"][0])
    assert_chains_agree(host, [(p, 4)] * 2, outs["jax"], outs["port"])


@pytest.mark.parametrize("env,match", [
    ({"MXNET_SERVING_EVICT": "mru"}, "mru"),
    ({"MXNET_SERVING_PREFIX_CACHE": "2"}, "0 or 1"),
    ({"MXNET_SERVING_PREFIX_CACHE": "banana"}, "integer"),
    ({"MXNET_SERVING_KV_DTYPE": "banana"}, "banana"),
], ids=lambda x: next(iter(x.values())) if isinstance(x, dict) else x)
def test_engine_env_validation(lm, monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(mx.MXNetError, match=match):
        mx.DecodeEngine(lm[0], **engine_kw())
    with pytest.raises(mt.MXNetError, match=match):
        mt.DecodeEngine(lm[0], **engine_kw(ctx=mt.cpu()))


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_engine_quantized_pages_with_the_cache(lm, name):
    """A full hit over quantized pages: one COW of every pool (codes
    and scales), the counters of the JAX engine, and both chains (the
    miss, then the full hit replaying its last prompt token over the
    cached codes) agreeing with the JAX engine's by ``QMARGIN`` along
    the JAX quantized graphs of the same path."""
    host, _ = lm
    p = np.arange(1, 9, dtype=np.int32)
    je, te = _engines(host, kv_dtype=name)
    outs, stats = {}, {}
    for eng_name, eng in (("jax", je), ("port", te)):
        with eng:
            outs[eng_name] = [eng.generate(p, 4), eng.generate(p, 4)]
            stats[eng_name] = _pick(eng.stats())
    assert stats["port"] == stats["jax"]
    assert stats["port"]["prefix_full_hits"] == 1
    assert stats["port"]["cow_copies"] == 1
    assert_chains_agree(host, [(p, 4)] * 2, outs["jax"], outs["port"],
                        name=name, paths=[{}, dict(cached=len(p))])


def test_engine_long_shared_prefix_sweep(lm):
    """Twelve requests, most over one 12-token shared prefix, through a
    25-page pool: every stream retires, pages are counted once, the
    counters are the JAX engine's and the chains agree with its."""
    host, _ = lm
    rng = np.random.RandomState(11)
    shared = np.arange(5, 17, dtype=np.int32)
    jobs = []
    for _ in range(12):
        if rng.rand() < 0.8:
            suffix = rng.randint(1, V, size=rng.randint(1, 5))
            jobs.append((np.concatenate([shared, suffix]).astype(np.int32),
                         5))
        else:
            jobs.append((rng.randint(1, V, size=rng.randint(6, 14))
                         .astype(np.int32), 5))
    je, te = _engines(host, cache_blocks=25)
    outs, stats = {}, {}
    for name, eng in (("jax", je), ("port", te)):
        with eng:
            futs = [eng.submit(p, n) for p, n in jobs]
            outs[name] = [f.result(240) for f in futs]
            stats[name] = eng.stats()
    st = stats["port"]
    assert st["prefix_hits"] >= 6 and st["generations"] == 12
    assert st["cache_util"] == 0.0
    assert _pick(st) == _pick(stats["jax"])
    assert_chains_agree(host, jobs, outs["jax"], outs["port"])
