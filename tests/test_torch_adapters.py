"""The port's multi-tenant layer against the JAX package's, on the CPU.

* The pool, quota and env readers (``mxnet_tpu_torch/adapters.py``):
  each case of ``tests/test_adapters.py:64-207`` is one op sequence
  written once and run through both packages; after every step the two
  logs hold the same returns, slots, refcounts, eviction order, counters,
  ``stats()`` and slab rows, and the same errors word for word.  The
  quota runs on an injected clock.
* ``LoraGatherDelta`` against the JAX op: 1e-6 in fp32, 2 units of 2^-8
  relative in bf16 (``torch_op_parity``'s bf16 rule), slot-0 rows bit
  for bit the base; a rank-4 adapter padded into a rank-8 bucket gives
  the unpadded delta.
* ``TransformerLM(lora=)`` entry points against the JAX graphs built
  with the same ``lora`` (``transformer_lm_{prefill,prefix_prefill,
  decode,verify}``) on the same pools, fp32 and int8: logits at the
  fp32 ``TOL`` of ``torch_serving_parity.py``.
* The engine cases of ``tests/test_adapters.py:292-618`` through both
  engines: plain streams of an adapter-enabled port engine bit for bit
  the pre-adapter port engine's; adapter streams, solo and mixed, and
  composed with the prefix cache, speculation and preemption, agreeing
  with the JAX engine's by the margin rule (the reference rows: the JAX
  full forward of the merged weights ``W + scale (A B)^T``, a different
  product, so never bitwise; ``QMARGIN`` over int8 pages); a mixed batch
  equal to the solo runs bit for bit within the port; the prefix cache
  namespaced by adapter (hit counters equal to the JAX engine's);
  publish and retire under load; quota shedding with per-tenant
  counters equal to JAX's; interactive admission ahead of batch; the
  refusals.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.adapters as jad
from mxnet_tpu.models.transformer import (transformer_lm_decode,
                                          transformer_lm_prefill,
                                          transformer_lm_prefix_prefill,
                                          transformer_lm_verify)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.adapters as tad
from mxnet_tpu_torch.ops.adapter import lora_gather_delta
from torch_serving_parity import (DM, KVB, L, QMARGIN, TOL, V,
                                  assert_chains_agree, engine_kw,
                                  fresh_pools, jax_graph,
                                  jax_quant_chain_rows, make_lm, run_graph)

torch.set_num_threads(1)

CPU = mt.cpu()
# one bucket of each ladder: the JAX engines compile one executable of
# each kind, and the port's engines see the same shapes
FEW = dict(decode_buckets=[4], cache_buckets=[8], prefill_buckets=[32])
PKGS = {"jax": dict(mod=jad, Error=mx.MXNetError, kw={}),
        "port": dict(mod=tad, Error=mt.MXNetError, kw={"ctx": CPU})}


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _ab(rng, r=4, scale=0.1):
    return (rng.randn(L, DM, r).astype(np.float32) * scale,
            rng.randn(L, r, 3 * DM).astype(np.float32) * scale)


# ---------------------------------------------------------------------------
# the pool and the quota: one op sequence through both packages
# ---------------------------------------------------------------------------


class _Log:
    """What one package's pool did: each step appends a record."""

    def __init__(self, pkg):
        self.pkg, self.out = pkg, []
        self.mod = PKGS[pkg]["mod"]

    def pool(self, **kw):
        args = dict(num_layers=L, d_model=DM, slots=2, rank_buckets=(4,))
        args.update(kw)
        self.p = self.mod.AdapterPool(**args, **PKGS[self.pkg]["kw"])
        return self.p

    def do(self, label, fn, *args, **kw):
        """Run ``fn``; record its return or its error, then the pool."""
        try:
            self.out.append((label, fn(*args, **kw)))
        except PKGS[self.pkg]["Error"] as e:
            self.out.append((label, "raised", str(e)))
        self.state(label)

    def state(self, label):
        p = self.p
        names = sorted(p._entries)
        slabs = [np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                            else x) for x in p.slabs()]
        self.out.append((label, "state", p.stats(),
                         {n: (p.refcount(n), p._entries[n].slot,
                              p.bucket_of(n)) for n in names},
                         [s.tobytes() for s in slabs]))


def seq_lifecycle_refcounts(m, rng):
    m.pool()
    m.do("publish x", m.p.publish, "x", *_ab(rng))
    m.do("acquire", m.p.acquire, "x")
    m.do("acquire again", m.p.acquire, "x")
    m.do("release", m.p.release, "x")
    m.do("release", m.p.release, "x")
    m.do("retire parked", m.p.retire, "x")
    m.do("acquire retired", m.p.acquire, "x")


def seq_lru_eviction_and_reinstall(m, rng):
    m.pool(slots=2)
    for name in ("a", "b"):
        m.do(f"publish {name}", m.p.publish, name, *_ab(rng))
    m.do("touch a", m.p.acquire, "a")
    m.do("release a", m.p.release, "a")
    m.do("publish c evicts b", m.p.publish, "c", *_ab(rng))
    m.do("acquire b (miss)", m.p.acquire, "b")
    m.do("release b", m.p.release, "b")
    m.do("export", lambda: [(n, a.tobytes(), b.tobytes(), r) for
                            n, a, b, r in m.p.export_adapters()])


def seq_live_slots_never_evict(m, rng):
    m.pool(slots=1)
    m.do("publish x", m.p.publish, "x", *_ab(rng))
    m.do("hold x", m.p.acquire, "x")
    m.do("publish y: full", m.p.publish, "y", *_ab(rng))
    m.do("release x", m.p.release, "x")
    m.do("publish y", m.p.publish, "y", *_ab(rng))


def seq_retire_defers_to_last_holder(m, rng):
    m.pool()
    m.do("publish x", m.p.publish, "x", *_ab(rng))
    m.do("hold x", m.p.acquire, "x")
    m.do("retire held", m.p.retire, "x")
    m.do("acquire retiring", m.p.acquire, "x")
    m.do("release last", m.p.release, "x")
    m.do("bucket_of gone", m.p.bucket_of, "x")
    m.do("release unknown", m.p.release, "x")


def seq_rank_buckets_and_validation(m, rng):
    m.pool(rank_buckets=(4, 8))
    m.do("publish r3", m.p.publish, "r3", *_ab(rng, r=3), alpha=6.0)
    m.do("bucket r3", m.p.bucket_of, "r3")
    m.do("publish r8", m.p.publish, "r8", *_ab(rng, r=8))
    m.do("publish r9", m.p.publish, "r9", *_ab(rng, r=9))
    m.do("republish", m.p.publish, "r3", *_ab(rng, r=3))
    m.do("bad A", m.p.publish, "bad", np.zeros((L, DM + 1, 4), np.float32),
         np.zeros((L, 4, 3 * DM), np.float32))
    m.do("bad B", m.p.publish, "bad", np.zeros((L, DM, 4), np.float32),
         np.zeros((L, 5, 3 * DM), np.float32))
    m.do("2-D broadcast", m.p.publish, "flat",
         rng.randn(DM, 2).astype(np.float32),
         rng.randn(2, 3 * DM).astype(np.float32), alpha=1.0)
    m.do("retire unknown", m.p.retire, "nope")
    m.do("acquire unknown", m.p.acquire, "nope")


SEQS = [seq_lifecycle_refcounts, seq_lru_eviction_and_reinstall,
        seq_live_slots_never_evict, seq_retire_defers_to_last_holder,
        seq_rank_buckets_and_validation]


@pytest.mark.parametrize("seq", SEQS, ids=lambda f: f.__name__[4:])
def test_pool_sequence_matches_jax(seq):
    logs = {}
    for pkg in PKGS:
        m = _Log(pkg)
        seq(m, np.random.RandomState(len(seq.__name__)))
        logs[pkg] = m.out
    assert len(logs["port"]) == len(logs["jax"])
    for a, b in zip(logs["port"], logs["jax"]):
        assert a == b, (a[:3], b[:3])


def test_pool_constructor_validation_matches_jax():
    for kw in (dict(slots=0), dict(rank_buckets=(8, 4)),
               dict(rank_buckets=()), dict(rank_buckets=(0,))):
        msgs = []
        for pkg, p in PKGS.items():
            with pytest.raises(p["Error"]) as ei:
                p["mod"].AdapterPool(num_layers=L, d_model=DM, **kw,
                                     **p["kw"])
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_quota_matches_jax_on_an_injected_clock():
    """``tests/test_adapters.py:154-176`` through both packages: the
    typed shed (reason, tenant, needed, balance), refund, refill against
    a pinned clock, capacity 0 off, the bucket caps at capacity."""
    logs = {}
    for pkg, p in PKGS.items():
        mod, out, now = p["mod"], [], [0.0]

        def do(label, fn, *a):
            try:
                out.append((label, fn(*a)))
            except mod.QuotaExceededError as e:
                out.append((label, "shed", str(e), e.reason, e.tenant,
                            e.needed, e.balance))

        q = mod.TenantQuota(10, clock=lambda: now[0])
        do("charge 6", q.charge, "t", 6)
        do("charge 6 again", q.charge, "t", 6)
        do("refund 4", q.refund, "t", 4)
        do("charge 6", q.charge, "t", 6)
        do("refund unknown", q.refund, "u", 3)
        out.append(("stats", q.stats()))
        q2 = mod.TenantQuota(10, refill_rate=2.0, clock=lambda: now[0])
        do("drain", q2.charge, "u", 10)
        now[0] = 3.0
        do("balance after 3 s", q2.balance, "u")
        do("charge 6", q2.charge, "u", 6)
        now[0] = 100.0
        do("balance capped", q2.balance, "u")
        do("refund past cap", q2.refund, "u", 50)
        out.append(("stats2", q2.stats()))
        do("off", mod.TenantQuota(0).charge, "v", 10 ** 9)
        for bad in ((-1,), (5, -0.5)):
            try:
                mod.TenantQuota(*bad)
            except p["Error"] as e:
                out.append(("bad", str(e)))
        logs[pkg] = out
    assert logs["port"] == logs["jax"]


ENV_CASES = [
    {"MXNET_ADAPTER_SLOTS": "banana"}, {"MXNET_ADAPTER_SLOTS": "0"},
    {"MXNET_ADAPTER_SLOTS": "3", "MXNET_ADAPTER_RANK_BUCKETS": "8,4"},
    {"MXNET_ADAPTER_RANK_BUCKETS": "4,x"},
    {"MXNET_ADAPTER_SLOTS": "3", "MXNET_ADAPTER_RANK_BUCKETS": "4,8"},
    {}, {"MXNET_ADAPTER_ENABLE": "2"}, {"MXNET_ADAPTER_ENABLE": "1"},
    {"MXNET_TENANT_QUOTA_TOKENS": "-1"}, {"MXNET_TENANT_QUOTA_TOKENS": "0"},
    {"MXNET_TENANT_QUOTA_TOKENS": "100",
     "MXNET_TENANT_QUOTA_REFILL": "nope"},
    {"MXNET_TENANT_QUOTA_TOKENS": "100", "MXNET_TENANT_QUOTA_REFILL": "2.5"},
]


@pytest.mark.parametrize("env", ENV_CASES,
                         ids=lambda e: ",".join(f"{k[6:]}={v}" for k, v in
                                                e.items()) or "defaults")
def test_env_readers_match_jax(monkeypatch, env):
    for k in ("MXNET_ADAPTER_SLOTS", "MXNET_ADAPTER_RANK_BUCKETS",
              "MXNET_ADAPTER_ENABLE", "MXNET_TENANT_QUOTA_TOKENS",
              "MXNET_TENANT_QUOTA_REFILL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for pkg, p in PKGS.items():
        mod, out = p["mod"], []
        for label, fn in (
                ("pool", lambda: mod.pool_from_env(L, DM, **p["kw"])),
                ("enabled", mod.adapters_enabled),
                ("quota", mod.quota_from_env)):
            try:
                r = fn()
                out.append((label, None if r is None else
                            r if isinstance(r, bool) else
                            (getattr(r, "slots", None),
                             getattr(r, "rank_buckets", None),
                             getattr(r, "capacity", None),
                             getattr(r, "refill_rate", None))))
            except p["Error"] as e:
                out.append((label, "raised", str(e)))
        got[pkg] = out
    assert got["port"] == got["jax"]


def test_catalog_defaults_match_jax():
    import mxnet_tpu.config as jcfg

    for name in ("MXNET_ADAPTER_ENABLE", "MXNET_ADAPTER_SLOTS",
                 "MXNET_ADAPTER_RANK_BUCKETS", "MXNET_TENANT_QUOTA_TOKENS",
                 "MXNET_TENANT_QUOTA_REFILL", "MXNET_SERVING_DRAFT_CKPT",
                 "MXNET_SERVING_DRAFT_HEADS"):
        t, j = mt.config.describe(name), jcfg.describe(name)
        assert (t.default, t.dtype) == (j.default, j.dtype), name


# ---------------------------------------------------------------------------
# LoraGatherDelta against the JAX op
# ---------------------------------------------------------------------------


def _slabs(rng, N=4, rb=8, ranks=(8, 4, 8), scale=0.3):
    """Slabs of N slots (row 0 zeros) whose slot i+1 holds a rank
    ``ranks[i]`` adapter zero-padded to ``rb``."""
    a = np.zeros((N, L, DM, rb), np.float32)
    b = np.zeros((N, L, rb, 3 * DM), np.float32)
    for i, r in enumerate(ranks):
        a[i + 1, :, :, :r] = rng.randn(L, DM, r) * scale
        b[i + 1, :, :r] = rng.randn(L, r, 3 * DM) * scale
    return a, b


def _jax_lora(base, h, a, b, slots, layer):
    import jax.numpy as jnp

    op = jreg.get_op("LoraGatherDelta")
    return np.asarray(op.compute(None, {"layer": str(layer)},
                                 [jnp.asarray(x) for x in
                                  (base, h, a, b, slots)], [])[0])


@pytest.mark.parametrize("layer", [0, 1])
def test_lora_gather_delta_matches_jax_fp32(layer):
    rng = np.random.RandomState(layer)
    a, b = _slabs(rng)
    B, S = 5, 3
    base = rng.randn(B, S, 3 * DM).astype(np.float32)
    h = rng.randn(B, S, DM).astype(np.float32)
    slots = np.array([0, 1, 2, 3, 0], np.int32)
    want = _jax_lora(base, h, a, b, slots, layer)
    got = lora_gather_delta(*(torch.from_numpy(x) for x in
                              (base, h, a, b, slots)), layer).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # slot-0 rows: the base's bits, not base + 0.0
    for i in (0, 4):
        assert got[i].tobytes() == base[i].tobytes()
    assert not np.allclose(got[1], base[1])
    # slot 2 holds a rank-4 adapter padded to 8: the unpadded delta
    delta = (h[2] @ a[2, layer, :, :4]) @ b[2, layer, :4]
    np.testing.assert_allclose(got[2], base[2] + delta, rtol=1e-6,
                               atol=1e-6)


def test_lora_gather_delta_matches_jax_bf16():
    """bf16 base and activations over float32 slabs (the pool's):
    within 2 units of 2^-8 of the JAX op's largest |value|."""
    import ml_dtypes

    rng = np.random.RandomState(3)
    a, b = _slabs(rng)
    base = rng.randn(4, 2, 3 * DM).astype(ml_dtypes.bfloat16)
    h = rng.randn(4, 2, DM).astype(ml_dtypes.bfloat16)
    slots = np.array([2, 0, 1, 3], np.int32)
    want = _jax_lora(base, h, a, b, slots, 1).astype(np.float32)
    tb, th = (torch.from_numpy(x.astype(np.float32)).bfloat16()
              for x in (base, h))
    got = lora_gather_delta(tb, th, torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(slots), 1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    assert got[1].tobytes() == base[1].astype(np.float32).tobytes()


def test_lora_gather_delta_sweep_case_matches_jax():
    """The op sweep's case (``chip_smoke.op_sweep_cases``, family
    "adapter", the one phase 14 runs on the card) through
    ``torch_op_parity.check_case``: forward and the gradients of base, h
    and both slabs against ``jax.vjp`` of the JAX op."""
    from torch_op_parity import cases, check_case

    (case,), _ = cases("adapter")
    check_case(case)


def test_lora_op_is_registered_with_the_jax_surface():
    """The op name, its arguments and shape inference as the JAX
    package's; a JAX symbol with the op loads (``sym.load_json`` no
    longer refuses it) and runs equal to the JAX executor."""
    op = mt.ops.registry.get_op("LoraGatherDelta")
    assert op.arg_names == jreg.get_op("LoraGatherDelta").arg_names
    names = ("base", "h", "a_slab", "b_slab", "slots")
    shapes = dict(base=(2, 3, 96), h=(2, 3, 32), a_slab=(3, 2, 32, 4),
                  b_slab=(3, 2, 4, 96), slots=(2,))
    jsym = mx.sym.LoraGatherDelta(*(mx.sym.Variable(n) for n in names),
                                  layer=1, name="lora")
    tsym = mt.sym.load_json(jsym.tojson())
    assert tsym.infer_shape(**shapes)[1] == jsym.infer_shape(**shapes)[1] \
        == [(2, 3, 96)]
    rng = np.random.RandomState(4)
    a, b = _slabs(rng, N=3, rb=4, ranks=(4, 2))
    vals = dict(base=rng.randn(2, 3, 96).astype(np.float32),
                h=rng.randn(2, 3, 32).astype(np.float32), a_slab=a,
                b_slab=b, slots=np.array([2, 0], np.int32))
    jout = jsym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in
                                vals.items()}).forward()[0].asnumpy()
    tout = tsym.bind(CPU, {k: mt.nd.array(v, ctx=CPU) for k, v in
                           vals.items()}).forward()[0].asnumpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# TransformerLM(lora=) against the JAX graphs
# ---------------------------------------------------------------------------

LORA = (4, 8)
P = 12


def _lora_feeds(rng, slot_vecs):
    """Slabs of 3 slots a bucket and the per-bucket slot vectors: JAX
    feeds and the port's ``adapter`` tuple."""
    feeds, adapter = {}, []
    for rb, vec in zip(LORA, slot_vecs):
        a, b = _slabs(rng, N=3, rb=rb, ranks=(rb, rb // 2))
        feeds.update({f"adapter_a_r{rb}": a, f"adapter_b_r{rb}": b,
                      f"adapter_slots_r{rb}": np.asarray(vec, np.int32)})
        adapter += [torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(np.asarray(vec, np.int32))]
    return feeds, tuple(adapter)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


_GRAPHS = {}


def _graph(host, sym_fn, name, **kw):
    """``jax_graph`` with ``lora=LORA``, built and jitted once a kind."""
    key = (sym_fn.__name__, name)
    if key not in _GRAPHS:
        _GRAPHS[key] = jax_graph(sym_fn, host, name, lora=LORA, **kw)
    return _GRAPHS[key]


@pytest.mark.parametrize("name", ["fp32", "int8"])
@pytest.mark.parametrize("entry", ["prefill", "suffix_prefill", "decode",
                                   "verify"])
def test_transformer_lora_entry_points_match_jax_graphs(lm, name, entry):
    host, _ = lm
    port = mt.models.transformer.TransformerLM(
        mt.params_from_numpy(host, "cpu"), num_layers=L, num_heads=2,
        kv_block=KVB, lora=LORA)
    rng = np.random.RandomState(7)
    t_pools, j_pools = fresh_pools(name, P)
    table = np.array([[7, 2, 11, 5], [3, 9, 4, 1], [6, 8, 10, 0]], np.int32)
    # rows: bucket 4 slot 1, plain, bucket 8 slot 2
    feeds, adapter = _lora_feeds(rng, ([1, 0, 0], [0, 0, 2]))
    # every row first writes a 6-token prompt through the plain prefill
    pre = _graph(host, transformer_lm_prefill, name, paged=True)
    prompt = rng.randint(1, V, size=(3, 8)).astype(np.int32)
    f0 = dict(feeds, data=prompt,
              positions=np.tile(np.arange(8, dtype=np.int32), (3, 1)),
              lengths=np.array([6, 6, 6], np.int32), block_table=table[:, :2])
    pre_args = [_t(f0[k]) for k in ("data", "positions", "lengths",
                                    "block_table")]
    j_logits, j_pools = run_graph(pre, f0, j_pools)
    t_logits = port.prefill(*pre_args, t_pools, adapter)
    np.testing.assert_allclose(t_logits.numpy()[:, :6], j_logits[:, :6],
                               **TOL)
    if entry == "prefill":
        # the plain row: the model without adapters, bit for bit
        plain = port.prefill(*pre_args, fresh_pools(name, P)[0])
        assert plain[1].numpy().tobytes() == t_logits[1].numpy().tobytes()
        # a bucket whose slots are None (no row there) is skipped: the
        # same bits as its slot vector of zeros
        _, zero8 = _lora_feeds(np.random.RandomState(7), ([1, 0, 0],
                                                          [0, 0, 0]))
        skip8 = zero8[:5] + (None,)
        a = port.prefill(*pre_args, fresh_pools(name, P)[0], zero8)
        b = port.prefill(*pre_args, fresh_pools(name, P)[0], skip8)
        assert a.numpy().tobytes() == b.numpy().tobytes()
        return
    # both packages go on from the same pool bytes
    j_pools = [jnp.asarray(p.numpy()) for p in t_pools]
    if entry == "decode":
        graph = _graph(host, transformer_lm_decode, name, paged=True)
        f = dict(feeds, data=rng.randint(1, V, size=(3, 1)).astype(np.int32),
                 positions=np.full((3, 1), 6, np.int32),
                 lengths=np.full((3,), 7, np.int32), block_table=table)
        args = [_t(f[k]) for k in ("data", "positions", "lengths",
                                   "block_table")]
        rows = slice(None), slice(None)
    elif entry == "verify":
        graph = _graph(host, transformer_lm_verify, name)
        f = dict(feeds, data=rng.randint(1, V, size=(3, 4)).astype(np.int32),
                 positions=np.tile(6 + np.arange(4, dtype=np.int32), (3, 1)),
                 start=np.full((3,), 6, np.int32),
                 lengths=np.array([10, 9, 10], np.int32), block_table=table)
        args = [_t(f[k]) for k in ("data", "positions", "start", "lengths",
                                   "block_table")]
        rows = slice(None), slice(0, 3)
    else:
        graph = _graph(host, transformer_lm_prefix_prefill, name)
        f = dict(feeds, data=rng.randint(1, V, size=(3, 4)).astype(np.int32),
                 positions=np.tile(4 + np.arange(4, dtype=np.int32), (3, 1)),
                 start=np.full((3,), 4, np.int32),
                 lengths=np.full((3,), 8, np.int32), block_table=table)
        args = [_t(f["data"]), _t(f["positions"]), 4, _t(f["lengths"]),
                _t(f["block_table"])]
        rows = slice(None), slice(None)
    j_logits, _ = run_graph(graph, f, j_pools)
    t_logits = getattr(port, entry)(*args, t_pools, adapter)
    np.testing.assert_allclose(t_logits.numpy()[rows], j_logits[rows], **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _adapters(rng, n=4):
    """n adapters over both rank buckets, alpha 2r (scale 2)."""
    out = {}
    for i, r in zip(range(n), (2, 4, 4, 8)):
        out[f"ad{i}"] = (rng.randn(L, DM, r).astype(np.float32) * 0.25,
                         rng.randn(L, r, 3 * DM).astype(np.float32) * 0.25,
                         2.0 * r)
    return out


def _merged(host, a, b, alpha):
    """The merged-weights model: ``W + scale (A_i B_i)^T`` on each
    layer's fused QKV weight."""
    scale = float(alpha) / a.shape[2]
    out = dict(host)
    for i in range(L):
        w = host[f"layer{i}_qkv_weight"]
        out[f"layer{i}_qkv_weight"] = (w + (a[i] @ b[i] * scale).T).astype(
            w.dtype)
    return out


def _pools(**kw):
    """A JAX pool and a port pool of the same geometry."""
    args = dict(num_layers=L, d_model=DM, slots=4, rank_buckets=(4, 8))
    args.update(kw)
    return jad.AdapterPool(**args), tad.AdapterPool(**args, ctx=CPU)


def _run(eng, jobs):
    """Submit [(prompt, max_new, submit kw)] together → outputs."""
    futs = [eng.submit(p, n, **kw) for p, n, kw in jobs]
    return [np.asarray(f.result(timeout=300)) for f in futs]


def _agree(host_for, jobs, ref, got):
    """The margin rule per adapter: each job's chain against the JAX
    engine's, reference rows from its own (merged) model."""
    groups = {}
    for i, (p, n, kw) in enumerate(jobs):
        groups.setdefault(kw.get("adapter"), []).append(i)
    for ad, idx in groups.items():
        assert_chains_agree(host_for(ad), [jobs[i][:2] for i in idx],
                            [ref[i] for i in idx], [got[i] for i in idx])


def test_plain_streams_bitwise_equal_the_pre_adapter_engine(lm):
    """No adapter in the request, an adapter pool in the engine (one
    adapter published and idle): every token, greedy and sampled, is the
    pre-adapter port engine's; and they agree with the JAX engine's."""
    host, _ = lm
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, V, size=n).astype(np.int32) for n in (3, 7, 11)]
    jobs = [(p, 6, dict(temperature=t, seed=100 + i))
            for i, p in enumerate(prompts) for t in (0.0, 0.9)]
    jpool, tpool = _pools()
    a, b = _ab(np.random.RandomState(8), scale=1.0)
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU)) as e0, \
            mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU,
                                              adapters=tpool)) as e1:
        e1.publish_adapter("idle", a, b)
        before = [e0.generate(p, n, **kw) for p, n, kw in jobs]
        after = [e1.generate(p, n, **kw) for p, n, kw in jobs]
        mixed = _run(e1, jobs)
    for x, y, z in zip(before, after, mixed):
        assert x.tobytes() == y.tobytes() == z.tobytes()
    with mx.DecodeEngine(host, **engine_kw(**FEW, adapters=jpool)) as je:
        je.publish_adapter("idle", a, b)
        ref = [je.generate(p, n, **kw) for p, n, kw in jobs[::2]]
    assert_chains_agree(host, [(p, n) for p, n, _ in jobs[::2]], ref,
                        after[::2])


@pytest.fixture(scope="module")
def four(lm):
    """Four adapters, the jobs of the solo/mixed case and the JAX
    engine's chains, solo and mixed (one JAX engine)."""
    host, _ = lm
    rng = np.random.RandomState(11)
    ads = _adapters(rng)
    prompts = [rng.randint(1, V, size=n).astype(np.int32) for n in (5, 9)]
    jobs = [(p, 6, dict(adapter=name, tenant=name and f"tn-{name}"))
            for p in prompts for name in list(ads) + [None]]
    jpool, _ = _pools()
    with mx.DecodeEngine(host, **engine_kw(**FEW, adapters=jpool)) as je:
        for name, (a, b, alpha) in ads.items():
            je.publish_adapter(name, a, b, alpha=alpha)
        solo = [je.generate(p, n, **kw) for p, n, kw in jobs]
        mixed = _run(je, jobs)
        jst = je.stats()
    return ads, jobs, solo, mixed, jst


def test_adapter_streams_solo_and_mixed_agree_with_jax(lm, four):
    """Four adapters over one base: each stream agrees with the JAX
    engine's (the merged-weights model's margins), solo and in a mixed
    batch; within the port the mixed batch equals the solo runs bit for
    bit (batch composition never changes tokens); per-tenant requests
    and the pool's counters equal the JAX engine's."""
    host, _ = lm
    ads, jobs, jsolo, jmixed, jst = four
    _, tpool = _pools()
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU,
                                           adapters=tpool)) as te:
        for name, (a, b, alpha) in ads.items():
            te.publish_adapter(name, a, b, alpha=alpha)
        solo = [te.generate(p, n, **kw) for p, n, kw in jobs]
        mixed = _run(te, jobs)
        st = te.stats()

    def host_for(ad):
        return host if ad is None else _merged(host, *ads[ad])

    _agree(host_for, jobs, jsolo, solo)
    _agree(host_for, jobs, jmixed, mixed)
    for x, y in zip(solo, mixed):
        assert x.tobytes() == y.tobytes()
    # the adapters move the chains off the base's
    assert sum(not np.array_equal(x, solo[4]) for x in solo[:4]) >= 3
    assert st["adapters"] == jst["adapters"]
    assert st["adapter_rank_buckets"] == jst["adapter_rank_buckets"] \
        == [4, 8]
    assert st["tenants"] == {t: {k: v for k, v in d.items()
                                 if k in ("requests", "tokens",
                                          "generations")}
                             for t, d in jst["tenants"].items()}
    assert st["tenants"]["tn-ad0"]["requests"] == 4
    assert st["adapter_publishes"] == 4


def test_adapters_compose_with_prefix_spec_and_preemption(lm):
    """Prefix cache, n-gram speculation and a pool small enough to
    preempt, both engines: every chain agrees with the JAX engine's, the
    adapter stream survives preemption with its slot pinned, and the
    counters of hits, preemptions and the pool equal JAX's."""
    host, _ = lm
    rng = np.random.RandomState(13)
    a, b = _ab(rng, scale=0.25)
    prompt = np.asarray([3, 9, 3, 9, 3, 9, 4, 4], np.int32)
    load = [rng.randint(1, V, size=9).astype(np.int32) for _ in range(4)]
    kw = dict(spec_tokens=2, cache_blocks=12)
    phases = [[(prompt, 5, dict(tenant="t", adapter="x"))],
              [(prompt, 5, {})]] * 2 + \
        [[(p, 12, dict(adapter="x" if i % 2 else None,
                       tenant="t" if i % 2 else None))
          for i, p in enumerate(load)],
         [(prompt, 5, dict(tenant="t", adapter="x"))]]
    outs, stats = {}, {}
    for pkg, eng_cls, extra in (
            ("jax", mx.DecodeEngine, dict(prefix_cache=1)),
            ("port", mt.DecodeEngine, dict(ctx=CPU))):
        pool = _pools(slots=2, rank_buckets=(4,))[pkg == "port"]
        with eng_cls(host, **engine_kw(**FEW, adapters=pool, **kw,
                                       **extra)) as e:
            e.publish_adapter("x", a, b, alpha=8.0)
            outs[pkg] = [o for ph in phases for o in _run(e, ph)]
            stats[pkg] = e.stats()
    jobs = [j for ph in phases for j in ph]
    merged = _merged(host, a, b, 8.0)
    _agree(lambda ad: merged if ad else host, jobs, outs["jax"],
           outs["port"])
    sj, st = stats["jax"], stats["port"]
    assert st["preempted"] >= 1 and st["prefix_hits"] >= 2
    for k in ("prefix_hits", "prefix_hit_tokens", "adapters", "tenants"):
        assert st[k] == sj[k], k


def test_prefix_cache_is_namespaced_by_adapter(lm):
    """A prompt prefilled plain never serves an adapter stream, nor the
    adapter's chains a plain one; retire then republish of the same
    name with other weights drops the old chains.  Hits at every stage
    equal the JAX engine's, and the chains agree by the margin rule."""
    host, _ = lm
    rng = np.random.RandomState(31)
    (a1, b1), (a2, b2) = _ab(rng, scale=0.25), _ab(rng, scale=0.25)
    prompt = rng.randint(1, V, size=9).astype(np.int32)
    logs = {}
    for pkg, eng_cls, extra in (("jax", mx.DecodeEngine, {}),
                                ("port", mt.DecodeEngine, dict(ctx=CPU))):
        pool = _pools(slots=2, rank_buckets=(4,))[pkg == "port"]
        out = []
        with eng_cls(host, **engine_kw(**FEW, adapters=pool, prefix_cache=1,
                                       **extra)) as e:
            e.publish_adapter("x", a1, b1, alpha=4.0)
            for step, kw in (("plain", {}), ("x", dict(adapter="x")),
                             ("plain again", {}), ("x again",
                                                   dict(adapter="x"))):
                g = e.generate(prompt, 5, **kw)
                out.append((step, g, e.stats()["prefix_hits"]))
            out.append(("retire", e.retire_adapter("x")))
            e.publish_adapter("x", a2, b2, alpha=4.0)
            g = e.generate(prompt, 5, adapter="x")
            st = e.stats()
            out.append(("republished", g, st["prefix_hits"],
                        st["adapters"]["publishes"],
                        st["adapters"]["retires"]))
            if pkg == "port":
                assert (st["adapter_publishes"], st["adapter_retires"]) \
                    == (2, 1)
        logs[pkg] = out
    hits = [r[2] for r in logs["port"] if len(r) > 2]
    assert hits == [r[2] for r in logs["jax"] if len(r) > 2]
    # plain: miss; x: miss (other salt); plain again: hit; x again: hit;
    # republished x: miss (the old chain dropped)
    assert hits == [0, 0, 1, 2, 2]
    assert logs["port"][4] == logs["jax"][4] == ("retire", True)
    assert logs["port"][5][3:] == logs["jax"][5][3:] == (2, 1)
    models = [host, _merged(host, a1, b1, 4.0), host,
              _merged(host, a1, b1, 4.0), None,
              _merged(host, a2, b2, 4.0)]
    for i, m in enumerate(models):
        if m is not None:
            assert_chains_agree(m, [(prompt, 5)], [logs["jax"][i][1]],
                                [logs["port"][i][1]])


def test_adapter_over_int8_pages_agrees_with_jax(lm):
    """int8 pages: the adapter stream against the JAX engine's by
    ``QMARGIN`` (the reference rows: the JAX quantized graphs of the
    merged model), and the merged model's own port engine."""
    host, _ = lm
    rng = np.random.RandomState(17)
    a, b = _ab(rng, scale=0.25)
    prompt = rng.randint(1, V, size=6).astype(np.int32)
    got = {}
    for pkg, eng_cls, extra in (("jax", mx.DecodeEngine, dict(prefix_cache=0)),
                                ("port", mt.DecodeEngine, dict(ctx=CPU))):
        pool = _pools(slots=2, rank_buckets=(4,))[pkg == "port"]
        with eng_cls(host, **engine_kw(**FEW, adapters=pool, kv_dtype="int8",
                                       **extra)) as e:
            e.publish_adapter("x", a, b, alpha=8.0)
            got[pkg] = e.generate(prompt, 6, adapter="x")
    merged = _merged(host, a, b, 8.0)
    assert_chains_agree(merged, [(prompt, 6)], [got["jax"]], [got["port"]],
                        "int8")
    rows = jax_quant_chain_rows(merged, "int8", prompt, got["port"])
    with mt.DecodeEngine(merged, **engine_kw(**FEW, ctx=CPU,
                                             kv_dtype="int8")) as e:
        ref = e.generate(prompt, 6)
    for i in range(6):
        top2 = np.sort(rows[i])[-2:]
        if top2[1] - top2[0] <= QMARGIN:
            break
        assert ref[i] == got["port"][i]


def test_hot_publish_and_retire_under_load(lm):
    """Adapters published, served and retired while plain traffic runs
    on another thread: no request fails, nothing is shed, a retired name
    refuses new streams with the JAX engine's error; the pool's counters
    after the sequence equal the JAX engine's, and each adapter's
    output agrees with the JAX engine's by the margin rule."""
    host, _ = lm
    rng = np.random.RandomState(19)
    gens = [_ab(rng, scale=0.2) for _ in range(4)]
    prompt = np.asarray([5, 4, 3, 2], np.int32)
    logs = {}
    for pkg, eng_cls, extra in (("jax", mx.DecodeEngine, {}),
                                ("port", mt.DecodeEngine, dict(ctx=CPU))):
        pool = _pools(slots=3, rank_buckets=(4,))[pkg == "port"]
        err = mx.MXNetError if pkg == "jax" else mt.MXNetError
        stop, failures, out = threading.Event(), [], []
        with eng_cls(host, **engine_kw(**FEW, adapters=pool, **extra)) as e:
            def load():
                r, i = np.random.RandomState(5), 0
                while not stop.is_set():
                    try:
                        e.generate(r.randint(1, V, size=4).astype(np.int32),
                                   4, seed=i)
                    except BaseException as exc:  # noqa: BLE001
                        failures.append(exc)
                        return
                    i += 1

            t = threading.Thread(target=load, daemon=True)
            t.start()
            try:
                for g, (a, b) in enumerate(gens):
                    e.publish_adapter(f"gen{g}", a, b, alpha=4.0)
                    out.append(e.generate(prompt, 4, adapter=f"gen{g}",
                                          tenant="hot"))
                    e.retire_adapter(f"gen{g}")
                    with pytest.raises(err) as ei:
                        e.generate(prompt, 4, adapter=f"gen{g}")
                    out.append(str(ei.value))
            finally:
                stop.set()
                t.join(timeout=60)
            st = e.stats()
        assert not failures, failures
        assert st["shed"] == 0 and st["shed_tenant_quota"] == 0
        if pkg == "port":
            assert (st["adapter_publishes"], st["adapter_retires"]) == (4, 4)
        logs[pkg] = (out, st["adapters"])
    assert logs["port"][1:] == logs["jax"][1:]
    assert logs["port"][0][1::2] == logs["jax"][0][1::2]
    for g, (a, b) in enumerate(gens):
        assert_chains_agree(_merged(host, a, b, 4.0), [(prompt, 4)],
                            [logs["jax"][0][2 * g]], [logs["port"][0][2 * g]])


def test_pool_slabs_are_written_in_place(lm):
    """Publishes, evictions and retires write rows of the same slab
    tensors: ``slabs()`` hands out one set of tensors for the pool's
    life, and a held slot's rows never change while a stream holds it."""
    _, tpool = _pools(slots=2, rank_buckets=(4,))
    rng = np.random.RandomState(2)
    first = tpool.slabs()
    tpool.publish("a", *_ab(rng))
    _, slot = tpool.acquire("a")
    held = [s[slot].clone() for s in first]
    for n in ("b", "c", "d"):  # evicts b, then c: never a's held slot
        tpool.publish(n, *_ab(rng))
    tpool.retire("c")
    now = tpool.slabs()
    assert all(x is y for x, y in zip(first, now))
    assert all(torch.equal(s[slot], h) for s, h in zip(now, held))
    assert not first[0][0].any() and not first[1][0].any()
    assert tpool.stats()["evictions"] == 2


def test_tenant_quota_sheds_typed_with_counters_equal_to_jax(lm):
    host, _ = lm
    prompt = np.asarray([1, 2, 3], np.int32)  # 3 + 5 = 8 tokens a request
    got = {}
    for pkg, eng_cls, mod, extra in (
            ("jax", mx.DecodeEngine, jad, {}),
            ("port", mt.DecodeEngine, tad, dict(ctx=CPU))):
        with eng_cls(host, **engine_kw(**FEW, tenant_quota=mod.TenantQuota(20),
                                       **extra)) as e:
            out = [e.generate(prompt, 5, tenant="small"),
                   e.generate(prompt, 5, tenant="small")]
            with pytest.raises(mod.QuotaExceededError) as ei:
                e.submit(prompt, 5, tenant="small")
            out.append((str(ei.value), ei.value.reason, ei.value.needed,
                        ei.value.balance))
            out.append(e.generate(prompt, 5, tenant="big"))
            st = e.stats()
        got[pkg] = (out, st["shed"], st["shed_tenant_quota"],
                    {t: {k: d[k] for k in ("requests", "shed", "balance",
                                           "charged", "tokens")
                         if k in d} for t, d in st["tenants"].items()},
                    st["requests"])
    assert got["port"][1:] == got["jax"][1:]
    assert got["port"][0][2] == got["jax"][0][2]
    assert got["port"][1] == got["port"][2] == 1
    assert got["port"][3]["small"]["requests"] == 2
    assert got["port"][3]["small"]["balance"] == 4
    assert_chains_agree(host, [(prompt, 5)] * 3,
                        [got["jax"][0][i] for i in (0, 1, 3)],
                        [got["port"][0][i] for i in (0, 1, 3)])


def test_interactive_admission_jumps_the_batch_queue(lm):
    """One decode seat: an interactive request queued behind two batch
    requests is admitted first, in both engines; an unknown class is
    refused with the JAX engine's error."""
    host, _ = lm
    prompt = np.asarray([2, 4, 6], np.int32)
    orders, errors = {}, {}
    for pkg, eng_cls, extra in (("jax", mx.DecodeEngine, {}),
                                ("port", mt.DecodeEngine, dict(ctx=CPU))):
        order, lock = [], threading.Lock()

        def tag(name):
            def cb(_f):
                with lock:
                    order.append(name)
            return cb

        with eng_cls(host, **engine_kw(max_streams=1, decode_buckets=[1],
                                       **extra)) as e:
            f0 = e.submit(prompt, 10)  # holds the only seat
            time.sleep(0.05)
            futs = [(e.submit(prompt, 2, slo_class="batch"), "batch1"),
                    (e.submit(prompt, 2, slo_class="batch"), "batch2"),
                    (e.submit(prompt, 2, slo_class="interactive"), "inter")]
            for f, n in futs:
                f.add_done_callback(tag(n))
            for f in [f0] + [f for f, _ in futs]:
                f.result(timeout=120)
            try:
                e.submit(prompt, 2, slo_class="bulk")
            except (mx.MXNetError, mt.MXNetError) as exc:
                errors[pkg] = str(exc)
        orders[pkg] = order
    for order in orders.values():
        assert order.index("inter") < order.index("batch1")
        assert order.index("inter") < order.index("batch2")
    assert orders["port"] == orders["jax"]
    assert errors["port"] == errors["jax"]


def test_preemption_takes_batch_streams_first(lm):
    """Under page pressure the victim is a batch stream whenever one
    other than the stream asking for the page is active
    (``_alloc_with_preempt``, ``mxnet_tpu/serving.py:2799-2803``)."""
    host, _ = lm
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, V, size=9).astype(np.int32) for _ in range(4)]
    classes = ["batch", "batch", "interactive", "interactive"]
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU, cache_blocks=12,
                                           prefix_cache=0)) as e:
        seen, asking = [], []
        grow, preempt = e._alloc_with_preempt, e._preempt

        def alloc(s, n):
            asking.append(s)
            try:
                return grow(s, n)
            finally:
                asking.pop()

        def spy(v):
            others = [o.slo_class for o in e._active if o is not asking[-1]]
            seen.append((v.slo_class, others))
            preempt(v)

        e._alloc_with_preempt, e._preempt = alloc, spy
        # the batch streams decode first; the interactive ones join them
        futs = [e.submit(p, 12, slo_class=c)
                for p, c in zip(prompts[:2], classes[:2])]
        while e.stats()["active_streams"] < 2:
            time.sleep(0.002)
        futs += [e.submit(p, 12, slo_class=c)
                 for p, c in zip(prompts[2:], classes[2:])]
        outs = [f.result(timeout=300) for f in futs]
    assert seen
    for victim, others in seen:
        assert victim == "batch" or "batch" not in others, (victim, others)
    assert any(v == "batch" for v, _ in seen)
    assert all(o.shape == (12,) for o in outs)


def test_engine_refusals_match_jax(lm):
    """No pool: a request naming an adapter and publish/retire raise;
    a pool of another geometry, a non-pool ``adapters`` and a pool on
    another device are refused at construction, with the JAX engine's
    words where it has the case."""
    host, _ = lm
    msgs = {}
    for pkg, eng_cls, mod, extra in (
            ("jax", mx.DecodeEngine, jad, {}),
            ("port", mt.DecodeEngine, tad, dict(ctx=CPU))):
        out = []
        with eng_cls(host, **engine_kw(**FEW, **extra)) as e:
            for fn in (lambda: e.submit(np.asarray([1, 2], np.int32), 2,
                                        adapter="x"),
                       lambda: e.publish_adapter(
                           "x", np.zeros((L, DM, 4), np.float32),
                           np.zeros((L, 4, 3 * DM), np.float32)),
                       lambda: e.retire_adapter("x")):
                with pytest.raises(Exception) as ei:
                    fn()
                out.append(str(ei.value))
        kw = dict(PKGS[pkg]["kw"])
        for bad in (mod.AdapterPool(num_layers=L + 1, d_model=DM, **kw),
                    mod.AdapterPool(num_layers=L, d_model=DM, d_out=DM, **kw),
                    "yes"):
            with pytest.raises(Exception) as ei:
                eng_cls(host, **engine_kw(**FEW, adapters=bad, **extra))
            out.append(str(ei.value))
        msgs[pkg] = out
    assert msgs["port"] == msgs["jax"]
    assert "geometry" in msgs["port"][3]
    elsewhere = tad.AdapterPool(num_layers=L, d_model=DM, ctx=CPU)
    elsewhere.device = torch.device("meta")  # a pool of another device
    with pytest.raises(mt.MXNetError, match="AdapterPool slabs lie on"):
        mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU, adapters=elsewhere))
