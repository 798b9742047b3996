"""The port's serving symbols (``models/transformer.py``:
``transformer_lm_prefill`` / ``_prefix_prefill`` / ``_verify`` /
``_decode``) against the JAX package's on the CPU.

* Each symbol function's arguments, outputs and attributes equal the
  JAX one's (the two JSON documents are equal), over paged and
  contiguous caches, fp32 and int8 pools and a LoRA rank bucket; a JAX
  serving symbol's JSON loads in the port.
* A chain through the port's executor (``build_graph_fn``) and JAX's on
  the same parameters and pools: a 6-token prefill, 3 decode steps, a
  verify window of 3 and a suffix prefill of 3 tokens over 12 cached
  (fp32 / int8 pools, paged and contiguous decode, one LoRA case), the
  pools fed back from each step's outputs: logits and fp32 pools (the
  model's K/V) at rtol = atol = 1e-5 on the real rows, quantized codes as
  ``tests/test_torch_serving_ops.py`` holds them.
* The port's symbols against ``TransformerLM``'s same calls: equal bit
  for bit (the same ops in the same order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jtf
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_graph_fn
from mxnet_tpu_torch.models import transformer as ttf
from test_torch_serving_ops import _check_pools
from torch_serving_parity import (DM, H, KVB, L, V, fresh_pools, jax_graph,
                                  make_lm, run_graph)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
P = 12
TABLE = np.array([[5, 2, 7, 3, 9]], np.int32)
PROMPT = np.array([7, 3, 19, 44, 2, 31], np.int32)
STEPS = (12, 50, 8)           # decode tokens at positions 6, 7, 8
WINDOW = (5, 17, 29)          # verify rows at 9, 10, 11
SUFFIX = (40, 1, 23)          # suffix prefill at 12, 13, 14
SYMBOL_FNS = ("transformer_lm_prefill", "transformer_lm_prefix_prefill",
            "transformer_lm_verify", "transformer_lm_decode")
# every symbol function with each option it takes (paged= is the prefill's and
# the decode's)
CASES = [(b, o) for b in SYMBOL_FNS
         for o in ({}, {"kv_dtype": "int8"}, {"kv_dtype": "fp8"},
                   {"lora": (4, 8)}, {"paged": False})
         if "paged" not in o or b in ("transformer_lm_prefill",
                                      "transformer_lm_decode")]


@pytest.fixture(scope="module")
def lm():
    return make_lm(0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fn,opts", CASES,
                         ids=[f"{b}-{o}" for b, o in CASES])
def test_symbol_interface_equals_jax(fn, opts):
    kw = dict(num_layers=2, num_heads=2, d_model=32, kv_block=4, **opts)
    with mx.name.NameManager(), mt.name.NameManager():
        j = getattr(jtf, fn)(61, **kw)
        t = getattr(ttf, fn)(61, **kw)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.attr_dict() == j.attr_dict()
    assert t.tojson() == j.tojson()
    loaded = mt.sym.load_json(j.tojson())
    assert loaded.list_outputs() == j.list_outputs()
    assert mx.sym.load_json(t.tojson()).list_arguments() \
        == j.list_arguments()


def _adapter(seed=11):
    """LoRA slabs of rank bucket 4 (2 slots), the batch's row in slot 1."""
    rng = np.random.RandomState(seed)
    return {"adapter_a_r4": (rng.randn(2, L, DM, 4) * 0.3).astype(
                np.float32),
            "adapter_b_r4": (rng.randn(2, L, 4, 3 * DM) * 0.3).astype(
                np.float32),
            "adapter_slots_r4": np.array([1], np.int32)}


class _Port:
    """A port serving symbol through its executor's graph function over
    the same host parameters."""

    def __init__(self, host, fn, **kw):
        self.sym = getattr(ttf, fn)(V, num_layers=L, num_heads=H,
                                    d_model=DM, kv_block=KVB, **kw)
        self.gfn = build_graph_fn(self.sym)
        self.base = {n: _t(host[n]) for n in self.sym.list_arguments()
                     if n in host}

    def __call__(self, feeds, pools, names):
        args = dict(self.base)
        args.update({k: _t(v) for k, v in feeds.items()})
        args.update(zip(names, pools))
        outs, _ = self.gfn(args, {}, 0, False)
        return outs[0].numpy(), outs[1:]


def _pool_names(stride, kind="pool"):
    if kind == "cache":
        return [f"layer{i}_{n}" for i in range(L) for n in ("kcache",
                                                            "vcache")]
    names = ("kpool", "vpool", "kscale", "vscale")[:stride]
    return [f"layer{i}_{n}" for i in range(L) for n in names]


@pytest.mark.parametrize("case", ["fp32", "int8", "lora"])
def test_paged_chain_matches_jax(lm, case):
    host, _ = lm
    name = "int8" if case == "int8" else "fp32"
    kw = {"lora": (4,)} if case == "lora" else {}
    extra = _adapter() if case == "lora" else {}
    t_pools, j_pools = fresh_pools(name, P)
    if name == "fp32":  # stale values the masks must keep out
        g = torch.Generator().manual_seed(3)
        for p in t_pools:
            p.copy_(torch.randn(p.shape, generator=g))
        j_pools = [jnp.asarray(p.numpy()) for p in t_pools]
    names = _pool_names(len(t_pools) // L)
    graphs = {fn: (jax_graph(getattr(jtf, fn), host, name, **kw),
                   _Port(host, fn, kv_dtype=name, **kw))
              for fn in SYMBOL_FNS}

    def step(fn, feeds, real):
        nonlocal t_pools, j_pools
        jg, tg = graphs[fn]
        jl, j_pools = run_graph(jg, {**feeds, **extra}, j_pools)
        tl, t_pools = tg({**feeds, **extra}, t_pools, names)
        np.testing.assert_allclose(tl[0, :real], jl[0, :real], **TOL)
        return tl

    data = np.zeros((1, 8), np.int32)
    data[0, :6] = PROMPT
    step("transformer_lm_prefill", dict(
        data=data, positions=np.arange(8, dtype=np.int32)[None],
        lengths=np.array([6], np.int32), block_table=TABLE[:, :2]), 6)
    for i, tok in enumerate(STEPS):
        pos = 6 + i
        step("transformer_lm_decode", dict(
            data=np.array([[tok]], np.int32),
            positions=np.array([[pos]], np.int32),
            lengths=np.array([pos + 1], np.int32), block_table=TABLE), 1)
    step("transformer_lm_verify", dict(
        data=np.array([WINDOW], np.int32),
        positions=np.array([[9, 10, 11]], np.int32),
        start=np.array([9], np.int32), lengths=np.array([12], np.int32),
        block_table=TABLE), 3)
    data = np.zeros((1, 4), np.int32)
    data[0, :3] = SUFFIX
    step("transformer_lm_prefix_prefill", dict(
        data=data, positions=np.arange(12, 16, dtype=np.int32)[None],
        start=np.array([12], np.int32), lengths=np.array([15], np.int32),
        block_table=TABLE), 3)
    _check_pools(j_pools, t_pools, TOL)


def test_contiguous_decode_matches_jax(lm):
    """``paged=False``: the prefill's (B, T, H, D) key/value outputs fill
    (B, C, H, D) caches (stale past the prompt), then decode steps on the
    contiguous-cache op (B8 with ``kv_len = lengths``) feed them back."""
    host, _ = lm
    C = 12
    jpre = jax_graph(jtf.transformer_lm_prefill, host, "fp32", paged=False)
    jdec = jax_graph(jtf.transformer_lm_decode, host, "fp32", paged=False)
    tpre = _Port(host, "transformer_lm_prefill", paged=False)
    tdec = _Port(host, "transformer_lm_decode", paged=False)
    data = np.zeros((1, 8), np.int32)
    data[0, :6] = PROMPT
    feeds = dict(data=data, positions=np.arange(8, dtype=np.int32)[None],
                 lengths=np.array([6], np.int32))
    jl, jkv = run_graph(jpre, feeds, [])
    tl, tkv = tpre(feeds, [], [])
    np.testing.assert_allclose(tl[0, :6], jl[0, :6], **TOL)
    rng = np.random.RandomState(4)
    caches = []
    for jx, tx in zip(jkv, tkv):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        c = rng.randn(1, C, H, DM // H).astype(np.float32)
        c[:, :6] = np.asarray(jx)[:, :6]
        caches.append(c)
    names = _pool_names(2, "cache")
    j_c = [jnp.asarray(c) for c in caches]
    t_c = [_t(c) for c in caches]
    for i, tok in enumerate(STEPS):
        pos = 6 + i
        feeds = dict(data=np.array([[tok]], np.int32),
                     positions=np.array([[pos]], np.int32),
                     lengths=np.array([pos + 1], np.int32))
        fn, base = jdec
        a = dict(base)
        a.update({k: jnp.asarray(v) for k, v in feeds.items()})
        a.update(zip(names, j_c))
        outs = fn(a)
        jl, j_c = np.asarray(outs[0]), list(outs[1:])
        tl, t_c = tdec(feeds, t_c, names)
        np.testing.assert_allclose(tl, jl, **TOL)
    for a, b in zip(t_c, j_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_symbols_equal_transformer_lm(lm, name):
    """The same chain through the port's symbols and ``TransformerLM``'s
    ``prefill`` / ``decode`` / ``verify`` / ``suffix_prefill``: logits
    and pools equal bit for bit."""
    host, model = lm
    pools = {}
    for who in ("sym", "lm"):
        pools[who], _ = fresh_pools(name, P)
    names = _pool_names(len(pools["sym"]) // L)
    syms = {fn: _Port(host, fn, kv_dtype=name) for fn in SYMBOL_FNS}
    data = np.zeros((1, 8), np.int32)
    data[0, :6] = PROMPT
    calls = [("transformer_lm_prefill", "prefill",
              dict(data=data, positions=np.arange(8, dtype=np.int32)[None],
                   lengths=np.array([6], np.int32),
                   block_table=TABLE[:, :2]))]
    for i, tok in enumerate(STEPS):
        calls.append(("transformer_lm_decode", "decode", dict(
            data=np.array([[tok]], np.int32),
            positions=np.array([[6 + i]], np.int32),
            lengths=np.array([7 + i], np.int32), block_table=TABLE)))
    calls.append(("transformer_lm_verify", "verify", dict(
        data=np.array([WINDOW], np.int32),
        positions=np.array([[9, 10, 11]], np.int32),
        start=np.array([9], np.int32), lengths=np.array([12], np.int32),
        block_table=TABLE)))
    suffix = np.zeros((1, 4), np.int32)
    suffix[0, :3] = SUFFIX
    calls.append(("transformer_lm_prefix_prefill", "suffix_prefill", dict(
        data=suffix, positions=np.arange(12, 16, dtype=np.int32)[None],
        start=np.array([12], np.int32), lengths=np.array([15], np.int32),
        block_table=TABLE)))
    for fn, method, feeds in calls:
        got, pools["sym"] = syms[fn](feeds, pools["sym"], names)
        f = {k: _t(v) for k, v in feeds.items()}
        order = [f["data"], f["positions"]] + (
            [f["start"]] if "start" in f else []) + [f["lengths"],
                                                      f["block_table"]]
        want = getattr(model, method)(*order, pools["lm"])
        np.testing.assert_array_equal(got, want.numpy())
    for a, b in zip(pools["sym"], pools["lm"]):
        assert torch.equal(a, b)


def test_serving_symbol_binds_through_the_executor(lm):
    """``bind`` of the int8 prefill symbol over the caller's arrays: the
    executor's forward hands the ops the bound pools themselves, which
    they write in place and return as the cache outputs; the logits are
    ``TransformerLM.prefill``'s."""
    host, model = lm
    s = ttf.transformer_lm_prefill(V, num_layers=L, num_heads=H, d_model=DM,
                                   kv_block=KVB, kv_dtype="int8")
    t_pools, _ = fresh_pools("int8", P)
    data = np.zeros((1, 8), np.int32)
    data[0, :6] = PROMPT
    feeds = dict(data=data, positions=np.arange(8, dtype=np.int32)[None],
                 lengths=np.array([6], np.int32), block_table=TABLE[:, :2])
    args = {n: mt.nd.array(host[n], mt.cpu()) for n in s.list_arguments()
            if n in host}
    args.update({k: mt.nd.array(v, mt.cpu()) for k, v in feeds.items()})
    pools = [p.clone() for p in t_pools]
    args.update({n: mt.nd.NDArray(p, mt.cpu()) for n, p in zip(
        _pool_names(4), pools)})
    ex = s.bind(mt.cpu(), args, grad_req="null")
    outs = ex.forward()
    assert outs[1]._data.data_ptr() == pools[0].data_ptr()
    assert bool(pools[0][5].any())  # page 5 holds the prompt's codes now
    want = model.prefill(*(_t(feeds[k]) for k in ("data", "positions",
                                                  "lengths",
                                                  "block_table")), t_pools)
    np.testing.assert_array_equal(outs[0].asnumpy(), want.numpy())
    for a, b in zip(pools, t_pools):
        assert torch.equal(a, b)
