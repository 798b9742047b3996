"""The port's DecodeEngine against the JAX package's, and the port's own
serving contracts.

Both engines serve the same converted parameters on the CPU.  Greedy
chains are compared token for token wherever the JAX full forward's
top-2 logit margin at that position exceeds 1e-4, so a near-tie decided
by summation order cannot decide the test; a chain is compared up to
its first such near-tie.  Logits are compared at the fp32 tolerance
rtol=atol=1e-5 (the two packages sum the same network in other orders).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models
from mxnet_tpu.executor import build_graph_fn
from mxnet_tpu.models.transformer import transformer_lm_prefill
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kv_cache import (BlockAllocator, blocks_for_tokens,
                                      bucket_ladder, kv_storage_dtype)
from mxnet_tpu_torch.models.transformer import TransformerLM

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
V, KVB, L, H, DM, MAXLEN = 61, 4, 2, 2, 32, 32
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def lm():
    sym = models.transformer_lm(V, MAXLEN, num_layers=L, num_heads=H,
                                d_model=DM, block_size=KVB)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, MAXLEN))],
             label_shapes=[("softmax_label", (2, MAXLEN))],
             for_training=False)
    mod.init_params(mx.initializer.Xavier(factor_type="in", magnitude=2.0))
    arg, aux = mod.get_params()
    params = {k: v.asnumpy() for k, v in {**arg, **aux}.items()}
    params["pos_embed_weight"] = (np.random.RandomState(7).randn(
        MAXLEN, DM) * 0.5).astype(np.float32)

    s = transformer_lm_prefill(V, num_layers=L, num_heads=H, d_model=DM,
                               kv_block=KVB, paged=False)
    gfn = build_graph_fn(s)
    base = {n: jnp.asarray(params[n]) for n in s.list_arguments()
            if n in params}

    def jax_logits(seq):
        T = len(seq)
        a = dict(base)
        a.update(data=jnp.asarray(np.asarray(seq, np.int32)[None]),
                 positions=jnp.asarray(np.arange(T, dtype=np.int32)[None]),
                 lengths=jnp.asarray(np.asarray([T], np.int32)))
        outs, _ = gfn(a, {}, jax.random.PRNGKey(0), False)
        return np.asarray(outs[0][0])

    port = TransformerLM(mt.params_from_numpy(params, "cpu"), num_layers=L,
                         num_heads=H, kv_block=KVB)
    return params, jax_logits, port


def _kw(**over):
    kw = dict(vocab_size=V, num_layers=L, num_heads=H, d_model=DM,
              max_len=MAXLEN, kv_block=KVB, max_streams=4,
              decode_buckets=[1, 2, 4], temperature=0.0)
    kw.update(over)
    return kw


def _serve(engine_cls, params, jobs, **over):
    """Submit ``jobs`` [(prompt, max_new)] together; results + stats."""
    with engine_cls(params, **_kw(**over)) as eng:
        futs = [eng.submit(p, n) for p, n in jobs]
        outs = [np.asarray(f.result(timeout=300)) for f in futs]
        return outs, eng.stats()


def _assert_chains_agree(lm, jobs, j_outs, t_outs):
    _, jax_logits, port = lm
    compared, total = 0, sum(len(jo) for jo in j_outs)
    for (prompt, _), jo, to in zip(jobs, j_outs, t_outs):
        assert len(jo) == len(to)
        seq = np.concatenate([prompt, jo]).astype(np.int32)
        jl = jax_logits(seq)
        tl = port(torch.from_numpy(seq)[None].long())[0].numpy()
        np.testing.assert_allclose(tl, jl, **TOL)
        for i in range(len(jo)):
            row = jl[len(prompt) + i - 1]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break  # a near-tie: later tokens condition on it
            assert to[i] == jo[i], (prompt, i, jo, to)
            compared += 1
    assert compared * 2 >= total  # near-ties must stay rare


def test_greedy_one_prompt_matches_jax_engine(lm):
    params = lm[0]
    jobs = [(np.array([3, 17, 42, 5, 9], np.int32), 12)]
    j_outs, _ = _serve(mx.DecodeEngine, params, jobs, prefix_cache=0)
    t_outs, st = _serve(mt.DecodeEngine, params, jobs, ctx=mt.cpu())
    _assert_chains_agree(lm, jobs, j_outs, t_outs)
    assert st["generations"] == 1 and st["tokens"] == 12
    assert st["prefill_tokens"] == 5 and st["prefills"] == 1


def test_greedy_streams_join_and_retire_match_jax_engine(lm):
    """Six requests over max_streams=4 with different lengths: streams
    retire at different steps and queued ones join the running batch."""
    params = lm[0]
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(1, V, size=n).astype(np.int32), m)
            for n, m in ((3, 9), (7, 4), (2, 13), (5, 6), (9, 10), (4, 3))]
    j_outs, _ = _serve(mx.DecodeEngine, params, jobs, prefix_cache=0)
    t_outs, st = _serve(mt.DecodeEngine, params, jobs, ctx=mt.cpu())
    _assert_chains_agree(lm, jobs, j_outs, t_outs)
    assert st["generations"] == 6 and st["active_streams"] == 0
    assert st["cache_util"] == 0.0
    # one device-to-host copy per prefill and per decode step
    assert st["d2h_syncs"] == st["prefills"] + st["steps"]
    assert st["tokens"] == sum(m for _, m in jobs)


def test_greedy_under_preemption_matches_jax_engine(lm):
    params = lm[0]
    jobs = [(np.arange(1, 6, dtype=np.int32), 14),
            (np.arange(7, 12, dtype=np.int32), 14),
            (np.arange(13, 18, dtype=np.int32), 14)]
    over = dict(max_streams=3, cache_blocks=10)
    j_outs, _ = _serve(mx.DecodeEngine, params, jobs, prefix_cache=0,
                       **over)
    t_outs, st = _serve(mt.DecodeEngine, params, jobs, ctx=mt.cpu(), **over)
    assert st["preempted"] > 0
    _assert_chains_agree(lm, jobs, j_outs, t_outs)


def test_temperature_sampling_reproducible_across_batching(lm):
    params = lm[0]
    prompt = np.array([3, 17, 42], np.int32)
    with mt.DecodeEngine(params, **_kw(seed=11, ctx=mt.cpu())) as eng:
        alone = eng.generate(prompt, 8, temperature=0.8)
    with mt.DecodeEngine(params, **_kw(seed=11, ctx=mt.cpu())) as eng:
        futs = [eng.submit(prompt, 8, temperature=0.8),
                eng.submit(np.array([9, 9], np.int32), 8, temperature=0.5),
                eng.submit(np.array([1, 2, 3, 4], np.int32), 5)]
        batched = futs[0].result(timeout=120)
        other = futs[1].result(timeout=120)
    np.testing.assert_array_equal(alone, batched)
    with mt.DecodeEngine(params, **_kw(seed=12, ctx=mt.cpu())) as eng:
        reseeded = eng.generate(prompt, 8, temperature=0.8)
    # another engine seed draws other tokens (8 draws over 61 ids)
    assert not np.array_equal(alone, reseeded)
    assert other.shape == (8,) and np.all((other >= 0) & (other < V))


def test_eos_and_single_token_requests_retire(lm):
    params = lm[0]
    prompt = np.array([3, 17, 42, 5], np.int32)
    with mt.DecodeEngine(params, **_kw(ctx=mt.cpu())) as eng:
        chain = eng.generate(prompt, 8)
        eos = int(chain[3])
        cut = int(np.nonzero(chain == eos)[0][0]) + 1
        stopped = eng.generate(prompt, 8, eos_id=eos)
        one = eng.generate(prompt, 1)  # retires at its prefill
        st = eng.stats()
    np.testing.assert_array_equal(stopped, chain[:cut])
    np.testing.assert_array_equal(one, chain[:1])
    assert st["generations"] == 3 and st["cache_util"] == 0.0


@pytest.mark.parametrize("kwargs,env", [
    ({"prefix_cache": 1}, {}),
    ({}, {"MXNET_SERVING_PREFIX_CACHE": "1"}),
    ({"evict_policy": "lru"}, {}),
    ({"spec_tokens": 2}, {}),
    ({}, {"MXNET_SERVING_SPEC_TOKENS": "2"}),
    ({"proposer": "ngram"}, {}),
    ({"prefill_chunk": 8}, {}),
    ({}, {"MXNET_SERVING_PREFILL_CHUNK": "8"}),
    ({"tp": 2}, {}),
    ({}, {"MXNET_SERVING_PP": "2"}),
    ({"devices": [0]}, {}),
    ({"adapters": True}, {}),
    ({}, {"MXNET_ADAPTER_ENABLE": "1"}),
    ({"tenant_quota": object()}, {}),
    ({}, {"MXNET_TENANT_QUOTA_TOKENS": "100"}),
    ({"kv_dtype": "int8"}, {}),
    ({}, {"MXNET_SERVING_KV_DTYPE": "fp8"}),
    ({"dtype": "bfloat16"}, {}),
], ids=lambda x: ",".join(f"{k}" for k in x) or "-")
def test_unported_features_raise(lm, monkeypatch, kwargs, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(mt.MXNetError, match="not ported yet"):
        mt.DecodeEngine(lm[0], **_kw(ctx=mt.cpu(), **kwargs))


@pytest.mark.parametrize("kwargs", [{"prefill_only": True},
                                    {"tenant": "a"}, {"adapter": "x"},
                                    {"trace": object()}])
def test_unported_request_options_raise(lm, kwargs):
    with mt.DecodeEngine(lm[0], **_kw(ctx=mt.cpu())) as eng:
        with pytest.raises(mt.MXNetError, match="not ported yet"):
            eng.submit(np.array([1, 2], np.int32), 2, **kwargs)
        with pytest.raises(mt.MXNetError, match="not ported yet"):
            eng.swap_params(lm[0])
        with pytest.raises(mt.MXNetError, match="not ported yet"):
            eng.import_stream({})


def test_bf16_pages_serve(lm):
    """kv_dtype='bf16' stores the pools narrow; the chain still comes
    out (its tokens may differ from fp32 pages at near-ties)."""
    with mt.DecodeEngine(lm[0], **_kw(ctx=mt.cpu(), kv_dtype="bf16")) as eng:
        out = eng.generate(np.array([3, 17, 42], np.int32), 6)
        assert eng._pools[0].dtype == torch.bfloat16
    assert out.shape == (6,) and np.all((out >= 0) & (out < V))


def test_submit_validation_and_close(lm):
    eng = mt.DecodeEngine(lm[0], **_kw(ctx=mt.cpu()))
    with pytest.raises(mt.MXNetError, match="non-empty 1-D"):
        eng.submit(np.zeros((2, 3), np.int32), 4)
    with pytest.raises(mt.MXNetError, match="max_len"):
        eng.submit(np.arange(1, 30, dtype=np.int32), 8)
    with pytest.raises(mt.MXNetError, match=">= 1"):
        eng.submit(np.array([1], np.int32), 0)
    eng.close()
    with pytest.raises(mt.EngineClosedError):
        eng.submit(np.array([1], np.int32), 2)


def test_engine_without_ctx_raises_when_no_cuda(lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.DecodeEngine(lm[0], **_kw())
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.gpu(0).torch_device()
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert mt.current_context() == mt.cpu()


# ---------------------------------------------------------------------------
# allocator and ladders (mirroring tests/test_decode.py)
# ---------------------------------------------------------------------------


def test_block_allocator_alloc_free_fragmentation():
    a = BlockAllocator(9, 4)  # 1 scratch + 8 usable
    assert a.capacity == 8 and a.free_blocks == 8
    x = a.alloc(3, owner="x")
    y = a.alloc(2, owner="y")
    assert len(set(x) | set(y)) == 5 and 0 not in x + y
    assert a.used_blocks == 5
    a.free(x)
    with pytest.raises(mt.MXNetError, match="double free|foreign"):
        a.free([x[0]])
    z = a.alloc(4, owner="z")
    assert z is not None and 0 not in z
    assert set(z).isdisjoint(y)
    assert a.alloc(4) is None  # all-or-nothing: 2 left
    assert a.free_blocks == 2
    assert a.alloc(2) is not None
    assert a.utilization() == 1.0
    with pytest.raises(mt.MXNetError, match="scratch"):
        a.free([0])
    with pytest.raises(mt.MXNetError, match=">= 2"):
        BlockAllocator(1, 4)


def test_blocks_for_tokens_and_ladder():
    assert blocks_for_tokens(0, 4) == 0
    assert blocks_for_tokens(1, 4) == 1
    assert blocks_for_tokens(4, 4) == 1
    assert blocks_for_tokens(5, 4) == 2
    assert bucket_ladder(8) == [1, 2, 4, 8]
    assert bucket_ladder(6) == [1, 2, 4, 6]
    assert bucket_ladder(1) == [1]
    with pytest.raises(mt.MXNetError):
        bucket_ladder(0)
    assert kv_storage_dtype("bf16") == torch.bfloat16


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, mxnet_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _port_sources():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), \
                f"{path.name}:{node.lineno} imports {n}"
