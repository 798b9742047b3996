"""The port's chunked prefill against the JAX package on the CPU
(``tests/test_speculative.py:376-440`` and its interleaving case, the
JAX ``slow`` ones kept fast at this size).

Each chunk is a suffix prefill (``TransformerLM.suffix_prefill``, B8's
plain version) over the pages the earlier chunks wrote.  Greedy chains
are held to the JAX engine's by the margin rule of
``torch_serving_parity.py``; within the port, a chunked prefill with the
prefix cache off equals the same chunks with it on bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from torch_serving_parity import (V, OracleProposer, assert_chains_agree,
                                  engine_kw, make_lm)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _port(host, **over):
    return mt.DecodeEngine(host, **engine_kw(ctx=mt.cpu(), **over))


def _jax(host, **over):
    return mx.DecodeEngine(host, **engine_kw(**over))


def test_chunked_prefill_matches_monolithic(lm):
    """A 21-token prompt in chunks of 8 (8 + 8 + 5): three chunks, the
    JAX engine's chain, the port's monolithic chain, and bit for bit the
    same chunks with the prefix cache on."""
    host, _ = lm
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, V, size=21).astype(np.int32)
    with _jax(host, prefill_chunk=8, prefix_cache=0) as e:
        ref = e.generate(prompt, 8)
    with _port(host, prefill_chunk=0) as e:
        whole = e.generate(prompt, 8)
    outs = {}
    for pc in (0, 1):
        with _port(host, prefill_chunk=8, prefix_cache=pc) as e:
            outs[pc] = e.generate(prompt, 8)
            st = e.stats()
        assert st["prefill_chunks"] == 3 and st["prefill_chunk"] == 8
        assert st["prefills"] == 1 and st["prefill_tokens"] == 21
        assert st["prefill_chunk_p50_ms"] is not None
    np.testing.assert_array_equal(outs[0], outs[1])
    jobs = [(prompt, 8)]
    assert_chains_agree(host, jobs, [ref], [outs[1]])
    assert_chains_agree(host, jobs, [ref], [whole])


def test_chunked_prefill_with_prefix_hit(lm):
    """A chunked prefill registers its prompt's pages; the same prompt
    again attaches them, its uncached suffix fits one chunk, and no new
    chunk runs."""
    host, _ = lm
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, V, size=20).astype(np.int32)
    runs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(host, prefill_chunk=8, prefix_cache=1) as e:
            first = e.generate(prompt, 6)
            st1 = e.stats()
            again = e.generate(prompt, 6)
            st2 = e.stats()
        runs[name] = [first, again]
        assert st1["prefill_chunks"] == 3  # 8 + 8 + 4
        assert st2["prefix_hits"] == 1 and st2["prefix_full_hits"] == 1
        assert st2["prefill_chunks"] == st1["prefill_chunks"]
    np.testing.assert_array_equal(runs["port"][0], runs["port"][1])
    assert_chains_agree(host, [(prompt, 6)] * 2, runs["jax"], runs["port"])


def test_chunked_prefill_beyond_prefill_ladder(lm):
    """Chunking admits a prompt longer than the largest prefill bucket
    (24 tokens over buckets [8, 16]): each chunk buckets on its own.
    Without chunking the same ladder refuses the prompt."""
    host, _ = lm
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, V, size=24).astype(np.int32)
    outs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(host, prefill_chunk=8, prefill_buckets=[8, 16]) as e:
            outs[name] = e.generate(prompt, 4)
            assert e.stats()["prefill_chunks"] == 3
    assert_chains_agree(host, [(prompt, 4)], [outs["jax"]], [outs["port"]])
    for make, err in ((_jax, mx.MXNetError), (_port, mt.MXNetError)):
        with make(host, prefill_buckets=[8, 16]) as e:
            with pytest.raises(err, match="prefill bucket"):
                e.submit(prompt, 4)


def _interleave(make, host, long_prompt, chat):
    """A chat stream decoding, then a long prompt submitted while it
    steps: (chat chain, long chain, steps before the long prompt,
    stats)."""
    with make(host, prefill_chunk=4) as e:
        f_chat = e.submit(chat, 16)
        wait = threading.Event()
        for _ in range(500):
            if e.stats()["active_streams"] >= 1:
                break
            wait.wait(0.01)
        steps0 = e.stats()["steps"]
        f_long = e.submit(long_prompt, 6)
        got_chat = f_chat.result(timeout=120)
        got_long = f_long.result(timeout=120)
        return got_chat, got_long, steps0, e.stats()


def test_chunked_prefill_interleaves_with_decode(lm):
    """While a long prompt prefills in chunks, an active stream keeps
    stepping between them: both engines run the same traffic, their
    chains agree by the margin rule, and the port's are its solo
    chains."""
    host, _ = lm
    rng = np.random.RandomState(8)
    long_prompt = rng.randint(1, V, size=24).astype(np.int32)
    chat = rng.randint(1, V, size=6).astype(np.int32)
    with _port(host) as e:
        want_long = e.generate(long_prompt, 6)
        want_chat = e.generate(chat, 16)
    runs = {name: _interleave(make, host, long_prompt, chat)
            for name, make in (("jax", _jax), ("port", _port))}
    got_chat, got_long = runs["port"][:2]
    np.testing.assert_array_equal(want_chat, got_chat)
    jobs = [(chat, 16), (long_prompt, 6)]
    assert_chains_agree(host, jobs, [want_chat, want_long],
                        [got_chat, got_long])
    assert_chains_agree(host, jobs, list(runs["jax"][:2]),
                        [got_chat, got_long])
    for _, _, steps0, st in runs.values():
        assert st["prefill_chunks"] == 2 + 6  # 6 and 24 tokens in 4s
        assert st["steps"] > steps0


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_chunked_prefill_with_spec_tokens(lm, kv_dtype):
    """Chunking composes with speculation and the prefix cache: an
    oracle proposer drafts the known chains (some drafts wrong), the
    chunked prompts prefill in chunks of 8, and a prompt again is a
    prefix hit.  The JAX engine runs the same configuration; the chains
    agree with its by the margin rule (``QMARGIN`` along the chunked
    and hit paths over int8 pages), and the port's equal the port's
    plain engine (the verify step is the decode step row by row)."""
    host, _ = lm
    rng = np.random.RandomState(9)
    jobs = [(rng.randint(1, V, size=n).astype(np.int32), m)
            for n, m in ((19, 9), (5, 12), (13, 8))]
    with _port(host, kv_dtype=kv_dtype, prefix_cache=0) as e:
        want = [e.generate(p, n) for p, n in jobs]
    proposer = OracleProposer(jobs, want)
    runs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        with make(host, kv_dtype=kv_dtype, prefill_chunk=8, spec_tokens=3,
                  proposer=proposer, prefix_cache=1) as e:
            futs = [e.submit(p, n) for p, n in jobs]
            got = [f.result(timeout=120) for f in futs]
            again = e.generate(*jobs[0])  # a prefix hit under speculation
            st = e.stats()
        assert st["prefill_chunks"] == 3 + 2  # 19 = 8 + 8 + 3, 13 = 8 + 5
        assert st["spec_steps"] > 0 and st["spec_accepted"] > 0
        assert st["prefix_hits"] == 1 and st["prefix_hit_tokens"] == 16
        runs[name] = got + [again]
    for w, g in zip(want, runs["port"]):
        np.testing.assert_array_equal(w, g)
    if kv_dtype == "fp32":  # a hit reads int8 pages where a miss did not
        np.testing.assert_array_equal(runs["port"][3], want[0])
    paths = [dict(chunk=8)] * 3 + [dict(chunk=8, cached=16)]
    assert_chains_agree(host, jobs + jobs[:1], runs["jax"], runs["port"],
                        name=kv_dtype, paths=paths)


@pytest.mark.parametrize("env,kw,match", [
    ({"MXNET_SERVING_PREFILL_CHUNK": "-4"}, {}, "PREFILL_CHUNK"),
    ({"MXNET_SERVING_PREFILL_CHUNK": "10"}, {}, "multiple of kv_block"),
    ({"MXNET_SERVING_PREFILL_CHUNK": "banana"}, {}, "PREFILL_CHUNK"),
    ({}, {"prefill_chunk": 6}, "multiple of kv_block"),
    ({}, {"prefill_chunk": -8}, ">= 0"),
    ({}, {"prefill_chunk": 16, "prefill_buckets": [4, 8]},
     "largest prefill bucket"),
], ids=["env_negative", "env_not_multiple", "env_not_int", "not_multiple",
        "negative", "above_ladder"])
def test_chunk_size_validation(lm, monkeypatch, env, kw, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(mx.MXNetError, match=match):
        _jax(lm[0], **kw)
    with pytest.raises(mt.MXNetError, match=match):
        _port(lm[0], **kw)
