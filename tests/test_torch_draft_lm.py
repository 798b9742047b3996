"""The port's draft-LM proposer (``mxnet_tpu_torch/speculative.py``)
and the params-only checkpoints it loads (``checkpoint.publish_params`` /
``load_latest_params``) against the JAX package's, on the CPU.

* Drafts: the port's ``DraftLMProposer`` over the same parameters and
  contexts proposes the JAX proposer's tokens (a full forward over the
  real tokens against the JAX draft's padded fixed-shape forward: the
  same greedy argmax unless the top-2 logits of a draft's row lie within
  ``MARGIN`` 1e-4, where the drafts are compared up to that token),
  including a context longer than the draft's window; drafting is a
  pure function of the context.
* Validation: the env readers, the head count, missing parameters and a
  draft of another vocabulary, with the JAX package's errors.
* Speculation: an engine drafting with the target's own weights and one
  with a 1-layer draft cut from them, both engines, chains agreeing with
  the JAX engine's by the margin rule; the self-draft accepts every
  draft and equals the plain engine bit for bit.
* Checkpoints: ``publish_params`` of each package read by the other's
  ``load_latest_params`` (arrays equal, bf16 included, the newest step,
  a corrupt newest one skipped), and ``draft_lm_from_env`` from a
  directory the JAX package wrote.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.checkpoint as jckpt
from mxnet_tpu.speculative import DraftLMProposer as JaxDraft
from mxnet_tpu.speculative import make_proposer as jax_make_proposer
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.checkpoint as tckpt
from mxnet_tpu_torch.speculative import (DraftLMProposer, draft_lm_from_env,
                                         make_proposer)
from torch_serving_parity import (DM, H, KVB, L, MARGIN, MAXLEN, V,
                                  assert_chains_agree, engine_kw, make_lm)

torch.set_num_threads(1)

CPU = mt.cpu()
FEW = dict(decode_buckets=[4], cache_buckets=[8], prefill_buckets=[32])


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _one_layer(host):
    """A 1-layer draft cut from the target: its embeddings, layer 0, its
    final LayerNorm and its head."""
    return {k: v for k, v in host.items() if not k.startswith("layer1_")}


def _jax_draft(params):
    """The JAX proposer, its fixed-shape graph jitted here (it runs op by
    op otherwise: ~0.6 s a draft token at this size)."""
    import jax

    prop = JaxDraft(params, num_heads=H, kv_block=KVB)
    prop._gfn = jax.jit(prop._gfn, static_argnums=3)
    return prop


@pytest.fixture(scope="module")
def drafts(lm):
    host, port = lm
    return {"self": (_jax_draft(host),
                     DraftLMProposer(host, num_heads=H, kv_block=KVB,
                                     ctx=CPU)),
            "cut": (_jax_draft(_one_layer(host)),
                    DraftLMProposer(_one_layer(host), num_heads=H,
                                    kv_block=KVB, ctx=CPU))}


def _margins(prop, ctx, drafts):
    """Each draft row's top-2 logit margin, from the port's forward."""
    out, seq = [], list(ctx[-max(1, prop.max_len - len(drafts)):])
    for d in drafts:
        row = prop.model(torch.as_tensor(np.asarray(seq, np.int32))[None])[
            0, -1]
        top2 = torch.topk(row, 2).values
        out.append(float(top2[0] - top2[1]))
        seq.append(int(d))
    return out


@pytest.mark.parametrize("which", ["self", "cut"])
def test_drafts_equal_the_jax_proposer(drafts, which):
    """Contexts of 1, 5, 20 and 40 tokens (40 > the 32-position window:
    the tail is kept) and k of 1, 4 and 40 (capped at max_len - 1)."""
    jprop, tprop = drafts[which]
    assert (tprop.vocab_size, tprop.max_len, tprop.num_layers,
            tprop.d_model) == (jprop.vocab_size, jprop.max_len,
                               jprop.num_layers, jprop.d_model) \
        == (V, MAXLEN, L if which == "self" else 1, DM)
    rng = np.random.RandomState(3)
    compared = 0
    for n in (1, 5, 20, 40):
        ctx = rng.randint(1, V, size=n).astype(np.int32)
        for k in (1, 4, 40):
            want = jprop.propose(ctx, k)
            got = tprop.propose(ctx, k)
            assert got.dtype == np.int32 and len(got) == len(want) \
                == min(k, MAXLEN - 1)
            for i, m in enumerate(_margins(tprop, ctx, got)):
                if m <= MARGIN:
                    break
                assert got[i] == want[i], (n, k, i, got, want)
                compared += 1
    assert compared >= 100
    assert tprop.propose(np.empty(0, np.int32), 3).size == 0
    assert tprop.propose(np.array([1, 2], np.int32), 0).size == 0


def test_drafting_is_deterministic(drafts):
    _, tprop = drafts["cut"]
    ctx = np.asarray([3, 1, 4, 1, 5], np.int32)
    before = tprop.forwards
    d1, d2 = tprop.propose(ctx, 4), tprop.propose(ctx, 4)
    np.testing.assert_array_equal(d1, d2)
    # one causal forward a proposed token
    assert tprop.forwards - before == 8


def test_validation_matches_jax(lm, monkeypatch, tmp_path):
    host, _ = lm
    msgs = []
    for ctor in (lambda **kw: JaxDraft(**kw),
                 lambda **kw: DraftLMProposer(**kw, ctx=CPU)):
        out = []
        for kw in (dict(params=host, num_heads=0),
                   dict(params=host, num_heads=3),
                   dict(params={k: v for k, v in host.items()
                                if k != "tok_embed_weight"}, num_heads=H),
                   dict(params={k: v for k, v in host.items()
                                if k != "layer1_ff2_bias"}, num_heads=H)):
            try:
                ctor(**kw)
                out.append("built")
            except (mx.MXNetError, mt.MXNetError) as e:
                out.append(str(e))
        msgs.append(out)
    assert msgs[0][:3] == msgs[1][:3]
    assert "MXNET_SERVING_DRAFT_HEADS" in msgs[1][0]
    assert "MXNET_SERVING_DRAFT_CKPT" in msgs[1][2]
    assert "missing parameters" in msgs[1][3] \
        and "layer1_ff2_bias" in msgs[1][3]

    envs = ({}, {"MXNET_SERVING_DRAFT_CKPT": str(tmp_path)},
            {"MXNET_SERVING_DRAFT_CKPT": str(tmp_path),
             "MXNET_SERVING_DRAFT_HEADS": "x"},
            {"MXNET_SERVING_DRAFT_CKPT": str(tmp_path),
             "MXNET_SERVING_DRAFT_HEADS": "0"},
            {"MXNET_SERVING_DRAFT_CKPT": str(tmp_path / "empty"),
             "MXNET_SERVING_DRAFT_HEADS": "2"})
    for env in envs:
        for k in ("MXNET_SERVING_DRAFT_CKPT", "MXNET_SERVING_DRAFT_HEADS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = []
        for fn in (lambda: jax_make_proposer("draft_lm"),
                   lambda: make_proposer("draft_lm", ctx=CPU)):
            with pytest.raises((mx.MXNetError, mt.MXNetError)) as ei:
                fn()
            got.append(str(ei.value))
        assert got[0] == got[1], env


def test_engine_refuses_a_draft_of_another_vocabulary(lm):
    host, _ = lm
    bigger = dict(host)
    for k in ("tok_embed_weight", "head_weight"):
        bigger[k] = np.concatenate([host[k], host[k][-1:]], axis=0)
    bigger["head_bias"] = np.concatenate([host["head_bias"],
                                          host["head_bias"][-1:]])
    msgs = []
    for eng_cls, prop in (
            (mx.DecodeEngine, JaxDraft(bigger, num_heads=H, kv_block=KVB)),
            (mt.DecodeEngine, DraftLMProposer(bigger, num_heads=H,
                                              kv_block=KVB, ctx=CPU))):
        assert prop.vocab_size == V + 1
        extra = {} if eng_cls is mx.DecodeEngine else dict(ctx=CPU)
        with pytest.raises((mx.MXNetError, mt.MXNetError)) as ei:
            eng_cls(host, **engine_kw(spec_tokens=2, proposer=prop,
                                      **extra))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "vocab" in msgs[1]


@pytest.mark.parametrize("which", ["self", "cut"])
def test_speculation_with_the_draft_lm_agrees_with_jax(lm, drafts, which):
    """``spec_tokens=3`` with the draft LM through both engines: chains
    agree with the JAX engine's by the margin rule; the self-draft's
    greedy chains equal the plain port engine's bit for bit and accept
    (nearly) every draft."""
    host, _ = lm
    jprop, tprop = drafts[which]
    rng = np.random.RandomState(29)
    jobs = [(rng.randint(1, V, size=n).astype(np.int32), 10)
            for n in (6, 11)]
    with mx.DecodeEngine(host, **engine_kw(**FEW, spec_tokens=3,
                                           proposer=jprop)) as e:
        ref = [e.generate(p, n) for p, n in jobs]
        jst = e.stats()
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU, spec_tokens=3,
                                           proposer=tprop)) as e:
        got = [e.generate(p, n) for p, n in jobs]
        st = e.stats()
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU)) as e:
        plain = [e.generate(p, n) for p, n in jobs]
    assert_chains_agree(host, jobs, ref, got)
    for a, b in zip(got, plain):
        assert a.tobytes() == b.tobytes()
    assert st["proposer"] == "DraftLMProposer" and st["spec_proposed"] > 0
    if which == "self":
        assert st["accepted_token_rate"] > 0.9
        assert jst["accepted_token_rate"] > 0.9
    else:
        assert 0 < st["spec_accepted"] < st["spec_proposed"]


def test_engine_drafts_from_the_environment(lm, monkeypatch, tmp_path):
    """``proposer="draft_lm"`` builds from ``MXNET_SERVING_DRAFT_CKPT``
    (a directory the JAX package published) on the engine's device."""
    host, _ = lm
    jckpt.publish_params(str(tmp_path), host, 3)
    monkeypatch.setenv("MXNET_SERVING_DRAFT_CKPT", str(tmp_path))
    monkeypatch.setenv("MXNET_SERVING_DRAFT_HEADS", str(H))
    prompt = np.arange(3, 12, dtype=np.int32)
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU, spec_tokens=3,
                                           proposer="draft_lm")) as e:
        got = e.generate(prompt, 8)
        st = e.stats()
        assert e._proposer.device == torch.device("cpu")
    with mt.DecodeEngine(host, **engine_kw(**FEW, ctx=CPU)) as e:
        assert e.generate(prompt, 8).tobytes() == got.tobytes()
    assert st["proposer"] == "draft_lm" and st["accepted_token_rate"] > 0.9


# ---------------------------------------------------------------------------
# params-only checkpoints across the packages
# ---------------------------------------------------------------------------


def _params(seed):
    import ml_dtypes

    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            "h": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
            "i": np.arange(5, dtype=np.int32)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if hasattr(g, "bits"):  # the port reads bf16 as HostBF16
            assert g.bits.tobytes() == np.asarray(v).view(np.uint16).tobytes()
        else:
            assert np.asarray(g).dtype == np.asarray(v).dtype, k
            assert np.asarray(g).tobytes() == np.asarray(v).tobytes(), k


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_publish_and_load_latest_params_cross(tmp_path, writer, reader):
    pub = {"jax": jckpt.publish_params, "port": tckpt.publish_params}
    load = {"jax": jckpt.load_latest_params,
            "port": tckpt.load_latest_params}
    err = {"jax": mx.MXNetError, "port": mt.MXNetError}
    p1, p2 = _params(1), _params(2)
    aux = {"moving_mean": np.ones(4, np.float32)}
    d = str(tmp_path)
    path1 = pub[writer](d, p1, 1)
    path2 = pub[writer](d, {k: v for k, v in p2.items() if k != "i"}, 2,
                        aux_params=aux)
    assert os.path.basename(path2) == "ckpt-000000000002"
    with pytest.raises(err[writer], match="already committed"):
        pub[writer](d, p1, 2)
    params, step, path = load[reader](d)
    assert (step, path) == (2, path2)
    _same(params, {**{k: v for k, v in p2.items() if k != "i"}, **aux})
    params, step, _ = load[reader](path1)
    assert step == 1
    _same(params, p1)
    # a corrupt newest checkpoint: the one before it loads
    shard = os.path.join(path2, "shard-00000.bin")
    with open(shard, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    params, step, _ = load[reader](d)
    assert step == 1
    with pytest.raises(err[reader], match="no committed"):
        load[reader](str(tmp_path / "nothing"))


def test_draft_lm_from_env_reads_a_jax_directory(lm, monkeypatch, tmp_path):
    host, _ = lm
    jckpt.publish_params(str(tmp_path), _one_layer(host), 7)
    monkeypatch.setenv("MXNET_SERVING_DRAFT_CKPT", str(tmp_path))
    monkeypatch.setenv("MXNET_SERVING_DRAFT_HEADS", str(H))
    prop = draft_lm_from_env(kv_block=KVB, ctx=CPU)
    assert (prop.num_layers, prop.num_heads, prop.vocab_size) == (1, H, V)
    import jax

    jprop = jax_make_proposer("draft_lm", kv_block=KVB)
    jprop._gfn = jax.jit(jprop._gfn, static_argnums=3)
    ctx = np.arange(1, 9, dtype=np.int32)
    got, want = prop.propose(ctx, 3), jprop.propose(ctx, 3)
    for i, m in enumerate(_margins(prop, ctx, got)):
        if m <= MARGIN:
            break
        assert got[i] == want[i]
