"""The port's suffix prefill against the JAX package on the CPU.

* ``qkv_paged_prefill_attend`` (fp32 pools) and
  ``qkv_paged_prefill_attend_q`` (int8 / fp8 pools) against the JAX ops
  ``QKVPagedPrefillAttend`` / ``QKVPagedPrefillAttendQ`` (lax
  ``prefix_suffix_attention``): outputs at rtol=atol=1e-5 (the cached
  prefix is the same bytes in both packages, and the suffix attends its
  own K/V raw), fp32 pools at 1e-6, quantized codes at most one code
  apart in at most 1% of the slots (``tests/test_torch_spec.py``'s rule
  for the quantized verify op).  Cases: ``start = 0`` (a first chunk),
  ``start`` the whole cached prompt minus one block, and a suffix padded
  to its bucket.
* ``TransformerLM.suffix_prefill`` against ``transformer_lm_prefix_prefill``
  (``build_graph_fn``) on the same pools, fp32 / int8 / fp8, and, within
  the port, a prompt prefilled in chunks against ``TransformerLM.prefill``
  over the whole prompt.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.models.transformer import transformer_lm_prefix_prefill
from mxnet_tpu.ops.registry import invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from test_torch_spec import _quant_pools
from torch_serving_parity import (D, H, KVB, TOL, V, fresh_pools, jax_graph,
                                  make_lm, pool_bytes, run_graph)

torch.set_num_threads(1)

P, MB = 12, 6
TABLE = np.array([[7, 2, 11, 5, 9, 3]], np.int32)
# (start, real suffix tokens, suffix bucket)
CASES = {"first_chunk": (0, 6, 8), "all_but_one_block": (12, 3, 4),
         "padded_suffix": (8, 5, 8)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lm():
    return make_lm()


def _pools(name, rng):
    """Pools whose pages already hold values (the cached prefix, and
    stale bytes the masks must keep out): (JAX arrays, port tensors)."""
    kp = rng.randn(P, KVB, H, D).astype(np.float32)
    vp = rng.randn(P, KVB, H, D).astype(np.float32)
    if name == "fp32":
        return [jnp.asarray(kp), jnp.asarray(vp)], [_t(kp), _t(vp)]
    j, t = _quant_pools(name, kp, vp)
    return list(j), t


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["fp32", "int8", "fp8"])
def test_prefill_attend_matches_jax_op(name, case):
    start, ns, ts = CASES[case]
    rng = np.random.RandomState(3)
    j_pools, t_pools = _pools(name, rng)
    qkv = rng.randn(1, ts, 3 * H * D).astype(np.float32)
    lengths = np.array([start + ns], np.int32)
    op = "QKVPagedPrefillAttend" if name == "fp32" \
        else "QKVPagedPrefillAttendQ"
    outs, _ = invoke(op, [jnp.asarray(qkv), *j_pools, jnp.asarray(TABLE),
                          jnp.asarray(np.array([start], np.int32)),
                          jnp.asarray(lengths)], {"num_heads": H})
    if name == "fp32":
        got = tatt.qkv_paged_prefill_attend(_t(qkv), *t_pools, _t(TABLE),
                                            start, _t(lengths), H)
    else:
        got = tatt.qkv_paged_prefill_attend_q(_t(qkv), *t_pools, _t(TABLE),
                                              start, _t(lengths), H)
    assert got.shape == (1, ts, H * D)
    # the real suffix rows; padded rows are garbage in both packages
    np.testing.assert_allclose(got.numpy()[:, :ns],
                               np.asarray(outs[0])[:, :ns], **TOL)
    for tp, jp in zip(t_pools, outs[1:]):
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       rtol=1e-6, atol=0)
        else:
            a = tp.numpy()[1:].astype(np.int32) if tp.dtype == torch.int8 \
                else pool_bytes(tp)[1:].astype(np.int32)
            b = np.asarray(jp)[1:].astype(np.int32) \
                if tp.dtype == torch.int8 \
                else pool_bytes(jp)[1:].astype(np.int32)
            assert (a != b).mean() <= 0.01
            if tp.dtype == torch.int8:
                assert np.abs(a - b).max() <= 1


def test_prefill_attend_start_validation():
    """An int ``start`` must be block-aligned; a (B,) tensor is taken per
    row (and gives the int's result), a tensor of another shape raises."""
    qkv = torch.zeros(1, 4, 3 * H * D)
    pools = [torch.zeros(P, KVB, H, D) for _ in range(2)]
    with pytest.raises(mt.MXNetError, match="multiple of the page size"):
        tatt.qkv_paged_prefill_attend(qkv, *pools, _t(TABLE), 3,
                                      _t(np.array([7], np.int32)), H)
    with pytest.raises(mt.MXNetError, match=r"start must be \(1,\)"):
        tatt.qkv_paged_prefill_attend(qkv, *pools, _t(TABLE),
                                      torch.tensor([4, 4]),
                                      _t(np.array([8], np.int32)), H)
    rng = np.random.RandomState(7)
    qkv = _t(rng.randn(1, 4, 3 * H * D).astype(np.float32))
    outs = []
    for start in (4, torch.tensor([4], dtype=torch.int32)):
        _, t_pools = _pools("fp32", np.random.RandomState(8))
        outs.append(tatt.qkv_paged_prefill_attend(
            qkv, *t_pools, _t(TABLE), start, _t(np.array([8], np.int32)),
            H))
    assert torch.equal(outs[0], outs[1])


def test_prefix_suffix_attention_is_one_b8_call(monkeypatch):
    """The suffix prefill's attention is B8 twice a layer, the kernel the
    card launches (its plain version here): over the table's MB pages
    (a fixed width) non-causal under the per-row key limit ``kv_len =
    start``, then over the raw suffix causal at ``kv_offset = 0``."""
    calls = []
    real = ck.flash_attention_partial

    def spy(q, k, v, causal, block_size, kv_offset, kv_len=None):
        calls.append((tuple(q.shape), tuple(k.shape), causal, block_size,
                      kv_offset, None if kv_len is None
                      else kv_len.tolist()))
        return real(q, k, v, causal, block_size, kv_offset, kv_len)

    monkeypatch.setattr(ck, "flash_attention_partial", spy)
    rng = np.random.RandomState(4)
    _, t_pools = _pools("fp32", rng)
    qkv = _t(rng.randn(1, 8, 3 * H * D).astype(np.float32))
    tatt.qkv_paged_prefill_attend(qkv, *t_pools, _t(TABLE), 8,
                                  _t(np.array([13], np.int32)), H)
    assert calls == [((1, 8, H, D), (1, MB * KVB, H, D), False, KVB, 0,
                      [8]),
                     ((1, 8, H, D), (1, 8, H, D), True, KVB, 0, None)]


# ---------------------------------------------------------------------------
# TransformerLM.suffix_prefill against transformer_lm_prefix_prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp32", "int8", "fp8"])
def test_suffix_prefill_matches_jax_graph(lm, name):
    host, port = lm
    graph = jax_graph(transformer_lm_prefix_prefill, host, name)
    rng = np.random.RandomState(5)
    t_pools, j_pools = fresh_pools(name, P)
    if name == "fp32":  # stale bytes the masks must keep out
        for i, tp in enumerate(t_pools):
            tp.copy_(torch.randn(tp.shape, generator=torch.Generator()
                                 .manual_seed(9 + i)))
        j_pools = [jnp.asarray(tp.numpy()) for tp in t_pools]
    # the cached prefix: the first 8 tokens, prefilled by both packages'
    # own suffix prefill at start 0 (so their pools hold the same K/V)
    prompt = rng.randint(1, V, size=13).astype(np.int32)
    for start, stop, ts in ((0, 8, 8), (8, 13, 8)):
        feeds = dict(data=np.zeros((1, ts), np.int32),
                     positions=(start + np.arange(ts, dtype=np.int32))[None],
                     start=np.array([start], np.int32),
                     lengths=np.array([stop], np.int32),
                     block_table=TABLE[:, :4])
        feeds["data"][0, :stop - start] = prompt[start:stop]
        j_logits, j_pools = run_graph(graph, feeds, j_pools)
        t_logits = port.suffix_prefill(
            _t(feeds["data"]), _t(feeds["positions"]), start,
            _t(feeds["lengths"]), _t(feeds["block_table"]), t_pools)
        assert t_logits.shape == (1, ts, V)
        np.testing.assert_allclose(t_logits.numpy()[0, :stop - start],
                                   j_logits[0, :stop - start], **TOL)
        for tp, jp in zip(t_pools, j_pools):
            a, b = pool_bytes(tp)[1:], pool_bytes(jp)[1:]
            if tp.dtype == torch.float32:
                np.testing.assert_allclose(a.view(np.float32),
                                           b.view(np.float32), **TOL)
            else:  # neighbouring codes at rounding boundaries, rarely
                assert (a != b).mean() <= 0.01


@pytest.mark.parametrize("chunk", [4, 8])
def test_suffix_prefill_chunks_equal_whole_prefill(lm, chunk):
    """Within the port: a 14-token prompt prefilled in chunks of
    ``chunk`` tokens (each chunk a suffix prefill over the pages the
    earlier chunks wrote) gives the whole prefill's logits and K/V."""
    _, port = lm
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, V, size=14).astype(np.int32)
    table = _t(TABLE[:, :4])
    whole, _ = fresh_pools("fp32", P)
    want = port.prefill(_t(np.pad(prompt, (0, 2))[None]),
                        _t(np.arange(16, dtype=np.int32)[None]),
                        _t(np.array([14], np.int32)), table, whole)[0, :14]
    pools, _ = fresh_pools("fp32", P)
    rows = []
    for start in range(0, 14, chunk):
        stop = min(start + chunk, 14)
        data = np.zeros((1, chunk), np.int32)
        data[0, :stop - start] = prompt[start:stop]
        pos = (start + np.arange(chunk, dtype=np.int32))[None]
        rows.append(port.suffix_prefill(
            _t(data), _t(pos), start, _t(np.array([stop], np.int32)),
            table, pools)[0, :stop - start])
    np.testing.assert_allclose(torch.cat(rows).numpy(), want.numpy(), **TOL)
    for a, b in zip(pools, whole):
        np.testing.assert_allclose(a.numpy()[1:], b.numpy()[1:], **TOL)
