"""The port's TransformerLM against the JAX package's serving graphs.

Parameters come from a JAX ``Module`` (``get_params`` → ``.asnumpy()``)
and cross through ``params_from_numpy``.  Prefill and decode logits and
pools are held against ``transformer_lm_prefill`` / ``_decode`` run
through ``build_graph_fn`` (the lax path), and the port's own contract
is checked: prefill plus N decode steps gives the full forward's rows.

fp32 tolerance rtol=atol=1e-5: the same two-layer network summed in
other orders (torch's matmuls and the plain attention's block partition
against XLA's) agrees to ~1e-6, not bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models
from mxnet_tpu.executor import build_graph_fn
from mxnet_tpu.models.transformer import (transformer_lm_decode,
                                          transformer_lm_prefill)
from mxnet_tpu_torch import MXNetError, params_from_numpy
from mxnet_tpu_torch.models.transformer import TransformerLM, param_names

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

V, KVB, L, H, DM, MAXLEN = 61, 4, 2, 2, 32, 32
D = DM // H
TOL = dict(rtol=1e-5, atol=1e-5)


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
    params = {**arg, **aux}
    # learned positions start at zero in the symbol; give them values so
    # a wrong position lookup shows
    params["pos_embed_weight"] = mx.nd.array(
        np.random.RandomState(7).randn(MAXLEN, DM).astype(np.float32) * 0.5)
    port = TransformerLM(params_from_numpy(params, "cpu"), num_layers=L,
                         num_heads=H, kv_block=KVB)
    host = {n: params[n].asnumpy() for n in param_names(L)}
    return host, port


def _graph(sym_fn, host):
    s = sym_fn(V, num_layers=L, num_heads=H, d_model=DM, kv_block=KVB,
               paged=True)
    base = {n: jnp.asarray(host[n]) for n in s.list_arguments()
            if n in host}
    return build_graph_fn(s), base


def _run(gfn, base, feeds, pools):
    a = dict(base)
    a.update({k: jnp.asarray(v) for k, v in feeds.items()})
    for i in range(L):
        a[f"layer{i}_kpool"] = jnp.asarray(pools[2 * i])
        a[f"layer{i}_vpool"] = jnp.asarray(pools[2 * i + 1])
    outs, _ = gfn(a, {}, jax.random.PRNGKey(0), False)
    return np.asarray(outs[0]), [np.asarray(p) for p in outs[1:]]


def test_params_from_numpy_binds_checkpoint_names(lm):
    host, port = lm
    for n in param_names(L):
        np.testing.assert_array_equal(getattr(port, n).numpy(), host[n])
    with pytest.raises(MXNetError, match="params missing"):
        TransformerLM({"tok_embed_weight": torch.zeros(V, DM)},
                      num_layers=L, num_heads=H)


def test_prefill_and_decode_match_jax_graphs(lm):
    host, port = lm
    pre, pbase = _graph(transformer_lm_prefill, host)
    dec, dbase = _graph(transformer_lm_decode, host)
    rng = np.random.RandomState(1)
    P = 12
    # stale values in the pools: padding and masks must keep them out
    pools = [rng.randn(P, KVB, H, D).astype(np.float32)
             for _ in range(2 * L)]
    seq = rng.randint(1, V, size=15).astype(np.int32)
    p0 = 6
    table = np.array([[7, 2, 11, 5]], np.int32)  # fragmented
    tokens = np.pad(seq[:p0], (0, 2))[None]      # prompt padded to 8
    feeds = dict(data=tokens, positions=np.arange(8, dtype=np.int32)[None],
                 lengths=np.array([p0], np.int32), block_table=table[:, :2])
    j_logits, j_pools = _run(pre, pbase, feeds, pools)
    t_pools = [torch.from_numpy(p.copy()) for p in pools]
    t_logits = port.prefill(*(torch.from_numpy(feeds[k]) for k in
                              ("data", "positions", "lengths",
                               "block_table")), t_pools)
    np.testing.assert_allclose(t_logits.numpy()[0, :p0], j_logits[0, :p0],
                               **TOL)
    for tp, jp in zip(t_pools, j_pools):
        np.testing.assert_allclose(tp.numpy()[1:], jp[1:], **TOL)

    for t in range(p0, len(seq)):
        feeds = dict(data=seq[None, t:t + 1],
                     positions=np.array([[t]], np.int32),
                     lengths=np.array([t + 1], np.int32), block_table=table)
        j_logits, j_pools = _run(dec, dbase, feeds, j_pools)
        t_logits = port.decode(*(torch.from_numpy(feeds[k]) for k in
                                 ("data", "positions", "lengths",
                                  "block_table")), t_pools)
        np.testing.assert_allclose(t_logits.numpy()[0, 0], j_logits[0, 0],
                                   err_msg=f"decode step t={t}", **TOL)
        for tp, jp in zip(t_pools, j_pools):
            np.testing.assert_allclose(tp.numpy()[1:], jp[1:], **TOL)


def test_batched_decode_with_padded_slots_matches_jax(lm):
    """Two live streams and one padded slot (lengths 0) in one step."""
    host, port = lm
    dec, dbase = _graph(transformer_lm_decode, host)
    rng = np.random.RandomState(2)
    P = 9
    pools = [rng.randn(P, KVB, H, D).astype(np.float32)
             for _ in range(2 * L)]
    feeds = dict(data=np.array([[5], [9], [0]], np.int32),
                 positions=np.array([[6], [3], [0]], np.int32),
                 lengths=np.array([7, 4, 0], np.int32),
                 block_table=np.array([[4, 8], [2, 0], [0, 0]], np.int32))
    j_logits, j_pools = _run(dec, dbase, feeds, pools)
    t_pools = [torch.from_numpy(p.copy()) for p in pools]
    t_logits = port.decode(*(torch.from_numpy(feeds[k]) for k in
                             ("data", "positions", "lengths",
                              "block_table")), t_pools)
    np.testing.assert_allclose(t_logits.numpy()[:2], j_logits[:2], **TOL)
    for tp, jp in zip(t_pools, j_pools):
        np.testing.assert_allclose(tp.numpy()[1:], jp[1:], **TOL)


def test_forward_matches_jax_training_symbol_rows(lm):
    """``forward`` is the full causal forward of ``transformer_lm``: its
    logits equal the non-paged prefill graph's at every row."""
    host, port = lm
    s = transformer_lm_prefill(V, num_layers=L, num_heads=H, d_model=DM,
                               kv_block=KVB, paged=False)
    gfn = build_graph_fn(s)
    seq = np.random.RandomState(3).randint(1, V, size=(2, 11)).astype(
        np.int32)
    a = {n: jnp.asarray(host[n]) for n in s.list_arguments() if n in host}
    a.update(data=jnp.asarray(seq),
             positions=jnp.asarray(np.tile(np.arange(11, dtype=np.int32),
                                           (2, 1))),
             lengths=jnp.asarray(np.array([11, 11], np.int32)))
    outs, _ = gfn(a, {}, jax.random.PRNGKey(0), False)
    got = port(torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(outs[0]), **TOL)


def test_prefill_plus_decode_equals_forward(lm):
    """The port's own serving contract: prefill of a prompt, then one
    decode step per further token, reproduces the full forward's rows."""
    _, port = lm
    rng = np.random.RandomState(4)
    seq = torch.from_numpy(rng.randint(1, V, size=14).astype(np.int32))
    full = port(seq[None].long())[0]
    p0, P = 5, 8
    pools = [torch.zeros(P, KVB, H, D) for _ in range(2 * L)]
    table = torch.tensor([[3, 6, 1, 7]], dtype=torch.int32)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    tokens[0, :p0] = seq[:p0]
    logits = port.prefill(tokens, torch.arange(8)[None],
                          torch.tensor([p0], dtype=torch.int32),
                          table[:, :2], pools)
    np.testing.assert_allclose(logits[0, :p0].numpy(), full[:p0].numpy(),
                               **TOL)
    for t in range(p0, len(seq)):
        step = port.decode(seq[None, t:t + 1], torch.tensor([[t]]),
                           torch.tensor([t + 1], dtype=torch.int32), table,
                           pools)
        np.testing.assert_allclose(step[0, 0].numpy(), full[t].numpy(),
                                   err_msg=f"t={t}", **TOL)
