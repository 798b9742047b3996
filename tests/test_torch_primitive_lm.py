"""The GPT-2-class LM with its attention written from the operator layer
(``chip_smoke.primitive_lm_symbol``: ``SliceChannel`` of the packed qkv,
``SwapAxis``, ``batch_dot``, scalar arithmetic, a causal bias from
``arange`` and ``broadcast_greater``, ``softmax``) at 2 layers, width
32, 2 heads, 16 positions and 61 tokens: the same graph in both
packages, one training step of each package's ``Module`` on the CPU
from the same numpy weights (loss and every gradient), and the port's
primitive LM against its packed ``transformer_lm`` on those weights
(the same function: loss and every gradient).  Phase 14 of
``chip_smoke.py`` runs it at GPT-2-small width on the card.

Tolerances (fp32): losses rtol = atol = 1e-5; gradients rtol = atol =
5e-5, ``test_torch_dpa.py``'s (both sides sum in other orders; the
gradients chain several such sums).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

import chip_smoke

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
V, T, L, NH, DM, B = 61, 16, 2, 2, 32, 3
CFG = dict(vocab_size=V, num_layers=L, num_heads=NH, d_model=DM,
           d_ff=4 * DM, max_len=T)
SHAPES = dict(data=(B, T), softmax_label=(B, T))


def _sym(api):
    return chip_smoke.primitive_lm_symbol(api, V, T, L, NH, DM, 4 * DM)


def _params():
    """The packed LM's weights at N(0, 0.02), then LayerNorm gains, biases
    and positions moved off their identity / zero starts (seeded)."""
    params = chip_smoke.gpt2_small_params(4, CFG)
    rng = np.random.RandomState(9)
    for k, v in params.items():
        if k.endswith(("_gamma", "_beta", "_bias")) or k == "pos_embed_weight":
            params[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    return params


def _batch(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, V, (B, T)).astype(np.float32),
            rng.randint(0, V, (B, T)).astype(np.float32))


def _port_step(sym, params, batch):
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(arg_params=params)
    X, Y = batch
    mod.forward_backward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                         [mt.nd.array(Y, ctx=mt.cpu())]))
    return mod.get_outputs()[0].asnumpy(), {
        k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
        if k in params}


def test_primitive_lm_builds_the_same_graph_in_both_packages():
    js, ts = _sym(mx.sym), _sym(mt.sym)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    packed = mt.models.transformer_lm(V, T, num_layers=L, num_heads=NH,
                                      d_model=DM, head="ce")
    assert sorted(ts.list_arguments()) == sorted(packed.list_arguments())
    assert ts.infer_shape(**SHAPES) == tuple(
        [list(x) for x in js.infer_shape(**SHAPES)])
    assert ts.infer_type(data="float32")[1] == ["float32"]


def test_primitive_lm_module_step_matches_jax_module(monkeypatch):
    """One forward + backward of each package's Module (the JAX one
    eager, ``MXNET_FUSED_STEP=0``, whose executor keeps the gradients)
    from the same weights and batch: the per-token loss and every
    gradient."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    params = _params()
    X, Y = _batch()
    jmod = mx.mod.Module(_sym(mx.sym), context=mx.cpu())
    jmod.bind(data_shapes=[("data", (B, T))],
              label_shapes=[("softmax_label", (B, T))])
    jmod.init_params(arg_params={k: mx.nd.array(v)
                                 for k, v in params.items()})
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    want = jmod.get_outputs()[0].asnumpy()
    want_g = {k: jmod._exec.grad_dict[k].asnumpy() for k in params}
    got, got_g = _port_step(_sym(mt.sym), params, (X, Y))
    np.testing.assert_allclose(got, want, **FWD)
    assert sorted(got_g) == sorted(want_g)
    for k in got_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **GRAD)
    assert max(np.abs(g).max() for g in got_g.values()) > 1e-3


def test_primitive_lm_equals_packed_lm():
    """The port's primitive LM and its packed ``transformer_lm`` compute
    the same function: loss and every gradient on the same weights."""
    params = _params()
    batch = _batch(3)
    packed = mt.models.transformer_lm(V, T, num_layers=L, num_heads=NH,
                                      d_model=DM, head="ce")
    ref, ref_g = _port_step(packed, params, batch)
    got, got_g = _port_step(_sym(mt.sym), params, batch)
    np.testing.assert_allclose(got, ref, **FWD)
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], err_msg=k, **GRAD)


@pytest.mark.cuda
def test_primitive_lm_launches_no_attention_kernel_on_the_card():
    """On the card the primitive LM's step runs cuBLAS, softmax and
    elementwise kernels only: B1's and B5's counters stay 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; python3 chip_smoke.py --ops . "
                    "runs phase 14 there")
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    params = _params()
    mod = mt.mod.Module(_sym(mt.sym), context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(arg_params=params)
    X, Y = _batch()
    ck.reset_launch_counts()
    mod.forward_backward(mt.io.DataBatch(
        [mt.nd.array(X, ctx=mt.gpu(0))], [mt.nd.array(Y, ctx=mt.gpu(0))]))
    torch.cuda.synchronize()
    assert not any(ck.LAUNCHES.values())
