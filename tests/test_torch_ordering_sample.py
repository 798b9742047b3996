"""The port's ordering ops, nodes without inputs, samplers and optimizer
updates against the JAX package's (``mxnet_tpu/ops/{ordering,init_ops,
sample,optimizer_op}.py`` → ``mxnet_tpu_torch/ops/...``): each case of
the chip's op sweep (families "ordering", "init", "sample",
"optimizer") at small shapes.  ``sort``/``argsort``/``topk`` over
halves, so ties meet every rule (stable order, the flipped descending
order, ``lax.top_k``'s lower index first), indices float32.  The
samplers cannot reproduce threefry's values: their shape and dtype are
held to the JAX op's and their draws' mean and variance to the
distribution's (``chip_smoke.check_sample_moments``, 6 standard errors,
2^20 draws), and a sampler node inside the Module's fused step draws
anew each step.  Tolerances in ``tests/torch_op_parity.py``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

import chip_smoke
from torch_op_parity import cases, check_case

CASES, IDS = cases("ordering", "init", "optimizer")
SAMPLES, SAMPLE_IDS = cases("sample")
BF16, BF16_IDS = zip(*[(c, i) for c, i in zip(CASES, IDS) if c["bf16"]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", BF16, ids=BF16_IDS)
def test_op_bf16_matches_jax(case):
    check_case(case, bf16=True)


@pytest.mark.parametrize("case", SAMPLES, ids=SAMPLE_IDS)
def test_sampler_shape_dtype_and_moments(case):
    (want,), _ = jreg.invoke(case["name"], [], case["attrs"])
    torch.manual_seed(0)
    (got,), _ = treg.invoke(case["name"], [], case["attrs"],
                            rng=torch.Generator().manual_seed(11))
    assert tuple(got.shape) == tuple(want.shape)
    assert mt.ndarray.dtype_name(got.dtype) == np.dtype(want.dtype).name
    chip_smoke.check_sample_moments(torch, case, got)


def test_sampler_node_draws_anew_each_fused_step():
    """A ``normal`` node under ``MakeLoss`` through the Module's fused
    step (lr 0): each step's output differs from the last, and output -
    FullyConnected's is N(0, 1)-like."""
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=64, name="fc")
    out = mt.sym.MakeLoss(h + mt.sym.normal(shape=(32, 64), name="noise"))
    mod = mt.mod.Module(out, label_names=(), context=mt.cpu())
    mod.bind(data_shapes=[("data", (32, 8))])
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.0})
    assert mod._fused_ready()  # the step runs fused
    x = np.random.RandomState(3).randn(32, 8).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], [])
    outs = []
    for _ in range(4):
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    for i in range(1, len(outs)):
        assert not np.array_equal(outs[i], outs[i - 1])
    w = mod._exec.arg_dict["fc_weight"].asnumpy()
    b = mod._exec.arg_dict["fc_bias"].asnumpy()
    noise = outs[-1] - (x @ w.T + b)
    assert abs(noise.mean()) < 0.1 and abs(noise.var() - 1) < 0.1


def test_samplers_through_nd_and_sym_names():
    """``nd.uniform``/``normal``/``random_*`` take the JAX package's
    signature; ``nd.exponential`` and ``nd.gamma`` are the samplers (the
    JAX package names a sampler's short name before the unary op
    ``gamma``, which stays ``sym.gamma``); ``sym.uniform`` builds the
    JAX package's node."""
    u = mt.nd.uniform(low=2.0, high=3.0, shape=(1000,), ctx=mt.cpu())
    assert u.shape == (1000,) and 2.0 <= u.asnumpy().min() \
        and u.asnumpy().max() < 3.0
    assert mt.nd.random_normal(shape=(2, 3), ctx=mt.cpu()).shape == (2, 3)
    assert mt.nd.random_uniform is mt.nd.uniform
    e = mt.nd.exponential(lam=4.0, shape=(4000,), ctx=mt.cpu()).asnumpy()
    assert e.min() >= 0 and abs(e.mean() - 0.25) < 0.02
    assert mt.nd.gamma.__name__ == mx.nd.gamma.__name__ == "_sample_gamma"
    g = mt.nd.gamma(alpha=3.0, shape=(4000,), ctx=mt.cpu()).asnumpy()
    assert g.min() > 0 and abs(g.mean() - 3.0) < 0.2
    assert mt.sym.gamma(mt.sym.Variable("x")).tojson() \
        == mx.sym.gamma(mx.sym.Variable("x")).tojson()
    js = mx.sym.uniform(shape=(3,), low=0, high=1, name="u")
    ts = mt.sym.uniform(shape=(3,), low=0, high=1, name="u")
    assert ts.tojson() == js.tojson()
