"""``MXNET_BACKWARD_DO_MIRROR`` in the port (``mxnet_tpu_torch/
executor.py``) on the CPU: the training forward runs under
``torch.utils.checkpoint`` and again in the backward.

Held to ``tests/test_dtype_remat.py::test_backward_do_mirror_same_numerics``:
3 epochs of SGD over an MLP give the same weights with and without the
mirror (rtol 1e-5, atol 1e-6; the port's are equal bit for bit, since
the recomputation runs the same operations), and the port's mirrored run
matches the JAX package's mirrored run at that tolerance.  With dropout
the recomputation sees the forward's masks (a random node's draws are
kept from the forward), on the fused step and the eager path; a
BatchNorm net's moving statistics are written once a step; the forward
runs twice a training step and once an inference one."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(pkg, dropout=0.0, batchnorm=False):
    x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=16,
                               name="fc1")
    if batchnorm:
        x = pkg.sym.BatchNorm(x, name="bn1")
    x = pkg.sym.Activation(x, act_type="relu")
    if dropout:
        x = pkg.sym.Dropout(x, p=dropout)
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _data(n=100):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 8).astype(np.float32)
    y = np.argmax(X @ rng.randn(8, 3), axis=1).astype(np.float32)
    return X, y


def _start(seed=3):
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (16, 8), "fc1_bias": (16,), "fc2_weight": (3, 16),
              "fc2_bias": (3,), "bn1_gamma": (16,), "bn1_beta": (16,)}
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _train(pkg, sym, mirror, monkeypatch, fused="1", epochs=3):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    X, y = _data()
    ctx = pkg.cpu()
    it = pkg.io.NDArrayIter(X, y, batch_size=20)
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    assert mod._exec._do_mirror == (mirror == "1")
    start = {n: v for n, v in _start().items()
             if n in sym.list_arguments()}
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                for n, v in start.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for _ in range(epochs):
        it.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
    arg, aux = mod.get_params()
    return {n: v.asnumpy() for n, v in {**arg, **aux}.items()}


def _assert_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_backward_do_mirror_same_numerics(fused, monkeypatch):
    plain = _train(mt, _mlp(mt), "0", monkeypatch, fused)
    mirrored = _train(mt, _mlp(mt), "1", monkeypatch, fused)
    _assert_equal(plain, mirrored)


def test_mirrored_run_as_the_jax_package_s(monkeypatch):
    mine = _train(mt, _mlp(mt), "1", monkeypatch)
    theirs = _train(mx, _mlp(mx), "1", monkeypatch)
    for n in theirs:
        np.testing.assert_allclose(mine[n], theirs[n], **TOL, err_msg=n)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_dropout_masks_survive_the_recomputation(fused, monkeypatch):
    """A dropout net trains the same with and without the mirror: the
    recomputation reuses the forward's draws (its ``draw_mask`` runs
    again and gets the same mask)."""
    masks = []
    real = tnn.draw_mask

    def recording(*args, **kwargs):
        m = real(*args, **kwargs)
        masks.append(m.clone())
        return m

    monkeypatch.setattr(tnn, "draw_mask", recording)
    mt.random.seed(5)
    plain = _train(mt, _mlp(mt, dropout=0.3), "0", monkeypatch, fused, 1)
    plain_masks, masks[:] = list(masks), []
    mt.random.seed(5)
    mirrored = _train(mt, _mlp(mt, dropout=0.3), "1", monkeypatch, fused, 1)
    _assert_equal(plain, mirrored)
    # each mirrored step draws in the forward and again in the
    # recomputation, the same mask both times, the plain run's mask
    assert len(masks) == 2 * len(plain_masks)
    for i, m in enumerate(plain_masks):
        assert torch.equal(masks[2 * i], m)
        assert torch.equal(masks[2 * i + 1], m)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_batchnorm_statistics_written_once_a_step(fused, monkeypatch):
    plain = _train(mt, _mlp(mt, batchnorm=True), "0", monkeypatch, fused)
    mirrored = _train(mt, _mlp(mt, batchnorm=True), "1", monkeypatch, fused)
    _assert_equal(plain, mirrored)
    theirs = _train(mx, _mlp(mx, batchnorm=True), "1", monkeypatch, fused)
    for n in ("bn1_moving_mean", "bn1_moving_var"):
        np.testing.assert_allclose(mirrored[n], theirs[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("is_train,runs", [(True, 2), (False, 1)])
def test_the_forward_runs_again_in_the_backward(is_train, runs,
                                                monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    ex = _mlp(mt).simple_bind(mt.cpu(), data=(4, 8), softmax_label=(4,))
    calls = []
    graph_fn = ex._graph_fn

    def counting(*args, **kwargs):
        calls.append(1)
        return graph_fn(*args, **kwargs)

    ex._graph_fn = counting
    for n, v in _start().items():
        if n in ex.arg_dict:
            ex.arg_dict[n][:] = v
    ex.forward(is_train=is_train, data=np.ones((4, 8), np.float32),
               softmax_label=np.zeros(4, np.float32))
    if is_train:
        ex.backward()
        assert np.abs(ex.grad_dict["fc1_weight"].asnumpy()).sum() > 0
    assert len(calls) == runs


def test_mirrored_lm_with_dropout_as_without(monkeypatch):
    """A 2-layer ``transformer_lm`` with dropout: two fused steps with
    the mirror equal two without, bit for bit."""
    V, T, B = 61, 16, 2
    rng = np.random.RandomState(1)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(1, V, (B, T)).astype(np.float32)
    out = []
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        mt.random.seed(2)
        net = mt.models.transformer_lm(V, T, num_layers=2, num_heads=2,
                                       d_model=32, head="ce", dropout=0.2)
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", (B, T))],
                 label_shapes=[("softmax_label", (B, T))])
        mod.init_params(mt.initializer.Xavier())
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                [mt.nd.array(Y, ctx=mt.cpu())])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        out.append({n: v.asnumpy() for n, v in mod.get_params()[0].items()})
    _assert_equal(*out)
