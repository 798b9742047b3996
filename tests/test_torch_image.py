"""The port's image-classification path against the JAX package on the
CPU: the model zoo's symbols (``get_symbol``: arguments, aux states and
inferred shapes), ``lr_scheduler``, ``io.ResizeIter``, ``Accuracy``
(counted where the predictions lie, and on the host),
``nd.concatenate``, ``Module.predict``/``iter_predict`` with a padded
last batch, and the ``train_mnist`` path through the examples' ``fit``
(``mxnet_tpu_torch/examples/common.py`` against
``examples/common/util.py``) for LeNet and the MLP; then the port's
example scripts on ``cpu()`` and what they refuse.

Data and parameters come from numpy seeds (the MNIST run's initial
parameters from the JAX module's ``Xavier``).  Tolerances: the
schedulers, iterators and metrics are exact; ``predict`` float32 rtol
1e-5, atol 1e-6 (an MLP, sums in another order); the MNIST epoch's
accuracies within one sample of 512 and its final parameters rtol 1e-5,
atol 1e-6 (eight SGD steps with momentum; ~3e-7 measured).
"""

import importlib.util
import logging
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import (benchmark_score, common, train_imagenet,
                                      train_mnist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# symbols
# ---------------------------------------------------------------------------


SYMBOLS = {
    "mlp": (dict(num_classes=10), (2, 1, 28, 28)),
    "lenet": (dict(num_classes=10), (2, 1, 28, 28)),
    "resnet-18": (dict(num_classes=1000, image_shape=(3, 224, 224)),
                  (2, 3, 224, 224)),
    "resnet-50": (dict(num_classes=1000, image_shape=(3, 224, 224)),
                  (2, 3, 224, 224)),
    "resnet-20": (dict(num_classes=10, image_shape=(3, 32, 32)),
                  (2, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_get_symbol_matches_jax(name):
    kwargs, dshape = SYMBOLS[name]
    j = jax_models.get_symbol(name, **kwargs)
    t = mt.models.get_symbol(name, **kwargs)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    shapes = dict(data=dshape, softmax_label=(dshape[0],))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    if name == "resnet-50":  # 157 parameters, 102 moving statistics
        assert len(t.list_arguments()) == 159
        assert len(t.list_auxiliary_states()) == 102


def test_get_symbol_refuses_what_is_not_ported():
    for name in ("alexnet", "vgg", "inception-bn", "inception-v3"):
        with pytest.raises(mt.MXNetError, match="queue A item 2"):
            mt.models.get_symbol(name)
    with pytest.raises(mt.MXNetError, match="space_to_depth"):
        mt.models.get_symbol("resnet-50", stem="s2d")
    with pytest.raises(mt.MXNetError, match="unknown network"):
        mt.models.get_symbol("googlenet")


# ---------------------------------------------------------------------------
# lr_scheduler
# ---------------------------------------------------------------------------


def _schedulers(pkg):
    return [pkg.lr_scheduler.FactorScheduler(step=7, factor=0.5,
                                             stop_factor_lr=1e-3),
            pkg.lr_scheduler.FactorScheduler(step=30, factor=0.9),
            pkg.lr_scheduler.MultiFactorScheduler(step=[10, 50, 120],
                                                  factor=0.3)]


def test_lr_schedulers_match_jax_over_200_updates():
    for j, t in zip(_schedulers(mx), _schedulers(mt)):
        j.base_lr = t.base_lr = 0.1
        for n in range(1, 201):
            assert t(n) == j(n), (type(t).__name__, n)
    # skipping updates applies every decay that is due, as there
    for j, t in zip(_schedulers(mx), _schedulers(mt)):
        j.base_lr = t.base_lr = 0.1
        for n in (3, 64, 65, 200):
            assert t(n) == j(n)
    # the optimizer rebases the scheduler on its learning rate
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[2], factor=0.5)
    sgd = mt.optimizer.SGD(learning_rate=0.4, lr_scheduler=sched)
    assert sched.base_lr == 0.4 and sgd._get_lr(0) == 0.4


@pytest.mark.parametrize("make", [
    lambda p: p.lr_scheduler.FactorScheduler(step=0),
    lambda p: p.lr_scheduler.FactorScheduler(step=5, factor=1.5),
    lambda p: p.lr_scheduler.MultiFactorScheduler(step=[5, 5]),
    lambda p: p.lr_scheduler.MultiFactorScheduler(step=[0, 5]),
    lambda p: p.lr_scheduler.MultiFactorScheduler(step=[5], factor=2.0),
    lambda p: p.lr_scheduler.MultiFactorScheduler(step=[]),
], ids=["factor-step-0", "factor-grows", "multi-not-increasing",
        "multi-milestone-0", "multi-grows", "multi-empty"])
def test_lr_scheduler_errors_match_jax(make):
    """The same messages; the port raises ValueError where the JAX
    package checks an empty list with ``assert``."""
    with pytest.raises((ValueError, AssertionError)) as jerr:
        make(mx)
    with pytest.raises(ValueError) as terr:
        make(mt)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# ResizeIter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reset_internal", [True, False])
def test_resize_iter_matches_jax_over_two_epochs(reset_internal):
    X = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    seqs = []
    for pkg in (mx, mt):
        it = pkg.io.ResizeIter(pkg.io.NDArrayIter(X, y, batch_size=4),
                               size=5, reset_internal=reset_internal)
        assert it.batch_size == 4
        assert [tuple(d[1]) for d in it.provide_data] == [(4, 3)]
        seq = []
        for _ in range(2):
            for batch in it:
                seq.append((batch.data[0].asnumpy().tolist(),
                            batch.label[0].asnumpy().tolist(), batch.pad))
            it.reset()
        seqs.append(seq)
    assert len(seqs[1]) == 10
    assert seqs[1] == seqs[0]


# ---------------------------------------------------------------------------
# Accuracy
# ---------------------------------------------------------------------------


def _accuracy_batches():
    rng = np.random.RandomState(4)
    probs = rng.rand(3, 6, 5).astype(np.float32)
    probs[0, 0] = [0.5, 0.5, 0.1, 0.5, 0.0]  # ties: the first maximum
    labels = rng.randint(0, 5, size=(3, 6)).astype(np.float32)
    labels[0, 0] = 1
    classes = rng.randint(0, 5, size=(3, 6)).astype(np.float32)
    return probs, labels, classes


def test_accuracy_device_path_matches_jax_and_never_reads_preds(monkeypatch):
    probs, labels, classes = _accuracy_batches()
    jm = mx.metric.Accuracy()
    for p, c, l in zip(probs, classes, labels):
        jm.update([mx.nd.array(l)], [mx.nd.array(p)])
        jm.update([mx.nd.array(l)], [mx.nd.array(c)])
    tm = mt.metric.Accuracy()
    arrays = [(mt.nd.array(p, ctx=mt.cpu()), mt.nd.array(c, ctx=mt.cpu()),
               mt.nd.array(l, ctx=mt.cpu()))
              for p, c, l in zip(probs, classes, labels)]

    def refuse(self):
        raise AssertionError("Accuracy.update read an NDArray back")

    monkeypatch.setattr(mt.nd.NDArray, "asnumpy", refuse)
    for p, c, l in arrays:
        tm.update([l], [p])  # a trailing class axis: argmax
        tm.update([l], [c])  # equal shapes: class ids
    assert tm.num_inst == 0  # nothing summed on the host yet
    monkeypatch.undo()
    assert tm.get() == jm.get()
    assert tm.num_inst == 36 and tm.sum_metric == jm.sum_metric
    tm.reset()
    assert np.isnan(tm.get()[1])


def test_accuracy_host_path_matches_jax():
    """numpy labels, and a label shape that is neither equal nor one
    axis shorter, take the host path in both packages."""
    probs, labels, _ = _accuracy_batches()
    jm, tm = mx.metric.Accuracy(), mt.metric.Accuracy()
    for p, l in zip(probs, labels):
        jm.update([l], [mx.nd.array(p)])
        tm.update([l], [mt.nd.array(p, ctx=mt.cpu())])
        jm.update([mx.nd.array(l[:, None])], [mx.nd.array(p[:, None])])
        tm.update([mt.nd.array(l[:, None], ctx=mt.cpu())],
                  [mt.nd.array(p[:, None], ctx=mt.cpu())])
    assert tm.get() == jm.get()
    with pytest.raises(ValueError):
        tm.update([labels[0][:4]], [mt.nd.array(probs[0], ctx=mt.cpu())])


# ---------------------------------------------------------------------------
# concatenate, wait_to_read, predict, iter_predict
# ---------------------------------------------------------------------------


def test_concatenate_and_wait_to_read_match_jax():
    rng = np.random.RandomState(5)
    a, b = rng.randn(2, 3).astype(np.float32), rng.randn(4, 3)
    for axis, (x, y) in ((0, (a, b.astype(np.float32))),
                         (1, (a, rng.randn(2, 5).astype(np.float32)))):
        j = mx.nd.concatenate([mx.nd.array(x), mx.nd.array(y)], axis=axis)
        t = mt.nd.concatenate([mt.nd.array(x, ctx=mt.cpu()),
                               mt.nd.array(y, ctx=mt.cpu())], axis=axis)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
        assert t.context == mt.cpu()
        assert t.wait_to_read() is None


def _mlp_modules(batch):
    rng = np.random.RandomState(6)
    sym = mt.models.mlp(num_classes=10)
    shapes = sym.infer_shape(data=(batch, 1, 28, 28),
                             softmax_label=(batch,))[0]
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    mods = []
    for pkg, ctx, ps in ((mx, mx.cpu(), {k: mx.nd.array(v)
                                         for k, v in params.items()}),
                         (mt, mt.cpu(), params)):
        mod = pkg.mod.Module(pkg.models.get_symbol("mlp", num_classes=10),
                             context=ctx)
        mod.bind(data_shapes=[("data", (batch, 1, 28, 28))],
                 label_shapes=[("softmax_label", (batch,))],
                 for_training=False)
        mod.init_params(arg_params=ps)
        mods.append(mod)
    return mods


PREDICT = dict(rtol=1e-5, atol=1e-6)


def test_predict_and_iter_predict_with_padding_match_jax():
    X, y = common.synthetic_mnist(10, seed=3)
    jmod, tmod = _mlp_modules(4)
    jit = mx.io.NDArrayIter(X, y, batch_size=4)
    tit = mt.io.NDArrayIter(X, y, batch_size=4)
    jout, tout = jmod.predict(jit), tmod.predict(tit)
    assert tout.shape == (10, 10)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **PREDICT)
    # batch by batch, the last one cut by its pad of 2
    per_batch = tmod.predict(tit, merge_batches=False)
    assert [o[0].shape[0] for o in per_batch] == [4, 4, 2]
    listed = tmod.predict(tit, always_output_list=True)
    assert isinstance(listed, list) and len(listed) == 1
    np.testing.assert_array_equal(listed[0].asnumpy(), tout.asnumpy())
    seen = []
    for (outs, nbatch, batch), (jouts, jn, _) in zip(
            tmod.iter_predict(tit), jmod.iter_predict(jit)):
        assert nbatch == jn and outs[0].shape == jouts[0].shape
        np.testing.assert_allclose(outs[0].asnumpy(), jouts[0].asnumpy(),
                                   **PREDICT)
        seen.append(batch.pad)
    assert seen == [0, 0, 2]
    assert tmod.predict(tit, num_batch=1).shape == (4, 10)
    # the concatenated outputs equal the trimmed forward outputs
    tit.reset()
    ref = []
    for batch in tit:
        tmod.forward(batch, is_train=False)
        out = tmod.get_outputs()[0].asnumpy()
        ref.append(out[:out.shape[0] - batch.pad])
    np.testing.assert_array_equal(tout.asnumpy(), np.concatenate(ref))


# ---------------------------------------------------------------------------
# the train_mnist path: the examples' fit in both packages
# ---------------------------------------------------------------------------


def _jax_util():
    path = os.path.join(REPO, "examples", "common", "util.py")
    spec = importlib.util.spec_from_file_location("jax_examples_util", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FromDict:
    """The port's counterpart of ``mx.initializer.Load``: every array
    from a dict of numpy arrays."""

    def __init__(self, params):
        self.params = params

    def __call__(self, name, arr):
        arr[:] = self.params[name]


def _epoch_accuracies(records):
    out = {}
    for r in records:
        m = re.match(r"Epoch\[0\] (Train|Validation)-accuracy=([0-9.]+)",
                     r.getMessage())
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


@pytest.mark.parametrize("network", ["lenet", "mlp"])
def test_train_mnist_epoch_matches_jax(network, caplog):
    """One epoch of 512 synthetic images (8 batches of 64, SGD lr 0.05,
    momentum 0.9, wd 1e-4) through each package's ``fit``, from the
    JAX module's initial ``Xavier(gaussian, in, 2)`` parameters, with
    ``np.random`` seeded before each package's iterators (both shuffle
    with it)."""
    jutil = _jax_util()
    args = train_mnist.parse_args(["--network", network, "--num-epochs",
                                   "1"])
    X, y = common.synthetic_mnist(512)
    Xv, yv = common.synthetic_mnist(512, seed=7)
    jsym = jax_models.get_symbol(network, num_classes=10)
    init = mx.mod.Module(jsym, context=mx.cpu())
    init.bind(data_shapes=[("data", (64, 1, 28, 28))],
              label_shapes=[("softmax_label", (64,))])
    mx.random.seed(0)
    init.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    params = {k: v.asnumpy() for k, v in init.get_params()[0].items()}

    results = []
    for pkg, fit, initializer, kw in (
            (mx, jutil.fit, mx.initializer.Load(
                {k: mx.nd.array(v) for k, v in params.items()}), {}),
            (mt, common.fit, _FromDict(params), {"ctx": mt.cpu()})):
        np.random.seed(0)
        train = pkg.io.NDArrayIter(X, y, batch_size=64, shuffle=True,
                                   last_batch_handle="discard")
        val = pkg.io.NDArrayIter(Xv, yv, batch_size=64,
                                 last_batch_handle="discard")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod = fit(args, pkg.models.get_symbol(network, num_classes=10),
                      train, val, initializer=initializer, **kw)
        accs = _epoch_accuracies(caplog.records)
        accs["score"] = mod.score(val, "acc")[0][1]
        results.append((accs, {k: v.asnumpy()
                               for k, v in mod.get_params()[0].items()}))
    (jacc, jparams), (tacc, tparams) = results
    assert sorted(tacc) == ["Train", "Validation", "score"]
    for k in tacc:
        assert abs(tacc[k] - jacc[k]) <= 1 / 512 + 1e-6, (k, tacc, jacc)
    assert sorted(tparams) == sorted(jparams)
    for k in tparams:
        assert np.abs(tparams[k] - params[k]).max() > 0, k
        np.testing.assert_allclose(tparams[k], jparams[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the port's example scripts on the CPU
# ---------------------------------------------------------------------------


def test_examples_run_on_cpu_and_default_to_the_card(caplog):
    with caplog.at_level(logging.INFO):
        mod = train_imagenet.main(
            ["--network", "resnet-20", "--benchmark", "1", "--batch-size",
             "2", "--image-shape", "3,32,32", "--num-classes", "8",
             "--num-batches", "3", "--disp-batches", "1"], ctx=mt.cpu())
    assert "Speed:" in caplog.text and "Epoch[0]" in caplog.text
    assert mod._context == [mt.cpu()]
    rates = benchmark_score.main(["--networks", "lenet,mlp",
                                  "--batch-sizes", "1,3", "--num-batches",
                                  "2", "--cpu"])
    assert sorted(rates) == [("lenet", 1), ("lenet", 3), ("mlp", 1),
                             ("mlp", 3)]
    assert all(r > 0 for r in rates.values())
    if not torch.cuda.is_available():  # gpu(0) is the default device
        with pytest.raises(mt.MXNetError, match="CUDA"):
            train_mnist.main(["--num-epochs", "1"])


@pytest.mark.parametrize("argv,match", [
    (["--kv-store", "device"], "--kv-store device"),
    (["--model-prefix", "ck"], "--model-prefix"),
    (["--load-epoch", "3"], "--load-epoch"),
    (["--monitor", "5"], "--monitor"),
    (["--profile", "trace.json"], "--profile"),
    (["--data-dir", "data/mnist"], "MNISTIter"),
])
def test_examples_refuse_what_is_not_ported(argv, match):
    with pytest.raises(mt.MXNetError, match=match):
        train_mnist.main(argv + ["--num-epochs", "1"], ctx=mt.cpu())


def test_train_imagenet_refuses_record_files():
    with pytest.raises(mt.MXNetError, match="ImageRecordIter"):
        train_imagenet.main(["--data-train", "train.rec"], ctx=mt.cpu())
