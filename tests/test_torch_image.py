"""The port's image-classification path against the JAX package on the
CPU: the model zoo's symbols (``get_symbol``: arguments, aux states and
inferred shapes, for every family and ResNet-50's s2d stem), one
forward and one SGD step of Inception-BN, AlexNet (the JAX Module's
dropout masks injected) and a ResNet with the s2d stem against the JAX
``Module``, ``lr_scheduler``, ``io.ResizeIter``, ``Accuracy``
(counted where the predictions lie, and on the host),
``nd.concatenate``, ``Module.predict``/``iter_predict`` with a padded
last batch, and the ``train_mnist`` path through the examples' ``fit``
(``mxnet_tpu_torch/examples/common.py`` against
``examples/common/util.py``) for LeNet and the MLP; then the port's
example scripts on ``cpu()`` and what they refuse.

Data and parameters come from numpy seeds (the MNIST run's initial
parameters from the JAX module's ``Xavier``).  Tolerances: the
schedulers, iterators and metrics are exact; the family steps rtol
1e-4, atol 1e-6 scaled by each array's largest value (as
``test_torch_batchnorm.py``'s first ResNet step: convolutions summed in
another order, then an SGD step); ``predict`` float32 rtol
1e-5, atol 1e-6 (an MLP, sums in another order); the MNIST epoch's
accuracies within one sample of 512 and its final parameters rtol 1e-5,
atol 1e-6 (eight SGD steps with momentum; ~3e-7 measured).
"""

import importlib.util
import logging
import os
import re

import numpy as np
import jax
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import (benchmark_score, common, train_imagenet,
                                      train_mnist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the module: ``mt.models.resnet`` is its factory function
T_RESNET = importlib.import_module("mxnet_tpu_torch.models.resnet")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# symbols
# ---------------------------------------------------------------------------


IMAGENET = dict(num_classes=1000, image_shape=(3, 224, 224))
SYMBOLS = {
    "mlp": ("mlp", dict(num_classes=10), (2, 1, 28, 28)),
    "lenet": ("lenet", dict(num_classes=10), (2, 1, 28, 28)),
    "resnet-18": ("resnet-18", IMAGENET, (2, 3, 224, 224)),
    "resnet-50": ("resnet-50", IMAGENET, (2, 3, 224, 224)),
    "resnet-50-s2d": ("resnet-50", dict(IMAGENET, stem="s2d"),
                      (2, 3, 224, 224)),
    "resnet-20": ("resnet-20", dict(num_classes=10, image_shape=(3, 32, 32)),
                  (2, 3, 32, 32)),
    "alexnet": ("alexnet", IMAGENET, (2, 3, 224, 224)),
    "vgg": ("vgg", IMAGENET, (2, 3, 224, 224)),
    "inception-bn": ("inception-bn", IMAGENET, (2, 3, 224, 224)),
    "inception-v3": ("inception-v3", dict(num_classes=1000,
                                          image_shape=(3, 299, 299)),
                     (2, 3, 299, 299)),
}


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_get_symbol_matches_jax(name):
    network, kwargs, dshape = SYMBOLS[name]
    j = jax_models.get_symbol(network, **kwargs)
    t = mt.models.get_symbol(network, **kwargs)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    shapes = dict(data=dshape, softmax_label=(dshape[0],))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    if name.startswith("resnet-50"):  # 157 parameters, 102 statistics
        assert len(t.list_arguments()) == 159
        assert len(t.list_auxiliary_states()) == 102
    if name == "inception-v3":  # the global pool sees 8x8 at 299
        internals = t.get_internals()
        _, outs, _ = internals.infer_shape(**shapes)
        pooled = dict(zip(internals.list_outputs(), outs))
        assert pooled["ch_concat_mixed_10_chconcat_output"][2:] == (8, 8)


def test_get_symbol_refuses_what_is_not_ported():
    """Every family of the JAX zoo builds, and ResNet's s2d stem (its
    ``space_to_depth`` node and the 4x4 conv0); an unknown network or
    stem raises."""
    for name in ("alexnet", "vgg", "inception-bn", "inception_bn",
                 "inception-v3", "inception_v3"):
        assert mt.models.get_symbol(name).list_outputs() == \
            ["softmax_output"]
    s2d = mt.models.get_symbol("resnet-50", stem="s2d")
    ops = {n.name: n.op for n in s2d._topo()}
    assert ops["s2d"] == "space_to_depth"
    assert s2d.infer_shape(data=(1, 3, 224, 224))[0][
        s2d.list_arguments().index("conv0_weight")] == (64, 12, 4, 4)
    with pytest.raises(ValueError, match="unknown stem"):
        mt.models.get_symbol("resnet-50", stem="s4d")
    with pytest.raises(mt.MXNetError, match="unknown network"):
        mt.models.get_symbol("googlenet")


def test_s2d_stem_with_the_conv7_weight_computes_the_conv7_stem():
    """``conv7_to_s2d_weight`` carries a 7x7/stride-2 conv0 weight into
    the s2d stem, whose forward then equals the conv7 network's (the
    same rearrangement as the JAX package's; float32 sums in another
    order, rtol=atol=1e-5)."""
    kw = dict(units=[1, 1], num_stages=2, filter_list=[8, 8, 16],
              num_classes=5, image_shape=(3, 48, 48), bottle_neck=False)
    conv7, s2d = (T_RESNET.resnet(stem=stem, **kw)
                  for stem in ("conv7", "s2d"))
    shapes = dict(data=(2, 3, 48, 48), softmax_label=(2,))
    rng = np.random.RandomState(3)
    args = {n: (rng.randn(*sh) * 0.3).astype(np.float32) for n, sh in zip(
        conv7.list_arguments(), conv7.infer_shape(**shapes)[0])}
    args["data"] = rng.rand(2, 3, 48, 48).astype(np.float32)
    aux = {n: np.full(sh, 1.0 if n.endswith("var") else 0.0, np.float32)
           for n, sh in zip(conv7.list_auxiliary_states(),
                            conv7.infer_shape(**shapes)[2])}
    outs = []
    for sym, w0 in ((conv7, args["conv0_weight"]),
                    (s2d, T_RESNET.conv7_to_s2d_weight(
                        args["conv0_weight"]))):
        fn = mt.executor.build_graph_fn(sym)
        t = {n: torch.from_numpy(v) for n, v in dict(
            args, conv0_weight=w0).items()}
        outs.append(fn(t, {n: torch.from_numpy(v) for n, v in aux.items()},
                       0, False)[0][0])
    assert [n.op for n in s2d._topo()].count("space_to_depth") == 1
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# one step of the new families against the JAX Module
# ---------------------------------------------------------------------------


STEP = dict(rtol=1e-4, atol=1e-6)
KEY = jax.random.PRNGKey(3)


def _s2d_resnet(pkg):
    """ResNet-20's units and widths on the ImageNet branch (3x64x64),
    where the s2d stem applies (the cifar branch, ResNet-20's own, has a
    3x3 stem either way)."""
    return importlib.import_module(pkg.__name__ + ".models.resnet").resnet(
        units=[3, 3, 3], num_stages=3, filter_list=[16, 16, 32, 64],
        num_classes=10, image_shape=(3, 64, 64), bottle_neck=False,
        stem="s2d")


FAMILY_STEPS = {
    # network builder, data shape (AlexNet's smallest image: 67 pixels)
    # at 3x32x32 the last BatchNorms see 1x1 maps, two values a channel,
    # where the forward's float32 misses float64 by ~1e-3 in both
    # packages; 64 leaves 2x2 (8 values), where both forwards agree with
    # float64 to ~1e-5 (the step's gradients: STEP_NORM)
    "inception-bn": (lambda pkg: pkg.models.get_symbol(
        "inception-bn", num_classes=10), (2, 3, 64, 64)),
    "alexnet": (lambda pkg: pkg.models.get_symbol("alexnet",
                                                  num_classes=10),
                (2, 3, 67, 67)),
    "resnet-s2d": (_s2d_resnet, (2, 3, 64, 64)),
}


# Inception-BN's first-step gradients are ill-conditioned in float32 in
# both packages: a pre-activation within float32 noise of a ReLU's kink,
# after a BatchNorm over 8 values a channel, flips its mask in one
# package and not the other (here one element of bn_5b_double_3x3_0 at
# 1.4e-4 moves five gradients by ~3%).  tools/torch_first_step_vs_jax.py
# at 3x64x64 and 3x96x96, batch 2 and 4, two data seeds: each float32
# forward flips 0-4 of 0.55-1.3 M ReLU decisions against the port's
# float64 one (JAX 2-4, the port 0-3), and the float32 gradients miss
# the float64 step by 0.15-0.54% in norm (JAX) and 0.006-3.1% (the
# port), depending on which decisions flip: so the update of every
# weight together is held in norm, at 5% of its size; a wiring fault
# moves it by order one.  Its forward is float32 noise of up to 2.1e-4 of an
# output's largest value in stages 4-5 in both packages (against
# float64), so its moving statistics are held at 5e-4 of theirs.
STEP_NORM = 0.05
STEP_IBN_AUX = dict(rtol=1e-4, atol=5e-4)


def _check_params(tmod, jmod, tol, what, weights=True):
    (ja, jx), (ta, tx) = jmod.get_params(), tmod.get_params()
    for jd, td in ((ja, ta), (jx, tx))[0 if weights else 1:]:
        assert sorted(jd) == sorted(td)
        for k in jd:
            j = jd[k].asnumpy()
            np.testing.assert_allclose(
                td[k].asnumpy(), j, rtol=tol["rtol"],
                atol=tol["atol"] * max(1.0, float(np.abs(j).max())),
                err_msg=f"{what}: {k}")


@pytest.mark.parametrize("family", sorted(FAMILY_STEPS))
def test_family_forward_and_step_match_jax(family, monkeypatch):
    """From the JAX Module's ``Xavier(gaussian, in, 2)`` parameters
    (carried over by ``params_from_numpy``): one SGD step (lr 0.01,
    momentum 0.9, wd 1e-4), its forward's outputs and then every
    argument and aux state compared (Inception-BN's weights in norm,
    ``STEP_NORM``).  AlexNet's two Dropout
    nodes take the JAX step's masks (its ``next_key`` fixed, the plain
    step path)."""
    build, dshape = FAMILY_STEPS[family]
    jsym, tsym = build(mx), build(mt)
    B = dshape[0]
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = dict(data_shapes=[("data", dshape)],
                  label_shapes=[("softmax_label", (B,))])
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    mx.random.seed(0)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    jmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tmod = mt.mod.Module(tsym, context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=mt.params_from_numpy(jmod.get_params()[0],
                                                     mt.cpu()),
                     aux_params=mt.params_from_numpy(jmod.get_params()[1],
                                                     mt.cpu()))
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    before = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}

    rng = np.random.RandomState(2)
    X = rng.rand(*dshape).astype(np.float32)
    Y = rng.randint(0, 10, B).astype(np.float32)
    jbatch = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(Y)])
    tbatch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                             [mt.nd.array(Y, ctx=mt.cpu())])
    monkeypatch.setattr(mx.random, "next_key", lambda: KEY)
    jmod.forward_backward(jbatch)
    jmod.update()
    drops = [(i, n) for i, n in enumerate(jsym._topo()) if n.op == "Dropout"]
    assert len(drops) == (2 if family == "alexnet" else 0)
    masks = []
    if drops:
        internals = jsym.get_internals()
        _, outs, _ = internals.infer_shape(data=dshape, softmax_label=(B,))
        shape_of = dict(zip(internals.list_outputs(), outs))
        masks = [np.array(jax.random.bernoulli(
            jax.random.fold_in(KEY, i), 0.5, shape_of[f"{n.name}_output"]))
            for i, n in drops]
    queue = [torch.from_numpy(m) for m in masks]
    monkeypatch.setattr(mt.ops.nn, "draw_mask",
                        lambda g, keep, shape, device: queue.pop(0))
    tmod.forward_backward(tbatch)
    tmod.update()
    assert not queue
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(),
                               err_msg="training outputs", **STEP)
    # the moving statistics come from the forward: held elementwise
    _check_params(tmod, jmod, STEP_IBN_AUX if family == "inception-bn"
                  else STEP, "after the step",
                  weights=family != "inception-bn")
    after = tmod.get_params()[0]
    if family == "inception-bn":
        jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
        diff = np.concatenate([(after[k].asnumpy() - jw[k]).ravel()
                               for k in before])
        update = np.concatenate([(jw[k] - before[k]).ravel()
                                 for k in before])
        assert np.linalg.norm(diff) <= STEP_NORM * np.linalg.norm(update)
    assert all(np.abs(after[k].asnumpy() - before[k]).max() > 0
               for k in before if not k.endswith("bn_data_gamma"))


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
    (["--model-prefix", "no/such/ck", "--load-epoch", "3"],
     "--model-prefix"),
    (["--load-epoch", "3"], "--load-epoch"),
    (["--kv-store", "dist_sync"], "--kv-store dist_sync"),
    (["--profile", "trace.json"], "--profile"),
    (["--data-dir", "data/mnist"], "MNISTIter"),
])
def test_examples_refuse_what_is_not_ported(argv, match):
    with pytest.raises(mt.MXNetError, match=match):
        train_mnist.main(argv + ["--num-epochs", "1"], ctx=mt.cpu())


def test_train_imagenet_refuses_record_files():
    with pytest.raises(mt.MXNetError, match="ImageRecordIter"):
        train_imagenet.main(["--data-train", "train.rec"], ctx=mt.cpu())
