"""The port's metrics beyond ``Accuracy``/``Perplexity``/``CrossEntropy``
/``Loss`` against the JAX package's on the CPU: ``TopKAccuracy``, ``F1``,
``MAE``, ``MSE``, ``RMSE``, ``Torch``, ``Caffe``, ``CustomMetric``,
``np()``, ``CompositeEvalMetric`` and ``create`` of a list or a callable
(``mxnet_tpu/metric.py``), with ``tests/test_metric.py``'s cases and
seeded random batches: the same names, values within rtol 1e-6.
``TopKAccuracy`` and the regression metrics count NDArray predictions
where they lie (a device scalar, read by ``get``) and equal their numpy
path."""

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-7)


def _nd(pkg, x):
    x = np.asarray(x, np.float32)
    return pkg.nd.array(x, ctx=pkg.cpu()) if pkg is mt else pkg.nd.array(x)


def _both(make, labels, preds, as_nd=True):
    """``make(pkg)`` updated with the same batches in both packages →
    (port's get(), JAX's get())."""
    out = []
    for pkg in (mt, mx):
        m = make(pkg)
        for lab, pred in zip(labels, preds):
            if as_nd:
                m.update([_nd(pkg, lab)], [_nd(pkg, pred)])
            else:
                m.update([np.asarray(lab)], [np.asarray(pred)])
        out.append(m.get())
    return out


def _assert_same(got, want):
    assert got[0] == want[0]
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(want[1], np.float64), **TOL)


# tests/test_metric.py's cases
def test_topk_as_test_metric():
    preds = [[[0.1, 0.5, 0.4], [0.7, 0.2, 0.1]]]
    _assert_same(*_both(lambda p: p.metric.TopKAccuracy(top_k=2),
                        [[2, 1]], preds))
    got, want = _both(lambda p: p.metric.TopKAccuracy(top_k=2), [[0, 1]],
                      preds)
    _assert_same(got, want)
    assert abs(got[1] - 0.5) < 1e-6


def test_mse_mae_rmse_as_test_metric():
    pred, label = [[[1.0], [2.0]]], [[1.5, 2.5]]
    for cls, value in (("MSE", 0.25), ("MAE", 0.5), ("RMSE", 0.5)):
        got, want = _both(lambda p: getattr(p.metric, cls)(), label, pred)
        _assert_same(got, want)
        assert abs(got[1] - value) < 1e-6


def test_cross_entropy_f1_as_test_metric():
    pred, label = [[[0.9, 0.1], [0.2, 0.8]]], [[0, 1]]
    got, want = _both(lambda p: p.metric.F1(), label, pred)
    _assert_same(got, want)
    assert got[1] == 1.0
    _assert_same(*_both(lambda p: p.metric.CrossEntropy(), label, pred))


def test_composite_and_custom_as_test_metric():
    got, want = _both(lambda p: p.metric.CompositeEvalMetric(
        metrics=["acc", "mse"]), [[1]], [[[0.1, 0.9]]])
    assert got[0] == want[0] == ["accuracy", "mse"]
    np.testing.assert_allclose(got[1], want[1], **TOL)

    def my_metric(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum())

    got, want = _both(lambda p: p.metric.np(my_metric), [[1]],
                      [[[0.9, 0.1]]], as_nd=False)
    _assert_same(got, want)
    assert got == ("my_metric", 1.0)


def test_create_factory_as_test_metric():
    assert isinstance(mt.metric.create("acc"), mt.metric.Accuracy)
    comp = mt.metric.create(["acc", "ce"])
    assert isinstance(comp, mt.metric.CompositeEvalMetric)
    assert [type(m).__name__ for m in comp.metrics] == \
        [type(m).__name__ for m in mx.metric.create(["acc", "ce"]).metrics]
    m = mt.metric.create(lambda l, p: 0.0)
    assert isinstance(m, mt.metric.CustomMetric)
    assert m.name == mx.metric.create(lambda l, p: 0.0).name
    for name in ("topkaccuracy", "f1", "mae", "mse", "rmse", "torch",
                 "caffe", "loss"):
        kw = {"top_k": 3} if name == "topkaccuracy" else {}
        assert mt.metric.create(name, **kw).get()[0] == \
            mx.metric.create(name, **kw).get()[0]


# seeded random batches
def _classification(seed, n=32, c=7, batches=3):
    rng = np.random.RandomState(seed)
    preds = [rng.rand(n, c).astype(np.float32) for _ in range(batches)]
    labels = [rng.randint(0, c, n).astype(np.float32)
              for _ in range(batches)]
    return labels, preds


@pytest.mark.parametrize("as_nd", [True, False], ids=["ndarray", "numpy"])
@pytest.mark.parametrize("top_k", [2, 3, 9])
def test_topk_random_batches_as_jax(top_k, as_nd):
    labels, preds = _classification(top_k)
    _assert_same(*_both(lambda p: p.metric.TopKAccuracy(top_k=top_k),
                        labels, preds, as_nd))


def test_topk_counts_on_the_device():
    labels, preds = _classification(5)
    m = mt.metric.TopKAccuracy(top_k=3)
    for lab, pred in zip(labels, preds):
        m.update([_nd(mt, lab)], [_nd(mt, pred)])
    assert m._dev is not None and m.num_inst == 0  # nothing read back yet
    want = mt.metric.TopKAccuracy(top_k=3)
    for lab, pred in zip(labels, preds):
        want.update([lab], [pred])
    assert m.get() == want.get()
    m.reset()
    assert m._dev is None and m.num_inst == 0


@pytest.mark.parametrize("label_shape", ["column", "flat"])
@pytest.mark.parametrize("as_nd", [True, False], ids=["ndarray", "numpy"])
@pytest.mark.parametrize("cls", ["MAE", "MSE", "RMSE"])
def test_regression_random_batches_as_jax(cls, as_nd, label_shape):
    rng = np.random.RandomState(len(cls))
    preds = [rng.randn(16, 1).astype(np.float32) for _ in range(3)]
    labels = [rng.randn(16).astype(np.float32) for _ in range(3)]
    if label_shape == "column":
        labels = [x.reshape(16, 1) for x in labels]
    got, want = _both(lambda p: getattr(p.metric, cls)(), labels, preds,
                      as_nd)
    _assert_same(got, want)


def test_regression_counts_on_the_device():
    m = mt.metric.MSE()
    m.update([_nd(mt, [1.0, 2.0])], [_nd(mt, [[1.5], [2.5]])])
    assert m._dev is not None and m.num_inst == 0
    assert m.get() == ("mse", 0.25)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_random_batches_as_jax(seed):
    rng = np.random.RandomState(seed)
    preds = [rng.rand(20, 2).astype(np.float32) for _ in range(3)]
    labels = [rng.randint(0, 2, 20).astype(np.float32) for _ in range(3)]
    _assert_same(*_both(lambda p: p.metric.F1(), labels, preds))


def test_f1_refuses_more_than_two_classes():
    m = mt.metric.F1()
    with pytest.raises(ValueError, match="binary"):
        m.update([np.array([0, 1, 2])], [np.zeros((3, 2), np.float32)])


@pytest.mark.parametrize("cls", ["Torch", "Caffe", "Loss"])
def test_loss_metrics_as_jax(cls):
    rng = np.random.RandomState(3)
    preds = [rng.rand(6, 4).astype(np.float32) for _ in range(2)]
    # a loss metric reads no label
    _assert_same(*_both(lambda p: getattr(p.metric, cls)(), preds, preds))


def test_custom_metric_with_a_count_and_extra_outputs():
    def hits(label, pred):
        return int((pred.argmax(1) == label).sum()), label.shape[0]

    labels, preds = _classification(8)
    got, want = _both(lambda p: p.metric.CustomMetric(
        hits, allow_extra_outputs=True), labels, preds)
    _assert_same(got, want)
    assert got[0] == "hits"


def test_composite_of_every_metric_in_one_update():
    labels, preds = _classification(9, c=2)
    names = ["acc", "ce", "f1", "mae"]
    got, want = _both(lambda p: p.metric.create(names), labels, preds)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    comp = mt.metric.create(names)
    assert isinstance(comp.get_metric(2), mt.metric.F1)
    with pytest.raises(ValueError):
        comp.get_metric(4)
    comp.update([_nd(mt, labels[0])], [_nd(mt, preds[0])])
    comp.reset()
    assert all(np.isnan(v) for v in comp.get()[1])


def test_fit_scores_a_metric_list():
    """``Module.fit`` and ``score`` take a list of metric names."""
    rng = np.random.RandomState(0)
    X = rng.randn(40, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    it = mt.io.NDArrayIter(X, y, batch_size=10)
    mod.fit(it, num_epoch=2, eval_metric=["acc", "ce"],
            optimizer_params={"learning_rate": 0.5})
    res = mod.score(mt.io.NDArrayIter(X, y, batch_size=10),
                    ["acc", "ce"])
    assert [n for n, _ in res] == ["accuracy", "cross-entropy"]
    assert all(np.isfinite(v) for _, v in res)
