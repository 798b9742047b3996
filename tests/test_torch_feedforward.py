"""``mt.model.FeedForward`` against the JAX package's ``mx.model.
FeedForward`` on the CPU (``mxnet_tpu/model.py:194-292``): ``fit``,
``predict``, ``score``, ``save``, ``load`` and ``create`` on one
context.

From the same starting parameters (``arg_params``) the two train an MLP
alike: parameters after 4 epochs of SGD within rtol 1e-5, atol 1e-6
(``test_torch_fused_step.py``'s MLP tolerance), predictions within the
same, and equal accuracies.  The files ``save`` writes load in the
other package.  A kvstore other than None/'local' raises, naming queue
A item 9."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(pkg):
    x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=16,
                               name="fc1")
    x = pkg.sym.Activation(x, act_type="relu")
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _data(n=400, seed=0):
    """Three classes of the argmax of one fixed projection."""
    W = np.random.RandomState(11).randn(8, 3)
    X = np.random.RandomState(seed).randn(n, 8).astype(np.float32)
    return X, np.argmax(X @ W, axis=1).astype(np.float32)


def _start():
    rng = np.random.RandomState(7)
    shapes = {"fc1_weight": (16, 8), "fc1_bias": (16,),
              "fc2_weight": (3, 16), "fc2_bias": (3,)}
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _model(pkg, **kw):
    ctx = pkg.cpu()
    params = {n: pkg.nd.array(v, ctx=ctx) for n, v in _start().items()}
    return pkg.model.FeedForward(_mlp(pkg), ctx=ctx, num_epoch=4,
                                 optimizer="sgd", learning_rate=0.1,
                                 momentum=0.9, numpy_batch_size=20,
                                 arg_params=params, **kw)


def _np_params(model):
    return {n: v.asnumpy() for n, v in model.arg_params.items()}


def test_fit_predict_score_as_jax():
    X, y = _data()
    mine, theirs = _model(mt), _model(mx)
    mine.fit(X, y)
    theirs.fit(X, y)
    a, b = _np_params(mine), _np_params(theirs)
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_allclose(a[n], b[n], **TOL, err_msg=n)
    Xt, yt = _data(60, seed=1)
    pa, pb = mine.predict(Xt), theirs.predict(Xt)
    assert pa.shape == pb.shape == (60, 3)
    np.testing.assert_allclose(pa, pb, **TOL)
    sa, sb = mine.score(Xt, yt), theirs.score(Xt, yt)
    assert sa == pytest.approx(sb) and sa > 0.8


def test_fit_over_a_data_iter_with_eval_data():
    X, y = _data()
    model = _model(mt)
    train = mt.io.NDArrayIter(X, y, batch_size=20, shuffle=True)
    val = mt.io.NDArrayIter(*_data(40, seed=2), batch_size=20)
    model.fit(train, eval_data=val, eval_metric=["acc", "ce"])
    assert model.score(val) > 0.8


def test_save_and_load_across_packages(tmp_path):
    X, y = _data()
    model = _model(mt)
    model.fit(X, y)
    prefix = str(tmp_path / "ff")
    model.save(prefix)
    theirs = mx.model.FeedForward.load(prefix, 4, ctx=mx.cpu(),
                                       numpy_batch_size=20)
    Xt, _ = _data(40, seed=3)
    np.testing.assert_allclose(theirs.predict(Xt), model.predict(Xt), **TOL)
    back = mt.model.FeedForward.load(prefix, 4, ctx=mt.cpu(),
                                     numpy_batch_size=20)
    assert back.begin_epoch == 4
    np.testing.assert_array_equal(back.predict(Xt), model.predict(Xt))
    jprefix = str(tmp_path / "jff")
    theirs.save(jprefix, epoch=5)
    again = mt.model.FeedForward.load(jprefix, 5, ctx=mt.cpu(),
                                      numpy_batch_size=20)
    np.testing.assert_allclose(again.predict(Xt), model.predict(Xt), **TOL)


def test_create_trains_in_one_call():
    X, y = _data()
    params = {n: mt.nd.array(v, ctx=mt.cpu()) for n, v in _start().items()}
    model = mt.model.FeedForward.create(
        _mlp(mt), X, y, ctx=mt.cpu(), num_epoch=4, learning_rate=0.1,
        momentum=0.9, numpy_batch_size=20, arg_params=params)
    theirs = _model(mx)
    theirs.fit(X, y)
    for n, v in _np_params(theirs).items():
        np.testing.assert_allclose(model.arg_params[n].asnumpy(), v, **TOL)


@pytest.mark.parametrize("kvstore", ["device", "dist_sync"])
def test_other_kvstores_raise(kvstore):
    X, y = _data()
    with pytest.raises(mt.MXNetError, match="item 9"):
        _model(mt).fit(X, y, kvstore=kvstore)


def test_default_context_is_the_card():
    model = mt.model.FeedForward(_mlp(mt), num_epoch=1, numpy_batch_size=20)
    X, y = _data()
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="CUDA"):
            model.fit(X, y)
