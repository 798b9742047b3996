"""``mt.mod.SequentialModule``, ``PythonModule`` and ``PythonLossModule``
against the JAX package's on the CPU (``mxnet_tpu/module/
sequential_module.py:21``, ``python_module.py:24, 97``), mirroring
``tests/test_bucketing.py:136-175``: the MLP split into two modules
(``take_labels``, ``auto_wiring``) and a ``FullyConnected`` module
followed by a host-code cross-entropy loss.

Weights are copied from the JAX run's start: each training step's
parameters match the JAX package's within rtol 1e-5, atol 1e-6 (the
MLP tolerance of ``test_torch_fused_step.py``), the chain's first step
equals one ``Module`` over the whole MLP, and the accuracies the JAX
tests ask for are reached."""

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)


def _ctx(pkg):
    return pkg.cpu()


def _xy(seed, n, d, k):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(d, k), axis=1).astype(np.float32)
    return X, y


def _chain(pkg):
    d1 = pkg.sym.Variable("data")
    feat = pkg.sym.Activation(
        pkg.sym.FullyConnected(d1, num_hidden=24, name="fc1"),
        act_type="relu", name="relu1")
    m1 = pkg.mod.Module(feat, label_names=None, context=_ctx(pkg))
    d2 = pkg.sym.Variable("data")
    head = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(d2, num_hidden=3, name="fc2"), name="softmax")
    m2 = pkg.mod.Module(head, context=_ctx(pkg))
    seq = pkg.mod.SequentialModule()
    seq.add(m1).add(m2, take_labels=True, auto_wiring=True)
    return seq


def _whole(pkg):
    x = pkg.sym.Variable("data")
    x = pkg.sym.Activation(pkg.sym.FullyConnected(x, num_hidden=24,
                                                  name="fc1"),
                           act_type="relu", name="relu1")
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.mod.Module(pkg.sym.SoftmaxOutput(x, name="softmax"),
                          context=_ctx(pkg))


def _start(seed=5):
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (24, 10), "fc1_bias": (24,),
              "fc2_weight": (3, 24), "fc2_bias": (3,)}
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _ready(pkg, mod, it, start, lr=0.3):
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=_ctx(pkg))
                                for n, v in start.items()},
                    allow_missing=False)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": lr})
    return mod


def _params(mod):
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_sequential_steps_as_jax():
    X, y = _xy(3, 200, 10, 3)
    start = _start()
    mods = {}
    for pkg in (mt, mx):
        it = pkg.io.NDArrayIter(X, y, batch_size=20)
        mod = _ready(pkg, _chain(pkg), it, start)
        for b in it:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
        mods[pkg.__name__] = mod
    mine, theirs = _params(mods["mxnet_tpu_torch"]), \
        _params(mods["mxnet_tpu"])
    assert set(mine) == set(theirs) == set(start)
    for n in mine:
        np.testing.assert_allclose(mine[n], theirs[n], **TOL, err_msg=n)


def test_sequential_first_step_equals_one_module():
    X, y = _xy(3, 20, 10, 3)
    start = _start()
    got = []
    for make in (_chain, _whole):
        it = mt.io.NDArrayIter(X, y, batch_size=20)
        mod = _ready(mt, make(mt), it, start)
        b = next(iter(it))
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        got.append((_params(mod), mod.get_outputs()[0].asnumpy()))
    for n in start:
        np.testing.assert_allclose(got[0][0][n], got[1][0][n], **TOL)
    np.testing.assert_allclose(got[0][1], got[1][1], **TOL)


def test_sequential_module_trains():
    """tests/test_bucketing.py::test_sequential_module_trains."""
    np.random.seed(3)
    X, y = _xy(3, 200, 10, 3)
    seq = _chain(mt)
    it = mt.io.NDArrayIter(X, y, batch_size=20, shuffle=True)
    seq.fit(it, num_epoch=8, optimizer="sgd",
            optimizer_params={"learning_rate": 0.3})
    score = seq.score(mt.io.NDArrayIter(X, y, batch_size=20), "acc")
    assert score[0][1] > 0.85, score
    assert seq.data_names == ["data"]
    assert seq.output_names == ["softmax_output"]
    assert seq.output_shapes == [("softmax_output", (20, 3))]


def _ce_grad(scores, labels):
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(int)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(lab)), lab] -= 1.0
    return p / len(lab)


def _loss_chain(pkg):
    d = pkg.sym.Variable("data")
    logits = pkg.sym.FullyConnected(d, num_hidden=2, name="fc")
    m1 = pkg.mod.Module(logits, label_names=None, context=_ctx(pkg))
    loss = pkg.mod.PythonLossModule(grad_func=_ce_grad)
    seq = pkg.mod.SequentialModule()
    seq.add(m1).add(loss, take_labels=True, auto_wiring=True)
    return seq


def test_python_loss_module_as_jax():
    """tests/test_bucketing.py::test_python_loss_module, step for step
    against the JAX package."""
    rng = np.random.RandomState(4)
    X = rng.randn(120, 6).astype(np.float32)
    yv = (X.sum(axis=1) > 0).astype(np.float32)
    start = {"fc_weight": (0.1 * rng.randn(2, 6)).astype(np.float32),
             "fc_bias": np.zeros(2, np.float32)}
    mods = {}
    for pkg in (mt, mx):
        seq = _loss_chain(pkg)
        it = pkg.io.NDArrayIter(X, yv, batch_size=20)
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        seq.init_params(arg_params={n: pkg.nd.array(v, ctx=_ctx(pkg))
                                    for n, v in start.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "rescale_grad": 1.0})
        for _ in range(12):
            it.reset()
            for b in it:
                seq.forward(b, is_train=True)
                seq.backward()
                seq.update()
        mods[pkg.__name__] = seq
    mine, theirs = _params(mods["mxnet_tpu_torch"]), \
        _params(mods["mxnet_tpu"])
    for n in start:
        np.testing.assert_allclose(mine[n], theirs[n], **TOL, err_msg=n)
    seq = mods["mxnet_tpu_torch"]
    it = mt.io.NDArrayIter(X, yv, batch_size=20)
    correct = 0
    for b in it:
        seq.forward(b, is_train=False)
        pred = seq.get_outputs()[0].asnumpy().argmax(axis=1)
        correct += int((pred == b.label[0].asnumpy()).sum())
    assert correct / len(yv) > 0.9


def test_python_module_is_a_parameterless_stage():
    class Double(mt.mod.PythonModule):
        def __init__(self):
            super().__init__(["data"], None, ["double_output"])
            self._out = None

        def _compute_output_shapes(self):
            return [("double_output", self._data_shapes[0][1])]

        def forward(self, data_batch, is_train=None):
            self._out = data_batch.data[0] * 2

        def get_outputs(self, merge_multi_context=True):
            return [self._out]

    d = Double()
    d.bind(data_shapes=[("data", (2, 3))])
    d.init_params()
    d.init_optimizer()
    assert d.get_params() == ({}, {}) and d.output_shapes == \
        [("double_output", (2, 3))]
    d.forward(mt.io.DataBatch([mt.nd.ones((2, 3), ctx=mt.cpu())], None))
    np.testing.assert_array_equal(d.get_outputs()[0].asnumpy(),
                                  np.full((2, 3), 2.0, np.float32))
    d.update()
    d.install_monitor(mt.Monitor(1))


def test_sequential_refuses_what_the_reference_refuses():
    seq = mt.mod.SequentialModule()
    with pytest.raises(mt.MXNetError, match="Unknown meta"):
        seq.add(_whole(mt), take_label=True)
    with pytest.raises(mt.MXNetError, match="no module"):
        seq.bind(data_shapes=[("data", (2, 10))])
    seq = _chain(mt)
    with pytest.raises(mt.MXNetError, match="Shared module"):
        seq.bind(data_shapes=[("data", (2, 10))],
                 label_shapes=[("softmax_label", (2,))],
                 shared_module=_whole(mt))
    dup = mt.mod.SequentialModule()
    dup.add(_whole(mt)).add(_whole(mt), auto_wiring=True)
    dup.bind(data_shapes=[("data", (2, 10))],
             label_shapes=[("softmax_label", (2,))])
    with pytest.raises(mt.MXNetError, match="Duplicate parameter names"):
        dup.init_params()
