"""``mt.Monitor`` and ``Module.get_input_grads`` against the JAX package
on the CPU (``mxnet_tpu/monitor.py``, ``tests/test_observability.py:
41, 66, 148``; ``mxnet_tpu/module/module.py:2088``,
``tests/test_module.py:85``).

A monitor taps the executor's forward: ``toc`` gives the same names in
the same order as the JAX monitor (every internal output of
``get_internals()``, then the arguments and aux states) and values
within 1e-5 (relative, and absolute for values near 0) from the same
parameters and batch.  A monitored module trains on the eager path (no
fused step, as the JAX ``_fused_ready``); ``fit(monitor=)`` logs each
collected batch; a ``BucketingModule`` taps every bucket; the examples'
``--monitor N`` installs one.  ``get_input_grads`` of a module bound
with ``inputs_need_grad`` equals the JAX module's within rtol 1e-5,
atol 1e-6, for ``Module`` and ``BucketingModule``."""

import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import train_mnist

TOL = dict(rtol=1e-5, atol=1e-5)


def _fc_softmax(pkg):
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")


def _bn_net(pkg):
    x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                               name="fc1")
    x = pkg.sym.BatchNorm(x, name="bn")
    x = pkg.sym.Activation(x, act_type="relu", name="relu")
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _ctx(pkg):
    return pkg.cpu()


def _pair(make_sym, shape, label_shape, inputs_need_grad=False,
          optimizer=True):
    """(port module, JAX module), bound alike, the port's parameters
    copied from the JAX module's."""
    mods = []
    for pkg in (mx, mt):
        mod = pkg.mod.Module(make_sym(pkg), context=_ctx(pkg))
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", label_shape)],
                 inputs_need_grad=inputs_need_grad)
        if pkg is mx:
            mod.init_params(mx.initializer.Xavier())
            arg, aux = mod.get_params()
            host = ({k: v.asnumpy() for k, v in arg.items()},
                    {k: v.asnumpy() for k, v in aux.items()})
        else:
            mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                        for k, v in host[0].items()},
                            aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                                        for k, v in host[1].items()})
        if optimizer:
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1})
        mods.append(mod)
    return mods[1], mods[0]


def _batch(pkg, X, y):
    return pkg.io.DataBatch([pkg.nd.array(X, ctx=_ctx(pkg))],
                            [pkg.nd.array(y, ctx=_ctx(pkg))])


def _assert_same_stats(got, want):
    assert [(s, k) for s, k, _ in got] == [(s, k) for s, k, _ in want]
    for (_, k, a), (_, _, b) in zip(got, want):
        va = np.array([float(x) for x in a.split()])
        vb = np.array([float(x) for x in b.split()])
        np.testing.assert_allclose(va, vb, **TOL, err_msg=k)


def _monitored(tmod, jmod, pattern, run):
    res = []
    for pkg, mod in ((mt, tmod), (mx, jmod)):
        mon = pkg.Monitor(interval=1, pattern=pattern)
        mod.install_monitor(mon)
        mon.tic()
        run(pkg, mod)
        res.append(mon.toc())
    return res


def test_monitor_collects_stats_as_jax():
    """test_observability.py:41: a forward of an inference batch."""
    rng = np.random.RandomState(0)
    X = rng.randn(10, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    tmod, jmod = _pair(_fc_softmax, (10, 6), (10,), optimizer=False)
    got, want = _monitored(tmod, jmod, ".*", lambda pkg, mod: mod.forward(
        _batch(pkg, X, y), is_train=False))
    _assert_same_stats(got, want)
    names = [k for _, k, _ in got]
    assert "fc_output" in names and "fc_weight" in names
    assert all("nan" not in v.lower() for _, _, v in got)


def test_monitor_finds_nan_as_jax():
    """test_observability.py:66: a poisoned weight shows in the stats."""
    tmod, jmod = _pair(_fc_softmax, (4, 6), (4,), optimizer=False)
    for mod in (tmod, jmod):
        bad = mod._exec.arg_dict["fc_weight"].asnumpy().copy()
        bad[0, 0] = np.nan
        mod._exec.arg_dict["fc_weight"][:] = bad
    zeros = (np.zeros((4, 6), np.float32), np.zeros(4, np.float32))
    got, want = _monitored(tmod, jmod, ".*fc.*", lambda pkg, mod: mod.forward(
        _batch(pkg, *zeros), is_train=False))
    assert [k for _, k, _ in got] == [k for _, k, _ in want]
    assert any("nan" in v.lower() for _, _, v in got)


@pytest.mark.parametrize("pattern", [".*output.*", ".*"])
def test_monitor_fires_during_training_as_jax(pattern):
    """test_observability.py:148: forward, backward and update of a
    monitored training step (a BatchNorm net: its aux states too)."""
    rng = np.random.RandomState(1)
    X = rng.randn(10, 6).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    tmod, jmod = _pair(_bn_net, (10, 6), (10,))

    def step(pkg, mod):
        mod.forward(_batch(pkg, X, y), is_train=True)
        mod.backward()
        mod.update()

    got, want = _monitored(tmod, jmod, pattern, step)
    _assert_same_stats(got, want)
    assert any("output" in k for _, k, _ in got)
    # the monitored step ran eagerly: no fused state was made
    assert tmod._fused is None and not tmod._fused_ready()


def test_monitor_interval_and_sort():
    tmod, _ = _pair(_fc_softmax, (4, 6), (4,), optimizer=False)
    mon = mt.Monitor(interval=2, pattern=".*", sort=True)
    tmod.install_monitor(mon)
    batch = _batch(mt, np.ones((4, 6), np.float32), np.zeros(4, np.float32))
    counts = []
    for _ in range(4):
        mon.tic()
        tmod.forward(batch, is_train=False)
        counts.append(len(mon.toc()))
    assert counts[0] > 0 and counts[1] == 0 and counts[2] == counts[0]
    mon.tic()
    tmod.forward(batch, is_train=False)
    mon.tic()  # the 6th batch is not collected: step 5 % 2
    names = [k for _, k, _ in mon.toc()]
    assert names == sorted(names)


def test_monitor_statistics_stay_on_the_device_until_toc(monkeypatch):
    """The tap queues NDArrays; ``toc`` alone reads them back."""
    tmod, _ = _pair(_fc_softmax, (4, 6), (4,), optimizer=False)
    mon = mt.Monitor(interval=1)
    tmod.install_monitor(mon)
    reads = []
    orig = mt.nd.NDArray.asscalar
    monkeypatch.setattr(mt.nd.NDArray, "asscalar",
                        lambda self: reads.append(1) or orig(self))
    mon.tic()
    tmod.forward(_batch(mt, np.ones((4, 6), np.float32),
                        np.zeros(4, np.float32)), is_train=False)
    assert not reads and all(isinstance(v, mt.nd.NDArray)
                             for _, _, v in mon.queue)
    res = mon.toc()
    assert len(reads) == len(res)


def test_fit_with_a_monitor_logs_each_batch(caplog):
    rng = np.random.RandomState(2)
    X = rng.randn(40, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    mod = mt.mod.Module(_fc_softmax(mt), context=mt.cpu())
    mon = mt.Monitor(interval=2, pattern=".*weight")
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(X, y, batch_size=10), num_epoch=1,
                monitor=mon, optimizer_params={"learning_rate": 0.1})
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Batch:")]
    # batches 1 and 3 (of 4), fc_weight at the forward and at toc
    assert [int(ln.split()[1]) for ln in lines] == [1, 1, 3, 3]
    assert all("fc_weight" in ln for ln in lines)
    assert mod._fused is None


def test_bucketing_module_monitors_every_bucket():
    def sym_gen(key):
        x = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                  name="fc")
        return mt.sym.SoftmaxOutput(x, name="softmax"), ("data",), \
            ("softmax_label",)

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                 context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    mon = mt.Monitor(interval=1, pattern="fc_output")
    mod.install_monitor(mon)
    for key in (6, 6):
        batch = mt.io.DataBatch(
            [mt.nd.ones((4, key), ctx=mt.cpu())],
            [mt.nd.zeros((4,), ctx=mt.cpu())], bucket_key=key,
            provide_data=[("data", (4, key))],
            provide_label=[("softmax_label", (4,))])
        mon.tic()
        mod.forward(batch, is_train=False)
        assert [k for _, k, _ in mon.toc()] == ["fc_output"]


def test_examples_monitor_flag_installs_a_monitor(caplog):
    with caplog.at_level(logging.INFO):
        train_mnist.main(["--network", "mlp", "--num-epochs", "1",
                          "--monitor", "32"], ctx=mt.cpu())
    assert any(r.getMessage().startswith("Batch:") for r in caplog.records)


# ---------------------------------------------------------------------------
# get_input_grads
# ---------------------------------------------------------------------------

def test_module_input_grads_as_jax():
    """test_module.py:85, against the JAX module's gradients."""
    rng = np.random.RandomState(3)
    X = rng.randn(4, 6).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    tmod, jmod = _pair(_bn_net, (4, 6), (4,), inputs_need_grad=True)
    got = []
    for pkg, mod in ((mt, tmod), (mx, jmod)):
        mod.forward(_batch(pkg, X, y), is_train=True)
        mod.backward()
        (din,) = mod.get_input_grads()
        assert din.shape == (4, 6)
        got.append(din.asnumpy())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)
    assert np.abs(got[0]).sum() > 0
    # the input gradient keeps the module off the fused step
    tmod.update()
    assert tmod._fused is None


def test_input_grads_need_inputs_need_grad():
    tmod, _ = _pair(_fc_softmax, (4, 6), (4,))
    with pytest.raises(mt.MXNetError, match="inputs_need_grad"):
        tmod.get_input_grads()


def test_bucketing_module_input_grads_as_jax():
    rng = np.random.RandomState(4)
    got = []
    params = {"fc_weight": rng.randn(3, 6).astype(np.float32),
              "fc_bias": rng.randn(3).astype(np.float32)}
    X = rng.randn(4, 6).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    for pkg in (mt, mx):
        def sym_gen(key, pkg=pkg):
            x = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                       num_hidden=3, name="fc")
            return pkg.sym.SoftmaxOutput(x, name="softmax"), ("data",), \
                ("softmax_label",)

        mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                      context=_ctx(pkg))
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                                    for k, v in params.items()})
        mod.forward(_batch(pkg, X, y), is_train=True)
        mod.backward()
        got.append(mod.get_input_grads()[0].asnumpy())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)
