"""The port's fused training step over LSTM-PTB's buckets on the CPU
(the companion of ``test_torch_fused_step.py``, whose helpers it uses):
(a) three steps of a ``BucketingModule`` over two buckets, a switch
each way, fused against ``MXNET_FUSED_STEP=0``, SGD with momentum and
Adam under a ``FactorScheduler``: parameters, optimizer states and
outputs bit for bit; (b) the fused ``BucketingModule`` against the JAX
one (fused by default) over six steps: outputs and parameters within
``test_torch_bucketing.py``'s PARAMS (rtol 1e-4, atol 1e-5: the
packages sum in other orders), the step counter ``t`` one count a batch
across the buckets in both packages, and one fused state for every
bucket.
"""

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

from test_torch_bucketing import (BATCH as LSTM_BATCH, H as LSTM_H,
                                  L as LSTM_L, as_batch, bucket_arrays,
                                  make_sym_gen, port_module)
from test_torch_fused_step import (OPTIMIZERS, _assert_equal, _opt_params,
                                   _snapshot)

LSTM_TOL = dict(rtol=1e-4, atol=1e-5)


def _lstm_batches():
    arrays = bucket_arrays(5, n_per_bucket=2, buckets=[4, 8])
    by = {k: [a for a in arrays if a[0] == k] for k in (4, 8)}
    return [by[8][0], by[4][0], by[8][1]]  # a switch each way


def _lstm_run(optimizer, monkeypatch, fused):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    mod = port_module()
    mod.init_optimizer(kvstore=None, optimizer=optimizer,
                       optimizer_params=_opt_params(optimizer))
    for b, data, label in _lstm_batches():
        mod.forward(as_batch(mt, b, data, label), is_train=True)
        mod.backward()
        mod.update()
    assert set(mod._buckets) == {4, 8}
    return _snapshot(mod)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fused_step_equals_the_eager_path_over_buckets(optimizer,
                                                       monkeypatch):
    eager = _lstm_run(optimizer, monkeypatch, fused=False)
    fused = _lstm_run(optimizer, monkeypatch, fused=True)
    _assert_equal(fused, eager, f"lstm {optimizer}")


def test_fused_bucketing_module_matches_jax_and_t_runs_on(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    buckets = [4, 8]
    jmod = mx.mod.BucketingModule(make_sym_gen(mx, 50, 16, LSTM_H, LSTM_L),
                                  default_bucket_key=8, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (LSTM_BATCH, 8))],
              label_shapes=[("softmax_label", (LSTM_BATCH, 8))])
    mx.random.seed(7)
    jz = mx.nd.zeros((LSTM_L, LSTM_BATCH, LSTM_H))
    jmod.init_params(mx.initializer.Uniform(0.08),
                     arg_params={"rnn_state": jz, "rnn_state_cell": jz.copy()},
                     allow_missing=True)
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tmod = port_module(arg_params=host)
    for mod in (jmod, tmod):
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params=OPTIMIZERS["sgd"])
    batches = _lstm_batches() * 2
    for b, data, label in batches:
        for lib, mod in ((mx, jmod), (mt, tmod)):
            mod.forward(as_batch(lib, b, data, label), is_train=True)
            mod.backward()
            mod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(),
                                   err_msg=f"bucket {b}", **LSTM_TOL)
    # one counter across the buckets, in both packages
    n = len(batches)
    assert int(np.asarray(jmod._curr_module._fused_t)) == n
    assert float(tmod._curr_module._fused.t) == n
    assert {id(tmod._buckets[k]._fused) for k in buckets} \
        == {id(tmod._curr_module._fused)}
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **LSTM_TOL)
