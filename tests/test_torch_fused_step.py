"""The port's fused training step (``mxnet_tpu_torch/module/fused_step.py``)
on the CPU, where it runs uncaptured: the same function a CUDA graph
records on the card.

(a) Three steps of the fused step against three of the eager path
(``MXNET_FUSED_STEP=0``: the executor's autograd pass, then the
``Updater`` a parameter), SGD with momentum and Adam under a
``FactorScheduler`` that halves the rate at the third update: a
2-layer ``transformer_lm`` and ResNet-20 at 3x32x32 with BatchNorm
(LSTM-PTB's buckets: ``test_torch_fused_bucketing.py``).
Parameters, optimizer states, aux states and outputs are equal bit for
bit: both paths run the same operations (``Optimizer.apply``, the
executor's ``_run`` and ``_backprop``); the rate and Adam's bias
correction are float64 on both sides (Python's, or 0-dim float64
tensors) before one cast to float32.
(b) The port's fused ``Module`` against the JAX ``Module``, fused by
default, after three steps from the same parameters: the MLP and
ResNet-20.
(c) ``get_outputs()`` (or ``backward(out_grads)``) before ``update()``
gives the parameters of ``update()`` alone, bit for bit.
(d) Two trainable parameters bound to one storage train as two
parameters, as in the JAX module.
(e) Dropout under the fused step: one seed draws the same masks twice,
a node's generator persists and its masks differ from step to step,
keep fractions within 6 sigma of 1 - p.
(f) ``MXNET_FUSED_STEP=0``, ``inputs_need_grad`` and a non-loss output
take the eager path; a ``Custom`` op keeps the step uncaptured.

Tolerances against the JAX package (fp32): the MLP rtol 1e-5, atol 1e-6;
ResNet-20 as its step test (``test_torch_batchnorm.py`` STEP2, rtol 2e-4
and atol 2e-4 of the largest magnitude, at its rate 0.01): the packages
sum in other orders, and ResNet's float32 steps amplify that (at rate
0.05 the third step's outputs part by 5e-4).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.resnet import get_symbol as jax_resnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import fused_step
from mxnet_tpu_torch.ops import nn as tnn

OPTIMIZERS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
              "adam": {"learning_rate": 0.01, "wd": 1e-4}}
# against the JAX package: test_torch_batchnorm.py's ResNet steps' rate
JAX_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=2e-4, atol=2e-4)
V, T, B = 61, 16, 2


def _cpu(x):
    return mt.nd.array(x, ctx=mt.cpu())


def _opt_params(optimizer):
    # a scheduler per module: it keeps its own count
    return dict(OPTIMIZERS[optimizer],
                lr_scheduler=mt.lr_scheduler.FactorScheduler(2, 0.5))


def _np(t):
    return t.detach().cpu().numpy()


def _states(mod):
    """name → the optimizer state's arrays, from the fused state or the
    Updater, whichever trained the module."""
    mod = getattr(mod, "_curr_module", mod)
    if mod._fused is not None:
        raw = mod._fused.states
    else:
        raw = {mod._param_names[i]: s for i, s in mod._updater.states.items()}
    out = {}
    for n, s in raw.items():
        s = s if isinstance(s, (tuple, list)) else (s,)
        out[n] = [_np(x) for x in s if x is not None]
    return out


def _snapshot(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()}, _states(mod),
            [o.asnumpy() for o in mod.get_outputs()])


def _assert_equal(a, b, what):
    (aa, ax, ast, ao), (ba, bx, bst, bo) = a, b
    for x, y, kind in ((aa, ba, "argument"), (ax, bx, "aux state")):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k],
                                          err_msg=f"{what}: {kind} {k}")
    assert sorted(ast) == sorted(bst) and ast
    for k in ast:
        assert len(ast[k]) == len(bst[k])
        for i, (x, y) in enumerate(zip(ast[k], bst[k])):
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: state "
                                          f"{i} of {k}")
    for i, (x, y) in enumerate(zip(ao, bo)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: output {i}")


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _lm_case():
    sym = mt.models.transformer_lm(V, T, num_layers=2, num_heads=2,
                                   d_model=32, head="ce")
    rng = np.random.RandomState(3)
    batches = [(rng.randint(1, V, (B, T)).astype(np.float32),
                rng.randint(0, V, (B, T)).astype(np.float32))
               for _ in range(3)]
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    return sym, shapes, batches, mt.initializer.Xavier(magnitude=2.0)


def _resnet_case():
    sym = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 32, 32))
    rng = np.random.RandomState(4)
    batches = [(rng.rand(4, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, 4).astype(np.float32)) for _ in range(3)]
    shapes = dict(data_shapes=[("data", (4, 3, 32, 32))],
                  label_shapes=[("softmax_label", (4,))])
    return sym, shapes, batches, mt.initializer.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2)


def _module_run(case, optimizer, monkeypatch, fused):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    sym, shapes, batches, init = case
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(**shapes)
    mt.random.seed(5)
    mod.init_params(init)
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=_opt_params(optimizer))
    for X, Y in batches:
        mod.forward_backward(mt.io.DataBatch([_cpu(X)], [_cpu(Y)]))
        mod.update()
    assert (mod._fused is not None) == fused
    assert bool(mod._updater.states) != fused
    return _snapshot(mod)


# ---------------------------------------------------------------------------
# (a) fused against eager, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("model", ["transformer_lm", "resnet-20"])
def test_fused_step_equals_the_eager_path(model, optimizer, monkeypatch):
    case = _lm_case() if model == "transformer_lm" else _resnet_case()
    eager = _module_run(case, optimizer, monkeypatch, fused=False)
    fused = _module_run(case, optimizer, monkeypatch, fused=True)
    _assert_equal(fused, eager, f"{model} {optimizer}")
    if model == "resnet-20":  # the moving statistics moved
        assert any(np.abs(v).max() > 0 for v in fused[1].values())


def test_rate_and_t_live_on_the_device_and_follow_the_scheduler(
        monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    sym, shapes, batches, init = _lm_case()
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(**shapes)
    mod.init_params(init)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=_opt_params("sgd"))
    lrs = []
    for X, Y in batches:
        mod.forward_backward(mt.io.DataBatch([_cpu(X)], [_cpu(Y)]))
        mod.update()
        lrs.append(float(mod._fused.lr))
    fs = mod._fused
    assert lrs == [0.05, 0.05, 0.025]  # halved after the second update
    assert fs.t.dtype == fs.lr.dtype == torch.float64 and fs.t.dim() == 0
    assert float(fs.t) == 3 and fs.step_count == 3
    assert mod._optimizer.num_update == 3


# ---------------------------------------------------------------------------
# (b) the port's fused Module against the JAX Module (fused by default)
# ---------------------------------------------------------------------------


def _jax_pair(jsym, tsym, shapes, aux_seed=None):
    mx.random.seed(0)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    if aux_seed is not None:
        rng = np.random.RandomState(aux_seed)
        aux = {k: (rng.randn(*v.shape) * 0.1 if k.endswith("_mean")
                   else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
               for k, v in jmod.get_params()[1].items()}
        jmod.set_params(jmod.get_params()[0],
                        {k: mx.nd.array(v) for k, v in aux.items()})
    tmod = mt.mod.Module(tsym, context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(
        arg_params=mt.params_from_numpy(jmod.get_params()[0], mt.cpu()),
        aux_params=mt.params_from_numpy(jmod.get_params()[1], mt.cpu()))
    for mod in (jmod, tmod):
        mod.init_optimizer(optimizer="sgd", optimizer_params=JAX_SGD)
    return jmod, tmod


def _assert_close(tmod, jmod, tol, what):
    (ja, jx), (ta, tx) = jmod.get_params(), tmod.get_params()
    for jd, td in ((ja, ta), (jx, tx)):
        assert sorted(jd) == sorted(td)
        for k in jd:
            j = jd[k].asnumpy()
            np.testing.assert_allclose(
                td[k].asnumpy(), j, rtol=tol["rtol"],
                atol=tol["atol"] * max(1.0, float(np.abs(j).max())),
                err_msg=f"{what}: {k}")


@pytest.mark.parametrize("model", ["mlp", "resnet-20"])
def test_fused_module_matches_the_jax_module(model, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    if model == "mlp":
        jsym = mx.models.get_symbol("mlp", num_classes=10)
        tsym = mt.models.get_symbol("mlp", num_classes=10)
        dshape, tol, aux_seed = (8, 1, 28, 28), MLP_TOL, None
    else:
        kw = dict(num_classes=10, num_layers=20, image_shape=(3, 32, 32))
        jsym, tsym = jax_resnet(**kw), mt.models.resnet(**kw)
        dshape, tol, aux_seed = (4, 3, 32, 32), RESNET_TOL, 1
    shapes = dict(data_shapes=[("data", dshape)],
                  label_shapes=[("softmax_label", (dshape[0],))])
    jmod, tmod = _jax_pair(jsym, tsym, shapes, aux_seed)
    rng = np.random.RandomState(6)
    for step in range(3):
        X = rng.rand(*dshape).astype(np.float32)
        Y = rng.randint(0, 10, dshape[0]).astype(np.float32)
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                              [mx.nd.array(Y)]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch([_cpu(X)], [_cpu(Y)]))
        tmod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(),
                                   err_msg=f"step {step}", **tol)
    assert jmod._fused_step is not None and tmod._fused is not None
    assert int(np.asarray(jmod._fused_t)) == float(tmod._fused.t) == 3
    _assert_close(tmod, jmod, tol, f"{model} after 3 steps")


# ---------------------------------------------------------------------------
# (c) outputs before update(): the eager pass, then the same fused state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("early", ["get_outputs", "out_grads"])
def test_outputs_before_update_give_the_same_parameters(early,
                                                        monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    sym, shapes, batches, init = _lm_case()
    mods = []
    for _ in range(2):
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.bind(**shapes)
        mt.random.seed(5)
        mod.init_params(init)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params=_opt_params("adam"))
        mods.append(mod)
    plain, early_mod = mods
    for X, Y in batches:
        batch = mt.io.DataBatch([_cpu(X)], [_cpu(Y)])
        plain.forward(batch, is_train=True)
        plain.backward()
        plain.update()
        early_mod.forward(batch, is_train=True)
        if early == "get_outputs":
            outs = [o.asnumpy() for o in early_mod.get_outputs()]
            assert early_mod._pending_batch is None
            early_mod.backward()  # ran already: a no-op
        else:
            early_mod.backward(out_grads=[mt.nd.ones((B, T), ctx=mt.cpu())])
            outs = [o.asnumpy() for o in early_mod.get_outputs()]
        early_mod.update()
        for x, y in zip(outs, plain.get_outputs()):
            np.testing.assert_array_equal(x, y.asnumpy())
    _assert_equal(_snapshot(early_mod), _snapshot(plain), early)
    assert float(early_mod._fused.t) == 3
    assert not early_mod._updater.states  # one optimizer state


def test_kept_outputs_are_not_overwritten_by_the_next_step(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    sym, shapes, batches, init = _lm_case()
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(**shapes)
    mod.init_params(init)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPTIMIZERS["sgd"])
    kept = []
    for X, Y in batches:
        mod.forward_backward(mt.io.DataBatch([_cpu(X)], [_cpu(Y)]))
        mod.update()
        kept.append((mod.get_outputs()[0], mod.get_outputs()[0].asnumpy()))
    for arr, copy in kept:
        np.testing.assert_array_equal(arr.asnumpy(), copy)
    assert not np.array_equal(kept[0][1], kept[-1][1])


# ---------------------------------------------------------------------------
# (d) tied parameters (tests/test_module.py:139-166)
# ---------------------------------------------------------------------------


def _tied_net(lib):
    data = lib.sym.Variable("data")
    a = lib.sym.FullyConnected(data, num_hidden=16, no_bias=True, name="enc")
    a = lib.sym.Activation(a, act_type="tanh")
    out = lib.sym.FullyConnected(a, num_hidden=16, no_bias=True, name="dec")
    return lib.sym.SoftmaxOutput(out, name="softmax")


def test_tied_parameter_buffers_train_apart_as_in_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    rng = np.random.RandomState(3)
    X = rng.randn(64, 16).astype(np.float32)
    Y = rng.randint(0, 16, 64).astype(np.float32)
    shapes = dict(data_shapes=[("data", (16, 16))],
                  label_shapes=[("softmax_label", (16,))])
    jmod = mx.mod.Module(_tied_net(mx), context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Uniform(0.1))
    w = jmod._exec.arg_dict["enc_weight"]
    jmod._exec.arg_dict["dec_weight"]._set_data(w._data)
    tmod = mt.mod.Module(_tied_net(mt), context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=mt.params_from_numpy(jmod.get_params()[0],
                                                     mt.cpu()))
    tw = tmod._exec.arg_dict["enc_weight"]
    tmod._exec.arg_dict["dec_weight"]._data = tw._data  # one storage
    opt = {"learning_rate": 0.01}
    jmod.init_optimizer(kvstore=None, optimizer="adam", optimizer_params=opt)
    tmod.init_optimizer(kvstore=None, optimizer="adam", optimizer_params=opt)
    for i in range(0, 64, 16):
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X[i:i + 16])],
                                              [mx.nd.array(Y[i:i + 16])]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch([_cpu(X[i:i + 16])],
                                              [_cpu(Y[i:i + 16])]))
        tmod.update()
    enc, dec = (tmod._exec.arg_dict[n]._data for n in ("enc_weight",
                                                       "dec_weight"))
    assert enc.untyped_storage().data_ptr() != dec.untyped_storage(
        ).data_ptr()
    assert not torch.equal(enc, dec)
    _assert_close(tmod, jmod, MLP_TOL, "tied")


# ---------------------------------------------------------------------------
# (e) dropout under the fused step
# ---------------------------------------------------------------------------


_DRAW_MASK = tnn.draw_mask


class Recorder:
    """Wraps ``draw_mask``, keeping each mask and its generator."""

    def __init__(self):
        self.masks = []
        self.generators = []

    def __call__(self, generator, *args):
        m = _DRAW_MASK(generator, *args)
        self.masks.append(m.clone())
        self.generators.append(generator)
        return m


def _dropout_module():
    x = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(x, num_hidden=256, name="fc1")
    h = mt.sym.Dropout(h, p=0.5, name="drop1")
    h = mt.sym.FullyConnected(h, num_hidden=256, name="fc2")
    h = mt.sym.Dropout(h, p=0.3, name="drop2")
    h = mt.sym.FullyConnected(h, num_hidden=4, name="fc3")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(h, name="softmax"),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPTIMIZERS["sgd"])
    return mod


def _keep_ok(mask, keep):
    n = mask.numel()
    frac = mask.float().mean().item()
    return abs(frac - keep) <= 6 * np.sqrt(keep * (1 - keep) / n)


def test_dropout_masks_under_the_fused_step(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        [_cpu(rng.randn(32, 16).astype(np.float32))],
        [_cpu(rng.randint(0, 4, 32).astype(np.float32))])
    runs = []
    for _ in range(2):
        mt.random.seed(11)
        mod = _dropout_module()
        rec = Recorder()
        monkeypatch.setattr(tnn, "draw_mask", rec)
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        assert mod._fused is not None and len(rec.masks) == 6
        runs.append(rec)
    first, again = runs
    assert all(torch.equal(m, n) for m, n in zip(first.masks, again.masks))
    for node, keep in ((0, 0.5), (1, 0.7)):
        masks = first.masks[node::2]
        gens = first.generators[node::2]
        # one persistent generator a node, its masks new every step
        assert all(g is gens[0] for g in gens)
        assert not any(torch.equal(masks[t], masks[t - 1])
                       for t in range(1, 3))
        assert all(_keep_ok(m, keep) for m in masks)
    assert first.generators[0] is not first.generators[1]
    assert not torch.equal(first.masks[0][:, :256], first.masks[1])
    # another seed, other masks
    mt.random.seed(12)
    mod = _dropout_module()
    rec = Recorder()
    monkeypatch.setattr(tnn, "draw_mask", rec)
    mod.forward_backward(batch)
    mod.update()
    assert not torch.equal(rec.masks[0], first.masks[0])


def test_rnn_dropout_layers_draw_from_persistent_streams(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    data = mt.sym.Variable("data")
    rnn = mt.sym.RNN(data=data, parameters=mt.sym.Variable("rnn_parameters"),
                     state=mt.sym.Variable("rnn_state"),
                     state_cell=mt.sym.Variable("rnn_state_cell"),
                     state_size=8, num_layers=3, mode="lstm", p=0.5,
                     name="rnn")
    net = mt.sym.MakeLoss(rnn)
    mod = mt.mod.Module(net, data_names=("data",), label_names=(),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (5, 2, 4))])
    zeros = mt.nd.zeros((3, 2, 8), ctx=mt.cpu())
    mod.init_params(mt.initializer.Uniform(0.1), allow_missing=True,
                    arg_params={"rnn_state": zeros,
                                "rnn_state_cell": zeros.copy()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    rec = Recorder()
    monkeypatch.setattr(tnn, "draw_mask", rec)
    x = np.random.RandomState(1).randn(5, 2, 4).astype(np.float32)
    for _ in range(2):
        mod.forward_backward(mt.io.DataBatch([_cpu(x)], []))
        mod.update()
    assert len(rec.masks) == 4  # layers 0 and 1, two steps
    g = rec.generators
    assert g[0] is g[2] and g[1] is g[3] and g[0] is not g[1]
    assert not torch.equal(rec.masks[0], rec.masks[2])
    streams = mod._fused.streams
    node = {n.name: i for i, n in enumerate(net._topo())}["rnn"]
    key = mt.random.sub_key(streams.base_key, node)
    for layer in (0, 1):
        assert g[layer] is streams.generator(
            mt.random.sub_key(key, layer), "cpu")


# ---------------------------------------------------------------------------
# (f) who takes the eager path
# ---------------------------------------------------------------------------


def _small_module(monkeypatch, fused="1", inputs_need_grad=False,
                  loss=True):
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    x = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(x, num_hidden=4, name="fc")
    sym = mt.sym.SoftmaxOutput(h, name="softmax") if loss else h
    mod = mt.mod.Module(sym, context=mt.cpu(),
                        label_names=("softmax_label",) if loss else ())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))] if loss else None,
             inputs_need_grad=inputs_need_grad)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPTIMIZERS["sgd"])
    return mod


@pytest.mark.parametrize("why", ["MXNET_FUSED_STEP=0", "inputs_need_grad",
                                 "non-loss output"])
def test_eager_path_when_switched_off_or_ineligible(why, monkeypatch):
    mod = _small_module(monkeypatch,
                        fused="0" if why == "MXNET_FUSED_STEP=0" else "1",
                        inputs_need_grad=why == "inputs_need_grad",
                        loss=why != "non-loss output")
    assert not mod._fused_ready()
    rng = np.random.RandomState(2)
    X = rng.randn(8, 6).astype(np.float32)
    label = [_cpu(rng.randint(0, 4, 8).astype(np.float32))] \
        if why != "non-loss output" else []
    before = mod.get_params()[0]["fc_weight"].asnumpy()
    mod.forward(mt.io.DataBatch([_cpu(X)], label), is_train=True)
    assert mod._pending_batch is None  # the executor ran it
    if why == "non-loss output":
        mod.backward(out_grads=[mt.nd.ones((8, 4), ctx=mt.cpu())])
    else:
        mod.backward()
    mod.update()
    assert mod._fused is None and mod._train_step is None
    assert len(mod._updater.states) == 2  # fc_weight, fc_bias
    assert not np.array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                              before)


def test_the_fused_step_defers_and_reports_where_it_runs(monkeypatch):
    mod = _small_module(monkeypatch)
    assert mod._fused_ready()
    rng = np.random.RandomState(2)
    batch = mt.io.DataBatch([_cpu(rng.randn(8, 6).astype(np.float32))],
                            [_cpu(rng.randint(0, 4, 8).astype(np.float32))])
    mod.forward(batch, is_train=True)
    assert mod._pending_batch is not None
    mod.backward()
    assert mod._pending_batch is not None  # backward() waits for update()
    mod.update()
    assert mod._pending_batch is None and isinstance(
        mod._train_step, fused_step.TrainStep)  # the CPU: uncaptured
    stats = mod.graph_stats()
    assert stats == {"graphs_on": False, "uncapturable_ops": [],
                     "graphs": 0, "captures": 0, "capture_ms": 0.0,
                     "pool_bytes": 0}


def test_a_custom_op_keeps_the_step_uncaptured():
    class Prop(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Op()

    class Op(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    mt.operator.register("torch_fused_step_double")(Prop)
    x = mt.sym.Variable("data")
    h = mt.sym.Custom(mt.sym.FullyConnected(x, num_hidden=4, name="fc"),
                      op_type="torch_fused_step_double")
    sym = mt.sym.SoftmaxOutput(h, name="softmax")
    assert fused_step.uncapturable_ops(sym) == ["Custom"]
    mod = mt.mod.Module(sym, context=mt.cpu())
    assert mod.graph_stats()["uncapturable_ops"] == ["Custom"]
    assert not mod._graphs_on()
    assert fused_step.uncapturable_ops(_lm_case()[0]) == []
    assert not mt.ops.registry.get_op("Custom").capturable
    assert all(mt.ops.registry.get_op(n).capturable
               for n in mt.ops.registry.list_ops() if n != "Custom")
