"""The port's optimizers (``mxnet_tpu_torch/optimizer.py``) against the
JAX package's on the CPU: ccSGD, NAG, SGLD, DCASGD, AdaGrad, RMSProp,
AdaDelta and Test (SGD and Adam: ``test_torch_fused_step.py`` and
``test_torch_bf16.py``).

(a) ``apply`` over a list of weights and ``_step`` on each weight, 3
updates with ``rescale_grad``, ``clip_gradient`` and weight decay,
against the JAX ``apply`` term by term: fp32 within rtol 1e-6, atol
1e-6; bf16 weights and states within the bound ``test_torch_bf16.py``
holds SGD's bf16 step to, one bf16 ulp of the JAX weight an update plus
``GRAD_ROUNDINGS`` U = 16 x 2^-8 of the largest change, since the JAX
package rounds each term in bf16 and the port forms them in float32 and
rounds once.  ``apply`` over a list mixing float32 and bf16 equals
``_step`` bit for bit.
(b) Two fused ``Module`` steps of an MLP (biases: the wd_mult 0 name
rule) against the JAX ``Module`` from the same parameters: rtol 1e-5,
atol 1e-6 (``test_torch_fused_step.py``'s MLP tolerance).
(c) The states files both ways: a step in one package, its states file
(the fused one, and the ``Updater`` blob under ``MXNET_FUSED_STEP=0``)
loaded by the other, and one more step in each, at (b)'s tolerance.
(d) SGLD's noise: the parity cases replace ``draw_noise`` (the port)
and ``jax.random.normal`` (the JAX package) by zeros; its own draws are
checked apart: N(0, lr) within 6 sigma, new noise each fused step, and
the fused step's noise from the module's random streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

U = 2.0 ** -8
GRAD_ROUNDINGS = 16
FP32_TOL = dict(rtol=1e-6, atol=1e-6)
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
COMMON = {"rescale_grad": 0.5, "clip_gradient": 0.8}
CASES = {
    "ccsgd": ("ccsgd", {"learning_rate": 0.05, "momentum": 0.9}),
    "nag": ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    "nag_no_momentum": ("nag", {"learning_rate": 0.05}),
    "sgld": ("sgld", {"learning_rate": 0.05}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9,
                          "lamda": 0.5}),
    "dcasgd_no_momentum": ("dcasgd", {"learning_rate": 0.05, "lamda": 0.5}),
    "adagrad": ("adagrad", {"learning_rate": 0.05}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01}),
    "adadelta": ("adadelta", {}),
    "test": ("test", {"learning_rate": 0.05}),
}
# the states files: every optimizer with a state
STATE_CASES = ["ccsgd", "nag", "dcasgd", "dcasgd_no_momentum", "adagrad",
               "rmsprop", "adadelta", "test"]
SHAPES = ((6, 5), (7,), (3, 2, 4))
WD = 1e-3


@pytest.fixture
def no_noise(monkeypatch):
    """SGLD's noise zero in both packages."""
    monkeypatch.setattr(mt.optimizer, "draw_noise",
                        lambda gen, shape, device: torch.zeros(
                            shape, dtype=torch.float32, device=device))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(
                            shape, dtype))


def _opts(case):
    name, params = CASES[case]
    kw = dict(params, **COMMON)
    return mx.optimizer.create(name, **kw), mt.optimizer.create(name, **kw)


def _data(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[(2 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_run(jopt, ws, gs, dtype):
    jw = [jnp.asarray(w, dtype) for w in ws]
    js = [jopt.init_state_arrays(w) for w in jw]
    for t, step in enumerate(gs, 1):
        for i, g in enumerate(step):
            jw[i], js[i] = jopt.apply(jw[i], jnp.asarray(g, dtype), js[i],
                                      jopt.lr, WD, t)
            js[i] = jax.tree_util.tree_map(
                lambda new, old: new.astype(old.dtype), js[i],
                jopt.init_state_arrays(jw[i]))
    return jw, js


def _torch_run(topt, ws, gs, dtype, one_by_one):
    tw = [torch.tensor(w).to(dtype) for w in ws]
    ts = topt.init_state_arrays(tw)
    with torch.no_grad():
        for t, step in enumerate(gs, 1):
            tg = [torch.from_numpy(g).to(dtype) for g in step]
            if one_by_one:
                for w, g, s in zip(tw, tg, ts):
                    topt._step(w, g, s, topt.lr, WD, t)
            else:
                topt.apply(tw, tg, ts, topt.lr, WD, t)
    return tw, ts


@pytest.mark.parametrize("one_by_one", [False, True],
                         ids=["apply", "step"])
@pytest.mark.parametrize("case", list(CASES))
def test_fp32_updates_as_jax(case, one_by_one, no_noise):
    jopt, topt = _opts(case)
    ws, gs = _data(1)
    jw, js = _jax_run(jopt, ws, gs, jnp.float32)
    tw, ts = _torch_run(topt, ws, gs, torch.float32, one_by_one)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(_f32(a), _f32(b), **FP32_TOL)
    for a, b in zip(ts, js):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_allclose(_f32(x), _f32(y), **FP32_TOL)
    assert not all(np.array_equal(_f32(a), w) for a, w in zip(tw, ws))


def _ulp(x):
    """One bf16 unit in the last place of each element of ``x``."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_updates_as_jax(case, no_noise):
    jopt, topt = _opts(case)
    ws, gs = _data(2)
    ws = [_f32(torch.from_numpy(w).to(torch.bfloat16)) for w in ws]
    jw, js = _jax_run(jopt, ws, gs, jnp.bfloat16)
    tw, ts = _torch_run(topt, ws, gs, torch.bfloat16, False)
    for a, b, w0 in zip(tw, jw, ws):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        got, want = _f32(a), _f32(b)
        tol = len(gs) * _ulp(want) \
            + GRAD_ROUNDINGS * U * np.abs(want - w0).max()
        assert np.all(np.abs(got - want) <= tol), case
    for a, b in zip(ts, js):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.dtype == torch.bfloat16
            want = _f32(y)
            tol = len(gs) * _ulp(want) \
                + GRAD_ROUNDINGS * U * np.abs(want).max()
            assert np.all(np.abs(_f32(x) - want) <= tol), case


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_dtype_list_equals_one_by_one(case, no_noise):
    """``apply`` over float32 and bf16 weights in one list is ``_step``
    on each, bit for bit (the bf16 LM's one group holds the float32
    ``tok_embed_weight``)."""
    _, topt = _opts(case)
    ws, gs = _data(3)
    dts = [torch.float32, torch.bfloat16, torch.float32]

    def run(one_by_one):
        tw = [torch.tensor(w).to(d) for w, d in zip(ws, dts)]
        ts = topt.init_state_arrays(tw)
        with torch.no_grad():
            for t, step in enumerate(gs, 1):
                tg = [torch.from_numpy(g).to(d) for g, d in zip(step, dts)]
                if one_by_one:
                    for w, g, s in zip(tw, tg, ts):
                        topt._step(w, g, s, 0.05, WD, t)
                else:
                    topt.apply(tw, tg, ts, 0.05, WD, t)
        return tw, ts

    (aw, as_), (bw, bs) = run(False), run(True)
    for x, y in zip(aw + _leaves(as_), bw + _leaves(bs)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert [w.dtype for w in aw] == dts


# ---------------------------------------------------------------------------
# Module steps
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _batches(pkg, ctx, n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        X = rng.randn(8, 10).astype(np.float32)
        y = rng.randint(0, 3, 8).astype(np.float32)
        out.append(pkg.io.DataBatch([pkg.nd.array(X, ctx=ctx)],
                                    [pkg.nd.array(y, ctx=ctx)]))
    return out


def _start_params(seed=4):
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (3, 16), "fc2_bias": (3,)}
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _module(pkg, ctx, params, case):
    name, opt_params = CASES[case]
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                for n, v in params.items()})
    mod.init_optimizer(optimizer=name, optimizer_params=dict(
        opt_params, clip_gradient=0.8, wd=WD))
    return mod


def _steps(mod, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()


def _params_np(mod):
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def _assert_params(tmod, jmod):
    tp, jp = _params_np(tmod), _params_np(jmod)
    assert set(tp) == set(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], **MLP_TOL, err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_module_steps_as_jax(case, no_noise):
    params = _start_params()
    jmod = _module(mx, mx.cpu(), params, case)
    tmod = _module(mt, mt.cpu(), params, case)
    _steps(jmod, _batches(mx, mx.cpu(), 2))
    _steps(tmod, _batches(mt, mt.cpu(), 2))
    assert tmod._fused is not None  # the fused step ran
    _assert_params(tmod, jmod)
    moved = _params_np(tmod)
    assert all(not np.array_equal(moved[n], params[n]) for n in params)


def _fused_env(monkeypatch, fused):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "updater"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", STATE_CASES)
def test_states_file_resumes_in_the_other_package(case, writer, fused,
                                                  tmp_path, monkeypatch,
                                                  no_noise):
    """One step in ``writer``'s package, its parameters and states file
    into the other, one more step in each: the two agree."""
    _fused_env(monkeypatch, fused)
    params = _start_params()
    batches = {"jax": _batches(mx, mx.cpu(), 2),
               "torch": _batches(mt, mt.cpu(), 2)}
    pkgs = {"jax": (mx, mx.cpu()), "torch": (mt, mt.cpu())}
    reader = "torch" if writer == "jax" else "jax"
    wmod = _module(*pkgs[writer], params, case)
    _steps(wmod, batches[writer][:1])
    fname = str(tmp_path / "opt.states")
    wmod.save_optimizer_states(fname)
    rmod = _module(*pkgs[reader], _params_np(wmod), case)
    rmod.load_optimizer_states(fname)
    _steps(wmod, batches[writer][1:])
    _steps(rmod, batches[reader][1:])
    tmod, jmod = (rmod, wmod) if reader == "torch" else (wmod, rmod)
    _assert_params(tmod, jmod)
    if fused:
        assert tmod._fused is not None
        assert tmod._fused.step_count == 2


# ---------------------------------------------------------------------------
# SGLD's noise
# ---------------------------------------------------------------------------

def test_sgld_noise_is_normal_with_variance_lr(monkeypatch):
    """w1 - (w0 - lr/2 (g + wd w0)) is N(0, lr): mean and variance within
    6 sigma over the MLP's 243 weights and 1,000 more from ``apply``; the
    fused step's noise comes from the module's streams and changes from
    step to step."""
    lr = 0.04
    params = _start_params()
    mods = {}
    for noise in (True, False):
        if not noise:
            monkeypatch.setattr(mt.optimizer, "draw_noise",
                                lambda gen, shape, device: torch.zeros(
                                    shape, device=device))
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod.bind(data_shapes=[("data", (8, 10))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                                    for n, v in params.items()})
        mod.init_optimizer(optimizer="sgld",
                           optimizer_params={"learning_rate": lr})
        _steps(mod, _batches(mt, mt.cpu(), 1))
        mods[noise] = mod
    monkeypatch.undo()
    noise = np.concatenate([
        (_params_np(mods[True])[n] - _params_np(mods[False])[n]).ravel()
        for n in params])
    opt = mt.optimizer.create("sgld", learning_rate=lr)
    w = [torch.zeros(1000)]
    with torch.no_grad():
        opt.apply(w, [torch.zeros(1000)], [None], lr, 0.0, 1)
    noise = np.concatenate([noise, w[0].numpy()])
    n = noise.size
    assert abs(noise.mean()) <= 6 * np.sqrt(lr / n)
    # the sample variance of n normals: sd lr sqrt(2 / (n - 1))
    assert abs(noise.var(ddof=1) - lr) <= 6 * lr * np.sqrt(2.0 / (n - 1))
    # the fused step drew from the module's streams
    streams = mods[True]._fused.streams
    key = mt.random.sub_key(streams.base_key, mt.optimizer.SGLD_STREAM)
    assert any(k == key for k, _ in streams._generators)


def test_sgld_draws_from_the_streams_anew_each_step():
    """Under a fused state's streams each ``apply`` draws new noise, and
    the same base key draws the same noise again."""

    def draws(base_key, n):
        opt = mt.optimizer.create("sgld", learning_rate=1.0)
        opt.rng_streams = mt.random.Streams(base_key)
        out = []
        for t in range(1, n + 1):
            w = [torch.zeros(64)]
            with torch.no_grad():
                opt.apply(w, [torch.zeros(64)], [None], 1.0, 0.0, t)
            out.append(w[0])
        return out

    a, b = draws(5, 2), draws(5, 2)
    assert not torch.equal(a[0], a[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], draws(6, 1)[0])


@pytest.mark.parametrize("name,lr", [("rmsprop", 0.002), ("adagrad", 0.05),
                                     ("nag", 0.05)])
def test_examples_optimizer_flag_takes_any_registered_optimizer(name, lr):
    """``--optimizer`` of the image examples names any registered
    optimizer (``examples/common.py``'s ``fit``)."""
    from mxnet_tpu_torch.examples import train_mnist

    np.random.seed(0)
    mt.random.seed(0)
    acc = train_mnist.main(["--network", "mlp", "--num-epochs", "1",
                            "--optimizer", name, "--lr", str(lr)],
                           ctx=mt.cpu())
    assert acc > 0.9, (name, acc)
