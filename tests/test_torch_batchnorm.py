"""The port's ``BatchNorm`` against the JAX op
(``mxnet_tpu.ops.registry.invoke("BatchNorm", ...)``), forward, the
gradients of data, gamma and beta under one seeded cotangent, and the
new moving statistics: training and inference, ``fix_gamma`` on and
off, ``use_global_stats``, ``output_mean_var``, 2-D and 4-D inputs, in
float32, bfloat16 and float16; and a channel with mean 1e3 and std
1e-2, where the float32 shift of ``_fused_mean_var`` decides the
result (checked against float64 as well).  Then BatchNorm's aux states
through ``Module``: two SGD steps and an inference forward of two
ResNets against the JAX ``Module``.

Inputs come from numpy seeds; half-precision inputs are the same
float32 values rounded by each package (round to nearest even in both).
gamma and beta take the data's dtype and the moving statistics float32,
as ``infer_type`` gives them in a half-precision network.  Tolerances:
float32 rtol = atol = 1e-5 (sums in another order); bfloat16 and
float16 rtol = atol = their machine epsilon (2**-7, 2**-10: one
rounding of the same float32 value apart); the moving statistics are
float32 in every case, at the float32 tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.resnet import get_symbol as jax_resnet_get
from mxnet_tpu.models.resnet import resnet as jax_resnet
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.resnet import resnet as torch_resnet
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -7),
       "float16": dict(rtol=2.0 ** -10, atol=2.0 ** -10)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _inputs(shape, seed, big_mean_channel=None):
    rng = np.random.RandomState(seed)
    C = shape[1]
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    if big_mean_channel is not None:
        x[:, big_mean_channel] = 1e3 + 1e-2 * rng.randn(
            *x[:, big_mean_channel].shape)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.randn(C).astype(np.float32)
    mm = rng.randn(C).astype(np.float32) * 0.2
    mv = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return x, gamma, beta, mm, mv


def _bn_both(x, gamma, beta, mm, mv, attrs, is_train, dtype, seed=0):
    """(port outputs, port grads, port new aux), the same from JAX, as
    float32 numpy."""
    jd, td = JNP[dtype], TORCH[dtype]
    jmm, jmv = jnp.asarray(mm), jnp.asarray(mv)

    def jfun(xx, g, b):
        outs, new_aux = jax_invoke("BatchNorm", [xx, g, b], attrs,
                                   is_train=is_train, aux=[jmm, jmv])
        return outs[0], (outs, new_aux)

    jin = [jnp.asarray(a).astype(jd) for a in (x, gamma, beta)]
    _, vjp, (jouts, jaux) = jax.vjp(jfun, *jin, has_aux=True)
    cot = np.random.RandomState(seed + 100).randn(*x.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot).astype(jd))

    tin = [torch.from_numpy(a.copy()).to(td) for a in (x, gamma, beta)]
    for t in tin:
        t.requires_grad_(True)
    taux_in = [torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())]
    touts, taux = torch_invoke("BatchNorm", tin, attrs, is_train=is_train,
                               aux=taux_in)
    tgrads = torch.autograd.grad(touts[0], tin,
                                 torch.from_numpy(cot).to(td),
                                 allow_unused=True)
    tgrads = [torch.zeros_like(t) if g is None else g
              for t, g in zip(tin, tgrads)]

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    def t32(t):
        return t.detach().float().numpy()

    return ([t32(o) for o in touts], [t32(g) for g in tgrads],
            [t32(a) for a in taux], touts, tgrads,
            [f32(o) for o in jouts], [f32(g) for g in jgrads],
            [f32(a) for a in jaux])


def _compare(res, dtype, fix_gamma, n_outs, msg=""):
    touts, tgrads, taux, tout_raw, tgrad_raw, jouts, jgrads, jaux = res
    tol = TOL[dtype]
    assert len(touts) == len(jouts) == n_outs
    # dtypes: the output keeps the input's, the statistics are float32
    assert tout_raw[0].dtype == TORCH[dtype]
    for o in tout_raw[1:]:
        assert o.dtype == torch.float32
    for k, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(t, j, err_msg=f"{msg} output {k}",
                                   **(tol if k == 0 else TOL["float32"]))
    for name, t, j in zip(("data", "gamma", "beta"), tgrads, jgrads):
        np.testing.assert_allclose(t, j, err_msg=f"{msg} grad {name}",
                                   **tol)
    if fix_gamma:  # ones in gamma's place: its gradient is exactly zero
        assert not np.any(tgrads[1]) and not np.any(jgrads[1])
    for name, t, j in zip(("moving_mean", "moving_var"), taux, jaux):
        np.testing.assert_allclose(t, j, err_msg=f"{msg} new {name}",
                                   **TOL["float32"])


# (dtype, ndim, is_train, fix_gamma, use_global_stats, output_mean_var)
CASES = [(dt, nd, tr, False, False, False)
         for dt in ("float32", "bfloat16", "float16")
         for nd in (2, 4) for tr in (True, False)]
CASES += [
    ("float32", 4, True, True, False, False),
    ("float32", 4, False, True, False, False),
    ("bfloat16", 2, True, True, False, False),
    ("float32", 4, True, False, True, False),
    ("bfloat16", 4, True, False, True, False),
    ("float32", 2, True, True, True, False),
    ("float32", 4, True, False, False, True),
    ("float32", 4, False, False, False, True),
    ("bfloat16", 2, True, False, False, True),
    ("float16", 4, True, True, False, True),
]


def _case_id(c):
    dt, nd, tr, fg, ug, om = c
    return "-".join([dt, f"{nd}d", "train" if tr else "infer"]
                    + ["fix_gamma"] * fg + ["global_stats"] * ug
                    + ["mean_var"] * om)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_batch_norm_matches_jax(case):
    dtype, ndim, is_train, fix_gamma, use_global, out_mv = case
    shape = (6, 5) if ndim == 2 else (3, 4, 5, 6)
    x, gamma, beta, mm, mv = _inputs(shape, seed=ndim + 10 * fix_gamma)
    attrs = {"eps": 1e-3, "momentum": 0.9, "fix_gamma": fix_gamma,
             "use_global_stats": use_global, "output_mean_var": out_mv}
    res = _bn_both(x, gamma, beta, mm, mv, attrs, is_train, dtype)
    _compare(res, dtype, fix_gamma, 3 if out_mv else 1, _case_id(case))
    taux = res[2]
    if is_train and not use_global:  # the moving statistics moved
        assert not np.allclose(taux[0], mm) and not np.allclose(taux[1], mv)
    else:  # constants, left as they were
        np.testing.assert_array_equal(taux[0], mm)
        np.testing.assert_array_equal(taux[1], mv)


@pytest.mark.parametrize("ndim", [2, 4])
def test_batch_norm_large_mean_channel_takes_the_shift(ndim):
    """A channel with mean 1e3 and std 1e-2: E[x^2] - E[x]^2 in float32
    without the shift cancels to noise of ~0.06 (an ulp of 1e6) against
    a variance of 1e-4; with it, both packages agree with float64."""
    shape = (16, 3) if ndim == 2 else (4, 3, 4, 5)
    x, gamma, beta, mm, mv = _inputs(shape, seed=7, big_mean_channel=1)
    attrs = {"eps": 1e-5, "fix_gamma": False, "output_mean_var": True}
    res = _bn_both(x, gamma, beta, mm, mv, attrs, True, "float32")
    _compare(res, "float32", False, 3, "large mean")
    # the batch statistics (float32 of the float32 inputs) against float64
    xd = x.astype(np.float64)
    dims = (0,) + tuple(range(2, ndim))
    var64 = xd.var(axis=dims)
    np.testing.assert_allclose(res[0][1], xd.mean(axis=dims), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res[0][2], var64, rtol=1e-4)
    # the output against float64, within two float32 spacings of each
    # channel's |mean| (x - mean rounds there) over its std
    bshape = (1, -1) + (1,) * (ndim - 2)
    inv = gamma / np.sqrt(var64 + 1e-5)
    ref = (xd - xd.mean(axis=dims).reshape(bshape)) * inv.reshape(bshape) \
        + beta.reshape(bshape)
    spacing = np.spacing(np.abs(xd.mean(axis=dims)).astype(np.float32))
    atol = 2 * spacing * inv + 1e-5
    assert np.all(np.abs(res[0][0] - ref) <= atol.reshape(bshape))


def test_batch_norm_symbol_shapes_names_and_types():
    data = mt.sym.Variable("data")
    bn = mt.sym.BatchNorm(data, name="bn", output_mean_var=True)
    assert bn.list_arguments() == ["data", "bn_gamma", "bn_beta"]
    assert bn.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    assert bn.list_outputs() == ["bn_output", "bn_mean", "bn_var"]
    args, outs, aux = bn.infer_shape(data=(2, 7, 3, 3))
    assert args == [(2, 7, 3, 3), (7,), (7,)]
    assert outs == [(2, 7, 3, 3), (7,), (7,)] and aux == [(7,), (7,)]
    assert mt.sym.BatchNorm(data, name="b2").list_outputs() == ["b2_output"]
    _, _, aux_types = bn.infer_type(data="bfloat16")
    assert aux_types == ["float32", "float32"]


def test_executor_writes_moving_stats_once_per_training_forward():
    """``forward(is_train=True)`` writes the new moving statistics into
    the bound aux arrays once (backward does not again); an inference
    forward leaves them unchanged."""
    rng = np.random.RandomState(3)
    bn = mt.sym.BatchNorm(mt.sym.Variable("data"), name="bn",
                          fix_gamma=False)
    ctx = mt.cpu()
    args = {"data": mt.nd.array(rng.randn(4, 3, 2, 2), ctx=ctx),
            "bn_gamma": mt.nd.ones((3,), ctx), "bn_beta": mt.nd.zeros((3,),
                                                                    ctx)}
    grads = {"bn_gamma": mt.nd.zeros((3,), ctx),
             "bn_beta": mt.nd.zeros((3,), ctx)}
    aux = {"bn_moving_mean": mt.nd.zeros((3,), ctx),
           "bn_moving_var": mt.nd.ones((3,), ctx)}
    ex = bn.bind(ctx, args, args_grad=grads, aux_states=aux)
    x = args["data"].asnumpy().astype(np.float64)
    ex.forward(is_train=True)
    ex.backward([mt.nd.ones((4, 3, 2, 2), ctx)])
    want_mean = 0.1 * x.mean(axis=(0, 2, 3))
    want_var = 0.9 + 0.1 * x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(aux["bn_moving_mean"].asnumpy(), want_mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux["bn_moving_var"].asnumpy(), want_var,
                               rtol=1e-5)
    before = [a.asnumpy() for a in aux.values()]
    out = ex.forward(is_train=False)[0].asnumpy()
    for a, b in zip(aux.values(), before):
        np.testing.assert_array_equal(a.asnumpy(), b)
    ref = (x - want_mean.reshape(1, 3, 1, 1)) \
        / np.sqrt(want_var + 1e-3).reshape(1, 3, 1, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_batch_norm_is_not_torch_batch_norm(monkeypatch):
    """The port computes its own statistics: neither ``F.batch_norm``
    nor ``torch.batch_norm`` is called."""
    def refuse(*a, **k):
        raise AssertionError("torch's batch_norm was called")

    monkeypatch.setattr(torch.nn.functional, "batch_norm", refuse)
    monkeypatch.setattr(torch, "batch_norm", refuse)
    x, gamma, beta, mm, mv = _inputs((3, 4, 5, 6), seed=1)
    for is_train in (True, False):
        torch_invoke("BatchNorm", [torch.from_numpy(a) for a in
                                   (x, gamma, beta)], {"fix_gamma": False},
                     is_train=is_train,
                     aux=[torch.from_numpy(mm), torch.from_numpy(mv)])


# ---------------------------------------------------------------------------
# ResNet: two SGD steps and an inference forward through Module, the
# port against the JAX Module from the same parameters and aux states
# ---------------------------------------------------------------------------


def _resnet_pair(which):
    if which == "cifar-resnet-20":
        kw = dict(num_classes=10, num_layers=20, image_shape=(3, 32, 32))
        return jax_resnet_get(**kw), mt.models.resnet(**kw), (4, 3, 32, 32)
    kw = dict(units=[2, 1, 1, 1], num_stages=4,
              filter_list=[8, 16, 32, 64, 128], num_classes=10,
              image_shape=(3, 64, 64))
    return jax_resnet(**kw), torch_resnet(**kw), (2, 3, 64, 64)


# after one step the packages agree to float32 noise (~1e-7 measured);
# a second step from weights that differ in the last bits amplifies the
# difference: one ulp added to conv0_weight moves the port's own weights
# after two steps by up to 4e-5 (cifar resnet-20, lr 0.01), so the
# second step and the inference forward are held at 2e-4
STEP1 = dict(rtol=1e-4, atol=1e-6)
STEP2 = dict(rtol=2e-4, atol=2e-4)


def _assert_params(tmod, jmod, tol, what):
    (ja, jx), (ta, tx) = jmod.get_params(), tmod.get_params()
    for jd, td in ((ja, ta), (jx, tx)):
        assert sorted(jd) == sorted(td)
        for k in jd:
            j = jd[k].asnumpy()
            np.testing.assert_allclose(
                td[k].asnumpy(), j, rtol=tol["rtol"],
                atol=tol["atol"] * max(1.0, float(np.abs(j).max())),
                err_msg=f"{what}: {k}")


@pytest.mark.parametrize("which", ["cifar-resnet-20", "bottleneck-conv7"])
def test_resnet_module_steps_match_jax(which):
    """resnet-20 at 3x32x32 (the cifar branch: basic units, 3x3 stem)
    and a bottleneck network at 3x64x64 (``bn_data``, the 7x7 stem, max
    pool, both shortcut kinds, the global pool), from the JAX Module's
    Xavier parameters and random moving statistics carried over by
    ``params_from_numpy``: two SGD steps (lr 0.01, momentum 0.9, wd
    1e-4), then an ``is_train=False`` forward on the moved statistics;
    every argument and aux state compared after each step."""
    jsym, tsym, dshape = _resnet_pair(which)
    B = dshape[0]
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = dict(data_shapes=[("data", dshape)],
                  label_shapes=[("softmax_label", (B,))])
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    mx.random.seed(0)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    rng = np.random.RandomState(1)
    arg = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    aux = {k: (rng.randn(*v.shape) * 0.1 if k.endswith("_mean")
               else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
           for k, v in jmod.get_params()[1].items()}
    jmod.set_params({k: mx.nd.array(v) for k, v in arg.items()},
                    {k: mx.nd.array(v) for k, v in aux.items()})
    jmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tmod = mt.mod.Module(tsym, context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=mt.params_from_numpy(jmod.get_params()[0],
                                                     mt.cpu()),
                     aux_params=mt.params_from_numpy(jmod.get_params()[1],
                                                     mt.cpu()))
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)

    X = rng.rand(*dshape).astype(np.float32)
    Y = rng.randint(0, 10, B).astype(np.float32)
    jbatch = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(Y)])
    tbatch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                             [mt.nd.array(Y, ctx=mt.cpu())])
    for step, tol in enumerate((STEP1, STEP2)):
        jmod.forward_backward(jbatch)
        jmod.update()
        tmod.forward_backward(tbatch)
        tmod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(),
                                   err_msg=f"step {step} outputs", **STEP1)
        _assert_params(tmod, jmod, tol, f"after step {step}")
    # every weight and every moving statistic moved
    ta, tx = tmod.get_params()
    assert all(np.abs(ta[k].asnumpy() - arg[k]).max() > 0 for k in arg)
    assert all(np.abs(tx[k].asnumpy() - aux[k]).max() > 0 for k in aux)
    jmod.forward(jbatch, is_train=False)
    tmod.forward(tbatch, is_train=False)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(),
                               err_msg="inference outputs", **STEP2)
    _assert_params(tmod, jmod, STEP2, "after the inference forward")


def test_batch_norm_keeps_float64_statistics_for_float64_input():
    """float64 in, float64 statistics (float32 for every narrower input,
    as the JAX package): what a float64 reference step needs."""
    x, gamma, beta, mm, mv = _inputs((4, 3, 5, 6), seed=2,
                                     big_mean_channel=0)
    xd = x.astype(np.float64)
    (out, mean, var), new_aux = torch_invoke(
        "BatchNorm", [torch.from_numpy(a.astype(np.float64)) for a in
                      (x, gamma, beta)],
        {"fix_gamma": False, "output_mean_var": True, "eps": 1e-5},
        is_train=True, aux=[torch.from_numpy(mm.astype(np.float64)),
                            torch.from_numpy(mv.astype(np.float64))])
    assert out.dtype == mean.dtype == var.dtype == torch.float64
    np.testing.assert_allclose(mean.numpy(), xd.mean(axis=(0, 2, 3)),
                               rtol=1e-12)
    np.testing.assert_allclose(var.numpy(), xd.var(axis=(0, 2, 3)),
                               rtol=1e-9)
    assert all(a.dtype == torch.float64 for a in new_aux)
