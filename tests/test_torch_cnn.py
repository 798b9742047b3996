"""The port's CNN ops and loss heads against ``mxnet_tpu.ops.registry``
of the same ops, forward and gradient: the loss heads under an ignore
label of -1, ``Convolution`` (groups, dilation, 1-D to 3-D),
``Pooling`` (every type and convention, ``global_pool``),
``Activation``, ``Flatten``, ``MakeLoss``, ``elemwise_sub``/``mul``;
then one LeNet step (BASELINE config 1's ops together) against the JAX
``Module``.  ``smooth_l1`` and the MultiBox ops are in
``test_torch_detection.py``.

Inputs and LeNet's parameters come from numpy seeds; gradients are
taken against one seeded cotangent on both sides.  Tolerances (fp32):
the loss heads rtol 1e-5, atol 1e-6 (softmax and a subtraction: a few
ulps apart); the other ops rtol=atol=1e-5 (torch's convolution sums in
another order than XLA's); the LeNet step rtol 1e-4, atol 1e-5 (a
500-wide product and an SGD step on top).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import lenet as jax_lenet
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding the timing-sensitive ones that share the
    host.  The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(name, inputs, attrs, grad_slots, seed=0, tol=TOL):
    """Forward (first output) and the gradients of ``grad_slots`` under
    one seeded cotangent, JAX op against the port's op."""
    def jfun(*xs):
        return jax_invoke(name, list(xs), attrs)[0][0]

    jout, vjp = jax.vjp(jfun, *[jnp.asarray(x) for x in inputs])
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))

    tin = [torch.from_numpy(x.copy()) for x in inputs]
    for s in grad_slots:
        tin[s].requires_grad_(True)
    (tout,), _ = torch_invoke(name, tin, attrs, is_train=True)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **tol)
    tgrads = torch.autograd.grad(tout, [tin[s] for s in grad_slots],
                                 torch.from_numpy(cot))
    for s, g in zip(grad_slots, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[s]),
                                   err_msg=f"{name} input {s}", **tol)
    return tout


# ---------------------------------------------------------------------------
# (a) the loss heads under an ignore label outside [0, C)
# ---------------------------------------------------------------------------


def _labels(shape, C, rng):
    """Labels in [0, C) with about a third set to the ignore label -1."""
    lab = rng.randint(0, C, size=shape).astype(np.float32)
    lab[rng.rand(*shape) < 0.35] = -1.0
    lab.flat[0] = -1.0
    return lab


@pytest.mark.parametrize("mode", ["flat", "preserve_shape", "multi_output"])
@pytest.mark.parametrize("normalization", ["null", "valid"])
def test_softmax_output_ignore_label_minus_one(mode, normalization):
    """Rows labelled -1 get zero gradient; -1 is never an index (the
    parent tree raised 'index -1 is out of bounds' in the backward)."""
    rng = np.random.RandomState(1)
    data = rng.randn(2, 4, 3).astype(np.float32)
    attrs = {"use_ignore": True, "ignore_label": -1,
             "normalization": normalization, "grad_scale": 1.5}
    if mode == "flat":
        label = _labels((2,), 12, rng)
    elif mode == "preserve_shape":
        label = _labels((2, 4), 3, rng)
        attrs["preserve_shape"] = True
    else:  # classes on axis 1
        label = _labels((2, 3), 4, rng)
        attrs["multi_output"] = True
    out = _both("SoftmaxOutput", [data, label], attrs, [0], tol=LOSS)
    assert out.shape == data.shape


def test_softmax_ce_loss_ignore_label_minus_one():
    rng = np.random.RandomState(2)
    data = rng.randn(2, 4, 3).astype(np.float32)
    label = _labels((2, 4), 3, rng)
    loss = _both("SoftmaxCELoss", [data, label],
                 {"use_ignore": True, "ignore_label": -1, "grad_scale": 0.5},
                 [0], tol=LOSS)
    assert loss.shape == (2, 4)
    assert np.all(loss.detach().numpy()[label == -1] == 0)


def test_softmax_output_multi_output_shapes():
    s = mt.sym.SoftmaxOutput(mt.sym.Variable("data"), mt.sym.Variable("lab"),
                             multi_output=True)
    args, outs, _ = s.infer_shape(data=(2, 3, 5, 7))
    assert args == [(2, 3, 5, 7), (2, 5, 7)] and outs == [(2, 3, 5, 7)]


# ---------------------------------------------------------------------------
# (b) Convolution, Pooling, Activation, Flatten, MakeLoss, elemwise
# ---------------------------------------------------------------------------


CONV_CASES = {
    "2d": ((2, 4, 9, 8), dict(kernel=(3, 3), num_filter=6, pad=(1, 1))),
    "2d-stride-dilate-groups": ((2, 4, 11, 10), dict(
        kernel=(3, 2), num_filter=6, stride=(2, 1), dilate=(2, 2),
        pad=(1, 0), num_group=2)),
    "2d-no-bias": ((1, 3, 7, 7), dict(kernel=(5, 5), num_filter=4,
                                      no_bias=True)),
    "1d": ((2, 3, 12), dict(kernel=(3,), num_filter=5, stride=(2,),
                            pad=(1,))),
    "3d": ((1, 2, 5, 6, 5), dict(kernel=(3, 3, 2), num_filter=4,
                                 pad=(1, 0, 1), num_group=2)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution(case):
    shape, attrs = CONV_CASES[case]
    rng = np.random.RandomState(3)
    sym = mt.sym.Convolution(mt.sym.Variable("data"), name="c", **attrs)
    args, outs, _ = sym.infer_shape(data=shape)
    ins = [rng.randn(*s).astype(np.float32) for s in args]
    out = _both("Convolution", ins, attrs, list(range(len(ins))))
    assert tuple(out.shape) == outs[0]


POOL_CASES = {
    "2d-pad": ((2, 3, 7, 8), dict(kernel=(3, 3), stride=(2, 2),
                                  pad=(1, 1))),
    "2d-odd": ((1, 2, 9, 6), dict(kernel=(2, 3), stride=(2, 2))),
    "1d": ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,))),
    "3d": ((1, 2, 5, 6, 7), dict(kernel=(2, 2, 3), stride=(2, 2, 2))),
}


@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling(case, pool_type, convention):
    shape, attrs = POOL_CASES[case]
    attrs = dict(attrs, pool_type=pool_type, pooling_convention=convention)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    sym = mt.sym.Pooling(mt.sym.Variable("data"), **attrs)
    _, outs, _ = sym.infer_shape(data=shape)
    out = _both("Pooling", [x], attrs, [0])
    assert tuple(out.shape) == outs[0]


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling(pool_type):
    x = np.random.RandomState(5).randn(2, 3, 5, 4).astype(np.float32)
    attrs = {"pool_type": pool_type, "global_pool": True, "kernel": (2, 2)}
    out = _both("Pooling", [x], attrs, [0])
    assert out.shape == (2, 3, 1, 1)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu"])
def test_activation(act):
    x = (np.random.RandomState(6).randn(3, 17) * 4).astype(np.float32)
    _both("Activation", [x], {"act_type": act}, [0])


def test_flatten():
    x = np.random.RandomState(7).randn(2, 3, 4, 5).astype(np.float32)
    out = _both("Flatten", [x], {}, [0])
    assert out.shape == (2, 60)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_make_loss(normalization):
    """Identity forward; backward grad_scale (normalized), whatever the
    cotangent."""
    x = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    _both("MakeLoss", [x], {"grad_scale": 2.5, "normalization": normalization,
                            "valid_thresh": 0.1}, [0])


@pytest.mark.parametrize("name", ["elemwise_sub", "elemwise_mul", "_minus",
                                  "_mul"])
def test_elemwise_binary(name):
    rng = np.random.RandomState(9)
    a, b = (rng.randn(3, 5).astype(np.float32) for _ in range(2))
    _both(name, [a, b], {}, [0, 1])


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    x = np.random.RandomState(12).randn(2, 5, 4, 3).astype(np.float32)
    _both("L2Normalization", [x], {"mode": mode}, [0])


def test_broadcast_mul():
    """SSD300's learned scale (1, C, 1, 1) times the normalized map."""
    rng = np.random.RandomState(13)
    scale = rng.randn(1, 5, 1, 1).astype(np.float32)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    out = _both("broadcast_mul", [scale, x], {}, [0, 1])
    assert out.shape == x.shape


@pytest.mark.parametrize("dim", [1, 2])
def test_concat(dim):
    rng = np.random.RandomState(14)
    xs = [rng.randn(2, 3 + k, 3 + k).astype(np.float32) for k in range(3)]
    xs = [x[:, :3] if dim == 2 else x[:, :, :3] for x in xs]
    out = _both("Concat", xs, {"num_args": 3, "dim": dim}, [0, 1, 2])
    s = mt.sym.Concat(*[mt.sym.Variable(f"x{k}") for k in range(3)],
                      num_args=3, dim=dim)
    shapes = {f"x{k}": x.shape for k, x in enumerate(xs)}
    assert s.infer_shape(**shapes)[1] == [tuple(out.shape)]


def test_symbol_arithmetic_and_indexing():
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    for expr, op in ((a - b, "elemwise_sub"), (a * b, "elemwise_mul"),
                     (a + b, "elemwise_add")):
        node = expr._outputs[0][0]
        assert node.op == op and [n.name for n, _ in node.inputs] == ["a", "b"]
    # with a number: the JAX package's scalar ops (since the operator
    # layer; they raised before it)
    for expr, op, scalar in ((a - 1.0, "_minus_scalar", "1.0"),
                             (2.0 * a, "_mul_scalar", "2.0")):
        node = expr._outputs[0][0]
        assert node.op == op and node.attrs == {"scalar": scalar}
        assert [n.name for n, _ in node.inputs] == ["a"]
    with pytest.raises(TypeError):
        a - "1"
    g = mt.sym.Group([a - b, a * b])
    assert len(g) == 2 and [s.name for s in g] == [x.name for x in
                                                   (g[0], g[1])]
    assert g[1].list_outputs() == [g.list_outputs()[1]]
    assert g[g.list_outputs()[0]].list_outputs() == g.list_outputs()[:1]
    internals = (a * b).get_internals()
    assert internals.list_outputs()[:2] == ["a", "b"]
    assert (a * b).get_children().list_outputs() == ["a", "b"]


# ---------------------------------------------------------------------------
# (c) LeNet: forward, backward and one SGD update against the JAX Module
# ---------------------------------------------------------------------------


def test_lenet_step_matches_jax_module():
    shapes = dict(data_shapes=[("data", (4, 1, 28, 28))],
                  label_shapes=[("softmax_label", (4,))])
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    tsym = mt.models.lenet(10)
    jmod = mx.mod.Module(jax_lenet(10), context=mx.cpu())
    assert tsym.list_arguments() == jmod.symbol.list_arguments()
    jmod.bind(**shapes)
    # weights uniform at Xavier's scale, drawn with numpy for both
    rng = np.random.RandomState(11)
    host = {}
    for name, shape in zip(tsym.list_arguments(), tsym.infer_shape(
            data=(4, 1, 28, 28), softmax_label=(4,))[0]):
        if name in ("data", "softmax_label"):
            continue
        if len(shape) == 1:  # biases
            host[name] = np.zeros(shape, np.float32)
            continue
        scale = np.sqrt(6.0 / (shape[0] + shape[1]) / np.prod(shape[2:]))
        host[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in host.items()})
    jmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tmod = mt.mod.Module(tsym, context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=host)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)

    rng = np.random.RandomState(10)
    X = rng.rand(4, 1, 28, 28).astype(np.float32)
    Y = np.array([3, 0, 7, 3], np.float32)
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    jmod.update()
    tmod.forward_backward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                          [mt.nd.array(Y, ctx=mt.cpu())]))
    tmod.update()
    STEP = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), **STEP)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **STEP)
    # the step moved every weight
    assert all(np.abs(tw[k] - host[k]).max() > 0 for k in tw)
