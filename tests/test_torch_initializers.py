"""The port's ``Orthogonal``, ``MSRAPrelu``, ``Load`` and ``Mixed``
initializers against the JAX package's on the CPU
(``mxnet_tpu/initializer.py:109, 137, 198, 252``).

``Load`` and ``Mixed`` draw nothing of their own: from the same saved
file and the same deterministic initializers they match the JAX package
exactly.  ``Orthogonal`` and ``MSRAPrelu`` draw from the framework
generator, which cannot reproduce JAX's draws, so the tests hold what
the two share: ``dumps()`` strings, orthogonality (W W^T = scale^2 I, or
W^T W for a wide-in matrix, within 1e-5 of scale^2), and MSRAPrelu's
variance formula 2 / ((1 + slope^2) x fan) from Xavier's fans, a sample
variance within 6 sigma of it."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _arr(pkg, shape):
    return pkg.nd.zeros(shape, ctx=pkg.cpu())


@pytest.mark.parametrize("make", [
    lambda p: p.initializer.Orthogonal(),
    lambda p: p.initializer.Orthogonal(scale=0.5, rand_type="normal"),
    lambda p: p.initializer.MSRAPrelu(),
    lambda p: p.initializer.MSRAPrelu(factor_type="in", slope=0.1),
    lambda p: p.initializer.Xavier(rnd_type="gaussian", magnitude=2),
], ids=["orthogonal", "orthogonal_normal", "msraprelu", "msraprelu_in",
        "xavier"])
def test_dumps_as_jax(make):
    assert make(mt).dumps() == make(mx).dumps()


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (8, 3, 2, 2), (5, 5)])
def test_orthogonal_rows_or_columns(shape, rand_type):
    scale = 1.414
    init = mt.initializer.Orthogonal(scale=scale, rand_type=rand_type)
    arr = _arr(mt, shape)
    init("fc_weight", arr)
    w = arr._data.double().reshape(shape[0], -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    eye = torch.eye(gram.shape[0], dtype=torch.float64)
    assert torch.allclose(gram, scale ** 2 * eye, atol=1e-5)
    # the JAX package's gives the same structure
    jarr = mx.nd.zeros(shape)
    mx.initializer.Orthogonal(scale=scale, rand_type=rand_type)(
        "fc_weight", jarr)
    jw = jarr.asnumpy().astype(np.float64).reshape(shape[0], -1)
    jgram = jw @ jw.T if jw.shape[0] <= jw.shape[1] else jw.T @ jw
    np.testing.assert_allclose(jgram, scale ** 2 * np.eye(len(jgram)),
                               atol=1e-5)


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 0.5)])
def test_msraprelu_variance(factor_type, slope):
    shape = (64, 32, 3, 3)
    arr = _arr(mt, shape)
    init = mt.initializer.MSRAPrelu(factor_type=factor_type, slope=slope)
    init("conv_weight", arr)
    jinit = mx.initializer.MSRAPrelu(factor_type=factor_type, slope=slope)
    assert init.magnitude == jinit.magnitude == 2.0 / (1 + slope ** 2)
    assert init.rnd_type == jinit.rnd_type == "gaussian"
    fan_in, fan_out = 32 * 9, 64 * 9
    fan = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
           "out": fan_out}[factor_type]
    var = init.magnitude / fan
    x = arr.asnumpy().astype(np.float64).ravel()
    n = x.size
    assert abs(x.mean()) <= 6 * np.sqrt(var / n)
    assert abs(x.var() - var) <= 6 * var * np.sqrt(2.0 / n)
    # bias and gamma keep the name rule
    b = _arr(mt, (4,))
    init("conv_bias", b)
    assert not b.asnumpy().any()


def _saved(tmp_path):
    rng = np.random.RandomState(0)
    params = {"arg:fc1_weight": rng.randn(4, 3).astype(np.float32),
              "arg:fc1_bias": rng.randn(4).astype(np.float32),
              "aux:bn_moving_var": rng.rand(4).astype(np.float32)}
    fname = str(tmp_path / "p.params")
    mx.nd.save(fname, {k: mx.nd.array(v) for k, v in params.items()})
    return fname, params


@pytest.mark.parametrize("source", ["file", "dict"])
def test_load_as_jax(tmp_path, source):
    fname, params = _saved(tmp_path)
    loaded = {}
    for pkg in (mt, mx):
        src = fname if source == "file" else pkg.nd.load(fname)
        init = pkg.initializer.Load(src, default_init=pkg.initializer.One())
        out = {}
        for name, shape in (("fc1_weight", (4, 3)), ("fc1_bias", (4,)),
                            ("bn_moving_var", (4,)), ("fc2_weight", (2, 4))):
            arr = _arr(pkg, shape)
            init(name, arr)
            out[name] = arr.asnumpy()
        loaded[pkg.__name__] = out
    mine, theirs = loaded["mxnet_tpu_torch"], loaded["mxnet_tpu"]
    for name in mine:
        np.testing.assert_array_equal(mine[name], theirs[name])
    np.testing.assert_array_equal(mine["fc1_weight"],
                                  params["arg:fc1_weight"])
    assert (mine["fc2_weight"] == 1).all()


def test_load_refuses_a_shape_mismatch_or_a_missing_name(tmp_path):
    fname, _ = _saved(tmp_path)
    init = mt.initializer.Load(fname)
    with pytest.raises(mt.MXNetError, match="shape mismatch"):
        init("fc1_weight", _arr(mt, (3, 4)))
    with pytest.raises(mt.MXNetError, match="no default_init"):
        init("fc9_weight", _arr(mt, (3, 4)))


def test_mixed_as_jax():
    shapes = {"fc1_weight": (3, 4), "fc1_bias": (3,), "emb_weight": (5, 2),
              "bn_gamma": (3,)}
    got = {}
    for pkg in (mt, mx):
        init = pkg.initializer.Mixed(
            ["emb.*", ".*bias", ".*"],
            [pkg.initializer.Constant(0.5), pkg.initializer.Constant(0.25),
             pkg.initializer.One()])
        out = {}
        for name, shape in shapes.items():
            arr = _arr(pkg, shape)
            init(name, arr)
            out[name] = arr.asnumpy()
        got[pkg.__name__] = out
    for name in shapes:
        np.testing.assert_array_equal(got["mxnet_tpu_torch"][name],
                                      got["mxnet_tpu"][name])
    assert (got["mxnet_tpu_torch"]["emb_weight"] == 0.5).all()
    with pytest.raises(mt.MXNetError, match="did not match"):
        mt.initializer.Mixed(["fc.*"], [mt.initializer.One()])(
            "conv_weight", _arr(mt, (2,)))


def test_module_init_params_with_load_and_mixed(tmp_path):
    """``Module.init_params`` takes ``Load`` and ``Mixed``; ``Load`` of a
    saved module's file gives its parameters back."""
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")

    def bound(init):
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", (2, 5))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(init)
        return mod

    src = bound(mt.initializer.Orthogonal())
    fname = str(tmp_path / "m.params")
    src.save_params(fname)
    again = bound(mt.initializer.Load(fname))
    for n, v in src.get_params()[0].items():
        np.testing.assert_array_equal(again.get_params()[0][n].asnumpy(),
                                      v.asnumpy())
    mixed = bound(mt.initializer.Mixed([".*weight", ".*"],
                                       [mt.initializer.MSRAPrelu(),
                                        mt.initializer.Zero()]))
    assert not mixed.get_params()[0]["fc_bias"].asnumpy().any()
