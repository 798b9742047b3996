"""The user surface of the operator layer against the JAX package's:
``Symbol`` arithmetic with numbers (``_plus_scalar``, ``_rminus_scalar``,
``_div_scalar``/``_rdiv_scalar``, ``_power_scalar``, ``-s`` as
``_mul_scalar(-1)``), ``/`` and ``**`` of two symbols, ``attr``,
``infer_shape_partial``, ``debug_str``, ``sym.arange``/``zeros``/
``ones``, a variadic op's ``num_args``; ``NDArray.astype``, ``reshape``,
``T``, ``as_in_context``, ``%``, ``**``, the comparisons,
``nd.onehot_encode`` and ``nd.waitall``; ``Executor.copy_params_from``,
``reshape`` and ``debug_str``; and the JSON of a graph of scalar ops
loaded by each package from the other's file.

Tolerances (fp32): rtol = atol = 1e-6 where both sides do the same
arithmetic, 1e-5 through a graph; 0/1 results equal.
"""

import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

EXACT = dict(rtol=1e-6, atol=1e-6)
FWD = dict(rtol=1e-5, atol=1e-5)


def _scalar_graph(api):
    x = api.sym.Variable("x")
    y = api.sym.Variable("y")
    with api.name.NameManager():
        return api.sym.Group([x * 0.5, 2 - x, x / 3, 3 / x, x ** 2, -x,
                              1 + x, x - 1.25, x / y, x ** y, 2 * x + y])


def _structure(sym):
    """(op, attrs, inputs) of every node: names aside, which count the
    nodes each process made before."""
    nodes = json.loads(sym.tojson())["nodes"]
    return [(n["op"], n.get("attr", {}), n["inputs"]) for n in nodes]


def _eval_jax(sym, **arrays):
    return [o.asnumpy() for o in sym.eval(
        ctx=mx.cpu(), **{k: mx.nd.array(v) for k, v in arrays.items()})]


def _eval_port(sym, **arrays):
    return [o.asnumpy() for o in sym.eval(
        ctx=mt.cpu(), **{k: mt.nd.array(v, ctx=mt.cpu())
                         for k, v in arrays.items()})]


def _inputs():
    rng = np.random.RandomState(7)
    return dict(x=rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
                y=rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32))


def test_symbol_arithmetic_with_numbers_builds_the_jax_ops():
    js, ts = _scalar_graph(mx), _scalar_graph(mt)
    assert _structure(ts) == _structure(js)
    ops = [n[0] for n in _structure(ts)]
    for op in ("_mul_scalar", "_rminus_scalar", "_div_scalar",
               "_rdiv_scalar", "_power_scalar", "_plus_scalar",
               "_minus_scalar", "elemwise_div", "_power"):
        assert op in ops
    neg = [n for n in _structure(ts) if n[0] == "_mul_scalar"
           and n[1]["scalar"] == "-1.0"]
    assert neg, "-x is _mul_scalar(-1)"
    for got, want in zip(_eval_port(ts, **_inputs()),
                         _eval_jax(js, **_inputs())):
        np.testing.assert_allclose(got, want, **FWD)
    with pytest.raises(TypeError):
        mt.sym.Variable("x") + "a"


def test_scalar_graph_json_loads_across_packages(tmp_path):
    js, ts = _scalar_graph(mx), _scalar_graph(mt)
    ts.save(str(tmp_path / "port.json"))
    js.save(str(tmp_path / "jax.json"))
    from_port = mx.sym.load(str(tmp_path / "port.json"))
    from_jax = mt.sym.load(str(tmp_path / "jax.json"))
    assert from_jax.tojson() == js.tojson()
    assert from_port.tojson() == ts.tojson()
    want = _eval_jax(js, **_inputs())
    for outs in (_eval_jax(from_port, **_inputs()),
                 _eval_port(from_jax, **_inputs())):
        for got, w in zip(outs, want):
            np.testing.assert_allclose(got, w, **FWD)


def _named_net(api):
    data = api.sym.Variable("data", lr_mult=2.0)
    fc = api.sym.FullyConnected(data, num_hidden=5, name="fc")
    act = api.sym.Activation(fc, act_type="relu", name="relu")
    return api.sym.SoftmaxOutput(act, name="softmax")


def test_attr_infer_shape_partial_debug_str_and_init_symbols():
    js, ts = _named_net(mx), _named_net(mt)
    assert ts.debug_str() == js.debug_str()
    for sym_ in (ts, js):
        assert sym_.get_internals()["data"].attr("lr_mult") == "2.0"
        assert sym_.get_internals()["fc_output"].attr("num_hidden") == "5"
        assert sym_.attr("missing") is None
    assert ts.infer_shape() == (None, None, None)
    assert ts.infer_shape_partial() == js.infer_shape_partial()
    assert ts.infer_shape_partial(data=(2, 7)) == js.infer_shape_partial(
        data=(2, 7))
    for api in (mt, mx):
        assert api.sym.arange(2, 11, 3, repeat=2).infer_shape()[1] == [(6,)]
    np.testing.assert_array_equal(
        _eval_port(mt.sym.arange(2, 11, 3, repeat=2))[0],
        _eval_jax(mx.sym.arange(2, 11, 3, repeat=2))[0])
    np.testing.assert_array_equal(_eval_port(mt.sym.ones((2, 3)))[0],
                                  np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(_eval_port(mt.sym.zeros((4,)))[0],
                                  np.zeros(4, np.float32))
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    node = json.loads(mt.sym.add_n(a, b, a, name="s").tojson())["nodes"][-1]
    ja, jb = mx.sym.Variable("a"), mx.sym.Variable("b")
    jnode = json.loads(mx.sym.add_n(ja, jb, ja, name="s").tojson())[
        "nodes"][-1]
    assert node == jnode and node["attr"]["num_args"] == "3"


def test_ndarray_methods_match_jax():
    rng = np.random.RandomState(5)
    src = (rng.randn(3, 4) * 3).astype(np.float32)
    src[0, :2] = [2.0, -2.0]
    t, j = mt.nd.array(src, ctx=mt.cpu()), mx.nd.array(src)
    assert t.astype("int32").dtype == j.astype("int32").dtype
    np.testing.assert_array_equal(t.astype("int32").asnumpy(),
                                  j.astype("int32").asnumpy())
    for shape in ((4, 3), (-1,), (0, 2, -1), (-3,)):
        np.testing.assert_array_equal(t.reshape(shape).asnumpy(),
                                      j.reshape(shape).asnumpy())
    np.testing.assert_array_equal(t.T.asnumpy(), j.T.asnumpy())
    assert t.as_in_context(mt.cpu()) is t
    for op in (lambda a: a % 1.5, lambda a: a % -1.5, lambda a: a ** 2,
               lambda a: a % a.T.T, lambda a: a ** 2.0 % 5):
        np.testing.assert_allclose(op(t).asnumpy(), op(j).asnumpy(),
                                   **EXACT)
    for op in (lambda a: a == 2.0, lambda a: a != 2.0, lambda a: a > 0,
               lambda a: a >= 2.0, lambda a: a < -2.0, lambda a: a <= 0,
               lambda a: a == a):
        got, want = op(t), op(j)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert len({t, t}) == 1
    out_t, out_j = mt.nd.zeros((3, 5), ctx=mt.cpu()), mx.nd.zeros((3, 5))
    idx = np.array([4, 0, 2], np.float32)
    mt.nd.onehot_encode(mt.nd.array(idx, ctx=mt.cpu()), out_t)
    mx.nd.onehot_encode(mx.nd.array(idx), out_j)
    np.testing.assert_array_equal(out_t.asnumpy(), out_j.asnumpy())
    mt.nd.waitall()


def _bound(api, ctx, batch):
    sym = _named_net(api)
    ex = sym.simple_bind(ctx, data=(batch, 7), softmax_label=(batch,))
    return sym, ex


def test_executor_copy_params_from_reshape_and_debug_str():
    rng = np.random.RandomState(8)
    w = rng.randn(5, 7).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    x = rng.randn(6, 7).astype(np.float32)
    outs = []
    for api, ctx in ((mt, mt.cpu()), (mx, mx.cpu())):
        arr = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if api is mt \
            else mx.nd.array
        sym, ex = _bound(api, ctx, 4)
        ex.copy_params_from({"fc_weight": arr(w), "fc_bias": arr(b)})
        with pytest.raises(api.MXNetError):
            ex.copy_params_from({"nope": arr(b)})
        ex.copy_params_from({"nope": arr(b)}, allow_extra_params=True)
        assert ex.debug_str() == sym.debug_str()
        big = ex.reshape(data=(6, 7), softmax_label=(6,))
        assert big.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
        assert big.arg_dict["data"].shape == (6, 7)
        with pytest.raises(api.MXNetError):
            ex.reshape(fc_weight=(5, 8))
        big.arg_dict["data"][:] = arr(x)
        outs.append(big.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **FWD)
