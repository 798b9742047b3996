"""The port's training path against the JAX package, part 2: the
``transformer_lm`` symbol, ``Module`` training steps against the JAX
``Module``, ``fit``, the executor's ``grad_req`` and the module's
context.  ``test_torch_train.py`` holds the attention backward and the
ops.

Inputs come from numpy seeds; parameters are copied out of a JAX
``Module`` (threefry draws cannot be reproduced), never seeded.

Tolerances (fp32): outputs rtol=atol=1e-5, updated weights
rtol=atol=5e-5.  The two packages sum in other orders (torch's matmuls
against XLA's), ~1e-6 apart after a few steps.
"""

import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer_lm as jax_transformer_lm
import mxnet_tpu_torch as mt

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# (c) the transformer_lm symbol
# ---------------------------------------------------------------------------

V, T, L, H, DM, B = 61, 16, 2, 2, 32, 4


@pytest.mark.parametrize("head", ["ce", "softmax"])
def test_transformer_lm_symbol_matches_jax(head):
    js = jax_transformer_lm(V, T, num_layers=L, num_heads=H, d_model=DM,
                            head=head)
    ts = mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                  d_model=DM, head=head)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == []
    params = [n for n in ts.list_arguments()
              if n not in ("data", "softmax_label")]
    assert params == mt.models.param_names(L)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    assert ts.infer_shape(**shapes) == tuple(
        [list(x) for x in js.infer_shape(**shapes)])
    jattr, tattr = js.attr_dict(), ts.attr_dict()
    for n in ts.list_arguments():
        assert tattr.get(n) == jattr.get(n), n


def test_transformer_lm_refuses_what_is_not_ported():
    """``dtype="bfloat16"`` (ported since the bf16 slice) builds the JAX
    graph: its ops in order, ``embed_cast`` among them, and its
    arguments; ``dropout > 0`` builds the JAX graph: its Dropout nodes
    by name, attrs and place (the residual adds take them), its
    arguments and shapes."""
    jb = jax_transformer_lm(V, T, num_layers=L, num_heads=H, d_model=DM,
                            dtype="bfloat16")
    tb = mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                  d_model=DM, dtype="bfloat16")
    assert [n.op for n in tb._topo() if not n.is_variable] == \
        [n.op for n in jb._topo() if not n.is_variable]
    assert ("embed_cast", "Cast") in [(n.name, n.op) for n in tb._topo()]
    assert tb.list_arguments() == jb.list_arguments()
    js = jax_transformer_lm(V, T, num_layers=L, num_heads=H, d_model=DM,
                            dropout=0.1)
    ts = mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                  d_model=DM, dropout=0.1)
    assert ts.list_arguments() == js.list_arguments()
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    assert ts.infer_shape(**shapes) == tuple(
        [list(x) for x in js.infer_shape(**shapes)])

    def drops(sym):
        consumers = {}
        for n in sym._topo():
            for i, _ in n.inputs:
                consumers.setdefault(i.name, []).append(n.op)
        return [(n.name, n.attrs["p"], n.inputs[0][0].name,
                 consumers[n.name]) for n in sym._topo() if n.op == "Dropout"]

    assert drops(ts) == drops(js)
    assert [d[0] for d in drops(ts)] == [
        f"layer{i}_{s}_drop" for i in range(L) for s in ("attn", "ff")]


# ---------------------------------------------------------------------------
# (d) Module training steps against the JAX Module
# ---------------------------------------------------------------------------


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        X = rng.randint(1, V, (B, T)).astype(np.float32)
        Y = rng.randint(0, V, (B, T)).astype(np.float32)  # 0s are ignored
        out.append((X, Y))
    return out


# Adam's first step is sign-like, lr*g/(|g| + epsilon/sqrt(1-beta2)):
# where the true gradient is zero (the key third of qkv_bias, to which
# softmax is blind) both sides update by the sign of rounding noise.
# epsilon=1e-3 keeps the update a smooth function of the gradient.
OPTIMIZERS = {"sgd": ({"learning_rate": 0.1, "momentum": 0.9}, 3),
              "adam": ({"learning_rate": 0.01, "epsilon": 1e-3}, 1)}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("head", ["ce", "softmax"])
def test_module_steps_match_jax_module(head, optimizer):
    params, steps = OPTIMIZERS[optimizer]
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    jmod = mx.mod.Module(jax_transformer_lm(V, T, num_layers=L, num_heads=H,
                                            d_model=DM, head=head),
                         context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Xavier(magnitude=2.0))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    # learned positions start at zero; give them values
    host["pos_embed_weight"] = (np.random.RandomState(5).randn(T, DM)
                                * 0.1).astype(np.float32)
    jmod.set_params({k: mx.nd.array(v) for k, v in host.items()}, {})
    jmod.init_optimizer(optimizer=optimizer, optimizer_params=params)

    tmod = mt.mod.Module(mt.models.transformer_lm(V, T, num_layers=L,
                                                  num_heads=H, d_model=DM,
                                                  head=head),
                         context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=host)
    tmod.init_optimizer(optimizer=optimizer, optimizer_params=params)

    for X, Y in _batches(steps):
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                              [mx.nd.array(Y)]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(X, ctx=mt.cpu())], [mt.nd.array(Y, ctx=mt.cpu())]))
        tmod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(), **FWD)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **GRAD)
    # the step moved the weights
    assert max(np.abs(tw[k] - host[k]).max() for k in tw) > 1e-3


# ---------------------------------------------------------------------------
# (e) fit, the executor's grad_req, the module's context
# ---------------------------------------------------------------------------


def random_walk_iter(vocab, seq_len, batch, steps, seed=7):
    """Next-token batches over a random-walk token stream (token t+1
    lies near token t: a learnable synthetic language)."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randint(-2, 3, size=batch * steps * seq_len + 1))
    toks = (np.abs(walk) % (vocab - 1) + 1).astype(np.float32)
    X = toks[:-1].reshape(batch * steps, seq_len)
    y = toks[1:].reshape(batch * steps, seq_len)
    return mt.io.NDArrayIter(X, y, batch_size=batch)


def test_module_fit_lowers_the_loss_on_the_cpu():
    mt.random.seed(0)
    mod = mt.mod.Module(mt.models.transformer_lm(V, T, num_layers=L,
                                                 num_heads=H, d_model=DM,
                                                 head="ce"),
                        context=mt.cpu(), logger=logging.getLogger("fit"))
    epochs = []
    mod.fit(random_walk_iter(V, T, 8, 6), eval_metric="loss",
            optimizer="sgd", num_epoch=4,
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            initializer=mt.initializer.Xavier(),
            epoch_end_callback=lambda *a: epochs.append(
                mod.score(random_walk_iter(V, T, 8, 6), "loss")[0][1]))
    assert np.all(np.isfinite(epochs))
    assert epochs[-1] < epochs[0] - 0.3, epochs
    # pos_embed_weight's own init attr ("zero") overrode Xavier, and
    # training moved it
    assert np.abs(mod.get_params()[0]["pos_embed_weight"].asnumpy()).max() \
        > 0


def test_init_attr_and_name_rules():
    mod = mt.mod.Module(mt.models.transformer_lm(V, T, num_layers=1,
                                                 num_heads=H, d_model=DM),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(mt.initializer.Uniform(0.5))
    p = mt.params_to_numpy(mod.get_params()[0])
    assert not p["pos_embed_weight"].any()          # its "zero" init attr
    assert np.all(p["layer0_ln1_gamma"] == 1) and not p["head_bias"].any()
    assert 0 < np.abs(p["head_weight"]).max() <= 0.5


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_grad_req(req):
    x = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(x, num_hidden=3, name="fc")
    net = mt.sym.SoftmaxOutput(fc, mt.sym.Variable("softmax_label"),
                               name="softmax")
    ex = net.simple_bind(mt.cpu(), grad_req={"fc_weight": req,
                                             "fc_bias": req},
                         data=(4, 5), softmax_label=(4,))
    rng = np.random.RandomState(0)
    ex.arg_dict["fc_weight"][:] = rng.randn(3, 5).astype(np.float32)
    feed = dict(data=rng.randn(4, 5).astype(np.float32),
                softmax_label=np.array([0, 1, 2, 1], np.float32))
    ex.forward_backward(**feed)
    if req == "null":
        assert "fc_weight" not in ex.grad_dict
        return
    once = ex.grad_dict["fc_weight"].asnumpy()
    assert np.abs(once).max() > 0
    ex.forward_backward(**feed)
    twice = ex.grad_dict["fc_weight"].asnumpy()
    np.testing.assert_allclose(twice, once * (2 if req == "add" else 1),
                               **FWD)
    with pytest.raises(mt.MXNetError, match="before forward"):
        ex.backward()  # the graph was walked already


def test_module_context_and_unported_options():
    net = mt.models.transformer_lm(V, T, num_layers=1, num_heads=H,
                                   d_model=DM)
    if not torch.cuda.is_available():
        # the default context is gpu(0); no card here, so it raises
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            mt.mod.Module(net)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(mt.initializer.Xavier())
    with pytest.raises(mt.MXNetError, match="not ported"):
        mod.init_optimizer(kvstore="device")
    with pytest.raises(mt.MXNetError, match="not ported"):
        mod.fit(random_walk_iter(V, T, B, 2), num_epoch=1, monitor=object())
    with pytest.raises(mt.MXNetError, match="not ported"):
        mt.mod.Module(net, context=[mt.cpu(0), mt.cpu(1)])


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"momentum": 0.9, "wd": 0.01, "clip_gradient": 0.5,
             "rescale_grad": 0.25, "learning_rate": 0.1}),
    ("sgd", {"wd": 0.01, "learning_rate": 0.1}),
    ("adam", {"wd": 0.01, "clip_gradient": 2.0, "learning_rate": 0.01}),
])
def test_optimizer_updates_match_jax(name, kwargs):
    """Eager updates of a weight and a bias (the wd_mult name rule gives
    the bias no weight decay) over three steps against the JAX
    optimizer's."""
    rng = np.random.RandomState(6)
    names = {0: "fc_weight", 1: "fc_bias"}
    jopt = mx.optimizer.create(name, param_idx2name=names, **kwargs)
    topt = mt.optimizer.create(name, param_idx2name=names, **kwargs)
    jup, tup = mx.optimizer.get_updater(jopt), mt.optimizer.get_updater(topt)
    w0 = [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    jw = [mx.nd.array(w) for w in w0]
    tw = [mt.nd.array(w, ctx=mt.cpu()) for w in w0]
    for _ in range(3):
        for i in (0, 1):
            g = (rng.randn(*w0[i].shape) * 3).astype(np.float32)
            jup(i, mx.nd.array(g), jw[i])
            tup(i, mt.nd.array(g, ctx=mt.cpu()), tw[i])
    assert topt.wd_mult == {"fc_bias": 0.0}
    for j, t in zip(jw, tw):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **GRAD)


def test_ndarray_writes_copies_and_arithmetic():
    a = mt.nd.zeros((2, 3), ctx=mt.cpu())
    assert a.shape == (2, 3) and a.dtype == np.float32
    assert a.context == mt.cpu()
    a[:] = 2.0                                  # scalar fill
    a[:] = np.arange(3, dtype=np.float64)       # broadcast, cast to fp32
    np.testing.assert_array_equal(a.asnumpy(), [[0, 1, 2], [0, 1, 2]])
    b = mt.nd.array(np.ones((2, 3)), ctx=mt.cpu())
    assert b.dtype == np.float32                # float64 sources → fp32
    c = (a + b) * 2 - 1
    np.testing.assert_array_equal(c.asnumpy(), [[1, 3, 5], [1, 3, 5]])
    c /= 2
    c += b
    np.testing.assert_array_equal((1 - c).asnumpy(), [[-0.5, -1.5, -2.5]] * 2)
    d = c.copy()
    c[:] = 0.0
    assert d.asnumpy().sum() == 15.0 and c.asnumpy().sum() == 0
    e = mt.nd.zeros((2, 3), ctx=mt.cpu(), dtype="bfloat16")
    d.copyto(e)                                 # cast into the target
    assert e._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(e.asnumpy(), d.asnumpy())
    with pytest.raises(mt.MXNetError, match="not supported"):
        mt.nd.zeros((1,), ctx=mt.cpu(), dtype="complex64")
