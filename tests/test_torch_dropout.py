"""Per-node randomness and ``Dropout`` in the port, against the JAX
package with its own masks injected, then the dropout contract in the
port alone.

JAX side: the graph runs as ``mxnet_tpu.executor.build_graph_fn(sym)(
args, aux, key, True)`` for a known ``key`` (the JAX ``Module`` with
``random.next_key`` returning it), so node ``i`` of ``sym._topo()``
draws its mask as ``jax.random.bernoulli(fold_in(key, i), keep,
shape)``, the fused RNN's layer ``l`` as ``fold_in(fold_in(key, i), l)``
and rrelu its slopes as ``jax.random.uniform(fold_in(key, i), (B, C),
lo, hi)``.  Port side: those masks and slopes replace
``ops.nn.draw_mask`` / ``draw_slopes``, in the order the nodes run.
Cases: ``Dropout`` in float32 and bfloat16, a two-layer LSTM with ``p =
0.5``, rrelu in training, and one ``Module`` SGD step of the two-layer
LM with ``dropout=0.1`` against the JAX ``Module``'s.

Tolerances: outputs and gradients rtol=atol=1e-5, losses 1e-6 (as
``test_torch_cnn.py``); bfloat16 Dropout is exact (one rounded division
on both sides).  Statistics: a keep fraction within 6 sigma of its
expectation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import executor as jax_executor
from mxnet_tpu.models.transformer import transformer_lm as jax_lm
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as t_executor
from mxnet_tpu_torch.ops import nn as tnn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-6, atol=1e-6)
KEY = jax.random.PRNGKey(42)


def _index(sym, name):
    return [n.name for n in sym._topo()].index(name)


class Injected:
    """Stands in for ``draw_mask`` / ``draw_slopes``: hands out the given
    draws in order and records the shapes asked for."""

    def __init__(self, draws):
        self.draws = [torch.from_numpy(np.array(d)) for d in draws]
        self.asked = []

    def __call__(self, generator, *args):
        assert isinstance(generator, torch.Generator)
        self.asked.append(tuple(next(a for a in args
                                     if isinstance(a, tuple))))
        return self.draws.pop(0)


def _jax_graph(sym, args, argnums):
    """Outputs of the JAX graph at ``KEY`` in training and a vjp over
    the arguments named in ``argnums``."""
    fn = jax_executor.build_graph_fn(sym)

    def f(*xs):
        full = dict(args)
        full.update(zip(argnums, xs))
        return fn(full, {}, KEY, True)[0]

    return jax.vjp(f, *[jnp.asarray(args[n]) for n in argnums])


def _port_graph(sym, args, argnums, dtype=torch.float32):
    fn = t_executor.build_graph_fn(sym)
    tin = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
           for k, v in args.items()}
    for n in argnums:
        tin[n].requires_grad_(True)
    outs, _ = fn(tin, {}, 123, True)
    return outs, [tin[n] for n in argnums]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_with_the_jax_masks_matches_jax(monkeypatch, dtype):
    """Two Dropout nodes in a chain: the outputs and the input's
    gradient under one cotangent."""
    rng = np.random.RandomState(0)
    for pkg in (mx, mt):
        x = pkg.sym.Variable("data")
        h = pkg.sym.Dropout(x, p=0.3, name="d1") * pkg.sym.Variable("w")
        s = pkg.sym.Dropout(h, p=0.6, name="d2")
        if pkg is mx:
            jsym = s
        else:
            tsym = s
    X = rng.randn(4, 33).astype(np.float32)
    W = rng.randn(4, 33).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = {"data": jnp.asarray(X, jdt), "w": jnp.asarray(W, jdt)}
    masks = [jax.random.bernoulli(jax.random.fold_in(KEY, _index(jsym, n)),
                                  1 - p, X.shape)
             for n, p in (("d1", 0.3), ("d2", 0.6))]
    jouts, vjp = _jax_graph(jsym, args, ["data"])
    cot = rng.randn(*X.shape).astype(np.float32)
    jgrad, = vjp([jnp.asarray(cot, jdt)])

    inject = Injected(masks)
    monkeypatch.setattr(tnn, "draw_mask", inject)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    outs, (tx,) = _port_graph(tsym, {"data": X, "w": W}, ["data"], tdt)
    assert inject.asked == [X.shape, X.shape] and not inject.draws
    assert outs[0].dtype == tdt
    tgrad, = torch.autograd.grad(outs[0], tx, torch.from_numpy(cot).to(tdt))
    got = outs[0].detach().float().numpy()
    want = np.asarray(jouts[0].astype(jnp.float32))
    gg, gw = tgrad.float().numpy(), np.asarray(jgrad.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gg, gw)
    else:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(gg, gw, **TOL)
    assert (got == 0).any() and (got != 0).any()


def test_rnn_dropout_between_layers_with_the_jax_masks_matches_jax(
        monkeypatch):
    """A two-layer LSTM with p = 0.5: layer 0's output is dropped with
    the mask keyed ``fold_in(fold_in(key, node), 0)``, the last
    layer's output is not; outputs and the data's and parameters'
    gradients."""
    T, B, I, Hs, L = 5, 3, 4, 6, 2
    size = mt.ops.rnn.rnn_param_size(L, I, Hs, False, "lstm")
    rng = np.random.RandomState(1)
    args = {"data": rng.randn(T, B, I).astype(np.float32),
            "rnn_parameters": (rng.randn(size) * 0.3).astype(np.float32),
            "rnn_state": rng.randn(L, B, Hs).astype(np.float32) * 0.1,
            "rnn_state_cell": rng.randn(L, B, Hs).astype(np.float32) * 0.1}
    syms = [pkg.sym.RNN(pkg.sym.Variable("data"), state_size=Hs,
                        num_layers=L, mode="lstm", p=0.5, name="rnn")
            for pkg in (mx, mt)]
    assert syms[0].list_arguments() == syms[1].list_arguments()
    node_key = jax.random.fold_in(KEY, _index(syms[0], "rnn"))
    mask = jax.random.bernoulli(jax.random.fold_in(node_key, 0), 0.5,
                                (T, B, Hs))
    names = ["data", "rnn_parameters"]
    jouts, vjp = _jax_graph(syms[0], args, names)
    cot = rng.randn(T, B, Hs).astype(np.float32)
    jgrads = vjp([jnp.asarray(cot)])

    inject = Injected([mask])
    monkeypatch.setattr(tnn, "draw_mask", inject)
    outs, tins = _port_graph(syms[1], args, names)
    assert inject.asked == [(T, B, Hs)]  # the last layer is not dropped
    np.testing.assert_allclose(outs[0].detach().numpy(),
                               np.asarray(jouts[0]), **TOL)
    for name, g, w in zip(names, torch.autograd.grad(
            outs[0], tins, torch.from_numpy(cot)), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_rrelu_in_training_with_the_jax_slopes_matches_jax(monkeypatch):
    rng = np.random.RandomState(2)
    syms = [pkg.sym.LeakyReLU(pkg.sym.Variable("data"), act_type="rrelu",
                              lower_bound=0.1, upper_bound=0.4, name="act")
            for pkg in (mx, mt)]
    X = rng.randn(3, 5, 4, 2).astype(np.float32)
    slopes = jax.random.uniform(
        jax.random.fold_in(KEY, _index(syms[0], "act")), (3, 5),
        minval=0.1, maxval=0.4)
    jouts, vjp = _jax_graph(syms[0], {"data": X}, ["data"])
    cot = rng.randn(*X.shape).astype(np.float32)
    jgrad, = vjp([jnp.asarray(cot)])
    inject = Injected([slopes])
    monkeypatch.setattr(tnn, "draw_slopes", inject)
    outs, (tx,) = _port_graph(syms[1], {"data": X}, ["data"])
    assert inject.asked == [(3, 5)]
    np.testing.assert_allclose(outs[0].detach().numpy(),
                               np.asarray(jouts[0]), **TOL)
    tgrad, = torch.autograd.grad(outs[0], tx, torch.from_numpy(cot))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)


def test_draw_slopes_scales_uniforms_as_jax_does():
    """The port's own slopes: ``jax.random.uniform``'s arithmetic over
    the generator's float32 uniforms, inside [lower, upper)."""
    g = mt.random.key_generator(7, "cpu")
    s = tnn.draw_slopes(g, (64, 32), 0.125, 0.334, "cpu")
    u = torch.rand((64, 32), generator=mt.random.key_generator(7, "cpu"))
    lo, hi = np.float32(0.125), np.float32(0.334)
    want = np.maximum(lo, u.numpy() * (hi - lo) + lo)
    np.testing.assert_array_equal(s.numpy(), want)
    assert s.min() >= 0.125 and s.max() < 0.334


V, T, B = 61, 16, 2


def test_dropout_lm_module_step_with_the_jax_masks_matches_jax(
        monkeypatch):
    """``transformer_lm(61, 16, num_layers=2, num_heads=2, d_model=32,
    dropout=0.1, head="ce")``: one SGD step (lr 0.1, momentum 0.9) of
    each package's ``Module`` from the same parameters, the JAX step at
    a known key (``next_key`` returns it; the plain step path, where a
    forward's key is that draw) and the port's with the JAX masks of its
    four Dropout nodes."""
    kw = dict(num_layers=2, num_heads=2, d_model=32, dropout=0.1, head="ce")
    jsym = jax_lm(V, T, **kw)
    tsym = mt.models.transformer_lm(V, T, **kw)
    assert tsym.list_arguments() == jsym.list_arguments()
    drops = [n for n in jsym._topo() if n.op == "Dropout"]
    assert [n.name for n in drops] == [n.name for n in tsym._topo()
                                      if n.op == "Dropout"] == [
        "layer0_attn_drop", "layer0_ff_drop", "layer1_attn_drop",
        "layer1_ff_drop"]
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    monkeypatch.setattr(mx.random, "next_key", lambda: KEY)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(mx.initializer.Xavier(magnitude=2.0))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    host["pos_embed_weight"] = (np.random.RandomState(5).randn(T, 32)
                                * 0.1).astype(np.float32)
    jmod.set_params({k: mx.nd.array(v) for k, v in host.items()}, {})
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tmod = mt.mod.Module(tsym, context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=host)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)

    rng = np.random.RandomState(1)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(0, V, (B, T)).astype(np.float32)
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    jmod.update()
    index = {n.name: i for i, n in enumerate(jsym._topo())}
    masks = [jax.random.bernoulli(jax.random.fold_in(KEY, index[n.name]),
                                  0.9, (B, T, 32)) for n in drops]
    inject = Injected(masks)
    monkeypatch.setattr(tnn, "draw_mask", inject)
    tmod.forward_backward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                          [mt.nd.array(Y, ctx=mt.cpu())]))
    tmod.update()
    assert len(inject.asked) == 4 and not inject.draws
    jloss = jmod.get_outputs()[0].asnumpy()
    tloss = tmod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(tloss, jloss, **LOSS)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)
    # the masks mattered: without them the loss is another
    monkeypatch.undo()
    ref = mt.mod.Module(mt.models.transformer_lm(V, T, **dict(kw,
                                                              dropout=0.0)),
                        context=mt.cpu())
    ref.bind(**shapes)
    ref.init_params(arg_params=host)
    ref.forward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                [mt.nd.array(Y, ctx=mt.cpu())]),
                is_train=True)
    assert np.abs(ref.get_outputs()[0].asnumpy() - tloss).max() > 1e-3


# ---------------------------------------------------------------------------
# the contract in the port alone
# ---------------------------------------------------------------------------


def _keep_ok(mask, keep):
    n = mask.numel()
    frac = mask.float().mean().item()
    return abs(frac - keep) <= 6 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_keep_fraction_scale_and_zeros(p):
    x = torch.ones(1 << 16)
    (out,), _ = mt.ops.registry.invoke("Dropout", [x], {"p": p},
                                       is_train=True)
    kept = out != 0
    assert _keep_ok(kept, 1 - p)
    scale = torch.tensor(1.0) / torch.tensor(1 - p)
    assert torch.equal(out[kept], scale.expand(int(kept.sum())))


def test_identity_in_inference_and_at_p_zero():
    x = torch.randn(4, 5)
    for p, train in ((0.5, False), (0.0, True), (-0.1, True)):
        (out,), _ = mt.ops.registry.invoke("Dropout", [x], {"p": p},
                                           is_train=train)
        assert out is x


_DRAW_MASK = tnn.draw_mask


class Recorder:
    """Wraps ``draw_mask``, keeping every mask drawn."""

    def __init__(self):
        self.masks = []

    def __call__(self, *args):
        m = _DRAW_MASK(*args)
        self.masks.append(m.clone())
        return m


def _two_node_module():
    x = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(x, num_hidden=64, name="fc1")
    h = mt.sym.Dropout(h, p=0.5, name="drop1")
    h = mt.sym.FullyConnected(h, num_hidden=64, name="fc2")
    h = mt.sym.Dropout(h, p=0.5, name="drop2")
    h = mt.sym.FullyConnected(h, num_hidden=4, name="fc3")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(h, name="softmax"),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (8, 16))],
             label_shapes=[("softmax_label", (8,))])
    mt.random.seed(3)
    mod.init_params(mt.initializer.Xavier())
    return mod


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return mt.io.DataBatch(
        [mt.nd.array(rng.randn(8, 16).astype(np.float32), ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 4, 8).astype(np.float32),
                     ctx=mt.cpu())])


def test_same_seed_same_masks_other_nodes_and_steps_other_masks(
        monkeypatch):
    mod = _two_node_module()
    runs = []
    for _ in range(2):
        rec = Recorder()
        monkeypatch.setattr(tnn, "draw_mask", rec)
        mt.random.seed(11)
        for _ in range(2):
            mod.forward(_batch(), is_train=True)
        runs.append(rec.masks)
    (a1, a2, b1, b2), again = runs[0], runs[1]
    assert len(again) == 4
    assert all(torch.equal(m, n) for m, n in zip(runs[0], again))
    assert not torch.equal(a1, a2)  # two nodes of one step
    assert not torch.equal(a1, b1) and not torch.equal(a2, b2)  # two steps
    # another seed, other masks
    rec = Recorder()
    monkeypatch.setattr(tnn, "draw_mask", rec)
    mt.random.seed(12)
    mod.forward(_batch(), is_train=True)
    assert not torch.equal(rec.masks[0], a1)


def test_forward_and_backward_share_one_mask(monkeypatch):
    x = mt.sym.Variable("data")
    net = mt.sym.MakeLoss(mt.sym.Dropout(x * mt.sym.Variable("w"), p=0.4,
                                         name="drop"))
    rng = np.random.RandomState(4)
    X, W = rng.randn(6, 7).astype(np.float32), rng.randn(6, 7)
    ex = net.simple_bind(mt.cpu(), data=(6, 7), w=(6, 7))
    ex.arg_dict["data"][:] = X
    ex.arg_dict["w"][:] = W.astype(np.float32)
    rec = Recorder()
    monkeypatch.setattr(tnn, "draw_mask", rec)
    ex.forward(is_train=True)
    ex.backward()
    assert len(rec.masks) == 1  # the backward drew nothing
    mask = rec.masks[0].numpy()
    out = ex.outputs[0].asnumpy()
    keep = np.float32(1) / np.float32(0.6)
    np.testing.assert_array_equal(out != 0, mask)
    # MakeLoss seeds ones: d out / d w = data * mask / keep
    np.testing.assert_allclose(ex.grad_dict["w"].asnumpy(),
                               np.where(mask, X * keep, 0), rtol=1e-6)


def test_predict_and_score_never_drop(monkeypatch):
    mod = _two_node_module()
    rng = np.random.RandomState(5)
    it = mt.io.NDArrayIter(rng.randn(20, 16).astype(np.float32),
                           rng.randint(0, 4, 20).astype(np.float32),
                           batch_size=8)
    rec = Recorder()
    monkeypatch.setattr(tnn, "draw_mask", rec)
    pred = mod.predict(it).asnumpy()
    mod.score(it, "acc")
    assert rec.masks == []
    # the same as the graph without its Dropout nodes
    x = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(x, num_hidden=64, name="fc1")
    h = mt.sym.FullyConnected(h, num_hidden=64, name="fc2")
    h = mt.sym.FullyConnected(h, num_hidden=4, name="fc3")
    plain = mt.mod.Module(mt.sym.SoftmaxOutput(h, name="softmax"),
                          context=mt.cpu())
    plain.bind(data_shapes=[("data", (8, 16))],
               label_shapes=[("softmax_label", (8,))], for_training=False)
    plain.init_params(arg_params=mod.get_params()[0])
    it.reset()
    np.testing.assert_array_equal(plain.predict(it).asnumpy(), pred)


def test_executor_hands_every_random_node_its_own_generator(monkeypatch):
    """In training and in inference each ``needs_rng`` node gets a
    generator seeded with ``sub_key(step_key, node_index)`` and that
    key; one step key is drawn a forward."""
    seen = []
    op = mt.ops.registry.get_op("Dropout")
    compute = op.compute

    def spy(op_ctx, attrs, inputs, aux):
        seen.append((op_ctx.is_train, op_ctx.rng, op_ctx.key))
        return compute(op_ctx, attrs, inputs, aux)

    monkeypatch.setattr(op, "compute", spy)
    mod = _two_node_module()
    keys = []
    draw = mt.random.next_key

    def next_key():
        keys.append(draw())
        return keys[-1]

    monkeypatch.setattr(mt.random, "next_key", next_key)
    mod.forward(_batch(), is_train=True)
    mod.forward(_batch(), is_train=False)
    assert len(keys) == 2 and len(seen) == 4
    index = {n.name: i for i, n in enumerate(mod.symbol._topo())}
    for (train, g, key), step, name in zip(
            seen, [keys[0]] * 2 + [keys[1]] * 2, ["drop1", "drop2"] * 2):
        assert isinstance(g, torch.Generator)
        assert key == mt.random.sub_key(step, index[name])
        assert g.initial_seed() == key
    assert [s[0] for s in seen] == [True, True, False, False]


def test_step_key_chain_state_round_trip():
    mt.random.seed(21)
    first = [mt.random.next_key() for _ in range(3)]
    mt.random.seed(21)
    assert [mt.random.next_key() for _ in range(3)] == first
    assert len(set(first)) == 3 and all(0 <= k < 2 ** 63 for k in first)
    state = mt.random.get_state()
    ahead = [mt.random.next_key() for _ in range(2)]
    mt.random.set_state(state)
    assert [mt.random.next_key() for _ in range(2)] == ahead
    mt.random.set_state(None)  # leaves the chain as it is
    assert mt.random.next_key() not in ahead
    mt.random.seed(0)
    assert mt.random.get_state() is None


def test_eager_rnn_dropout_draws_each_layer_from_the_generator():
    """Outside a graph (``registry.invoke``) the layers' masks come from
    the call's generator in turn: a seeded generator repeats them."""
    T, B, I, Hs, L = 4, 2, 3, 5, 3
    size = mt.ops.rnn.rnn_param_size(L, I, Hs, False, "gru")
    rng = np.random.RandomState(6)
    ins = [torch.from_numpy(rng.randn(T, B, I).astype(np.float32)),
           torch.from_numpy((rng.randn(size) * 0.3).astype(np.float32)),
           torch.zeros(L, B, Hs)]
    attrs = dict(state_size=Hs, num_layers=L, mode="gru", p=0.5)
    outs = [mt.ops.registry.invoke("RNN", ins, attrs, is_train=True,
                                   rng=mt.random.key_generator(9, "cpu"))
            [0][0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    (ref,), _ = mt.ops.registry.invoke("RNN", ins, dict(attrs, p=0.0))
    assert not torch.equal(outs[0], ref)
