"""The port's predict API and exported artifacts against the JAX
package's (``tests/test_predictor.py``'s cases) on the CPU.

The checkpoint is written by the JAX package's ``Module`` (its
``-symbol.json`` and ``.params`` files, byte for byte the port's
format): the port's ``Predictor`` loads those files and its outputs are
held against the JAX ``Predictor`` and the JAX ``Module`` at rtol 1e-5,
atol 1e-6 (two float32 programs summing in other orders).  An exported
artifact (``export_model``) runs through ``load_exported`` and in a
clean subprocess that imports ``torch`` and nothing of either package;
a graph that reaches a hand-written kernel raises at export.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"data": (20, 6), "softmax_label": (20,)}


def _jax_checkpoint(tmp_path):
    """The JAX package's trained MLP, saved as ``model-0004``: (JAX
    module, prefix, inputs)."""
    rng = np.random.RandomState(0)
    X = rng.randn(120, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(
            mx.sym.Activation(
                mx.sym.FullyConnected(mx.sym.Variable("data"),
                                      num_hidden=8, name="fc1"),
                act_type="relu"),
            num_hidden=2, name="fc2"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=20), num_epoch=4,
            optimizer="sgd", optimizer_params={"learning_rate": 0.3})
    prefix = str(tmp_path / "model")
    mod.save_checkpoint(prefix, 4)
    return mod, prefix, X


def _jax_outputs(mod, x):
    mod.forward(mx.io.DataBatch([mx.nd.array(x)],
                                [mx.nd.zeros((len(x),))]), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _port_net():
    return mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(
            mt.sym.Activation(
                mt.sym.FullyConnected(mt.sym.Variable("data"),
                                      num_hidden=8, name="fc1"),
                act_type="relu"),
            num_hidden=2, name="fc2"), name="softmax")


def test_predictor_matches_jax_on_its_checkpoint(tmp_path):
    mod, prefix, X = _jax_checkpoint(tmp_path)
    batch = X[:20]
    pred = mt.Predictor.from_checkpoint(prefix, 4, SHAPES, ctx=mt.cpu())
    assert pred.output_names == ["softmax_output"]
    pred.set_input("data", batch)
    pred.set_input("softmax_label", np.zeros((20,), np.float32))
    out = pred.forward().get_output(0)
    jpred = mx.Predictor.from_checkpoint(prefix, 4, SHAPES)
    jout = jpred.forward(data=batch, softmax_label=np.zeros(
        (20,), np.float32)).get_output(0)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(out, _jax_outputs(mod, batch), **TOL)


def test_predictor_rejects_bad_input(tmp_path):
    _, prefix, _ = _jax_checkpoint(tmp_path)
    pred = mt.Predictor.from_checkpoint(prefix, 4, {"data": (4, 6),
                                                    "softmax_label": (4,)},
                                        ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="shape"):
        pred.set_input("data", np.zeros((4, 7), np.float32))
    with pytest.raises(mt.MXNetError, match="unknown input"):
        pred.set_input("fc1_weight", np.zeros((8, 6), np.float32))
    with pytest.raises(mt.MXNetError, match="not set"):
        pred.forward(data=np.zeros((4, 6), np.float32))
    with pytest.raises(mt.MXNetError, match="forward"):
        mt.Predictor.from_checkpoint(prefix, 4, {"data": (4, 6),
                                                 "softmax_label": (4,)},
                                     ctx=mt.cpu()).get_output(0)
    # a truncated checkpoint: a missing or misshapen parameter
    params = {k.split(":", 1)[1]: v
              for k, v in mt.nd.load(prefix + "-0004.params").items()}
    net = _port_net()
    with pytest.raises(mt.MXNetError, match="missing parameter 'fc2_bias'"):
        mt.Predictor(net, {k: v for k, v in params.items()
                           if k != "fc2_bias"}, SHAPES, ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="fc1_weight.*shape"):
        mt.Predictor(net, {**params, "fc1_weight": np.zeros((8, 5))},
                     SHAPES, ctx=mt.cpu())


def test_predictor_default_context_is_the_card():
    """Without ``ctx`` the predictor lives on ``gpu(0)``, which raises on
    a host without CUDA (nothing of the port carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default context works")
    net = _port_net()
    with pytest.raises(mt.MXNetError, match="NVIDIA card"):
        mt.Predictor(net, {}, SHAPES)


def test_predictor_dict_params_with_aux():
    """An in-memory dict with BatchNorm aux states, against the JAX
    Predictor over the same arrays."""
    rng = np.random.RandomState(1)
    params = {"bn_gamma": rng.rand(6).astype(np.float32) + 0.5,
              "bn_beta": rng.randn(6).astype(np.float32),
              "bn_moving_mean": rng.randn(6).astype(np.float32),
              "bn_moving_var": rng.rand(6).astype(np.float32) + 0.5,
              "fc_weight": rng.randn(2, 6).astype(np.float32),
              "fc_bias": rng.randn(2).astype(np.float32)}
    shapes = {"data": (4, 6), "softmax_label": (4,)}
    x = rng.randn(4, 6).astype(np.float32)
    outs = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        net = pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(
                pkg.sym.BatchNorm(pkg.sym.Variable("data"), name="bn"),
                num_hidden=2, name="fc"), name="softmax")
        pred = pkg.Predictor(net, params, shapes, **kw)
        outs.append(pred.forward(data=x, softmax_label=np.zeros(
            4, np.float32)).get_output(0))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_set_params_swaps_in_place(tmp_path):
    """``set_params`` copies into the served tensors: a closure taken
    before the swap serves the new weights; a missing or misshapen name
    raises and installs nothing."""
    _, prefix, X = _jax_checkpoint(tmp_path)
    pred = mt.Predictor.from_checkpoint(prefix, 4, SHAPES, ctx=mt.cpu())
    fwd = pred.forward_closure()
    feeds = {"data": torch.from_numpy(X[:20]),
             "softmax_label": torch.zeros(20)}
    before = fwd(feeds)[0].clone()
    params = {k.split(":", 1)[1]: v.asnumpy()
              for k, v in mt.nd.load(prefix + "-0004.params").items()}
    with pytest.raises(mt.MXNetError, match="missing parameter"):
        pred.set_params({k: v for k, v in params.items() if k != "fc1_bias"})
    with pytest.raises(mt.MXNetError, match="shape"):
        pred.set_params({**params, "fc1_bias": np.zeros(3, np.float32)})
    assert torch.equal(fwd(feeds)[0], before)
    doubled = {k: v * 2.0 for k, v in params.items()}
    pred.set_params(doubled)
    ref = mx.Predictor(mx.sym.load(prefix + "-symbol.json"), doubled,
                       SHAPES)
    want = ref.forward(data=X[:20], softmax_label=np.zeros(
        20, np.float32)).get_output(0)
    np.testing.assert_allclose(fwd(feeds)[0].numpy(), want, **TOL)
    assert not np.allclose(want, before.numpy())


def test_export_and_load(tmp_path):
    mod, prefix, X = _jax_checkpoint(tmp_path)
    arg, aux = mod.get_params()
    path = str(tmp_path / "model.mxtorch")
    net = mt.sym.load(prefix + "-symbol.json")
    mt.predictor.export_model(net, {k: v.asnumpy() for k, v in arg.items()},
                              aux, SHAPES, path=path)
    fn, meta = mt.predictor.load_exported(path)
    assert meta["inputs"] == ["data", "softmax_label"]
    assert meta["input_shapes"]["data"] == [20, 6]
    assert meta["outputs"] == ["softmax_output"]
    out = fn(torch.from_numpy(X[:20]), torch.zeros(20))[0]
    np.testing.assert_allclose(out.numpy(), _jax_outputs(mod, X[:20]),
                               **TOL)
    with pytest.raises(mt.MXNetError, match="not an mxnet_tpu_torch"):
        mt.predictor.load_exported(b"MXTPUEXP1" + bytes(16))


def test_exported_artifact_runs_with_torch_alone(tmp_path):
    """The amalgamation claim: the artifact runs in a fresh interpreter
    that imports torch and numpy, and neither package."""
    mod, prefix, X = _jax_checkpoint(tmp_path)
    arg, aux = mod.get_params()
    path = str(tmp_path / "model.mxtorch")
    mt.predictor.export_model(mt.sym.load(prefix + "-symbol.json"),
                              {k: v.asnumpy() for k, v in arg.items()},
                              aux, SHAPES, path=path)
    expect_path, in_path = str(tmp_path / "expect.npy"), str(
        tmp_path / "in.npy")
    np.save(expect_path, _jax_outputs(mod, X[:20]))
    np.save(in_path, X[:20])
    script = f"""
import io, sys
import numpy as np
import torch
raw = open({path!r}, 'rb').read()
assert raw.startswith(b'MXTORCHEXP1')
n = int.from_bytes(raw[11:19], 'little')
fn = torch.export.load(io.BytesIO(raw[19 + n:])).module()
x = torch.from_numpy(np.load({in_path!r}))
out = fn(x, torch.zeros(20))[0].numpy()
np.testing.assert_allclose(out, np.load({expect_path!r}), rtol=1e-5,
                           atol=1e-6)
forbidden = [m for m in sys.modules if m.startswith('mxnet_tpu')
             or m.startswith('jax')]
assert not forbidden, forbidden
print('standalone artifact OK')
"""
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "standalone artifact OK" in r.stdout


@contextlib.contextmanager
def _user_op(name):
    """``name`` registered through ``rtc.register_op`` while entered, and
    gone after: the port's registry holds only the JAX package's names
    (``tests/test_torch_elemwise.py``)."""
    mt.rtc.register_op(name, lambda x: 2 * x)
    try:
        yield getattr(mt.sym, name)
    finally:
        treg._OPS.pop(name)
        delattr(mt.sym, name)
        delattr(mt.nd, name)


@pytest.mark.parametrize("graph", ["attention", "lstm", "serving", "user"])
def test_export_of_a_kernel_graph_raises(graph):
    """A graph that reaches a hand-written kernel raises at export, naming
    the op and the ROADMAP item."""
    data = mt.sym.Variable("data")
    with contextlib.ExitStack() as stack:
        if graph == "attention":
            net = mt.sym.QKVSelfAttention(data, num_heads=2, name="att")
            shapes, name = {"data": (1, 4, 12)}, "QKVSelfAttention"
        elif graph == "lstm":
            net = mt.sym.RNN(data, state_size=4, num_layers=1, mode="lstm",
                             name="rnn")
            shapes, name = {"data": (3, 1, 4)}, "RNN"
        elif graph == "serving":
            net = mt.models.transformer.transformer_lm_decode(
                11, num_layers=1, num_heads=2, d_model=8, kv_block=4)
            shapes, name = {}, "QKVPagedAttentionDecode"
        else:
            name = "export_probe_double"
            net = stack.enter_context(_user_op(name))(data)
            shapes = {"data": (2, 2)}
        with pytest.raises(mt.MXNetError, match=f"{name}.*item 13"):
            mt.predictor.export_model(net, {}, {}, shapes)
