"""The fused step's CUDA graphs (``mxnet_tpu_torch/module/fused_step.py``)
on the card: marked ``cuda``, they skip on a host without one (the CPU
runs the same step uncaptured: ``test_torch_fused_step.py``).  Run them
there with ``python -m pytest tests/test_torch_fused_graphs.py``; this
file imports no JAX.

A small ``transformer_lm`` (its attention through B1's kernels) takes
``STEPS`` SGD steps eagerly (``MXNET_FUSED_STEP=0``) and through the
graphed step (``_WARMUP_STEPS`` eager steps on a side stream, a capture
and replays): losses and parameters agree within ``TOL`` (the
embedding's backward sums with atomics, in no fixed order), every step
launches B1's three kernels once a layer, a replay's outputs are
copies, a replaced parameter tensor makes the step capture again, and
the inference forward under its graph equals the eager one.  Dropout
under replay draws new masks each step (a mask probe writes each mask
into a buffer made before the capture).  LSTM-PTB's symbol over two
buckets: a graph a bucket from one pool, ``lstm_scan`` launched once a
layer a step by replay, one step counter.  ResNet-20 (BatchNorm: its
moving statistics written by every step) and SSD300 at its published
widths (``MultiBoxTarget`` and ``MakeLoss`` heads) take graphed steps
against eager steps from the same parameters: outputs of every step,
weights and moving statistics agree within ``TOL``.  A fused states
file loaded into a module whose step is captured drops the graph and
repeats the steps after the save; a thread copying to the host (a
checkpoint writer) beside a capture fails neither.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import fused_step
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-4, atol=1e-5)
V, T, B, L = 97, 64, 4, 2
STEPS = 6
PACKED = ("flash_mha_packed", "flash_mha_packed_bwd_dq",
          "flash_mha_packed_bwd_dkv")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels "
                    "exist only there); the CPU runs the step uncaptured "
                    "in test_torch_fused_step.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mt.gpu(0)


def _lm(dropout=0.0):
    return mt.models.transformer_lm(V, T, num_layers=L, num_heads=2,
                                    d_model=64, head="ce", dropout=dropout)


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, V, (B, T)).astype(np.float32),
             rng.randint(0, V, (B, T)).astype(np.float32))
            for _ in range(n)]


def _module(ctx, monkeypatch, fused, sym=None, params=None):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    mod = mt.mod.Module(sym if sym is not None else _lm(), context=ctx)
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    if params is None:
        mt.random.seed(3)
        mod.init_params(mt.initializer.Xavier(magnitude=2.0))
    else:
        mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    return mod


def _batch(ctx, X, Y):
    return mt.io.DataBatch([mt.nd.array(X, ctx=ctx)],
                           [mt.nd.array(Y, ctx=ctx)])


def _train(mod, ctx, batches):
    losses, launches = [], []
    for X, Y in batches:
        before = dict(ck.LAUNCHES)
        mod.forward_backward(_batch(ctx, X, Y))
        mod.update()
        torch.cuda.synchronize()
        launches.append({k: ck.LAUNCHES[k] - before[k] for k in PACKED})
        losses.append(mod.get_outputs()[0].asnumpy())
    return losses, launches


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.cuda
def test_graphed_step_matches_the_eager_step(card, monkeypatch):
    batches = _batches(STEPS)
    eager = _module(card, monkeypatch, fused=False)
    start = eager.get_params()[0]
    e_losses, e_launches = _train(eager, card, batches)
    graphed = _module(card, monkeypatch, fused=True, params=start)
    g_losses, g_launches = _train(graphed, card, batches)
    step = graphed._train_step
    assert isinstance(step, fused_step.Graphed) and step.graph is not None
    stats = graphed.graph_stats()
    assert stats["graphs_on"] and stats["captures"] == 1
    assert stats["graphs"] == 1 and stats["pool_bytes"] > 0
    want = {k: L for k in PACKED}
    assert e_launches == g_launches == [want] * STEPS
    for i, (a, b) in enumerate(zip(g_losses, e_losses)):
        np.testing.assert_allclose(a, b, err_msg=f"loss {i}", **TOL)
    pe, pg = _params(eager), _params(graphed)
    for k in pe:
        np.testing.assert_allclose(pg[k], pe[k], err_msg=k, **TOL)
    # outputs kept from two replays are two arrays
    assert not np.array_equal(g_losses[-1], g_losses[-2])


@pytest.mark.cuda
def test_a_replaced_tensor_recaptures_and_inference_replays(card,
                                                            monkeypatch):
    mod = _module(card, monkeypatch, fused=True)
    batches = _batches(STEPS + fused_step._WARMUP_STEPS + 1, seed=2)
    _train(mod, card, batches[:STEPS])
    step = mod._train_step
    assert step.captures == 1
    arr = mod._exec.arg_dict["tok_embed_weight"]
    arr._data = arr._data.clone()  # same values, another tensor
    _train(mod, card, batches[STEPS:STEPS + fused_step._WARMUP_STEPS])
    assert step.captures == 1 and step.graph is None  # warming up again
    assert step.warm == fused_step._WARMUP_STEPS
    _train(mod, card, batches[-1:])
    assert step.captures == 2 and step.captured[
        list(mod._exec.arg_dict).index("tok_embed_weight")] is arr._data
    # inference: graph replays against the eager forward, same weights
    X, Y = batches[0]
    outs = []
    for _ in range(fused_step._WARMUP_STEPS + 2):
        mod.forward(_batch(card, X, Y), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert mod._infer_step.captures == 1
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    ref = mt.mod.Module(_lm(), context=card)
    ref.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))], for_training=False)
    ref.init_params(arg_params=mod.get_params()[0])
    ref.forward(_batch(card, X, Y), is_train=False)
    want = ref.get_outputs()[0].asnumpy()
    for out in outs:
        np.testing.assert_allclose(out, want, **TOL)


class MaskProbe:
    """Wraps ``draw``: each mask drawn is also copied into a buffer made
    at its first (eager) draw, so a captured step writes every replay's
    mask where the host can read it."""

    def __init__(self, draw, nodes):
        self.draw = draw
        self.nodes = nodes
        self.buffers = []
        self.calls = 0

    def __call__(self, *args):
        m = self.draw(*args)
        i = self.calls % self.nodes
        if len(self.buffers) <= i:
            self.buffers.append(torch.empty_like(m))
        self.buffers[i].copy_(m)
        self.calls += 1
        return m


@pytest.mark.cuda
def test_replayed_dropout_steps_draw_new_masks(card, monkeypatch):
    probe = MaskProbe(tnn.draw_mask, 2 * L)
    monkeypatch.setattr(tnn, "draw_mask", probe)
    mod = _module(card, monkeypatch, fused=True, sym=_lm(dropout=0.1))
    masks = []
    for X, Y in _batches(STEPS, seed=4):
        mod.forward_backward(_batch(card, X, Y))
        mod.update()
        torch.cuda.synchronize()
        masks.append([b.clone() for b in probe.buffers])
    assert mod._train_step.captures == 1
    # the warm-up steps and the capture call it, replays do not
    assert probe.calls == 2 * L * (fused_step._WARMUP_STEPS + 1)
    for t in range(1, STEPS):
        for node in range(2 * L):
            assert not torch.equal(masks[t][node], masks[t - 1][node]), \
                (t, node)
            frac = masks[t][node].float().mean().item()
            n = masks[t][node].numel()
            assert abs(frac - 0.9) <= 6 * np.sqrt(0.9 * 0.1 / n)


@pytest.mark.cuda
def test_bucket_graphs_share_one_pool_and_one_counter(card, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    vocab, hidden, layers, batch = 50, 32, 2, 4

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=vocab, output_dim=16,
                                 name="embed")
        rnn = mt.sym.RNN(data=mt.sym.transpose(embed, axes=(1, 0, 2)),
                         parameters=mt.sym.Variable("rnn_parameters"),
                         state=mt.sym.Variable("rnn_state"),
                         state_cell=mt.sym.Variable("rnn_state_cell"),
                         state_size=hidden, num_layers=layers, mode="lstm",
                         name="rnn")
        out = mt.sym.Reshape(mt.sym.transpose(rnn, axes=(1, 0, 2)),
                             shape=(-1, hidden))
        pred = mt.sym.FullyConnected(out, num_hidden=vocab, name="pred")
        sm = mt.sym.SoftmaxOutput(pred, mt.sym.Reshape(label, shape=(-1,)),
                                  name="softmax")
        return sm, ("data",), ("softmax_label",)

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=card)
    mod.bind(data_shapes=[("data", (batch, 8))],
             label_shapes=[("softmax_label", (batch, 8))])
    zeros = mt.nd.zeros((layers, batch, hidden), ctx=card)
    mod.init_params(mt.initializer.Uniform(0.08), allow_missing=True,
                    arg_params={"rnn_state": zeros,
                                "rnn_state_cell": zeros.copy()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    rng = np.random.RandomState(5)
    keys = [8, 4] * 5
    for key in keys:
        X = rng.randint(1, vocab, (batch, key)).astype(np.float32)
        before = ck.LAUNCHES["lstm_scan"]
        mod.forward(mt.io.DataBatch(
            [mt.nd.array(X, ctx=card)], [mt.nd.array(X, ctx=card)],
            bucket_key=key,
            provide_data=[mt.io.DataDesc("data", (batch, key))],
            provide_label=[mt.io.DataDesc("softmax_label", (batch, key))]),
            is_train=True)
        mod.backward()
        mod.update()
        assert ck.LAUNCHES["lstm_scan"] - before == layers
        out = mod.get_outputs()[0].asnumpy()
        assert np.isfinite(out).all()
    stats = mod.graph_stats()
    assert stats["graphs"] == 2 and stats["captures"] == 2
    a, b = (mod._buckets[k] for k in (8, 4))
    assert a._pool_handle() is b._pool_handle() and a._fused is b._fused
    assert float(a._fused.t) == len(keys)


def _image_pair(card, monkeypatch, sym, shapes, batches, init, opt_params,
                label_names=("softmax_label",)):
    """The same start trained on ``batches`` eagerly, then graphed →
    ([(outputs of each step, weights, aux states)] of the two runs, the
    aux states at the start)."""
    runs, start = [], None
    for fused in (False, True):
        monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
        mod = mt.mod.Module(sym, label_names=label_names, context=card)
        mod.bind(**shapes)
        if start is None:
            mt.random.seed(5)
            mod.init_params(init)
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
        outs = []
        for X, Y in batches:
            mod.forward_backward(_batch(card, X, Y))
            mod.update()
            outs.append([o.asnumpy() for o in mod.get_outputs()])
        if fused:
            assert mod.graph_stats()["captures"] == 1
            assert mod._train_step.graph is not None
        else:
            assert mod._fused is None
        arg, aux = mod.get_params()
        runs.append((outs, {k: v.asnumpy() for k, v in arg.items()},
                     {k: v.asnumpy() for k, v in aux.items()}))
    return runs, {k: v.asnumpy() for k, v in start[1].items()}


def _assert_pair_close(runs):
    (e_outs, e_arg, e_aux), (g_outs, g_arg, g_aux) = runs
    for i, (a, b) in enumerate(zip(g_outs, e_outs)):
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, err_msg=f"step {i} output {j}",
                                       **TOL)
    for kind, g, e in (("weight", g_arg, e_arg), ("aux", g_aux, e_aux)):
        assert sorted(g) == sorted(e)
        for k in e:
            np.testing.assert_allclose(g[k], e[k], err_msg=f"{kind} {k}",
                                       **TOL)


@pytest.mark.cuda
def test_graphed_batchnorm_steps_match_the_eager_steps(card, monkeypatch):
    sym = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 32, 32))
    rng = np.random.RandomState(4)
    batches = [(rng.rand(8, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, 8).astype(np.float32))
               for _ in range(STEPS)]
    runs, start = _image_pair(
        card, monkeypatch, sym,
        dict(data_shapes=[("data", (8, 3, 32, 32))],
             label_shapes=[("softmax_label", (8,))]), batches,
        mt.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                              magnitude=2),
        {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
    _assert_pair_close(runs)
    moved = [k for k in start if not np.allclose(runs[1][2][k], start[k])]
    assert len(moved) == len(start), "a moving statistic stayed put"


@pytest.mark.cuda
def test_graphed_ssd300_steps_match_the_eager_steps(card, monkeypatch):
    from mxnet_tpu_torch.models.ssd import ssd300_symbol, synthetic_boxes

    train_sym, _ = ssd300_symbol()
    X, Y = synthetic_boxes(2 * 4, seed=0)
    batches = [(X[i:i + 2], Y[i:i + 2]) for i in range(0, 8, 2)]
    batches.append(batches[0])  # a second replay
    runs, _ = _image_pair(
        card, monkeypatch, train_sym,
        dict(data_shapes=[("data", (2, 3, 300, 300))],
             label_shapes=[("label", (2,) + Y.shape[1:])]), batches,
        mt.initializer.Xavier(), {"learning_rate": 0.002, "momentum": 0.9,
                                  "wd": 0.0005, "rescale_grad": 1.0},
        label_names=("label",))
    _assert_pair_close(runs)


@pytest.mark.cuda
def test_states_restored_into_a_captured_step(card, monkeypatch, tmp_path):
    """A dropout LM's fused states file (optimizer states, step count,
    the random streams) saved after 4 graphed steps, loaded back with
    the parameters of that moment into the same module after 2 more
    steps: restoring the streams drops the captured graph (its
    generators' states were set), and the next 2 steps (eager warm-ups
    again) repeat the 2 after the save, masks and all: parameters and
    momentum within ``TOL``."""
    batches = _batches(6)
    mod = _module(card, monkeypatch, fused=True, sym=_lm(dropout=0.1))
    _train(mod, card, batches[:4])
    step = mod._train_step
    assert step.graph is not None and step.captures == 1
    fname = str(tmp_path / "lm.states")
    mod.save_optimizer_states(fname)
    saved = mod.get_params()
    _train(mod, card, batches[4:])
    want = _params(mod)
    want_mom = {n: s.cpu().numpy() for n, s in mod._fused.states.items()}
    mod.set_params(*saved)
    mod.load_optimizer_states(fname)
    assert mod._fused.step_count == 4
    _train(mod, card, batches[4:])
    assert step.graph is None and step.warm == 2 and step.captures == 1
    got = _params(mod)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for n, s in mod._fused.states.items():
        np.testing.assert_allclose(s.cpu().numpy(), want_mom[n],
                                   err_msg=f"{n} momentum", **TOL)


@pytest.mark.cuda
def test_capture_beside_a_thread_copying_to_the_host(card, monkeypatch):
    """A thread that copies a device tensor to the host on its own
    stream, as the checkpoint writer does, while the module warms up,
    captures and replays: the capture succeeds and so does every copy
    (under CUDA's default global capture mode the copy raises and the
    capture is invalidated)."""
    import threading

    src = torch.randn(4 << 20, device="cuda")
    stop, errors, copies = threading.Event(), [], [0]

    def writer():
        stream = torch.cuda.Stream()
        while not stop.is_set():
            with torch.cuda.stream(stream):
                try:
                    src.cpu()
                except Exception as exc:  # reported by the test
                    errors.append(exc)
                    return
            copies[0] += 1

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    try:
        mod = _module(card, monkeypatch, fused=True)
        _train(mod, card, _batches(4))
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not errors, errors
    assert copies[0] > 0 and mod.graph_stats()["captures"] == 1
