"""The port's LSTM-PTB workflow against the JAX package: the LSTM
language model's symbol, ``BucketingModule`` trained step for step
against the JAX ``BucketingModule`` across buckets, parameter and
optimizer sharing between buckets, ``force_rebind``, inference, ``fit``
with ``Perplexity`` and ``Speedometer``, the callbacks, and the
initializer's name patterns.

Inputs come from numpy seeds; parameters are copied out of the JAX
module (threefry draws cannot be reproduced), never seeded.

Tolerances (fp32): outputs rtol=atol=1e-5; parameters after the last
Adam step rtol=1e-4, atol=1e-5 (the two packages sum in other orders,
and Adam's early steps, lr * m / sqrt(v), amplify relative differences
of small gradients).
"""

import logging
from collections import namedtuple

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.callback import ProgressBar as JaxProgressBar
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.callback import ProgressBar, Speedometer

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-5)

V, E, H, L, BATCH = 50, 16, 24, 2, 4
BUCKETS = [4, 6, 8]


def make_sym_gen(lib, vocab, num_embed, num_hidden, num_layers):
    """The LSTM language model of ``examples/lstm_bucketing.py``, built
    from ``lib`` (``mxnet_tpu`` or ``mxnet_tpu_torch``)."""
    def sym_gen(seq_len):
        data = lib.sym.Variable("data")
        label = lib.sym.Variable("softmax_label")
        embed = lib.sym.Embedding(data, input_dim=vocab,
                                  output_dim=num_embed, name="embed")
        rnn = lib.sym.RNN(data=lib.sym.transpose(embed, axes=(1, 0, 2)),
                          parameters=lib.sym.Variable("rnn_parameters"),
                          state=lib.sym.Variable("rnn_state"),
                          state_cell=lib.sym.Variable("rnn_state_cell"),
                          state_size=num_hidden, num_layers=num_layers,
                          mode="lstm", name="rnn")
        out = lib.sym.Reshape(lib.sym.transpose(rnn, axes=(1, 0, 2)),
                              shape=(-1, num_hidden))
        pred = lib.sym.FullyConnected(out, num_hidden=vocab, name="pred")
        flat_label = lib.sym.Reshape(label, shape=(-1,))
        sm = lib.sym.SoftmaxOutput(pred, flat_label, ignore_label=0,
                                   use_ignore=True, name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


def bucket_arrays(seed, n_per_bucket, buckets=BUCKETS, batch=BATCH,
                  vocab=V):
    """(bucket, data, label) batches: Markov sentences (each token one of
    two successors of the last, one fixed transition table) of lengths
    that fall in their bucket, padded with 0 (ignored), label = data
    shifted left."""
    trans = np.random.RandomState(0).randint(1, vocab, size=(vocab, 2))
    rng = np.random.RandomState(seed)
    out = []
    for i, b in enumerate(buckets):
        lo = buckets[i - 1] + 1 if i else 2
        for _ in range(n_per_bucket):
            data = np.zeros((batch, b), np.float32)
            for r in range(batch):
                tok = rng.randint(1, vocab)
                for t in range(rng.randint(lo, b + 1)):
                    data[r, t] = tok
                    tok = trans[tok, rng.randint(0, 2)]
            label = np.concatenate([data[:, 1:],
                                    np.zeros((batch, 1), np.float32)], 1)
            out.append((b, data, label))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def as_batch(lib, b, data, label, batch=BATCH):
    kw = {"ctx": mt.cpu()} if lib is mt else {}
    return lib.io.DataBatch(
        [lib.nd.array(data, **kw)], [lib.nd.array(label, **kw)], pad=0,
        bucket_key=b,
        provide_data=[lib.io.DataDesc("data", (batch, b))],
        provide_label=[lib.io.DataDesc("softmax_label", (batch, b))])


class BucketBatches(mt.io.DataIter):
    """Replays a fixed list of bucketed batches each epoch."""

    def __init__(self, batches, batch=BATCH):
        super().__init__(batch)
        self._batches = batches
        self._cur = 0
        key = max(b for b, _, _ in batches)
        self.provide_data = [mt.io.DataDesc("data", (batch, key))]
        self.provide_label = [mt.io.DataDesc("softmax_label", (batch, key))]

    def reset(self):
        self._cur = 0

    def next(self):
        if self._cur >= len(self._batches):
            raise StopIteration
        self._cur += 1
        return as_batch(mt, *self._batches[self._cur - 1],
                        batch=self.batch_size)


def _shapes(key=max(BUCKETS)):
    return dict(data_shapes=[("data", (BATCH, key))],
                label_shapes=[("softmax_label", (BATCH, key))])


def port_module(arg_params=None):
    mod = mt.mod.BucketingModule(make_sym_gen(mt, V, E, H, L),
                                 default_bucket_key=max(BUCKETS),
                                 context=mt.cpu())
    mod.bind(**_shapes())
    if arg_params is None:
        mt.random.seed(7)
        zeros = mt.nd.zeros((L, BATCH, H), ctx=mt.cpu())
        arg_params = {"rnn_state": zeros, "rnn_state_cell": zeros.copy()}
    mod.init_params(mt.initializer.Uniform(0.08), arg_params=arg_params,
                    allow_missing=True)
    return mod


# ---------------------------------------------------------------------------
# (a) the symbol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("widths", [(V, E, H, L, BATCH, 6),
                                    (10000, 200, 200, 2, 32, 60)],
                         ids=["small", "published"])
def test_lstm_lm_symbol_matches_jax(widths):
    vocab, embed, hidden, layers, batch, seq = widths
    js, jd, jl = make_sym_gen(mx, vocab, embed, hidden, layers)(seq)
    ts, td, tl = make_sym_gen(mt, vocab, embed, hidden, layers)(seq)
    assert (td, tl) == (jd, jl)
    assert ts.list_arguments() == js.list_arguments() == [
        "data", "embed_weight", "rnn_parameters", "rnn_state",
        "rnn_state_cell", "pred_weight", "pred_bias", "softmax_label"]
    assert ts.list_outputs() == js.list_outputs()
    shapes = {"data": (batch, seq), "softmax_label": (batch, seq)}
    assert ts.infer_shape(**shapes) == tuple(
        [tuple(s) for s in x] for x in js.infer_shape(**shapes))


# ---------------------------------------------------------------------------
# (b) BucketingModule step for step against the JAX BucketingModule
# ---------------------------------------------------------------------------


def test_bucketing_module_steps_match_jax():
    jmod = mx.mod.BucketingModule(make_sym_gen(mx, V, E, H, L),
                                  default_bucket_key=max(BUCKETS),
                                  context=mx.cpu())
    jmod.bind(**_shapes())
    mx.random.seed(7)
    jz = mx.nd.zeros((L, BATCH, H))
    jmod.init_params(mx.initializer.Uniform(0.08),
                     arg_params={"rnn_state": jz, "rnn_state_cell": jz.copy()},
                     allow_missing=True)
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    # non-zero starting states exercise the state gradients
    rng = np.random.RandomState(3)
    for k in ("rnn_state", "rnn_state_cell"):
        host[k] = (rng.randn(L, BATCH, H) * 0.1).astype(np.float32)
    jmod.set_params({k: mx.nd.array(v) for k, v in host.items()}, {})
    params = {"learning_rate": 0.01}
    jmod.init_optimizer(kvstore=None, optimizer="adam",
                        optimizer_params=params)
    tmod = port_module(arg_params=host)
    tmod.init_optimizer(kvstore=None, optimizer="adam",
                        optimizer_params=params)

    batches = bucket_arrays(11, n_per_bucket=3)
    assert len(batches) >= 6 and len({b for b, _, _ in batches}) == 3
    for b, data, label in batches:
        for lib, mod in ((mx, jmod), (mt, tmod)):
            mod.forward(as_batch(lib, b, data, label), is_train=True)
            mod.backward()
            mod.update()
        out = tmod.get_outputs()[0].asnumpy()
        assert out.shape == (BATCH * b, V)
        np.testing.assert_allclose(out, jmod.get_outputs()[0].asnumpy(),
                                   err_msg=f"bucket {b}", **FWD)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **PARAMS)
        assert np.abs(tw[k] - host[k]).max() > 1e-3, k  # Adam moved it


def test_buckets_share_parameters_gradients_and_one_optimizer():
    mod = port_module()
    mod.init_optimizer(kvstore=None, optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    batches = bucket_arrays(5, n_per_bucket=2)
    for b, data, label in batches:
        mod.forward(as_batch(mt, b, data, label), is_train=True)
        mod.backward()
        mod.update()
    assert set(mod._buckets) == set(BUCKETS)
    default = mod._buckets[max(BUCKETS)]
    for key in BUCKETS:
        other = mod._buckets[key]
        for p in default._param_names:
            assert other._exec.arg_dict[p] is default._exec.arg_dict[p], p
            assert other._exec.grad_dict[p] is default._exec.grad_dict[p], p
        assert other._optimizer is default._optimizer
        assert other._updater is default._updater
        assert other._fused is default._fused  # one fused-step state
    # Adam's step count runs on across buckets: one count per batch
    opt = default._optimizer
    assert opt.num_update == len(batches)
    assert set(opt._index_update_count.values()) == {len(batches)}
    # the states live in the fused step's state (the Updater's, under
    # MXNET_FUSED_STEP=0), one a parameter, and its t ran on as well
    assert sorted(default._fused.states) == sorted(default._param_names)
    assert float(default._fused.t) == len(batches)


def test_borrow_optimizer_refuses_other_parameters():
    mod = port_module()
    mod.init_optimizer(optimizer="adam")
    other = mt.mod.Module(mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax"),
        context=mt.cpu())
    with pytest.raises(mt.MXNetError, match="differ"):
        other.borrow_optimizer(mod._curr_module)


def test_shared_bind_refuses_a_parameter_of_another_shape():
    mod = port_module()
    donor = mod._curr_module
    wider = mt.mod.Module(make_sym_gen(mt, V, E, H + 1, L)(4)[0],
                          context=mt.cpu())
    with pytest.raises(mt.MXNetError, match="does not match"):
        wider.bind(**_shapes(4), shared_module=donor)


def test_force_rebind_keeps_the_parameters():
    mod = port_module()
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    batches = bucket_arrays(6, n_per_bucket=1)
    for b, data, label in batches:
        mod.forward(as_batch(mt, b, data, label), is_train=True)
        mod.backward()
        mod.update()
    before = mt.params_to_numpy(mod.get_params()[0])
    mod.bind(**_shapes(), force_rebind=True)
    after = mt.params_to_numpy(mod.get_params()[0])
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert not mod.optimizer_initialized
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for b, data, label in batches:
        mod.forward(as_batch(mt, b, data, label), is_train=True)
        mod.backward()
        mod.update()
    moved = mt.params_to_numpy(mod.get_params()[0])
    assert not np.allclose(moved["pred_weight"], before["pred_weight"])


def test_inference_switches_output_shapes():
    mod = port_module()
    for b, data, label in bucket_arrays(2, n_per_bucket=1):
        mod.forward(as_batch(mt, b, data, label), is_train=False)
        out = mod.get_outputs()[0]
        assert out.shape == (BATCH * b, V)
        assert mod.output_shapes == [("softmax_output", (BATCH * b, V))]
        np.testing.assert_allclose(out.asnumpy().sum(-1), 1.0, rtol=1e-5)


def test_fit_lowers_perplexity_and_score_reads_held_out_data(caplog):
    mod = mt.mod.BucketingModule(make_sym_gen(mt, V, E, H, L),
                                 default_bucket_key=max(BUCKETS),
                                 context=mt.cpu(),
                                 logger=logging.getLogger("fit"))
    train = BucketBatches(bucket_arrays(8, n_per_bucket=4))
    metric = mt.metric.Perplexity(ignore_label=0)
    curve = []
    zeros = mt.nd.zeros((L, BATCH, H), ctx=mt.cpu())
    mt.random.seed(0)
    with caplog.at_level(logging.INFO):
        mod.fit(train, num_epoch=4, optimizer="adam",
                optimizer_params={"learning_rate": 0.01}, eval_metric=metric,
                initializer=mt.initializer.Uniform(0.08),
                arg_params={"rnn_state": zeros,
                            "rnn_state_cell": zeros.copy()},
                allow_missing=True,
                batch_end_callback=Speedometer(BATCH, 4, auto_reset=False),
                epoch_end_callback=lambda *a: curve.append(metric.get()[1]))
    assert np.all(np.isfinite(curve)) and curve[-1] < 0.7 * curve[0], curve
    assert any("samples/sec" in r.getMessage() for r in caplog.records)
    held_out = BucketBatches(bucket_arrays(9, n_per_bucket=1))
    (name, ppl), = mod.score(held_out, mt.metric.Perplexity(ignore_label=0))
    assert name == "Perplexity" and np.isfinite(ppl) and ppl < curve[0]


def test_default_context_and_unported_parts():
    sym_gen = make_sym_gen(mt, V, E, H, L)
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            mt.mod.BucketingModule(sym_gen, default_bucket_key=8)
    mod = port_module()
    # monitors are ported: fit(monitor=) taps every bucket's executor
    mon = mt.Monitor(1, pattern=".*pred.*")
    mod.fit(BucketBatches(bucket_arrays(1, 1)), num_epoch=1, monitor=mon)
    assert mon.exes and all(m._exec._monitor_callback is not None
                            for m in mod._buckets.values())
    with pytest.raises(mt.MXNetError, match="item 9.*not ported"):
        mod.fit(BucketBatches(bucket_arrays(1, 1)), num_epoch=1,
                elastic_data=object())


def test_perplexity_scored_where_preds_lie_matches_host_and_jax():
    """One NDArray pair is scored on its device (the label moved there);
    numpy pairs take the host path; both equal the JAX metric, and an
    all-ignored batch adds nothing."""
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 6, 7)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
             ).astype(np.float32).reshape(18, 7)
    labels = rng.randint(0, 7, size=(3, 6)).astype(np.float32)
    labels[0, :4] = 0  # ignored
    jm = mx.metric.Perplexity(ignore_label=0)
    jm.update([mx.nd.array(labels)], [mx.nd.array(probs)])
    dev, host = (mt.metric.Perplexity(ignore_label=0) for _ in range(2))
    dev.update([mt.nd.array(labels, ctx=mt.cpu())],
               [mt.nd.array(probs, ctx=mt.cpu())])
    assert dev._dev is not None  # the device path took it
    host.update([labels], [probs])
    assert host._dev is None
    for m in (dev, host):
        np.testing.assert_allclose(m.get()[1], jm.get()[1], **FWD)
    dev.update([mt.nd.zeros((3, 6), ctx=mt.cpu())],
               [mt.nd.array(probs, ctx=mt.cpu())])
    np.testing.assert_allclose(dev.get()[1], jm.get()[1], **FWD)
    assert dev.num_inst == host.num_inst == 14


def test_perplexity_device_path_takes_a_negative_label_as_jax_does():
    """Repair (ROADMAP queue C, C5): the device path gathered at the raw
    label, so ``ignore_label=-1`` raised "index -1 is out of bounds" (a
    device-side assert on the card); JAX gathers at the label wrapped
    and clamped into range, then masks the ignored rows."""
    p = np.random.RandomState(0).rand(6, 5).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    for labels, ignore in (([1, -1, 3, 0, -1, 2], -1),
                           ([1, -1, 7, -9, 0, 2], None)):
        lab = np.array(labels, np.float32)
        jm = mx.metric.Perplexity(ignore_label=ignore)
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        tm = mt.metric.Perplexity(ignore_label=ignore)
        tm.update([mt.nd.array(lab, ctx=mt.cpu())],
                  [mt.nd.array(p, ctx=mt.cpu())])
        assert tm._dev is not None  # the device path took it
        name, value = tm.get()
        assert name == jm.get()[0]
        np.testing.assert_allclose(value, jm.get()[1], **FWD)


# ---------------------------------------------------------------------------
# (c) the callbacks, as tests/test_callback.py pins the JAX ones
# ---------------------------------------------------------------------------

Param = namedtuple("Param", ["epoch", "nbatch", "eval_metric"])


class _FakeMetric:
    def __init__(self):
        self.resets = 0

    def get_name_value(self):
        return [("acc", 0.5), ("ce", 1.25)]

    def reset(self):
        self.resets += 1


def test_speedometer_report_cadence(caplog):
    m = _FakeMetric()
    s = Speedometer(batch_size=4, frequent=2, auto_reset=True)
    with caplog.at_level(logging.INFO):
        for nb in range(1, 7):
            s(Param(epoch=0, nbatch=nb, eval_metric=m))
    msgs = [r.getMessage() for r in caplog.records
            if "Speed:" in r.getMessage()]
    assert len(msgs) == 6, msgs  # reports at 2, 4, 6, one line a metric
    assert all("Epoch[0]" in m_ for m_ in msgs)
    assert any("Train-acc=0.5" in m_ for m_ in msgs)
    assert float(msgs[0].split("Speed: ")[1].split(" ")[0]) > 0
    assert m.resets == 3


def test_speedometer_no_autoreset_and_epoch_rewind(caplog):
    m = _FakeMetric()
    s = Speedometer(batch_size=4, frequent=2, auto_reset=False)
    with caplog.at_level(logging.INFO):
        for nb in (1, 2, 3, 4):
            s(Param(epoch=0, nbatch=nb, eval_metric=m))
        n_epoch0 = len(caplog.records)
        s(Param(epoch=1, nbatch=2, eval_metric=m))  # rewind: opens only
        assert len(caplog.records) == n_epoch0
        s(Param(epoch=1, nbatch=4, eval_metric=m))
        assert len(caplog.records) == n_epoch0 + 2
    assert m.resets == 0


def test_speedometer_no_metric(caplog):
    s = Speedometer(batch_size=8, frequent=1)
    with caplog.at_level(logging.INFO):
        s(Param(epoch=2, nbatch=1, eval_metric=None))
        s(Param(epoch=2, nbatch=2, eval_metric=None))
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "Epoch[2]" in msgs[0] and "Speed:" in msgs[0]


@pytest.mark.parametrize("total,length,steps", [(4, 8, (2, 3, 4)),
                                                (3, 6, (1,))])
def test_progress_bar_frames_match_jax(capsys, total, length, steps):
    for nb in steps:
        JaxProgressBar(total, length)(Param(0, nb, None))
        want = capsys.readouterr().out
        ProgressBar(total, length)(Param(0, nb, None))
        assert capsys.readouterr().out == want


def test_log_train_metric(caplog):
    m = _FakeMetric()
    cb = mt.callback.log_train_metric(2, auto_reset=True)
    with caplog.at_level(logging.INFO):
        for nb in (1, 2, 3, 4):
            cb(Param(epoch=1, nbatch=nb, eval_metric=m))
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == "Iter[1] Batch[2] Train-acc=0.500000"
    assert len(msgs) == 4 and m.resets == 2


# ---------------------------------------------------------------------------
# (d) the initializer's name patterns (the repair of this slice)
# ---------------------------------------------------------------------------

INIT_NAMES = ["rnn_parameters", "bn_moving_mean", "bn_moving_var",
              "bn_running_mean", "bn_running_var", "bn_moving_inv_var",
              "bn_moving_avg", "fc_bias", "fc_weight", "ln_gamma", "ln_beta"]


def _init_pair(kind, kwargs):
    return getattr(mx.initializer, kind)(**kwargs), \
        getattr(mt.initializer, kind)(**kwargs)


@pytest.mark.parametrize("kind,kwargs", [("Uniform", {"scale": 0.5}),
                                         ("Xavier", {}), ("Zero", {})])
@pytest.mark.parametrize("name", INIT_NAMES)
def test_initializer_patterns_match_jax(kind, kwargs, name):
    jinit, tinit = _init_pair(kind, kwargs)
    shape = (6, 4)
    ja = mx.nd.zeros(shape) + 7.0
    ta = mt.nd.array(np.full(shape, 7.0, np.float32), ctx=mt.cpu())
    jinit(name, ja)
    tinit(name, ta)
    jv, tv = ja.asnumpy(), ta.asnumpy()
    if np.all(jv == jv.flat[0]):  # a constant pattern: the same constant
        np.testing.assert_array_equal(tv, jv)
    else:  # a draw: the same law's bound, not the same bits
        bound = 0.5 if kind == "Uniform" else np.sqrt(3.0 / 5.0)
        assert np.abs(tv).max() <= bound and np.abs(jv).max() <= bound
        assert len(np.unique(tv)) > 1


def test_initializer_raises_as_jax_does():
    for kind, kwargs in (("Uniform", {}), ("Zero", {})):
        jinit, tinit = _init_pair(kind, kwargs)
        with pytest.raises(mx.MXNetError, match="Unknown initialization"):
            jinit("rnn_state", mx.nd.zeros((2, 3)))
        with pytest.raises(mt.MXNetError, match="Unknown initialization"):
            tinit("rnn_state", mt.nd.zeros((2, 3), ctx=mt.cpu()))
    # Xavier sizes itself from two fans: a 1-D packed vector has one, in
    # both packages
    jinit, tinit = _init_pair("Xavier", {})
    with pytest.raises(IndexError):
        jinit("rnn_parameters", mx.nd.zeros((12,)))
    with pytest.raises(IndexError):
        tinit("rnn_parameters", mt.nd.zeros((12,), ctx=mt.cpu()))


def test_module_allow_missing_without_an_initializer_raises():
    mod = mt.mod.Module(make_sym_gen(mt, V, E, H, L)(4)[0], context=mt.cpu())
    mod.bind(**_shapes(4))
    with pytest.raises(mt.MXNetError, match="cannot init parameter"):
        mod.init_params(initializer=None, arg_params={}, allow_missing=True)
