"""The port's ``InferenceEngine`` against the JAX package's on the CPU
(``tests/test_serving.py``'s engine cases; its profiler-metrics case is
queue A item 8's).

Both engines serve one small MLP over the same weights (seeded numpy,
Xavier-like): where outputs are compared, the port's rows are held
against the JAX engine's and against the per-request batch-1 forward of
the JAX Predictor at rtol = atol = 2e-6 (float32 programs at other batch
sizes sum in other orders).  On the CPU each bucket runs its executable
uncaptured, so these cover the batcher, the completer, the padding,
the flush policy and the cost model the card's CUDA graphs share
(``chip_smoke.py --infer`` holds the graphed buckets against
``_graphs=False`` on the card).
Every wait has its own timeout, so a hang fails one test.
"""

import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

TOL = dict(rtol=2e-6, atol=2e-6)
WAIT = 60


def _params(seed=0):
    rng = np.random.RandomState(seed)
    p = {"fc1_weight": rng.randn(16, 6) * np.sqrt(2.0 / 22),
         "fc1_bias": np.zeros(16),
         "fc2_weight": rng.randn(4, 16) * np.sqrt(2.0 / 20),
         "fc2_bias": rng.randn(4) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _net(pkg, with_label=False):
    net = pkg.sym.FullyConnected(
        pkg.sym.Activation(
            pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=16,
                                   name="fc1"), act_type="relu"),
        num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax") if with_label else net


def _predictors(batch=1, with_label=False, seed=0):
    """(port Predictor on the CPU, JAX Predictor) over the same weights."""
    shapes = {"data": (batch, 6)}
    if with_label:
        shapes["softmax_label"] = (batch,)
    params = _params(seed)
    return (mt.Predictor(_net(mt, with_label), params, shapes, ctx=mt.cpu()),
            mx.Predictor(_net(mx, with_label), params, shapes))


def _per_request_ref(jpred_b1, X, label=None):
    """Each sample alone through the JAX Predictor's batch-1 forward."""
    outs = []
    for i in range(len(X)):
        kwargs = {"data": X[i:i + 1]}
        if label is not None:
            kwargs["softmax_label"] = label[i:i + 1]
        jpred_b1.forward(**kwargs)
        outs.append(jpred_b1.get_output(0))
    return np.concatenate(outs, axis=0)


def test_bucket_cache_compiles_each_bucket_at_most_once():
    pred, jpred = _predictors()
    rng = np.random.RandomState(1)
    reqs = [rng.randn(1, 6).astype(np.float32) for _ in range(6)] \
        + [rng.randn(3, 6).astype(np.float32) for _ in range(6)]
    st = {}
    for name, p, pkg in (("port", pred, mt), ("jax", jpred, mx)):
        with pkg.InferenceEngine(p, buckets=(1, 4, 8),
                                 batch_timeout_ms=1.0) as eng:
            outs = [eng.infer(x)[0] for x in reqs]
            st[name] = (eng.stats(), outs)
    (tst, touts), (jst, jouts) = st["port"], st["jax"]
    assert tst["compiles"] == jst["compiles"] == {1: 1, 4: 1}
    assert tst["cache_hits"] >= 10 and tst["cache_misses"] == 2
    assert not tst["graphs"]["graphs_on"]
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, **TOL)


def test_prewarm_compiles_everything_up_front():
    pred, _ = _predictors()
    eng = mt.InferenceEngine(pred, buckets=(1, 4), prewarm=True)
    try:
        assert eng.stats()["compiles"] == {1: 1, 4: 1}
        eng.submit(np.zeros((1, 6), np.float32)).result(timeout=WAIT)
        assert eng.stats()["compiles"] == {1: 1, 4: 1}
        assert set(eng._bucket_ms) == {1, 4}  # warm-up seeded the model
    finally:
        eng.close(timeout=WAIT)


def test_padding_rows_do_not_leak_into_real_outputs():
    """A 3-sample request pads to bucket 4: the real rows equal, bit for
    bit, the bucket's executable run with zero padding and with garbage
    padding (rows are independent within one executable), and the
    per-request batch-1 JAX forward within ``TOL``."""
    pred, jpred = _predictors()
    X = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    with mt.InferenceEngine(pred, buckets=(4,),
                            batch_timeout_ms=1.0) as eng:
        (out,) = eng.submit(X).result(timeout=WAIT)
        assert out.shape == (3, 4)
        exe = eng._bucket_exe(4)
        rows = []
        for pad in (0.0, 1e6):
            buf = np.full((4, 6), pad, np.float32)
            buf[:3] = X
            exe.feed(data=buf)
            rows.append(exe.run()[0][:3].numpy().copy())
    np.testing.assert_array_equal(out, rows[0])
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_allclose(out, _per_request_ref(jpred, X), **TOL)


def test_same_bucket_resubmission_is_deterministic():
    pred, _ = _predictors()
    X = np.random.RandomState(6).randn(3, 6).astype(np.float32)
    with mt.InferenceEngine(pred, buckets=(4,),
                            batch_timeout_ms=1.0) as eng:
        (a,) = eng.submit(X).result(timeout=WAIT)
        (b,) = eng.submit(X).result(timeout=WAIT)
    np.testing.assert_array_equal(a, b)


def test_full_batch_flush_vs_timeout_flush():
    pred, _ = _predictors()
    X = np.zeros((1, 6), np.float32)
    with mt.InferenceEngine(pred, buckets=(4,), max_batch=4,
                            batch_timeout_ms=10_000,
                            idle_timeout_ms=10_000, prewarm=True) as eng:
        futs = [eng.submit(X) for _ in range(4)]
        for f in futs:
            f.result(timeout=WAIT)
        st = eng.stats()
        assert st["flush_full"] == 1 and st["flush_timeout"] == 0, st
        assert st["batches"] == 1
    with mt.InferenceEngine(pred, buckets=(4,), max_batch=4,
                            batch_timeout_ms=20, idle_timeout_ms=20,
                            prewarm=True) as eng:
        t0 = time.perf_counter()
        eng.submit(X).result(timeout=WAIT)
        waited = time.perf_counter() - t0
        st = eng.stats()
    assert st["flush_timeout"] == 1 and st["flush_full"] == 0, st
    assert waited >= 0.02


def test_short_timeout_flushes_partial_batch():
    pred, _ = _predictors()
    with mt.InferenceEngine(pred, buckets=(8,), batch_timeout_ms=5,
                            prewarm=True) as eng:
        (out,) = eng.submit(np.zeros((2, 6), np.float32)).result(
            timeout=WAIT)
        assert out.shape == (2, 4)
        st = eng.stats()
    assert st["flush_timeout"] == 1
    assert st["batch_fill_ratio"] == pytest.approx(2 / 8)


def test_concurrent_clients_match_jax():
    """8 client threads x 12 single-sample requests, closed loop: every
    row equals the per-request batch-1 JAX forward within ``TOL``
    whatever batch it rode in; the engine batched; each bucket built
    once."""
    pred, jpred = _predictors()
    N, M = 8, 12
    X = np.random.RandomState(3).randn(N, M, 6).astype(np.float32)
    results = {}
    with mt.InferenceEngine(pred, buckets=(1, 4, 8, 16),
                            batch_timeout_ms=2.0,
                            idle_timeout_ms=2.0) as eng:
        def client(c):
            results[c] = np.concatenate(
                [eng.submit(X[c, i:i + 1]).result(timeout=WAIT)[0]
                 for i in range(M)], axis=0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * WAIT)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
    assert st["images"] == N * M
    for c in range(N):
        np.testing.assert_allclose(results[c], _per_request_ref(jpred, X[c]),
                                   **TOL)
    assert st["batches"] < N * M
    assert all(v == 1 for v in st["compiles"].values()), st["compiles"]
    assert st["p99_ms"] >= st["p50_ms"] > 0


def test_multi_input_requests_and_label_input():
    pred, jpred = _predictors(with_label=True)
    X = np.random.RandomState(4).randn(2, 6).astype(np.float32)
    lab = np.zeros((2,), np.float32)
    with mt.InferenceEngine(pred, buckets=(4,),
                            batch_timeout_ms=1.0) as eng:
        (out,) = eng.submit({"data": X, "softmax_label": lab}).result(
            timeout=WAIT)
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out, _per_request_ref(jpred, X, label=lab),
                               **TOL)


def test_submit_validation_errors():
    pred, _ = _predictors()
    eng = mt.InferenceEngine(pred, buckets=(1, 4))
    try:
        with pytest.raises(mt.MXNetError, match="shape"):
            eng.submit(np.zeros((1, 7), np.float32))
        with pytest.raises(mt.MXNetError, match="max_batch"):
            eng.submit(np.zeros((5, 6), np.float32))
        with pytest.raises(mt.MXNetError, match="empty"):
            eng.submit(np.zeros((0, 6), np.float32))
        with pytest.raises(mt.MXNetError, match="bucket"):
            mt.InferenceEngine(pred, buckets=(4,), max_batch=8)
        with pytest.raises(mt.MXNetError, match="item 8"):
            eng.submit(np.zeros((1, 6), np.float32), trace=object())
        with pytest.raises(mt.MXNetError, match="Predictor"):
            mt.InferenceEngine(object())
    finally:
        eng.close(timeout=WAIT)
    with pytest.raises(mt.MXNetError, match="closed"):
        eng.submit(np.zeros((1, 6), np.float32))


def test_bare_sample_auto_batches():
    pred, _ = _predictors()
    with mt.InferenceEngine(pred, buckets=(1,),
                            batch_timeout_ms=1.0) as eng:
        (out,) = eng.submit(np.zeros((6,), np.float32)).result(timeout=WAIT)
    assert out.shape == (1, 4)


def test_serving_exported_artifact(tmp_path):
    """``from_exported``: the artifact's one batch size is the only
    bucket; outputs as the JAX engine serving the JAX artifact."""
    pred, jpred = _predictors()
    params = _params()
    X = np.random.RandomState(5).randn(2, 6).astype(np.float32)
    path, jpath = str(tmp_path / "m.mxtorch"), str(tmp_path / "m.mxtpu")
    mt.predictor.export_model(_net(mt), params, {}, {"data": (4, 6)},
                              path=path)
    mx.predictor.export_model(_net(mx), params, {}, {"data": (4, 6)},
                              path=jpath)
    with mt.InferenceEngine.from_exported(path, ctx=mt.cpu(),
                                          batch_timeout_ms=1.0) as eng:
        assert eng.stats()["buckets"] == [4]
        (out,) = eng.submit(X).result(timeout=WAIT)
        with pytest.raises(mt.MXNetError, match="embeds its weights"):
            eng.swap_params(params)
    with mx.InferenceEngine.from_exported(jpath,
                                          batch_timeout_ms=1.0) as jeng:
        (jout,) = jeng.infer(X)
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, _per_request_ref(jpred, X), rtol=1e-5,
                               atol=1e-6)


def test_batch_reducing_output_fails_loudly():
    net = mt.sym.sum(mt.sym.FullyConnected(mt.sym.Variable("data"),
                                           num_hidden=4, name="fc"))
    rng = np.random.RandomState(7)
    pred = mt.Predictor(net, {"fc_weight": rng.randn(4, 6).astype(
        np.float32), "fc_bias": np.zeros(4, np.float32)}, {"data": (1, 6)},
        ctx=mt.cpu())
    with mt.InferenceEngine(pred, buckets=(4,),
                            batch_timeout_ms=1.0) as eng:
        fut = eng.submit(np.ones((1, 6), np.float32))
        with pytest.raises(mt.MXNetError, match="batch axis"):
            fut.result(timeout=WAIT)


def test_boundary_flush_cost_model():
    """Grow across a bucket boundary only when the measured rate of the
    bigger bucket wins; explore when it was never measured (the JAX
    engine's rule, on the same numbers)."""
    pred, jpred = _predictors()
    engines = [mt.InferenceEngine(pred, buckets=(8, 32)),
               mx.InferenceEngine(jpred, buckets=(8, 32))]
    try:
        for ms, total, add, want in (({8: 50.0, 32: 190.0}, 8, 1, True),
                                     ({8: 50.0, 32: 55.0}, 8, 1, False),
                                     ({8: 50.0}, 8, 1, False),
                                     ({8: 50.0, 32: 190.0}, 4, 1, False)):
            for eng in engines:
                eng._bucket_ms = dict(ms)
                assert eng._boundary_flush(total, add) == want
    finally:
        for eng in engines:
            eng.close(timeout=WAIT)


def test_boundary_flush_reason_counted():
    pred, _ = _predictors()
    with mt.InferenceEngine(pred, buckets=(2, 32), max_batch=32,
                            batch_timeout_ms=10_000, idle_timeout_ms=500,
                            prewarm=True) as eng:
        eng._bucket_ms = {2: 1.0, 32: 1e6}  # never worth growing
        f1 = eng.submit(np.zeros((2, 6), np.float32))
        f2 = eng.submit(np.zeros((1, 6), np.float32))
        f1.result(timeout=WAIT)
        assert eng.stats()["flush_boundary"] >= 1
        f2.result(timeout=WAIT)


def test_inflight_snapshot_drain_and_resume():
    pred, _ = _predictors()
    # a window long enough that a loaded host cannot flush the three
    # requests before the count is read
    eng = mt.InferenceEngine(pred, buckets=(1, 8), batch_timeout_ms=1000.0,
                             idle_timeout_ms=1000.0)
    try:
        assert eng.inflight() == 0
        futs = [eng.submit(np.zeros((1, 6), np.float32)) for _ in range(3)]
        assert eng.inflight() == 3
        assert eng.drain(timeout=WAIT) == 0 and eng.inflight() == 0
        for f in futs:
            assert f.result(timeout=1)[0].shape == (1, 4)
        with pytest.raises(mt.MXNetError, match="draining"):
            eng.submit(np.zeros((1, 6), np.float32))
        eng.resume()
        out = eng.submit(np.zeros((1, 6), np.float32)).result(timeout=WAIT)
        assert out[0].shape == (1, 4)
    finally:
        eng.close(timeout=WAIT)


def test_loop_death_poisoned_count_matches_inflight():
    """What ``inflight()`` reported before the batch loop died is exactly
    how many futures are poisoned, and the count empties after."""
    pred, _ = _predictors()
    # the sabotage must land inside the coalesce window, on a loaded host
    # too
    eng = mt.InferenceEngine(pred, buckets=(8,), batch_timeout_ms=5000.0,
                             idle_timeout_ms=5000.0)
    try:
        futs = [eng.submit(np.zeros((1, 6), np.float32)) for _ in range(3)]
        n_before = eng.inflight()
        assert n_before == 3
        eng._timeout_s = eng._idle_timeout_s = None  # sabotage the loop
        fut4 = eng.submit(np.zeros((1, 6), np.float32))
        for f in futs + [fut4]:
            with pytest.raises(mt.EngineClosedError, match="died"):
                f.result(timeout=WAIT)
        assert eng.inflight() == 0
    finally:
        eng._queue.put(None)
        eng.close(timeout=5)


def test_swap_params_guard_and_new_weights_served():
    """A swap with a request in flight refuses; after a drain the new
    weights are copied into the served tensors (no bucket is rebuilt)
    and served, as the JAX Predictor over them computes."""
    pred, _ = _predictors()
    eng = mt.InferenceEngine(pred, buckets=(1, 4), batch_timeout_ms=1000.0,
                             idle_timeout_ms=1000.0)
    try:
        eng.warmup()
        x = np.random.RandomState(5).rand(1, 6).astype(np.float32)
        base = eng.submit({"data": x}).result(timeout=WAIT)[0]
        new = {k: v * 2.0 for k, v in _params().items()}
        fut = eng.submit({"data": x})  # held by the 1 s window
        with pytest.raises(mt.MXNetError, match="in flight"):
            eng.swap_params(new)
        assert eng.drain(timeout=WAIT) == 0
        fut.result(timeout=1)
        before = dict(eng.compiles)
        with pytest.raises(mt.MXNetError, match="missing parameter"):
            eng.swap_params({"fc1_weight": new["fc1_weight"]})
        eng.swap_params(new)
        eng.warmup()
        eng.resume()
        out = eng.submit({"data": x}).result(timeout=WAIT)[0]
        assert dict(eng.compiles) == before
        assert not np.allclose(out, base)
        ref = mx.Predictor(_net(mx), new, {"data": (1, 6)})
        np.testing.assert_allclose(out, ref.forward(data=x).get_output(0),
                                   rtol=1e-5, atol=1e-6)
        snap = eng.get_params()
        assert all(np.array_equal(snap[k], new[k]) for k in new)
    finally:
        eng.close(timeout=WAIT)
