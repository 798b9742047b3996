"""The port's ``CheckpointManager`` and ``fit(checkpoint=, resume=)`` on
the CPU, mirroring ``tests/test_checkpoint.py``: the commit protocol,
``keep``, the fallback past a corrupt checkpoint, torn and unmarked
directories, a resume mid-epoch from other seeds that bit-matches the
uninterrupted run (an MLP over a shuffling ``NDArrayIter``, an LM with
dropout, whose fused step's random streams resume, and an LSTM
``BucketingModule`` with Adam), the writer killed mid-shard and SIGTERM
(in subprocesses, ``tests/torch_ckpt_crash_worker.py``), the
``MXNET_CKPT_*`` variables, and resumes across packages: the JAX
manager's checkpoint resumed by the port's ``fit`` and the port's by the
JAX ``fit``.

Tolerances: the port's resumes are bit for bit; a resume across
packages is held to the other package's uninterrupted run at ``GRAD``
(rtol = atol = 5e-5, updated weights in ``tests/test_torch_module.py``)
after 18 SGD steps of the MLP.
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as JC
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import ckpt_crash_worker as JW  # noqa: E402
import torch_ckpt_crash_worker as W  # noqa: E402
from test_torch_bucketing import (BucketBatches, bucket_arrays,  # noqa: E402
                                  make_sym_gen)
from test_torch_checkpoint import assert_host_tree  # noqa: E402

torch.set_num_threads(1)

GRAD = dict(rtol=5e-5, atol=5e-5)


class Stop(Exception):
    pass


def _subproc_env():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("MXNET_CKPT_CRASH", None)
    return env


def _committed(d):
    return [i for i in C.list_checkpoints(d) if i.committed]


# ---------------------------------------------------------------------------
# the commit protocol, keep, fallback, torn directories
# ---------------------------------------------------------------------------

def test_manager_roundtrip_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    params = W.train(ckpt_dir=d, num_epoch=2, every_n=3)
    infos = _committed(d)
    # 24 steps, a save every 3; keep=10 in the worker
    assert [i.step for i in infos] == [3, 6, 9, 12, 15, 18, 21, 24]
    assert C.verify_checkpoint(infos[-1].path) == []
    state = C.load_shard(infos[-1].path, 0)
    assert state["step"] == 24 and state["epoch"] == 1
    assert state["nbatch"] == 11  # 12 batches an epoch
    for k, v in state["arg_params"].items():
        np.testing.assert_array_equal(v, params[k])
    assert state["optimizer"]["kind"] == "fused"
    assert "fc1_weight" in state["optimizer"]["states"]
    assert state["iter_state"]["kind"] == "NDArrayIter"
    assert state["rng"] is None and state["torch_rng"]["chain"] is not None
    for info in infos:
        with open(os.path.join(info.path, "shard-00000.bin"), "rb") as f:
            assert_host_tree(pickle.loads(f.read()), info.path)


def test_manager_keep_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = mt.CheckpointManager(d, keep=2, async_save=False)

    class FakeModule:
        optimizer_initialized = False

        def get_params(self):
            return {"w": mt.nd.ones((2, 2), ctx=mt.cpu())}, {}

    for s in range(1, 6):
        mgr.save(module=FakeModule(), epoch=0, nbatch=s, step=s)
    assert [i.step for i in _committed(d)] == [4, 5]
    assert mgr.last_bytes > 0 and mgr.last_save_ms > 0


def test_restore_falls_back_on_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    W.train(ckpt_dir=d, num_epoch=1, every_n=6)  # commits steps 6, 12
    infos = _committed(d)
    assert [i.step for i in infos] == [6, 12]
    shard = os.path.join(infos[-1].path, "shard-00000.bin")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # a bit flip in the newest shard
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    assert C.verify_checkpoint(infos[-1].path) != []
    state = mt.CheckpointManager(d).load_latest()
    assert state is not None and state["step"] == 6


def test_restore_ignores_torn_tmp(tmp_path):
    d = str(tmp_path / "ckpt")
    W.train(ckpt_dir=d, num_epoch=1, every_n=12)  # commits step 12
    torn = os.path.join(d, "ckpt-000000000099.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "shard-00000.bin"), "wb") as f:
        f.write(b"half a shard")
    state = mt.CheckpointManager(d).load_latest()
    assert state["step"] == 12
    assert not os.path.isdir(torn)  # retired by the restore


def test_uncommitted_dir_without_marker_is_not_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    W.train(ckpt_dir=d, num_epoch=1, every_n=12)
    good = _committed(d)[0]
    os.makedirs(os.path.join(d, "ckpt-000000000050"))  # no COMMIT
    assert mt.CheckpointManager(d).load_latest()["step"] == good.step


# ---------------------------------------------------------------------------
# fit(resume='auto'): bit for bit, mid-epoch, from other seeds
# ---------------------------------------------------------------------------

LM = dict(vocab=61, seq_len=16, batch=4, steps=6)


def _mlp():
    X, y = W.make_data()
    it = mt.io.NDArrayIter(X, y, batch_size=W.BATCH, shuffle=True)
    mod = mt.mod.Module(W.build_sym(), context=mt.cpu())
    return mod, it, dict(
        optimizer="sgd", eval_metric="acc",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        initializer=mt.initializer.Xavier(rnd_type="gaussian"))


def _dropout_lm():
    rng = np.random.RandomState(7)
    n = LM["batch"] * LM["steps"] * LM["seq_len"]
    walk = np.cumsum(rng.randint(-2, 3, size=n + 1))
    toks = (np.abs(walk) % (LM["vocab"] - 1) + 1).astype(np.float32)
    X = toks[:-1].reshape(-1, LM["seq_len"])
    y = toks[1:].reshape(-1, LM["seq_len"])
    it = mt.io.NDArrayIter(X, y, batch_size=LM["batch"])
    sym = mt.models.transformer_lm(LM["vocab"], LM["seq_len"], num_layers=2,
                                   num_heads=2, d_model=32, head="ce",
                                   dropout=0.1)
    mod = mt.mod.Module(sym, context=mt.cpu())
    return mod, it, dict(
        optimizer="sgd", eval_metric="loss",
        optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
        initializer=mt.initializer.Xavier())


class StatefulBuckets(BucketBatches):
    """``BucketBatches`` with a position a checkpoint can keep."""

    def state_dict(self):
        return {"kind": "StatefulBuckets", "cur": self._cur}

    def set_state(self, state, rewind=False):
        self._cur = 0 if rewind else int(state["cur"])


def _lstm_buckets():
    it = StatefulBuckets(bucket_arrays(3, 2))  # 6 batches an epoch
    mod = mt.mod.BucketingModule(make_sym_gen(mt, 50, 16, 24, 2),
                                 default_bucket_key=8, context=mt.cpu())
    zeros = mt.nd.zeros((2, 4, 24), ctx=mt.cpu())
    return mod, it, dict(
        optimizer="adam", optimizer_params={"learning_rate": 0.01},
        eval_metric=mt.metric.Perplexity(ignore_label=0),
        initializer=mt.initializer.Uniform(0.08), allow_missing=True,
        arg_params={"rnn_state": zeros, "rnn_state_cell": zeros.copy()})


# case: (make, save every, stop after (epoch 0) batch, steps an epoch)
CASES = {"mlp": (_mlp, 6, 7, 12), "dropout_lm": (_dropout_lm, 4, 5, 6),
         "lstm_buckets": (_lstm_buckets, 2, 4, 6)}


def _fit(case, ckpt_dir, seed, stop=None, masks=None):
    make, every, _, _ = CASES[case]
    mt.random.seed(seed)
    np.random.seed(seed)
    mod, it, kw = make()
    mgr = None if ckpt_dir is None else mt.CheckpointManager(
        ckpt_dir, every_n_steps=every, async_save=True, keep=10)

    def cb(param):
        if stop is not None and (param.epoch, param.nbatch) == (0, stop):
            raise Stop()

    try:
        mod.fit(it, num_epoch=2, checkpoint=mgr,
                resume="auto" if mgr is not None else None,
                batch_end_callback=cb, **kw)
    finally:
        if mgr is not None:
            mgr.close()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_resume_auto_bitexact_mid_epoch(case, tmp_path, monkeypatch):
    """Interrupted after batch ``stop`` of epoch 0 (a checkpoint every
    ``every`` steps), then resumed by a fresh module under other seeds:
    parameters, optimizer state, the random streams, the iterator's
    position and the batch count come from the checkpoint, and the
    final weights equal the uninterrupted run's bit for bit.  The LM's
    dropout masks of every step after the checkpoint are the
    uninterrupted run's."""
    _, every, stop, _ = CASES[case]
    masks = {"ref": [], "resumed": []}
    draw = mt.ops.nn.draw_mask
    run = ["ref"]

    def recording(*args):
        mask = draw(*args)
        masks[run[0]].append(mask.clone())
        return mask

    monkeypatch.setattr(mt.ops.nn, "draw_mask", recording)
    ref = _fit(case, None, seed=11)
    d = str(tmp_path / "ckpt")
    run[0] = "interrupted"
    masks["interrupted"] = []
    with pytest.raises(Stop):
        _fit(case, d, seed=11, stop=stop)
    saved = [i.step for i in _committed(d)]
    assert saved == list(range(every, stop + 2, every)), saved
    run[0] = "resumed"
    resumed = _fit(case, d, seed=555)
    for k in ref:
        np.testing.assert_array_equal(
            ref[k], resumed[k],
            err_msg=f"{k}: the resumed weights part from the uninterrupted "
                    f"run's")
    if case == "dropout_lm":
        per_step = len(masks["ref"]) // (2 * CASES[case][3])
        assert per_step == 4  # two Dropout nodes a layer, two layers
        tail = masks["ref"][saved[-1] * per_step:]
        assert len(tail) == len(masks["resumed"]) > 0
        assert all(torch.equal(a, b) for a, b in zip(tail,
                                                     masks["resumed"]))


def test_fit_resume_requires_manager_and_a_valid_value(tmp_path):
    X, y = W.make_data()
    it = mt.io.NDArrayIter(X, y, batch_size=W.BATCH)
    mod = mt.mod.Module(W.build_sym(), context=mt.cpu())
    with pytest.raises(mt.MXNetError, match="resume"):
        mod.fit(it, num_epoch=1, resume="auto")
    with pytest.raises(mt.MXNetError, match="resume must be"):
        mod.fit(it, num_epoch=1, resume="sometimes",
                checkpoint=mt.CheckpointManager(str(tmp_path / "c")))


def test_ckpt_dir_env_makes_a_manager(tmp_path, monkeypatch):
    d = str(tmp_path / "env")
    monkeypatch.setenv("MXNET_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_CKPT_EVERY_N_STEPS", "12")
    mt.random.seed(1)
    mod, it, kw = _mlp()
    mod.fit(it, num_epoch=1, **kw)
    assert [i.step for i in _committed(d)] == [12]


def test_multi_rank_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(mt.MXNetError, match="item 9"):
        mt.CheckpointManager(str(tmp_path / "c"), rank=1, num_shards=2)
    monkeypatch.setenv("MXNET_NUM_WORKERS", "4")
    with pytest.raises(mt.MXNetError, match="item 9"):
        mt.CheckpointManager(str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# fault injection: the writer killed mid-shard; SIGTERM
# ---------------------------------------------------------------------------

def test_kill_background_writer_mid_shard_then_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    env = _subproc_env()
    env["MXNET_CKPT_CRASH"] = "mid_shard:2"  # the 2nd save (step 12) tears
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_ckpt_crash_worker.py"),
         "--ckpt-dir", d, "--epochs", "2", "--every-n", "6"],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert r.returncode == 9, r.stdout + r.stderr
    infos = C.list_checkpoints(d)
    assert [i.step for i in infos if i.committed] == [6]
    assert [i.step for i in infos if not i.committed] == [12]
    assert C.verify_checkpoint(_committed(d)[0].path) == []
    mt.random.seed(321)
    np.random.seed(321)
    resumed = W.train(ckpt_dir=d, num_epoch=2, every_n=6)
    ref = W.train(ckpt_dir=None, num_epoch=2)
    for k in ref:
        np.testing.assert_array_equal(ref[k], resumed[k])


def test_sigterm_triggers_emergency_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_ckpt_crash_worker.py"),
         "--ckpt-dir", d, "--epochs", "50", "--every-n", "0",
         "--sleep", "0.05", "--progress"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=_subproc_env())
    out_lines = []
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            out_lines.append(line)
            if "BATCH 3" in line:
                break
        assert any("BATCH 3" in ln for ln in out_lines), "".join(out_lines)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
        out_lines.append(out or "")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = "".join(out_lines)
    assert p.returncode == -signal.SIGTERM, out
    infos = _committed(d)
    assert len(infos) == 1, out
    state = C.load_shard(infos[0].path, 0)
    assert state["reason"] == "preempt" and state["step"] > 0


# ---------------------------------------------------------------------------
# the MXNET_CKPT_* variables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("var,bad,msg", [
    ("MXNET_CKPT_EVERY_N_STEPS", "banana", "expected int"),
    ("MXNET_CKPT_EVERY_N_STEPS", "-3", "must be >="),
    ("MXNET_CKPT_KEEP", "0", "must be >="),
    ("MXNET_CKPT_KEEP", "2.5", "expected int"),
    ("MXNET_CKPT_COMMIT_TIMEOUT", "soon", "expected float"),
    ("MXNET_CKPT_CRASH", "sometimes", "MXNET_CKPT_CRASH"),
    ("MXNET_CKPT_CRASH", "mid_shard:x", "MXNET_CKPT_CRASH"),
])
def test_invalid_ckpt_env_fails_loudly(tmp_path, monkeypatch, var, bad, msg):
    monkeypatch.setenv(var, bad)
    with pytest.raises(mt.MXNetError, match=msg):
        mt.CheckpointManager(str(tmp_path / "c"))


def test_explicit_args_override_env_and_defaults(tmp_path, monkeypatch):
    mgr = mt.CheckpointManager(str(tmp_path / "a"))
    assert (mgr.keep, mgr.every_n_steps, mgr.async_save,
            mgr.commit_timeout) == (5, 0, True, 300.0)
    monkeypatch.setenv("MXNET_CKPT_EVERY_N_STEPS", "7")
    monkeypatch.setenv("MXNET_CKPT_KEEP", "9")
    mgr = mt.CheckpointManager(str(tmp_path / "c"), every_n_steps=2)
    assert mgr.every_n_steps == 2 and mgr.keep == 9


# ---------------------------------------------------------------------------
# resumes across packages
# ---------------------------------------------------------------------------

def _interrupted(pkg, worker, d, every=6, stop=7):
    """``worker``'s MLP in ``pkg``, stopped after batch ``stop`` of
    epoch 0 with a checkpoint every ``every`` steps."""
    pkg.random.seed(11)
    np.random.seed(11)
    X, y = worker.make_data()
    it = pkg.io.NDArrayIter(X, y, batch_size=worker.BATCH, shuffle=True)
    mod = pkg.mod.Module(worker.build_sym(), context=pkg.cpu())
    mgr = pkg.CheckpointManager(d, every_n_steps=every, async_save=True,
                                keep=10)

    def boom(param):
        if (param.epoch, param.nbatch) == (0, stop):
            raise Stop()

    with pytest.raises(Stop):
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                initializer=pkg.initializer.Xavier(rnd_type="gaussian"),
                eval_metric="acc", checkpoint=mgr, resume="auto",
                batch_end_callback=boom)
    mgr.close()


def _first_batch(seen):
    def cb(param):
        if len(seen) < 1:
            seen.append((param.epoch, param.nbatch))
    return cb


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(writer, tmp_path, caplog):
    """The checkpoint of one package's interrupted run (step 6, batch 5
    of epoch 0) resumed by the other package's ``fit``: it goes on at
    batch 6 with the saved shuffle order, and its final weights are the
    writing package's uninterrupted run's at ``GRAD``.  The JAX package
    finds the port's checkpoint clean (``verify_checkpoint``); the port
    warns that the JAX keys are ignored."""
    d = str(tmp_path / "ckpt")
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    src_w, dst_w = (JW, W) if writer == "jax" else (W, JW)
    _interrupted(src, src_w, d)
    info = [i for i in JC.list_checkpoints(d) if i.committed]
    assert [i.step for i in info] == [6]
    assert JC.verify_checkpoint(info[0].path) == []
    assert C.verify_checkpoint(info[0].path) == []
    with open(os.path.join(info[0].path, "shard-00000.bin"), "rb") as f:
        state = pickle.loads(f.read())
    assert_host_tree(state)
    ref = src_w.train(ckpt_dir=None, num_epoch=2)

    dst.random.seed(555)
    np.random.seed(555)
    X, y = dst_w.make_data()
    it = dst.io.NDArrayIter(X, y, batch_size=dst_w.BATCH, shuffle=True)
    mod = dst.mod.Module(dst_w.build_sym(), context=dst.cpu())
    mgr = dst.CheckpointManager(d, every_n_steps=0, async_save=True,
                                keep=10)
    seen = []
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            initializer=dst.initializer.Xavier(rnd_type="gaussian"),
            eval_metric="acc", checkpoint=mgr, resume="auto",
            batch_end_callback=_first_batch(seen))
    mgr.close()
    assert seen == [(0, 6)]
    np.testing.assert_array_equal(np.asarray(it._order),
                                  state["iter_state"]["order"])
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **GRAD)
    if writer == "jax":
        assert state["rng"] is not None
        assert any("cannot be reproduced" in r.getMessage()
                   for r in caplog.records)
