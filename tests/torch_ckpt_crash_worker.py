"""Single-process worker for the port's checkpoint crash and preemption
tests (the counterpart of ``tests/ckpt_crash_worker.py``).

Trains a small deterministic MLP on the CPU through
``mxnet_tpu_torch``'s ``Module.fit`` with a ``CheckpointManager``.  The
tests run it as a subprocess and end it, through the
``MXNET_CKPT_CRASH`` fault injection (the writer dies halfway through a
shard) or SIGTERM (an emergency checkpoint), then resume with
``resume='auto'`` and hold the final weights to an uninterrupted run's
(``train`` is imported for that run)."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import mxnet_tpu_torch as mt

N_SAMPLES = 48
BATCH = 4
CLASSES = 4
IN_DIM = 8


def build_sym(sym=None):
    sym = sym or mt.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def make_data():
    rng = np.random.RandomState(9)
    X = rng.randn(N_SAMPLES, IN_DIM).astype(np.float32)
    y = rng.randint(0, CLASSES, N_SAMPLES).astype(np.float32)
    return X, y


def train(ckpt_dir=None, num_epoch=2, every_n=2, sleep=0.0,
          resume="auto", async_save=True, progress=False):
    mt.random.seed(11)
    np.random.seed(11)
    X, y = make_data()
    it = mt.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=True)
    mod = mt.mod.Module(build_sym(), context=mt.cpu())
    mgr = None
    if ckpt_dir is not None:
        mgr = mt.CheckpointManager(ckpt_dir, every_n_steps=every_n,
                                   async_save=async_save, keep=10)
    cb = None
    if sleep > 0 or progress:
        def cb(param):
            if progress:
                print(f"BATCH {param.nbatch}", flush=True)
            if sleep > 0:
                time.sleep(sleep)
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            initializer=mt.initializer.Xavier(rnd_type="gaussian"),
            eval_metric="acc", checkpoint=mgr,
            resume=resume if mgr is not None else None,
            batch_end_callback=cb)
    if mgr is not None:
        mgr.close()
    args_, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args_.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--every-n", type=int, default=2)
    ap.add_argument("--sleep", type=float, default=0.0)
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--progress", action="store_true")
    args = ap.parse_args()
    train(args.ckpt_dir, num_epoch=args.epochs, every_n=args.every_n,
          sleep=args.sleep, async_save=not args.sync,
          progress=args.progress)
    print("ckpt worker done", flush=True)


if __name__ == "__main__":
    main()
