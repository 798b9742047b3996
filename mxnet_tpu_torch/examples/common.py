"""Example plumbing for the image-classification scripts: the fit
argument group, the learning-rate schedule, the standard training run
and the synthetic datasets.

The port's copy of ``examples/common/util.py`` (reference:
``example/image-classification/common/fit.py`` and ``data.py``).  The
synthetic sets stand in for MNIST and ImageNet, whose files are not in
the repository; they are learnable (a class-dependent signal), so
accuracy gains are real.  The training device is ``gpu(0)`` unless the
caller passes another context.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import not_ported

__all__ = ["setup_logging", "add_fit_args", "lr_scheduler", "fit",
           "synthetic_mnist", "mnist_iters", "synthetic_image_iter"]


def setup_logging():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")


def add_fit_args(parser: argparse.ArgumentParser):
    """reference: common/fit.py add_fit_args"""
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="lenet")
    train.add_argument("--batch-size", type=int, default=64)
    train.add_argument("--num-epochs", type=int, default=3)
    train.add_argument("--lr", type=float, default=0.05)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=0.0001)
    train.add_argument("--kv-store", type=str, default="local",
                       help="local (the only one ported)")
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str, default=None)
    train.add_argument("--load-epoch", type=int, default=None)
    train.add_argument("--monitor", type=int, default=0,
                       help="monitor interval (0 = off)")
    train.add_argument("--profile", type=str, default=None,
                       help="write a Chrome trace to this file")
    return train


def lr_scheduler(args, epoch_size):
    """``MultiFactorScheduler`` at ``--lr-step-epochs`` (in epochs of
    ``epoch_size`` updates), or None."""
    if not args.lr_step_epochs:
        return None
    steps = [int(x) for x in args.lr_step_epochs.split(",") if x]
    return mt.lr_scheduler.MultiFactorScheduler(
        step=[max(1, epoch_size * s) for s in steps], factor=args.lr_factor)


def fit(args, network, train_iter, val_iter=None, label_names=None,
        initializer=None, epoch_size=None, ctx=None):
    """reference: common/fit.py fit — ``Module.fit`` of ``network`` on
    ``ctx`` (default ``gpu(0)``): the optimizer named by ``--optimizer``
    (any registered one; momentum ``--mom`` for sgd and nag) at ``--lr``
    and ``--wd``, ``Xavier(gaussian, in, 2)``, accuracy, a
    ``Speedometer`` every ``--disp-batches``, and with ``--monitor N`` a
    ``Monitor`` of every array each N batches.  With ``--model-prefix``
    each epoch ends with ``do_checkpoint`` (symbol and parameters, no
    optimizer state); with ``--load-epoch`` too, the run starts from
    that epoch's checkpoint, at that epoch.  Returns the module."""
    if args.profile is not None:
        raise not_ported("--profile (the profiler, queue A item 8)")
    if args.kv_store != "local":
        raise not_ported(f"--kv-store {args.kv_store} (distribution, "
                         f"queue A item 9)")
    setup_logging()
    mod = mt.mod.Module(network, context=ctx if ctx is not None
                        else mt.gpu(0),
                        label_names=label_names or ("softmax_label",))
    arg_params = aux_params = None
    if args.load_epoch is not None:
        if not args.model_prefix:
            raise mt.MXNetError("--load-epoch needs --model-prefix, the "
                                "checkpoint to load")
        try:
            _, arg_params, aux_params = mt.model.load_checkpoint(
                args.model_prefix, args.load_epoch)
        except mt.MXNetError as exc:
            raise mt.MXNetError(f"--model-prefix {args.model_prefix} "
                                f"--load-epoch {args.load_epoch}: {exc}") \
                from None
    optimizer_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer in ("sgd", "nag"):
        optimizer_params["momentum"] = args.mom
    sched = lr_scheduler(args, epoch_size or 1000)
    if sched is not None:
        optimizer_params["lr_scheduler"] = sched
    monitor = mt.Monitor(args.monitor, pattern=".*") if args.monitor > 0 \
        else None
    checkpoint = mt.callback.do_checkpoint(args.model_prefix) \
        if args.model_prefix else None
    mod.fit(train_iter,
            eval_data=val_iter,
            begin_epoch=args.load_epoch or 0,
            num_epoch=args.num_epochs,
            eval_metric="acc",
            kvstore=args.kv_store,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params,
            initializer=initializer or mt.initializer.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2),
            arg_params=arg_params,
            aux_params=aux_params,
            batch_end_callback=mt.callback.Speedometer(
                args.batch_size, args.disp_batches),
            epoch_end_callback=checkpoint,
            monitor=monitor)
    return mod


# ---------------------------------------------------------------------------
# Synthetic datasets (learnable, deterministic)
# ---------------------------------------------------------------------------

def synthetic_mnist(num=2048, seed=0):
    """28x28 digit-like data: class k = bright kxk-ish block pattern."""
    rng = np.random.RandomState(seed)
    X = rng.rand(num, 1, 28, 28).astype(np.float32) * 0.25
    y = rng.randint(0, 10, size=num).astype(np.float32)
    for i in range(num):
        k = int(y[i])
        r, c = divmod(k, 4)
        X[i, 0, 2 + r * 8:8 + r * 8, 2 + c * 6:8 + c * 6] += 0.75
    return X, y


def mnist_iters(args):
    """The synthetic MNIST set: 4,096 training images (shuffled with the
    global numpy RNG) and 512 validation images, ``--batch-size``,
    partial batches discarded.  Reading the MNIST files (``MNISTIter``)
    is not ported."""
    X, y = synthetic_mnist(4096)
    Xv, yv = synthetic_mnist(512, seed=7)
    train = mt.io.NDArrayIter(X, y, batch_size=args.batch_size, shuffle=True,
                              last_batch_handle="discard")
    val = mt.io.NDArrayIter(Xv, yv, batch_size=args.batch_size,
                            last_batch_handle="discard")
    return train, val


def synthetic_image_iter(batch_size, image_shape, num_classes=1000,
                         num_batches=50):
    """The reference's --benchmark 1 path: two seeded batches of random
    images and labels, cycled by ``ResizeIter`` for ``num_batches`` an
    epoch."""
    c, h, w = image_shape
    rng = np.random.RandomState(0)
    n = batch_size * 2
    X = rng.rand(n, c, h, w).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.float32)
    it = mt.io.NDArrayIter(X, y, batch_size=batch_size)
    return mt.io.ResizeIter(it, num_batches, reset_internal=False)
