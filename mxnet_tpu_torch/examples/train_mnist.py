"""Train LeNet or the MLP on MNIST — BASELINE config 1.

The port of ``examples/train_mnist.py`` (reference:
``example/image-classification/train_mnist.py``): the same command
line over ``Module.fit``, on the synthetic learnable digit set (the
MNIST files are not in the repository).

    python -m mxnet_tpu_torch.examples.train_mnist --network lenet
    python -m mxnet_tpu_torch.examples.train_mnist --network mlp --cpu
"""

import argparse
import sys

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import not_ported
from mxnet_tpu_torch.examples.common import add_fit_args, fit, mnist_iters


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train MNIST",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--data-dir", type=str, default=None,
                        help="MNIST idx files (not ported: MNISTIter)")
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of gpu(0)")
    add_fit_args(parser)
    parser.set_defaults(network="lenet", batch_size=64, num_epochs=3,
                        lr=0.05)
    return parser.parse_args([] if argv is None else argv)


def main(argv=None, ctx=None):
    """Train and score on ``ctx`` (``gpu(0)`` unless ``ctx`` or
    ``--cpu`` says otherwise) → the final validation accuracy."""
    args = parse_args(argv)
    if args.data_dir:
        raise not_ported("--data-dir (MNISTIter, queue A item 8)")
    if ctx is None:
        ctx = mt.cpu() if args.cpu else mt.gpu(0)
    net = models.get_symbol(args.network, num_classes=args.num_classes)
    train, val = mnist_iters(args)
    mod = fit(args, net, train, val,
              epoch_size=train.num_data // args.batch_size, ctx=ctx)
    score = mod.score(val, "acc")
    print(f"final validation accuracy: {score[0][1]:.4f}")
    return score[0][1]


if __name__ == "__main__":
    main(sys.argv[1:])
