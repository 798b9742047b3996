"""Train an ImageNet-class network — BASELINE config 2 and its AlexNet
and Inception-v3 rows.

The port of ``examples/train_imagenet.py`` (reference:
``example/image-classification/train_imagenet.py``) in its synthetic
benchmark mode (``--benchmark 1``, the reference's throughput path):
two seeded batches cycled by ``ResizeIter`` through ``Module.fit``.
``--network`` is any of ``models.get_symbol``'s: resnet-N, alexnet,
vgg, inception-bn, inception-v3 (at ``--image-shape 3,299,299``).
RecordIO data (``--data-train``, ``ImageRecordIter``) is not ported.

    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1
    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --network alexnet --batch-size 256 --lr 0.01
    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --network inception-v3 --image-shape 3,299,299
"""

import argparse
import sys

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import not_ported
from mxnet_tpu_torch.examples.common import (add_fit_args, fit,
                                             synthetic_image_iter)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--data-train", type=str, default=None,
                        help="RecordIO data (not ported: ImageRecordIter)")
    parser.add_argument("--image-shape", type=str, default="3,224,224")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--benchmark", type=int, default=0,
                        help="1 = synthetic data throughput run")
    parser.add_argument("--num-batches", type=int, default=40,
                        help="benchmark batches per epoch")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of gpu(0)")
    add_fit_args(parser)
    parser.set_defaults(network="resnet-50", batch_size=32, num_epochs=1,
                        lr=0.1)
    return parser.parse_args([] if argv is None else argv)


def main(argv=None, ctx=None):
    """Train on ``ctx`` (``gpu(0)`` unless ``ctx`` or ``--cpu`` says
    otherwise) → the module."""
    args = parse_args(argv)
    if args.data_train:
        raise not_ported("--data-train (ImageRecordIter, queue A item 8)")
    if ctx is None:
        ctx = mt.cpu() if args.cpu else mt.gpu(0)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    net = models.get_symbol(args.network, num_classes=args.num_classes,
                            image_shape=image_shape)
    train = synthetic_image_iter(args.batch_size, image_shape,
                                 args.num_classes, args.num_batches)
    return fit(args, net, train, ctx=ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
