"""Inference throughput — the port of ``examples/benchmark_score.py``
(reference: ``example/image-classification/benchmark_score.py``):
scores each network at each batch size on synthetic data and prints
images/s.

    python -m mxnet_tpu_torch.examples.benchmark_score \
        --networks lenet,alexnet,vgg,inception-bn,resnet-50
"""

import argparse
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models

# untimed calls first: they build the kernels and, on the card, leave
# the module's inference graph captured, so the timed calls replay it
WARMUP_CALLS = 5


def score(network, batch_size, image_shape, num_classes, dev,
          num_batches=10, **symbol_kwargs):
    """images/s of ``num_batches`` ``forward(is_train=False)`` calls of
    ``network`` (``symbol_kwargs`` to ``get_symbol``, e.g. ``stem="s2d"``)
    at ``batch_size`` on ``dev``, from ``Xavier(magnitude=2)`` weights,
    after ``WARMUP_CALLS`` untimed ones."""
    sym = models.get_symbol(network, num_classes=num_classes,
                            image_shape=image_shape, **symbol_kwargs)
    data_shape = (batch_size,) + image_shape
    # the zoo symbols end in SoftmaxOutput, so declare the label input
    # (zero-filled at bind; unused by the inference forward)
    mod = mt.mod.Module(sym, context=dev)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (batch_size,))],
             for_training=False)
    mod.init_params(mt.initializer.Xavier(magnitude=2.0))
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch([mt.nd.array(
        rng.rand(*data_shape).astype(np.float32), ctx=mt.cpu())], [])
    for _ in range(WARMUP_CALLS):
        mod.forward(batch, is_train=False)
        mod.get_outputs()[0].wait_to_read()
    tic = time.time()
    for _ in range(num_batches):
        mod.forward(batch, is_train=False)
    mod.get_outputs()[0].wait_to_read()
    return num_batches * batch_size / (time.time() - tic)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="inference benchmark")
    parser.add_argument("--networks", type=str,
                        default="lenet,alexnet,resnet-18,resnet-50")
    parser.add_argument("--batch-sizes", type=str, default="1,2,4,8,16,32")
    parser.add_argument("--image-shape", type=str, default="3,224,224")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-batches", type=int, default=10)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of gpu(0)")
    return parser.parse_args([] if argv is None else argv)


def main(argv=None, ctx=None):
    """Score every (network, batch size) on ``ctx`` (``gpu(0)`` unless
    ``ctx`` or ``--cpu`` says otherwise) → {(network, batch): img/s}."""
    args = parse_args(argv)
    if ctx is None:
        ctx = mt.cpu() if args.cpu else mt.gpu(0)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    rates = {}
    for net in args.networks.split(","):
        shape = (1, 28, 28) if net in ("lenet", "mlp") else image_shape
        classes = 10 if net in ("lenet", "mlp") else args.num_classes
        for b in (int(x) for x in args.batch_sizes.split(",")):
            rates[(net, b)] = ips = score(net, b, shape, classes, ctx,
                                          args.num_batches)
            print(f"network: {net:16s} batch: {b:3d}  {ips:10.1f} img/s")
    return rates


if __name__ == "__main__":
    main(sys.argv[1:])
