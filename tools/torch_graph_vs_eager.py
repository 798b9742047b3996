"""How far the port's graphed training steps lie from its eager ones on
the card, beside how far two eager runs lie from each other, with cuDNN
held to its deterministic algorithms (as the executor holds it) and
left to its default ones (the executor's ``_cudnn_algorithms`` replaced
by a context that does nothing).

ResNet-20 (3x32x32, 10 classes, batch 8; ``tests/test_torch_fused_graphs
.py``'s BatchNorm case: seeded ``Xavier(gaussian, in, 2)``, SGD lr 0.05,
momentum 0.9, wd 1e-4, six steps) trained from one start four times in
one process: eager (``MXNET_FUSED_STEP=0``), eager, graphed (the fused
step: two warm-ups, a capture, replays), graphed; ``REPEATS`` times
under cuDNN's default algorithms, then once under the deterministic
ones.  Each pair is reported as the test does: the largest |a - b| /
(atol + rtol |b|) at its ``TOL`` (rtol 1e-4, atol 1e-5) over each
step's outputs, the weights and the moving statistics after the last
step, and whether the pair is bit for bit equal.  TF32 is off.  Needs
an NVIDIA card::

    python tools/torch_graph_vs_eager.py

One JSON line per cuDNN setting, each pair's figures a list over the
repeats.
"""

import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RTOL, ATOL, STEPS, BATCH, REPEATS = 1e-4, 1e-5, 6, 8, 3


def main():
    import torch

    import mxnet_tpu_torch as mt

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mt.gpu(0)
    sym = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 32, 32))
    rng = np.random.RandomState(4)
    batches = [(rng.rand(BATCH, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, BATCH).astype(np.float32))
               for _ in range(STEPS)]
    start = []

    def run(fused):
        os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
        mod = mt.mod.Module(sym, context=card)
        mod.bind(data_shapes=[("data", (BATCH, 3, 32, 32))],
                 label_shapes=[("softmax_label", (BATCH,))])
        if not start:
            mt.random.seed(5)
            mod.init_params(mt.initializer.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2))
            start.append(mod.get_params())
        else:
            mod.init_params(arg_params=start[0][0], aux_params=start[0][1])
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        outs = []
        for X, Y in batches:
            mod.forward_backward(mt.io.DataBatch(
                [mt.nd.array(X, ctx=card)], [mt.nd.array(Y, ctx=card)]))
            mod.update()
            outs.append([o.asnumpy() for o in mod.get_outputs()])
        arg, aux = mod.get_params()
        return (outs, {k: v.asnumpy() for k, v in arg.items()},
                {k: v.asnumpy() for k, v in aux.items()})

    def over_tol(a, b):
        return float((np.abs(a - b) / (ATOL + RTOL * np.abs(b))).max())

    def pair(x, y):
        return {
            "steps": [max(over_tol(a, b) for a, b in zip(sa, sb))
                      for sa, sb in zip(x[0], y[0])],
            "weights": max(over_tol(x[1][k], y[1][k]) for k in y[1]),
            "aux": max(over_tol(x[2][k], y[2][k]) for k in y[2]),
            "bitwise": all(np.array_equal(p, q)
                           for sa, sb in zip(x[0], y[0])
                           for p, q in zip(sa, sb))
            and all(np.array_equal(x[i][k], y[i][k])
                    for i in (1, 2) for k in y[i])}

    pin = mt.executor._cudnn_algorithms
    for pinned in (False, True):
        mt.executor._cudnn_algorithms = pin if pinned \
            else contextlib.nullcontext
        pairs = {"eager_vs_eager": [], "graphed_vs_eager": [],
                 "graphed_vs_graphed": []}
        for _ in range(REPEATS if not pinned else 1):
            e1, e2, g1, g2 = run(False), run(False), run(True), run(True)
            pairs["eager_vs_eager"].append(pair(e2, e1))
            pairs["graphed_vs_eager"].append(pair(g1, e1))
            pairs["graphed_vs_graphed"].append(pair(g2, g1))
        print(json.dumps({"graph_vs_eager": {
            "cudnn": "deterministic" if pinned else "default",
            "card": torch.cuda.get_device_name(0),
            **{k: {f: [p[f] for p in v] for f in v[0]}
               for k, v in pairs.items()}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
