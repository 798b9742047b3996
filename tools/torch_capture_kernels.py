"""Which kernels SSD300's detection forward runs on the card eager and
as the fused step's CUDA graph, and how long each takes.

The port's SSD300 detection symbol (``models/ssd.ssd300_symbol``, the
published widths, 8,732 anchors, 21 classes) at batch 32 over
``synthetic_boxes``, seeded ``Xavier`` parameters, bound for inference
twice: eager (``MXNET_FUSED_STEP=0``) and graphed (two warm-ups, a
capture, replays), first with cuDNN's default algorithms, then with its
deterministic ones.  For each: the forward's host p50 (ms, around the
forward and a synchronize, 10 after 4 warm-ups) and, from
``torch.profiler`` over 3 forwards, the device ms a forward by kernel
(the 8 largest) and in all.  TF32 is off.  Needs an NVIDIA card::

    python tools/torch_capture_kernels.py

One JSON line per (cuDNN setting, path).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BATCH, WARM, REPS, PROFILED, TOP = 32, 4, 10, 3, 8


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.ssd import ssd300_symbol, synthetic_boxes

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mt.gpu(0)
    _, det_sym = ssd300_symbol()
    X, Y = synthetic_boxes(BATCH, seed=0)
    batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                            [mt.nd.array(Y, ctx=mt.cpu())])
    params = None
    for deterministic in (False, True):
        for path in ("eager", "graphed"):
            os.environ["MXNET_FUSED_STEP"] = "1" if path == "graphed" \
                else "0"
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=deterministic,
                                            allow_tf32=False):
                mod = mt.mod.Module(det_sym, label_names=("label",),
                                    context=card)
                mod.bind(data_shapes=[("data", X.shape)],
                         label_shapes=[("label", Y.shape)],
                         for_training=False)
                if params is None:
                    mt.random.seed(0)
                    mod.init_params(mt.initializer.Xavier())
                    params = mod.get_params()
                else:
                    mod.init_params(arg_params=params[0],
                                    aux_params=params[1])

                def forward():
                    mod.forward(batch, is_train=False)
                    mod.get_outputs()
                    torch.cuda.synchronize()

                for _ in range(WARM):
                    forward()
                ms = []
                for _ in range(REPS):
                    t0 = time.perf_counter()
                    forward()
                    ms.append((time.perf_counter() - t0) * 1e3)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILED):
                        forward()
                kernels = sorted(
                    ((e.key, e.self_device_time_total / PROFILED / 1e3)
                     for e in prof.key_averages()
                     if e.self_device_time_total > 0),
                    key=lambda kv: -kv[1])
            print(json.dumps({"ssd300_detection": {
                "cudnn": "deterministic" if deterministic else "default",
                "path": path, "card": torch.cuda.get_device_name(0),
                "forward_p50_ms": float(np.median(ms)),
                "device_ms": sum(v for _, v in kernels),
                "top_kernels_ms": [[k[:90], v] for k, v in kernels[:TOP]],
                "pool_or_reserved_bytes": torch.cuda.memory_reserved()}}),
                flush=True)
            del mod
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
