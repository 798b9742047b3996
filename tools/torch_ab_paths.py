"""SSD300's training and detection phase and ResNet-50's training run of
``chip_smoke.py``, graphed and eager, for several checkouts of the port
in turns on one card: to compare a change with its parent where the
change is outside the kernels (the executor, the allocator's state).

    python tools/torch_ab_paths.py PARENT CHANGE CHANGE PARENT

Each ROOT is a checkout (e.g. ``git archive`` of a commit unpacked into
a git-ignored directory); each runs in a process of its own, from its
root, with its own ``chip_smoke.py`` and ``mxnet_tpu_torch`` (B7 built
first).  One ``AB`` JSON line per root, in the order given: SSD300's step
p50 and device ms fused and eager, its detection forward p50 both ways,
its peak memory and graph pool; ResNet-50's step p50 fused and eager
and its peak memory.  TF32 is off.  Needs an NVIDIA card.
"""

import json
import os
import subprocess
import sys

RUN = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.ops import cuda_kernels as ck

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["nms"])
rec = cs.ssd_path(torch, mt, ck, eager=True)
e = rec["eager"]
out = {"ssd_fused_step_p50_ms": rec["step_p50_ms"],
       "ssd_fused_kernels_ms": rec["step_device_ms"]["kernels_ms"],
       "ssd_fused_detect_p50_ms": rec["detection_forward_p50_ms"],
       "ssd_eager_step_p50_ms": e["step_p50_ms"],
       "ssd_eager_kernels_ms": e["step_device_ms"]["kernels_ms"],
       "ssd_eager_detect_p50_ms": e["detection_forward_p50_ms"],
       "ssd_peak_memory_bytes": rec["peak_memory_bytes"],
       "ssd_pool_bytes": rec["graphs"]["pool_bytes"]}
torch.cuda.empty_cache()
r = cs.resnet_train(torch, mt)
out.update(resnet_fused_step_p50_ms=r["step_p50_ms"],
           resnet_eager_step_p50_ms=r["eager"]["step_p50_ms"],
           resnet_peak_memory_bytes=r["peak_memory_bytes"])
print("AB " + json.dumps(out))
'''


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        p = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                           capture_output=True, text=True)
        lines = [l for l in p.stdout.splitlines() if l.startswith("AB ")]
        if p.returncode or not lines:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"root": os.path.abspath(root),
                          **json.loads(lines[-1][3:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
