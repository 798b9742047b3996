"""Where a prefill's time goes in the port's ``DecodeEngine``: one
prefix-cache hit's admission (the 512-token system prompt of
``chip_smoke.py``'s phase 16 plus 200 new tokens: a suffix prefill on
B8) against the same prompt's miss with the cache off (B1 over 712
tokens), at the GPT-2-class width on one NVIDIA card, fp32 with TF32
off.

    python3 tools/torch_prefill_trace.py OUT_DIR

Each engine serves phase 16 (a)'s warm prompts first, greedy (so the
process's first sampled token falls in the first engine's burst, where
``prefill_split`` shows its cost), then (a)'s burst, then three
probes (the system prompt and 200 tokens of their own seed), each a
``generate(probe, 1)``: its prefill and first token, no decode step.
Each probe runs under ``torch.profiler`` (CPU and CUDA); the last one's
Chrome trace stays in ``OUT_DIR/prefill_{hit,miss}.json``.  One
``prefill_trace`` JSON line a probe of each: the wall (host clock), the
kernels' busy time and the span from the first event to the last
kernel's end, the CUDA runtime calls by name (calls, total and longest
ms) and the device's idle gaps over 0.5 ms, with the runtime call the
host was in when each began.  Before the probes, one ``prefill_split``
line a run: (a)'s 15 requests together, each prefill split into its
dispatch, the device wait and the sampling (``split_burst``).  Needs an
NVIDIA card.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def summarize(path):
    """The trace's kernels, runtime calls and device gaps (ms)."""
    ev = [e for e in json.load(open(path))["traceEvents"]
          if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in ev)
    kern = sorted((e for e in ev if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    rt = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    calls = {}
    for e in rt:
        c = calls.setdefault(e["name"], [0, 0.0, 0.0])
        c[0] += 1
        c[1] += e["dur"] / 1e3
        c[2] = max(c[2], e["dur"] / 1e3)
    gaps, end = [], kern[0]["ts"] if kern else t0
    for e in kern:
        if e["ts"] - end > 500:
            during = [r["name"] for r in rt
                      if r["ts"] <= end <= r["ts"] + r["dur"]]
            gaps.append([(end - t0) / 1e3, (e["ts"] - end) / 1e3,
                         during[0] if during else None, e["name"][:60]])
        end = max(end, e["ts"] + e["dur"])
    return {"kernels_ms": sum(e["dur"] for e in kern) / 1e3,
            "last_kernel_end_ms": (end - t0) / 1e3,
            "trace_span_ms": (max(e["ts"] + e["dur"] for e in ev) - t0)
            / 1e3,
            "runtime": {k: [v[0], round(v[1], 4), round(v[2], 4)]
                        for k, v in sorted(calls.items(),
                                           key=lambda kv: -kv[1][1])},
            "device_gaps": gaps}


def split_burst(torch, cs, eng, prompts, temps):
    """Phase 16 (a)'s 15 requests submitted together (its second half:
    hits with the cache on), each admission's prefill split on the host
    clock into the forward's dispatch (``_run_prefill``), the wait for
    the device at the first token (a synchronize put in front of
    ``_sample_first``) and the sampling and copy-back after it: ms per
    admission, medians and means."""
    rec = {"dispatch": [], "device_wait": [], "sample": []}
    run, sample = eng._run_prefill, eng._sample_first

    def timed_run(*a, **kw):
        t = time.perf_counter()
        out = run(*a, **kw)
        rec["dispatch"].append((time.perf_counter() - t) * 1e3)
        return out

    def timed_sample(*a, **kw):
        t = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = sample(*a, **kw)
        rec["device_wait"].append((t1 - t) * 1e3)
        rec["sample"].append((time.perf_counter() - t1) * 1e3)
        return out

    eng._run_prefill, eng._sample_first = timed_run, timed_sample
    try:
        futs = [eng.submit(p, cs.PREFIX_NEW, temperature=t)
                for p, t in zip(prompts, temps)]
        for f in futs:
            f.result(timeout=600)
    finally:
        del eng._run_prefill, eng._sample_first
    out = {k: {"p50": float(np.median(v)), "mean": float(np.mean(v)),
               "max": float(np.max(v))} for k, v in rec.items()}
    out["sample_ms"] = rec["sample"]
    return out


def main(out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("torch_prefill_trace: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(out_dir, exist_ok=True)
    _build.build(["flash_mha_packed", "flash_attention_partial",
                  "paged_attention_decode"])
    dev_params = mt.params_from_numpy(cs.gpt2_small_params(0), "cuda")
    prefix, first, prompts, temps = cs.shared_prompt_traffic()
    _, wfirst, wprompts, _ = cs.shared_prompt_traffic(seed=5)
    warm = [(p, cs.PREFIX_NEW) for p in [wfirst] + wprompts]
    V = cs.GPT2_SMALL["vocab_size"]
    for name, kw in (("hit", {}), ("miss", {"prefix_cache": 0})):
        with cs.counted_engine(torch, mt, ck, dev_params, warm=warm,
                               **kw) as eng:
            eng.generate(first, 2)  # the system prompt enters the index
            print(json.dumps({"prefill_split": {
                "run": name, **split_burst(torch, cs, eng, prompts, temps),
                "card": cs.card_line()}}))
            for seed in (7, 8, 9):
                probe = np.concatenate([prefix, np.random.RandomState(
                    seed).randint(1, V, size=200)]).astype(np.int32)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    eng.generate(probe, 1)
                    wall = (time.perf_counter() - t) * 1e3
                path = os.path.join(out_dir, f"prefill_{name}.json")
                prof.export_chrome_trace(path)
                st = eng.stats()
                print(json.dumps({"prefill_trace": {
                    "run": name, "seed": seed, "wall_ms": wall,
                    "prefix_hits": st.get("prefix_hits"),
                    **summarize(path), "card": cs.card_line()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python3 tools/torch_prefill_trace.py OUT_DIR")
    sys.exit(main(sys.argv[1]))
