#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Device and build: prints the card's name and power limit and builds
   the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (one ``nvcc``
   per source, started together).
2. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, in fp32 (tolerance 2e-5) and bf16 (2e-2):
   the time of each (CUDA events, median of 20 after warm-up), of its
   plain version, of a PyTorch library call computing the same function
   (timed here only, used nowhere in the port) and the least time the
   card could take for the work (``bound_ms``).
3. The main path: a GPT-2-small-class LM (12 layers, d_model 768, 12
   heads, d_ff 3072, vocab 32768, 1024 positions; random weights from
   ``np.random.RandomState(0)``) serves 16 requests through
   ``DecodeEngine``; every kernel must have launched exactly 12 times
   per prefill / per decode step, and the full forward must reproduce
   the generated greedy tokens wherever the top-2 margin exceeds 1e-3.
4. Prints ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.

Float32 matmuls run in full float32: TF32 is off for matmuls and cuDNN.
Any failed check raises and the script exits non-zero without the last
line.  It needs a CUDA card and the repository around it.
"""

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks, dense (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

GPT2_SMALL = dict(vocab_size=32768, num_layers=12, num_heads=12, d_model=768,
                  d_ff=3072, max_len=1024)
H, D, KVB = 12, 64, 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, warmup=3):
    """Median of ``reps`` launches, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_prefill(torch, ck, F, T, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn((1, T, 3 * H * D), generator=g, device="cuda").to(dt)
    o, lse = ck.flash_mha_packed(qkv, H, causal=True)
    po, plse = ck.flash_mha_packed_plain(qkv, H, causal=True)
    torch.cuda.synchronize()
    err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    check(err <= TOL[dtype] and lse_err <= TOL["float32"] * 10,
          f"flash_mha_packed T={T} {dtype}: max_abs_err {err} (lse "
          f"{lse_err}) over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(o.float()).all()), "prefill output not finite")
    q, k, v = (x.unflatten(-1, (H, D)).transpose(1, 2)
               for x in qkv.split(H * D, dim=-1))
    es = qkv.element_size()
    nbytes = T * 3 * H * D * es + T * H * D * es + T * H * 4
    flops = 4 * H * D * T * (T + 1) // 2
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "kernel": "flash_mha_packed", "shape": f"B=1 T={T} H={H} D={D} "
        f"causal", "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.flash_mha_packed(qkv, H, True)),
        "plain_ms": time_ms(torch, lambda: ck.flash_mha_packed_plain(
            qkv, H, True), reps=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by}


def check_decode(torch, ck, F, B, MB, dtype, rng, kv_dtype=None):
    """``kv_dtype`` other than ``dtype``: an fp32 model over bf16 pages
    (``kv_dtype='bf16'``); both sides then read the same bf16 values, so
    the fp32 tolerance holds."""
    dt = getattr(torch, dtype)
    kv_dt = getattr(torch, kv_dtype or dtype)
    P = 1 + B * MB
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + MB)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    kp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(kv_dt)
    vp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(kv_dt)
    # ragged lengths up to MB pages; with B > 1 one empty slot and one
    # stream ending exactly on a page boundary
    lengths = rng.randint(1, MB * KVB + 1, size=B).astype(np.int32)
    lengths[0] = MB * KVB
    if B > 1:
        lengths[1] = 0
    if B > 2:
        lengths[2] = KVB * max(1, MB // 2)
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    table = np.zeros((B, MB), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-int(n) // KVB)
        table[i, :k] = pages[used:used + k]  # fragmented, padded with 0
        used += k
    t_d = torch.from_numpy(table).cuda()
    l_d = torch.from_numpy(lengths).cuda()
    out = ck.paged_attention_decode(q, kp, vp, t_d, l_d)
    ref = ck.paged_attention_decode_plain(q, kp, vp, t_d, l_d)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[dtype], f"paged_attention_decode B={B} MB={MB} "
          f"{dtype}: max_abs_err {err} over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(out.float()).all()), "decode not finite")
    if B > 1:
        check(out[1].abs().max().item() == 0.0, "lengths==0 row not zeros")

    idx = t_d.long()
    pos = torch.arange(MB * KVB, device="cuda")
    mask = (pos[None, :] < l_d[:, None])[:, None, None, :]

    def library():  # gather (widened to q's dtype), then masked SDPA
        kg = kp[idx].reshape(B, MB * KVB, H, D).transpose(1, 2).to(dt)
        vg = vp[idx].reshape(B, MB * KVB, H, D).transpose(1, 2).to(dt)
        return F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                              attn_mask=mask)

    es = kp.element_size()
    toks = int(lengths.sum())
    npages = int(sum(-(-int(n) // KVB) for n in lengths))
    nbytes = 2 * B * H * D * q.element_size() + 2 * toks * H * D * es \
        + npages * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * toks, dtype)
    return {
        "kernel": "paged_attention_decode", "shape": f"B={B} MB={MB} "
        f"KVB={KVB} H={H} D={D} tokens={toks}",
        "dtype": dtype if kv_dtype is None else f"{dtype}/{kv_dtype}",
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.paged_attention_decode(
            q, kp, vp, t_d, l_d)),
        "plain_ms": time_ms(torch, lambda: ck.paged_attention_decode_plain(
            q, kp, vp, t_d, l_d), reps=5, warmup=1),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by}


def gpt2_small_params(seed=0):
    """Random GPT-2-small-class weights, N(0, 0.02), LayerNorm at
    identity, zero biases."""
    from mxnet_tpu_torch.models.transformer import param_names

    V, L, dm = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["d_model"]
    dff, T = GPT2_SMALL["d_ff"], GPT2_SMALL["max_len"]
    shapes = {"tok_embed_weight": (V, dm), "pos_embed_weight": (T, dm),
              "ln_f_gamma": (dm,), "ln_f_beta": (dm,),
              "head_weight": (V, dm), "head_bias": (V,)}
    for i in range(L):
        p = f"layer{i}_"
        shapes.update({p + "ln1_gamma": (dm,), p + "ln1_beta": (dm,),
                       p + "qkv_weight": (3 * dm, dm),
                       p + "qkv_bias": (3 * dm,),
                       p + "proj_weight": (dm, dm), p + "proj_bias": (dm,),
                       p + "ln2_gamma": (dm,), p + "ln2_beta": (dm,),
                       p + "ff1_weight": (dff, dm), p + "ff1_bias": (dff,),
                       p + "ff2_weight": (dm, dff), p + "ff2_bias": (dm,)})
    rng = np.random.RandomState(seed)
    params = {}
    for n in param_names(L):
        if n.endswith("_gamma"):
            params[n] = np.ones(shapes[n], np.float32)
        elif n.endswith(("_beta", "_bias")):
            params[n] = np.zeros(shapes[n], np.float32)
        else:
            params[n] = (rng.standard_normal(shapes[n]) * 0.02).astype(
                np.float32)
    return params


def main_path(torch, mt, ck):
    params = gpt2_small_params(0)
    dev_params = mt.params_from_numpy(params, "cuda")
    del params
    L = GPT2_SMALL["num_layers"]
    eng = mt.DecodeEngine(dev_params, **GPT2_SMALL, ctx=mt.gpu(0),
                          kv_block=KVB, max_streams=16, seed=0)
    with eng:
        eng.generate(np.arange(1, 20, dtype=np.int32), 2)  # CUDA warm-up
        rng = np.random.RandomState(1)
        lens = rng.randint(32, 901, size=16)
        prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], size=n)
                   .astype(np.int32) for n in lens]
        temps = [0.8 if i in (3, 11) else 0.0 for i in range(16)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.reset_stats()
        ck.reset_launch_counts()  # counts from here on: the main path
        t0 = time.perf_counter()
        futs = [eng.submit(p, 32, temperature=t)
                for p, t in zip(prompts, temps)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated()
        for o in outs:
            check(o.shape == (32,) and o.min() >= 0
                  and o.max() < GPT2_SMALL["vocab_size"],
                  f"bad generation {o}")
        check(launches["flash_mha_packed"] == L * st["prefills"] > 0,
              f"flash_mha_packed launched {launches['flash_mha_packed']} "
              f"times for {st['prefills']} prefills")
        check(launches["paged_attention_decode"] == L * st["steps"] > 0,
              f"paged_attention_decode launched "
              f"{launches['paged_attention_decode']} times for "
              f"{st['steps']} steps")
        # the port's full forward reproduces the greedy tokens
        greedy = [i for i in range(16) if temps[i] == 0.0]
        for i in (min(greedy, key=lambda j: lens[j]),
                  max(greedy, key=lambda j: lens[j])):
            seq = np.concatenate([prompts[i], outs[i]])
            logits = eng.model(torch.from_numpy(seq).cuda()[None])[0]
            top2 = torch.topk(logits[len(prompts[i]) - 1:-1], 2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            arg = top2.indices[:, 0].cpu().numpy()
            sure = margin > 1e-3
            check(sure.sum() > 0 and np.array_equal(arg[sure],
                                                    outs[i][sure]),
                  f"stream {i}: full forward disagrees with the engine at "
                  f"{np.nonzero(sure & (arg != outs[i]))[0]}")
            print(f"forward check: stream {i} ({lens[i]}-token prompt) "
                  f"{int(sure.sum())}/32 tokens over the 1e-3 margin agree")
    return {"requests": 16, "prompt_tokens": int(lens.sum()),
            "generated_tokens": int(sum(len(o) for o in outs)),
            "wall_s": wall,
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "ttft_p50_ms": st["ttft_p50_ms"],
            "ttft_p99_ms": st["ttft_p99_ms"],
            "decode_step_p50_ms": st["step_p50_ms"],
            "prefills": st["prefills"], "steps": st["steps"],
            "preempted": st["preempted"],
            "peak_memory_bytes": int(peak), "launches": launches}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script drives "
              "the port on an NVIDIA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; device {kind}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))

    rng = np.random.RandomState(2)
    checks = []
    for dtype in ("float32", "bfloat16"):
        for T in (128, 1000, 1024):
            checks.append(check_prefill(torch, ck, F, T, dtype))
            print(json.dumps({"check": checks[-1]}))
        for B, MB in ((1, 64), (16, 64), (64, 64)):
            checks.append(check_decode(torch, ck, F, B, MB, dtype, rng))
            print(json.dumps({"check": checks[-1]}))
    checks.append(check_decode(torch, ck, F, 16, 64, "float32", rng,
                               kv_dtype="bfloat16"))
    print(json.dumps({"check": checks[-1]}))
    torch.cuda.empty_cache()

    res = main_path(torch, mt, ck)
    print(json.dumps({"main_path": res}))

    # the fp32 check at the main path's largest shapes stands for each
    rep = {"flash_mha_packed": "B=1 T=1024 ",
           "paged_attention_decode": "B=16 MB=64 "}
    meta = {"flash_mha_packed": (
                "mxnet_tpu_torch/csrc/flash_mha_packed.cu",
                "mxnet_tpu/ops/pallas_kernels.py:1193"),
            "paged_attention_decode": (
                "mxnet_tpu_torch/csrc/paged_attention_decode.cu",
                "mxnet_tpu/ops/pallas_kernels.py:1389")}
    kernels = []
    for name, (src, replaces) in meta.items():
        c = next(c for c in checks if c["kernel"] == name
                 and c["dtype"] == "float32"
                 and c["shape"].startswith(rep[name]))
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": res["launches"][name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
