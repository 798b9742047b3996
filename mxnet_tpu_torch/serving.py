"""Serving: ``InferenceEngine`` (dynamic micro-batching of a
``Predictor``'s forward, below) and ``DecodeEngine`` (autoregressive
serving, continuous batching over a paged KV cache).

Counterpart of ``mxnet_tpu/serving.py``'s ``DecodeEngine``, with the same
entry point and semantics:

* **prefill** runs the causal forward over a bucket-padded prompt once
  (one stream at a time), writing each layer's K/V into the stream's
  pages (``flash_mha_packed`` kernel for the attention);
* **decode** advances every active stream one token per step in one
  batch (``paged_attention_decode`` kernel; ``paged_attention_decode_quant``
  over int8/fp8 pages), samples greedy or temperature tokens on the
  device, and copies ONE (B,) int32 vector to the host per step;
* **speculation** (``spec_tokens=k``): the n-gram proposer drafts up to
  k tokens a stream, and one verify step (``paged_attention_verify`` /
  ``_quant`` kernel) scores the pending token and the drafts; the
  longest verified prefix plus the target's own next token commits, ONE
  (B, 1+k) int32 copy a step; pages that held only rejected tokens go
  back to the pool.  A step where no stream has a draft is the plain
  step;
* **quantized pages** (``kv_dtype='int8'`` / ``'fp8'``): codes plus one
  float32 scale per (slot, head), quantized on write, dequantized inside
  the attention kernels;
* streams join and retire at every step (Orca, Yu et al. OSDI '22);
* the **prefix cache** (on by default, ``prefix_cache`` /
  ``MXNET_SERVING_PREFIX_CACHE``): admission attaches the longest cached
  block-aligned prefix of a prompt (``prefix_cache.PrefixCache``: pages
  shared by refcount, parked pages revived) and prefills only the
  uncached suffix (``TransformerLM.suffix_prefill``, the
  ``flash_attention_partial`` kernel over the cached pages); a fully
  cached prompt skips prefill and replays its last token, whose write
  copies the shared tail page first (copy-on-write); a retired stream's
  indexed pages park, and are evicted LRU when the pool runs dry
  (``evict_policy`` / ``MXNET_SERVING_EVICT``);
* **chunked prefill** (``prefill_chunk`` / ``MXNET_SERVING_PREFILL_CHUNK``):
  a prompt whose uncached part exceeds the chunk prefills one chunk per
  scheduler iteration, each a suffix prefill, with the decode step of
  the active streams between chunks; pages are charged chunk by chunk;
* **multi-tenancy** (``adapters`` / ``MXNET_ADAPTER_ENABLE``,
  ``tenant_quota`` / ``MXNET_TENANT_QUOTA_TOKENS``): a request names an
  adapter of the engine's ``adapters.AdapterPool`` (published and
  retired hot, ``publish_adapter`` / ``retire_adapter``), whose
  low-rank delta every forward of the stream adds to its QKV
  projection (``ops.adapter.lora_gather_delta``, the slabs and the
  batch's slot ids runtime arguments); a request of a tenant charges
  the tenant's token bucket or is shed with ``QuotaExceededError``;
  the prefix cache keys an adapter stream's pages by the adapter's
  name, so no other stream matches them;
* admission is keyed to free pages (the prompt's pages plus one block
  of headroom), the first ``interactive`` request ahead of ``batch``
  ones (``submit(slo_class=)``); when a growing stream finds the pool
  empty, the youngest other stream is preempted (one whose pages are
  its own first, a ``batch`` one before an ``interactive`` one) and
  re-queued for re-prefill (recompute-style);
* batch size, table width and prompt length are bucketed on doubling
  ladders, so the kernels see few distinct shapes.

The pools are updated in place by the attention ops (``index_put_``),
which replaces the JAX engine's buffer donation.  The scheduler runs on
its own thread; kernels launch on that thread's current CUDA stream,
and the step's one device-to-host copy synchronises that stream only.

**Executables** (the JAX engine's ``_exe_cache`` and ``compiles``,
``mxnet_tpu/serving.py:1426-1428, 2002-2293``): a decode step, a verify
step, a miss's prefill and a suffix prefill (a prefix hit's suffix,
every chunk) run ``_Executable``s keyed as the JAX engine keys its
compiled programs — ``("decode", bb, mb)``, ``("verify", bb, mb, W)``,
``("prefill", tp)``, ``("prefix_prefill", tp, mb)``, plus the rank
buckets a batch's adapter rows use — each owning its int32 input
buffers (filled by one copy a
step from a pinned staging buffer) and computing the model up to the
logits.  On CUDA each is one CUDA graph, captured at the bucket's first
use (which runs the step eagerly on a side stream first, then captures
on that stream into the engine's graph pool; ``module.fused_step.
capture``) and replayed after; ``compiles`` counts it once and it is
never retaken.  ``warmup()`` builds every prefill and (bb, mb) decode
bucket (and verify bucket when speculating, and (tp, mb) suffix-prefill
bucket with the prefix cache or chunks) at once.  Sampling stays
outside the graph (its generators are seeded on the host a row).  On the
CPU, and on CUDA with the private ``_graphs=False``, the same
executables run uncaptured.  The suffix prefill's ``start`` is a feed
like the others: B8 reads it as its per-row key limit from the card's
memory.  The draft LM's forward (its length is the context's) and the
copy-on-write page copies stay eager.  A plain step
whose next step's batch is provably this one's runs two steps back to
back, step t+1 fed from step t's tokens on the device while step t's
tokens travel to the host (the JAX engine's pipelined fetch,
``:3358-3460``; ``d2h_syncs_saved``).  ``swap_params`` copies new weights
into the served tensors between steps, so no graph is recaptured.

Features of the JAX engine outside this slice raise ``MXNetError("...
not ported yet")`` when asked for by argument or environment variable:
tp/pp/devices, ``prefill_only``, ``trace=``, ``canary=``,
``cost_records()`` and the ``cost_*`` statistics, ``import_stream``.
"""

from __future__ import annotations

import collections
import os
import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import slo as _slo
from .adapters import (AdapterPool, QuotaExceededError, TenantQuota,
                       adapters_enabled, pool_from_env, quota_from_env)
from .base import MXNetError, get_env, not_ported
from .context import current_context
from .convert import params_from_numpy, params_to_numpy
from .ndarray import torch_dtype
from .kv_cache import (KV_DTYPES, BlockAllocator, blocks_for_tokens,
                       bucket_ladder, kv_quantized, kv_storage_dtype,
                       trim_blocks)
from .models.transformer import TransformerLM, param_names
from .module.fused_step import add_launches, capture
from .prefix_cache import EVICT_POLICIES, PrefixCache
from .random import gumbel_noise, stream_key
from .speculative import PROPOSERS, make_proposer, verify_sample

__all__ = ["DecodeEngine", "InferenceEngine", "EngineClosedError",
           "sample_tokens"]

_DEFAULT_KV_BLOCK = 16
_DEFAULT_MAX_STREAMS = 64


class EngineClosedError(MXNetError):
    """Raised at wait by every future still outstanding when an engine
    shuts down or its serving loop dies, instead of blocking forever."""


def sample_tokens(logits: torch.Tensor, temps: np.ndarray,
                  seeds: np.ndarray, steps: np.ndarray,
                  engine_seed: int) -> torch.Tensor:
    """Greedy (temp 0) or temperature sampling of logits (B, V) on their
    device → (B,) int32.  Row i's draw is keyed by (engine_seed,
    seeds[i], steps[i]) (``random.stream_key``), so a stream samples the
    same tokens whatever batch it rides in."""
    toks = torch.argmax(logits, dim=-1)
    rows = np.nonzero(temps > 0)[0]
    if rows.size:
        keys = [stream_key(engine_seed, seeds[i], steps[i]) for i in rows]
        noise = gumbel_noise(keys, logits.shape[-1], logits.device)
        idx = torch.as_tensor(rows, device=logits.device)
        t = torch.as_tensor(temps[rows], dtype=torch.float32,
                            device=logits.device)
        toks[idx] = torch.argmax(logits[idx].float() / t[:, None] + noise,
                                 dim=-1)
    return toks.to(torch.int32)


def _env_int(name: str, default: int, lo: int) -> int:
    raw = get_env(name, None, str)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise MXNetError(f"{name}={raw!r} is not an integer")
    if v < lo:
        raise MXNetError(f"{name}={v} must be >= {lo}")
    return v


def _env_buckets(name: str, default):
    """CSV bucket ladder: strictly increasing positive ints."""
    raw = get_env(name, None, str)
    if raw is None:
        return default
    try:
        vals = [int(x) for x in raw.split(",") if x.strip()]
    except ValueError:
        raise MXNetError(f"{name}={raw!r} is not a comma-separated list "
                         f"of integers")
    if not vals or any(v < 1 for v in vals) \
            or any(b <= a for a, b in zip(vals, vals[1:])):
        raise MXNetError(f"{name}={raw!r} must be a strictly increasing "
                         f"ladder of positive ints")
    return vals


def _refuse_unported(*, tp, pp, devices) -> None:
    """Raise for every feature of the JAX engine this port does not
    carry yet, asked for by argument or by environment variable."""
    tp = tp if tp is not None else _env_int("MXNET_SERVING_TP", 1, 1)
    pp = pp if pp is not None else _env_int("MXNET_SERVING_PP", 1, 1)
    if int(tp) != 1 or int(pp) != 1 or devices is not None \
            or os.environ.get("MXNET_SERVING_DEVICES"):
        raise not_ported("model-parallel serving (tp / pp / devices / "
                         "MXNET_SERVING_TP / _PP / _DEVICES; queue A "
                         "item 10)")


def _prefix_salt(s) -> bytes:
    """The prefix-cache namespace of a stream: its adapter's name.  An
    adapter's K/V is a function of (tokens, adapter), so a prefix
    prefilled under adapter X never serves a plain stream or one of Y;
    plain streams keep the unsalted tree."""
    return s.adapter.encode("utf-8") if s.adapter else b""


class _Stats(dict):
    """``stats()``: a dict whose per-request cost keys (``cost_by_class``,
    ``cost_by_tenant``, ...) raise ``not_ported`` when read."""

    def __missing__(self, key):
        if isinstance(key, str) and key.startswith("cost_"):
            raise not_ported(f"per-request cost attribution (stats()"
                             f"[{key!r}]; the SLO tracker of queue A "
                             f"item 8)")
        raise KeyError(key)


class _Metrics:
    """Counters and bounded latency samples, read by ``stats()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.counters: Dict[str, float] = collections.defaultdict(float)
            self.samples: Dict[str, collections.deque] = \
                collections.defaultdict(
                    lambda: collections.deque(maxlen=65536))
            self.t0 = time.perf_counter()

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float):
        with self._lock:
            self.samples[name].append(float(value))

    def percentiles(self, name: str) -> Optional[dict]:
        with self._lock:
            vals = list(self.samples.get(name, ()))
        if not vals:
            return None
        p50, p90, p99 = np.percentile(vals, [50, 90, 99])
        return {"p50": float(p50), "p90": float(p90), "p99": float(p99),
                "count": len(vals)}


class _Stream:
    """One in-flight generation: host-side state the scheduler owns."""

    __slots__ = ("sid", "prompt", "max_new", "temp", "eos", "future",
                 "seed", "generated", "blocks", "length", "next_token",
                 "resume", "t_submit", "t_admit", "t_enqueue",
                 "cached_len", "await_first", "t_chunk0", "slo_class",
                 "tenant", "adapter", "adapter_bucket", "adapter_slot")

    def __init__(self, sid, prompt, max_new, temp, eos, future, seed,
                 slo_class="interactive", tenant=None, adapter=None):
        self.sid = sid
        self.prompt = prompt          # np.int32 (P,)
        self.max_new = max_new
        self.temp = temp
        self.eos = eos
        self.future = future
        self.seed = seed
        self.generated: List[int] = []
        self.blocks: List[int] = []   # page ids held (host block table)
        self.length = 0               # tokens currently cached
        self.next_token = -1          # sampled, not yet fed
        self.resume = False           # re-prefill after preemption
        self.t_submit = time.perf_counter()
        self.t_admit = 0.0
        self.t_enqueue = self.t_submit  # (re)joined the pending queue
        self.cached_len = 0           # prefix-cache tokens attached
        self.await_first = False      # full hit: first token pending
        self.t_chunk0 = 0.0           # chunked prefill: first chunk start
        self.slo_class = slo_class    # validated at submit()
        self.tenant = tenant          # quota and per-tenant counters key
        self.adapter = adapter        # published adapter name | None
        self.adapter_bucket = None    # rank bucket (set on acquire)
        self.adapter_slot = None      # pool slot, None once released

    def prefill_seq(self) -> np.ndarray:
        """Tokens whose K/V the cache must hold before the next decode
        step: the prompt, plus — after a preemption — every sampled
        token except the pending ``next_token``."""
        if not self.resume:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated[:-1], np.int32)])

    def done(self) -> bool:
        return (len(self.generated) >= self.max_new
                or (self.eos is not None and bool(self.generated)
                    and self.generated[-1] == self.eos))


# each feed's bytes start on this boundary of an executable's flat buffer
_FEED_ALIGN = 16


class _Executable:
    """One bucket of an engine: ``fn(bufs)`` (a model's forward up to its
    outputs) over input buffers this object owns.

    ``feeds`` [(name, shape[, numpy dtype, int32 by default])] are views
    ``bufs[name]`` of one flat device buffer of bytes, written by
    ``feed`` with one host-to-device copy from a pinned staging buffer
    (two alternate; a staging buffer is reused once its copy has run, so
    a feed may be queued behind a step that has not run yet).
    ``graphed`` (CUDA, the engine's ``_graphs``): the first ``run``
    performs the step eagerly on the engine's side stream, which loads
    every kernel and meets cuBLAS's per-stream state there, then
    captures ``fn`` on that stream into the engine's graph pool
    (``fused_step.capture``); each later ``run`` replays it into the
    output buffers the capture made and counts the captured launches
    again (``fused_step.add_launches``).  Uncaptured, ``run`` calls
    ``fn``.  A failed capture raises."""

    def __init__(self, engine, key, fn, feeds):
        self.key, self.fn = key, fn
        self.engine = engine
        dev = engine._device
        self.graphed = dev.type == "cuda" and engine._graphs
        self.slices, off = {}, 0
        for name, shape, *dt in feeds:
            dtype = np.dtype(dt[0] if dt else np.int32)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self.slices[name] = (off, nbytes, tuple(shape), dtype)
            off += -(-nbytes // _FEED_ALIGN) * _FEED_ALIGN
        self.buf = torch.zeros(off, dtype=torch.uint8, device=dev)
        self.bufs = {
            name: self.buf[o:o + n].view(
                torch.from_numpy(np.zeros(0, dt)).dtype).view(shape)
            for name, (o, n, shape, dt) in self.slices.items()}
        cuda = dev.type == "cuda"
        self.stage = [torch.zeros(off, dtype=torch.uint8, pin_memory=cuda)
                      for _ in range(2 if cuda else 1)]
        self.copied = [None] * len(self.stage)
        self.turn = 0
        self.graph = self.out = self.launches = None
        self.capture_ms, self.pool_bytes = 0.0, 0

    def feed(self, **arrays):
        """Every input's value (host arrays of the feeds' shapes), one
        copy to the device."""
        if set(arrays) != set(self.slices):
            raise MXNetError(f"executable {self.key}: feeds "
                             f"{sorted(arrays)}, want {sorted(self.slices)}")
        i = self.turn
        self.turn = (i + 1) % len(self.stage)
        if self.copied[i] is not None:
            self.copied[i].synchronize()  # its last copy has been read
        host = self.stage[i].numpy()
        for name, a in arrays.items():
            o, n, _, dt = self.slices[name]
            host[o:o + n].view(dt)[:] = np.asarray(a, dt).ravel()
        self.buf.copy_(self.stage[i], non_blocking=True)
        if self.buf.is_cuda:
            self.copied[i] = torch.cuda.Event()
            self.copied[i].record()

    def zeros(self):
        """Zero feeds of every input (a build's, or a warm-up's)."""
        return {n: np.zeros(shape, dt)
                for n, (_, _, shape, dt) in self.slices.items()}

    def run(self):
        """The step on the fed buffers → its outputs (a replay's: the
        graph's output buffers, overwritten by the next replay)."""
        if not self.graphed:
            return self.fn(self.bufs)
        if self.graph is None:
            with self.engine._compile_lock:
                if self.graph is None:
                    return self._first_run()
        self.graph.replay()
        add_launches(self.launches)
        return self.out

    def _first_run(self):
        eng = self.engine
        side = eng._side_stream()
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(self.bufs)
        main.wait_stream(side)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            t.record_stream(main)
        self.graph, self.out, self.launches, self.capture_ms, \
            self.pool_bytes = capture(lambda: self.fn(self.bufs), side,
                                      eng._graph_pool())
        return out


class _ExecutableHost:
    """What an engine's executables share: ``_device``, the private
    ``_graphs`` switch, ``_compile_lock``, ``_exe_cache`` / ``compiles``
    by key, one side stream and one CUDA-graph memory pool (its
    executables run one at a time, on one thread)."""

    def _init_executables(self, device, graphs: bool) -> None:
        self._device = device
        self._graphs = bool(graphs)
        self._exe_cache: Dict = {}
        self._compile_lock = threading.RLock()
        self.compiles: Dict = {}
        self._side = self._pool_handle = None

    def _side_stream(self):
        """The stream every capture of this engine warms up and captures
        on."""
        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        return self._side

    def _graph_pool(self):
        """The engine's one memory pool of CUDA graphs."""
        if self._pool_handle is None:
            self._pool_handle = torch.cuda.graph_pool_handle()
        return self._pool_handle

    def _executable(self, key, fn, feeds) -> _Executable:
        """The executable of ``key``, made at its first use and counted
        in ``compiles`` once."""
        exe = self._exe_cache.get(key)
        if exe is not None:
            return exe
        with self._compile_lock:
            exe = self._exe_cache.get(key)
            if exe is None:
                exe = _Executable(self, key, fn, feeds)
                self._exe_cache[key] = exe
                self.compiles[key] = self.compiles.get(key, 0) + 1
            return exe

    def _build(self, exe: _Executable) -> None:
        """Capture ``exe`` now (on CUDA) over zero feeds."""
        if exe.graphed and exe.graph is None:
            exe.feed(**exe.zeros())
            exe.run()

    def _graph_stats(self) -> dict:
        """The executables' CUDA graphs: captures, capture ms, pool
        growth."""
        with self._compile_lock:
            exes = list(self._exe_cache.values())
        caught = [e for e in exes if e.graph is not None]
        return {"graphs_on": self._device.type == "cuda" and self._graphs,
                "executables": len(exes), "captures": len(caught),
                "capture_ms": sum(e.capture_ms for e in caught),
                "pool_bytes": sum(e.pool_bytes for e in caught)}


class DecodeEngine(_ExecutableHost):
    """Continuous-batching autoregressive serving of a ``transformer_lm``
    over a paged KV cache.

    Parameters
    ----------
    params : dict
        Arrays or tensors by training-symbol name (``Module.get_params``
        of the JAX package, or ``params_from_numpy``).  They are moved to
        the engine's device in their own dtypes (a bf16 LM's stay bf16,
        its ``tok_embed_weight`` float32), and the model computes in
        ``pos_embed_weight``'s (``TransformerLM``).
    vocab_size, num_layers, num_heads, d_model, d_ff : int
        Architecture of the served model.
    max_len : int, optional
        Longest prompt+generation a stream may reach (default: the
        ``pos_embed_weight`` row count).
    kv_block : int
        Cache page size in tokens (env ``MXNET_SERVING_KV_BLOCK``,
        default 16), also the plain attention's block size.
    max_streams : int
        Concurrent-stream ceiling (env ``MXNET_SERVING_MAX_STREAMS``,
        default 64), the top of the decode batch ladder.
    cache_blocks : int, optional
        Pool pages (+1 scratch).  Default: every stream can reach
        ``max_len``; smaller trades memory for preemptions.
    decode_buckets, cache_buckets, prefill_buckets
        Explicit ladders (env ``MXNET_SERVING_DECODE_BUCKETS`` /
        ``_CACHE_BUCKETS`` / ``_PREFILL_BUCKETS``); default doubling.
    temperature : float
        Default sampling temperature (0 = greedy), per request
        overridable.
    ctx : Context, optional
        ``gpu(0)`` unless given; on a host without CUDA that raises —
        pass ``cpu()`` to run on the CPU.
    kv_dtype : str
        Pool storage (env ``MXNET_SERVING_KV_DTYPE``): ``'fp32'``
        (default), ``'bf16'``, or quantized ``'int8'`` / ``'fp8'``
        (e4m3) codes with float32 scale pools.
    dtype : str
        The pools' storage dtype while ``kv_dtype`` is ``'fp32'``
        (default ``"float32"``; ``"bfloat16"`` stores bf16 pages, as
        ``kv_dtype='bf16'`` does, ``"float16"`` fp16 pages).
    spec_tokens : int
        Speculative draft depth k (env ``MXNET_SERVING_SPEC_TOKENS``,
        default 0 = off): up to k + 1 tokens a stream per step.
    proposer : str or object
        Draft proposer (env ``MXNET_SERVING_PROPOSER``, default
        ``'ngram'``), or an object with ``propose(context, k)``.
    prefix_cache : int
        1 (default; env ``MXNET_SERVING_PREFIX_CACHE``): share the pages
        of common block-aligned prompt prefixes between streams; 0: each
        stream owns its pages.
    evict_policy : str
        ``'lru'`` (default; env ``MXNET_SERVING_EVICT``): keep retired
        streams' indexed pages parked for later hits, evicted least
        recently used first under pressure; ``'off'``: free them at
        once.
    prefill_chunk : int
        Chunk size in tokens (env ``MXNET_SERVING_PREFILL_CHUNK``, a
        multiple of ``kv_block``; default 0 = whole-prompt prefill).
    adapters : AdapterPool, True or None
        The LoRA adapter pool requests name adapters of (its slabs on
        the engine's device, its geometry the model's: ``num_layers``,
        ``d_model``, d_out ``3 * d_model``); True builds one from
        ``MXNET_ADAPTER_SLOTS`` / ``_RANK_BUCKETS``; None (default)
        follows ``MXNET_ADAPTER_ENABLE``.
    tenant_quota : TenantQuota, optional
        Per-tenant token buckets of admission (default: from
        ``MXNET_TENANT_QUOTA_TOKENS`` / ``_REFILL``, off at 0).

    The private keyword ``_graphs`` (default True) makes each executable
    a CUDA graph on a CUDA device; False runs the same executables
    uncaptured there (the graphed-against-eager comparisons).
    """

    def __init__(self, params, *, vocab_size, num_layers, num_heads,
                 d_model, d_ff=None, max_len=None, kv_block=None,
                 max_streams=None, cache_blocks=None, decode_buckets=None,
                 cache_buckets=None, prefill_buckets=None, temperature=0.0,
                 seed=0, eos_id=None, ctx=None, dtype="float32",
                 kv_dtype=None, prefix_cache=None, evict_policy=None,
                 spec_tokens=None, proposer=None, prefill_chunk=None,
                 tp=None, pp=None, devices=None, adapters=None,
                 tenant_quota=None, _graphs=True):
        _refuse_unported(tp=tp, pp=pp, devices=devices)
        self._graphs = bool(_graphs)
        self._kv_dtype = kv_dtype if kv_dtype is not None else \
            get_env("MXNET_SERVING_KV_DTYPE", "fp32", str)
        if self._kv_dtype not in KV_DTYPES:
            raise MXNetError(f"kv_dtype {self._kv_dtype!r} must be one of "
                             f"{KV_DTYPES} (MXNET_SERVING_KV_DTYPE)")
        # the pools' storage: ``dtype`` while kv_dtype is fp32, else the
        # kv_dtype's (mxnet_tpu/serving.py:1205-1208)
        pool_dtype = kv_storage_dtype(self._kv_dtype)
        if self._kv_dtype == "fp32":
            pool_dtype = torch_dtype(dtype)
            if pool_dtype not in (torch.float32, torch.bfloat16,
                                  torch.float16):
                raise not_ported(f"dtype={dtype!r} pages (the paged "
                                 f"kernels take float32, bfloat16 and "
                                 f"float16)")
        pc = prefix_cache if prefix_cache is not None else \
            _env_int("MXNET_SERVING_PREFIX_CACHE", 1, 0)
        if int(pc) not in (0, 1):
            raise MXNetError(f"MXNET_SERVING_PREFIX_CACHE={pc!r} must be 0 "
                             f"or 1")
        self._prefix_on = bool(int(pc))
        self._evict_policy = evict_policy if evict_policy is not None \
            else get_env("MXNET_SERVING_EVICT", "lru", str)
        if self._evict_policy not in EVICT_POLICIES:
            raise MXNetError(f"MXNET_SERVING_EVICT={self._evict_policy!r} "
                             f"must be one of {EVICT_POLICIES}")
        self._chunk = int(prefill_chunk) if prefill_chunk is not None \
            else _env_int("MXNET_SERVING_PREFILL_CHUNK", 0, 0)
        if self._chunk < 0:
            raise MXNetError(f"prefill_chunk {self._chunk} must be >= 0")
        self._spec_k = int(spec_tokens) if spec_tokens is not None else \
            _env_int("MXNET_SERVING_SPEC_TOKENS", 0, 0)
        if self._spec_k < 0:
            raise MXNetError(f"spec_tokens {self._spec_k} must be >= 0")
        ctx = ctx if ctx is not None else current_context()
        self._device = ctx.torch_device()  # gpu without CUDA raises
        if proposer is None or isinstance(proposer, str):
            name = proposer if proposer is not None else \
                get_env("MXNET_SERVING_PROPOSER", "ngram", str)
            if name not in PROPOSERS:
                raise MXNetError(f"MXNET_SERVING_PROPOSER={name!r} must be "
                                 f"one of {PROPOSERS}")
            self._proposer_name = name
            # a draft LM drafts on the engine's device
            kw = {"ctx": ctx} if name == "draft_lm" else {}
            self._proposer = make_proposer(name, **kw) if self._spec_k \
                else None
        else:  # a custom proposer instance
            if not callable(getattr(proposer, "propose", None)):
                raise MXNetError(f"proposer {proposer!r} must expose "
                                 f"propose(context, k) -> np.int32 tokens")
            self._proposer_name = type(proposer).__name__
            self._proposer = proposer

        self._L = int(num_layers)
        self._H = int(num_heads)
        if d_model % num_heads:
            raise MXNetError(f"d_model {d_model} % num_heads {num_heads} "
                             f"!= 0")
        self._D = int(d_model) // self._H
        self._kv_block = int(kv_block) if kv_block is not None else \
            _env_int("MXNET_SERVING_KV_BLOCK", _DEFAULT_KV_BLOCK, 1)
        if self._kv_block < 1:
            raise MXNetError(f"kv_block {self._kv_block} must be >= 1")
        if self._chunk % self._kv_block:
            raise MXNetError(
                f"MXNET_SERVING_PREFILL_CHUNK={self._chunk} must be a "
                f"multiple of kv_block {self._kv_block}: every chunk after "
                f"the first starts on a page boundary")
        self._max_streams = int(max_streams) if max_streams is not None \
            else _env_int("MXNET_SERVING_MAX_STREAMS",
                          _DEFAULT_MAX_STREAMS, 1)
        if self._max_streams < 1:
            raise MXNetError(f"max_streams {self._max_streams} must be "
                             f">= 1")

        if "pos_embed_weight" not in params:
            raise MXNetError(
                "params has no 'pos_embed_weight' — DecodeEngine serves "
                "the transformer_lm family")
        pos_rows = int(params["pos_embed_weight"].shape[0])
        self._max_len = int(max_len) if max_len is not None else pos_rows
        if self._max_len > pos_rows:
            raise MXNetError(
                f"max_len {self._max_len} exceeds the model's learned "
                f"positions ({pos_rows} pos_embed_weight rows)")
        # -- LoRA adapters and tenant quotas (mxnet_tpu/serving.py:1303-1350)
        if adapters is None:
            adapters = adapters_enabled()
        if adapters is True:
            adapters = pool_from_env(self._L, int(d_model), ctx=ctx)
        elif adapters is False:
            adapters = None
        if adapters is not None and not isinstance(adapters, AdapterPool):
            raise MXNetError(
                f"adapters must be an AdapterPool, True (build from "
                f"MXNET_ADAPTER_* env), or None; got {adapters!r}")
        self._adapter_pool = adapters
        if adapters is not None:
            if adapters.num_layers != self._L \
                    or adapters.d_model != int(d_model) \
                    or adapters.d_out != 3 * int(d_model):
                raise MXNetError(
                    f"AdapterPool geometry (layers={adapters.num_layers}, "
                    f"d_model={adapters.d_model}, d_out={adapters.d_out}) "
                    f"does not match the engine (layers={self._L}, d_model="
                    f"{int(d_model)}, d_out={3 * int(d_model)})")
            if adapters.device != self._device:
                raise MXNetError(
                    f"AdapterPool slabs lie on {adapters.device}; the "
                    f"engine serves on {self._device} (AdapterPool(ctx=))")
        self._lora = tuple(adapters.rank_buckets) if adapters is not None \
            else ()
        if tenant_quota is None:
            tenant_quota = quota_from_env()
        if tenant_quota is not None \
                and not isinstance(tenant_quota, TenantQuota):
            raise MXNetError(f"tenant_quota must be a TenantQuota or None; "
                             f"got {tenant_quota!r}")
        self._quota = tenant_quota
        # per-tenant requests / tokens / shed, at the global counters' sites
        self._tenants: Dict[str, Dict[str, float]] = {}
        # a draft LM that tokenizes otherwise would propose other ids
        if self._proposer is not None \
                and hasattr(self._proposer, "vocab_size") \
                and int(self._proposer.vocab_size) != int(vocab_size):
            raise MXNetError(
                f"draft_lm proposer vocab {self._proposer.vocab_size} "
                f"!= target vocab {int(vocab_size)} — draft and "
                f"target must share a tokenizer")

        dev_params = params_from_numpy(params, self._device, dtype=None)
        # the served tensors are the engine's own (swap_params writes
        # them in place): a caller's tensor already on the device is
        # copied
        for n, t in dev_params.items():
            v = params[n]
            if isinstance(v, torch.Tensor) and t.data_ptr() == v.data_ptr():
                dev_params[n] = t.clone()
        self._param_names = param_names(self._L)
        self._model = TransformerLM(dev_params, num_layers=self._L,
                                    num_heads=self._H,
                                    kv_block=self._kv_block, lora=self._lora)
        want = {"tok_embed_weight": (int(vocab_size), int(d_model))}
        if self._L:
            want["layer0_ff1_weight"] = (int(d_ff or 4 * d_model),
                                         int(d_model))
        for n, shape in want.items():
            got = tuple(dev_params[n].shape)
            if got != shape:
                raise MXNetError(f"param {n!r} has shape {got}; the engine "
                                 f"was told {shape}")

        self._max_blocks_seq = blocks_for_tokens(self._max_len,
                                                 self._kv_block)
        if cache_blocks is None:
            cache_blocks = 1 + self._max_streams * self._max_blocks_seq
        if int(cache_blocks) < 2:
            raise MXNetError(f"cache_blocks {cache_blocks} must be >= 2")
        self._alloc = BlockAllocator(int(cache_blocks), self._kv_block)
        self._prefix = PrefixCache(self._alloc, policy=self._evict_policy) \
            if self._prefix_on else None

        self._decode_buckets = tuple(
            decode_buckets if decode_buckets is not None else
            _env_buckets("MXNET_SERVING_DECODE_BUCKETS",
                         bucket_ladder(self._max_streams)))
        self._cache_buckets = tuple(
            cache_buckets if cache_buckets is not None else
            _env_buckets("MXNET_SERVING_CACHE_BUCKETS",
                         bucket_ladder(self._max_blocks_seq)))
        self._prefill_buckets = tuple(
            prefill_buckets if prefill_buckets is not None else
            _env_buckets("MXNET_SERVING_PREFILL_BUCKETS",
                         [b * self._kv_block
                          for b in bucket_ladder(self._max_blocks_seq)]))
        for pb in self._prefill_buckets:
            if pb % self._kv_block:
                raise MXNetError(
                    f"prefill bucket {pb} is not a multiple of kv_block "
                    f"{self._kv_block}")
        for lad, nm in ((self._decode_buckets, "decode_buckets"),
                        (self._cache_buckets, "cache_buckets"),
                        (self._prefill_buckets, "prefill_buckets")):
            if any(b <= a for a, b in zip(lad, lad[1:])) or lad[0] < 1:
                raise MXNetError(f"bad {nm} ladder {lad}")
        if self._decode_buckets[-1] < self._max_streams:
            raise MXNetError(f"decode_buckets {self._decode_buckets} does "
                             f"not cover max_streams {self._max_streams}")
        if self._cache_buckets[-1] < self._max_blocks_seq:
            raise MXNetError(
                f"cache_buckets {self._cache_buckets} does not cover the "
                f"{self._max_blocks_seq} pages a max_len stream holds")
        if self._chunk > self._prefill_buckets[-1]:
            raise MXNetError(
                f"prefill_chunk {self._chunk} exceeds the largest prefill "
                f"bucket {self._prefill_buckets[-1]}: chunks are bucketed "
                f"through the prefill ladder")

        # per layer [k, v] or, quantized, [k, v, k_scale, v_scale]; the
        # scale pools start at ones (the JAX engine's), the values at 0
        pool_shape = (int(cache_blocks), self._kv_block, self._H, self._D)
        self._pools = []
        for _ in range(self._L):
            for _ in range(2):
                self._pools.append(torch.zeros(pool_shape, dtype=pool_dtype,
                                               device=self._device))
            if kv_quantized(self._kv_dtype):
                for _ in range(2):
                    self._pools.append(torch.ones(
                        pool_shape[:3], dtype=torch.float32,
                        device=self._device))
        self._pool_bytes = sum(p.numel() * p.element_size()
                               for p in self._pools)

        self._seed = int(seed)
        self._temperature = float(temperature)
        self._eos = eos_id
        # the executables (mxnet_tpu/serving.py:1426-1428): by key, and
        # how many times each key was built (once)
        self._init_executables(self._device, self._graphs)
        self._metrics = _Metrics()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Stream] = []
        self._active: List[_Stream] = []
        self._admitting: Optional[_Stream] = None
        self._prefilling: Optional[_Stream] = None  # mid-chunked-prefill
        # adapter salts whose prefix chains the scheduler drops before
        # its next admission (publish / retire of the adapter)
        self._prefix_dirty: List[bytes] = []
        # calls waiting for the scheduler thread's next iteration
        # (swap_params, get_params)
        self._calls: List[tuple] = []
        self._accepting = True
        self._alive = True
        self._next_sid = 0

        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="mxnet_tpu_torch-serving-decode")
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, temperature=None,
               eos_id=None, seed=None, trace=None, slo_class="interactive",
               canary=False, prefill_only=False, tenant=None,
               adapter=None) -> Future:
        """Enqueue one generation; the Future resolves to the np.int32
        array of generated token ids (eos, when hit, included).

        ``seed`` overrides the stream's sampling seed (default: the
        engine-local stream id + 1); sampling is keyed by (engine seed,
        stream seed, position).  ``slo_class`` (``"interactive"``, the
        default, or ``"batch"``): an interactive request is admitted
        ahead of batch ones, and batch streams are preempted first.
        ``tenant`` charges prompt + ``max_new_tokens`` tokens to the
        tenant's quota (``QuotaExceededError`` when it cannot pay,
        counted under ``shed_tenant_quota``); ``adapter`` names a
        published adapter of the engine's pool, whose reference the
        stream holds until it ends."""
        _slo.check_class(slo_class)
        if canary:
            raise not_ported("canary probes (submit(canary=True); the SLO "
                             "tracker of queue A item 8)")
        if prefill_only:
            raise not_ported("prefill_only stream export (disaggregated "
                             "serving, queue A item 10)")
        if trace is not None:
            raise not_ported("request tracing (trace=; profiler spans, "
                             "queue A item 8)")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise MXNetError(f"prompt must be a non-empty 1-D token array; "
                             f"got shape {prompt.shape}")
        prompt = prompt.astype(np.int32)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise MXNetError(f"max_new_tokens {max_new} must be >= 1")
        total = prompt.size + max_new
        if total > self._max_len:
            raise MXNetError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) = "
                f"{total} exceeds max_len {self._max_len}")
        if prompt.size > self._prefill_buckets[-1] and not self._chunk:
            raise MXNetError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill bucket {self._prefill_buckets[-1]} (enable "
                f"MXNET_SERVING_PREFILL_CHUNK to prefill it in chunks)")
        need = blocks_for_tokens(total, self._kv_block)
        if need > self._alloc.capacity:
            raise MXNetError(f"request needs {need} cache blocks but the "
                             f"pool only has {self._alloc.capacity}")
        # tenancy: the quota's charge and the adapter's reference, before
        # the stream takes any engine state (mxnet_tpu/serving.py:1550-1602)
        if adapter is not None and self._adapter_pool is None:
            raise MXNetError(
                f"request names adapter {adapter!r} but the engine has no "
                f"adapter pool (MXNET_ADAPTER_ENABLE=1 or "
                f"adapters=AdapterPool(...))")
        tenant = str(tenant) if tenant is not None else None
        charged = self._quota is not None and tenant is not None
        if charged:
            try:
                self._quota.charge(tenant, prompt.size + max_new)
            except QuotaExceededError:
                self._metrics.inc("shed")
                self._metrics.inc("shed_tenant_quota")
                self._tenant_count(tenant, "shed")
                raise
        ad_bucket = ad_slot = None
        try:
            if adapter is not None:
                ad_bucket, ad_slot = self._adapter_pool.acquire(adapter)
            temp = self._temperature if temperature is None \
                else float(temperature)
            eos = self._eos if eos_id is None else eos_id
            fut: Future = Future()
            with self._cond:
                if not self._accepting:
                    raise EngineClosedError("DecodeEngine is closed")
                s = _Stream(self._next_sid, prompt, max_new, temp, eos, fut,
                            seed=(self._next_sid + 1 if seed is None
                                  else int(seed)), slo_class=slo_class,
                            tenant=tenant, adapter=adapter)
                s.adapter_bucket, s.adapter_slot = ad_bucket, ad_slot
                self._next_sid += 1
                self._pending.append(s)
                self._cond.notify_all()
        except BaseException:
            if ad_slot is not None:  # refused: hand the reference back
                self._adapter_pool.release(adapter)
            if charged:
                self._quota.refund(tenant, prompt.size + max_new)
            raise
        self._metrics.inc("requests")
        self._tenant_count(tenant, "requests")
        return fut

    @property
    def model(self) -> TransformerLM:
        """The served model, its parameters on the engine's device."""
        return self._model

    def generate(self, prompt, max_new_tokens=32, **kw) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(prompt, max_new_tokens, **kw).result()

    def swap_params(self, params):
        """Live weight swap, by the JAX engine's rules
        (``mxnet_tpu/serving.py:1640-1688``): every served name must be in
        ``params`` (an error naming what is "missing"), each value of the
        served shape (an error naming the "shape"), and values are cast
        to the served dtypes.  Everything is checked first, so a swap
        that fails installs nothing.  The values are then copied into the
        served tensors on the scheduler thread between two steps: no step
        sees two weight versions, no executable is rebuilt and
        ``compiles`` does not change.  The prefix cache's chains, whose
        pages hold the old weights' K/V, stop being matchable then.
        Returns once installed."""
        missing = [n for n in self._param_names if n not in params]
        if missing:
            raise MXNetError(f"swap_params: params missing {missing}")
        served = dict(self._model.named_parameters())
        new = {}
        for n in self._param_names:
            t = params_from_numpy({n: params[n]}, "cpu", dtype=None)[n]
            old = served[n]
            if tuple(t.shape) != tuple(old.shape):
                raise MXNetError(
                    f"swap_params: param {n!r} shape {tuple(t.shape)} != "
                    f"serving shape {tuple(old.shape)}")
            new[n] = t.to(old.dtype)

        def install():
            with torch.no_grad():
                for n, t in new.items():
                    served[n].copy_(t)
            if self._prefix is not None:
                self._prefix.invalidate_all()

        self._between_steps(install)

    def get_params(self) -> dict:
        """Host snapshot of the served weights (``params_to_numpy``: numpy
        arrays, bf16 as ``HostBF16``), taken between two steps: the
        rollback anchor a failed swap restores from."""
        out = {}

        def snapshot():
            out.update(params_to_numpy(dict(self._model.named_parameters())))

        self._between_steps(snapshot)
        return out

    def _between_steps(self, fn) -> None:
        """Run ``fn`` on the scheduler thread at its next iteration (between
        two steps) and wait for it; here when the loop has stopped."""
        if threading.current_thread() is self._thread:
            fn()
            return
        fut: Future = Future()
        with self._cond:
            queued = self._alive and self._thread.is_alive()
            if queued:
                self._calls.append((fn, fut))
                self._cond.notify_all()
        if not queued:
            fn()
            return
        fut.result()

    def _run_calls(self) -> None:
        with self._cond:
            calls, self._calls = self._calls, []
        for fn, fut in calls:
            try:
                fn()
            except BaseException as exc:
                fut.set_exception(exc)
            else:
                fut.set_result(None)

    def warmup(self):
        """Build every prefill bucket and every (batch, cache) decode
        bucket now, every verify bucket when speculating, and, with the
        prefix cache or chunked prefill on, every (suffix, table) bucket
        of the suffix prefill whose table holds the suffix, as the JAX
        engine compiles them (``mxnet_tpu/serving.py:1742``): a bucket
        built inside the serving loop stalls every active stream for its
        capture.  On CUDA each is captured after one step on zero feeds
        (lengths 0: its cache writes land on the scratch page)."""
        for tp in self._prefill_buckets:
            self._build(self._prefill_exe(tp))
        for bb in self._decode_buckets:
            for mb in self._cache_buckets:
                self._build(self._decode_exe(bb, mb))
                if self._spec_k:
                    self._build(self._verify_exe(bb, mb))
        if self._prefix is not None or self._chunk:
            for tp in self._prefill_buckets:
                for mb in self._cache_buckets:
                    if mb * self._kv_block >= tp:
                        self._build(self._prefix_prefill_exe(tp, mb))

    def cost_records(self):
        raise not_ported("per-request cost records (cost_records(); the "
                         "SLO tracker of queue A item 8)")

    def publish_adapter(self, name, a, b, alpha=None) -> int:
        """Install a LoRA adapter under ``name``, hot: the pool writes a
        free or parked slot's rows in place (no drain, no stream
        disturbed) and the name's old prefix chains are dropped before
        the next admission.  Returns the slot."""
        if self._adapter_pool is None:
            raise MXNetError(
                "publish_adapter: this engine has no adapter pool "
                "(construct with adapters=..., or set "
                "MXNET_ADAPTER_ENABLE=1)")
        slot = self._adapter_pool.publish(name, a, b, alpha=alpha)
        # a retire-then-republish binds new weights to the name: chains
        # prefilled under the old ones (the name is the salt) must stop
        # matching
        self._queue_prefix_invalidate(name)
        self._metrics.inc("adapter_publishes")
        return slot

    def retire_adapter(self, name) -> bool:
        """Retire an adapter, hot: the name stops being acquirable at
        once and its slot frees when its last stream ends; its prefix
        chains are dropped.  True when the slot freed now."""
        if self._adapter_pool is None:
            raise MXNetError(
                "retire_adapter: this engine has no adapter pool")
        freed = self._adapter_pool.retire(name)
        self._queue_prefix_invalidate(name)
        self._metrics.inc("adapter_retires")
        return freed

    def _queue_prefix_invalidate(self, name) -> None:
        """Queue the salt invalidation of adapter ``name`` for the
        scheduler thread, which owns the radix index; it is applied at
        the next admission pass, before any request submitted after this
        call is admitted."""
        if self._prefix is None:
            return
        with self._cond:
            self._prefix_dirty.append(str(name).encode("utf-8"))
            self._cond.notify_all()

    def _tenant_count(self, tenant, name, value=1) -> None:
        """Per-tenant requests / tokens / shed, at the sites of the
        engine-wide counters."""
        if tenant is None:
            return
        with self._lock:
            d = self._tenants.setdefault(tenant, {})
            d[name] = d.get(name, 0) + value

    def import_stream(self, *args, **kwargs):
        raise not_ported("KV-page stream import (import_stream; the "
                         "fleet, queue A item 10)")

    def reset_stats(self) -> None:
        """Zero the counters and latency samples so the next
        :meth:`stats` covers only work from here on; the prefix cache's
        index and pages are untouched."""
        self._metrics.reset()
        with self._lock:
            self._tenants.clear()
        if self._prefix is not None:
            self._prefix.reset_counters()

    def stats(self) -> dict:
        m = self._metrics
        with m._lock:
            c = dict(m.counters)
            wall = time.perf_counter() - m.t0
        out = _Stats({k: int(c.get(k, 0)) for k in
                      ("requests", "generations", "tokens", "prefill_tokens",
                       "preempted", "prefills", "steps", "stream_steps",
                       "prefill_chunks", "spec_steps", "spec_proposed",
                       "spec_accepted", "spec_pages_rolled_back",
                       "d2h_syncs", "d2h_syncs_saved", "shed",
                       "shed_tenant_quota", "adapter_publishes",
                       "adapter_retires")})
        # how much of what the proposer offered was verified, and how
        # many tokens one target evaluation of one stream commits (1.0
        # without speculation; up to spec_tokens + 1)
        out["accepted_token_rate"] = round(
            out["spec_accepted"] / out["spec_proposed"], 4) \
            if out["spec_proposed"] else 0.0
        out["tokens_per_step"] = round(
            out["tokens"] / out["stream_steps"], 4) \
            if out["stream_steps"] else 0.0
        out["spec_tokens"] = self._spec_k
        out["proposer"] = self._proposer_name if self._spec_k else None
        out["prefill_chunk"] = self._chunk
        # ttft_hit / ttft_miss: the first token of a prefix-cache hit
        # (suffix prefill or full hit) and of a miss
        for name, key in (("time_per_token_ms", ""), ("ttft_ms", "ttft_"),
                          ("ttft_hit_ms", "ttft_hit_"),
                          ("ttft_miss_ms", "ttft_miss_"),
                          ("step_ms", "step_"), ("prefill_ms", "prefill_"),
                          ("prefill_chunk_ms", "prefill_chunk_"),
                          ("queue_wait_ms", "queue_wait_")):
            h = m.percentiles(name)
            for q in ("p50", "p90", "p99"):
                out[f"{key}{q}_ms"] = h[q] if h else None
        out["tokens_per_s"] = out["tokens"] / wall if wall > 0 else 0.0
        out["cache_util"] = self._alloc.utilization()
        out["cache_blocks_free"] = self._alloc.free_blocks
        out["cache_blocks_cached"] = self._alloc.parked_blocks
        out["shared_blocks"] = self._alloc.shared_blocks
        out["kv_dtype"] = self._kv_dtype
        out["prefix_cache"] = int(self._prefix_on)
        if self._prefix is not None:
            out.update(self._prefix.stats())
            admissions = out["prefills"] + self._prefix.full_hits
            out["prefix_hit_rate"] = round(
                self._prefix.hits / admissions, 4) if admissions else 0.0
        out["pool_bytes"] = self._pool_bytes
        with self._lock:
            out["active_streams"] = len(self._active)
            out["pending"] = len(self._pending)
        out["decode_buckets"] = list(self._decode_buckets)
        out["cache_buckets"] = list(self._cache_buckets)
        out["prefill_buckets"] = list(self._prefill_buckets)
        out["kv_block"] = self._kv_block
        out["device"] = str(self._device)
        # the executables built, by key as the JAX engine prints them,
        # and their CUDA graphs: captures, capture ms, pool growth
        with self._compile_lock:
            out["compiles"] = {str(k): v for k, v in self.compiles.items()}
        out["graphs"] = self._graph_stats()
        # tenancy: per-tenant requests / tokens / shed and the quota's
        # balances; the adapter pool's counters
        with self._lock:
            out["tenants"] = {t: dict(d) for t, d in self._tenants.items()}
        if self._quota is not None:
            for t, q in self._quota.stats().items():
                out["tenants"].setdefault(t, {}).update(q)
        if self._adapter_pool is not None:
            out["adapters"] = self._adapter_pool.stats()
            out["adapter_rank_buckets"] = list(self._lora)
        return out

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Stop accepting work and fail every outstanding generation with
        :class:`EngineClosedError` at the next step boundary."""
        with self._cond:
            if not self._alive:
                return
            self._accepting = False
            self._alive = False
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # the loop still owns _active and the allocator mid-step; its
            # finally clause fails the outstanding futures instead
            return
        self._fail_outstanding(EngineClosedError("DecodeEngine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(timeout=1.0)
        except Exception:
            pass

    def _fail_outstanding(self, exc):
        with self._lock:
            streams = self._pending + self._active
            if self._admitting is not None:
                if self._admitting not in streams:
                    streams.append(self._admitting)
                self._admitting = None
            # a stream mid-chunked-prefill is in neither list either
            if self._prefilling is not None:
                if self._prefilling not in streams:
                    streams.append(self._prefilling)
                self._prefilling = None
            self._pending, self._active = [], []
            calls, self._calls = self._calls, []
        for _, fut in calls:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
        for s in streams:
            if s.blocks:
                self._release_pages(s.blocks)
                s.blocks = []
            self._release_adapter(s)
            if s.future.set_running_or_notify_cancel():
                s.future.set_exception(exc)

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def _bucket(self, ladder, n, what):
        for b in ladder:
            if b >= n:
                return b
        raise MXNetError(f"{what} {n} exceeds ladder {ladder}")

    # ------------------------------------------------------------------
    # executables (mxnet_tpu/serving.py:2002-2171)
    # ------------------------------------------------------------------
    @staticmethod
    def _exe_key(base: tuple, used: tuple) -> tuple:
        """The JAX engine's key, plus the rank buckets the batch's adapter
        rows use (a bucket without a row runs no epilogue, and a batch
        without an adapter the pre-adapter ops: another program)."""
        return base + ((("lora",) + tuple(used)),) if used else base

    def _exe_adapter(self, bufs, used: tuple) -> tuple:
        """The model's ``adapter`` arguments over the slot ids in
        ``bufs`` (``slots{rb}``) of the rank buckets ``used``."""
        if not used:
            return ()
        slabs = self._adapter_pool.slabs()
        out = []
        for j, rb in enumerate(self._lora):
            out += [slabs[2 * j], slabs[2 * j + 1],
                    bufs[f"slots{rb}"] if rb in used else None]
        return tuple(out)

    def _adapter_slots(self, streams, bb: int):
        """({"slots{rb}": (bb,) slot ids}, used rank buckets) of one
        forward over ``streams`` padded to ``bb`` rows: a bucket is used
        when a row sits in it (0 for the other rows, pad rows included);
        none without an adapter in the batch."""
        if not self._lora or not any(s.adapter_slot for s in streams):
            return {}, ()
        vecs = {}
        for rb in self._lora:
            vec = np.zeros(bb, np.int32)
            for i, s in enumerate(streams):
                if s.adapter_slot is not None and s.adapter_bucket == rb:
                    vec[i] = s.adapter_slot
            if vec.any():
                vecs[f"slots{rb}"] = vec
        return vecs, tuple(rb for rb in self._lora if f"slots{rb}" in vecs)

    @staticmethod
    def _slot_feeds(bb: int, used: tuple) -> list:
        return [(f"slots{rb}", (bb,)) for rb in used]

    def _decode_exe(self, bb: int, mb: int, used: tuple = ()):
        """The plain step at batch bucket ``bb`` x table bucket ``mb``."""
        def fn(b):
            return self._model.decode(b["tokens"], b["positions"],
                                      b["lengths"], b["table"], self._pools,
                                      self._exe_adapter(b, used))

        return self._executable(
            self._exe_key(("decode", bb, mb), used), fn,
            [("tokens", (bb, 1)), ("positions", (bb, 1)),
             ("lengths", (bb,)), ("table", (bb, mb))]
            + self._slot_feeds(bb, used))

    def _verify_exe(self, bb: int, mb: int, used: tuple = ()):
        """The speculative verify step at ``bb`` x ``mb``: W = 1 +
        spec_tokens rows a stream (keyed apart from the plain step, the
        zero-draft fast path)."""
        W = self._spec_k + 1

        def fn(b):
            return self._model.verify(b["tokens"], b["positions"],
                                      b["start"], b["lengths"], b["table"],
                                      self._pools,
                                      self._exe_adapter(b, used))

        return self._executable(
            self._exe_key(("verify", bb, mb, W), used), fn,
            [("tokens", (bb, W)), ("positions", (bb, W)), ("start", (bb,)),
             ("lengths", (bb,)), ("table", (bb, mb))]
            + self._slot_feeds(bb, used))

    def _prefill_exe(self, tp: int, used: tuple = ()):
        """A miss's prefill at prompt bucket ``tp`` (its table tp / kv_block
        pages)."""
        mb = tp // self._kv_block

        def fn(b):
            return self._model.prefill(b["tokens"], b["positions"],
                                       b["lengths"], b["table"], self._pools,
                                       self._exe_adapter(b, used))

        return self._executable(
            self._exe_key(("prefill", tp), used), fn,
            [("tokens", (1, tp)), ("positions", (1, tp)), ("lengths", (1,)),
             ("table", (1, mb))] + self._slot_feeds(1, used))

    def _prefix_prefill_exe(self, tp: int, mb: int, used: tuple = ()):
        """A suffix prefill (a prefix hit's suffix, a chunk) at suffix
        bucket ``tp`` over table bucket ``mb`` (prefix and suffix pages):
        ``start`` is a feed, B8's key limit on the device
        (``mxnet_tpu/serving.py:2235``)."""
        def fn(b):
            return self._model.suffix_prefill(
                b["tokens"], b["positions"], b["start"], b["lengths"],
                b["table"], self._pools, self._exe_adapter(b, used))

        return self._executable(
            self._exe_key(("prefix_prefill", tp, mb), used), fn,
            [("tokens", (1, tp)), ("positions", (1, tp)), ("start", (1,)),
             ("lengths", (1,)), ("table", (1, mb))]
            + self._slot_feeds(1, used))

    # ------------------------------------------------------------------
    # page accounting: the one funnel for alloc and release
    # ------------------------------------------------------------------
    def _palloc(self, n: int, owner=None) -> Optional[List[int]]:
        """Allocate pages; with the prefix cache on, parked (cached)
        pages are evicted LRU when the free list runs dry."""
        if self._prefix is not None:
            return self._prefix.alloc(n, owner=owner)
        return self._alloc.alloc(n, owner=owner)

    def _release_pages(self, pages: List[int]) -> None:
        """Detach a stream from its pages: exclusive pages free, shared
        pages drop one reference, indexed pages park for later hits."""
        if not pages:
            return
        if self._prefix is not None:
            self._prefix.release(pages)
        else:
            self._alloc.free(pages)

    def _loop(self):
        try:
            while True:
                with self._cond:
                    while self._alive and not self._pending \
                            and not self._active \
                            and self._prefilling is None \
                            and not self._calls:
                        self._cond.wait(timeout=0.5)
                    if not self._alive:
                        return
                self._run_calls()
                self._admit()
                if self._prefilling is not None:
                    # one chunk an iteration: the decode step below runs
                    # between chunks, so a long prompt does not stall
                    # every active stream for its whole prefill
                    self._prefill_chunk()
                if self._active:
                    self._step()
                elif self._pending and self._prefilling is None:
                    # head-of-line request cannot be admitted and nothing
                    # decodes (a submit racing the loop): don't spin
                    with self._cond:
                        self._cond.wait(timeout=0.05)
        except BaseException as exc:
            self._shut_door()
            self._fail_outstanding(EngineClosedError(
                f"DecodeEngine serving loop died: {exc!r}"))
            raise
        finally:
            self._shut_door()
            self._fail_outstanding(EngineClosedError("DecodeEngine closed"))

    def _shut_door(self):
        with self._cond:
            self._accepting = False
            self._alive = False
            self._cond.notify_all()

    def _admit(self):
        """Join pending requests, FIFO, while the pool holds the
        prompt's new pages plus one block of decode headroom (capped at
        the stream's lifetime need of new pages, so a request sized
        exactly to the pool still admits).

        With the prefix cache on, the longest cached block-aligned
        prefix is attached (pages shared by refcount, parked pages
        revived) and only the suffix needs new pages and prefill; parked
        matches are about to be revived, so they are not spare capacity.
        A fully cached prompt skips prefill (``_full_hit``).  A prompt
        whose uncached part exceeds ``prefill_chunk`` is handed to the
        chunk state machine, charged only its first chunk's pages."""
        kvb = self._kv_block
        if self._prefix is not None and self._prefix_dirty:
            # adapter publishes / retires queued salt invalidations: here,
            # on the thread that owns the index, before any later request
            with self._cond:
                dirty, self._prefix_dirty = self._prefix_dirty, []
            for salt in dirty:
                self._prefix.invalidate_salt(salt)
        while True:
            with self._lock:
                if not self._pending \
                        or len(self._active) >= self._max_streams \
                        or self._prefilling is not None:
                    return
                # SLO tiers: the first interactive request goes ahead of
                # batch ones, FIFO within a class
                pick = next((i for i, c in enumerate(self._pending)
                             if c.slo_class == "interactive"), 0)
                s = self._pending[pick]
                seq = s.prefill_seq()
                cached, parked_matched = self._prefix.peek(
                    seq, salt=_prefix_salt(s)) \
                    if self._prefix is not None else (0, 0)
                chunked = bool(self._chunk) \
                    and len(seq) - cached > self._chunk
                if chunked:
                    need = blocks_for_tokens(self._chunk, kvb)
                elif cached:  # block-aligned: 0 new pages on a full hit
                    need = blocks_for_tokens(len(seq) - cached, kvb)
                else:
                    need = blocks_for_tokens(max(len(seq), 1), kvb)
                lifetime = blocks_for_tokens(len(s.prompt) + s.max_new, kvb)
                lifetime_new = max(lifetime - cached // kvb, 0)
                avail = self._alloc.free_blocks - parked_matched
                if avail < min(need + 1, max(lifetime_new, 1)):
                    return  # not enough cache: hold the line
                self._pending.pop(pick)
                self._admitting = s  # visible to _fail_outstanding
            cached, pages = self._prefix.attach(
                seq, owner=s.sid, salt=_prefix_salt(s)) \
                if self._prefix is not None else (0, [])
            s.blocks = pages  # held now: a dying prefill must not leak
            s.cached_len = cached
            if chunked:
                s.length = cached  # tokens cached so far
                self._prefilling = s
                self._admitting = None
                return
            new = self._palloc(need, owner=s.sid)
            if new is None:  # pragma: no cover - checked just above
                raise MXNetError(f"admission raced the allocator: {need} "
                                 f"pages unavailable")
            s.blocks = pages + new
            if cached and cached == len(seq):
                self._full_hit(s, seq)
            else:
                self._prefill(s, seq)
            self._admitting = None

    def _full_hit(self, s: _Stream, seq: np.ndarray):
        """Admission of a fully cached prompt: no prefill.  A fresh
        stream re-enters decode at its last prompt token, whose step
        recomputes that token's K/V (the write copies the shared tail
        page first) and samples the first new token; a resumed stream's
        pending token survives, so it continues where preemption cut
        it."""
        self._prefix.full_hits += 1
        if s.resume:
            s.length = len(seq)
            s.resume = False
        else:
            s.length = len(seq) - 1
            s.next_token = int(seq[-1])
            s.await_first = True  # first token (and TTFT) at its step
        now = time.perf_counter()
        self._metrics.observe("queue_wait_ms", (now - s.t_enqueue) * 1e3)
        s.t_admit = now
        with self._lock:
            self._active.append(s)

    def _run_prefill(self, s: _Stream, seq: np.ndarray, done: int,
                     end: int, what: str, suffix: bool) -> torch.Tensor:
        """The B = 1 forward over ``seq[done:end]`` padded to its prefill
        bucket; rows past ``end`` write to the scratch page and are never
        read.  A whole-prompt miss runs ``TransformerLM.prefill`` over
        its bucket's pages; with ``suffix`` (a prefix hit's suffix, every
        chunk of a chunked prefill) ``suffix_prefill`` runs over the
        cached pages (``done`` block-aligned).  Returns the logits of the
        real rows."""
        csize = end - done
        tp = self._bucket(self._prefill_buckets, csize, what)
        mb = self._bucket(self._cache_buckets, len(s.blocks),
                          "cache blocks") if suffix else tp // self._kv_block
        tokens = np.zeros((1, tp), np.int32)
        tokens[0, :csize] = seq[done:end]
        positions = (done + np.arange(tp, dtype=np.int32))[None]
        lengths = np.asarray([end], np.int32)
        table = np.zeros((1, mb), np.int32)
        table[0, :len(s.blocks)] = s.blocks
        slots, used = self._adapter_slots([s], 1)
        if suffix:
            exe = self._prefix_prefill_exe(tp, mb, used)
            exe.feed(tokens=tokens, positions=positions,
                     start=np.asarray([done], np.int32), lengths=lengths,
                     table=table, **slots)
        else:
            exe = self._prefill_exe(tp, used)
            exe.feed(tokens=tokens, positions=positions, lengths=lengths,
                     table=table, **slots)
        logits = exe.run()
        return logits[:, :csize]

    def _sample_first(self, s: _Stream, row: torch.Tensor, n: int) -> int:
        """Sample the stream's token at position ``n - 1`` from its
        logits row and copy it to the host (the prefill's one copy)."""
        toks = sample_tokens(row, np.asarray([s.temp]), np.asarray([s.seed]),
                             np.asarray([n - 1]), self._seed)
        first = int(toks.cpu()[0])
        self._metrics.inc("d2h_syncs")
        return first

    def _prefill(self, s: _Stream, seq: np.ndarray):
        """Prefill one stream: a miss runs the whole prompt, a prefix hit
        only the uncached suffix over the attached pages."""
        n, c = len(seq), s.cached_len
        t0 = time.perf_counter()
        logits = self._run_prefill(s, seq, c, n, "suffix length" if c
                                   else "prompt length", suffix=bool(c))
        first = self._sample_first(s, logits[:, -1], n)
        s.length = n
        self._finish_prefill(s, first, n - c, c, t0, time.perf_counter())

    def _prefill_chunk(self):
        """Advance the in-flight chunked prefill by one chunk, a suffix
        prefill at offset ``s.length``.  A chunk that cannot get its
        pages waits for the next iteration (decode retirements refill
        the pool); only the final chunk samples and fetches its token,
        so the others leave the loop free to queue the decode step
        behind them."""
        s = self._prefilling
        seq = s.prefill_seq()
        n, done = len(seq), s.length
        end = min(done + self._chunk, n)
        need = blocks_for_tokens(end, self._kv_block) - len(s.blocks)
        if need > 0:
            pages = self._palloc(need, owner=s.sid)
            if pages is None:
                return  # pool dry: retry after the next decode step
            s.blocks.extend(pages)
        t0 = time.perf_counter()
        if done == s.cached_len:
            s.t_chunk0 = t0  # first chunk: queue wait ends here
        logits = self._run_prefill(s, seq, done, end, "chunk length",
                                   suffix=True)
        if end >= n:
            first = self._sample_first(s, logits[:, -1], n)
        t_done = time.perf_counter()
        self._metrics.inc("prefill_chunks")
        self._metrics.observe("prefill_chunk_ms", (t_done - t0) * 1e3)
        s.length = end
        if end < n:
            return  # more chunks; a decode step runs in between
        self._prefilling = None
        self._finish_prefill(s, first, n - s.cached_len, s.cached_len,
                             s.t_chunk0, t_done)

    def _finish_prefill(self, s: _Stream, first: int, ns: int, c: int,
                        t0: float, t_done: float):
        """The completion of every prefill (whole, suffix, last chunk):
        the prompt's full pages enter the prefix index, the timing and
        TTFT metrics, the first token, then activation or retirement.
        ``ns`` tokens were prefilled, ``c`` were attached."""
        if self._prefix is not None:
            # blocks already indexed keep their page; ours stays private
            self._prefix.register(s.prompt, s.blocks, salt=_prefix_salt(s))
        self._metrics.observe("prefill_ms", (t_done - t0) * 1e3)
        self._metrics.observe("queue_wait_ms", (t0 - s.t_enqueue) * 1e3)
        s.t_admit = t_done
        if s.resume:
            s.resume = False  # next_token survives preemption
        else:
            s.next_token = first
            s.generated.append(first)
            s.await_first = False
            ttft = (t_done - s.t_submit) * 1e3
            self._metrics.observe("ttft_ms", ttft)
            self._metrics.observe("ttft_hit_ms" if c else "ttft_miss_ms",
                                  ttft)
            self._metrics.inc("tokens")
        self._metrics.inc("prefills")
        self._metrics.inc("prefill_tokens", ns)  # uncached tokens only
        if s.done():  # max_new == 1 or instant eos
            self._retire(s)
        else:
            with self._lock:
                self._active.append(s)

    def _reclaimable(self, v: _Stream) -> int:
        """Pages preempting ``v`` would return to the pool: those it
        holds alone (a shared page only loses one reference)."""
        if self._prefix is None:
            return len(v.blocks)
        return sum(1 for p in v.blocks if self._alloc.refcount(p) == 1)

    def _alloc_with_preempt(self, s: _Stream, n: int) -> Optional[List[int]]:
        """Pages for active stream ``s``, evicting parked pages and then
        preempting the youngest other stream while the pool is dry.
        None: ``s`` itself could not be kept and was failed."""
        while True:
            pages = self._palloc(n, owner=s.sid)
            if pages is not None:
                return pages
            # a victim must be able to come back: its re-prefill has to
            # fit the prefill ladder, unless chunked prefill re-prefills
            # any length
            victims = [v for v in self._active if v is not s
                       and (self._chunk
                            or v.length <= self._prefill_buckets[-1])]
            if not victims:
                with self._lock:
                    self._active.remove(s)
                self._release_pages(s.blocks)
                s.blocks = []
                self._release_adapter(s)
                if s.future.set_running_or_notify_cancel():
                    s.future.set_exception(MXNetError(
                        f"KV cache exhausted: stream {s.sid} needs a page "
                        f"and no preemptable stream remains (pool: "
                        f"{self._alloc.capacity} blocks); size "
                        f"cache_blocks for the workload"))
                return None
            # prefer victims whose preemption frees pages: a pure sharer
            # only drops refcounts.  When every victim is one, take the
            # youngest anyway: its chain's refcounts drain to zero, park,
            # and the eviction above reclaims them.  Among them a batch
            # stream goes before an interactive one, youngest first
            productive = [v for v in victims if self._reclaimable(v) > 0]
            self._preempt(max(productive or victims,
                              key=lambda v: (v.slo_class == "batch",
                                             v.t_admit)))

    def _ensure_capacity(self, s: _Stream, ahead: int = 1) -> bool:
        """Grow ``s`` to hold ``ahead`` more tokens' pages (1: the next
        token; a verify window: its width); False when ``s`` itself
        could not be kept resident."""
        need = blocks_for_tokens(s.length + ahead, self._kv_block) \
            - len(s.blocks)
        if need <= 0:
            return True
        pages = self._alloc_with_preempt(s, need)
        if pages is None:
            return False
        s.blocks.extend(pages)
        return True

    def _maybe_cow(self, s: _Stream) -> bool:
        """Copy-on-write before this step's cache write: if the page
        about to receive position ``s.length``'s K/V is shared (another
        stream holds it, or the prefix index maps its bytes), copy it to
        a private page, every pool (values and scales), and splice the
        block table.  In practice only a full hit's replayed token gets
        here: the index holds full pages only.  False when ``s`` could
        not get its page."""
        j = s.length // self._kv_block
        if j >= len(s.blocks):  # pragma: no cover - ensured upstream
            return True
        page = s.blocks[j]
        if not self._prefix.needs_cow(page):
            return True
        pages = self._alloc_with_preempt(s, 1)
        if pages is None:
            return False
        new = pages[0]
        # eager, between steps: the pages copied vary with the stream, and
        # eviction and preemption around it are host bookkeeping
        for pool in self._pools:  # a byte copy: fp8 pages included
            pool[new].view(torch.uint8).copy_(pool[page].view(torch.uint8))
        s.blocks[j] = new
        self._prefix.release([page])  # our reference; sharers keep it
        self._prefix.note_cow()
        return True

    def _preempt(self, victim: _Stream):
        """Recompute-style preemption: drop the victim's page references
        and queue it at the front for re-prefill of prompt + progress.
        Shared pages lose only its reference; its re-admission will
        usually attach them again as a prefix hit.  It keeps its adapter
        reference, so its slot cannot be evicted while it waits."""
        self._release_pages(victim.blocks)
        victim.blocks = []
        victim.length = 0
        victim.cached_len = 0
        # a full hit preempted before its first token re-admits as a
        # fresh request: there is no pending token to resume
        victim.resume = bool(victim.generated)
        victim.t_enqueue = time.perf_counter()
        with self._lock:
            self._active.remove(victim)
            self._pending.insert(0, victim)
        self._metrics.inc("preempted")

    def _release_adapter(self, s: _Stream) -> None:
        """Drop the stream's adapter reference once (the slot doubles as
        the not-yet-released flag)."""
        if s.adapter is None or s.adapter_slot is None:
            return
        s.adapter_slot = None
        self._adapter_pool.release(s.adapter)

    def _retire(self, s: _Stream):
        self._release_pages(s.blocks)
        s.blocks = []
        self._release_adapter(s)
        self._tenant_count(s.tenant, "tokens",
                           len(s.generated) + len(s.prompt))
        self._tenant_count(s.tenant, "generations")
        # counted before the result is set: a caller that reads stats()
        # once its last future resolves sees every generation
        self._metrics.inc("generations")
        if s.future.set_running_or_notify_cancel():
            s.future.set_result(np.asarray(s.generated, np.int32))

    def _step(self):
        """One scheduling step: with speculation on, ask the proposer for
        every active stream's drafts and run the verify step if any
        stream has one; otherwise (and always without speculation) the
        plain one-token step, which is the zero-draft verify step."""
        if self._spec_k:
            with self._lock:
                streams = list(self._active)
            drafts = {s.sid: self._propose(s) for s in streams}
            if any(d.size for d in drafts.values()):
                self._verify_step(drafts)
                return
        self._plain_step()

    def _propose(self, s: _Stream) -> np.ndarray:
        """Draft tokens for one stream, capped by what the step may
        commit: emissions left before max_new, positions left before
        max_len, and the draft depth."""
        room = min(s.max_new - len(s.generated) - 1,
                   self._max_len - s.length - 1, self._spec_k)
        if room < 1:
            return np.empty(0, np.int32)
        ctx = np.concatenate([s.prompt, np.asarray(s.generated, np.int32)])
        # eager: a draft LM runs its forward over the real tokens, a
        # length that changes every call
        d = np.asarray(self._proposer.propose(ctx, room), np.int32)
        return d[:room]

    def _verify_step(self, drafts: Dict[int, np.ndarray]):
        """One speculative step: feed every active stream its pending
        token plus its drafts (W = 1 + spec_tokens rows, padded), score
        all rows in one ``TransformerLM.verify``, copy the (B, W) int32
        emissions to the host once, commit the longest verified prefix
        plus the first mismatching emission (cut at eos / max_new), and
        return pages that held only rejected tokens to the pool."""
        t0 = time.perf_counter()
        for s in list(self._active):
            if s in self._active:
                self._ensure_capacity(s, ahead=1 + len(drafts.get(s.sid,
                                                                  ())))
        self._cow_active()
        with self._lock:
            streams = list(self._active)
        if not streams:
            return
        n = len(streams)
        W = self._spec_k + 1
        bb = self._bucket(self._decode_buckets, n, "active streams")
        mb = self._bucket(self._cache_buckets,
                          max(len(s.blocks) for s in streams),
                          "cache blocks")
        # padded batch rows: start 0, lengths 0 (every window row writes
        # to the scratch page); padded window rows sit past lengths[i]
        tokens = np.zeros((bb, W), np.int32)
        positions = np.zeros((bb, W), np.int32)
        start = np.zeros((bb,), np.int32)
        lengths = np.zeros((bb,), np.int32)
        table = np.zeros((bb, mb), np.int32)
        temps = np.zeros((bb,), np.float32)
        seeds = np.zeros((bb,), np.int64)
        steps0 = np.zeros((bb,), np.int64)
        fed: List[np.ndarray] = []
        for i, s in enumerate(streams):
            # a stream admitted after the propose pass has no draft
            d = drafts.get(s.sid, np.empty(0, np.int32))
            row = np.concatenate([np.asarray([s.next_token], np.int32), d])
            fed.append(row)
            tokens[i, :len(row)] = row
            # pad rows keep in-range positions (their logits are unused)
            positions[i] = np.minimum(s.length + np.arange(W),
                                      self._max_len - 1)
            start[i] = s.length
            lengths[i] = s.length + len(row)
            table[i, :len(s.blocks)] = s.blocks
            temps[i] = s.temp
            seeds[i] = s.seed
            steps0[i] = s.length  # row j samples position length + j
        slots, used = self._adapter_slots(streams, bb)
        exe = self._verify_exe(bb, mb, used)
        exe.feed(tokens=tokens, positions=positions, start=start,
                 lengths=lengths, table=table, **slots)
        logits = exe.run()
        emit = verify_sample(logits, tokens, lengths - start, temps, seeds,
                             steps0, self._seed)
        emit = emit.cpu().numpy()  # the step's one device-to-host copy
        t_done = time.perf_counter()
        step_ms = (t_done - t0) * 1e3
        self._metrics.inc("d2h_syncs")
        self._metrics.inc("steps")
        self._metrics.inc("stream_steps", n)
        self._metrics.inc("spec_steps")
        self._metrics.inc("spec_proposed", sum(len(r) - 1 for r in fed))
        self._metrics.observe("step_ms", step_ms)
        retired = []
        for i, s in enumerate(streams):
            d = fed[i][1:]
            t = 0
            for j in range(len(fed[i])):
                tok = int(emit[i, j])
                # every emission up to and including the first mismatch
                # is an exact sample for its own slot
                s.generated.append(tok)
                t += 1
                if s.done():
                    break
                if j < len(d) and tok != int(d[j]):
                    break
            s.length += t
            s.next_token = s.generated[-1]
            self._metrics.inc("tokens", t)
            self._metrics.inc("spec_accepted", t - 1)
            self._first_from_step(s, t_done)
            for _ in range(t):
                self._metrics.observe("time_per_token_ms", step_ms / t)
            # pages past the committed tokens and the pending token's
            # slot held only rejected window writes
            keep, surplus = trim_blocks(s.blocks, s.length + 1,
                                        self._kv_block)
            if surplus:
                s.blocks = keep
                self._release_pages(surplus)
                self._metrics.inc("spec_pages_rolled_back", len(surplus))
            if s.done():
                retired.append(s)
        self._retire_all(retired)

    def _plain_step(self):
        """One decode step over every active stream: feed, run, then one
        (B,) int32 copy to the host.  When the next step's batch is
        provably this one's, two steps run back to back (the JAX engine's
        pipelined fetch, ``mxnet_tpu/serving.py:3358-3460``): step t+1 is
        fed from step t's tokens on the device, and step t's tokens are
        copied to the host and absorbed while step t+1 runs.  Sampling is
        keyed by (seed, stream, position), so the pair emits the bits of
        two sequential steps."""
        t0 = time.perf_counter()
        for s in list(self._active):
            if s in self._active:
                self._ensure_capacity(s)
        self._cow_active()
        with self._lock:
            streams = list(self._active)
        if not streams:
            return
        # pipelined only while nothing can change the batch between the
        # two steps: nothing pending, no chunked prefill in flight, no
        # stream able to retire, pages for two more tokens, and no
        # copy-on-write at the second step's write.  Not while
        # speculating: a pair would skip step t+1's proposal, and whether
        # a stream has a draft picks the sampler of its temperature rows,
        # so its tokens would hang on the batch it rides in
        pipeline = (not self._spec_k and not self._pending
                    and self._prefilling is None
                    and all(s.eos is None
                            and len(s.generated) + 2 <= s.max_new
                            for s in streams))
        if pipeline:
            for s in streams:
                if s not in self._active \
                        or not self._ensure_capacity(s, ahead=2):
                    pipeline = False
                    break
            with self._lock:
                cur = list(self._active)
            if cur != streams:
                # growing two ahead preempted a stream: a fresh snapshot,
                # and this iteration unpipelined
                streams = cur
                pipeline = False
                if not streams:
                    return
        if pipeline and self._prefix is not None:
            pipeline = not any(self._cow_ahead(s) for s in streams)
        n = len(streams)
        bb = self._bucket(self._decode_buckets, n, "active streams")
        mb = self._bucket(self._cache_buckets,
                          max(len(s.blocks) for s in streams),
                          "cache blocks")
        # padded rows: lengths 0 (their write goes to the scratch page
        # and their attention is empty), table padded with page 0 out to
        # the cache bucket (the kernel never reads past a stream's pages)
        tokens = np.zeros((bb, 1), np.int32)
        positions = np.zeros((bb, 1), np.int32)
        lengths = np.zeros((bb,), np.int32)
        table = np.zeros((bb, mb), np.int32)
        temps = np.zeros((bb,), np.float32)
        seeds = np.zeros((bb,), np.int64)
        steps = np.zeros((bb,), np.int64)
        for i, s in enumerate(streams):
            tokens[i, 0] = s.next_token
            positions[i, 0] = s.length
            lengths[i] = s.length + 1
            table[i, :len(s.blocks)] = s.blocks
            temps[i] = s.temp
            seeds[i] = s.seed
            steps[i] = s.length  # the position being sampled from
        # one adapter snapshot serves both steps of a pair (the batch is
        # pinned, so its slot ids are)
        slots, used = self._adapter_slots(streams, bb)
        exe = self._decode_exe(bb, mb, used)
        exe.feed(tokens=tokens, positions=positions, lengths=lengths,
                 table=table, **slots)
        toks = sample_tokens(exe.run()[:, 0], temps, seeds, steps,
                             self._seed)
        if not pipeline:
            toks = toks.cpu().numpy()  # the step's one device-to-host copy
            self._metrics.inc("d2h_syncs")
            self._absorb_step(streams, toks, t0, time.perf_counter())
            return
        # step t's tokens start for the host ahead of step t+1 on the
        # stream; step t+1 feeds them from the device: live rows advance
        # one position, pad rows stay dead (lengths 0)
        fetched = self._fetch(toks)
        live = lengths > 0
        exe.feed(tokens=tokens,
                 positions=positions + live[:, None].astype(np.int32),
                 lengths=np.where(live, lengths + 1, 0).astype(np.int32),
                 table=table, **slots)
        exe.bufs["tokens"].copy_(toks.view(bb, 1))
        logits = exe.run()
        toks = self._fetched(fetched)  # while step t+1 runs
        self._metrics.inc("d2h_syncs")
        self._metrics.inc("d2h_syncs_saved")
        t_mid = time.perf_counter()
        # no stream can retire (the predicate): step t+1's batch held
        self._absorb_step(streams, toks, t0, t_mid)
        toks = sample_tokens(logits[:, 0], temps, seeds, steps + 1,
                             self._seed).cpu().numpy()
        self._metrics.inc("d2h_syncs")
        self._absorb_step(streams, toks, t_mid, time.perf_counter())

    def _fetch(self, toks: torch.Tensor):
        """Start the copy of a step's (B,) tokens to the host, behind the
        step on the stream: (pinned host tensor, its event)."""
        if not toks.is_cuda:
            return toks.clone(), None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetched(fetched) -> np.ndarray:
        host, done = fetched
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _cow_ahead(self, s: _Stream) -> bool:
        """Would the write after this step's (position ``s.length + 1``)
        copy a shared page on write?"""
        j = (s.length + 1) // self._kv_block
        return j < len(s.blocks) and self._prefix.needs_cow(s.blocks[j])

    def _absorb_step(self, streams, toks, t0, t_done):
        """Book one decode step's tokens: counters, per-stream append,
        retirement."""
        step_ms = (t_done - t0) * 1e3
        n = len(streams)
        self._metrics.inc("steps")
        self._metrics.inc("stream_steps", n)
        self._metrics.inc("tokens", n)
        self._metrics.observe("step_ms", step_ms)
        retired = []
        for i, s in enumerate(streams):
            tok = int(toks[i])
            s.generated.append(tok)
            s.length += 1
            s.next_token = tok
            self._first_from_step(s, t_done)
            self._metrics.observe("time_per_token_ms", step_ms)
            if s.done():
                retired.append(s)
        self._retire_all(retired)

    def _cow_active(self):
        """The copy-on-write probe of every active stream before a
        step's cache writes (prefix cache on)."""
        if self._prefix is None:
            return
        for s in list(self._active):
            if s in self._active:
                self._maybe_cow(s)

    def _first_from_step(self, s: _Stream, t_done: float):
        """A full hit's first token came from this step: its TTFT is the
        wait plus one step."""
        if s.await_first:
            s.await_first = False
            ttft = (t_done - s.t_submit) * 1e3
            self._metrics.observe("ttft_ms", ttft)
            self._metrics.observe("ttft_hit_ms", ttft)

    def _retire_all(self, retired: List[_Stream]):
        if retired:
            with self._lock:
                for s in retired:
                    self._active.remove(s)
            for s in retired:
                self._retire(s)


# ---------------------------------------------------------------------------
# InferenceEngine: dynamic micro-batching over one executable a batch
# bucket (mxnet_tpu/serving.py:81-743)
# ---------------------------------------------------------------------------

_DEFAULT_BUCKETS = (1, 8, 32, 128)


class _Request:
    __slots__ = ("inputs", "n", "future", "t_submit")

    def __init__(self, inputs, n, future, t_submit):
        self.inputs = inputs      # {name: np.ndarray with leading n}
        self.n = n                # samples in this request
        self.future = future
        self.t_submit = t_submit


class _PredictorModel:
    """A ``Predictor``'s forward, run at any batch size: its bound batch
    dimension is dropped from the per-sample shapes."""

    def __init__(self, predictor):
        self._pred = predictor
        self.input_names = list(predictor._input_names)
        self.sample_shapes = {n: tuple(predictor._input_shapes[n][1:])
                              for n in self.input_names}
        self.input_dtypes = {n: np.dtype(predictor._input_dtypes[n])
                             for n in self.input_names}
        self.output_names = list(predictor.output_names)
        self.device = predictor._device
        self.forward = predictor.forward_closure()

    def set_params(self, params):
        """New weights copied into the served tensors (the bucket
        graphs read them: nothing is recaptured)."""
        self._pred.set_params(params)

    def get_params(self):
        """Host snapshot of the served weights and aux states."""
        from .predictor import _host

        return {n: _host(t) for n, t in
                {**self._pred._weights, **self._pred._aux}.items()}


class _ExportedModel:
    """A ``predictor.export_model`` artifact on ``device``: its program is
    traced at one batch size, so the ladder is that one bucket."""

    def __init__(self, path_or_bytes, device):
        from .predictor import load_exported

        fn, meta = load_exported(path_or_bytes)
        self._fn = fn.to(device)
        self.input_names = list(meta["inputs"])
        shapes = meta["input_shapes"]
        self.export_batch = int(shapes[self.input_names[0]][0])
        self.sample_shapes = {n: tuple(shapes[n][1:])
                              for n in self.input_names}
        dtypes = meta.get("input_dtypes", {})
        self.input_dtypes = {n: np.dtype(dtypes.get(n, "float32"))
                             for n in self.input_names}
        self.output_names = list(meta.get("outputs", []))
        self.device = device

    def forward(self, bufs):
        with torch.no_grad():
            return list(self._fn(*[bufs[n] for n in self.input_names]))

    def set_params(self, params):
        raise MXNetError("an exported artifact embeds its weights: no "
                         "live swap; export again and restart the engine")

    def get_params(self):
        raise MXNetError("an exported artifact embeds its weights; there "
                         "is nothing to snapshot")


class InferenceEngine(_ExecutableHost):
    """Dynamic micro-batching over one executable a batch bucket.

    Counterpart of the JAX package's ``InferenceEngine``: a batcher
    thread coalesces requests into a micro-batch, pads it to the
    smallest bucket that holds it and dispatches it; a completer thread
    waits for its outputs and resolves each request's future with its
    own rows.  A bucket is an ``_Executable``: input buffers it owns, fed
    by one copy from a pinned staging buffer, and on CUDA one CUDA graph
    of the model's forward, captured at the bucket's first use (or
    ``warmup()``) and replayed (``_graphs=False``, private, runs the same
    executables uncaptured there; the CPU always does).  The outputs of
    a dispatch are copied into pinned host buffers on the device's
    stream right behind it, so the next replay may overwrite the graph's
    output buffers while the completer reads.

    Parameters
    ----------
    model : Predictor
        The loaded model; its bound batch size is irrelevant (the engine
        runs the forward at each bucket's).
    buckets : sequence of int
        Batch-size ladder (default (1, 8, 32, 128)).
    max_batch : int, optional
        Coalescing ceiling (default: the largest bucket); a request may
        carry at most this many samples.
    batch_timeout_ms : float
        How long the batcher holds a partial batch for more requests
        while the device is busy with an earlier micro-batch.
    idle_timeout_ms : float
        The shorter grace when the device is idle (default 0.5 ms).
    queue_depth : int
        Request-queue bound; ``submit`` blocks while it is full.
    pipeline_depth : int
        Micro-batches in flight between dispatch and completion.
    prewarm : bool
        Build (capture) every bucket at construction.
    donate : bool, optional
        Accepted for the JAX engine's signature; no effect (the
        executables own their input buffers).
    """

    def __init__(self, model, buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 max_batch: Optional[int] = None,
                 batch_timeout_ms: float = 2.0,
                 idle_timeout_ms: float = 0.5, queue_depth: int = 1024,
                 pipeline_depth: int = 2, prewarm: bool = False,
                 donate: Optional[bool] = None, _graphs: bool = True):
        from .predictor import Predictor

        if isinstance(model, Predictor):
            model = _PredictorModel(model)
        elif not isinstance(model, (_PredictorModel, _ExportedModel)):
            raise MXNetError(
                "InferenceEngine wraps a Predictor or an exported artifact "
                f"(use from_exported); got {type(model)}")
        self._model = model
        if isinstance(model, _ExportedModel):
            buckets = (model.export_batch,)
        self._buckets = tuple(sorted({int(b) for b in buckets}))
        if not self._buckets or self._buckets[0] < 1:
            raise MXNetError(f"bad bucket ladder {buckets}")
        self._max_batch = int(max_batch or self._buckets[-1])
        if self._max_batch > self._buckets[-1]:
            raise MXNetError(f"max_batch {self._max_batch} exceeds the "
                             f"largest bucket {self._buckets[-1]}")
        self._timeout_s = float(batch_timeout_ms) / 1000.0
        self._idle_timeout_s = min(float(idle_timeout_ms) / 1000.0,
                                   self._timeout_s)
        self._init_executables(model.device, _graphs)
        self._inflight_n = 0  # micro-batches dispatched, not yet done
        self._queue: _queue.Queue = _queue.Queue(maxsize=queue_depth)
        self._pipeline_depth = int(pipeline_depth)
        self._inflight: _queue.Queue = _queue.Queue(maxsize=pipeline_depth)
        self._carry: Optional[_Request] = None
        self._building: Optional[List[_Request]] = None
        self._lock = threading.Lock()
        self._metrics = _Metrics()
        # the measured cost model: bucket -> EMA of a batch's ms, which
        # decides whether growing a batch across a bucket boundary raises
        # or lowers the projected rate (mxnet_tpu/serving.py:544-564)
        self._bucket_ms: Dict[int, float] = {}
        self._alive = True
        self._accepting = True
        self._reject = None  # drain(): submit's refusal message
        self._owned: set = set()  # every accepted, unresolved future
        # orders submit's (check, put) against close's (clear, sentinel)
        self._accept_lock = threading.Lock()
        if prewarm:
            self.warmup()
        self._batcher = threading.Thread(
            target=self._batch_loop, daemon=True,
            name="mxnet_tpu_torch-serving-batcher")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name="mxnet_tpu_torch-serving-completer")
        self._batcher.start()
        self._completer.start()

    @classmethod
    def from_exported(cls, path_or_bytes, ctx=None, **kwargs):
        """Serve a ``predictor.export_model`` artifact on ``ctx``
        (default ``current_context()``), one bucket: its exported batch
        size."""
        kwargs.pop("buckets", None)
        ctx = ctx or current_context()
        return cls(_ExportedModel(path_or_bytes, ctx.torch_device()),
                   **kwargs)

    # -- client surface ---------------------------------------------------
    def submit(self, inputs, trace=None) -> Future:
        """Enqueue one request → a Future of the list of output arrays,
        each with this request's sample count as its leading dim.
        ``inputs``: {input_name: array} (a leading batch dim, or a bare
        per-sample shape for one sample), or one array when the model has
        one input.  ``trace=`` (request tracing) is not ported yet."""
        if trace is not None:
            raise not_ported("request tracing (InferenceEngine.submit("
                             "trace=); profiler spans, queue A item 8)")
        if not self._accepting:
            raise MXNetError(self._reject or "InferenceEngine is closed")
        names = self._model.input_names
        if not isinstance(inputs, dict):
            if len(names) != 1:
                raise MXNetError(f"model has inputs {names}; pass a dict")
            inputs = {names[0]: inputs}
        missing = set(names) - set(inputs)
        if missing:
            raise MXNetError(f"inputs not set: {sorted(missing)}")
        batch: Dict[str, np.ndarray] = {}
        n = None
        for name in names:
            sshape = self._model.sample_shapes[name]
            arr = np.asarray(
                getattr(inputs[name], "asnumpy", lambda: inputs[name])(),
                dtype=self._model.input_dtypes[name])
            if arr.shape == sshape:  # a bare single sample
                arr = arr[None]
            if arr.shape[1:] != sshape:
                raise MXNetError(
                    f"input {name!r} shape {arr.shape} != (n,) + {sshape}")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise MXNetError(f"inconsistent sample counts: {name!r} has "
                                 f"{arr.shape[0]}, expected {n}")
            batch[name] = arr
        if n == 0:
            raise MXNetError("empty request")
        if n > self._max_batch:
            raise MXNetError(f"request of {n} samples exceeds max_batch "
                             f"{self._max_batch}; split it client-side")
        fut: Future = Future()
        req = _Request(batch, n, fut, time.perf_counter())
        # backpressure without holding the accept lock through a blocking
        # put: a full queue stalls this caller only
        while True:
            with self._accept_lock:
                if not self._accepting:
                    raise MXNetError(
                        self._reject or "InferenceEngine is closed")
                try:
                    self._queue.put_nowait(req)
                    break
                except _queue.Full:
                    pass
            time.sleep(0.002)
        self._metrics.inc("requests")
        with self._lock:
            self._owned.add(fut)
        fut.add_done_callback(self._disown)
        return fut

    def _disown(self, fut):
        with self._lock:
            self._owned.discard(fut)

    def infer(self, inputs):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(inputs).result()

    def inflight(self) -> int:
        """Accepted, unresolved requests: queued, coalescing or
        dispatched (a poisoned future leaves the count when it fails)."""
        with self._lock:
            return len(self._owned)

    def drain(self, timeout: float = 30.0) -> int:
        """Stop accepting requests and wait for the in-flight ones; the
        number still unresolved at the deadline.  ``resume()`` re-opens
        (the swap choreography: drain → swap_params → warmup → resume)."""
        with self._accept_lock:
            if self._accepting:
                self._reject = ("InferenceEngine is draining — not "
                                "accepting requests (weight swap in "
                                "progress)")
                self._accepting = False
        deadline = time.perf_counter() + float(timeout)
        while self.inflight() and time.perf_counter() < deadline:
            time.sleep(0.002)
        return self.inflight()

    def resume(self):
        """Re-open admission after :meth:`drain`."""
        if not self._alive:
            raise MXNetError("cannot resume a closed InferenceEngine")
        with self._accept_lock:
            self._reject = None
            self._accepting = True

    def swap_params(self, params):
        """Live weight swap on a drained engine: the new weights are
        copied into the tensors every bucket reads (no graph is
        recaptured); a missing or misshapen name raises and installs
        nothing."""
        n = self.inflight()
        if n:
            raise MXNetError(f"swap_params with {n} request(s) in flight — "
                             f"drain() first (their batches would mix "
                             f"weight versions)")
        with self._compile_lock:
            self._model.set_params(params)
            with self._lock:
                self._bucket_ms.clear()  # re-learn: weights changed

    def get_params(self):
        """Host snapshot of the served weights (weights and aux)."""
        return self._model.get_params()

    def warmup(self):
        """Build every bucket now (on CUDA: capture it) and time one run
        of each on zeros, seeding the cost model."""
        for b in self._buckets:
            exe = self._bucket_exe(b)
            self._build(exe)
            exe.feed(**exe.zeros())
            t0 = time.perf_counter()
            for o in exe.run():
                o.cpu()
            with self._lock:
                self._bucket_ms[b] = (time.perf_counter() - t0) * 1e3

    # -- stats ------------------------------------------------------------
    _COUNTERS = ("requests", "images", "slots", "batches", "flush_full",
                 "flush_timeout", "flush_boundary", "cache_hits",
                 "cache_misses")

    def stats(self) -> dict:
        """Counters, per-bucket build counts, the slot-weighted batch
        fill, latency percentiles, rates since start, the graphs."""
        with self._compile_lock:
            compiles = {k[1]: v for k, v in self.compiles.items()}
        c = self._metrics.counters
        out = {name: int(c.get(name, 0)) for name in self._COUNTERS}
        out["compiles"] = compiles
        out["batch_fill_ratio"] = (out["images"] / out["slots"]
                                   if out["slots"] else None)
        lat = self._metrics.percentiles("latency_ms")
        for k in ("p50", "p90", "p99"):
            out[f"{k}_ms"] = lat[k] if lat else None
        wall = time.perf_counter() - self._metrics.t0
        out["requests_per_s"] = out["requests"] / wall
        out["images_per_s"] = out["images"] / wall
        out["buckets"] = list(self._buckets)
        out["latency_breakdown"] = {
            phase: {"p50_ms": p["p50"], "p99_ms": p["p99"]}
            for phase, hist in (("queue_wait", "queue_wait_ms"),
                                ("exec", "batch_ms"),
                                ("total", "latency_ms"))
            for p in [self._metrics.percentiles(hist)] if p}
        out["device"] = str(self._device)
        out["graphs"] = self._graph_stats()
        return out

    # -- lifecycle --------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Stop accepting requests, serve what was accepted, join the
        threads."""
        if not self._alive:
            return
        with self._accept_lock:
            self._accepting = False
            self._queue.put(None)  # the batcher serves everything before it
        self._batcher.join(timeout=timeout)
        self._alive = False
        self._completer.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(timeout=1.0)
        except Exception:  # interpreter shutdown: nothing left to join
            pass

    # -- buckets ----------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _bucket_exe(self, bucket: int) -> _Executable:
        m = self._model
        return self._executable(
            ("batch", bucket), m.forward,
            [(n, (bucket,) + m.sample_shapes[n], m.input_dtypes[n])
             for n in m.input_names])

    def _boundary_flush(self, total: int, add: int) -> bool:
        """Would adding ``add`` samples push this batch into a bigger
        bucket whose measured rate is worse than shipping now?  Compares
        ``total / t(bucket)`` with ``(total + add + backlog) /
        t(next bucket)``, the backlog capped at the next bucket's room;
        with a bucket not measured yet, grow."""
        b = self._bucket_for(total)
        nb = self._bucket_for(total + add)
        if nb <= b:
            return False
        t_b, t_nb = self._bucket_ms.get(b), self._bucket_ms.get(nb)
        if not t_b or not t_nb:
            return False
        backlog = min(self._queue.qsize(), nb - total - add)
        return total / t_b >= (total + add + backlog) / t_nb

    # -- batcher thread: coalesce → pad → feed → dispatch ---------------------
    def _batch_loop(self):
        try:
            self._batch_loop_inner()
        except BaseException as exc:  # the loop died: poison, don't hang
            self._shutdown(EngineClosedError(
                f"InferenceEngine batch loop died: {exc!r}"))
            raise

    def _batch_loop_inner(self):
        while True:
            first = self._carry
            self._carry = None
            if first is None:
                first = self._queue.get()
            if first is None:  # close() sentinel
                self._shutdown()
                return
            batch = [first]
            self._building = batch  # failed too if the loop dies here
            total = first.n
            reason = "full" if total >= self._max_batch else "timeout"
            closing = False
            t_first = time.perf_counter()
            while reason == "timeout":
                # pipeline full: the deadline is suspended while the batch
                # grows; device busy: hold up to the deadline; idle: a
                # short grace
                suspended = self._inflight_n >= self._pipeline_depth
                if suspended:
                    remaining = 0.005
                else:
                    window = (self._timeout_s if self._inflight_n > 0
                              else self._idle_timeout_s)
                    remaining = t_first + window - time.perf_counter()
                    if remaining <= 0:
                        break
                try:
                    req = self._queue.get(timeout=remaining)
                except _queue.Empty:
                    if suspended:
                        continue
                    break
                if req is None:  # close(): flush what we have, then exit
                    closing = True
                    break
                if total + req.n > self._max_batch:
                    self._carry = req
                    reason = "full"
                    break
                if self._boundary_flush(total, req.n):
                    self._carry = req
                    reason = "boundary"
                    break
                batch.append(req)
                total += req.n
                if total >= self._max_batch:
                    reason = "full"
            self._building = None
            try:
                self._dispatch(batch, total, reason)
            except Exception:  # _dispatch failed the batch's futures
                pass
            if closing:
                self._shutdown()
                return

    def _shutdown(self, exc: Optional[Exception] = None):
        """Fail the requests a close raced or a dead loop stranded, then
        release the completer."""
        exc = exc or EngineClosedError("InferenceEngine closed")
        building, self._building = self._building, None
        for req in building or ():
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
        carry, self._carry = self._carry, None
        while True:
            if carry is not None:
                req, carry = carry, None
            else:
                try:
                    req = self._queue.get_nowait()
                except _queue.Empty:
                    break
            if req is not None and req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
        self._inflight.put(None)

    def _dispatch(self, batch: List[_Request], total: int, reason: str):
        t0 = time.perf_counter()
        for req in batch:
            self._metrics.observe("queue_wait_ms", (t0 - req.t_submit) * 1e3)
        try:
            bucket = self._bucket_for(total)
            built_now = ("batch", bucket) not in self._exe_cache
            self._metrics.inc("cache_misses" if built_now else "cache_hits")
            exe = self._bucket_exe(bucket)
            feeds = {}
            for name in self._model.input_names:
                buf = np.zeros((bucket,) + self._model.sample_shapes[name],
                               self._model.input_dtypes[name])
                off = 0
                for req in batch:
                    buf[off:off + req.n] = req.inputs[name]
                    off += req.n
                feeds[name] = buf
            exe.feed(**feeds)
            outs = exe.run()
            # the outputs leave for pinned host buffers right behind the
            # run, on its stream: a later replay may overwrite the graph's
            # output buffers while the completer waits
            cuda = self._device.type == "cuda"
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=cuda)
                    .copy_(o, non_blocking=cuda) for o in outs]
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
        except BaseException as exc:
            # nothing else can fail these futures now: they are off the
            # queue and out of _building
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(exc)
            raise
        with self._lock:
            self._inflight_n += 1
        self._metrics.inc("batches")
        self._metrics.inc("images", total)
        self._metrics.inc("slots", bucket)
        self._metrics.inc(f"flush_{reason}")
        self._inflight.put((host, done, batch, t0, bucket, built_now))

    # -- completer thread: wait, slice, resolve --------------------------------
    def _complete_loop(self):
        from .predictor import _host

        last_done = 0.0
        while True:
            item = self._inflight.get()
            if item is None:
                return
            outs, done, batch, t0, bucket, built_now = item
            try:
                if done is not None:
                    done.synchronize()
                host = [_host(o) for o in outs]
            except Exception as exc:
                with self._lock:
                    self._inflight_n -= 1
                for req in batch:
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(exc)
                continue
            now = time.perf_counter()
            self._metrics.observe("batch_ms", (now - t0) * 1e3)
            # the cost model's sample is occupancy (a pipelined batch
            # occupied the device from its predecessor's end); a batch
            # that built its bucket (a capture) is no sample
            exec_ms = (now - max(t0, last_done)) * 1e3
            last_done = now
            with self._lock:
                self._inflight_n -= 1
                if not built_now:
                    old = self._bucket_ms.get(bucket)
                    self._bucket_ms[bucket] = (
                        exec_ms if old is None else 0.5 * old + 0.5 * exec_ms)
            bad = [i for i, o in enumerate(host) if o.shape[:1] != (bucket,)]
            if bad:
                exc = MXNetError(
                    f"output(s) {bad} have leading dims "
                    f"{[host[i].shape for i in bad]} != bucket {bucket}: the "
                    f"model reduces over the batch axis, so its outputs "
                    f"cannot be served per request by the batching engine")
                for req in batch:
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(exc)
                continue
            off = 0
            for req in batch:
                # a copy, not a view: a view would pin the whole bucket
                rows = [np.array(o[off:off + req.n]) for o in host]
                off += req.n
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(rows)
                self._metrics.observe("latency_ms",
                                      (now - req.t_submit) * 1e3)
