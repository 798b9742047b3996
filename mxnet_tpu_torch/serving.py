"""Autoregressive serving: continuous batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serving.py``'s ``DecodeEngine``, with the same
entry point and semantics:

* **prefill** runs the causal forward over a bucket-padded prompt once
  (one stream at a time), writing each layer's K/V into the stream's
  pages (``flash_mha_packed`` kernel for the attention);
* **decode** advances every active stream one token per step in one
  batch (``paged_attention_decode`` kernel), samples greedy or
  temperature tokens on the device, and copies ONE (B,) int32 vector
  to the host per step;
* streams join and retire at every step (Orca, Yu et al. OSDI '22);
* admission is keyed to free pages (the prompt's pages plus one block
  of headroom); when a growing stream finds the pool empty, the
  youngest other stream is preempted and re-queued for re-prefill
  (recompute-style);
* batch size, table width and prompt length are bucketed on doubling
  ladders, so the kernels see few distinct shapes.

The pools are updated in place by the attention ops (``index_put_``),
which replaces the JAX engine's buffer donation.  The scheduler runs on
its own thread; kernels launch on that thread's current CUDA stream,
and the step's one device-to-host copy synchronises that stream only.

Features of the JAX engine outside this slice raise ``MXNetError("...
not ported yet")`` when asked for by argument or environment variable.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, get_env, not_ported
from .context import current_context
from .convert import params_from_numpy
from .kv_cache import (KV_DTYPES, BlockAllocator, blocks_for_tokens,
                       bucket_ladder, kv_storage_dtype)
from .models.transformer import TransformerLM
from .random import gumbel_noise, stream_key

__all__ = ["DecodeEngine", "EngineClosedError", "sample_tokens"]

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


def _refuse_unported(*, prefix_cache, evict_policy, spec_tokens,
                     proposer, prefill_chunk, tp, pp, devices, adapters,
                     tenant_quota, dtype) -> None:
    """Raise for every feature of the JAX engine this port does not
    carry yet, asked for by argument or by environment variable."""
    pc = prefix_cache if prefix_cache is not None else \
        _env_int("MXNET_SERVING_PREFIX_CACHE", 0, 0)
    if int(pc) not in (0, 1):
        raise MXNetError(f"prefix_cache={pc!r} must be 0 or 1")
    if int(pc):
        raise not_ported("the prefix cache (prefix_cache / "
                         "MXNET_SERVING_PREFIX_CACHE)")
    if evict_policy is not None or os.environ.get("MXNET_SERVING_EVICT"):
        raise not_ported("prefix-cache eviction (evict_policy / "
                         "MXNET_SERVING_EVICT)")
    k = spec_tokens if spec_tokens is not None else \
        _env_int("MXNET_SERVING_SPEC_TOKENS", 0, 0)
    if int(k) or proposer is not None \
            or os.environ.get("MXNET_SERVING_PROPOSER"):
        raise not_ported("speculative decoding (spec_tokens / proposer / "
                         "MXNET_SERVING_SPEC_TOKENS / "
                         "MXNET_SERVING_PROPOSER)")
    chunk = prefill_chunk if prefill_chunk is not None else \
        _env_int("MXNET_SERVING_PREFILL_CHUNK", 0, 0)
    if int(chunk):
        raise not_ported("chunked prefill (prefill_chunk / "
                         "MXNET_SERVING_PREFILL_CHUNK)")
    tp = tp if tp is not None else _env_int("MXNET_SERVING_TP", 1, 1)
    pp = pp if pp is not None else _env_int("MXNET_SERVING_PP", 1, 1)
    if int(tp) != 1 or int(pp) != 1 or devices is not None \
            or os.environ.get("MXNET_SERVING_DEVICES"):
        raise not_ported("model-parallel serving (tp / pp / devices / "
                         "MXNET_SERVING_TP / _PP / _DEVICES)")
    if (adapters is not None and adapters is not False) \
            or _env_int("MXNET_ADAPTER_ENABLE", 0, 0):
        raise not_ported("LoRA adapters (adapters / MXNET_ADAPTER_ENABLE)")
    if tenant_quota is not None \
            or _env_int("MXNET_TENANT_QUOTA_TOKENS", 0, 0):
        raise not_ported("tenant quotas (tenant_quota / "
                         "MXNET_TENANT_QUOTA_TOKENS)")
    if dtype != "float32":
        raise not_ported(f"dtype={dtype!r} pool storage (bf16 pages come "
                         f"from kv_dtype='bf16')")


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
                 "resume", "t_submit", "t_admit", "t_enqueue")

    def __init__(self, sid, prompt, max_new, temp, eos, future, seed):
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
        self.t_enqueue = self.t_submit

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


class DecodeEngine:
    """Continuous-batching autoregressive serving of a ``transformer_lm``
    over a paged KV cache.

    Parameters
    ----------
    params : dict
        Arrays or tensors by training-symbol name (``Module.get_params``
        of the JAX package, or ``params_from_numpy``).  They are moved to
        the engine's device as float32.
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
        Pool storage: ``'fp32'`` (default, env
        ``MXNET_SERVING_KV_DTYPE``) or ``'bf16'``.
    """

    def __init__(self, params, *, vocab_size, num_layers, num_heads,
                 d_model, d_ff=None, max_len=None, kv_block=None,
                 max_streams=None, cache_blocks=None, decode_buckets=None,
                 cache_buckets=None, prefill_buckets=None, temperature=0.0,
                 seed=0, eos_id=None, ctx=None, dtype="float32",
                 kv_dtype=None, prefix_cache=None, evict_policy=None,
                 spec_tokens=None, proposer=None, prefill_chunk=None,
                 tp=None, pp=None, devices=None, adapters=None,
                 tenant_quota=None):
        _refuse_unported(prefix_cache=prefix_cache,
                         evict_policy=evict_policy, spec_tokens=spec_tokens,
                         proposer=proposer, prefill_chunk=prefill_chunk,
                         tp=tp, pp=pp, devices=devices, adapters=adapters,
                         tenant_quota=tenant_quota, dtype=dtype)
        self._kv_dtype = kv_dtype if kv_dtype is not None else \
            get_env("MXNET_SERVING_KV_DTYPE", "fp32", str)
        if self._kv_dtype not in KV_DTYPES:
            raise MXNetError(f"kv_dtype {self._kv_dtype!r} must be one of "
                             f"{KV_DTYPES}")
        pool_dtype = kv_storage_dtype(self._kv_dtype)  # int8/fp8 raise

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
        self._max_streams = int(max_streams) if max_streams is not None \
            else _env_int("MXNET_SERVING_MAX_STREAMS",
                          _DEFAULT_MAX_STREAMS, 1)
        if self._max_streams < 1:
            raise MXNetError(f"max_streams {self._max_streams} must be "
                             f">= 1")

        ctx = ctx if ctx is not None else current_context()
        self._device = ctx.torch_device()  # gpu without CUDA raises

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
        dev_params = params_from_numpy(params, self._device, torch.float32)
        self._model = TransformerLM(dev_params, num_layers=self._L,
                                    num_heads=self._H,
                                    kv_block=self._kv_block)
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

        pool_shape = (int(cache_blocks), self._kv_block, self._H, self._D)
        self._pools = [torch.zeros(pool_shape, dtype=pool_dtype,
                                   device=self._device)
                       for _ in range(2 * self._L)]
        self._pool_bytes = sum(p.numel() * p.element_size()
                               for p in self._pools)

        self._seed = int(seed)
        self._temperature = float(temperature)
        self._eos = eos_id
        self._metrics = _Metrics()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Stream] = []
        self._active: List[_Stream] = []
        self._admitting: Optional[_Stream] = None
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
               eos_id=None, seed=None, trace=None, prefill_only=False,
               tenant=None, adapter=None) -> Future:
        """Enqueue one generation; the Future resolves to the np.int32
        array of generated token ids (eos, when hit, included).

        ``seed`` overrides the stream's sampling seed (default: the
        engine-local stream id + 1); sampling is keyed by (engine seed,
        stream seed, position)."""
        if prefill_only:
            raise not_ported("prefill_only stream export (disaggregated "
                             "serving)")
        if trace is not None:
            raise not_ported("request tracing (trace=)")
        if tenant is not None or adapter is not None:
            raise not_ported("multi-tenant requests (tenant= / adapter=)")
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
        if prompt.size > self._prefill_buckets[-1]:
            raise MXNetError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill bucket {self._prefill_buckets[-1]}")
        need = blocks_for_tokens(total, self._kv_block)
        if need > self._alloc.capacity:
            raise MXNetError(f"request needs {need} cache blocks but the "
                             f"pool only has {self._alloc.capacity}")
        temp = self._temperature if temperature is None \
            else float(temperature)
        eos = self._eos if eos_id is None else eos_id
        fut: Future = Future()
        with self._cond:
            if not self._accepting:
                raise EngineClosedError("DecodeEngine is closed")
            s = _Stream(self._next_sid, prompt, max_new, temp, eos, fut,
                        seed=(self._next_sid + 1 if seed is None
                              else int(seed)))
            self._next_sid += 1
            self._pending.append(s)
            self._cond.notify_all()
        self._metrics.inc("requests")
        return fut

    @property
    def model(self) -> TransformerLM:
        """The served model, its parameters on the engine's device."""
        return self._model

    def generate(self, prompt, max_new_tokens=32, **kw) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(prompt, max_new_tokens, **kw).result()

    def swap_params(self, params):
        raise not_ported("live weight swap (swap_params)")

    def import_stream(self, *args, **kwargs):
        raise not_ported("KV-page stream import (import_stream)")

    def reset_stats(self) -> None:
        """Zero the counters and latency samples so the next
        :meth:`stats` covers only work from here on."""
        self._metrics.reset()

    def stats(self) -> dict:
        m = self._metrics
        with m._lock:
            c = dict(m.counters)
            wall = time.perf_counter() - m.t0
        out = {k: int(c.get(k, 0)) for k in
               ("requests", "generations", "tokens", "prefill_tokens",
                "preempted", "prefills", "steps", "stream_steps",
                "d2h_syncs")}
        for name, key in (("time_per_token_ms", ""), ("ttft_ms", "ttft_"),
                          ("step_ms", "step_"), ("prefill_ms", "prefill_"),
                          ("queue_wait_ms", "queue_wait_")):
            h = m.percentiles(name)
            for q in ("p50", "p90", "p99"):
                out[f"{key}{q}_ms"] = h[q] if h else None
        out["tokens_per_s"] = out["tokens"] / wall if wall > 0 else 0.0
        out["cache_util"] = self._alloc.utilization()
        out["cache_blocks_free"] = self._alloc.free_blocks
        out["kv_dtype"] = self._kv_dtype
        out["pool_bytes"] = self._pool_bytes
        with self._lock:
            out["active_streams"] = len(self._active)
            out["pending"] = len(self._pending)
        out["decode_buckets"] = list(self._decode_buckets)
        out["cache_buckets"] = list(self._cache_buckets)
        out["prefill_buckets"] = list(self._prefill_buckets)
        out["kv_block"] = self._kv_block
        out["device"] = str(self._device)
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
            self._pending, self._active = [], []
        for s in streams:
            if s.blocks:
                self._alloc.free(s.blocks)
                s.blocks = []
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

    def _feed(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """One host-to-device copy for a step's int32 feeds, handed back
        as contiguous views of the arrays' shapes."""
        flat = np.concatenate([a.ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self._device)
        out, off = [], 0
        for a in arrays:
            out.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def _loop(self):
        try:
            while True:
                with self._cond:
                    while self._alive and not self._pending \
                            and not self._active:
                        self._cond.wait(timeout=0.5)
                    if not self._alive:
                        return
                self._admit()
                if self._active:
                    self._step()
                elif self._pending:
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
        prompt's pages plus one block of decode headroom (capped at the
        stream's lifetime need, so a request sized exactly to the pool
        still admits)."""
        while True:
            with self._lock:
                if not self._pending \
                        or len(self._active) >= self._max_streams:
                    return
                s = self._pending[0]
                seq = s.prefill_seq()
                need = blocks_for_tokens(max(len(seq), 1), self._kv_block)
                lifetime = blocks_for_tokens(len(s.prompt) + s.max_new,
                                             self._kv_block)
                if self._alloc.free_blocks < min(need + 1, lifetime):
                    return  # not enough cache: hold the FIFO line
                self._pending.pop(0)
                self._admitting = s  # visible to _fail_outstanding
            pages = self._alloc.alloc(need, owner=s.sid)
            if pages is None:  # pragma: no cover - checked just above
                raise MXNetError(f"admission raced the allocator: {need} "
                                 f"pages unavailable")
            s.blocks = pages
            self._prefill(s, seq)
            self._admitting = None

    def _prefill(self, s: _Stream, seq: np.ndarray):
        """Prefill one stream: B = 1, the prompt padded to its bucket;
        rows past the prompt write to the scratch page and are never
        read."""
        n = len(seq)
        t0 = time.perf_counter()
        tp = self._bucket(self._prefill_buckets, n, "prompt length")
        mb = tp // self._kv_block
        tokens = np.zeros((1, tp), np.int32)
        tokens[0, :n] = seq
        positions = np.arange(tp, dtype=np.int32)[None]
        lengths = np.asarray([n], np.int32)
        table = np.zeros((1, mb), np.int32)
        table[0, :len(s.blocks)] = s.blocks
        tok_d, pos_d, len_d, tab_d = self._feed(tokens, positions, lengths,
                                                table)
        logits = self._model.prefill(tok_d, pos_d, len_d, tab_d,
                                     self._pools)
        toks = sample_tokens(logits[:, n - 1], np.asarray([s.temp]),
                             np.asarray([s.seed]), np.asarray([n - 1]),
                             self._seed)
        first = int(toks.cpu()[0])  # the one device-to-host copy
        t_done = time.perf_counter()
        self._metrics.inc("d2h_syncs")
        s.length = n
        self._metrics.observe("prefill_ms", (t_done - t0) * 1e3)
        self._metrics.observe("queue_wait_ms", (t0 - s.t_enqueue) * 1e3)
        s.t_admit = t_done
        if s.resume:
            s.resume = False  # next_token survives preemption
        else:
            s.next_token = first
            s.generated.append(first)
            self._metrics.observe("ttft_ms", (t_done - s.t_submit) * 1e3)
            self._metrics.inc("tokens")
        self._metrics.inc("prefills")
        self._metrics.inc("prefill_tokens", n)
        if s.done():  # max_new == 1 or instant eos
            self._retire(s)
        else:
            with self._lock:
                self._active.append(s)

    def _alloc_with_preempt(self, s: _Stream, n: int) -> Optional[List[int]]:
        """Pages for active stream ``s``, preempting the youngest other
        stream while the pool is dry.  None: ``s`` itself could not be
        kept and was failed."""
        while True:
            pages = self._alloc.alloc(n, owner=s.sid)
            if pages is not None:
                return pages
            # a victim must be able to come back: its re-prefill has to
            # fit the prefill ladder
            victims = [v for v in self._active if v is not s
                       and v.length <= self._prefill_buckets[-1]]
            if not victims:
                with self._lock:
                    self._active.remove(s)
                self._alloc.free(s.blocks)
                s.blocks = []
                if s.future.set_running_or_notify_cancel():
                    s.future.set_exception(MXNetError(
                        f"KV cache exhausted: stream {s.sid} needs a page "
                        f"and no preemptable stream remains (pool: "
                        f"{self._alloc.capacity} blocks); size "
                        f"cache_blocks for the workload"))
                return None
            self._preempt(max(victims, key=lambda v: v.t_admit))

    def _ensure_capacity(self, s: _Stream) -> bool:
        """Grow ``s`` to hold its next token's page; False when ``s``
        itself could not be kept resident."""
        need = blocks_for_tokens(s.length + 1, self._kv_block) \
            - len(s.blocks)
        if need <= 0:
            return True
        pages = self._alloc_with_preempt(s, need)
        if pages is None:
            return False
        s.blocks.extend(pages)
        return True

    def _preempt(self, victim: _Stream):
        """Recompute-style preemption: free the victim's pages and queue
        it at the front for re-prefill of prompt + progress."""
        self._alloc.free(victim.blocks)
        victim.blocks = []
        victim.length = 0
        victim.resume = bool(victim.generated)
        victim.t_enqueue = time.perf_counter()
        with self._lock:
            self._active.remove(victim)
            self._pending.insert(0, victim)
        self._metrics.inc("preempted")

    def _retire(self, s: _Stream):
        if s.blocks:
            self._alloc.free(s.blocks)
            s.blocks = []
        if s.future.set_running_or_notify_cancel():
            s.future.set_result(np.asarray(s.generated, np.int32))
        self._metrics.inc("generations")

    def _step(self):
        """One decode step over every active stream, unpipelined: feed,
        run, then one (B,) int32 copy to the host."""
        t0 = time.perf_counter()
        for s in list(self._active):
            if s in self._active:
                self._ensure_capacity(s)
        with self._lock:
            streams = list(self._active)
        if not streams:
            return
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
        tok_d, pos_d, len_d, tab_d = self._feed(tokens, positions, lengths,
                                                table)
        logits = self._model.decode(tok_d, pos_d, len_d, tab_d, self._pools)
        toks = sample_tokens(logits[:, 0], temps, seeds, steps, self._seed)
        toks = toks.cpu().numpy()  # the step's one device-to-host copy
        t_done = time.perf_counter()
        self._metrics.inc("d2h_syncs")
        self._absorb_step(streams, toks, t0, t_done)

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
            self._metrics.observe("time_per_token_ms", step_ms)
            if s.done():
                retired.append(s)
        if retired:
            with self._lock:
                for s in retired:
                    self._active.remove(s)
            for s in retired:
                self._retire(s)
