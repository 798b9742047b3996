"""Paged LoRA adapter pool and tenant quotas: the multi-tenant layer.

Counterpart of ``mxnet_tpu/adapters.py``.  Many fine-tuned variants of
one base model share its weights: every tenant's low-rank (A, B) pair
lives in a fixed device slab, and each stream's pair is gathered by slot
id inside the serving forward (``ops/adapter.py``'s
``lora_gather_delta``), so one batch mixes tenants (S-LoRA, Sheng et al.
'23; Punica, Chen et al. '23).

* :class:`AdapterPool`: ref-counted, LRU-evicted slots in rank buckets,
  each bucket over one ``kv_cache.BlockAllocator`` whose "pages" are
  adapter slots (page 0, the allocator's scratch page, is the null
  adapter).  ``publish`` writes the padded rows and parks the slot
  (resident, refcount 0, evictable); a stream's ``acquire`` revives or
  shares it; the last ``release`` parks it again.  An evicted adapter
  re-installs from its host copy at the next acquire: a counted miss,
  not a failure.  Eviction is strict LRU by acquire clock, slot id
  breaking ties, so two pools fed the same calls evict alike.
* :class:`TenantQuota`: per-tenant token buckets for admission
  (``MXNET_TENANT_QUOTA_TOKENS`` / ``_REFILL``); an empty bucket sheds
  with the typed :class:`QuotaExceededError`.

The slabs are device tensors, ``(slots + 1, L, d_model, rb)`` and
``(slots + 1, L, rb, d_out)`` a bucket, row 0 zeros.  Where the JAX pool
replaces a slab array on every publish, this one writes the slot's rows
in place, under the pool's lock, with a copy from host memory that is
complete on the device when it returns, and ``slabs()`` hands out the
same tensors under that lock.  No step can see a torn write: a step
reads only the rows of the slots its streams hold, and a held slot
(refcount >= 1) is never written — only a free slot or a parked one
(refcount 0, whose last holder retired after its last step's result
reached the host) is installed into.  So publish and retire need no
drain and copy no slab.

Numerics: ``alpha / r`` is folded into B at publish; a rank-r pair is
zero-padded into the smallest bucket >= r (exact: padded lanes multiply
zero rows); slot 0's rows are zeros and the gather where-selects the
base bits for slot-0 streams, so streams without an adapter are bit for
bit the pre-adapter engine's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .base import MXNetError, get_env
from .context import current_context
from .kv_cache import BlockAllocator
from .ndarray import torch_dtype

__all__ = ["AdapterPool", "TenantQuota", "QuotaExceededError",
           "adapters_enabled", "pool_from_env", "quota_from_env"]


# ---------------------------------------------------------------------------
# env readers (validated at construction, defaults from the catalog)
# ---------------------------------------------------------------------------


def _env_int(name, lo):
    from . import config

    raw = get_env(name, None, str)
    if raw is None:
        return config.describe(name).default
    try:
        v = int(raw)
    except ValueError:
        raise MXNetError(f"{name}={raw!r} is not an integer")
    if v < lo:
        raise MXNetError(f"{name}={v} must be >= {lo}")
    return v


def _env_float(name, lo):
    from . import config

    raw = get_env(name, None, str)
    if raw is None:
        return config.describe(name).default
    try:
        v = float(raw)
    except ValueError:
        raise MXNetError(f"{name}={raw!r} is not a number")
    if v < lo:
        raise MXNetError(f"{name}={v} must be >= {lo}")
    return v


def adapters_enabled() -> bool:
    """``MXNET_ADAPTER_ENABLE``, 0 or 1."""
    v = _env_int("MXNET_ADAPTER_ENABLE", 0)
    if v not in (0, 1):
        raise MXNetError(f"MXNET_ADAPTER_ENABLE={v} must be 0 or 1")
    return bool(v)


def _env_rank_buckets() -> Tuple[int, ...]:
    from . import config

    raw = get_env("MXNET_ADAPTER_RANK_BUCKETS", None, str)
    if raw is None:
        raw = config.describe("MXNET_ADAPTER_RANK_BUCKETS").default
    try:
        vals = [int(x) for x in str(raw).split(",") if x.strip()]
    except ValueError:
        raise MXNetError(f"MXNET_ADAPTER_RANK_BUCKETS={raw!r} is not a "
                         f"comma-separated list of integers")
    if not vals or any(v < 1 for v in vals) \
            or any(b <= a for a, b in zip(vals, vals[1:])):
        raise MXNetError(f"MXNET_ADAPTER_RANK_BUCKETS={raw!r} must be "
                         f"a strictly increasing list of positive ints")
    return tuple(vals)


def pool_from_env(num_layers: int, d_model: int,
                  d_out: Optional[int] = None, ctx=None) -> "AdapterPool":
    """An :class:`AdapterPool` sized by ``MXNET_ADAPTER_SLOTS`` /
    ``MXNET_ADAPTER_RANK_BUCKETS`` for the model geometry, its slabs on
    ``ctx``."""
    return AdapterPool(num_layers=num_layers, d_model=d_model,
                       d_out=d_out,
                       slots=_env_int("MXNET_ADAPTER_SLOTS", 1),
                       rank_buckets=_env_rank_buckets(), ctx=ctx)


def quota_from_env(clock=None) -> Optional["TenantQuota"]:
    """A :class:`TenantQuota` from ``MXNET_TENANT_QUOTA_TOKENS`` /
    ``MXNET_TENANT_QUOTA_REFILL``, or None when quotas are off."""
    cap = _env_int("MXNET_TENANT_QUOTA_TOKENS", 0)
    refill = _env_float("MXNET_TENANT_QUOTA_REFILL", 0.0)
    if cap == 0:
        return None
    return TenantQuota(cap, refill_rate=refill, clock=clock)


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------


class QuotaExceededError(MXNetError):
    """The typed per-tenant admission shed: the tenant's token bucket
    cannot cover the request.  ``reason`` feeds the engine's shed
    counters (``shed_tenant_quota``); ``tenant``, ``needed`` and
    ``balance`` make the refusal auditable."""

    def __init__(self, msg: str, tenant: str, needed: int,
                 balance: float):
        super().__init__(msg)
        self.reason = "tenant_quota"
        self.tenant = tenant
        self.needed = int(needed)
        self.balance = float(balance)


class TenantQuota:
    """Per-tenant token buckets of ``capacity`` tokens, refilling at
    ``refill_rate`` tokens a second (0: a hard lifetime cap).  A bucket
    is created full at a tenant's first request; requests without a
    tenant are never charged.  ``clock`` is injectable (default
    ``time.monotonic``)."""

    def __init__(self, capacity: int, refill_rate: float = 0.0,
                 clock=None):
        if capacity < 0:
            raise MXNetError(
                f"MXNET_TENANT_QUOTA_TOKENS={capacity} must be >= 0")
        if refill_rate < 0:
            raise MXNetError(
                f"MXNET_TENANT_QUOTA_REFILL={refill_rate} must be >= 0")
        self.capacity = int(capacity)
        self.refill_rate = float(refill_rate)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._level: Dict[str, float] = {}   # tenant -> tokens left
        self._stamp: Dict[str, float] = {}   # tenant -> last refill time
        self.charged: Dict[str, int] = {}    # tenant -> tokens admitted
        self.shed: Dict[str, int] = {}       # tenant -> requests shed

    def _refill_locked(self, tenant: str) -> None:
        now = self._clock()
        if tenant not in self._level:
            self._level[tenant] = float(self.capacity)
            self._stamp[tenant] = now
            return
        if self.refill_rate > 0:
            dt = max(0.0, now - self._stamp[tenant])
            self._level[tenant] = min(
                float(self.capacity),
                self._level[tenant] + dt * self.refill_rate)
        self._stamp[tenant] = now

    def charge(self, tenant: str, tokens: int) -> None:
        """Debit ``tokens`` from ``tenant``'s bucket, or raise
        :class:`QuotaExceededError` charging nothing."""
        if self.capacity == 0:
            return
        with self._lock:
            self._refill_locked(tenant)
            if self._level[tenant] < tokens:
                self.shed[tenant] = self.shed.get(tenant, 0) + 1
                raise QuotaExceededError(
                    f"tenant {tenant!r} quota exhausted: request needs "
                    f"{tokens} tokens, {self._level[tenant]:.0f} left "
                    f"of {self.capacity} (MXNET_TENANT_QUOTA_TOKENS; "
                    f"refill {self.refill_rate}/s)",
                    tenant, tokens, self._level[tenant])
            self._level[tenant] -= tokens
            self.charged[tenant] = self.charged.get(tenant, 0) + tokens

    def refund(self, tenant: str, tokens: int) -> None:
        """Give back tokens a refused request was charged."""
        if self.capacity == 0 or tokens <= 0:
            return
        with self._lock:
            if tenant in self._level:
                self._level[tenant] = min(float(self.capacity),
                                          self._level[tenant] + tokens)

    def balance(self, tenant: str) -> float:
        with self._lock:
            self._refill_locked(tenant)
            return self._level[tenant]

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            tenants = set(self._level) | set(self.charged) | set(self.shed)
            return {t: {"balance": self._level.get(t, self.capacity),
                        "charged": self.charged.get(t, 0),
                        "shed": self.shed.get(t, 0)}
                    for t in sorted(tenants)}


# ---------------------------------------------------------------------------
# the adapter pool
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("name", "rank", "bucket", "slot", "a_host", "b_host",
                 "last_used", "retiring", "publishes")

    def __init__(self, name, rank, bucket, a_host, b_host):
        self.name = name
        self.rank = rank
        self.bucket = bucket
        self.slot: Optional[int] = None
        self.a_host = a_host        # (L, d_model, rb) padded, host
        self.b_host = b_host        # (L, rb, d_out) padded and scaled
        self.last_used = 0
        self.retiring = False
        self.publishes = 0


class AdapterPool:
    """Ref-counted, LRU-evicted device slabs of LoRA adapters.

    ``slots`` resident adapters a rank bucket (device rows: slots + 1,
    row 0 the null adapter).  ``rank_buckets`` is the strictly
    increasing ladder of ranks; a rank-r adapter is zero-padded into the
    smallest bucket >= r.  ``d_out`` defaults to ``3 * d_model``, the
    fused QKV projection, the one LoRA site of the serving forward.
    ``ctx`` is the slabs' device (default ``gpu(0)``; the engine serving
    the pool must run there), ``dtype`` their element type (the host
    copies are float32, rounded to ``dtype`` once at install).

    Thread-safe: the scheduler thread acquires and releases a stream's
    reference while ``publish``/``retire`` come from other threads."""

    def __init__(self, *, num_layers: int, d_model: int,
                 d_out: Optional[int] = None, slots: int = 8,
                 rank_buckets: Tuple[int, ...] = (8,),
                 dtype="float32", ctx=None):
        if slots < 1:
            raise MXNetError(
                f"MXNET_ADAPTER_SLOTS={slots} must be >= 1")
        buckets = tuple(int(b) for b in rank_buckets)
        if not buckets or any(b < 1 for b in buckets) \
                or any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            raise MXNetError(
                f"MXNET_ADAPTER_RANK_BUCKETS={rank_buckets!r} must be "
                f"a strictly increasing list of positive ints")
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.d_out = int(d_out) if d_out else 3 * self.d_model
        self.slots = int(slots)
        self.rank_buckets = buckets
        self.device = (ctx if ctx is not None
                       else current_context()).torch_device()
        tdt = torch_dtype(dtype)
        # host copies in float32; the slabs take ``dtype`` at install
        self._dtype = np.dtype(np.float32)
        self._lock = threading.RLock()
        self._clock = 0
        # one allocator a bucket: "pages" are adapter slots, page 0 (the
        # allocator's scratch page) the null adapter
        self._alloc: Dict[int, BlockAllocator] = {
            rb: BlockAllocator(self.slots + 1, 1) for rb in buckets}
        self._a = {rb: torch.zeros((self.slots + 1, self.num_layers,
                                    self.d_model, rb), dtype=tdt,
                                   device=self.device) for rb in buckets}
        self._b = {rb: torch.zeros((self.slots + 1, self.num_layers, rb,
                                    self.d_out), dtype=tdt,
                                   device=self.device) for rb in buckets}
        self._entries: Dict[str, _Entry] = {}
        self._by_slot: Dict[Tuple[int, int], str] = {}  # (rb, slot)->name
        self.counters = {"publishes": 0, "retires": 0, "hits": 0,
                         "misses": 0, "evictions": 0, "releases": 0}

    # -- internals -------------------------------------------------------

    def _bucket_for(self, rank: int) -> int:
        for rb in self.rank_buckets:
            if rank <= rb:
                return rb
        raise MXNetError(
            f"adapter rank {rank} exceeds the largest rank bucket "
            f"{self.rank_buckets[-1]} (MXNET_ADAPTER_RANK_BUCKETS="
            f"{','.join(map(str, self.rank_buckets))})")

    def _evict_lru_locked(self, rb: int) -> bool:
        """Reclaim the least recently used parked slot of bucket ``rb``:
        acquire-clock order, slot id breaking ties."""
        alloc = self._alloc[rb]
        victim = None
        for (b, slot), name in self._by_slot.items():
            if b != rb or not alloc.is_parked(slot):
                continue
            key = (self._entries[name].last_used, slot)
            if victim is None or key < victim[0]:
                victim = (key, slot, name)
        if victim is None:
            return False
        _, slot, name = victim
        alloc.reclaim(slot)
        del self._by_slot[(rb, slot)]
        self._entries[name].slot = None
        self.counters["evictions"] += 1
        return True

    def _install_locked(self, e: _Entry) -> int:
        """Place ``e`` in a slot of its bucket (evicting LRU parked slots
        as needed) and write its rows in place.  The slot is free or was
        parked: no stream's step reads it."""
        alloc = self._alloc[e.bucket]
        got = alloc.alloc(1, owner=e.name)
        while got is None:
            if not self._evict_lru_locked(e.bucket):
                live = [n for (b, s), n in self._by_slot.items()
                        if b == e.bucket and not alloc.is_parked(s)]
                raise MXNetError(
                    f"adapter pool bucket r{e.bucket} is full: all "
                    f"{self.slots} slots are held by live streams "
                    f"({sorted(live)}); raise MXNET_ADAPTER_SLOTS or "
                    f"retire an adapter")
            got = alloc.alloc(1, owner=e.name)
        slot = got[0]
        # a blocking copy from host memory: complete on the device when
        # it returns, so any later step (on any stream) reads the rows
        self._a[e.bucket][slot].copy_(torch.from_numpy(e.a_host))
        self._b[e.bucket][slot].copy_(torch.from_numpy(e.b_host))
        self._by_slot[(e.bucket, slot)] = e.name
        e.slot = slot
        e.publishes += 1
        return slot

    # -- public API --------------------------------------------------------

    def publish(self, name: str, a, b, alpha: Optional[float] = None):
        """Register adapter ``name`` from A (L, d_model, r) and B (L, r,
        d_out) (2-D: one matrix for every layer), folding ``alpha / r``
        into B (``alpha=None``: scale 1) and zero-padding rank r into its
        bucket.  The slot is written at once and parked (resident,
        evictable).  Publishing a published name raises: retire it
        first.  Returns the slot."""
        a = np.asarray(a, self._dtype)
        b = np.asarray(b, self._dtype)
        if a.ndim == 2:
            a = np.broadcast_to(a, (self.num_layers,) + a.shape).copy()
        if b.ndim == 2:
            b = np.broadcast_to(b, (self.num_layers,) + b.shape).copy()
        if a.ndim != 3 or a.shape[0] != self.num_layers \
                or a.shape[1] != self.d_model:
            raise MXNetError(
                f"adapter {name!r}: A must be (num_layers="
                f"{self.num_layers}, d_model={self.d_model}, r); got "
                f"{a.shape}")
        r = a.shape[2]
        if b.shape != (self.num_layers, r, self.d_out):
            raise MXNetError(
                f"adapter {name!r}: B must be (num_layers="
                f"{self.num_layers}, r={r}, d_out={self.d_out}); got "
                f"{b.shape}")
        if r < 1:
            raise MXNetError(f"adapter {name!r}: rank must be >= 1")
        rb = self._bucket_for(r)
        scale = 1.0 if alpha is None else float(alpha) / r
        a_pad = np.zeros((self.num_layers, self.d_model, rb), self._dtype)
        b_pad = np.zeros((self.num_layers, rb, self.d_out), self._dtype)
        a_pad[:, :, :r] = a
        b_pad[:, :r, :] = b * self._dtype.type(scale)
        with self._lock:
            if name in self._entries:
                raise MXNetError(
                    f"adapter {name!r} is already published — "
                    f"retire_adapter it before republishing")
            e = _Entry(name, r, rb, a_pad, b_pad)
            self._clock += 1
            e.last_used = self._clock
            slot = self._install_locked(e)
            # parked: resident but evictable until a stream acquires it
            self._alloc[rb].release(slot, park=True)
            self._entries[name] = e
            self.counters["publishes"] += 1
            return slot

    def retire(self, name: str) -> bool:
        """Unregister ``name``: True when its slot was freed now, False
        when live streams still hold it (the retire completes at their
        last :meth:`release`)."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise MXNetError(f"retire of unknown adapter {name!r} "
                                 f"(published: {sorted(self._entries)})")
            self.counters["retires"] += 1
            if e.slot is None:                      # evicted already
                del self._entries[name]
                return True
            alloc = self._alloc[e.bucket]
            if alloc.is_parked(e.slot):             # resident, idle
                alloc.reclaim(e.slot)
                del self._by_slot[(e.bucket, e.slot)]
                del self._entries[name]
                return True
            e.retiring = True                       # live holders
            return False

    def acquire(self, name: str) -> Tuple[int, int]:
        """Take one stream reference on ``name`` → ``(bucket, slot)``.
        A parked slot revives (a hit); an evicted adapter re-installs
        from its host copy (a miss).  Unknown or retiring names raise."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise MXNetError(
                    f"unknown adapter {name!r} (published: "
                    f"{sorted(self._entries)}) — publish_adapter it "
                    f"first")
            if e.retiring:
                raise MXNetError(
                    f"adapter {name!r} is retiring — no new streams")
            self._clock += 1
            e.last_used = self._clock
            alloc = self._alloc[e.bucket]
            if e.slot is not None:
                if alloc.is_parked(e.slot):
                    alloc.revive(e.slot, owner=name)
                else:
                    alloc.share(e.slot)
                self.counters["hits"] += 1
            else:
                self._install_locked(e)   # refcount 1, not parked
                self.counters["misses"] += 1
            return e.bucket, e.slot

    def release(self, name: str) -> None:
        """Drop one stream reference; the last parks the slot, or frees
        it when a retire is pending."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.slot is None:
                raise MXNetError(f"release of unknown/evicted adapter "
                                 f"{name!r}")
            alloc = self._alloc[e.bucket]
            self.counters["releases"] += 1
            left = alloc.release(e.slot, park=not e.retiring)
            if left == 0 and e.retiring:
                del self._by_slot[(e.bucket, e.slot)]
                del self._entries[name]

    def refcount(self, name: str) -> int:
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.slot is None:
                return 0
            return self._alloc[e.bucket].refcount(e.slot)

    def bucket_of(self, name: str) -> int:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise MXNetError(f"unknown adapter {name!r}")
            return e.bucket

    def slabs(self) -> List[torch.Tensor]:
        """The device slabs, bucket-major: ``[a_r{b1}, b_r{b1}, a_r{b2},
        ...]``, the same tensors every call (rows written in place)."""
        with self._lock:
            out = []
            for rb in self.rank_buckets:
                out.extend((self._a[rb], self._b[rb]))
            return out

    def export_adapters(self) -> List[Tuple[str, np.ndarray, np.ndarray,
                                            int]]:
        """Host copies of every published adapter (padded A, scaled
        padded B, rank)."""
        with self._lock:
            return [(e.name, e.a_host.copy(), e.b_host.copy(), e.rank)
                    for e in self._entries.values() if not e.retiring]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            per_bucket = {}
            for rb in self.rank_buckets:
                al = self._alloc[rb]
                per_bucket[f"r{rb}"] = {
                    "slots": self.slots,
                    "live": al.used_blocks,
                    "parked": al.parked_blocks,
                    "free": al.free_list_blocks,
                }
            return dict(self.counters, published=len(self._entries),
                        buckets=per_bucket)
