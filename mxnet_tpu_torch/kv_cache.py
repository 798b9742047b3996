"""Paged KV-cache bookkeeping: the host side of the paged cache.

Own copy of the parts of ``mxnet_tpu/kv_cache.py`` that the serving
slice runs.  The device side is two pool tensors per layer,
``k_pool``/``v_pool`` of shape ``(num_blocks, block_tokens, H, D)``,
plus, for int8/fp8 storage, two float32 scale pools
``(num_blocks, block_tokens, H)``, all written in place by
``ops/attention.py``.  This module decides which
pages belong to which stream (PagedAttention, Kwon et al. SOSP '23):

* memory is carved into fixed-size token pages; a stream holds
  ``ceil(tokens / block_tokens)`` of them;
* the block table maps a stream's logical block to a page id; pages
  come from a free list in any order, so churn fragments the table,
  never the memory;
* page 0 is reserved scratch: padded batch slots and padded prompt
  rows write there, and every read of it is masked by the stream's
  length;
* pages are reference counted, so streams with a common prompt prefix
  share its pages (``prefix_cache.PrefixCache``); a page whose last
  holder lets go while the prefix index still maps it is parked: it
  keeps its bytes until a hit revives it or an eviction reclaims it.

Page export and import (stream migration between engines) belong to the
fleet, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import torch

from .base import MXNetError

__all__ = ["BlockAllocator", "blocks_for_tokens", "bucket_ladder",
           "kv_storage_dtype", "kv_quantized", "pool_device_bytes",
           "trim_blocks", "KV_DTYPES", "KV_QMAX", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0

# the JAX package's MXNET_SERVING_KV_DTYPE vocabulary.  fp32 is exact;
# bf16 is a plain narrow cast; int8/fp8 store codes plus one float32
# scale per (slot, head), dequantized inside the decode attention (fp32
# softmax throughout)
KV_DTYPES = ("fp32", "bf16", "int8", "fp8")
KV_QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3 finite max


def kv_quantized(name: str) -> bool:
    """Does this KV storage dtype carry per-slot scale pools?"""
    return name in KV_QMAX


def kv_storage_dtype(name: str) -> torch.dtype:
    """Torch dtype backing the K/V pools for a kv_dtype name.  fp8 is
    ``torch.float8_e4m3fn``: the encoding of ml_dtypes' float8_e4m3fn
    and of CUDA's ``__nv_fp8_e4m3``."""
    if name == "fp32":
        return torch.float32
    if name == "bf16":
        return torch.bfloat16
    if name == "int8":
        return torch.int8
    if name == "fp8":
        return torch.float8_e4m3fn
    raise MXNetError(f"unknown KV cache dtype {name!r} (wants one of "
                     f"{KV_DTYPES})")


def pool_device_bytes(cache_blocks: int, kv_block: int, num_layers: int,
                      num_heads: int, d_model: int,
                      kv_dtype: str = "fp32") -> int:
    """Bytes of K/V pool (values plus quantization scales) of one
    engine's device: what ``DecodeEngine.stats()["pool_bytes"]``
    reports."""
    d_head = int(d_model) // int(num_heads)
    slots = int(num_layers) * int(cache_blocks) * int(kv_block) \
        * int(num_heads)
    itemsize = torch.empty(0, dtype=kv_storage_dtype(kv_dtype)).element_size()
    total = 2 * slots * d_head * itemsize
    if kv_quantized(kv_dtype):
        total += 2 * slots * 4  # per-slot-per-head float32 scales
    return total


def blocks_for_tokens(tokens: int, block_tokens: int) -> int:
    """Pages needed to hold ``tokens`` cache entries; 0 tokens need 0
    pages, negative counts raise."""
    tokens = int(tokens)
    if tokens < 0:
        raise MXNetError(f"blocks_for_tokens({tokens}): negative")
    return -(-tokens // int(block_tokens))


def trim_blocks(blocks: List[int], tokens: int, block_tokens: int):
    """Split a stream's page list after a speculative-verify rollback
    into (keep, surplus): ``keep`` covers ``tokens`` cache slots,
    ``surplus`` held only rejected window writes (every read of them is
    length-masked, every later write overwrites before a read), so the
    caller returns it to the pool.  Pages are positional, so the split
    is a prefix split."""
    keep = blocks_for_tokens(tokens, block_tokens)
    if keep >= len(blocks):
        return blocks, []
    return blocks[:keep], blocks[keep:]


def bucket_ladder(max_value: int, base: int = 1) -> List[int]:
    """Doubling ladder ``base, 2*base, ...`` capped at (and always
    including) ``max_value`` — the bucketing of batch sizes, table
    widths and prefill lengths, so kernels see few distinct shapes."""
    if int(max_value) < 1:
        raise MXNetError(
            f"bucket_ladder({max_value}): a bucket ladder needs a "
            f"positive top")
    out = []
    v = max(1, int(base))
    while v < max_value:
        out.append(v)
        v *= 2
    out.append(int(max_value))
    return out


class BlockAllocator:
    """Ref-counted free-list allocator over ``num_blocks`` fixed-size
    token pages.

    Page 0 is the reserved scratch page and never handed out.  ``alloc``
    is all-or-nothing: a request that cannot be fully met takes nothing,
    and the caller decides whether to preempt, evict or wait.  Pages come
    back at refcount 1; ``share`` attaches another holder, ``release``
    detaches one.  A released page returns to the free list or, with
    ``park=True``, keeps its bytes as reclaimable cache.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise MXNetError(
                f"BlockAllocator needs >= 2 blocks (1 scratch + 1 "
                f"usable); got {num_blocks}")
        if block_tokens < 1:
            raise MXNetError(f"bad block_tokens {block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        # LIFO free list: recently freed pages are reused first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owner: Dict[int, object] = {}  # page -> stream tag
        self._refs: Dict[int, int] = {}      # page -> holder count
        self._parked: Set[int] = set()       # refcount-0 cached pages

    @property
    def capacity(self) -> int:
        """Allocatable pages (the scratch page excluded)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Pages a new allocation can have: free ones plus parked ones,
        which are reclaimable on demand.  A page N streams share is
        absent from this count once."""
        return len(self._free) + len(self._parked)

    @property
    def used_blocks(self) -> int:
        """Pages some stream references (refcount >= 1), each once."""
        return self.capacity - self.free_blocks

    @property
    def free_list_blocks(self) -> int:
        """Pages allocatable without an eviction."""
        return len(self._free)

    @property
    def parked_blocks(self) -> int:
        """Refcount-0 cached pages awaiting revival or reclaim."""
        return len(self._parked)

    @property
    def shared_blocks(self) -> int:
        """Pages referenced by more than one stream."""
        return sum(1 for r in self._refs.values() if r > 1)

    def utilization(self) -> float:
        return self.used_blocks / self.capacity

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def is_parked(self, page: int) -> bool:
        return page in self._parked

    def alloc(self, n: int, owner=None) -> Optional[List[int]]:
        """Take ``n`` pages at refcount 1, or None (taking nothing) if
        the free list holds fewer.  Parked pages are not taken: the
        prefix cache's eviction must ``reclaim`` them first, so an
        eviction is always an explicit, counted decision."""
        if n < 0:
            raise MXNetError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
            self._refs[p] = 1
        return pages

    def share(self, page: int) -> int:
        """Attach one more holder to a live page; returns the new
        refcount."""
        if page not in self._refs:
            raise MXNetError(f"share of non-live page {page}")
        self._refs[page] += 1
        return self._refs[page]

    def revive(self, page: int, owner=None) -> None:
        """Re-activate a parked page at refcount 1 (a prefix hit on a
        cached page no stream holds)."""
        if page not in self._parked:
            raise MXNetError(f"revive of non-parked page {page} "
                             f"(parked: {sorted(self._parked)})")
        self._parked.discard(page)
        self._owner[page] = owner
        self._refs[page] = 1

    def release(self, page: int, park: bool = False) -> int:
        """Detach one holder; returns the refcount left.  At zero the
        page returns to the free list or, with ``park``, keeps its bytes
        as reclaimable cache (the prefix index still maps them)."""
        if page not in self._refs:
            raise MXNetError(f"release of non-live page {page}")
        self._refs[page] -= 1
        left = self._refs[page]
        if left == 0:
            del self._refs[page]
            del self._owner[page]
            if park:
                self._parked.add(page)
            else:
                self._free.append(page)
        return left

    def reclaim(self, page: int) -> None:
        """Move a parked page to the free list (the prefix index dropped
        its entry: an eviction)."""
        if page not in self._parked:
            raise MXNetError(f"reclaim of non-parked page {page}")
        self._parked.discard(page)
        self._free.append(page)

    def free(self, pages: List[int]) -> None:
        """Terminal free of exclusively held pages.  A page another
        stream still references raises: handing it to a new stream while
        the sharer reads it would corrupt the sharer.  Shared pages go
        through :meth:`release`; a parked page frees as a reclaim."""
        for p in pages:
            if p == SCRATCH_PAGE:
                raise MXNetError("attempt to free the scratch page")
            if p in self._parked:
                self._parked.discard(p)
                self._free.append(p)
                continue
            if p not in self._owner:
                raise MXNetError(
                    f"double free / foreign page {p} (owned pages: "
                    f"{sorted(self._owner)})")
            if self._refs.get(p, 0) > 1:
                raise MXNetError(
                    f"free of page {p} with {self._refs[p]} live "
                    f"references: another stream still reads it; "
                    f"release() the caller's reference instead")
            del self._owner[p]
            self._refs.pop(p, None)
            self._free.append(p)
