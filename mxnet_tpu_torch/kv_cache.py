"""Paged KV-cache bookkeeping: the host side of the paged cache.

Own copy of the parts of ``mxnet_tpu/kv_cache.py`` that the serving
slice runs.  The device side is two pool tensors per layer,
``k_pool``/``v_pool`` of shape ``(num_blocks, block_tokens, H, D)``,
written in place by ``ops/attention.py``.  This module decides which
pages belong to which stream (PagedAttention, Kwon et al. SOSP '23):

* memory is carved into fixed-size token pages; a stream holds
  ``ceil(tokens / block_tokens)`` of them;
* the block table maps a stream's logical block to a page id; pages
  come from a free list in any order, so churn fragments the table,
  never the memory;
* page 0 is reserved scratch: padded batch slots and padded prompt
  rows write there, and every read of it is masked by the stream's
  length.

Reference counting, parking and page export (prefix cache, migration)
belong to features that are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError, not_ported

__all__ = ["BlockAllocator", "blocks_for_tokens", "bucket_ladder",
           "kv_storage_dtype", "KV_DTYPES", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0

# the JAX package's MXNET_SERVING_KV_DTYPE vocabulary; the port stores
# fp32 and bf16 pools, the quantized two are still to come
KV_DTYPES = ("fp32", "bf16", "int8", "fp8")


def kv_storage_dtype(name: str) -> torch.dtype:
    """Torch dtype backing the K/V pools for a kv_dtype name."""
    if name == "fp32":
        return torch.float32
    if name == "bf16":
        return torch.bfloat16
    if name in ("int8", "fp8"):
        raise not_ported(f"kv_dtype {name!r} (quantized KV pages)")
    raise MXNetError(f"unknown KV cache dtype {name!r} (wants one of "
                     f"{KV_DTYPES})")


def blocks_for_tokens(tokens: int, block_tokens: int) -> int:
    """Pages needed to hold ``tokens`` cache entries; 0 tokens need 0
    pages, negative counts raise."""
    tokens = int(tokens)
    if tokens < 0:
        raise MXNetError(f"blocks_for_tokens({tokens}): negative")
    return -(-tokens // int(block_tokens))


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
    """Free-list allocator over ``num_blocks`` fixed-size token pages.

    Page 0 is the reserved scratch page and never handed out.
    ``alloc`` is all-or-nothing: a request that cannot be fully met
    takes nothing, and the caller decides whether to preempt or wait.
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
        self._owner: Dict[int, object] = {}

    @property
    def capacity(self) -> int:
        """Allocatable pages (the scratch page excluded)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - self.free_blocks

    def utilization(self) -> float:
        return self.used_blocks / self.capacity

    def alloc(self, n: int, owner=None) -> Optional[List[int]]:
        """Take ``n`` pages, or None (taking nothing) if the free list
        holds fewer."""
        if n < 0:
            raise MXNetError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: List[int]) -> None:
        """Return pages to the free list; a page not held raises."""
        for p in pages:
            if p == SCRATCH_PAGE:
                raise MXNetError("attempt to free the scratch page")
            if p not in self._owner:
                raise MXNetError(
                    f"double free / foreign page {p} (owned pages: "
                    f"{sorted(self._owner)})")
            del self._owner[p]
            self._free.append(p)
