"""Prefix-shared KV cache: a radix index over block-aligned prompt
prefixes, composed with the ref-counted page allocator.

Counterpart of ``mxnet_tpu/prefix_cache.py`` (the port keeps its own
copy).  Two published designs compose:

* **PagedAttention** (Kwon et al. SOSP '23): K/V lives in fixed-size
  pages addressed through per-stream block tables, so sharing a prefix
  is a block-table splice: N streams point rows of their tables at the
  same page ids;
* **RadixAttention** (SGLang, Zheng et al. '23): a radix tree over
  token-block keys maps every cached block-aligned prefix to its page
  chain, so admission finds the longest cached prefix in O(prompt
  blocks) and prefill runs only on the uncached suffix.

Sharing rules:

* only **full** pages enter the index: a full page of a causal model's
  K/V depends only on the tokens at and before it, and is never written
  again;
* the partly filled tail page is private, except on a fully cached
  block-aligned prompt, whose first decode step re-writes the last
  prompt token's slot: a write to a page with other holders (or one the
  index still maps) is **copy-on-write**: the engine takes a private
  page, copies the bytes on the device and splices its block table;
* a page released by every holder while still indexed is **parked**:
  it keeps its bytes, revives on the next hit, and is reclaimed in LRU
  order (leaf first, logical-clock stamps) when the pool runs dry
  (``MXNET_SERVING_EVICT=lru``; ``off``: release frees at once and
  drops the index entry).

Host-side bookkeeping only: ``serving.DecodeEngine`` drives it at
admission (attach, suffix-only prefill), at each decode step (the COW
probe), at preemption and retirement (release) and inside allocation
(eviction under pressure).  The counters live on the object
(``stats()``); the JAX module's profiler spans are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import MXNetError
from .kv_cache import BlockAllocator

__all__ = ["PrefixIndex", "PrefixCache", "EVICT_POLICIES"]

EVICT_POLICIES = ("lru", "off")


class _Node:
    """One cached block: the radix-tree edge label is the block's
    token bytes; the payload is the page id holding its K/V."""

    __slots__ = ("key", "page", "parent", "children", "stamp")

    def __init__(self, key: bytes, page: int, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.stamp = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"_Node(page={self.page}, children={len(self.children)})"


class PrefixIndex:
    """Radix tree over block-aligned token prefixes -> page chains.

    Keys are the raw bytes of each ``block_tokens``-sized token block
    (exact match — no hash collisions to reason about); depth d holds
    the d-th block of a prefix.  LRU stamps come from a monotonic
    logical clock, so eviction order is a deterministic function of
    the request sequence, never of wall time."""

    def __init__(self, block_tokens: int):
        if block_tokens < 1:
            raise MXNetError(f"bad block_tokens {block_tokens}")
        self.block_tokens = int(block_tokens)
        self._root: Dict[bytes, _Node] = {}
        self._clock = 0
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    @staticmethod
    def _salted(salt: bytes) -> bytes:
        # length-prefixed so no (salt, block-bytes) pair can collide
        # with another salt's — or with the unsalted tree, whose root
        # keys are exactly block_tokens * 4 bytes
        return len(salt).to_bytes(4, "big") + salt if salt else b""

    def _keys(self, tokens: np.ndarray, nblocks: int,
              salt: bytes = b"") -> List[bytes]:
        t = np.ascontiguousarray(np.asarray(tokens, np.int32))
        B = self.block_tokens
        keys = [t[j * B:(j + 1) * B].tobytes() for j in range(nblocks)]
        if salt and keys:
            # namespace the tree at its ROOT block: K/V bytes depend on
            # the (tokens, adapter) pair, not tokens alone — a prefix
            # prefilled under LoRA adapter X must never satisfy a
            # stream of adapter Y (or a plain stream)
            keys[0] = self._salted(salt) + keys[0]
        return keys

    def roots_for(self, salt: bytes) -> List[_Node]:
        """Depth-0 nodes living under ``salt``'s namespace — the
        handles an adapter republish uses to drop every chain whose
        bytes were computed under the name's OLD weights."""
        p = self._salted(salt)
        want = len(p) + self.block_tokens * 4
        return [n for k, n in list(self._root.items())
                if len(k) == want and k.startswith(p)]

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    # ------------------------------------------------------------------
    def match(self, tokens, touch: bool = True,
              salt: bytes = b"") -> List[_Node]:
        """Longest cached block-aligned prefix of ``tokens``: the node
        chain, shallowest first (``len(chain) * block_tokens`` cached
        tokens).  ``touch`` refreshes the chain's LRU stamps."""
        nblocks = len(tokens) // self.block_tokens
        chain: List[_Node] = []
        children = self._root
        for key in self._keys(tokens, nblocks, salt):
            node = children.get(key)
            if node is None:
                break
            chain.append(node)
            children = node.children
        if touch:
            for node in chain:  # shallow->deep: deepest gets newest
                self._touch(node)
        return chain

    def insert(self, tokens, pages: List[int], nblocks: int,
               salt: bytes = b"") -> List[_Node]:
        """Map the first ``nblocks`` full blocks of ``tokens`` to
        ``pages[j]``.  Existing nodes keep THEIR page (the content is
        identical by construction; the caller's duplicate page simply
        stays private).  Returns the nodes newly created — whose pages
        the index now co-owns."""
        created: List[_Node] = []
        children = self._root
        parent: Optional[_Node] = None
        for j, key in enumerate(self._keys(tokens, nblocks, salt)):
            node = children.get(key)
            if node is None:
                node = _Node(key, int(pages[j]), parent)
                children[key] = node
                self._nodes += 1
                created.append(node)
            self._touch(node)
            parent = node
            children = node.children
        return created

    def remove(self, node: _Node) -> None:
        """Unlink a LEAF node (eviction).  Interior nodes cannot go
        first — their children's chains would dangle."""
        if node.children:
            raise MXNetError("PrefixIndex.remove of an interior node")
        siblings = node.parent.children if node.parent is not None \
            else self._root
        if siblings.get(node.key) is not node:  # pragma: no cover
            raise MXNetError("PrefixIndex.remove of an unlinked node")
        del siblings[node.key]
        self._nodes -= 1

    def leaves(self) -> List[_Node]:
        out = []
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out


class PrefixCache:
    """The sharing layer the engine talks to: allocator + radix index
    + eviction policy + the hit/COW/eviction counters.

    All page-state transitions used by the serving scheduler flow
    through here so the invariants hold in one place:

    * ``peek``/``attach`` — longest-prefix lookup at admission;
      attach bumps refcounts (reviving parked pages) so the matched
      chain cannot be evicted from under the stream;
    * ``register`` — after (suffix) prefill, the prompt's full pages
      enter the index and become shareable;
    * ``release`` — a retiring/preempted stream detaches; indexed
      pages park (bytes kept) instead of freeing;
    * ``alloc`` — pages for new work, evicting parked pages LRU when
      the free list runs dry;
    * ``needs_cow`` — the decode-step write probe: true when the
      target page has other holders or is still index-mapped.
    """

    def __init__(self, alloc: BlockAllocator, policy: str = "lru"):
        if policy not in EVICT_POLICIES:
            raise MXNetError(
                f"unknown eviction policy {policy!r} "
                f"(MXNET_SERVING_EVICT wants one of {EVICT_POLICIES})")
        self.allocator = alloc
        self.policy = policy
        self.index = PrefixIndex(alloc.block_tokens)
        self._page_node: Dict[int, _Node] = {}  # indexed pages
        self.hits = 0
        self.hit_tokens = 0
        self.full_hits = 0
        self.cow_copies = 0
        self.evictions = 0

    # -- admission ------------------------------------------------------
    def peek(self, tokens, salt: bytes = b"") -> Tuple[int, int]:
        """(cached_tokens, parked_matched) for the longest cached
        prefix — refcounts untouched, stamps untouched (a peek that
        doesn't admit must not distort LRU order).  ``parked_matched``
        pages revive on attach, so they are NOT spare capacity for the
        admission check.  ``salt`` namespaces the lookup (the stream's
        adapter identity — adapted K/V never crosses tenants)."""
        chain = self.index.match(tokens, touch=False, salt=salt)
        parked = sum(1 for n in chain if self.allocator.is_parked(n.page))
        return len(chain) * self.index.block_tokens, parked

    def attach(self, tokens, owner=None,
               salt: bytes = b"") -> Tuple[int, List[int]]:
        """Acquire the longest cached prefix for a new stream: bump
        each chain page's refcount (reviving parked ones) and return
        (cached_tokens, pages).  Counted as ONE prefix hit when
        anything matched."""
        chain = self.index.match(tokens, touch=True, salt=salt)
        pages = []
        for node in chain:
            if self.allocator.is_parked(node.page):
                self.allocator.revive(node.page, owner=owner)
            else:
                self.allocator.share(node.page)
            pages.append(node.page)
        cached = len(chain) * self.index.block_tokens
        if cached:
            self.hits += 1
            self.hit_tokens += cached
        return cached, pages

    # -- registration ---------------------------------------------------
    def register(self, tokens, pages: List[int],
                 salt: bytes = b"") -> None:
        """Index every FULL block of ``tokens`` (held by the calling
        stream as ``pages``).  Blocks already indexed keep the
        incumbent page; the caller's duplicate stays private."""
        nblocks = len(tokens) // self.index.block_tokens
        if nblocks > len(pages):  # pragma: no cover - caller bug
            raise MXNetError(
                f"register: {nblocks} full blocks but only "
                f"{len(pages)} pages")
        for node in self.index.insert(tokens, pages, nblocks, salt):
            self._page_node[node.page] = node

    # -- release / eviction ---------------------------------------------
    def release(self, pages: List[int]) -> None:
        """A stream detaches from its pages (retire, preemption,
        failure).  Indexed pages whose refcount hits zero park (bytes
        kept for future hits) under the 'lru' policy; with 'off' they
        free immediately and leave the index."""
        for p in pages:
            keep = self.policy == "lru" and p in self._page_node
            left = self.allocator.release(p, park=keep)
            if left == 0 and not keep and p in self._page_node:
                self._drop_chain(self._page_node[p])

    def _drop_chain(self, node: _Node) -> None:
        """Remove a node's whole subtree from the index (policy 'off'
        release: the page just freed must not stay reachable).
        Descendant pages still held by live streams merely lose their
        index entry (they free normally at their own release); parked
        descendants are reclaimed."""
        stack = [node]
        order: List[_Node] = []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):  # deepest-first: leaves before parents
            self.index.remove(n)
            self._page_node.pop(n.page, None)
            if self.allocator.is_parked(n.page):
                self.allocator.reclaim(n.page)

    def invalidate_salt(self, salt: bytes) -> int:
        """Drop every cached chain in ``salt``'s namespace (adapter
        publish/retire): after a retire-then-republish the name maps
        to NEW weights, so chains prefilled under the old ones must
        stop being matchable.  Pages still held by (retiring) live
        streams merely lose their index entry; parked ones are
        reclaimed.  Returns the number of root chains dropped."""
        roots = self.index.roots_for(salt) if salt else []
        for node in roots:
            self._drop_chain(node)
        return len(roots)

    def invalidate_all(self) -> int:
        """Drop every cached chain of every namespace (a weight swap:
        each page's K/V was computed under the old weights).  Pages live
        streams hold merely lose their index entry; parked ones are
        reclaimed.  Returns the number of root chains dropped."""
        roots = list(self.index._root.values())
        for node in roots:
            self._drop_chain(node)
        return len(roots)

    def detach(self, pages: List[int]) -> int:
        """Un-index pages about to be EXPORTED (live KV migration): a
        migrating stream's pages leave this replica's pool, so any
        radix entry mapping them — and the whole subtree hanging off
        it, whose chains would dangle — must stop being matchable
        first.  Pages other streams still hold merely lose their index
        entry (their holders keep reading them and they free at their
        own release); parked descendants of a dropped chain are
        reclaimed by :meth:`_drop_chain` as usual.  Returns the number
        of pages whose index entry was dropped.  (Page export itself
        belongs to the fleet, which the port does not carry yet.)"""
        dropped = 0
        for p in pages:
            node = self._page_node.get(p)
            if node is None:
                continue
            self._drop_chain(node)
            dropped += 1
        return dropped

    def _evictable(self) -> List[_Node]:
        """Leaf nodes whose page is parked, LRU-first."""
        cands = [n for n in self.index.leaves()
                 if self.allocator.is_parked(n.page)]
        cands.sort(key=lambda n: n.stamp)
        return cands

    def evict(self, need: int) -> int:
        """Reclaim up to ``need`` parked pages in LRU leaf order
        (evicting a leaf may expose its parent as the next
        candidate).  Returns the number reclaimed."""
        if self.policy != "lru":
            return 0
        done = 0
        while done < need:
            cands = self._evictable()
            if not cands:
                break
            for n in cands:
                if done >= need:
                    break
                self.index.remove(n)
                del self._page_node[n.page]
                self.allocator.reclaim(n.page)
                self.evictions += 1
                done += 1
        return done

    def alloc(self, n: int, owner=None) -> Optional[List[int]]:
        """Allocator facade: evict parked pages (LRU) when the free
        list alone cannot cover ``n``, then allocate all-or-nothing."""
        short = n - self.allocator.free_list_blocks
        if short > 0:
            self.evict(short)
        return self.allocator.alloc(n, owner=owner)

    # -- copy-on-write ---------------------------------------------------
    def needs_cow(self, page: int) -> bool:
        """Would a K/V write to ``page`` be visible beyond its writer?
        True when another stream holds it, or the index still maps its
        bytes (a future hit would read the overwrite)."""
        return self.allocator.refcount(page) > 1 or page in self._page_node

    def note_cow(self) -> None:
        self.cow_copies += 1

    def reset_counters(self) -> None:
        """Zero the hit/COW/eviction counters (bench sweep points);
        the index and page states are untouched."""
        self.hits = self.hit_tokens = self.full_hits = 0
        self.cow_copies = self.evictions = 0

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        return {
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_full_hits": self.full_hits,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "indexed_blocks": len(self.index),
            "cached_blocks": self.allocator.parked_blocks,
            "shared_blocks": self.allocator.shared_blocks,
        }
