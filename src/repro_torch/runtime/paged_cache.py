"""Paged KV-cache subsystem (port of ``repro.runtime.paged_cache``).

The serving cache is a **shared page pool**: physical pages of
``page_size`` tokens (= ``EnergonConfig.decode_key_block``, so a page is
exactly one MP-MRF key block) hold K/V rows plus the resident filter
operands (int16 ``k_codes`` + one f32 absmax scale per page). A
host-side :class:`PageAllocator` hands pages out on demand, keeps
per-slot **block tables** (logical key block → physical page),
refcounts pages shared between slots, content-addresses full pages in a
prefix trie, and enforces copy-on-write for shared or registered pages.

The allocator is plain Python/numpy, copied from the reference so the
two engines place pages identically. The device helpers below are the
torch counterparts of the reference's logical→physical indirection.

Pool leaf layout (per layer): ``k``/``v``/``k_codes`` are
``[KV, num_pages · page_size, head_dim]`` — page p owns rows
``[p·ps, (p+1)·ps)`` — and ``k_scale`` is ``[KV, num_pages]``.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class AllocatorInvariantError(RuntimeError):
    """A `PageAllocator.check_invariants` self-check failed — allocator
    bookkeeping has drifted from the block tables (a refcount leak, a
    second writer, or a page lost between the heap, the cached set and
    live use)."""


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a page pool.

    Attributes:
      num_pages: physical pages in the pool.
      page_size: tokens per page (== the decode key block width, so the
        filter's block granularity and the paging granularity coincide).
      max_blocks: logical blocks per slot — the compiled decode shape is
        ``max_blocks · page_size`` logical rows regardless of how many
        pages a slot actually owns.
      batch_slots: number of engine slots sharing the pool.
    """

    num_pages: int
    page_size: int
    max_blocks: int
    batch_slots: int

    def __post_init__(self):
        if self.num_pages < self.max_blocks:
            # a lone request may need up to max_blocks pages; a smaller
            # pool would preempt-loop forever on a long request.
            raise ValueError(
                f"num_pages={self.num_pages} < max_blocks="
                f"{self.max_blocks}: one full-length request could "
                "never be resident"
            )
        if self.page_size <= 0 or self.max_blocks <= 0:
            raise ValueError("page_size and max_blocks must be positive")

    @property
    def logical_rows(self) -> int:
        return self.max_blocks * self.page_size

    @property
    def pool_rows(self) -> int:
        return self.num_pages * self.page_size

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache rows."""
        return max(-(-n_tokens // self.page_size), 0)


class _TrieNode:
    """One prefix-trie node: a ``page_size``-token chunk of a prefix.

    ``children`` maps the *next* chunk (an exact token tuple — content
    addressing by equality, so there is no hash-collision failure mode)
    to its node. ``page`` is the physical page currently holding this
    chunk's K/V + filter state, or None when that page was evicted —
    the node survives as structure and can be re-filled by the next
    registration of the same content."""

    __slots__ = ("children", "page", "parent", "key")

    def __init__(self, parent=None, key=None):
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page: Optional[int] = None
        self.parent: Optional["_TrieNode"] = parent
        self.key: Optional[Tuple[int, ...]] = key


class PageAllocator:
    """Host-side page allocator: free list + per-slot block tables +
    refcounted prefix sharing.

    Allocation is deterministic — the lowest-numbered free page is
    always handed out first (a heap, not an arbitrary set), and cached
    zero-refcount pages are evicted oldest-first — so a given request
    trace produces the same physical placement, the same preemptions,
    and the same watermark on every run.

    Block tables are **compacted**: a slot's table holds its pages in
    logical-block order in entries ``[0, n_blocks)``, and every entry
    beyond that is 0 (a safe in-range page id — device code masks those
    logical blocks by cache length, so what page they alias is
    irrelevant, but the gather must stay in bounds).

    Page lifecycle with sharing:

    * ``ref[p] == 0`` and on the free heap — truly free; zeroed on
      reuse before first write.
    * ``ref[p] >= 1`` — live: mapped by ``ref[p]`` table entries across
      slots. Writable only when ``ref == 1`` *and* unregistered.
    * ``ref[p] == 0`` but **cached** — its content is registered in the
      prefix trie and survives its last reference (a shared page
      survives its writer); evicted (and deregistered) oldest-first
      when the heap runs dry.
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: List[int] = list(range(layout.num_pages))
        heapq.heapify(self._free)
        self.block_tables = np.zeros(
            (layout.batch_slots, layout.max_blocks), np.int32
        )
        self.n_blocks = np.zeros((layout.batch_slots,), np.int32)
        self.ref = np.zeros((layout.num_pages,), np.int32)
        self.pages_in_use = 0
        self.peak_pages_in_use = 0
        # prefix sharing state
        self._root = _TrieNode()
        self._page_node: Dict[int, _TrieNode] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now: the free heap plus evictable
        cached (zero-refcount, registered) pages."""
        return len(self._free) + len(self._cached)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    # --- prefix trie ---------------------------------------------------

    def _chunks(self, tokens: Sequence[int]):
        ps = self.layout.page_size
        for j in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest registered prefix of ``tokens``, as physical pages.

        Walks the trie one full ``page_size`` chunk at a time and stops
        at the first chunk with no resident page. Every returned page
        is either live or cached — both hold exactly the chunk's
        content. The caller *must* attach (``share``) before any
        further allocation, or an eviction could reuse a cached match.
        """
        pages: List[int] = []
        node = self._root
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None or child.page is None:
                break
            pages.append(child.page)
            node = child
            if len(pages) >= self.layout.max_blocks:
                break
        return pages

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Content-address ``slot``'s full pages under ``tokens``.

        Chunk j's trie node gets ``slot``'s physical page for logical
        block j — unless the node already holds a (different) page with
        the same content, in which case the existing registration wins
        and ``slot``'s copy stays private. Registered pages are
        immutable from then on: the write guard (:meth:`writable`)
        forces copy-on-write. Returns the number of pages newly
        registered."""
        node = self._root
        added = 0
        for j, chunk in enumerate(self._chunks(tokens)):
            if j >= int(self.n_blocks[slot]):
                break
            child = node.children.get(chunk)
            if child is None:
                child = _TrieNode(parent=node, key=chunk)
                node.children[chunk] = child
            if child.page is None:
                page = int(self.block_tables[slot, j])
                if page not in self._page_node:
                    child.page = page
                    self._page_node[page] = child
                    added += 1
            node = child
        return added

    def _deregister(self, page: int) -> None:
        node = self._page_node.pop(page, None)
        if node is None:
            return
        node.page = None
        # prune now-empty structure so the trie stays bounded
        while (
            node.parent is not None
            and node.page is None
            and not node.children
        ):
            del node.parent.children[node.key]
            node = node.parent

    def is_registered(self, page: int) -> bool:
        return int(page) in self._page_node

    # --- page handout --------------------------------------------------

    def _take_page(self) -> Optional[int]:
        """Lowest free page, else evict the oldest cached page (its
        registration is dropped first). None when neither exists."""
        if self._free:
            return heapq.heappop(self._free)
        if self._cached:
            page, _ = self._cached.popitem(last=False)
            self._deregister(page)
            return page
        return None

    def _retire_page(self, page: int) -> None:
        """Route a page whose refcount just hit zero: registered pages
        survive in the cached set, anonymous pages rejoin the heap."""
        if page in self._page_node:
            self._cached[page] = None
        else:
            heapq.heappush(self._free, page)

    def _append_block(self, slot: int, page: int) -> None:
        base = int(self.n_blocks[slot])
        if base + 1 > self.layout.max_blocks:
            raise ValueError(
                f"slot {slot} would exceed max_blocks="
                f"{self.layout.max_blocks}"
            )
        self.block_tables[slot, base] = page
        self.n_blocks[slot] = base + 1

    def alloc(self, slot: int, n_pages: int) -> Optional[List[int]]:
        """Append ``n_pages`` fresh pages to ``slot``'s block table.

        Returns the allocated page ids, or None (state unchanged) when
        neither the free list nor the evictable cache can cover the
        request. Every returned page had refcount 0; the caller must
        zero it on device before use: a reused page still holds its
        previous occupant's rows, and a block absmax computed over
        stale rows would poison the new occupant's filter scale (the
        same failure reset_decode_slots guards against in the unpaged
        cache).
        """
        if n_pages < 0:
            raise ValueError(f"n_pages={n_pages}")
        base = int(self.n_blocks[slot])
        if base + n_pages > self.layout.max_blocks:
            raise ValueError(
                f"slot {slot} would exceed max_blocks="
                f"{self.layout.max_blocks}"
            )
        if n_pages > self.free_pages:
            return None
        pages = [self._take_page() for _ in range(n_pages)]
        self.block_tables[slot, base:base + n_pages] = pages
        self.n_blocks[slot] = base + n_pages
        for p in pages:
            self.ref[p] = 1
        self.pages_in_use += n_pages
        self.peak_pages_in_use = max(
            self.peak_pages_in_use, self.pages_in_use
        )
        return pages

    def ensure_capacity(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Grow ``slot``'s table to cover ``n_tokens`` rows.

        Returns the newly allocated pages ([] when already covered), or
        None when the pool is exhausted (state unchanged — the caller
        preempts and retries).
        """
        need = self.layout.blocks_for(n_tokens) - int(self.n_blocks[slot])
        if need <= 0:
            return []
        return self.alloc(slot, need)

    def share(self, slot: int, page: int) -> None:
        """Attach an existing page (live or cached) as ``slot``'s next
        logical block: pure block-table aliasing, no copy, no zeroing —
        the attached content is live data."""
        page = int(page)
        self._append_block(slot, page)
        if self.ref[page] == 0:
            self._cached.pop(page, None)
            self.pages_in_use += 1
            self.peak_pages_in_use = max(
                self.peak_pages_in_use, self.pages_in_use
            )
        self.ref[page] += 1

    def writable(self, slot: int, block: int) -> bool:
        """True when ``slot`` may mutate logical ``block`` in place:
        exactly one table reference and no content registration."""
        page = int(self.block_tables[slot, block])
        return int(self.ref[page]) == 1 and page not in self._page_node

    def cow(self, slot: int, block: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write ``slot``'s logical ``block``: swap in a fresh
        exclusive page for the shared/registered one it maps.

        Returns ``(src, dst)`` — the caller must copy src's rows, codes
        and scale to dst on device (``clone_page_rows``) *before* the
        next cache write; dst is **not** zeroed (the clone overwrites
        the whole page). Returns None (state unchanged) when the pool
        cannot supply a page; the caller preempts and retries.
        """
        src = int(self.block_tables[slot, block])
        dst = self._take_page()
        if dst is None:
            return None
        self.block_tables[slot, block] = dst
        self.ref[dst] = 1
        self.pages_in_use += 1
        self.ref[src] -= 1
        if self.ref[src] == 0:
            self._retire_page(src)
            self.pages_in_use -= 1
        self.peak_pages_in_use = max(
            self.peak_pages_in_use, self.pages_in_use
        )
        return src, dst

    def free_slot(self, slot: int) -> List[int]:
        """Drop every table reference ``slot`` holds and compact its
        table. Refcounts decrement; a page only leaves live use when
        its last reference goes — shared pages survive their writer,
        and registered pages retire to the cached set instead of the
        heap."""
        n = int(self.n_blocks[slot])
        pages = self.block_tables[slot, :n].tolist()
        for p in pages:
            p = int(p)
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._retire_page(p)
                self.pages_in_use -= 1
        self.block_tables[slot, :] = 0
        self.n_blocks[slot] = 0
        return pages

    def check_invariants(self) -> None:
        """Audit allocator bookkeeping against the block tables; raises
        :class:`AllocatorInvariantError` on any violation.

        These are the PR 4 allocator-fuzzer checks promoted into a
        runtime self-check (the serving engine runs it per tick when
        constructed with ``audit=True``):

        * refcounts equal live table references, exactly;
        * table entries beyond ``n_blocks`` are compacted to 0;
        * ``pages_in_use`` counts pages with ``ref >= 1``, and live +
          heap + cached partitions the pool (no page lost, none twice);
        * every heap/cached page has refcount 0;
        * single-writer: a page mapped by >1 table reference, or
          content-registered, is writable by nobody.
        """
        lay = self.layout

        def fail(msg: str) -> None:
            raise AllocatorInvariantError(msg)

        counts = np.zeros(lay.num_pages, np.int64)
        for s in range(lay.batch_slots):
            n = int(self.n_blocks[s])
            np.add.at(counts, self.block_tables[s, :n], 1)
            if not (self.block_tables[s, n:] == 0).all():
                fail(f"slot {s}: table entries beyond n_blocks={n} "
                     "are not compacted to 0")
        if not np.array_equal(counts, self.ref):
            diff = np.nonzero(counts != self.ref)[0].tolist()
            fail(f"refcount drift on pages {diff}: table refs "
                 f"{counts[diff].tolist()} vs ref "
                 f"{self.ref[diff].tolist()}")
        live = int((self.ref >= 1).sum())
        if self.pages_in_use != live:
            fail(f"pages_in_use={self.pages_in_use} but {live} pages "
                 "have ref >= 1")
        if live + len(self._free) + len(self._cached) != lay.num_pages:
            fail(f"pool partition broken: {live} live + "
                 f"{len(self._free)} free + {len(self._cached)} cached "
                 f"!= {lay.num_pages}")
        if set(self._free) & set(self._cached):
            fail(f"pages both free and cached: "
                 f"{sorted(set(self._free) & set(self._cached))}")
        for p in list(self._free) + list(self._cached):
            if int(self.ref[p]) != 0:
                fail(f"page {p} on heap/cached with ref={int(self.ref[p])}")
        for s in range(lay.batch_slots):
            for j in range(int(self.n_blocks[s])):
                p = int(self.block_tables[s, j])
                if (counts[p] > 1 or self.is_registered(p)) \
                        and self.writable(s, j):
                    fail(f"second-writer hazard: slot {s} block {j} "
                         f"writable but page {p} is shared/registered")

    def table_device(self, device) -> torch.Tensor:
        """The block tables as a device tensor ``[batch_slots, max_blocks]``."""
        return torch.as_tensor(self.block_tables, device=device)

    def page_reset_mask(self, pages: List[int], device) -> torch.Tensor:
        """Bool ``[num_pages]`` mask selecting ``pages``."""
        mask = np.zeros((self.layout.num_pages,), bool)
        mask[np.asarray(pages, np.int64)] = True
        return torch.as_tensor(mask, device=device)


# ---------------------------------------------------------------------------
# Device-side logical→physical indirection helpers
# ---------------------------------------------------------------------------

#: row id that no pool holds: writes aimed at it are dropped
DROP_ROW = 2 ** 30


def logical_row_ids(block_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """Physical pool row of every logical row: ``[B, mb·ps]`` int64.
    Unmapped logical blocks alias page 0 — callers mask those rows."""
    mb = block_table.shape[-1]
    r = torch.arange(mb * page_size, device=block_table.device)
    return block_table.long()[..., r // page_size] * page_size + (r % page_size)


def gather_logical_rows(
    pool: torch.Tensor, block_table: torch.Tensor, page_size: int
) -> torch.Tensor:
    """Per-slot logical view of a row-major pool leaf:
    ``[KV, pool_rows, ...]`` → ``[B, KV, mb·ps, ...]`` (a transient
    copy; the pool stays the only resident state). Gathered straight
    into a contiguous ``[B, KV, …]`` tensor — the layout of the
    contiguous cache — so that the dense attention over it multiplies
    operands laid out as the unpaged path's and rounds as they do (a
    permuted view sends cuBLAS down another summation order)."""
    rows = logical_row_ids(block_table, page_size)        # [B, n_log]
    heads = torch.arange(pool.shape[0], device=pool.device)
    return pool[heads[None, :, None], rows[:, None, :]]


def gather_logical_scales(
    scale_pool: torch.Tensor, block_table: torch.Tensor
) -> torch.Tensor:
    """``[KV, num_pages]`` → ``[B, KV, mb]``."""
    return scale_pool[:, block_table.long()].movedim(1, 0)


def paged_row_targets(
    positions: torch.Tensor,
    block_table: torch.Tensor,
    page_size: int,
    write_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pool row each (slot, token) write lands in — ``[B, C]`` int64.

    Sentinel positions (``>= logical_rows``) and masked-off slots map to
    :data:`DROP_ROW`; the scatter must then drop them explicitly (an
    idle slot's table may alias pages a live slot owns).
    """
    mb = block_table.shape[-1]
    ps = page_size
    positions = positions.long()
    blk = torch.clamp(positions // ps, 0, mb - 1)
    page = torch.gather(block_table.long(), 1, blk)
    rowid = page * ps + positions % ps
    ok = positions < mb * ps
    if write_mask is not None:
        ok = ok & write_mask[:, None]
    return torch.where(ok, rowid, DROP_ROW)


def clone_page_rows(
    cache: Dict[str, torch.Tensor],
    page_size: int,
    src_pages: Sequence[int],
    dst_pages: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Copy-on-write on device: duplicate whole physical pages (K/V
    rows, codes, per-page scale) across every layer of a paged cache
    (leaves ``[L, KV, pool_rows, hd]`` / scales ``[L, KV, num_pages]``),
    **in place**. Destinations need no prior zeroing."""
    if not len(src_pages):
        return cache
    leaf = cache["k"]
    dev = leaf.device
    src = torch.as_tensor(np.asarray(src_pages, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst_pages, np.int64), device=dev)
    for key in ("k", "v", "k_codes"):
        if key in cache:
            t = cache[key]
            pages = t.view(*t.shape[:-2], -1, page_size, t.shape[-1])
            pages[..., dst, :, :] = pages[..., src, :, :]
    if "k_scale" in cache:
        cache["k_scale"][..., dst] = cache["k_scale"][..., src]
    return cache


def attention_cache_bytes(cache) -> int:
    """Total bytes of the K/V + filter leaves of a serving cache."""
    if not isinstance(cache, dict):
        return 0
    total = 0
    for key, leaf in cache.items():
        if isinstance(leaf, dict):
            total += attention_cache_bytes(leaf)
        elif key in ("k", "v", "k_codes", "k_scale"):
            total += leaf.numel() * leaf.element_size()
    return total
