"""Paged KV arena + prefix cache — the memory layer under continuous
decode; the port's copy of ``distributeddeeplearningspark_tpu/serve/kv.py``
(pure host bookkeeping, numpy only, the same code).

The fixed-slot pool gives every sequence a private ``[max_cache_len]`` KV
allocation for its whole life; paging replaces it with a pool of
fixed-size pages and a block table per slot:

- the device cache becomes a **page pool** (``[L, num_pages, page_size,
  nkv, hd]`` for K and for V) instead of a per-slot slab; a **block table**
  maps each slot to the ordered list of page ids backing its positions;
- :class:`PagedKVArena` is the host-side allocator: first-fit (the lowest
  free page id, so holes from out-of-order eos reclaim refill at once),
  refcounted so that a page can back several readers at once;
- :class:`PrefixCache` is the sharing map: page-aligned prompt prefixes are
  keyed by their token content (sha1) and mapped to the already-prefilled
  pages, so a request whose prompt starts with a known system prompt
  references those pages and prefills only its remainder. Sharing is safe
  by construction: decode writes land only at positions ``>= prompt_len``,
  and a shared page covers positions ``< n*page_size <= prompt_len`` (the
  partial last page of a prefix is never shared).

The device-side gather/scatter that makes a slot's dense cache view from
its pages lives in :mod:`.generate`, keyed by the tables this module hands
out. Page 0 is the **trash page**: unallocated block-table entries point at
it, so the gathers keep one shape (garbage beyond a slot's length is masked
by attention and overwritten before it is ever attended).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
from typing import Any

import numpy as np

#: Block-table entries that back no allocated page point here. Never
#: allocated; holds garbage by design.
TRASH_PAGE = 0


class PagedKVArena:
    """First-fit page allocator with refcounts over ``num_pages`` pages.

    ``alloc`` hands out the lowest-numbered free pages (first-fit: a hole
    opened by an out-of-order ``release`` is refilled by the very next
    allocation — pool occupancy stays dense at the low ids, and the free
    structure is a heap, O(log P) per page). Pages are refcounted:
    :class:`PrefixCache` retains pages a finished slot released, so "free"
    means "no slot AND no cache entry references it".

    Sizing: a page holds ``page_size`` token positions of K+V for every
    layer; ``num_pages`` must cover at least one full-length sequence
    (``max_cache_len / page_size`` pages) plus the trash page.
    """

    def __init__(self, num_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: list[int] = list(range(1, num_pages))
        heapq.heapify(self._free)
        self._ref: dict[int, int] = {}
        self.allocs = 0          # pages handed out, lifetime
        self.alloc_failures = 0  # alloc() calls that returned None

    @property
    def pages_total(self) -> int:
        """Allocatable pages (the trash page is not one)."""
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.pages_total - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.pages_used / max(1, self.pages_total)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` pages at refcount 1 (lowest free ids), or None if the pool
        can't supply them — the caller decides whether to evict cache
        entries and retry, or defer admission."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [heapq.heappop(self._free) for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.allocs += n
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add one reference to each page (sharing — pages must be live)."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"retain of unallocated page {p}")
            self._ref[p] += 1

    def release(self, pages: list[int]) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free pool (out-of-order — this is the reclaim path eos takes).
        Returns how many pages actually freed."""
        freed = 0
        for p in pages:
            r = self._ref.get(p)
            if r is None:
                raise ValueError(f"release of unallocated page {p}")
            if r > 1:
                self._ref[p] = r - 1
            else:
                del self._ref[p]
                heapq.heappush(self._free, p)
                freed += 1
        return freed

    def stats(self) -> dict[str, Any]:
        return {
            "kv_page_size": self.page_size,
            "kv_pages_total": self.pages_total,
            "kv_pages_used": self.pages_used,
            "kv_pages_free": self.pages_free,
            "kv_page_occupancy": round(self.occupancy, 4),
            "kv_page_allocs": self.allocs,
            "kv_alloc_failures": self.alloc_failures,
        }


@dataclasses.dataclass
class _PrefixEntry:
    pages: list[int]      # the n pages backing tokens [0, n*page_size)
    tokens: int           # n * page_size
    version: Any          # params version the K/V was computed under
    last_used: int        # LRU tick


class PrefixCache:
    """Hash-keyed page-sharing map: token prefix → already-prefilled pages.

    Keys are sha1 over the raw int32 token bytes of page-ALIGNED prompt
    prefixes. Registration stores every aligned depth of a prompt (depth n
    retains ``pages[:n]``), because two prompts sharing a system prompt
    diverge at an arbitrary depth — a hit must be possible at exactly the
    shared depth, not only at the registering prompt's full depth.
    ``lookup`` walks longest-first and caps the match at ``len(prompt)-1``
    tokens: at least one real token must remain to prefill, since sampling
    the first output token needs that position's logits.

    Entries are invalidated by params version (a hot-reload makes every
    cached K/V stale — :meth:`flush` drops them) and evicted LRU when the
    arena runs dry (:meth:`evict_until` — the cache is a scavenger of free
    memory, never a reason to refuse admission).
    """

    def __init__(self, arena: PagedKVArena, *, max_entries: int = 512):
        self.arena = arena
        self.max_entries = int(max_entries)
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._tick = itertools.count()
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(tokens, np.int32).tobytes()).digest()

    def lookup(self, prompt: np.ndarray, version: Any
               ) -> tuple[int, list[int]]:
        """Longest registered page-aligned prefix of ``prompt`` under
        ``version`` → ``(n_pages, pages)``; ``(0, [])`` on miss.

        A hit retains the pages for the caller (caller releases them with
        the slot's other pages on completion). Hit/miss accounting is NOT
        done here — the caller may still defer the admission (arena full)
        and retry, so it reports the outcome once, via :meth:`record`."""
        page = self.arena.page_size
        for n in range((len(prompt) - 1) // page, 0, -1):
            e = self._entries.get(self._key(prompt[:n * page]))
            if e is None or e.version != version:
                continue
            e.last_used = next(self._tick)
            self.arena.retain(e.pages)
            return n, list(e.pages)
        return 0, []

    def record(self, tokens_reused: int) -> None:
        """Count one completed admission: ``tokens_reused`` prompt tokens
        were served from cached pages (0 = a miss)."""
        if tokens_reused:
            self.hits += 1
            self.tokens_saved += int(tokens_reused)
        else:
            self.misses += 1

    def register(self, prompt: np.ndarray, pages: list[int],
                 version: Any) -> int:
        """Register every page-aligned depth of ``prompt`` whose pages are
        fully prefilled (``pages`` backs positions [0, len(pages)*page)).
        Returns how many new entries were created. Existing keys are kept
        (their K/V is identical by construction)."""
        page = self.arena.page_size
        created = 0
        for n in range(1, min(len(prompt) // page, len(pages)) + 1):
            k = self._key(prompt[:n * page])
            if k in self._entries:
                continue
            self.arena.retain(pages[:n])
            self._entries[k] = _PrefixEntry(
                pages=list(pages[:n]), tokens=n * page, version=version,
                last_used=next(self._tick))
            created += 1
        while len(self._entries) > self.max_entries:
            self._evict_one()
        return created

    def _evict_one(self) -> bool:
        if not self._entries:
            return False
        k = min(self._entries, key=lambda k: self._entries[k].last_used)
        self.arena.release(self._entries.pop(k).pages)
        return True

    def evict_until(self, pages_free: int) -> int:
        """LRU-evict entries until the arena has ``pages_free`` free pages
        (or the cache is empty — pages held by live slots can't be freed
        here). Returns entries evicted."""
        evicted = 0
        while self.arena.pages_free < pages_free and self._evict_one():
            evicted += 1
        return evicted

    def flush(self) -> int:
        """Drop every entry (params swapped: all cached K/V is stale)."""
        n = len(self._entries)
        for e in self._entries.values():
            self.arena.release(e.pages)
        self._entries.clear()
        return n

    def stats(self) -> dict[str, Any]:
        total = self.hits + self.misses
        return {
            "prefix_entries": len(self._entries),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": round(self.hits / total, 4) if total else None,
            "prefix_tokens_saved": self.tokens_saved,
        }
