"""Paged KV cache: host-side page allocator, prefix reuse and
copy-on-write (port of kubeflow_tpu/runtime/kvcache.py).

The dense decode cache reserves P + N positions per slot for the slot's
whole life. The paged cache is a fixed pool of `num_pages` pages of
`page_size` positions shared by all slots: a request holds only the
pages its prompt and its own token budget need, complete prompt pages
whose content matches an earlier request's are shared read-only
(prefix reuse), and admission waits on free pages, not free slots.

`PageAllocator` is host bookkeeping over numpy page tables (freelist,
refcounts, chained prompt-page hashes, copy-on-write barriers), a copy
of the reference's; device work comes back as data (page ids to copy).
models/transformer.py owns the device side (the [num_pages, page_size,
Hkv, D] pools, written and gathered through a [B, MP] page table);
serving/continuous.py drives both. `init_paged_cache` and `copy_pages`
are the torch device helpers.

Page 0 is the trash page: no slot owns it, a freed slot's table row is
zeroed so its lockstep writes land there, and a gather through an
unallocated entry reads it only at masked positions. Prefix hashes
chain (h_j = H(h_{j-1} || tokens_j), the pad length salting the root),
since a page's k/v at layer > 0 depend on every earlier position; only
complete prompt pages are registered. Any write into a shared page
first clones it (`write_barrier` returns the (src, dst) copies to apply
before the program that writes).
"""

from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

TRASH_PAGE = 0


def pages_for(length: int, page_size: int) -> int:
    """Number of pages covering `length` positions."""
    return -(-length // page_size)


@dataclass
class AdmitPlan:
    """What one admission did: where prefill must start computing and
    which device-side page copies must run before it."""

    slot: int
    total_len: int
    prompt_len: int
    cached_positions: int          # positions covered by shared pages
    compute_start: int             # first prompt position to compute
    copies: list = field(default_factory=list)   # [(src, dst)] clones
    shared_pages: int = 0          # pages claimed from the prefix index


class PageAllocator:
    """Freelist + refcount + prefix-index bookkeeping for the pool.

    Single-threaded by design: the one decoder scheduler thread drives
    every transition (admission, per-tick appends/barriers, frees), so
    there is no lock to take.

    Refcount invariant: ``ref[p]`` == number of slot-table references
    to p + (1 if p is held by the prefix index). Pages with ref 0 are
    exactly the freelist. ``check()`` asserts this after any sequence
    of operations (the property test calls it per step).
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int, prefix_cache: bool = True):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is trash)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages_per_slot = max_pages_per_slot
        self.prefix_enabled = prefix_cache
        # passed to every decode call; int32 row per slot
        self.table = np.zeros((slots, max_pages_per_slot), np.int32)
        self._free: list[int] = list(range(1, num_pages))  # heap, asc ids
        heapq.heapify(self._free)
        self._ref = np.zeros(num_pages, np.int64)
        # per-slot: logical page index -> True if claimed shared
        self._slot_len: list[int] = [0] * slots     # allocated logical pages
        self._slot_total: list[int] = [0] * slots   # reserved total pages
        self._reserved = 0                          # unallocated-yet pages
        # prefix index: chain hash -> page id (LRU via move_to_end)
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self._page_key: dict[int, bytes] = {}
        # counters (host truth; the decoder mirrors them into metrics)
        self.prefix_lookups = 0
        self.prefix_hit_pages = 0
        self.prefix_hit_tokens = 0
        self.cow_clones = 0
        self.admits = 0
        self.evictions = 0

    # -- introspection ----------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def available(self) -> int:
        """Pages an admission may still claim: free + evictable prefix
        pages, minus what in-flight slots have reserved for decode."""
        evictable = sum(1 for p in self._prefix.values()
                        if self._ref[p] == 1)
        return len(self._free) + evictable - self._reserved

    # -- hashing ----------------------------------------------------------

    def _chain_hashes(self, row, pad: int) -> list[bytes]:
        """Chained hashes of the COMPLETE pages of `row` (one hash per
        full page; the pad length salts the root because left-pad
        masking changes every position's attention output)."""
        ps = self.page_size
        toks = np.asarray(row, np.int32)
        h = hashlib.blake2b(f"pad={pad}".encode(), digest_size=16).digest()
        out = []
        for j in range(len(toks) // ps):
            h = hashlib.blake2b(
                h + toks[j * ps:(j + 1) * ps].tobytes(),
                digest_size=16).digest()
            out.append(h)
        return out

    # -- allocation core --------------------------------------------------

    def _evict_one(self) -> bool:
        """Drop the least-recently-hit prefix page nobody references."""
        for key, page in self._prefix.items():
            if self._ref[page] == 1:
                del self._prefix[key]
                del self._page_key[page]
                self._ref[page] = 0
                heapq.heappush(self._free, page)
                self.evictions += 1
                return True
        return False

    def _alloc_page(self) -> int:
        if not self._free and not self._evict_one():
            raise RuntimeError("page pool exhausted (caller must gate "
                               "admission on available())")
        page = heapq.heappop(self._free)
        self._ref[page] = 1
        return page

    # -- admission --------------------------------------------------------

    def _plan_hits(self, row, pad: int, total_len: int) -> tuple:
        prompt_len = len(row)
        hashes = self._chain_hashes(row, pad) if self.prefix_enabled else []
        hits = []
        for h in hashes:
            page = self._prefix.get(h)
            if page is None:
                break
            hits.append(page)
        need = pages_for(total_len, self.page_size) - len(hits)
        if len(hits) * self.page_size >= prompt_len:
            # fully-cached prompt: the final position is still
            # recomputed for the first-token logits, and that write
            # copy-on-writes the last shared page — one extra page
            need += 1
        return need, hits

    def plan(self, row, pad: int, total_len: int) -> tuple[int, int]:
        """(pages_to_claim, cached_positions) for an admission. Gate
        with can_admit(), not `need <= available()`: available() counts
        every unreferenced prefix page as evictable, including the very
        pages THIS admission would hit — claiming them pins them, so
        the naive comparison over-admits and exhausts the pool
        mid-decode."""
        need, hits = self._plan_hits(row, pad, total_len)
        return need, len(hits) * self.page_size

    def can_admit(self, row, pad: int, total_len: int) -> bool:
        """True when the admission can claim every page it needs NOW
        and lazily through decode: free pages plus prefix pages that
        are genuinely evictable (unreferenced AND not this admission's
        own hits), minus what live slots have reserved."""
        need, hits = self._plan_hits(row, pad, total_len)
        hitset = set(hits)
        evictable = sum(1 for p in self._prefix.values()
                        if self._ref[p] == 1 and p not in hitset)
        return need <= len(self._free) + evictable - self._reserved

    def admit(self, slot: int, row, pad: int, total_len: int) -> AdmitPlan:
        """Claim pages for a request: shared prompt pages from the
        prefix index (refcounted, read-only), fresh pages for the rest
        of the prompt; decode pages are RESERVED but appended lazily
        (``append``). Returns the plan — including any copy-on-write
        clones the caller must apply on-device before prefill runs —
        and registers the slot's newly computed complete prompt pages
        for future reuse."""
        prompt_len = len(row)
        if prompt_len < 1 or total_len < prompt_len:
            raise ValueError(f"bad admit geometry ({prompt_len=}, "
                             f"{total_len=})")
        n_total = pages_for(total_len, self.page_size)
        if n_total > self.max_pages_per_slot:
            raise ValueError(
                f"total_len {total_len} needs {n_total} pages > "
                f"max_pages_per_slot {self.max_pages_per_slot}")
        if self._slot_total[slot]:
            raise RuntimeError(f"slot {slot} already admitted")
        ps = self.page_size
        hashes = self._chain_hashes(row, pad) if self.prefix_enabled else []
        self.prefix_lookups += 1
        hit_pages: list[int] = []
        for h in hashes:
            page = self._prefix.get(h)
            if page is None:
                break
            hit_pages.append(page)
            self._prefix.move_to_end(h)   # LRU touch
        for j, page in enumerate(hit_pages):
            self.table[slot, j] = page
            self._ref[page] += 1
        k = len(hit_pages)
        cached = k * ps
        self.prefix_hit_pages += k
        self.prefix_hit_tokens += cached
        # always recompute >= 1 prompt position: the first decode token
        # needs the last position's logits
        compute_start = min(cached, prompt_len - 1)
        # private pages for the computed prompt tail
        n_prompt = pages_for(prompt_len, ps)
        for j in range(k, n_prompt):
            self.table[slot, j] = self._alloc_page()
        self._slot_len[slot] = n_prompt
        self._slot_total[slot] = n_total
        self._reserved += n_total - n_prompt
        self.admits += 1
        plan = AdmitPlan(slot=slot, total_len=total_len,
                         prompt_len=prompt_len, cached_positions=cached,
                         compute_start=compute_start, shared_pages=k)
        # prefill WRITES [compute_start, prompt_len): COW anything
        # shared in that range (reachable when the whole prompt was
        # cached and compute_start falls inside the last shared page)
        plan.copies = self.write_barrier(slot, compute_start, prompt_len)
        # register newly computed COMPLETE prompt pages for reuse
        if self.prefix_enabled:
            for j in range(k, prompt_len // ps):
                page = int(self.table[slot, j])
                key = hashes[j]
                if key in self._prefix or page in self._page_key:
                    continue  # duplicate content (e.g. a COW clone)
                self._prefix[key] = page
                self._page_key[page] = key
                self._ref[page] += 1
        return plan

    # -- decode-time operations -------------------------------------------

    def append(self, slot: int, upto_position: int) -> None:
        """Make sure pages covering positions < `upto_position` exist
        (decode/speculative writes march forward; pages appear as the
        sequence crosses page boundaries, drawn from the reservation
        made at admission)."""
        need = pages_for(upto_position, self.page_size)
        if need > self._slot_total[slot]:
            raise ValueError(
                f"slot {slot}: position {upto_position} beyond reserved "
                f"{self._slot_total[slot]} pages")
        while self._slot_len[slot] < need:
            j = self._slot_len[slot]
            self.table[slot, j] = self._alloc_page()
            self._slot_len[slot] = j + 1
            self._reserved -= 1

    def write_barrier(self, slot: int, start: int, end: int) -> list:
        """Copy-on-write guard: every page overlapping positions
        [start, end) that is shared (another slot's table or the prefix
        index also references it) is replaced by a fresh private clone.
        Returns [(src, dst)] page copies the caller MUST apply to the
        device pool before any program writes the range."""
        if end <= start:
            return []
        copies = []
        ps = self.page_size
        for j in range(start // ps, pages_for(end, ps)):
            if j >= self._slot_len[slot]:
                break  # not allocated yet; append() hands out fresh pages
            page = int(self.table[slot, j])
            shared = self._ref[page] > 1 or page in self._page_key
            if page != TRASH_PAGE and shared:
                clone = self._alloc_page()
                self._ref[page] -= 1
                self.table[slot, j] = clone
                copies.append((page, clone))
                self.cow_clones += 1
        return copies

    def free(self, slot: int) -> None:
        """Release the slot: deref every page (shared prompt pages
        survive in the prefix index for future hits), zero the table
        row so the idle slot's lockstep writes land in the trash page,
        drop the unallocated reservation."""
        for j in range(self._slot_len[slot]):
            page = int(self.table[slot, j])
            if page == TRASH_PAGE:
                continue
            self._ref[page] -= 1
            if self._ref[page] == 0:
                heapq.heappush(self._free, page)
        self._reserved -= self._slot_total[slot] - self._slot_len[slot]
        self.table[slot, :] = TRASH_PAGE
        self._slot_len[slot] = 0
        self._slot_total[slot] = 0

    def reset(self) -> None:
        """Forget everything (the decoder's fail_all path: device state
        is rebuilt from scratch, so cached prefix pages are garbage)."""
        self.table[:, :] = TRASH_PAGE
        self._free = list(range(1, self.num_pages))
        heapq.heapify(self._free)
        self._ref[:] = 0
        self._slot_len = [0] * self.slots
        self._slot_total = [0] * self.slots
        self._reserved = 0
        self._prefix.clear()
        self._page_key.clear()

    # -- invariants (the property test's oracle) --------------------------

    def check(self) -> None:
        refs = np.zeros(self.num_pages, np.int64)
        for s in range(self.slots):
            row = self.table[s, :self._slot_len[s]]
            for page in row:
                assert page != TRASH_PAGE, (s, row)
                refs[page] += 1
            assert (self.table[s, self._slot_len[s]:] == TRASH_PAGE).all()
        for page in self._prefix.values():
            refs[page] += 1
        assert (refs == self._ref).all(), "refcount drift"
        free = set(self._free)
        assert len(free) == len(self._free), "freelist duplicates"
        assert TRASH_PAGE not in free
        for page in range(1, self.num_pages):
            in_free = page in free
            assert in_free == (refs[page] == 0), (page, refs[page], in_free)
        assert set(self._page_key) == set(self._prefix.values())
        assert self._reserved == sum(
            t - l for t, l in zip(self._slot_total, self._slot_len))
        assert self._reserved >= 0


# ---------------------------------------------------------------------------
# device-side helpers (the only torch in this module)


def init_paged_cache(model, max_pages_per_slot: int) -> dict:
    """Zero page pools for a model built with cfg.kv_pages /
    kv_page_size, on the model's device, shaped from its config alone.
    `max_pages_per_slot` only shapes the caller's page table."""
    import torch

    from kubeflow_tpu_torch.models.transformer import paged_cache_shapes

    del max_pages_per_slot
    return {name: torch.zeros(shape, dtype=dtype, device=model.device)
            for name, (shape, dtype)
            in paged_cache_shapes(model.cfg).items()}


def copy_pages(cache: dict, src, dst) -> dict:
    """Apply copy-on-write clones in place: pool[dst] = pool[src] for
    every pool of the paged cache; src/dst are [m] page ids."""
    for pool in cache.values():
        pool[dst] = pool[src]
    return cache
