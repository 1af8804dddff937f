"""Decode-state management for the serving engine: slot pool + page pool.

Counterpart of ``repro/serving/engine/state.py``, without its ``mesh``
argument (a GSPMD sharding of the state; passing one raises
``NotImplementedError``).

``DecodeStatePool`` (the contiguous layout) owns the per-slot decode state
— the KV mean/variance caches (PFP's uncertainty-carrying analogue of a KV
cache: ``k_mu``, ``v_mu``, ``v_var``) plus any recurrent/SSM carries — as
ONE preallocated device pytree of ``num_slots`` batch rows
(``lm.init_decode_state``). Requests borrow a slot for their lifetime:

  alloc   -> pop the lowest free slot, zero its state rows on device
  evict   -> return the slot to the free list (completion or abstention);
             stale device rows are left in place — validity is governed by
             per-slot ``cache_len`` masks and the zero-on-alloc reset
  compact -> permutation-gather live slots to the front of the pool when
             eviction order fragments them (one device gather per leaf)

``PagedDecodeStatePool`` replaces the static per-slot ``max_len`` KV rows
with a global pool of fixed-size pages (``lm.init_paged_decode_state``):
slot identity lives entirely in host-side page tables, so device memory
scales with the TOKENS actually cached, not ``slots * max_len``. Pages
are REFCOUNTED, not slot-owned: a page may appear in several slots'
tables at once (requests sharing a prompt prefix) and be held by the
prefix index after its writer finished. Requests borrow a slot (a batch
row + a page-table row) and pages grow with their position:

  alloc            -> pop the lowest free slot (no pages yet)
  share            -> map already-cached prefix pages into a fresh slot's
                      table at refcount+1 (no device work, no copies —
                      paged attention reads through the table indirection)
  ensure_capacity  -> extend a slot's page list to cover its positions
                      (the engine calls it before each prefill chunk and
                      decode write; False = pool exhausted -> preempt)
  ensure_writable  -> copy-on-write: any page the slot is about to WRITE
                      that is still shared (refcount > 1) is first
                      duplicated onto a private page — ONE device gather +
                      scatter per leaf for all copies of the call — and
                      the slot's table rewritten to the copy
  hold / release   -> external references (the prefix index) on a page;
                      a page is freed only when its refcount drops to 0
  evict            -> release the slot's reference on every page it maps
                      (pages survive while shared or held); stale page
                      contents stay — per-batch ``cache_len`` masking plus
                      the trash-page write redirect make them invisible
  defrag           -> permutation-gather live pages to the pool front: a
                      shared page moves ONCE and every referencing table
                      (and, via remap listeners, the prefix index) is
                      rewritten to its new position

Page 0 is reserved as the TRASH page: the paged cache insert in
``nn/attention.py`` redirects writes at positions >= ``cache_len`` (and,
under prefix sharing, below ``write_start``) there, which is what lets
one lockstep pass over the shared pool serve slots at different
lifecycle phases without select-merge.

Speculative decoding writes through the same discipline: a chunked
verify pass lands a whole K-token block of rows via the paged insert,
and a rejected suffix needs no device-side rollback — the engine leaves
``positions[slot]`` at the accepted prefix, so the stale rows sit masked
behind ``cache_len`` until the next block re-feeds them (or, once the
slot's window moves past them, their writes redirect to trash).

All device transfers are whole-axis gathers and scatters on the device;
neither pool ever round-trips KV buffers through the host. Host state is
only free lists, page tables and per-slot position counters.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import lm


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a sharded decode state (mesh) is not ported yet (ROADMAP.md)")


class DecodeStatePool:
    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int, *,
                 mesh=None, device: DeviceLike = None):
        _no_mesh(mesh)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.states = lm.init_decode_state(cfg, num_slots, max_len,
                                           device=self.device)
        # Lowest-index-first allocation keeps live slots packed at the
        # front, bounding fragmentation between compactions.
        self._free: List[int] = list(range(num_slots))
        self.owner: List[Optional[int]] = [None] * num_slots  # request uid
        self.positions = np.zeros(num_slots, np.int32)  # valid cache entries
        self._reset = lm.reset_decode_slot
        self._take = lm.take_decode_slots
        self._write = lm.write_decode_slot

    # -- occupancy ----------------------------------------------------------
    @property
    def live(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def live_slot_indices(self) -> List[int]:
        return [i for i, o in enumerate(self.owner) if o is not None]

    def fragmentation(self) -> int:
        """Number of live slots sitting past the packed prefix."""
        live = self.live_slot_indices()
        return sum(1 for s in live if s >= len(live))

    # -- lifecycle ----------------------------------------------------------
    def alloc(self, uid: int) -> int:
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        slot = min(self._free)
        self._free.remove(slot)
        self.owner[slot] = uid
        self.positions[slot] = 0
        # Zero the new occupant's rows: KV masking hides stale *attention*
        # rows, but recurrent/SSM carries have no validity mask.
        self.states = self._reset(self.states, slot)
        return slot

    def evict(self, slot: int) -> int:
        """Free ``slot``; returns the evicted request's uid."""
        uid = self.owner[slot]
        if uid is None:
            raise RuntimeError(f"evict of idle slot {slot}")
        self.owner[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)
        return uid

    def compact(self) -> Dict[int, int]:
        """Pack live slots to the pool front (stable order).

        Returns the {old_slot: new_slot} remap applied; callers holding
        slot indices (the engine's per-slot records, logit buffers) must
        remap with it. One permutation gather per state leaf, on device.
        """
        live = self.live_slot_indices()
        remap = {old: new for new, old in enumerate(live)}
        if all(old == new for old, new in remap.items()):
            return {}
        perm = live + [s for s in range(self.num_slots) if s not in remap]
        self.states = self._take(self.states, np.asarray(perm, np.int32))
        self.owner = [self.owner[s] for s in perm]
        self.positions = self.positions[perm]
        self._free = [i for i, o in enumerate(self.owner) if o is None]
        return remap

    # -- per-slot device views ----------------------------------------------
    def take_slot(self, slot: int):
        """Single-slot (batch=1) state view, e.g. for a prefill chunk or an
        SVI second-opinion pass."""
        return self._take(self.states, np.asarray([slot], np.int32))

    def write_slot(self, slot: int, sub) -> None:
        self.states = self._write(self.states, slot, sub)

    def check_invariants(self) -> None:
        assert sorted(self._free) == sorted(
            i for i, o in enumerate(self.owner) if o is None)
        assert len(self.owner) == self.num_slots
        assert all(self.positions[s] == 0 for s in self._free)
        uids = [o for o in self.owner if o is not None]
        assert len(uids) == len(set(uids)), "duplicate owner uid"


class PagedDecodeStatePool:
    """Page-pool decode-state manager (see module docstring).

    ``num_pages`` is the USABLE page budget (page 0, the trash page, is
    allocated on top of it); the default budget ``num_slots *
    ceil(max_len / page_size)`` matches the contiguous layout's capacity
    exactly, so the paged engine admits whenever the static one would —
    a smaller budget trades admission headroom for device memory, which
    is the whole point of paging: slots only hold pages for tokens they
    actually cached.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 page_size: int, *, num_pages: Optional[int] = None,
                 mesh=None, device: DeviceLike = None):
        _no_mesh(mesh)
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = math.ceil(max_len / page_size)
        usable = (num_pages if num_pages is not None
                  else num_slots * self.pages_per_slot)
        if usable < self.pages_per_slot:
            raise ValueError(
                f"page budget {usable} cannot hold one max_len={max_len} "
                f"request ({self.pages_per_slot} pages of {page_size})")
        self.num_pages = 1 + usable              # + the reserved trash page
        self.device = resolve_device(device)
        self.states = lm.init_paged_decode_state(cfg, self.num_pages,
                                                 page_size,
                                                 device=self.device)
        # Host-side identity: slots are batch rows; pages are pool rows.
        self._free: List[int] = list(range(num_slots))
        self.owner: List[Optional[int]] = [None] * num_slots   # request uid
        self.positions = np.zeros(num_slots, np.int32)
        self.page_table = np.zeros((num_slots, self.pages_per_slot), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # Lowest-index-first page allocation (a min-heap: a large pool
        # hands out hundreds of pages per reservation) keeps live pages
        # packed low, bounding fragmentation between defrags.
        self._free_pages: List[int] = list(range(1, self.num_pages))
        # Refcounted ownership: page_ref[p] counts every reference on page
        # p — one per slot table mapping it plus one per external hold
        # (the prefix index). external_holds is the hold subset, so the
        # invariant page_ref == table_refs + external_holds is checkable.
        # The trash page carries a -1 sentinel: never allocated, never
        # freed, never counted.
        self.page_ref: List[int] = [0] * self.num_pages
        self.page_ref[0] = -1
        self.external_holds: List[int] = [0] * self.num_pages
        self.cow_copies = 0                      # lifetime COW page copies
        # Listeners notified with the {old_page: new_page} map after every
        # defrag, so page-indexed structures outside the tables (the
        # prefix index) stay aligned with the moved pool rows.
        self._remap_listeners: List[Callable[[Dict[int, int]], None]] = []
        self._device_table = None                # cache; tables change rarely
        self._take = lm.take_decode_slots
        self._copy = lm.copy_decode_pages

    # -- occupancy ----------------------------------------------------------
    @property
    def live(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def total_pages(self) -> int:
        """Usable pages (the trash page is not part of the budget)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def live_pages(self) -> int:
        return self.total_pages - len(self._free_pages)

    def live_slot_indices(self) -> List[int]:
        return [i for i, o in enumerate(self.owner) if o is not None]

    def pages_needed(self, tokens: int) -> int:
        return math.ceil(tokens / self.page_size)

    @property
    def shared_pages(self) -> int:
        """Pages referenced more than once (table mappings + holds)."""
        return sum(1 for r in self.page_ref[1:] if r > 1)

    @property
    def held_pages(self) -> int:
        """Pages carrying at least one external (prefix-index) hold."""
        return sum(1 for h in self.external_holds[1:] if h > 0)

    def page_fragmentation(self) -> int:
        """Live pages sitting past the packed prefix [1 .. live_pages]."""
        live = self.live_pages
        return sum(1 for p, r in enumerate(self.page_ref)
                   if p > 0 and r > 0 and p > live)

    def page_gauges(self) -> Tuple[int, int, int]:
        """(live, total, fragmented) — the per-step page telemetry tuple
        the engine hands to ``EngineMetrics.on_step``."""
        return (self.live_pages, self.total_pages,
                self.page_fragmentation())

    # -- lifecycle ----------------------------------------------------------
    def alloc(self, uid: int) -> int:
        """Borrow a slot (batch row + page-table row). Pages come later via
        :meth:`ensure_capacity` — a fresh slot holds none."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        slot = min(self._free)
        self._free.remove(slot)
        self.owner[slot] = uid
        self.positions[slot] = 0
        assert not self.slot_pages[slot]
        return slot

    def ensure_capacity(self, slot: int, upto_len: int) -> bool:
        """Grow ``slot``'s page list to cover positions [0, upto_len).

        Allocation is atomic: if the pool cannot supply every missing page
        the pool is left unchanged and False is returned (the engine then
        preempts or requeues). No device work — pages are zero-initialized
        at pool construction and stale contents are masked.
        """
        if self.owner[slot] is None:
            raise RuntimeError(f"ensure_capacity on idle slot {slot}")
        if upto_len > self.max_len:
            raise ValueError(f"slot {slot}: {upto_len} exceeds max_len")
        need = self.pages_needed(upto_len) - len(self.slot_pages[slot])
        if need <= 0:
            return True
        if need > len(self._free_pages):
            return False
        for _ in range(need):
            page = heapq.heappop(self._free_pages)
            self.page_ref[page] = 1
            self.page_table[slot, len(self.slot_pages[slot])] = page
            self.slot_pages[slot].append(page)
        self._device_table = None
        return True

    # -- prefix sharing: refcounts, holds, copy-on-write --------------------
    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Map already-cached prefix ``pages`` (in logical order, page 0 of
        the sequence first) into a FRESH slot's table at refcount+1. No
        device work: paged attention reads through the table indirection,
        so the mapped rows are immediately visible to the new slot."""
        if self.owner[slot] is None:
            raise RuntimeError(f"share into idle slot {slot}")
        if self.slot_pages[slot]:
            raise RuntimeError(f"share into non-empty slot {slot}")
        for j, page in enumerate(pages):
            if not 0 < page < self.num_pages or self.page_ref[page] < 1:
                raise RuntimeError(f"share of dead page {page}")
            self.page_ref[page] += 1
            self.page_table[slot, j] = page
            self.slot_pages[slot].append(page)
        if pages:
            self._device_table = None

    def hold(self, page: int) -> None:
        """Take an external (prefix-index) reference on a live page."""
        if not 0 < page < self.num_pages or self.page_ref[page] < 1:
            raise RuntimeError(f"hold of dead page {page}")
        self.page_ref[page] += 1
        self.external_holds[page] += 1

    def release_hold(self, page: int) -> None:
        """Drop an external reference; frees the page at refcount 0."""
        if self.external_holds[page] < 1:
            raise RuntimeError(f"release of unheld page {page}")
        self.external_holds[page] -= 1
        self._unref(page)

    def _unref(self, page: int) -> None:
        self.page_ref[page] -= 1
        if self.page_ref[page] == 0:
            heapq.heappush(self._free_pages, page)

    def writable(self, slot: int, start: int, upto: int) -> bool:
        """True iff every page of ``slot`` covering positions
        [start, upto) is private (refcount 1) — i.e. ensure_writable
        would be a no-op."""
        lo, hi = start // self.page_size, self.pages_needed(upto)
        return all(self.page_ref[p] == 1
                   for p in self.slot_pages[slot][lo:hi])

    def ensure_writable(self, slot: int, start: int, upto: int) -> bool:
        """Copy-on-write for the pages ``slot`` is about to write.

        Positions [start, upto) must already be covered by the slot's
        table (ensure_capacity first). Any covering page still shared
        (refcount > 1) is duplicated onto a private page — ALL copies of
        the call ride one device gather + scatter per leaf — and the
        slot's table entry is swapped to the copy; the shared original
        keeps its remaining references. Atomic: returns False (pool
        unchanged) when the free list cannot supply every copy target.
        """
        if self.owner[slot] is None:
            raise RuntimeError(f"ensure_writable on idle slot {slot}")
        lo, hi = start // self.page_size, self.pages_needed(upto)
        pages = self.slot_pages[slot]
        if hi > len(pages):
            raise ValueError(
                f"slot {slot}: ensure_writable upto {upto} exceeds the "
                f"{len(pages)} mapped pages (ensure_capacity first)")
        cow = [j for j in range(lo, hi) if self.page_ref[pages[j]] > 1]
        if not cow:
            return True
        if len(cow) > len(self._free_pages):
            return False
        src, dst = [], []
        for j in cow:
            page = pages[j]
            copy = heapq.heappop(self._free_pages)
            self.page_ref[copy] = 1
            self._unref(page)       # shared before, so never frees here
            pages[j] = copy
            self.page_table[slot, j] = copy
            src.append(page)
            dst.append(copy)
        self.states = self._copy(self.states, np.asarray(src, np.int32),
                                 np.asarray(dst, np.int32))
        self.cow_copies += len(cow)
        self._device_table = None
        return True

    def evict(self, slot: int) -> int:
        """Release ``slot`` and its reference on every page it maps;
        returns the evicted request's uid. A page is freed only when its
        refcount drops to 0 — pages shared with other slots or held by
        the prefix index survive. Stale page contents stay in place — the
        trash-page write redirect plus ``cache_len`` masking keep them
        invisible."""
        uid = self.owner[slot]
        if uid is None:
            raise RuntimeError(f"evict of idle slot {slot}")
        for page in self.slot_pages[slot]:
            self._unref(page)
        if self.slot_pages[slot]:
            self._device_table = None
        self.slot_pages[slot] = []
        self.page_table[slot] = 0
        self.owner[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)
        return uid

    def add_remap_listener(self,
                           fn: Callable[[Dict[int, int]], None]) -> None:
        """Register a callback receiving the {old: new} page map applied
        by every defrag (page-indexed structures outside the tables —
        the prefix index — must follow the moved rows)."""
        self._remap_listeners.append(fn)

    def defrag(self) -> Optional[np.ndarray]:
        """Pack live pages to the pool front (stable order, trash page
        pinned at 0). One permutation gather per attention leaf, on
        device; a SHARED page moves once and every slot table referencing
        it is rewritten (plus any registered remap listeners — the prefix
        index). Returns the applied page permutation (``perm[new] =
        old``) so callers holding page-indexed snapshots can remap, or
        None when already packed."""
        live = [p for p in range(1, self.num_pages) if self.page_ref[p] > 0]
        dest = {old: new for new, old in enumerate(live, start=1)}
        if all(old == new for old, new in dest.items()):
            return None
        perm = np.asarray(
            [0] + live + [p for p in range(1, self.num_pages)
                          if p not in dest], np.int32)
        self.states = self._take(self.states, perm)
        new_ref = [0] * self.num_pages
        new_ext = [0] * self.num_pages
        new_ref[0] = -1
        for old, new in dest.items():
            new_ref[new] = self.page_ref[old]
            new_ext[new] = self.external_holds[old]
        self.page_ref = new_ref
        self.external_holds = new_ext
        for slot in self.live_slot_indices():
            self.slot_pages[slot] = [dest[p] for p in self.slot_pages[slot]]
            self.page_table[slot, :len(self.slot_pages[slot])] = \
                self.slot_pages[slot]
        self._free_pages = [p for p in range(1, self.num_pages)
                            if self.page_ref[p] == 0]
        heapq.heapify(self._free_pages)
        self._device_table = None
        for listener in self._remap_listeners:
            listener(dest)
        return perm

    # -- device views -------------------------------------------------------
    def device_table(self, slots: Optional[np.ndarray] = None):
        """The page table as an int32 tensor on the pool's device —
        (num_slots, P), or the selected rows when ``slots`` is given (e.g.
        a replay's batch). The full table is cached between mutations
        (alloc/evict/defrag), so steady-state decode pays no per-step
        host-to-device upload."""
        if slots is not None:
            return torch.tensor(self.page_table[slots], device=self.device)
        if self._device_table is None:
            self._device_table = torch.tensor(self.page_table,
                                              device=self.device)
        return self._device_table

    def check_invariants(self) -> None:
        assert sorted(self._free) == sorted(
            i for i, o in enumerate(self.owner) if o is None)
        uids = [o for o in self.owner if o is not None]
        assert len(uids) == len(set(uids)), "duplicate owner uid"
        assert self.page_ref[0] == -1 and 0 not in self._free_pages
        assert self.external_holds[0] == 0
        table_refs = [0] * self.num_pages
        for slot in range(self.num_slots):
            pages = self.slot_pages[slot]
            if self.owner[slot] is None:
                assert not pages
                assert not self.page_table[slot].any()
                assert self.positions[slot] == 0
                continue
            assert len(set(pages)) == len(pages), "slot holds duplicate page"
            for j, page in enumerate(pages):
                assert 0 < page < self.num_pages
                assert self.page_ref[page] > 0, \
                    f"slot {slot} maps freed page {page}"
                assert self.page_table[slot, j] == page
                table_refs[page] += 1
            assert not self.page_table[slot, len(pages):].any()
            assert self.positions[slot] <= len(pages) * self.page_size
        for p in range(1, self.num_pages):
            assert self.external_holds[p] >= 0
            assert self.page_ref[p] == table_refs[p] + self.external_holds[p], \
                (f"page {p}: refcount {self.page_ref[p]} != "
                 f"{table_refs[p]} table refs + "
                 f"{self.external_holds[p]} holds")
        assert sorted(self._free_pages) == sorted(
            p for p in range(1, self.num_pages) if self.page_ref[p] == 0)
