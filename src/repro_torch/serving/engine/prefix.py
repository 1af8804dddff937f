"""Radix-tree prefix index over the paged Gaussian KV-cache.

Counterpart of ``repro/serving/engine/prefix.py`` (host-only Python; the
port keeps its own copy).

PFP K/V rows are deterministic per (token, position), so two requests
whose prompts share a token prefix would write IDENTICAL rows into their
leading pages — recomputing and re-storing them per request wastes both
prefill FLOPs and page budget (the paper's economics argument, applied
across requests instead of across samples). This module is the lookup
side of prefix sharing: a radix tree keyed on token ids at page
granularity, where each node IS one cached page of the pool:

    node.key    the <= page_size token ids whose k/v rows the page holds
                (a partial key marks a partially-filled tail page)
    node.page   the pool page id; the index takes a refcount hold on it
                (``pool.hold``), so the page outlives its writer

``insert`` registers a finished request's lineage (prompt + generated
tokens, in page_size chunks); ``match`` walks the tree for a new prompt
and returns the longest cached page chain: full-key edges descend, and a
final PARTIAL edge match (the first m < page_size tokens of a child's
key) may contribute one partially-valid page — the sharer maps it too
and copy-on-writes it before its first divergent write.

The index never exceeds ``retention_pages`` held pages: inserts evict
least-recently-matched LEAVES of other lineages first (an inner node's
page backs every descendant's prefix, so leaves must go first) and
truncate their own tail when nothing else can yield; explicit
``reclaim`` calls (the engine under page pressure) evict LRU leaves too,
but only count evictions that actually free memory — releasing a hold on
a page some slot still maps frees nothing.

Pure host logic over (tokens, page id) pairs; the device pages stay in
the pool. Page moves (defrag) reach the index through the pool's remap
listener hook.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class PrefixNode:
    key: Tuple[int, ...]                 # tokens this page's rows encode
    page: int                            # pool page id (held)
    parent: Optional["PrefixNode"]
    children: Dict[Tuple[int, ...], "PrefixNode"] = \
        dataclasses.field(default_factory=dict)
    last_used: int = 0                   # LRU clock at last match/insert

    @property
    def valid(self) -> int:
        """Valid rows in the page (== len(key); partial for tail pages)."""
        return len(self.key)


class PrefixIndex:
    def __init__(self, page_size: int, retention_pages: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if retention_pages < 0:
            raise ValueError("retention_pages must be >= 0")
        self.page_size = page_size
        self.retention_pages = retention_pages
        self._roots: Dict[Tuple[int, ...], PrefixNode] = {}
        self._nodes: Dict[int, PrefixNode] = {}     # page id -> node
        self._clock = 0

    # -- introspection -------------------------------------------------------
    @property
    def pages_held(self) -> int:
        return len(self._nodes)

    def check_invariants(self, pool) -> None:
        assert self.pages_held <= self.retention_pages
        for page, node in self._nodes.items():
            assert node.page == page
            assert pool.page_ref[page] >= 1
            assert pool.external_holds[page] >= 1
            siblings = (self._roots if node.parent is None
                        else node.parent.children)
            assert siblings.get(node.key) is node
            # partial-key nodes are tails: nothing can extend them
            if node.valid < self.page_size:
                assert not node.children

    # -- lookup --------------------------------------------------------------
    def match(self, tokens, *, limit: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``.

        Returns (pages, matched): ``pages`` is the logical page chain
        (consecutive from position 0) and ``matched`` the token count it
        covers — a multiple of page_size except when the last page is a
        partial match (the sharer must copy-on-write that page before
        writing into it). ``limit`` caps the match (the engine passes
        len(prompt) - 1 so at least one token is always prefilled —
        logits for the first generated token come from feeding the last
        prompt token).
        """
        self._clock += 1
        limit = len(tokens) if limit is None else min(limit, len(tokens))
        pages: List[int] = []
        matched = 0
        children = self._roots
        while matched < limit:
            remaining = [int(t) for t in tokens[matched:limit]]
            full = tuple(remaining[:self.page_size])
            node = children.get(full) if len(full) == self.page_size else None
            if node is not None:
                node.last_used = self._clock
                pages.append(node.page)
                matched += self.page_size
                children = node.children
                continue
            # No full-page edge: take the child with the longest common
            # key prefix as one final, partially-valid page.
            best, best_m = None, 0
            for child in children.values():
                m = 0
                for a, b in zip(child.key, remaining):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best, best_m = child, m
            if best is not None:
                best.last_used = self._clock
                pages.append(best.page)
                matched += best_m
            break
        return pages, matched

    def peek(self, tokens, *, limit: Optional[int] = None) -> int:
        """Length of the longest cached prefix of ``tokens`` WITHOUT
        touching the LRU clock or any node's recency — the fleet router's
        read-only probe. Routing consults every replica's index; if the
        probe bumped recency, the mere act of routing would perturb each
        index's retention order and make eviction depend on fleet-level
        traffic instead of the replica's own matches."""
        limit = len(tokens) if limit is None else min(limit, len(tokens))
        matched = 0
        children = self._roots
        while matched < limit:
            remaining = [int(t) for t in tokens[matched:limit]]
            full = tuple(remaining[:self.page_size])
            node = children.get(full) if len(full) == self.page_size else None
            if node is not None:
                matched += self.page_size
                children = node.children
                continue
            best_m = 0
            for child in children.values():
                m = 0
                for a, b in zip(child.key, remaining):
                    if a != b:
                        break
                    m += 1
                best_m = max(best_m, m)
            matched += best_m
            break
        return matched

    # -- registration --------------------------------------------------------
    def insert(self, tokens, pages, pool) -> int:
        """Register a lineage: ``tokens`` (prompt + generated, truncated to
        the rows actually written) backed by the slot's leading ``pages``.
        Walks the tree in page_size chunks; existing nodes (same key) are
        kept — the caller's page is usually the SAME page, shared at
        admission — and new nodes take a ``pool.hold`` on their page.
        Returns the number of pages newly indexed. Retention is enforced
        front-first: before each new hold an LRU leaf from OTHER lineages
        is evicted, and when none exists the insert truncates its own
        TAIL (leading pages are the shareable ones) — pages already
        indexed are never displaced by their own insert."""
        n_pages = min(len(pages),
                      -(-len(tokens) // self.page_size))  # ceil
        self._clock += 1
        children = self._roots
        parent: Optional[PrefixNode] = None
        added = 0
        fresh: List[int] = []
        for j in range(n_pages):
            chunk = tuple(int(t) for t in
                          tokens[j * self.page_size:(j + 1) * self.page_size])
            node = children.get(chunk)
            if node is not None:
                node.last_used = self._clock
                parent, children = node, node.children
                continue
            page = int(pages[j])
            if page in self._nodes:      # page already indexed elsewhere
                break
            if self.pages_held >= self.retention_pages:
                victims = [n for n in self._leaves()
                           if n.page not in fresh and n is not parent]
                if not victims:
                    break                # truncate our own tail instead
                # Prefer victims whose hold is the only thing keeping the
                # page alive (the same refcount test reclaim applies):
                # evicting a leaf some live slot still maps frees zero
                # memory AND loses a reusable prefix — only fall back to
                # still-mapped leaves when every freeable one is gone.
                freeable = [n for n in victims
                            if pool.page_ref[n.page]
                            == pool.external_holds[n.page]]
                self._evict_node(min(freeable or victims,
                                     key=lambda n: n.last_used), pool)
            node = PrefixNode(key=chunk, page=page, parent=parent,
                              last_used=self._clock)
            pool.hold(page)
            children[chunk] = node
            self._nodes[page] = node
            fresh.append(page)
            added += 1
            if len(chunk) < self.page_size:
                break                    # partial tails take no children
            parent, children = node, node.children
        return added

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[PrefixNode]:
        return [n for n in self._nodes.values() if not n.children]

    def _evict_node(self, node: PrefixNode, pool) -> None:
        siblings = (self._roots if node.parent is None
                    else node.parent.children)
        del siblings[node.key]
        del self._nodes[node.page]
        pool.release_hold(node.page)

    def reclaim(self, pool, need: int = 1) -> int:
        """Release LRU leaves until ``need`` pages were actually FREED
        (refcount hit 0) or no productive leaf remains. Leaves some other
        slot still maps are skipped — releasing those holds frees
        nothing. Returns the number of pages freed."""
        freed = 0
        while freed < need:
            victims = [n for n in self._leaves()
                       if pool.page_ref[n.page] == pool.external_holds[n.page]]
            if not victims:
                return freed
            node = min(victims, key=lambda n: n.last_used)
            before = pool.free_pages
            self._evict_node(node, pool)
            freed += pool.free_pages - before
        return freed

    def clear(self, pool) -> None:
        """Drop every held page (tests / shutdown)."""
        for node in self._nodes.values():
            pool.release_hold(node.page)
        self._nodes = {}
        self._roots = {}

    # -- pool defrag ---------------------------------------------------------
    def remap_pages(self, mapping: Dict[int, int]) -> None:
        """Follow a pool defrag: rewrite every node's page id with the
        {old: new} map (registered as a pool remap listener)."""
        nodes = {}
        for node in self._nodes.values():
            node.page = mapping.get(node.page, node.page)
            nodes[node.page] = node
        self._nodes = nodes
