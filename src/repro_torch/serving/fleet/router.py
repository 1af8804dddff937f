"""Cross-replica prefix routing.

Counterpart of ``repro/serving/fleet/router.py`` (host-only Python; the
port keeps its own copy).

Each replica's radix prefix index already answers "how many leading
tokens of this prompt do I hold pages for?" — the same question the
single-engine admission path asks before mapping shared pages. The fleet
router asks it ACROSS replicas (through the read-only ``prefix_peek``
probe, so routing never perturbs any index's LRU retention order) and
sends the request where the answer is longest: that replica will map the
cached pages at refcount+1 and prefill only the suffix, so the routing
decision converts directly into saved prefill work and page budget.

When no replica holds a usable prefix (fewer than ``min_tokens`` cached
tokens), the request routes to the least-loaded replica — plain load
balancing, which is also what seeds the prefix locality the next
requests of the same stream then route on.

Ties are deterministic (lowest replica index wins), so a fleet replay of
the same trace always routes identically.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.serving.batcher import Request


class PrefixRouter:
    """Longest-cached-prefix routing with a least-loaded fallback."""

    def __init__(self, min_tokens: int = 1):
        if min_tokens < 1:
            raise ValueError("min_tokens must be >= 1")
        self.min_tokens = min_tokens

    def route(self, req: Request,
              replicas: Sequence) -> Tuple[int, int, bool]:
        """Pick a replica for ``req``.

        Replicas expose ``prefix_peek(tokens) -> int`` (cached prefix
        length, 0 without an index) and ``load`` (queued + occupying
        work). Returns (replica index, matched tokens, prefix_routed):
        ``prefix_routed`` is True when the choice was driven by a cached
        prefix of at least ``min_tokens`` tokens, False for the
        least-loaded fallback.
        """
        best_idx, best_matched = 0, -1
        for idx, replica in enumerate(replicas):
            matched = replica.prefix_peek(req.prompt)
            if matched > best_matched:
                best_idx, best_matched = idx, matched
        if best_matched >= self.min_tokens:
            return best_idx, best_matched, True
        idx = min(range(len(replicas)), key=lambda i: (replicas[i].load, i))
        return idx, 0, False
