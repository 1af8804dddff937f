"""Synthetic LM token pipeline: sharded, step-indexed, restart-reproducible.

The port's own copy of ``repro/data/tokens.py``. It uses numpy only, so
both packages make the same batches from the same seed and step.

Generates structured pseudo-text (Zipfian unigrams + a first-order Markov
kick so the LM has learnable signal) deterministically from (seed, step),
which gives the two properties a pod-scale pipeline needs:
  * no coordination: every host materializes exactly its shard of the
    global batch from (step, host_id) — no data server in the loop;
  * bit-reproducible restarts: step N yields the same batch after a
    checkpoint restore, on any mesh size.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, alpha: float = 1.1):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -alpha
        self._probs = (p / p.sum()).astype(np.float64)

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def global_batch_at(self, step: int) -> np.ndarray:
        return self.shard_batch_at(step, 0, 1)

    def shard_batch_at(self, step: int, shard: int, num_shards: int
                       ) -> np.ndarray:
        """The `shard`-th slice of the global batch for `step`."""
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        rng = self._rng(step, shard)
        base = rng.choice(self.vocab_size, size=(per, self.seq_len + 1),
                          p=self._probs)
        # Markov kick: with p=0.5 repeat-shift the previous token (bigram
        # structure a context model can learn).
        rep = rng.random((per, self.seq_len)) < 0.5
        nxt = (base[:, :-1] + 1) % self.vocab_size
        base[:, 1:][rep] = nxt[rep]
        return base.astype(np.int32)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """Returns {'tokens': (b, T), 'targets': (b, T)} for this shard."""
        seq = self.shard_batch_at(step, shard, num_shards)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
