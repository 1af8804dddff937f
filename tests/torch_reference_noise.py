"""The reference's SVI weight noise, rebuilt for the port's ``Context.eps``.

The reference keys a leaf's SVI noise ``fold_in(fold_in(key, counter),
layer_tag)`` (``repro/nn/module.py`` ``Context.next_key``): the counter
restarts at each ``with_layer``, whose tags are 1000 + i for the head
layers, the group index for the stacked ones and 2000 + i for the tail;
the embedding and the LM head count on the outer context (counters 1 and
2, tag 0). ``ReferenceLMEps`` hands the port that noise in the order the
port resolves its leaves. A helper of the port's tests, not a test file.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models import lm


@functools.partial(jax.jit, static_argnums=3)
def draw(key, counter, tag, shape):
    """``Context.next_key``'s normal draw for one leaf."""
    k = jax.random.fold_in(jax.random.fold_in(key, counter), tag)
    return jax.random.normal(k, shape, jnp.float32)


def leaf_schedule(cfg, per_block):
    """(layer_tag, counter) of every leaf of one reference LM forward, in
    the order the port resolves them."""
    lpg, groups, tail = lm._group_counts(cfg)
    sched = [(0, 1)]                                  # the embedding
    for i in range(cfg.first_dense_layers):
        sched += [(1000 + i, c) for c in range(1, per_block + 1)]
    for g in range(groups):
        sched += [(g, c) for c in range(1, lpg * per_block + 1)]
    for i in range(tail):
        sched += [(2000 + i, c) for c in range(1, per_block + 1)]
    return sched + [(0, 2)]                           # the LM head


class ReferenceLMEps:
    """``Context.eps`` handing the port the reference's SVI noise of one
    LM forward under ``key``: leaf n draws
    ``normal(fold_in(fold_in(key, counter), tag))`` with (tag, counter)
    the n-th entry of ``schedule``."""

    def __init__(self, key, schedule):
        self.key, self.schedule = key, schedule
        self.calls = 0

    def __call__(self, mu):
        tag, counter = self.schedule[self.calls]
        self.calls += 1
        return torch.from_numpy(np.array(draw(
            self.key, counter, tag, tuple(mu.shape))))
