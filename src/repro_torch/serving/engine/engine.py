"""The continuous-batching serving engine for PFP-BNN language models.

Counterpart of ``repro/serving/engine/engine.py`` without SVI escalation
and speculative decoding, which come with port slice 3b, part (b)
(ROADMAP.md queue A item 2). One ``Engine`` owns a fixed decode batch of
``slots`` sequences over one model:

  submit -> scheduler (admission control, priority/deadline + aging;
            paged engines admit on PAGE budget, not slot count — with
            prefix sharing, a shared page costs the budget once)
         -> state pool (contiguous: zeroed per-slot KV mean/variance rows;
            paged: a page-table row over the shared refcounted Gaussian
            page pool; prefix sharing maps a cached prompt prefix's pages
            into the table at refcount+1 and copies-on-write the
            partially-shared boundary page)
         -> chunked prefill (budgeted prompt tokens per engine step;
            paged engines batch each round's chunks into ONE multi-slot
            pass; prefix-shared slots prefill only the non-shared suffix)
         -> lockstep PFP decode (ONE probabilistic pass per step for the
            whole batch: logit means + variances)
         -> uncertainty router (continue / abstain; the grey zone abstains
            until escalation is ported)
         -> eviction on completion or abstention (slot + pages return to
            the pool; optimistic page admission may PREEMPT the youngest
            slot when the pool runs dry — its request is requeued and
            later re-prefilled from prompt + generated, bit-identically)

Per-slot decode state stays on the device for a request's whole lifetime;
the host reads (B,)-sized tokens and mutual-information values once a
step (and the MoE drop counts once more on the MoE family). The
contiguous layout protects parked and mid-prefill slots with
``lm.select_decode_slots``; the paged layout needs no merge — writes from
slots that must not advance go to the pool's trash page (the paged cache
insert in ``nn/attention.py``).

The passes run eagerly: the reference shares jitted executables between
engines, the port has nothing to share. Every pass keeps one shape per
engine (prefill windows of ``prefill_chunk`` rows, decode at slot width),
so the bits of a row depend only on its own tokens and keys on the card
(the dense and norm kernels' rows do not depend on M, the cache kernels'
rows not on Tq, B or the page layout): a request's tokens and MI are the
same on both pools, with and without prefix sharing or preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import is_gaussian
from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import Context
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.decode import uncertainty_decode
from repro_torch.serving.engine.metrics import EngineMetrics
from repro_torch.serving.engine.prefix import PrefixIndex
from repro_torch.serving.engine.router import (Decision, RouterConfig,
                                               UncertaintyRouter)
from repro_torch.serving.engine.scheduler import (RequestScheduler,
                                                  SchedulerConfig, pages_for)
from repro_torch.serving.engine.state import (DecodeStatePool,
                                              PagedDecodeStatePool)

_LATER = "port slice 3b, part (b) (ROADMAP.md queue A item 2)"
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's fields without ``compute_dtype``: the port serves
    in IEEE fp32 (ROADMAP.md queue C)."""
    slots: int = 4
    max_len: int = 64
    num_uncertainty_samples: int = 32
    greedy: bool = True
    eos_id: Optional[int] = None
    formulation: str = "srm"
    impl: Optional[str] = None     # 'eager' | 'kernel' | None = registry
    seed: int = 0
    auto_compact: bool = False     # contiguous: compact whenever fragmented
    # -- paged Gaussian KV-cache (attention-family models only) -------------
    page_size: Optional[int] = None  # None = contiguous per-slot layout
    page_budget: Optional[int] = None  # usable pages; None = slots *
    #                                    ceil(max_len / page_size) (the
    #                                    contiguous layout's capacity)
    reserve_pages: bool = True     # True: admission reserves the full
    #                                prompt+generation page need (never
    #                                preempts). False: optimistic — pages
    #                                are claimed on demand; exhaustion
    #                                preempts the youngest slot.
    auto_defrag: bool = False      # paged: defrag whenever fragmented
    # -- refcounted prefix sharing (paged engines only) ---------------------
    prefix_sharing: bool = False   # index finished lineages' pages and map
    #                                them copy-on-write into new requests
    #                                sharing a prompt prefix
    prefix_retention_pages: Optional[int] = None  # max pages the prefix
    #                                index may hold after their writers
    #                                finished; None = the whole page budget
    speculate_k: int = 0           # must stay 0 until speculation is ported
    batch_escalations: bool = True  # accepted and ignored: nothing
    #                                 escalates in this slice

    def __post_init__(self):
        if self.speculate_k < 0:
            raise ValueError("speculate_k must be >= 1 (or 0 = off)")
        if self.speculate_k:
            raise NotImplementedError(
                f"speculative decoding (speculate_k > 0) comes with {_LATER}")


@dataclasses.dataclass
class _Slot:
    request: Request
    admit_seq: int
    phase: str = "prefill"         # 'prefill' -> 'decode'
    prefill_pos: int = 0
    # Tokens this slot prefills: the prompt, plus — after a preemption —
    # the tokens already generated (PFP K/V rows are deterministic per
    # (token, position), so re-prefilling prompt+generated reproduces the
    # evicted pages bit-for-bit and decode continues where it left off).
    prefill_tokens: Optional[np.ndarray] = None
    # First position this slot may WRITE: 0 for a cold slot; the matched
    # prefix length when admission mapped shared pages (rows below it are
    # already cached — the paged insert redirects re-fed writes there to
    # the trash page, and prefill starts here).
    write_start: int = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def noise_seed(seed: int, uid: int, tok_idx: int) -> int:
    """The generator seed of request ``uid``'s token ``tok_idx``: a fixed
    mix of the three, so a request's Eq. 11 draws do not depend on when
    its tokens decode (the reference keys them by
    ``fold_in(fold_in(key(seed), uid), tok_idx)``)."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (uid & 0x7FFFFFFF))
    h = _splitmix64(h ^ (tok_idx & _MASK64))
    return h >> 1                      # a non-negative int64


class Engine:
    def __init__(self, cfg: ModelConfig, model,
                 config: EngineConfig = EngineConfig(), *,
                 router: Optional[UncertaintyRouter] = None,
                 scheduler: Optional[RequestScheduler] = None,
                 pool=None, prefix: Optional[PrefixIndex] = None,
                 tracer=None, lane: str = "engine",
                 device: DeviceLike = None):
        """``model`` is the port's ``lm.LM`` (converted to PFP) on
        ``device`` (None: the CUDA card; this raises without one).
        ``router`` defaults to the reference's thresholds with
        ``escalate_samples=0``. ``pool``/``prefix`` inject SHARED decode
        state (disaggregated serving: a prefill engine and a decode engine
        over one page pool and one prefix index); the injecting owner
        wires the pool's remap listener, so one defrag remaps the shared
        index exactly once."""
        if not cfg.embed_inputs:
            raise ValueError("engine serves token-prompt models only")
        self.cfg = cfg
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.router = router if router is not None else UncertaintyRouter(
            cfg, RouterConfig(escalate_samples=0),
            formulation=config.formulation, impl=config.impl)
        self.scheduler = scheduler if scheduler is not None else \
            RequestScheduler(SchedulerConfig(), max_len=config.max_len)
        if self.scheduler.max_len is None:
            self.scheduler.max_len = config.max_len
        if self.scheduler.config.prefill_chunk > config.max_len:
            raise ValueError("prefill_chunk must not exceed max_len")
        # Every prefill chunk runs at ONE shape: a fixed-size window sliding
        # to the chunk's end, re-feeding earlier tokens — exact, since PFP
        # k/v rows are deterministic per (token, position). Recurrent/SSM
        # carries would see re-fed tokens twice and have no positional
        # validity mask for the paged pool; the port has no such family.
        if not all(k in ("attn", "moe", "cross") for k in cfg.pattern):
            raise ValueError(
                "the engine serves attention-family models only "
                f"(recurrent/SSM carries are not ported): {cfg.name}")
        self.paged = config.page_size is not None
        if pool is not None:
            if self.paged != isinstance(pool, PagedDecodeStatePool):
                raise ValueError("injected pool layout does not match "
                                 "config.page_size")
            if pool.num_slots != config.slots or \
                    pool.max_len != config.max_len or \
                    (self.paged and pool.page_size != config.page_size):
                raise ValueError("injected pool geometry does not match "
                                 "the engine config")
            if pool.device != self.device:
                raise ValueError(f"injected pool lives on {pool.device}, "
                                 f"the engine on {self.device}")
            self.pool = pool
        elif self.paged:
            self.pool = PagedDecodeStatePool(
                cfg, config.slots, config.max_len, config.page_size,
                num_pages=config.page_budget, device=self.device)
        else:
            self.pool = DecodeStatePool(cfg, config.slots, config.max_len,
                                        device=self.device)
        self.prefix: Optional[PrefixIndex] = None
        if config.prefix_sharing:
            if not self.paged:
                raise ValueError("prefix_sharing requires the paged "
                                 "Gaussian KV-cache (set page_size)")
            if prefix is not None:
                self.prefix = prefix
            else:
                retention = (config.prefix_retention_pages
                             if config.prefix_retention_pages is not None
                             else self.pool.total_pages)
                self.prefix = PrefixIndex(config.page_size, retention)
                # defrag moves a shared page once; the index's page ids
                # must follow the rewritten tables
                self.pool.add_remap_listener(self.prefix.remap_pages)
        elif prefix is not None:
            raise ValueError("injected prefix index requires "
                             "config.prefix_sharing")
        # (uid, pages, matched) of _page_need's latest index walk, reused
        # by the admission it gated
        self._prefix_match = None
        self.metrics = EngineMetrics()
        self._ood_mi = (self.router.config.ood_mi
                        if self.router.config.ood_mi is not None
                        else self.router.config.mi_abstain)
        self.metrics.uncertainty.set_ood_threshold(self._ood_mi)
        # ``tracer``: a shared Tracer (bound to ``lane``) or a LaneTracer;
        # None = tracing off (every emit site is guarded).
        self._tracer = (tracer.bind(lane) if isinstance(tracer, Tracer)
                        else tracer)
        self.finished: List[Request] = []
        self._slots: List[Optional[_Slot]] = [None] * config.slots
        self._admit_seq = 0
        self._step_idx = 0
        v = cfg.vocab_size
        self._lm_mean = torch.zeros((config.slots, v), dtype=torch.float32,
                                    device=self.device)
        self._lm_var = torch.zeros_like(self._lm_mean)
        # Eq. 11 noise: one generator on the logits' device, reseeded per
        # (request, token) with noise_seed.
        self._gen = torch.Generator(device=self.device)
        # Test hook: fn(uid, tok_idx) -> (num_uncertainty_samples, V)
        # noise that replaces the draw (the tests hand in the reference's
        # own fold_in-keyed normals).
        self._noise_override: Optional[Callable[[int, int], object]] = None

    # -- device passes -------------------------------------------------------
    def _ctx(self) -> Context:
        return Context(mode=Mode.PFP, formulation=self.config.formulation,
                       impl=self.config.impl, device=self.device)

    @staticmethod
    def _split_logits(logits):
        if is_gaussian(logits):
            return logits.mean, logits.var
        return logits, torch.zeros_like(logits)

    def _chunk_step(self, inputs, sub, out_idx: int):
        """One prefill chunk on a single-slot state view: (1, C) tokens in,
        logit (mean, var) at the last *real* token (``out_idx``) + updated
        substate out."""
        logits, new_sub = lm.decode_step(self.model, self.cfg, inputs, sub,
                                         self._ctx())
        mean, var = self._split_logits(logits)
        return (mean[:, out_idx].float(), var[:, out_idx].float()), new_sub

    def _decode_step(self, tokens, positions, cache_len, active, states,
                     lm_mean, lm_var):
        """Lockstep decode for the whole slot batch + select-merge so only
        ``active`` slots observe the state/logit update. The 4th output is
        the MoE aux dict (drop accounting; zeros on dense families)."""
        inputs = {"tokens": tokens, "positions": positions,
                  "cache_len": cache_len}
        logits, aux, new_states = lm.decode_step_with_aux(
            self.model, self.cfg, inputs, states, self._ctx())
        mean, var = self._split_logits(logits)
        keep = active[:, None]
        merged = lm.select_decode_slots(new_states, states, active)
        return (torch.where(keep, mean[:, -1].float(), lm_mean),
                torch.where(keep, var[:, -1].float(), lm_var), merged, aux)

    def _decode_step_paged(self, tokens, positions, cache_len, active,
                           states, page_table, lm_mean, lm_var):
        """Lockstep decode over the shared page pool. No select-merge: an
        inactive slot's cache_len sits at its position, so the paged
        insert redirects its write to the trash page."""
        inputs = {"tokens": tokens, "positions": positions,
                  "cache_len": cache_len, "page_table": page_table}
        logits, aux, new_states = lm.decode_step_with_aux(
            self.model, self.cfg, inputs, states, self._ctx())
        mean, var = self._split_logits(logits)
        keep = active[:, None]
        return (torch.where(keep, mean[:, -1].float(), lm_mean),
                torch.where(keep, var[:, -1].float(), lm_var), new_states,
                aux)

    def _batch_chunk_step(self, inputs, states, out_idx, done, lm_mean,
                          lm_var):
        """One batched multi-slot prefill round over the page pool:
        (B, C) window tokens in, per-slot logit (mean, var) rows gathered
        at each slot's own last-real-token index, merged into the logit
        buffers only where ``done`` (prefill completed this round)."""
        logits, new_states = lm.decode_step(self.model, self.cfg, inputs,
                                            states, self._ctx())
        mean, var = self._split_logits(logits)
        rows = torch.arange(mean.shape[0], device=mean.device)
        keep = done[:, None]
        return (torch.where(keep, mean[rows, out_idx].float(), lm_mean),
                torch.where(keep, var[rows, out_idx].float(), lm_var),
                new_states)

    def _as_tensor(self, array, dtype=torch.long):
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            device=self.device, dtype=dtype)

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        ok = self.scheduler.submit(req, float(self._step_idx))
        self.metrics.on_submit(ok)
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "submit", uid=req.uid,
                              accepted=ok, prompt_len=len(req.prompt),
                              max_new=req.max_new_tokens)
        return ok

    def reset_metrics(self) -> None:
        """Fresh telemetry (e.g. after a warm-up run, so throughput rows
        measure the hot path instead of first-call work). Pool state is
        kept."""
        self.metrics = EngineMetrics()
        self.metrics.uncertainty.set_ood_threshold(self._ood_mi)

    @property
    def now(self) -> int:
        return self._step_idx

    @property
    def decode_fn(self):
        """The lockstep decode pass (public: benchmarks time it)."""
        return self._decode_step_paged if self.paged else self._decode_step

    @property
    def logit_buffers(self):
        """Current per-slot next-token logit (mean, var) device buffers."""
        return self._lm_mean, self._lm_var

    @property
    def active_slots(self) -> int:
        """Slots THIS engine owns (a shared pool's ``live`` also counts a
        peer's slots; this never does)."""
        return sum(sl is not None for sl in self._slots)

    @property
    def prefilling(self) -> int:
        return sum(sl is not None and sl.phase == "prefill"
                   for sl in self._slots)

    @property
    def decoding(self) -> int:
        return sum(sl is not None and sl.phase == "decode"
                   for sl in self._slots)

    @property
    def idle(self) -> bool:
        return len(self.scheduler) == 0 and self.active_slots == 0

    @property
    def load(self) -> int:
        """Queued + occupying work, a fleet router's fallback metric."""
        return len(self.scheduler) + self.active_slots

    def prefix_peek(self, tokens) -> int:
        """Cached-prefix length: how many leading tokens of ``tokens`` this
        engine's prefix index holds pages for (0 without an index).
        Read-only — never bumps the LRU clock. The limit mirrors
        admission's: the last token is always prefilled."""
        if self.prefix is None or len(tokens) == 0:
            return 0
        return self.prefix.peek(tokens, limit=len(tokens) - 1)

    def run_until_idle(self, max_steps: int = 100_000) -> dict:
        while not self.idle:
            if self._step_idx >= max_steps:
                raise RuntimeError(f"engine not idle after {max_steps} steps")
            self.step()
        return self.metrics.summary()

    # -- the engine step ----------------------------------------------------
    def step(self) -> None:
        now = float(self._step_idx)
        # drain deadline-expired waiters even while the pool is full, so
        # they never hold the bounded admission queue against live traffic
        for e in self.scheduler.drain_expired(now):
            self.metrics.on_expire()
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "expire", uid=e.uid)
            self.finished.append(e)
        self._admit(now)
        self._prefill()
        self._route_and_decode(now)
        self._step_idx += 1
        if self.paged:
            pages = self.pool.page_gauges()
            if self.prefix is not None:
                pages += (self.pool.shared_pages, self.prefix.pages_held)
            self.metrics.on_step(self.pool.live, pages=pages)
            if self.config.auto_defrag and self.pool.page_fragmentation():
                self.defrag()
        else:
            self.metrics.on_step(self.pool.live)
            if self.config.auto_compact and self.pool.fragmentation():
                self.compact()

    def _request_tokens(self, req: Request) -> np.ndarray:
        tokens = np.asarray(req.prompt, np.int32)
        if req.generated:  # re-admission after a preemption
            tokens = np.concatenate(
                [tokens, np.asarray(req.generated, np.int32)])
        return tokens

    def _page_need(self, req: Request) -> int:
        """Pages an admission would actually take from the free list: the
        plain :func:`pages_for` budget minus the FULLY-shared prefix pages
        the index would map at refcount+1. A partially-matched boundary
        page still costs one page — its copy-on-write duplicate. The match
        is cached per uid so the admission that follows reuses it."""
        total = pages_for(req, self.pool.page_size,
                          reserve=self.config.reserve_pages)
        tokens = self._request_tokens(req)
        pages, matched = self.prefix.match(tokens, limit=len(tokens) - 1)
        self._prefix_match = (req.uid, pages, matched)
        return total - matched // self.pool.page_size

    def _admit(self, now: float) -> None:
        while self.pool.free_slots:
            if self.paged:
                req, expired = self.scheduler.pop_ready(
                    now, free_pages=self.pool.free_pages,
                    page_size=self.pool.page_size,
                    reserve_pages=self.config.reserve_pages,
                    page_need=(self._page_need if self.prefix is not None
                               else None))
            else:
                req, expired = self.scheduler.pop_ready(now)
            for e in expired:
                self.metrics.on_expire()
                if self._tracer is not None:
                    self._tracer.emit(self._step_idx, "expire", uid=e.uid)
                self.finished.append(e)
            if req is None:
                # The head may be blocked only by pages the prefix index
                # holds for FINISHED lineages — reclaim LRU leaves
                # (skipping pages live slots still share) and retry.
                if (self.paged and self.prefix is not None
                        and len(self.scheduler)
                        and self.prefix.reclaim(self.pool, 1)):
                    continue
                break
            slot = self.pool.alloc(req.uid)
            tokens = self._request_tokens(req)
            sl = _Slot(request=req, admit_seq=self._admit_seq,
                       prefill_tokens=tokens)
            self._slots[slot] = sl
            if self.prefix is not None:
                # Map the cached prefix into this slot's table and prefill
                # only the non-shared suffix (paged attention reads through
                # the table, so the logits are bit-for-bit a cold
                # prefill's); the limit keeps >= 1 token to prefill.
                if self._prefix_match is not None and \
                        self._prefix_match[0] == req.uid:
                    _, pages, matched = self._prefix_match
                else:
                    pages, matched = self.prefix.match(
                        tokens, limit=len(tokens) - 1)
                self._prefix_match = None
                self.pool.share(slot, pages)
                self.pool.positions[slot] = matched
                sl.prefill_pos = matched
                sl.write_start = matched
                self.metrics.on_prefix(matched, len(pages))
            if self._tracer is not None:
                extra = ({"shared_pages": len(pages),
                          "matched_tokens": matched}
                         if self.prefix is not None else {})
                self._tracer.emit(self._step_idx, "admit", uid=req.uid,
                                  slot=slot, **extra)
            if self.paged and self.config.reserve_pages:
                # pop_ready admitted against the free-page count (prefix
                # pages discounted), so reserving the full prompt +
                # generation need — including the eager copy-on-write of a
                # partially-shared boundary page — cannot fail.
                ok = self._ensure_pages(
                    slot, len(req.prompt) + req.max_new_tokens)
                assert ok, "page reservation failed after admission check"
            self._admit_seq += 1
            self.metrics.on_admit(req.uid, req.arrival, now)

    def _prefill_pending(self):
        pending = sorted(
            ((sl.admit_seq, slot) for slot, sl in enumerate(self._slots)
             if sl is not None and sl.phase == "prefill"))
        return [(slot, len(self._slots[slot].prefill_tokens)
                 - self._slots[slot].prefill_pos) for _, slot in pending]

    def _prefill(self) -> None:
        if self.paged:
            self._prefill_paged()
            return
        plan = self.scheduler.plan_prefill(self._prefill_pending())
        for slot, n in plan:
            sl = self._slots[slot]
            end = sl.prefill_pos + n
            prompt = sl.prefill_tokens
            # fixed-size window ending at `end`: one shape. Re-fed rows
            # rewrite identical k/v; right-pad rows (only while end < chunk)
            # sit beyond cache_len, so they stay masked until the decode
            # loop overwrites them in the same step their position becomes
            # valid.
            c = self.scheduler.config.prefill_chunk
            lo = max(0, end - c)
            window = prompt[lo:end]
            tokens = np.zeros(c, np.int32)
            tokens[:len(window)] = window
            positions = lo + np.arange(c, dtype=np.int32)
            out_idx = len(window) - 1
            inputs = {"tokens": tokens[None], "positions": positions[None],
                      "cache_len": np.asarray([end], np.int32)}
            sub = self.pool.take_slot(slot)
            (mean, var), new_sub = self._chunk_step(inputs, sub, out_idx)
            self.pool.write_slot(slot, new_sub)
            sl.prefill_pos += n
            self.pool.positions[slot] = sl.prefill_pos
            self.metrics.on_prefill(n)
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "prefill_round",
                                  uid=sl.request.uid, slot=slot, tokens=n,
                                  pos=sl.prefill_pos)
            if sl.prefill_pos == len(prompt):
                if sl.request.prefill_only:
                    # disaggregation: the pages are the product — finish
                    # without ever entering the decode phase
                    self._finish(slot, "prefill", float(self._step_idx))
                    continue
                sl.phase = "decode"
                row = self._as_tensor([slot])
                self._lm_mean = self._lm_mean.index_copy(0, row, mean)
                self._lm_var = self._lm_var.index_copy(0, row, var)

    def _prefill_paged(self) -> None:
        """Batched multi-slot prefill over the shared page pool: every
        round of the scheduler's plan (at most one chunk per slot) runs as
        ONE lockstep pass at the full slot-batch width — one shape however
        many slots are prefilling. Unplanned rows carry cache_len 0, so
        their writes land on the trash page and their outputs are
        discarded."""
        b = self.config.slots
        c = self.scheduler.config.prefill_chunk
        for rnd in self.scheduler.plan_prefill_rounds(self._prefill_pending()):
            tokens = np.zeros((b, c), np.int32)
            positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
            cache_len = np.zeros(b, np.int32)
            write_start = np.zeros(b, np.int32)
            out_idx = np.zeros(b, np.int64)
            done = np.zeros(b, bool)
            planned = []
            for slot, n in rnd:
                sl = self._slots[slot]
                if sl is None or sl.phase != "prefill":
                    continue  # preempted as a page victim in this step
                end = sl.prefill_pos + n
                if not self._ensure_pages(slot, end) and \
                        not self._make_room(slot, end):
                    # pool exhausted and nothing to preempt: bounce this
                    # request back to the queue (it keeps its progress)
                    self._preempt(slot)
                    continue
                lo = max(0, end - c)
                window = sl.prefill_tokens[lo:end]
                tokens[slot, :len(window)] = window
                positions[slot] = lo + np.arange(c, dtype=np.int32)
                cache_len[slot] = end
                # The window may re-feed tokens below the shared-prefix
                # boundary — their writes go to the trash page (the shared
                # pages already hold the identical rows).
                write_start[slot] = sl.write_start
                out_idx[slot] = len(window) - 1
                done[slot] = end == len(sl.prefill_tokens)
                planned.append((slot, n, end))
            # A planned slot may have been preempted by a LATER slot's
            # _make_room in the same round: drop it (its table row is
            # already zeroed, so even its staged write would only reach
            # the trash page) and keep its logit rows untouched.
            for slot, _, _ in planned:
                if self._slots[slot] is None:
                    cache_len[slot] = 0
                    done[slot] = False
            planned = [p for p in planned if self._slots[p[0]] is not None]
            if not planned:
                continue
            inputs = {"tokens": tokens, "positions": positions,
                      "cache_len": cache_len, "write_start": write_start,
                      "page_table": self.pool.device_table()}
            self._lm_mean, self._lm_var, self.pool.states = \
                self._batch_chunk_step(inputs, self.pool.states,
                                       self._as_tensor(out_idx),
                                       self._as_tensor(done, torch.bool),
                                       self._lm_mean, self._lm_var)
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "prefill_round",
                                  slots=len(planned),
                                  tokens=sum(n for _, n, _ in planned))
            for slot, n, end in planned:
                sl = self._slots[slot]
                sl.prefill_pos = end
                self.pool.positions[slot] = end
                self.metrics.on_prefill(n)
                if done[slot]:
                    if sl.request.prefill_only:
                        self._finish(slot, "prefill", float(self._step_idx))
                        continue
                    sl.phase = "decode"

    def _noise(self, uid: int, tok_idx: int) -> torch.Tensor:
        """(num_uncertainty_samples, V) Eq. 11 noise of request ``uid``'s
        token ``tok_idx``, drawn on the logits' device."""
        if self._noise_override is not None:
            eps = np.array(self._noise_override(uid, tok_idx), np.float32)
            return torch.as_tensor(eps.reshape(
                self.config.num_uncertainty_samples, self.cfg.vocab_size),
                device=self.device)
        self._gen.manual_seed(noise_seed(self.config.seed, uid, tok_idx))
        return torch.randn((self.config.num_uncertainty_samples,
                            self.cfg.vocab_size), generator=self._gen,
                           dtype=torch.float32, device=self.device)

    def _route_current(self, decode_slots):
        """Route every listed slot's CURRENT logits: one uncertainty pass
        over the slot batch with each row's noise keyed by (request,
        token index), one host read of the tokens and MI. Returns {slot:
        (token, mi, decision)}."""
        n, v = self.config.num_uncertainty_samples, self.cfg.vocab_size
        zero = torch.zeros((n, v), dtype=torch.float32, device=self.device)
        rows = {slot: self._noise(self._slots[slot].request.uid,
                                  len(self._slots[slot].request.generated))
                for slot in decode_slots}
        eps = torch.stack([rows.get(s, zero)
                           for s in range(self.config.slots)], dim=1)
        out = uncertainty_decode(
            self._lm_mean[:, None], self._lm_var[:, None], eps=eps,
            num_uncertainty_samples=n,
            mi_threshold=self.router.config.mi_abstain, greedy=True)
        tokens = out.token
        if not self.config.greedy:
            # A sampled token per row from the row's own generator state
            # after its noise draw, so it too is keyed per (request,
            # token).
            tokens = tokens.clone()
            for slot in decode_slots:
                req = self._slots[slot].request
                self._gen.manual_seed(noise_seed(self.config.seed, req.uid,
                                                 len(req.generated)))
                row = uncertainty_decode(
                    self._lm_mean[slot:slot + 1, None],
                    self._lm_var[slot:slot + 1, None], self._gen,
                    num_uncertainty_samples=n, greedy=False)
                tokens[slot] = row.token[0]
        host = torch.stack((tokens.double(),
                            out.mutual_info.double())).cpu().numpy()
        resolved = {}
        for slot in decode_slots:
            tok, mi = int(host[0, slot]), float(host[1, slot])
            decision = self.router.route(mi)
            self.metrics.on_decision(mi, decision.value)
            if decision is Decision.ESCALATE:
                raise NotImplementedError(
                    f"SVI escalation comes with {_LATER}")
            resolved[slot] = (tok, mi, decision)
        return resolved

    def _route_and_decode(self, now: float) -> None:
        decode_slots = [slot for slot, sl in enumerate(self._slots)
                        if sl is not None and sl.phase == "decode"]
        if not decode_slots:
            return
        resolved = self._route_current(decode_slots)

        feed = np.zeros(self.config.slots, np.int32)
        active = np.zeros(self.config.slots, bool)
        for slot in decode_slots:
            req = self._slots[slot].request
            tok, mi, decision = resolved[slot]
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "route", uid=req.uid,
                                  token=tok, mi=mi,
                                  decision=decision.value,
                                  tok_idx=len(req.generated))
            if decision is Decision.ABSTAIN:
                req.mi_trace.append(mi)
                req.abstained = True
                self._finish(slot, "abstain", now)
                continue
            req.generated.append(tok)
            req.mi_trace.append(mi)
            self.metrics.on_token()
            if self.config.eos_id is not None and tok == self.config.eos_id:
                self._finish(slot, "eos", now)
            elif len(req.generated) >= req.max_new_tokens:
                self._finish(slot, "length", now)
            else:
                feed[slot] = tok
                active[slot] = True

        if not active.any():
            return
        if self.paged:
            # Each active slot writes one KV row at its position this
            # step: make sure the covering page exists. Under optimistic
            # admission the pool can run dry — preempt the youngest slot
            # until it fits, or bounce the requester itself.
            for slot in np.flatnonzero(active):
                if self._slots[slot] is None:
                    continue  # preempted as a victim earlier in this loop
                pos = int(self.pool.positions[slot])
                if not self._ensure_pages(slot, pos + 1) and \
                        not self._make_room(slot, pos + 1):
                    self._preempt(slot)
            active &= np.asarray([sl is not None for sl in self._slots])
            if not active.any():
                return
        positions = self.pool.positions.copy()
        args = (feed[:, None], positions[:, None], positions + active,
                self._as_tensor(active, torch.bool), self.pool.states)
        if self.paged:
            self._lm_mean, self._lm_var, self.pool.states, aux = \
                self._decode_step_paged(*args, self.pool.device_table(),
                                        self._lm_mean, self._lm_var)
        else:
            self._lm_mean, self._lm_var, self.pool.states, aux = \
                self._decode_step(*args, self._lm_mean, self._lm_var)
        self.metrics.on_decode_pass()
        if self.cfg.family == "moe":
            dropped, offered = torch.stack(
                (aux["moe_dropped"], aux["moe_assignments"])).tolist()
            self.metrics.on_moe_drop(dropped, offered)
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "decode_step",
                              active=int(active.sum()))
        self.pool.positions[active] += 1

    def _finish(self, slot: int, reason: str, now: float) -> None:
        sl = self._slots[slot]
        sl.request.finish(reason)
        if self.prefix is not None:
            # Register the finished lineage: the index takes refcount
            # holds on the pages covering the rows actually written
            # (prompt + generated, minus the final token, which was never
            # fed). Retention is enforced inside insert.
            valid = int(self.pool.positions[slot])
            tokens = self._request_tokens(sl.request)[:valid]
            self.prefix.insert(tokens, self.pool.slot_pages[slot], self.pool)
        self.pool.evict(slot)
        self._slots[slot] = None
        self.finished.append(sl.request)
        self.metrics.on_finish(sl.request, now)
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "finish", uid=sl.request.uid,
                              reason=reason,
                              tokens=len(sl.request.generated))

    # -- paged page-pressure handling ---------------------------------------
    def _ensure_pages(self, slot: int, upto_len: int) -> bool:
        """Cover positions [0, upto_len) with pages the slot may WRITE:
        capacity (allocate missing pages) plus, under prefix sharing,
        copy-on-write of any still-shared page at or past the slot's
        write_start. False = the free list cannot supply the pages."""
        if not self.pool.ensure_capacity(slot, upto_len):
            return False
        if self.prefix is None:
            return True
        sl = self._slots[slot]
        before = self.pool.cow_copies
        if not self.pool.ensure_writable(slot, sl.write_start, upto_len):
            return False
        copied = self.pool.cow_copies - before
        self.metrics.on_cow(copied)
        if copied and self._tracer is not None:
            self._tracer.emit(self._step_idx, "cow", uid=sl.request.uid,
                              pages=copied)
        return True

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` mid-flight and requeue its request (with its
        generated tokens — re-prefilling prompt+generated reproduces the
        freed pages bit-for-bit, so decode resumes where it stopped).
        Pages other slots share (or the index holds) survive the evict."""
        sl = self._slots[slot]
        self.pool.evict(slot)
        self._slots[slot] = None
        self.metrics.on_preemption()
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "preempt", uid=sl.request.uid,
                              generated=len(sl.request.generated))
        displaced = self.scheduler.requeue(sl.request, float(self._step_idx))
        if displaced is not None:
            # the requeue displaced the newest un-started waiter to keep
            # the queue depth bounded; account it like a rejection
            self.metrics.on_requeue_overflow()
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "requeue_overflow",
                                  uid=displaced.uid)
            self.finished.append(displaced)

    def _make_room(self, for_slot: int, upto_len: int) -> bool:
        """Free pages for ``for_slot``: first reclaim prefix-index holds
        on finished lineages, then preempt JUNIOR live slots (admitted
        after it), youngest first, until the capacity fits. When
        ``for_slot`` is itself the youngest there is nobody it may evict:
        return False and let the caller bounce the requester."""
        my_seq = self._slots[for_slot].admit_seq
        while not self._ensure_pages(for_slot, upto_len):
            if self.prefix is not None and self.prefix.reclaim(self.pool, 1):
                continue
            victims = [s for s, sl in enumerate(self._slots)
                       if sl is not None and sl.admit_seq > my_seq]
            if not victims:
                return False
            self._preempt(max(victims,
                              key=lambda s: self._slots[s].admit_seq))
        return True

    def defrag(self) -> None:
        """Pack live pages to the pool front (the prefix index follows
        through the pool's remap listener)."""
        if not self.paged:
            raise ValueError("defrag() applies to the paged engine; the "
                             "contiguous engine compacts slots instead")
        if self.pool.defrag() is None:
            return
        self.metrics.on_defrag()
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "defrag")

    def compact(self) -> None:
        """Pack live slots to the front; remap host-side slot records and
        the per-slot logit rows to match."""
        if self.paged:
            raise ValueError("the paged engine has no slot compaction "
                             "(slots are just batch rows); use defrag()")
        remap = self.pool.compact()
        if not remap:
            return
        new_slots: List[Optional[_Slot]] = [None] * self.config.slots
        perm = np.arange(self.config.slots)
        for old, new in remap.items():
            new_slots[new] = self._slots[old]
            perm[new] = old
        self._slots = new_slots
        index = self._as_tensor(perm)
        self._lm_mean = self._lm_mean[index]
        self._lm_var = self._lm_var[index]
