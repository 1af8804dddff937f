"""The continuous-batching serving engine for PFP-BNN language models.

Counterpart of ``repro/serving/engine/engine.py``. One ``Engine`` owns a
fixed decode batch of ``slots`` sequences over one model:

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
            whole batch: logit means + variances), or on paged engines
            with ``speculate_k`` K: K-1 mean-only draft steps and ONE
            chunked PFP pass verifying the K-token block
         -> uncertainty router (continue / escalate to an N-sample SVI
            second opinion / abstain; paged engines resolve every slot a
            step escalates in one call)
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
engine (prefill windows and escalation replays of ``prefill_chunk`` rows,
decode at slot width, verify at slot width x K), so the bits of a row
depend only on its own tokens and keys on the card (the dense and norm
kernels' rows do not depend on M, the cache kernels' rows not on Tq, B or
the page layout): a request's tokens and MI are the same on both pools,
with and without prefix sharing, preemption or speculation, and batched
second opinions are the sequential ones. Models with recurrent or SSM
carries (recurrentgemma, mamba2) feed each prompt token once, in
exact-length chunks, and serve on the contiguous pool only: the paged
pool, prefix sharing and speculation refuse them, as in the reference.
An SVI second opinion runs the plain torch ops, whose attention reads the
gathered pages on one pool and the cache on the other, so across the two
pools it need only agree at tolerance.

With ``mesh=`` (a live ``DeviceMesh`` of axes ``('data', 'model')``) every
rank runs the same engine: the model is placed by the serving rules
(``params_shardings(serve=True)``), the pools' states by the decode-state
rules and each pass's inputs by ``batch_shardings``; the kernel impl runs
on each rank's blocks through ``core/mesh_route.py``. The logits come back
whole on every rank (``full_tensor``) before anything reads them, and the
Eq. 11 and SVI noise is drawn whole from the seeded generators, so every
host decision (tokens, MI, routing, finishing, admission, preemption,
defrag) is taken on the same values on every rank and every rank's
scheduler takes the same path. On one rank the meshed engine serves the
unmeshed engine's tokens and MI bit for bit. The dense family serves on a
mesh; the MoE, hybrid, SSM and VLM families raise, naming the ROADMAP.md
item that brings them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh_route
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import is_gaussian
from repro_torch.core.modes import Mode
from repro_torch.launch.mesh import live_mesh
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

_MASK64 = (1 << 64) - 1

# Block kinds that do not serve on a mesh yet, and the ROADMAP.md item
# that brings them.
MESH_WAITS = {"moe": "expert parallelism",
              "rec": "the einsum route and the SSD per rank",
              "ssm": "the einsum route and the SSD per rank",
              "cross": "the VLM's cross-attention on a mesh"}


def _host(t):
    """A device result on the host, read whole on every rank."""
    return mesh_route.full(t).cpu().numpy()


def placed_model(model, mesh):
    """``model`` to serve on ``mesh``: as it is off a mesh or where its
    parameters are DTensors already, else a copy placed by the serving
    rules (``params_shardings(serve=True)``). The caller's model is left
    as it is. A ``MeshSpec`` raises ``TypeError`` (``live_mesh``)."""
    mesh = live_mesh(mesh)
    if mesh is None or any(mesh_route.has_dtensor((p,))
                           for p in model.parameters()):
        return model
    from repro_torch.launch import sharding

    return sharding.placed_copy(model, mesh, serve=True)


def check_mesh_family(cfg: ModelConfig) -> None:
    """Raise where ``cfg``'s family does not serve on a mesh yet."""
    waits = sorted({MESH_WAITS[k] for k in cfg.pattern if k in MESH_WAITS})
    if waits:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) does not serve on a mesh yet: it "
            f"waits for {' and '.join(waits)} (ROADMAP.md)")


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
    # -- uncertainty-speculative decoding (paged engines only) --------------
    speculate_k: int = 0           # 0 = off. K >= 1: each decode round
    #                                drafts K-1 tokens with a mean-only
    #                                (zero-variance) pass, then verifies the
    #                                K-token block (served-but-unfed head +
    #                                drafts) with ONE chunked PFP pass and
    #                                serves the verified tokens greedily
    #                                while routing says CONTINUE
    batch_escalations: bool = True  # paged: resolve every slot the router
    #                                escalates in a step with ONE call that
    #                                runs each slot's N-sample SVI replay
    #                                (bit for bit the sequential second
    #                                opinion); contiguous engines always go
    #                                sequential

    def __post_init__(self):
        if self.speculate_k < 0:
            raise ValueError("speculate_k must be >= 1 (or 0 = off)")


@dataclasses.dataclass
class _Slot:
    request: Request
    admit_seq: int
    phase: str = "prefill"         # 'prefill' -> 'decode'
    prefill_pos: int = 0
    last_input: Optional[int] = None  # token fed at the step behind the
    #                                   current logits (SVI replay input)
    # Escalation replay while the current logits come from a prefill
    # chunk: (pre-chunk state, chunk inputs, out_idx). None once a decode
    # step ran — the engine then replays the trailing fed-token window
    # against the pre-decode pool snapshot instead.
    replay: Optional[tuple] = None
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
    # Speculative decode: the one token already SERVED (appended to
    # generated, MI recorded) but not yet fed — the head of the next
    # draft+verify block. None when the slot's current logits are fresh
    # (the next step routes them in phase 0 instead).
    pending: Optional[int] = None


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
                 mesh=None, tracer=None, lane: str = "engine",
                 device: DeviceLike = None):
        """``model`` is the port's ``lm.LM`` (converted to PFP) on
        ``device`` (None: the CUDA card; this raises without one).
        ``mesh``: a live ``DeviceMesh`` to serve on; a model whose
        parameters are not DTensors yet is served from a copy placed on it
        by the serving rules (:func:`placed_model`), the caller's model
        left as it is. ``device`` is then this rank's device.
        ``router`` defaults to the reference's ``RouterConfig()``.
        ``pool``/``prefix`` inject SHARED decode
        state (disaggregated serving: a prefill engine and a decode engine
        over one page pool and one prefix index); the injecting owner
        wires the pool's remap listener, so one defrag remaps the shared
        index exactly once."""
        if not cfg.embed_inputs:
            raise ValueError("engine serves token-prompt models only")
        self.cfg = cfg
        self.mesh = live_mesh(mesh)
        if self.mesh is not None:
            check_mesh_family(cfg)
        self.model = placed_model(model, self.mesh)
        self.config = config
        self.device = resolve_device(device)
        self.router = router if router is not None else UncertaintyRouter(
            cfg, RouterConfig(), formulation=config.formulation,
            impl=config.impl)
        self.scheduler = scheduler if scheduler is not None else \
            RequestScheduler(SchedulerConfig(), max_len=config.max_len)
        if self.scheduler.max_len is None:
            self.scheduler.max_len = config.max_len
        if self.scheduler.config.prefill_chunk > config.max_len:
            raise ValueError("prefill_chunk must not exceed max_len")
        # Attention-family models run every prefill chunk at ONE shape: a
        # fixed-size window sliding to the chunk's end, re-feeding earlier
        # tokens — exact, since PFP k/v rows are deterministic per (token,
        # position). Models with recurrent/SSM carries must see each token
        # exactly once, so they take exact-length chunks; their carries
        # have no positional validity mask, so they keep the contiguous
        # pool.
        self._static_chunks = all(k in ("attn", "moe", "cross")
                                  for k in cfg.pattern)
        self.paged = config.page_size is not None
        if config.speculate_k and not self.paged:
            raise ValueError(
                "speculative decoding requires the paged Gaussian KV-cache "
                "(set page_size): the chunked verify pass leans on "
                "trash-page write redirection to leave rejected rows "
                "rollback-free")
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
            if pool.mesh is not self.mesh:
                raise ValueError("injected pool is placed on another mesh "
                                 "than the engine's")
            self.pool = pool
        elif self.paged:
            if not self._static_chunks:
                raise ValueError(
                    "paged KV-cache serving supports attention-family "
                    "models only (recurrent/SSM carries have no positional "
                    "validity mask); use the contiguous layout for "
                    f"{cfg.name}")
            self.pool = PagedDecodeStatePool(
                cfg, config.slots, config.max_len, config.page_size,
                num_pages=config.page_budget, mesh=self.mesh,
                device=self.device)
        else:
            self.pool = DecodeStatePool(cfg, config.slots, config.max_len,
                                        mesh=self.mesh, device=self.device)
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
        # Pool states as of just BEFORE the latest lockstep decode step — a
        # reference swap, not a copy (the old tensors stay alive one step).
        # Escalation replays against this snapshot.
        self._prev_states = None
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
        # SVI second-opinion noise: a second generator, reseeded per
        # (request, token) with noise_seed(seed + 1, ...); the N samples
        # draw from it in turn.
        self._gen_esc = torch.Generator(device=self.device)
        # Test hook: fn(uid, tok_idx) -> escalate_samples ``Context.eps``
        # callables, one a sample (the tests hand in the reference's own
        # fold_in-keyed weight noise).
        self._svi_eps_override: Optional[Callable[[int, int], list]] = None
        # Test hook: fn((B, K-1) drafted tokens) -> replacement array.
        # Forcing drafts to always/never match the verified tokens pins the
        # acceptance extremes in the bit-for-bit parity tests.
        self._draft_override = None

    # -- device passes -------------------------------------------------------
    def _ctx(self) -> Context:
        return Context(mode=Mode.PFP, formulation=self.config.formulation,
                       impl=self.config.impl, device=self.device)

    @contextlib.contextmanager
    def _placed(self):
        """The context every pass on a mesh runs in: tensors the model
        makes itself (positions, masks) count as replicas beside the
        DTensors, and partial sums are added in rank order, so a row's
        bits do not depend on its slot (``mesh_route.ordered_sums``)."""
        if self.mesh is None:
            yield
            return
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), mesh_route.ordered_sums():
            yield

    def _inputs(self, inputs: dict) -> dict:
        """A pass's inputs as tensors on the device; on a mesh placed by
        ``batch_shardings`` (slots over ``data`` where they divide)."""
        if self.mesh is None:
            return inputs
        from repro_torch.launch import sharding

        inputs = {k: (v if isinstance(v, torch.Tensor)
                      else self._as_tensor(v)).to(torch.long)
                  for k, v in inputs.items()}
        return sharding.distribute_tree(
            inputs, sharding.batch_shardings(inputs, self.mesh), self.mesh)

    @staticmethod
    def _split_logits(logits):
        """(mean, var) of the logits, whole on every rank."""
        if is_gaussian(logits):
            return mesh_route.full(logits.mean), mesh_route.full(logits.var)
        logits = mesh_route.full(logits)
        return logits, torch.zeros_like(logits)

    def _chunk_step(self, inputs, sub, out_idx: int):
        """One prefill chunk on a single-slot state view: (1, C) tokens in,
        logit (mean, var) at the last *real* token (``out_idx``) + updated
        substate out."""
        logits, new_sub = lm.decode_step(self.model, self.cfg,
                                         self._inputs(inputs), sub,
                                         self._ctx())
        mean, var = self._split_logits(logits)
        return (mean[:, out_idx].float(), var[:, out_idx].float()), new_sub

    def _decode_step(self, tokens, positions, cache_len, active, states,
                     lm_mean, lm_var):
        """Lockstep decode for the whole slot batch + select-merge so only
        ``active`` slots observe the state/logit update. The 4th output is
        the MoE aux dict (drop accounting; zeros on dense families)."""
        inputs = self._inputs({"tokens": tokens, "positions": positions,
                               "cache_len": cache_len})
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
        inputs = self._inputs({"tokens": tokens, "positions": positions,
                               "cache_len": cache_len,
                               "page_table": page_table})
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
        logits, new_states = lm.decode_step(self.model, self.cfg,
                                            self._inputs(inputs), states,
                                            self._ctx())
        mean, var = self._split_logits(logits)
        rows = torch.arange(mean.shape[0], device=mean.device)
        keep = done[:, None]
        return (torch.where(keep, mean[rows, out_idx].float(), lm_mean),
                torch.where(keep, var[rows, out_idx].float(), lm_var),
                new_states)

    def _draft_steps(self, head, positions, states, table):
        """K-1 mean-only (zero-variance) draft decode steps over the shared
        page pool: :func:`lm.draft_decode_step` in a loop, each step
        feeding the previous argmax. Returns the (B, K-1) drafted tokens;
        the steps' state updates (zero-variance k/v rows) are DISCARDED —
        only the verify pass's PFP rows ever reach ``pool.states``. Rows
        not drafting this round run at position 0 over their own (or the
        trash) pages; their proposals are ignored."""
        tok, st, drafts = head, states, []
        for i in range(self.config.speculate_k - 1):
            inputs = {"tokens": tok[:, None],
                      "positions": (positions + i)[:, None],
                      "cache_len": positions + i + 1,
                      "page_table": table}
            logits, st = lm.draft_decode_step(self.model, self.cfg,
                                              self._inputs(inputs), st,
                                              self._ctx())
            tok = torch.argmax(mesh_route.full(logits)[:, -1], dim=-1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def _verify_step(self, inputs, states):
        """ONE chunked PFP pass over each slot's (B, K) speculative block —
        the chunked-prefill machinery pointed at decode: logit means AND
        variances for every block position, plus the pool with all fed
        rows' PFP k/v written (``cache_len`` bounds the writable window;
        pad rows land on the trash page). Rows the acceptance scan rejects
        need no rollback — the engine leaves ``positions`` at the accepted
        prefix, so stale rows stay masked until re-fed."""
        logits, new_states = lm.decode_step(self.model, self.cfg,
                                            self._inputs(inputs), states,
                                            self._ctx())
        mean, var = self._split_logits(logits)
        return mean.float(), var.float(), new_states

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
        fn = self._decode_step_paged if self.paged else self._decode_step
        if self.mesh is None:
            return fn

        def placed(*args):
            with self._placed():
                return fn(*args)
        return placed

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
        with self._placed():
            self._step()

    def _step(self) -> None:
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
            start = sl.prefill_pos
            end = start + n
            prompt = sl.prefill_tokens
            if self._static_chunks:
                # fixed-size window ending at `end`: one shape. Re-fed rows
                # rewrite identical k/v; right-pad rows (only while end <
                # chunk) sit beyond cache_len, so they stay masked until
                # the decode loop overwrites them in the same step their
                # position becomes valid.
                c = self.scheduler.config.prefill_chunk
                lo = max(0, end - c)
                window = prompt[lo:end]
                tokens = np.zeros(c, np.int32)
                tokens[:len(window)] = window
                positions = lo + np.arange(c, dtype=np.int32)
                out_idx = len(window) - 1
            else:
                tokens = prompt[start:end]
                positions = start + np.arange(n, dtype=np.int32)
                out_idx = n - 1
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
                sl.last_input = int(prompt[-1])
                sl.replay = (sub, inputs, out_idx)
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
            pre_states = self.pool.states  # escalation-replay snapshot
            #            (copy-on-write duplicates are already in it: every
            #            _ensure_pages above ran before this reference)
            table = self.pool.device_table()
            inputs = {"tokens": tokens, "positions": positions,
                      "cache_len": cache_len, "write_start": write_start,
                      "page_table": table}
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
                    sl.last_input = int(sl.prefill_tokens[-1])
                    # The replay leaves out write_start: its writes go to a
                    # copy of the pool, so it may rewrite its whole window,
                    # shared prefix rows included. A replay is then a
                    # function of the request's tokens and position alone,
                    # the same with or without prefix sharing, and the
                    # same as a mid-decode window (_replay_window) after a
                    # preemption's re-prefill.
                    row = {"tokens": tokens[slot:slot + 1],
                           "positions": positions[slot:slot + 1],
                           "cache_len": cache_len[slot:slot + 1],
                           "page_table": table[slot:slot + 1]}
                    sl.replay = (pre_states, row, int(out_idx[slot]))

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

    def _svi_noise(self, uid: int, tok_idx: int):
        """The SVI second opinion's noise for request ``uid``'s token
        ``tok_idx``: the escalation generator reseeded by
        ``noise_seed(seed + 1, uid, tok_idx)`` (the samples draw from it in
        turn), or the test hook's ``Context.eps`` callables."""
        if self._svi_eps_override is not None:
            return self._svi_eps_override(uid, tok_idx)
        self._gen_esc.manual_seed(noise_seed(self.config.seed + 1, uid,
                                             tok_idx))
        return self._gen_esc

    def _uncertainty(self, mean, var, keyed):
        """One uncertainty pass over (B, V) logit moments: a (2, B) float64
        tensor of (token, MI) per row on the device, row ``r``'s noise
        keyed by ``keyed[r] = (uid, tok_idx)``; rows not in ``keyed`` get
        zero noise and nobody reads them. The plain step and every column
        of a speculative block call this at the same (B, V) shape."""
        n, v = self.config.num_uncertainty_samples, self.cfg.vocab_size
        zero = torch.zeros((n, v), dtype=torch.float32, device=self.device)
        rows = {slot: self._noise(*key) for slot, key in keyed.items()}
        eps = torch.stack([rows.get(s, zero)
                           for s in range(self.config.slots)], dim=1)
        out = uncertainty_decode(
            mean[:, None], var[:, None], eps=eps,
            num_uncertainty_samples=n,
            mi_threshold=self.router.config.mi_abstain, greedy=True)
        tokens = out.token
        if not self.config.greedy:
            # A sampled token per row from the row's own generator state
            # after its noise draw, so it too is keyed per (request,
            # token).
            tokens = tokens.clone()
            for slot, (uid, tok_idx) in keyed.items():
                self._gen.manual_seed(noise_seed(self.config.seed, uid,
                                                 tok_idx))
                row = uncertainty_decode(
                    mean[slot:slot + 1, None], var[slot:slot + 1, None],
                    self._gen, num_uncertainty_samples=n, greedy=False)
                tokens[slot] = row.token[0]
        return torch.stack((tokens.double(), out.mutual_info.double()))

    def _route_current(self, decode_slots):
        """Route every listed slot's CURRENT logits: one uncertainty pass
        over the slot batch with each row's noise keyed by (request,
        token index), one host read of the tokens and MI, and one SVI
        resolution (batched, when paged) of the slots the router
        escalates. Returns {slot: (token, mi, decision)}."""
        keyed = {slot: (self._slots[slot].request.uid,
                        len(self._slots[slot].request.generated))
                 for slot in decode_slots}
        host = _host(self._uncertainty(self._lm_mean, self._lm_var, keyed))
        return self._resolve_escalations(decode_slots, host[0], host[1])

    def _route_and_decode(self, now: float) -> None:
        if self.config.speculate_k:
            self._route_and_decode_spec(now)
            return
        decode_slots = [slot for slot, sl in enumerate(self._slots)
                        if sl is not None and sl.phase == "decode"]
        if not decode_slots:
            return
        resolved = self._route_current(decode_slots)

        feed = np.zeros(self.config.slots, np.int32)
        active = np.zeros(self.config.slots, bool)
        for slot in decode_slots:
            sl = self._slots[slot]
            req = sl.request
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
                sl.last_input = tok

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
        # The replay snapshot is a reference, not a copy: it stays valid
        # only because every update to the pool's state makes new tensors
        # (the cache inserts, write_slot, reset, copy-on-write, defrag and
        # compaction are all out of place). An in-place write added to any
        # of them would change this snapshot too and corrupt escalation
        # replays without an error.
        self._prev_states = self.pool.states
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
        for slot in np.flatnonzero(active):
            self._slots[slot].replay = None  # replay via _prev_states now

    # -- uncertainty-speculative decoding ------------------------------------
    def _route_and_decode_spec(self, now: float) -> None:
        """The speculative decode round, replacing the one-token lockstep:

        phase 0  slots whose current logits are FRESH (just prefilled or
                 escalate-deferred) route them exactly like the plain
                 engine — serve/abstain/escalate under the same keys — but
                 a served token becomes the slot's ``pending`` head
                 instead of a one-token feed;
        phase 1  every slot holding a pending head drafts K-1 more tokens
                 with the mean-only pass and the whole (head + drafts)
                 block is verified by ONE chunked PFP pass; verified
                 tokens are served greedily while the router says
                 CONTINUE and the next draft matches.

        Every served (token, mi) is keyed per (request uid, token index)
        and reduced by the plain step's function at its shape, so the
        served stream is the plain engine's — speculation only changes
        how many full-PFP passes it takes to produce it."""
        decode_slots = [slot for slot, sl in enumerate(self._slots)
                        if sl is not None and sl.phase == "decode"]
        if not decode_slots:
            return
        route_slots = [s for s in decode_slots
                       if self._slots[s].pending is None]
        if route_slots:
            resolved = self._route_current(route_slots)
            for slot in route_slots:
                sl = self._slots[slot]
                req = sl.request
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
                if self.config.eos_id is not None and \
                        tok == self.config.eos_id:
                    self._finish(slot, "eos", now)
                elif len(req.generated) >= req.max_new_tokens:
                    self._finish(slot, "length", now)
                else:
                    sl.pending = tok
        spec_slots = [s for s in decode_slots
                      if self._slots[s] is not None
                      and self._slots[s].pending is not None]
        if spec_slots:
            self._speculative_round(spec_slots, now)

    def _speculative_round(self, spec_slots, now: float) -> None:
        """Draft K-1 tokens per pending slot, verify the K-token block
        with one chunked PFP pass, accept greedily."""
        k = self.config.speculate_k
        b = self.config.slots
        # Per-slot block width: the pending head plus up to K-1 drafts,
        # clipped so a fully-accepted block lands exactly on the request's
        # generation budget (fed positions then never pass max_len - 1).
        f_of = {}
        for slot in spec_slots:
            sl = self._slots[slot]
            if sl is None:
                continue  # preempted as a page victim below
            req = sl.request
            f = min(k, req.max_new_tokens - len(req.generated))
            pos = int(self.pool.positions[slot])
            if not self._ensure_pages(slot, pos + f) and \
                    not self._make_room(slot, pos + f):
                self._preempt(slot)
                continue
            f_of[slot] = f
        live = [s for s in spec_slots
                if self._slots[s] is not None and s in f_of]
        if not live:
            return

        head = np.zeros(b, np.int64)
        pos0 = np.zeros(b, np.int64)
        for slot in live:
            head[slot] = self._slots[slot].pending
            pos0[slot] = self.pool.positions[slot]
        drafts = np.zeros((b, max(k - 1, 0)), np.int64)
        if k > 1:
            drafts = _host(self._draft_steps(
                self._as_tensor(head), self._as_tensor(pos0),
                self.pool.states, self.pool.device_table()))
            self.metrics.on_draft_pass(k - 1)
            if self._tracer is not None:
                self._tracer.emit(self._step_idx, "spec_draft",
                                  slots=len(live), drafted=k - 1)
        if self._draft_override is not None:
            drafts = np.asarray(self._draft_override(drafts))

        # ONE chunked PFP verify pass over every block. Pad rows (beyond a
        # slot's width, or whole rows for slots not speculating) carry
        # positions at/past cache_len or an all-trash table row, so the
        # pool is only written through live blocks' own pages.
        tokens = np.zeros((b, k), np.int64)
        positions = np.tile(np.arange(k, dtype=np.int64), (b, 1))
        cache_len = np.ones(b, np.int64)
        write_start = np.zeros(b, np.int64)
        vtable = np.zeros_like(self.pool.page_table)
        fed_of = {}
        for slot in live:
            sl = self._slots[slot]
            f = f_of[slot]
            fed = [int(head[slot])] + [int(t) for t in drafts[slot, :f - 1]]
            fed_of[slot] = fed
            tokens[slot, :f] = fed
            positions[slot] = pos0[slot] + np.arange(k, dtype=np.int64)
            cache_len[slot] = pos0[slot] + f
            write_start[slot] = sl.write_start
            vtable[slot] = self.pool.page_table[slot]
        inputs = {"tokens": tokens, "positions": positions,
                  "cache_len": cache_len, "write_start": write_start,
                  "page_table": vtable}
        vmean, vvar, self.pool.states = self._verify_step(inputs,
                                                          self.pool.states)
        self.metrics.on_verify_pass()
        # The block's (token, MI): column i runs the plain step's
        # uncertainty pass at its (B, V) shape, row b keyed by (uid,
        # tok0 + i) — one host read for the block.
        columns = []
        for i in range(k):
            keyed = {slot: (self._slots[slot].request.uid,
                            len(self._slots[slot].request.generated) + i)
                     for slot in live if i < f_of[slot]}
            columns.append(self._uncertainty(vmean[:, i].contiguous(),
                                             vvar[:, i].contiguous(), keyed))
        host = _host(torch.stack(columns, dim=2))   # (2, B, K)
        tok_np, mi_np = host[0], host[1]

        drafted_total = accepted_total = 0
        for slot in live:
            sl = self._slots[slot]
            req = sl.request
            f = f_of[slot]
            fed = fed_of[slot]
            a = f                    # fed rows that stay valid
            finish_reason = None
            defer_row = None
            for i in range(f):
                mi = float(mi_np[slot, i])
                tok = int(tok_np[slot, i])
                decision = self.router.route(mi)
                if decision is not Decision.ESCALATE:
                    # An ESCALATE row is NOT counted here: it re-routes
                    # next step in phase 0 under the same (uid, token)
                    # key, and _resolve_escalations counts it there —
                    # band totals match the plain engine's exactly.
                    self.metrics.on_decision(mi, decision.value)
                if self._tracer is not None:
                    self._tracer.emit(self._step_idx, "route",
                                      uid=req.uid, token=tok, mi=mi,
                                      decision=decision.value,
                                      tok_idx=len(req.generated),
                                      speculative=True)
                if decision is Decision.ESCALATE:
                    # Stop UNSERVED: row i's logits become the slot's
                    # current logits and next step's phase 0 — same
                    # (uid, token) key, same MI — escalates them.
                    a = i + 1
                    sl.pending = None
                    sl.last_input = fed[i]
                    defer_row = i
                    break
                if decision is Decision.ABSTAIN:
                    req.mi_trace.append(mi)
                    req.abstained = True
                    a = i + 1
                    finish_reason = "abstain"
                    break
                req.generated.append(tok)
                req.mi_trace.append(mi)
                self.metrics.on_token()
                if self.config.eos_id is not None and \
                        tok == self.config.eos_id:
                    a = i + 1
                    finish_reason = "eos"
                    break
                if len(req.generated) >= req.max_new_tokens:
                    a = i + 1
                    finish_reason = "length"
                    break
                if i + 1 < f and tok == fed[i + 1]:
                    continue         # draft confirmed; row i+1 stays valid
                # Draft mismatch (or block exhausted): the verified token
                # is served but unfed — it heads the next block. Rows past
                # i are stale; they sit masked past ``positions`` until
                # re-fed (rollback-to-trash, no device work).
                a = i + 1
                sl.pending = tok
                sl.last_input = fed[i]
                break
            drafted_total += f - 1
            accepted_total += a - 1
            self.pool.positions[slot] = int(pos0[slot]) + a
            sl.replay = None
            if defer_row is not None:
                row = self._as_tensor([slot])
                self._lm_mean = self._lm_mean.index_copy(
                    0, row, vmean[slot:slot + 1, defer_row])
                self._lm_var = self._lm_var.index_copy(
                    0, row, vvar[slot:slot + 1, defer_row])
            if finish_reason is not None:
                self._finish(slot, finish_reason, now)
        self.metrics.on_spec_round(drafted_total, accepted_total)
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "spec_verify",
                              slots=len(live), drafted=drafted_total,
                              accepted=accepted_total)

    # -- escalation ----------------------------------------------------------
    def _resolve_escalations(self, decode_slots, tok_np, mi_np):
        """Route each slot's (token, MI); resolve every ESCALATE with the
        SVI second opinion — one call for all of them on paged engines
        (``batch_escalations``), a call per slot otherwise. Returns
        {slot: (token, mi, decision)} with ESCALATE already replaced by
        the second opinion's CONTINUE/ABSTAIN."""
        out = {}
        esc = []
        for slot in decode_slots:
            mi = float(mi_np[slot])
            tok = int(tok_np[slot])
            decision = self.router.route(mi)
            self.metrics.on_decision(mi, decision.value)
            if decision is Decision.ESCALATE:
                esc.append(slot)
            else:
                out[slot] = (tok, mi, decision)
        if esc:
            if self.paged and self.config.batch_escalations:
                out.update(self._escalate_batched(esc, tok_np, mi_np))
            else:
                for slot in esc:
                    out[slot] = self._escalate(slot, self._slots[slot],
                                               float(mi_np[slot]),
                                               int(tok_np[slot]))
        return out

    def _escalate_batched(self, esc_slots, pfp_tok_np, pfp_mi_np):
        """ONE call resolving every escalating slot's second opinion. Every
        row replays the inputs that produced its current logits (the
        stored prefill chunk, or the trailing fed-token window) against
        the CURRENT pool: pages are refcounted and copy-on-write, so no
        other slot can have touched this slot's rows, and the replay
        rewrites its whole window out of place before attending and masks
        everything past cache_len — bit for bit the sequential replay
        against the pre-step snapshot. Returns {slot: (tok, mi,
        decision)}."""
        b = self.config.slots
        rows = {}
        uids = np.zeros(b, np.int64)
        tok_idx = np.zeros(b, np.int64)
        out_idx = np.zeros(b, np.int64)
        for slot in esc_slots:
            sl = self._slots[slot]
            self.metrics.on_escalation()
            sl.request.escalated += 1
            uids[slot] = sl.request.uid
            tok_idx[slot] = len(sl.request.generated)
            rows[slot], out_idx[slot] = self._replay_inputs(slot, sl)
        stoks, smis = self.router.second_opinion_batched(
            self.model, rows, self.pool.states, self._svi_noise, uids,
            tok_idx, out_idx)
        self.metrics.on_svi_pass(len(esc_slots))
        host = _host(torch.stack((stoks.double(), smis.double())))
        return {slot: self._svi_outcome(
                    self._slots[slot], int(pfp_tok_np[slot]),
                    float(pfp_mi_np[slot]), int(host[0, slot]),
                    float(host[1, slot]), batched=True)
                for slot in esc_slots}

    def _svi_outcome(self, sl: _Slot, pfp_tok: int, pfp_mi: float,
                     stok: int, mi: float, *, batched: bool):
        """The final (token, mi, decision) of one second opinion: serve
        the SVI token, or abstain when the sampled ensemble is still
        uncertain; records its telemetry and trace event."""
        decision = (Decision.ABSTAIN if mi >= self.router.svi_mi_abstain
                    else Decision.CONTINUE)
        self.metrics.on_escalation_outcome(pfp_mi, pfp_tok, mi, stok,
                                           decision.value)
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "escalate", uid=sl.request.uid,
                              pfp_mi=pfp_mi, svi_mi=mi,
                              agree=pfp_tok == stok,
                              outcome=decision.value, batched=batched)
        return stok, mi, decision

    def _replay_window(self, slot: int, sl: _Slot):
        """The SVI replay window of a mid-decode escalation: the last
        ``prefill_chunk`` fed tokens ending at the slot's position
        (right-padded past cache_len while fewer have been fed) — the
        SAME shape as a stored prefill-chunk replay, so every replay of
        an attention model runs at one (1, C) shape. MoE models replay the
        one last token, as the reference does (their expert capacity
        follows the pass's token count), and so do models with recurrent
        or SSM carries: re-fed tokens would advance a carry twice, so
        they replay against the carries from before the step
        (``_prev_states``). Returns (tokens (1, w), positions (1, w),
        cache_len (1,), out_idx)."""
        pos = int(self.pool.positions[slot])
        c = (self.scheduler.config.prefill_chunk
             if all(k == "attn" for k in self.cfg.pattern) else 1)
        lo = max(0, pos - c)
        window = self._request_tokens(sl.request)[lo:pos]
        tokens = np.zeros(c, np.int64)
        tokens[:len(window)] = window
        positions = lo + np.arange(c, dtype=np.int64)
        return (tokens[None], positions[None],
                np.asarray([pos], np.int64), len(window) - 1)

    def _replay_inputs(self, slot: int, sl: _Slot):
        """(inputs, out_idx) reproducing the pass that made the slot's
        current logits: the stored chunk inputs right after prefill, else
        the trailing fed-token window (with the slot's page-table row on
        a paged engine)."""
        if sl.replay is not None:
            _, inputs, out_idx = sl.replay
            return inputs, out_idx
        tokens, positions, cache_len, out_idx = self._replay_window(slot, sl)
        inputs = {"tokens": tokens, "positions": positions,
                  "cache_len": cache_len}
        if self.paged:
            inputs["page_table"] = self.pool.device_table(
                np.asarray([slot], np.int64))
        return inputs, out_idx

    def _replay_for(self, slot: int, sl: _Slot):
        """(state, inputs, out_idx) reproducing the pass that made the
        slot's current logits: the pre-chunk state + chunk inputs right
        after prefill, else the trailing fed-token window against the
        pre-decode pool. Paged engines replay against the WHOLE page pool
        (there is no per-slot state to extract), the slot's page-table row
        doing the selection."""
        if sl.replay is not None:
            return sl.replay
        inputs, out_idx = self._replay_inputs(slot, sl)
        if self.paged:
            # Speculative mode replays against the CURRENT pool: the
            # verify pass writes several rows per step, so no pre-step
            # snapshot exists. The replay rewrites its whole window out of
            # place before attending and masks everything past cache_len,
            # so the two states give the same bits.
            if self.config.speculate_k:
                return self.pool.states, inputs, out_idx
            return self._prev_states, inputs, out_idx
        sub = lm.take_decode_slots(self._prev_states, [slot])
        return sub, inputs, out_idx

    def _escalate(self, slot: int, sl: _Slot, pfp_mi: float, pfp_tok: int):
        """SVI second opinion for one grey-zone token: the final (token,
        mi, decision) of :meth:`_svi_outcome`."""
        self.metrics.on_escalation()
        sl.request.escalated += 1
        sub, inputs, out_idx = self._replay_for(slot, sl)
        # keyed per (request, token), like the PFP uncertainty sampling:
        # escalated second opinions are schedule-invariant too
        noise = self._svi_noise(sl.request.uid, len(sl.request.generated))
        stok, smi = self.router.second_opinion(self.model, inputs, sub,
                                               noise, out_idx=out_idx)
        self.metrics.on_svi_pass(1)
        host = _host(torch.stack((stok.double(), smi.double())))
        return self._svi_outcome(sl, pfp_tok, pfp_mi, int(host[0]),
                                 float(host[1]), batched=False)

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
        through the pool's remap listener); keep the escalation-replay
        snapshot page-aligned with the rewritten tables."""
        if not self.paged:
            raise ValueError("defrag() applies to the paged engine; the "
                             "contiguous engine compacts slots instead")
        perm = self.pool.defrag()
        if perm is None:
            return
        self.metrics.on_defrag()
        if self._tracer is not None:
            self._tracer.emit(self._step_idx, "defrag")
        if self._prev_states is not None:
            self._prev_states = lm.take_decode_slots(self._prev_states, perm)

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
        if self._prev_states is not None:
            # keep the escalation-replay snapshot slot-aligned (free rows
            # may duplicate — replay only ever reads live slots)
            self._prev_states = lm.take_decode_slots(self._prev_states, perm)
