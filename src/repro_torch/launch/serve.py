"""PFP serving CLI: the continuous-batching engine, or a fleet of
engines, on one card.

Counterpart of ``repro/launch/serve.py``. Drives
``repro_torch.serving.engine``: Poisson request arrivals, admission-
controlled scheduling, chunked prefill, one probabilistic forward pass
per decode step for the whole slot batch, and uncertainty routing
(continue / escalate to an SVI second opinion / abstain).
``--replicas R`` serves through ``repro_torch.serving.fleet`` (prefix
routing; ``--disaggregate`` splits each replica into a prefill and a
decode engine over one page pool) and checks the routed output bit for
bit against a single engine on the same trace. ``--impl kernel`` (the
registry's default) runs every PFP op on the hand-written CUDA kernels;
``--impl eager`` on plain torch.

Differences from the reference: one card, so no ``--devices`` or
``--mesh`` (they come with the ``torch.distributed`` slice); ``--impl``
takes ``eager`` / ``kernel``; the weights are drawn on ``--device`` (the
CUDA card by default; without one this raises unless ``--device cpu``)
from ``--seed``, and ``--layers`` cuts the model; the engine serves in
IEEE fp32 where the reference serves in bf16.

Usage (``PYTHONPATH=src``):
  python -m repro_torch.launch.serve --device cpu --reduced --tokens 4
  python -m repro_torch.launch.serve --device cpu --reduced --replicas 2 \\
      --disaggregate --page-size 16 --prefix-sharing --common-prefix 8 \\
      --trace-out obs/trace.jsonl --metrics-out obs/metrics.json \\
      --prom-out obs/metrics.prom
  python -m repro_torch.launch.serve --full-size --layers 2 --impl kernel \\
      --replicas 2 --page-size 16 --prefix-sharing --profile-ops  # card

``main(argv)`` returns the exit code, so scripts can call it in-process.
"""
import argparse
import contextlib
import json
import os
import sys

_SUMMARY_KEYS = (
    "submitted", "rejected", "expired", "completed", "abstained",
    "escalations", "tokens_generated", "steps", "throughput_tok_s",
    "p50_latency_steps", "p99_latency_steps", "abstain_rate",
    "escalation_rate", "peak_occupancy", "final_occupancy",
)

_PAGED_KEYS = (
    "preemptions", "defrags", "peak_page_occupancy", "mean_page_occupancy",
    "mean_page_fragmentation", "final_live_pages",
)

_PREFIX_KEYS = (
    "prefix_hits", "prefix_hit_rate", "prefix_shared_pages",
    "prefill_tokens_saved", "prefill_frac_saved", "cow_copies",
    "mean_shared_pages", "final_prefix_held_pages",
)

_MOE_KEYS = (
    "moe_assignments", "moe_dropped_assignments", "moe_drop_rate",
)

_SPEC_KEYS = (
    "spec_rounds", "draft_tokens", "accepted_draft_tokens",
    "draft_acceptance_rate", "accepted_tokens_per_verify", "verify_passes",
    "decode_passes", "draft_passes", "svi_passes", "svi_passes_per_step",
    "max_svi_passes_per_step", "mean_escalation_batch",
    "pfp_passes_per_token",
)


_FLEET_KEYS = (
    "replicas", "submitted", "rejected", "expired", "finished", "completed",
    "abstained", "tokens_generated", "prefill_tokens", "steps",
    "route_prefix_hits", "route_fallbacks", "route_hit_rate",
    "route_tokens_matched", "prefix_hits", "prefix_hit_rate",
    "prefill_tokens_saved", "cow_copies", "preemptions", "requeue_overflow",
    "final_occupancy",
)

_DISAGG_KEYS = (
    "handoffs", "p50_handoff_steps", "p99_handoff_steps",
    "decode_steps_during_peer_prefill",
)


def _served(reqs):
    """uid -> (tokens, MI trace, finish reason) of finished requests."""
    return {r.uid: (list(r.generated), [float(m) for m in r.mi_trace],
                    r.finish_reason) for r in reqs}


def _print_summary(summary, keys):
    for k in keys:
        v = summary[k]
        print(f"  {k:22s} {v:.4g}" if isinstance(v, float)
              else f"  {k:22s} {v}")


def _lane_registries(target):
    """lane -> MetricsRegistry for every telemetry owner in a serving
    stack: a single Engine, or a Fleet frontend plus each replica engine
    (a DisaggPair contributes its prefill and decode engines)."""
    if hasattr(target, "replicas"):  # Fleet
        out = {"fleet": target.metrics.registry}
        for i, rep in enumerate(target.replicas):
            if hasattr(rep, "engines"):  # DisaggPair
                out[f"r{i}.prefill"] = rep.prefill_engine.metrics.registry
                out[f"r{i}.decode"] = rep.decode_engine.metrics.registry
            else:
                out[f"r{i}"] = rep.metrics.registry
        return out
    return {"engine": target.metrics.registry}


def decode_pass_inputs(engine):
    """The arguments of one lockstep decode pass of ``engine`` with every
    slot inactive: paged writes go to the trash page, the contiguous
    select-merge keeps the old state, and the logit buffers keep their
    rows, so the engine's state is untouched."""
    import numpy as np
    import torch

    b = engine.config.slots
    feed = np.zeros((b, 1), np.int32)
    pos = np.zeros((b, 1), np.int32)
    clen = np.zeros(b, np.int32)
    active = torch.zeros(b, dtype=torch.bool, device=engine.device)
    args = (feed, pos, clen, active, engine.pool.states)
    if engine.paged:
        args += (engine.pool.device_table(),)
    return args + engine.logit_buffers


def profile_decode(engine):
    """One per-op-fenced lockstep decode pass through the dispatch
    profiler (:func:`decode_pass_inputs`) — the live Table-4-style
    per-layer breakdown of the LM pass the engine serves."""
    from repro_torch.obs.profiler import profile_ops

    args = decode_pass_inputs(engine)
    with profile_ops() as prof:
        engine.decode_fn(*args)
    return prof


def _export_obs(args, target, summary, tracer, profile=None):
    """Write the run's observability artifacts: JSONL + Chrome traces,
    the metrics JSON payload (run metadata + summary + every lane's
    registry snapshot), and the Prometheus text export."""
    if tracer is not None and args.trace_out:
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        tracer.write_jsonl(args.trace_out)
        chrome = os.path.splitext(args.trace_out)[0] + ".chrome.json"
        tracer.write_chrome(chrome)
        print(f"trace: {len(tracer.events)} events -> {args.trace_out} "
              f"(Perfetto: {chrome})")
    regs = _lane_registries(target)
    if args.metrics_out:
        from repro_torch.obs.runmeta import run_metadata
        payload = {
            "meta": run_metadata(),
            "summary": summary,
            "registries": {lane: reg.snapshot()
                           for lane, reg in sorted(regs.items())},
        }
        if profile is not None:
            payload["op_profile"] = profile.summary()
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        print(f"metrics: -> {args.metrics_out}")
    if args.prom_out:
        # One text exposition over every lane (lane is a label); repeated
        # HELP/TYPE headers from the per-lane exports are deduplicated.
        seen, lines = set(), []
        for lane, reg in sorted(regs.items()):
            for line in reg.to_prometheus(
                    extra_labels={"lane": lane}).splitlines():
                if line.startswith("#"):
                    if line in seen:
                        continue
                    seen.add(line)
                lines.append(line)
        os.makedirs(os.path.dirname(args.prom_out) or ".", exist_ok=True)
        with open(args.prom_out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"prometheus: -> {args.prom_out}")


def _run_fleet(args, cfg, model, router, sched_cfg, device, max_len,
               make_trace, tracer=None):
    """--replicas R: the fleet frontend path. Routed multi-replica output
    must be bit-for-bit (tokens AND MI traces) a single engine's on the
    same trace — every replica runs the baseline's pass shapes and the
    per-(uid, token) keyed sampling makes placement invisible — and every
    replica's pool must drain without a page or hold leak."""
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            RequestScheduler, run_load)
    from repro_torch.serving.fleet import Fleet, FleetConfig

    if args.disaggregate and (args.page_size is None
                              or not args.prefix_sharing):
        print("ERROR: --disaggregate requires --page-size and "
              "--prefix-sharing (pages hand off from the prefill engine "
              "to the decode engine through the prefix index)",
              file=sys.stderr)
        return 2
    engine_cfg = EngineConfig(
        slots=args.batch, max_len=max_len, impl=args.impl, seed=args.seed,
        page_size=args.page_size, page_budget=args.page_budget,
        reserve_pages=not args.optimistic_pages,
        # a defrag inside one engine of a disaggregated pair would remap
        # the peer's tables without permuting its replay snapshot
        auto_defrag=args.page_size is not None and not args.disaggregate,
        prefix_sharing=args.prefix_sharing,
        prefix_retention_pages=args.prefix_retention,
        speculate_k=args.speculate)
    fleet = Fleet(cfg, model, engine_cfg,
                  FleetConfig(replicas=args.replicas,
                              disaggregate=args.disaggregate),
                  router=router, scheduler_config=sched_cfg, device=device,
                  tracer=tracer)
    summary = run_load(fleet, make_trace())

    profile = None
    if args.profile_ops:
        first = fleet.replicas[0]
        eng = first.decode_engine if hasattr(first, "engines") else first
        profile = profile_decode(eng)
        print("== per-op decode profile (one fenced pass, replica 0) ==")
        print(profile.format_table())
    _export_obs(args, fleet, summary, tracer, profile)

    mode = "disaggregated" if args.disaggregate else "replicated"
    layout = (f"paged/ps={args.page_size}" if args.page_size
              else "contiguous")
    if args.prefix_sharing:
        layout += "/prefix"
    print(f"== fleet summary ({cfg.name}, R={args.replicas} {mode}, "
          f"device={device}, impl={args.impl or 'default'}, "
          f"kv={layout}) ==")
    _print_summary(summary,
                   _FLEET_KEYS + (_DISAGG_KEYS if args.disaggregate else ()))

    # -- per-replica drain + page/hold leak checks --------------------------
    occ = sum(r.active_slots for r in fleet.replicas)
    if occ != 0:
        print(f"ERROR: fleet leaked {occ} occupied slots after drain",
              file=sys.stderr)
        return 1
    for i, rep in enumerate(fleet.replicas):
        rep.pool.check_invariants()
        prefix = getattr(rep, "prefix", None)
        if prefix is not None:
            if prefix.pages_held > prefix.retention_pages:
                print(f"ERROR: replica {i} prefix index holds "
                      f"{prefix.pages_held} pages beyond its retention of "
                      f"{prefix.retention_pages}", file=sys.stderr)
                return 1
            prefix.check_invariants(rep.pool)
        if args.page_size is not None:
            pool = rep.pool
            leaked = [p for p in range(1, pool.num_pages)
                      if pool.page_ref[p] != pool.external_holds[p]]
            if leaked:
                print(f"ERROR: replica {i} page/hold leak on pages "
                      f"{leaked[:8]} ({len(leaked)} total) after drain",
                      file=sys.stderr)
                return 1

    if args.expect_route_hits is not None:
        if summary["route_prefix_hits"] == 0 or \
                summary["route_hit_rate"] < args.expect_route_hits:
            print("ERROR: --expect-route-hits: "
                  f"{summary['route_prefix_hits']} prefix routes at "
                  f"hit-rate {summary['route_hit_rate']:.3f} "
                  f"(floor {args.expect_route_hits})", file=sys.stderr)
            return 1
    if args.disaggregate and summary["handoffs"] == 0:
        print("ERROR: --disaggregate but no prefill->decode handoff "
              "completed (trace drained without disaggregation engaging)",
              file=sys.stderr)
        return 1

    # -- bit-for-bit parity with a single engine ----------------------------
    # The baseline reuses the fleet's exact engine_cfg (no auto_defrag
    # under --disaggregate), so the comparison can only surface routing or
    # handoff faults.
    single = Engine(cfg, model, engine_cfg, router=router,
                    scheduler=RequestScheduler(sched_cfg, max_len=max_len),
                    device=device)
    run_load(single, make_trace())
    got, want = _served(fleet.finished), _served(single.finished)
    if got != want:
        diff = sorted(u for u in set(got) | set(want)
                      if got.get(u) != want.get(u))
        print("ERROR: routed fleet output diverged from the single-engine "
              f"baseline on uids {diff[:8]} (tokens and MI traces must be "
              "bit-for-bit identical)", file=sys.stderr)
        return 1
    print(f"fleet served {summary['completed']} requests "
          f"({summary['tokens_generated']} tokens) across {args.replicas} "
          "replicas — bit-for-bit the single-engine stream, "
          f"{summary['route_prefix_hits']} of them routed to a cached "
          "prefix.")
    return 0


def _parser():
    ap = argparse.ArgumentParser(
        description="Serve a PFP LM through the continuous-batching engine "
                    "(or a fleet of them) on one card.")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-size", dest="reduced", action="store_false",
                    help="serve the full-size config instead of the "
                         "reduced CPU-smoke one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); "
                         "'cpu' serves on the CPU")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (the continuous batch size)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8,
                    help="max new tokens per request")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate (requests per engine step)")
    ap.add_argument("--engine", action="store_true", default=True,
                    help="no-op compatibility flag, as in the reference: "
                         "the continuous-batching engine is the only "
                         "serving path")
    ap.add_argument("--impl", default=None, choices=["eager", "kernel"],
                    help="PFP operator implementation (core/dispatch.py; "
                         "default: the registry's, kernel)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged Gaussian KV-cache page size (rows per "
                         "page); default: contiguous per-slot layout")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="usable pages in the pool (default: "
                         "slots * ceil(max_len / page_size))")
    ap.add_argument("--optimistic-pages", action="store_true",
                    help="admit on prompt pages only and claim decode "
                         "pages on demand (may preempt) instead of "
                         "reserving the full prompt+generation need")
    ap.add_argument("--expect-defrag", action="store_true",
                    help="exit nonzero unless the run performed at least "
                         "one page defrag (prove multi-page churn)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted copy-on-write prefix sharing: index "
                         "finished lineages' pages and map them into new "
                         "requests sharing a prompt prefix (paged only)")
    ap.add_argument("--prefix-retention", type=int, default=None,
                    help="max pages the prefix index may hold for finished "
                         "lineages (default: the whole page budget)")
    ap.add_argument("--common-prefix", type=int, default=0,
                    help="overwrite the first N tokens of every generated "
                         "prompt with one fixed system prefix, so the "
                         "trace exercises prefix sharing")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="exit nonzero unless at least one admission "
                         "mapped shared prefix pages")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="uncertainty-speculative decoding: draft K tokens "
                         "per slot with a mean-only pass and verify the "
                         "block with ONE chunked PFP pass (paged only); "
                         "the run is checked against a plain engine on "
                         "the same trace")
    ap.add_argument("--expect-moe-drop", action="store_true",
                    help="exit nonzero unless the run recorded MoE routing "
                         "accounting (moe_assignments > 0) and a finite "
                         "drop rate (moe only)")
    ap.add_argument("--expect-accept-rate", type=float, default=None,
                    metavar="R",
                    help="exit nonzero if the draft acceptance rate falls "
                         "below R")
    ap.add_argument("--replicas", type=int, default=1, metavar="R",
                    help="serve through a fleet of R data-parallel replica "
                         "engines behind a prefix-routing frontend; the "
                         "routed output is checked bit-for-bit against a "
                         "single-engine baseline on the same trace")
    ap.add_argument("--disaggregate", action="store_true",
                    help="split each replica into a prefill engine and a "
                         "decode engine over one shared page pool (needs "
                         "--page-size and --prefix-sharing): prompts "
                         "prefill on the prefill engine and the pages hand "
                         "off through the prefix index, so decode "
                         "admission never waits behind a long prompt")
    ap.add_argument("--expect-route-hits", type=float, default=None,
                    nargs="?", const=0.0, metavar="RATE",
                    help="exit nonzero unless at least one request was "
                         "routed to a replica's cached prefix (with a "
                         "value: unless the routing prefix hit-rate is "
                         ">= RATE)")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--mi-continue", type=float, default=0.5)
    ap.add_argument("--mi-abstain", type=float, default=3.0)
    ap.add_argument("--escalate-samples", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # -- observability ------------------------------------------------------
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the deterministic request trace as JSONL "
                         "to PATH and a Perfetto/chrome://tracing view to "
                         "PATH's stem + '.chrome.json'")
    ap.add_argument("--trace-wall", action="store_true",
                    help="annotate every trace event with wall-clock "
                         "seconds (strippable; the step-keyed trace stays "
                         "deterministic without it)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics payload (run metadata, the "
                         "summary, every lane's registry snapshot) as JSON")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write every lane's registry in Prometheus text "
                         "exposition format (lane as a label)")
    ap.add_argument("--profile-ops", action="store_true",
                    help="after the run, time ONE per-op-fenced decode "
                         "pass at the dispatch registry and print the "
                         "per-layer breakdown (paper Table 4, live)")
    # -- tuned-schedule DB --------------------------------------------------
    ap.add_argument("--schedule-db", default=None, metavar="PATH",
                    help="preload a tuned-schedule DB (repro_torch.tuning "
                         "cache) before building the engine")
    ap.add_argument("--save-schedule-db", default=None, metavar="PATH",
                    help="record every (op, shape, dtype) the run consults, "
                         "tune any missing entry (timed on a card, ranked "
                         "on the CPU), and save the DB to PATH")
    ap.add_argument("--expect-warm-cache", action="store_true",
                    help="exit nonzero if any tuning-cache consult missed "
                         "during the run (prove a preloaded --schedule-db "
                         "covers the model's shape set)")
    ap.add_argument("--fuse-ops", action="store_true",
                    help="enable the dispatch fusion pass: eligible "
                         "norm->dense->activation chains run as one fused "
                         "kernel when a tuned norm_dense_act schedule is "
                         "cached (the unfused chain otherwise)")
    return ap


def _serve(args, device):
    import numpy as np

    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            RequestScheduler, RouterConfig,
                                            SchedulerConfig,
                                            UncertaintyRouter, poisson_trace,
                                            run_load)
    from repro_torch.tuning.autotune import build_lm

    cfg, model = build_lm(args.arch, layers=args.layers,
                          reduced=args.reduced, device=device,
                          seed=args.seed)
    max_len = args.prompt_len + args.tokens
    router = UncertaintyRouter(
        cfg, RouterConfig(mi_continue=args.mi_continue,
                          mi_abstain=args.mi_abstain,
                          escalate_samples=args.escalate_samples),
        impl=args.impl)
    sched_cfg = SchedulerConfig(prefill_chunk=args.prefill_chunk,
                                prefill_budget=2 * args.prefill_chunk)

    def make_trace():
        # Regenerable: run_load mutates the Request objects, so the
        # parity checks below need a fresh copy per engine.
        trace = poisson_trace(
            args.requests, args.rate, vocab_size=cfg.vocab_size,
            seed=args.seed,
            prompt_len=(max(2, args.prompt_len // 2), args.prompt_len),
            max_new_tokens=(max(1, args.tokens // 2), args.tokens))
        if args.common_prefix:
            # one fixed system prefix across the whole trace
            # (deterministic), so requests share their leading pages once
            # a donor finishes
            system = (np.arange(args.common_prefix, dtype=np.int32)
                      % cfg.vocab_size)
            for r in trace:
                n = min(args.common_prefix, len(r.prompt) - 1)
                r.prompt[:n] = system[:n]
        return trace

    tracer = Tracer(wall=args.trace_wall) if args.trace_out else None

    if args.replicas > 1:
        return _run_fleet(args, cfg, model, router, sched_cfg, device,
                          max_len, make_trace, tracer)

    def build_engine(speculate_k, tracer=None):
        return Engine(
            cfg, model,
            EngineConfig(slots=args.batch, max_len=max_len, impl=args.impl,
                         seed=args.seed, page_size=args.page_size,
                         page_budget=args.page_budget,
                         reserve_pages=not args.optimistic_pages,
                         auto_defrag=args.page_size is not None,
                         prefix_sharing=args.prefix_sharing,
                         prefix_retention_pages=args.prefix_retention,
                         speculate_k=speculate_k),
            router=router,
            scheduler=RequestScheduler(sched_cfg, max_len=max_len),
            tracer=tracer, device=device)

    engine = build_engine(args.speculate, tracer)
    summary = run_load(engine, make_trace())

    profile = None
    if args.profile_ops:
        profile = profile_decode(engine)
        print("== per-op decode profile (one fenced pass) ==")
        print(profile.format_table())
    _export_obs(args, engine, summary, tracer, profile)

    layout = (f"paged/ps={args.page_size}" if args.page_size
              else "contiguous")
    if args.prefix_sharing:
        layout += "/prefix"
    if args.speculate:
        layout += f"/spec-k{args.speculate}"
    print(f"== engine summary ({cfg.name}, device={device}, "
          f"impl={args.impl or 'default'}, kv={layout}) ==")
    _print_summary(summary, _SUMMARY_KEYS
                   + (_MOE_KEYS if cfg.family == "moe" else ())
                   + (_PAGED_KEYS if args.page_size else ())
                   + (_PREFIX_KEYS if args.prefix_sharing else ())
                   + (_SPEC_KEYS if args.speculate else ()))
    # Diagnostics before the assertion-style invariant checks, so a
    # failure prints the readable ERROR line instead of a bare traceback.
    if engine.prefix is not None and \
            engine.prefix.pages_held > engine.prefix.retention_pages:
        print(f"ERROR: prefix index holds {engine.prefix.pages_held} pages "
              f"for finished lineages, beyond its retention of "
              f"{engine.prefix.retention_pages}", file=sys.stderr)
        return 1
    engine.pool.check_invariants()
    if engine.prefix is not None:
        engine.prefix.check_invariants(engine.pool)
    if summary["final_occupancy"] != 0:
        print("ERROR: slot pool leaked "
              f"{summary['final_occupancy']} slots", file=sys.stderr)
        return 1
    if args.page_size is not None:
        pool = engine.pool
        held = engine.prefix.pages_held if engine.prefix is not None else 0
        # Refcount-leak check, the paged analogue of the slot-leak check:
        # with every slot drained, the only legitimate references left
        # are the prefix index's holds — any page whose refcount is not
        # exactly its external-hold count leaked a reference (or was
        # freed with one outstanding).
        leaked = [p for p in range(1, pool.num_pages)
                  if pool.page_ref[p] != pool.external_holds[p]]
        if leaked:
            print(f"ERROR: page refcount leak on pages {leaked[:8]} "
                  f"({len(leaked)} total) after drain", file=sys.stderr)
            return 1
        if summary["final_live_pages"] != held:
            print("ERROR: page pool leaked "
                  f"{summary['final_live_pages'] - held} pages beyond the "
                  f"{held} prefix-index holds", file=sys.stderr)
            return 1
    if args.expect_defrag and summary["defrags"] == 0:
        print("ERROR: --expect-defrag but the run never defragged "
              "(page churn too low to exercise the paged pool)",
              file=sys.stderr)
        return 1
    if args.expect_moe_drop:
        if cfg.family != "moe":
            print(f"ERROR: --expect-moe-drop on a non-MoE arch "
                  f"({cfg.name} is family={cfg.family})", file=sys.stderr)
            return 1
        if summary["moe_assignments"] == 0:
            print("ERROR: --expect-moe-drop but the run recorded no MoE "
                  "routing assignments (aux accounting never reached the "
                  "engine metrics)", file=sys.stderr)
            return 1
        print(f"moe routing: {summary['moe_assignments']} assignments, "
              f"{summary['moe_dropped_assignments']} dropped "
              f"(rate {summary['moe_drop_rate']:.4f})")
    if args.expect_prefix_hits and summary["prefix_hits"] == 0:
        print("ERROR: --expect-prefix-hits but no admission mapped shared "
              "prefix pages (trace lacks a common prefix, or donors never "
              "finished before sharers arrived)", file=sys.stderr)
        return 1
    if args.speculate:
        # The speculative stream must serve exactly what plain decode
        # serves: tokens and finish reasons bit-for-bit; MI traces within
        # the reference's tolerance between pass shapes (the port's
        # verify rows are bit for bit its decode rows on the card, and on
        # the CPU wherever no dense call has one row).
        plain = build_engine(0)
        run_load(plain, make_trace())
        got, want = _served(engine.finished), _served(plain.finished)
        same = set(got) == set(want) and all(
            (got[u][0], got[u][2]) == (want[u][0], want[u][2])
            and len(got[u][1]) == len(want[u][1])
            and np.allclose(got[u][1], want[u][1], rtol=0.0, atol=2e-5)
            for u in want)
        if not same:
            print("ERROR: speculative decode diverged from plain decode "
                  "(tokens differ, or MI traces beyond 2e-5)",
                  file=sys.stderr)
            return 1
        if args.expect_accept_rate is not None and \
                summary["draft_acceptance_rate"] < args.expect_accept_rate:
            print("ERROR: draft acceptance rate "
                  f"{summary['draft_acceptance_rate']:.3f} below the "
                  f"--expect-accept-rate {args.expect_accept_rate} floor",
                  file=sys.stderr)
            return 1
    print(f"served {summary['completed']} requests "
          f"({summary['tokens_generated']} tokens) — one PFP pass per decode "
          "step; escalations spent SVI samples only on gray-zone tokens.")
    return 0


def _tuning_epilogue(args, queries, device):
    """Post-run tuned-schedule bookkeeping: prove the preloaded DB kept
    the serving path free of misses (--expect-warm-cache) and/or persist
    what this run consulted (--save-schedule-db)."""
    from repro_torch.tuning import cache as sched_cache

    counters = sched_cache.consult_counters()
    if args.schedule_db or args.expect_warm_cache or args.save_schedule_db:
        print(f"tuning-cache consults: {counters['consults']} "
              f"({counters['hits']} hits, {counters['misses']} misses)")
    if args.expect_warm_cache and counters["misses"] > 0:
        print("ERROR: --expect-warm-cache but the run missed the tuning "
              f"cache {counters['misses']} times (the schedule DB does not "
              "cover this model's shape set)", file=sys.stderr)
        return 1
    if args.save_schedule_db:
        from repro_torch.tuning import measure as sched_measure

        cache = sched_cache.global_cache()
        tuned = 0
        for op, shape_key, dtype, backend in dict.fromkeys(queries or ()):
            if cache.get(op, shape_key, dtype, backend) is None:
                sched_measure.tune_into_cache(cache, op, shape_key, dtype,
                                              backend, device=device)
                tuned += 1
        path = cache.save(args.save_schedule_db)
        print(f"schedule-db: tuned {tuned} new entries, saved "
              f"{len(cache)} total -> {path}")
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from repro_torch.core import dispatch
    from repro_torch.core.device import resolve_device
    from repro_torch.tuning import cache as sched_cache

    device = resolve_device(args.device)
    if args.schedule_db:
        n = len(sched_cache.load_global_cache(args.schedule_db))
        print(f"schedule-db: preloaded {n} tuned entries "
              f"from {args.schedule_db}")
    # Scope the warm-start proof to this run's consults, not earlier work
    # in the same process.
    sched_cache.consult_counters(reset=True)
    with contextlib.ExitStack() as stack:
        stack.enter_context(dispatch.fusion(args.fuse_ops))
        queries = (stack.enter_context(sched_cache.record_shapes())
                   if args.save_schedule_db else None)
        rc = _serve(args, device)
    if rc == 0:
        rc = _tuning_epilogue(args, queries, device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
