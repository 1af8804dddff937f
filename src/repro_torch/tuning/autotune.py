"""Model-level autotuning: warm the schedule cache for a model's shapes.

Counterpart of ``repro/tuning/autotune.py``. ``collect_queries`` runs a
forward once under the shape recorder (``torch.no_grad``; torch has no
``eval_shape``, so the forward really runs). With a cold cache every
fusion pending misses, so the recorded run is the unfused forward.
``autotune`` then tunes each query the cache does not hold yet and stores
the winner, with whether it beat the unfused chain. Later forwards with
fusion on pick the schedules up through the dispatch layer's cache
consult, and fuse where the winner was faster.

CLI for an LM, on the card (``--device cpu --reduced`` runs it on the
CPU, where the first legal candidate is taken and nothing is timed):

    python -m repro_torch.tuning.autotune --config granite-8b --layers 2 \\
        --fuse --save build/schedules.json
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.tuning import measure
from repro_torch.tuning.cache import (Query, ScheduleCache, global_cache,
                                      record_shapes)
from repro_torch.tuning.schedules import Schedule


def collect_queries(forward: Callable, params, batch, ctx) -> list:
    """Unique (op, shape_key, dtype, backend) queries of one
    ``forward(params, batch, ctx)``, in first-consult order."""
    with record_shapes() as rec, torch.no_grad():
        forward(params, batch, ctx)
    return list(dict.fromkeys(rec))


def autotune(forward: Callable, params, batch, ctx, *,
             cache: Optional[ScheduleCache] = None, limit: int = 8,
             save_path: Optional[str] = None,
             verbose: bool = False) -> Dict[Query, Schedule]:
    """Tune every query one forward makes and warm ``cache`` (the
    process-global one by default). A query the cache holds is not tuned
    again. Returns query -> schedule."""
    cache = cache if cache is not None else global_cache()
    device = ctx.device
    chosen: Dict[Query, Schedule] = {}
    for query in collect_queries(forward, params, batch, ctx):
        op, shape_key, dtype, backend = query
        hit = cache.get(op, shape_key, dtype, backend)
        if hit is not None:
            chosen[query] = hit
            if verbose:
                print(f"  [hit ] {op} {shape_key} -> {hit.describe()}")
            continue
        result = measure.tune_into_cache(
            cache, op, shape_key, dtype, backend, device=device,
            limit=limit)
        chosen[query] = result.best
        if verbose:
            times = ", ".join(
                f"{r['schedule']} {r['seconds'] * 1e3:.3f} ms"
                if r["seconds"] is not None else r["schedule"]
                for r in result.records)
            chain = ("" if result.unfused_s is None else
                     f"; unfused chain {result.unfused_s * 1e3:.3f} ms, "
                     + ("fuse" if result.fuse else "stay unfused"))
            print(f"  [tune] {op} {shape_key} ({result.mode}) -> "
                  f"{result.best.describe()}; {times}{chain}"
                  + (f"; dropped {[r['schedule'] for r in result.dropped]}"
                     if result.dropped else ""))
    if save_path or cache.path:
        cache.save(save_path or cache.path)
    return chosen


def lm_workloads(model, cfg, *, batch: int, seq: int, decode_slots: int,
                 device):
    """The LM's calls to tune for: a forward of ``batch`` x ``seq`` token
    ids and, with ``decode_slots``, one decode step of that many slots
    (one token each, against a fresh cache of ``seq`` rows). Returns
    [(label, forward(params, inputs, ctx), inputs)]."""
    from repro_torch.models import lm

    g = torch.Generator().manual_seed(0)
    out = [("forward", lambda p, b, c: lm.forward(p, cfg, b, c),
            {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=g)})]
    if decode_slots:
        states = lm.init_decode_state(cfg, decode_slots, seq, device=device)
        pos = torch.arange(decode_slots)
        out.append(("decode step",
                    lambda p, b, c: lm.decode_step(p, cfg, b, states, c),
                    {"tokens": torch.randint(0, cfg.vocab_size,
                                             (decode_slots, 1), generator=g),
                     "positions": pos[:, None], "cache_len": pos + 1}))
    return out


def build_lm(config: str, *, layers: Optional[int], reduced: bool, device,
             seed: int = 0):
    """The LM of ``config`` (full width, or the reduced config), cut to
    ``layers`` layers, random weights drawn on ``device`` from ``seed``,
    converted to PFP."""
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    cfg = reduced_config(config) if reduced else get_config(config)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, svi_to_pfp(lm.init_params(cfg, generator=gen, device=device))


def main(argv=None) -> Dict[Query, Schedule]:
    ap = argparse.ArgumentParser(
        description="Tune the fused norm_dense_act units of an LM and "
                    "save the schedule DB (time on a card, rank on the "
                    "CPU).")
    ap.add_argument("--config", default="granite-8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the tests' size)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--decode-slots", type=int, default=4,
                    help="also tune one decode step of this many slots "
                         "(0: the forward only)")
    ap.add_argument("--limit", type=int, default=4,
                    help="max candidates per (op, shape)")
    ap.add_argument("--fuse", action="store_true",
                    help="turn the fusion pass on while collecting shapes, "
                         "so the fused norm_dense_act units are found")
    ap.add_argument("--save", default=None, help="cache file to write")
    args = ap.parse_args(argv)

    from repro_torch.core import dispatch
    from repro_torch.core.device import resolve_device
    from repro_torch.core.modes import Mode
    from repro_torch.nn.module import Context

    device = resolve_device(args.device)
    cfg, model = build_lm(args.config, layers=args.layers,
                          reduced=args.reduced, device=device)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    chosen: Dict[Query, Schedule] = {}
    with dispatch.fusion(args.fuse):
        for label, forward, inputs in lm_workloads(
                model, cfg, batch=args.batch, seq=args.seq,
                decode_slots=args.decode_slots, device=device):
            print(f"[autotune] {cfg.name} ({cfg.num_layers} layers) {label}")
            chosen.update(autotune(forward, model, inputs, ctx,
                                   limit=args.limit, save_path=args.save,
                                   verbose=True))
    print(f"[autotune] tuned {len(chosen)} (op, shape, dtype) queries"
          + (f"; cache -> {args.save}" if args.save else ""))
    return chosen


if __name__ == "__main__":
    main()
