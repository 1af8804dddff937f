"""Multi-pod dry-run: every (arch x input-shape x mesh) cell on a fake mesh.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell for 512 placeholder host devices. Here each cell builds
its program (``launch/programs.py``) under ``FakeTensorMode`` on PyTorch's
in-process ``fake`` process group of 256 (pod, (16, 16)) or 512 ranks
(multipod, (2, 16, 16)), runs it once on rank 0's fake shards (nothing is
allocated, no device is needed), and records per device:

* argument and output bytes, exact from the local shards;
* temporaries: the peak of the live storages the run makes
  (``CostMode``, under fake mode), less the outputs, for the program as it
  runs here: the ``eager`` impl (or ``--impl kernel``), fp32, no remat.
  ``MemTracker`` is not used: under fake mode it refuses inference (it
  hooks tensors that need no gradient) and microbatched steps;
* FLOPs (matmul FLOPs apart), bytes and collectives by kind
  (``launch/costs.py``), and the roofline terms on the H100's rates
  (``launch/roofline.py``);
* ``fits_80gb_hbm``: arguments + temporaries + outputs under 80 GB;
* the schedule-cache queries the dispatch layer made;
* on decode cells, the serving probe: a small engine run of the reduced
  config on the CPU, outside fake mode, with the mesh rules cleared.

The default impl is ``eager``, the counterpart of the reference's default
``xla``. A cell that fails (an op with no DTensor sharding strategy, or an
op whose kernel impl takes no DTensor yet) is recorded with
``status: "error"`` and the error, as the reference records its errors.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell writes ``<out>/<arch>__<shape>__<mesh>[__<mode>][__<tag>].json``,
``--out`` defaulting to ``results/dryrun_torch/`` (never the reference's
``results/dryrun/``); ``launch/report.py`` renders the tables.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.mesh import production_spec

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks (this process is rank 0),
    destroyed on exit; an initialized group of at least ``size`` ranks is
    used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < size:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"needs {size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _serving_probe(arch: str, formulation: str) -> dict:
    """A small deterministic engine run of the reduced config on the CPU
    (the reference's probe): the abstention and escalation counts the
    uncertainty router gives, comparable across PRs."""
    import torch

    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.nn import pjit_hints
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            RouterConfig, UncertaintyRouter,
                                            poisson_trace, run_load)

    # Widen the init posteriors (sigma 5e-2 against the paper's 1e-4) so
    # the probe's MI exercises the router's three bands.
    cfg = dataclasses.replace(reduced_config(arch), sigma_init=5e-2)
    if not cfg.embed_inputs:
        return {"status": "skipped",
                "reason": "frame-embedding frontend (no token prompts)"}
    try:
        pjit_hints.set_rules(None)
        router_cfg = RouterConfig(mi_continue=0.02, mi_abstain=0.5,
                                  escalate_samples=4)
        model = svi_to_pfp(lm.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
        engine = Engine(
            cfg, model,
            EngineConfig(slots=2, max_len=16, num_uncertainty_samples=16,
                         formulation=formulation, impl="eager", seed=0),
            router=UncertaintyRouter(cfg, router_cfg,
                                     formulation=formulation, impl="eager"),
            device="cpu")
        trace = poisson_trace(6, rate=0.7, vocab_size=cfg.vocab_size,
                              seed=0, prompt_len=(3, 6),
                              max_new_tokens=(2, 4))
        s = run_load(engine, trace, max_steps=500)
        return {"status": "ok",
                "router": {"mi_continue": router_cfg.mi_continue,
                           "mi_abstain": router_cfg.mi_abstain,
                           "escalate_samples": router_cfg.escalate_samples},
                "requests": s["submitted"], "completed": s["completed"],
                "abstained": s["abstained"],
                "escalations": s["escalations"],
                "tokens_generated": s["tokens_generated"],
                "abstain_rate": round(s["abstain_rate"], 4),
                "escalation_rate": round(s["escalation_rate"], 4),
                "final_occupancy": s["final_occupancy"]}
    except Exception as e:  # noqa: BLE001  (recorded in the cell's JSON)
        return {"status": "error", "error": f"{type(e).__name__}: {e}"}


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (modules,
    train states, dicts, NamedTuples, tuples)."""
    import torch

    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        return local.numel() * local.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def _measure(prog):
    """Run ``prog`` once under ``CostMode`` (inside fake mode). Returns
    (costs, output bytes, schedule queries)."""
    from repro_torch.launch.costs import CostMode
    from repro_torch.tuning import cache as schedule_cache

    cost = CostMode()
    with schedule_cache.record_shapes() as queries, cost:
        out = prog.fn(*prog.args)
    return cost.summary(), _local_bytes(out), queries


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             mode_override=None, save: bool = True, tag: str = "",
             formulation: str = "srm", serve_params: str = "auto",
             impl: str = "eager", out_dir: str = RESULTS_DIR,
             cfg=None, probe: bool = True) -> dict:
    """One cell; returns its record and, with ``save``, writes it under
    ``out_dir``. ``cfg`` replaces the arch's config (tests pass reduced
    ones; the record says so)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import pfp_math
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.programs import build_program, cell_is_applicable
    from repro_torch.nn import pjit_hints
    from repro_torch.tuning import cache as schedule_cache

    mesh_name = "multipod" if multi_pod else "pod"
    ok, why = cell_is_applicable(arch, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mode_override": mode_override, "tag": tag}
    if cfg is not None:
        result["config"] = dataclasses.asdict(cfg)
    if not ok:
        result.update(status="skipped", reason=why)
        print(f"[SKIP] {arch} x {shape_name} x {mesh_name}: {why}")
        return _save(result, out_dir) if save else result

    chips = production_spec(multi_pod).size
    t0 = time.time()
    # Tensors cached outside fake mode (the Gauss-Hermite nodes) cannot mix
    # with fake ones, nor fake ones with later real ones: drop them on
    # entry and on exit.
    pfp_math._gh_nodes.cache_clear()
    try:
        with fake_world(chips):
            # The mesh is made outside fake mode: it reads its rank map.
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            with FakeTensorMode():
                prog = build_program(arch, shape_name, mesh,
                                     mode_override=mode_override,
                                     formulation=formulation, impl=impl,
                                     serve_params=serve_params, cfg=cfg)
                t_build = time.time() - t0
                arg_bytes = _local_bytes(prog.args)
                cost, out_bytes, queries = _measure(prog)
                t_run = time.time() - t0 - t_build
        schedules = {}
        for op, shape_key, dtype, backend in queries:
            hit = schedule_cache.global_cache().get(op, shape_key, dtype,
                                                    backend)
            key = f"{op}|{'x'.join(map(str, shape_key))}|{dtype}"
            schedules[key] = hit.describe() if hit is not None else "default"
        # The run's peak of live storages holds temporaries and outputs.
        mem_info = {"argument_size_in_bytes": arg_bytes,
                    "output_size_in_bytes": out_bytes,
                    "temp_size_in_bytes": max(
                        int(cost["peak_bytes"]) - out_bytes, 0),
                    "temp_of": (f"the {prog.meta['impl']} impl as it runs "
                                "here, eager, no remat (CostMode's live "
                                "storages under fake mode)")}
        flops, bytes_ = cost["flops"], cost["bytes"]
        terms = roofline.roofline_terms(
            flops, bytes_, cost["collective_bytes_link"],
            collective_s=cost["collective_s"])
        shape_cfg = SHAPES[shape_name]
        mf = roofline.model_flops(prog.meta, shape_cfg.kind,
                                  shape_cfg.seq_len, shape_cfg.global_batch)
        hbm = arg_bytes + mem_info["temp_size_in_bytes"] + out_bytes
        result.update(
            status="ok", chips=chips, program=prog.name,
            impl=prog.meta["impl"], meta=prog.meta, schedules=schedules,
            lower_s=round(t_build, 2), compile_s=round(t_run, 2),
            flops_per_device=flops, bytes_per_device=bytes_,
            matmul_flops_per_device=cost["matmul_flops"],
            aten_ops=cost["ops"],
            collective_bytes=cost["collective_bytes"],
            collective_bytes_operand=cost["collective_bytes_operand"],
            collective_bytes_link=cost["collective_bytes_link"],
            collective_bytes_total=cost["collective_bytes_link"],
            memory_analysis=mem_info,
            model_flops_total=mf, model_flops_per_device=mf / chips,
            useful_flops_ratio=(mf / chips / flops) if flops else None,
            hbm_bytes_per_device=hbm, hbm_estimate=hbm,
            fits_80gb_hbm=bool(hbm < roofline.HBM_BYTES),
            rates={"peak_flops": roofline.PEAK_FLOPS,
                   "hbm_bw": roofline.HBM_BW,
                   "nvlink_bw": roofline.NVLINK_BW,
                   "node_bw": roofline.NODE_BW,
                   "card": "NVIDIA H100 80GB HBM3, 700 W (data sheet)"},
            **terms)
        print(f"[OK]  {prog.name} mesh={mesh_name} chips={chips} "
              f"build={t_build:.1f}s run={t_run:.1f}s "
              f"flops/dev={flops:.3e} bytes/dev={bytes_:.3e} "
              f"coll/dev={cost['collective_bytes_link']:.3e} "
              f"bottleneck={terms['bottleneck']} "
              f"hbm/dev={hbm / 1e9:.2f}GB fits={result['fits_80gb_hbm']}")
    except Exception as e:  # noqa: BLE001  (recorded, as the reference does)
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[ERR] {arch} x {shape_name} x {mesh_name}: "
              f"{type(e).__name__}: {str(e)[:300]}")
    finally:
        pjit_hints.set_rules(None)
        pfp_math._gh_nodes.cache_clear()
    if probe and SHAPES[shape_name].kind == "decode":
        result["serving"] = _serving_probe(arch, formulation)
        if result["serving"].get("status") == "ok":
            sv = result["serving"]
            print(f"      serving probe: {sv['completed']} completed, "
                  f"{sv['abstained']} abstained, "
                  f"{sv['escalations']} escalations")
    return _save(result, out_dir) if save else result


def _cost_guess(cell: dict) -> float:
    """A rough order of a cell's run time: layers, microbatches, ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.programs import num_microbatches

    cfg = get_config(cell["arch"])
    kind = SHAPES[cell["shape_name"]].kind
    micro = num_microbatches(cfg.param_count()) if kind == "train" else 1
    return cfg.num_layers * micro * (3 if kind == "train" else 1) * (
        2 if cell["multi_pod"] else 1)


def _cell_status(cell: dict) -> tuple:
    """Run one cell (``run_cell``'s keywords) on one thread (fake tensors
    compute nothing); (arch, shape, mesh, status)."""
    import torch

    torch.set_num_threads(1)
    r = run_cell(**cell)
    return r["arch"], r["shape"], r["mesh"], r["status"]


def _save(result: dict, out_dir: str = RESULTS_DIR) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    mode = result.get("mode_override") or ""
    tag = result.get("tag") or ""
    suffix = (f"__{mode}" if mode else "") + (f"__{tag}" if tag else "")
    path = os.path.join(
        out_dir,
        f"{result['arch']}__{result['shape']}__{result['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=str)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--mode", default=None,
                    help="override the program's mode (svi/pfp/"
                         "deterministic)")
    ap.add_argument("--tag", default="", help="result-file suffix")
    ap.add_argument("--formulation", default="srm", choices=["srm", "var"])
    ap.add_argument("--impl", default="eager", choices=["eager", "kernel"],
                    help="PFP operator implementation (core/dispatch.py)")
    ap.add_argument("--serve-params", default="auto",
                    choices=["auto", "tp", "fsdp"])
    ap.add_argument("--schedule-cache", default=None,
                    help="tuned-schedule cache JSON to load "
                         "(repro_torch.tuning)")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the cells' JSON files")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a fresh process")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if os.path.normpath(args.out).endswith(os.path.join("results",
                                                        "dryrun")):
        ap.error("results/dryrun/ holds the reference's cells: pick another "
                 "--out")
    if args.schedule_cache:
        from repro_torch.tuning import load_global_cache

        load_global_cache(args.schedule_cache)

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [dict(arch=arch, shape_name=shape, multi_pod=mp,
                  mode_override=args.mode, tag=args.tag,
                  formulation=args.formulation, impl=args.impl,
                  serve_params=args.serve_params, out_dir=args.out)
             for mp in meshes for arch in archs for shape in shapes]
    if args.jobs > 1:
        import multiprocessing

        cells.sort(key=_cost_guess, reverse=True)   # the longest start first
        with multiprocessing.get_context("spawn").Pool(
                args.jobs, maxtasksperchild=1) as pool:
            statuses = pool.map(_cell_status, cells, chunksize=1)
    else:
        statuses = [_cell_status(cell) for cell in cells]
    bad = [s for s in statuses if s[3] == "error"]
    print(f"\n== {len(statuses)} cells: "
          f"{sum(1 for s in statuses if s[3] == 'ok')} ok, "
          f"{sum(1 for s in statuses if s[3] == 'skipped')} skipped, "
          f"{len(bad)} errors ==")
    for b in bad:
        print("  ERROR:", b)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
