"""Time the serving engine's decode step from several checkouts of the port
on one card.

Each tree is timed in a child process of its own, which imports that
tree's package and builds (or loads) its kernels into the tree's own
``build/``: granite-8b at full width, cut to 2 of its 36 layers, random
variational weights drawn on the card from seed 0 and converted to PFP; the
paged engine (kernel impl, srm, 4 slots of 1024 rows, pages of 16) with 4
requests of 129-token prompts decoding together. After the prefill and
``WARM`` decode steps, ``STEPS`` decode-only steps are timed one by one
(CUDA-synced walls: median, p90, least), then torch.profiler over
``PROFILED`` more gives the device-busy ms and the device kernels a step,
and the host-side events a step by name (aten ops and CUDA runtime calls:
an extra ``cudaStreamSynchronize`` or copy shows there).
Where the tree's ``Engine`` takes ``mesh=``, the same is timed again on a
world-1 NCCL group's (1, 1) mesh. The tokens and MI every request was
served are hashed, so that the runs can be shown to serve one stream.
The parent prints, for each tree after the first, the host events off the
mesh whose count a step differs from the first tree's.

Usage, on the card, the trees in the order to run them (for an A/B
parent, change, change, parent)::

    python3 tools/engine_step_ab.py build/ab/parent build/ab/change \\
        build/ab/change build/ab/parent

A tree is a directory holding ``src/repro_torch`` (``git archive <rev> |
tar -x -C <dir>``). The rows go to stdout and to
``chiprun_out/engine_step_ab.json``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SLOTS, MAX_LEN, PAGE_SIZE, PROMPT = 4, 1024, 16, 129
WARM, STEPS, PROFILED = 5, 200, 10
ROUTER = dict(mi_continue=1e9, mi_abstain=2e9, escalate_samples=0)


def _engine(cfg, model, device, mesh):
    import inspect

    import numpy as np
    from repro_torch.serving.batcher import Request
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            RequestScheduler, RouterConfig,
                                            SchedulerConfig,
                                            UncertaintyRouter)
    kw = {} if mesh is None else {"mesh": mesh}
    if mesh is not None and "mesh" not in inspect.signature(Engine).parameters:
        return None
    eng = Engine(cfg, model, EngineConfig(
        slots=SLOTS, max_len=MAX_LEN, impl="kernel", formulation="srm",
        page_size=PAGE_SIZE),
        router=UncertaintyRouter(cfg, RouterConfig(**ROUTER),
                                 formulation="srm", impl="kernel"),
        scheduler=RequestScheduler(SchedulerConfig(prefill_chunk=128,
                                                   prefill_budget=512)),
        device=device, **kw)
    rng = np.random.default_rng(7)
    for uid in range(SLOTS):
        eng.submit(Request(
            uid=uid, arrival=0.0,
            prompt=rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32),
            max_new_tokens=WARM + STEPS + PROFILED + 8))
    return eng


def _time(eng):
    """Decode-only step walls and the profiler's device time a step."""
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    while eng.decoding < SLOTS:
        eng.step()
    for _ in range(WARM):
        eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            eng.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host = {e.key: e.count / PROFILED for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    served = sorted((s.request.uid, [int(t) for t in s.request.generated],
                     [float(m) for m in s.request.mi_trace])
                    for s in eng._slots if s is not None)
    walls.sort()
    return {"median_ms": walls[len(walls) // 2],
            "p90_ms": walls[int(0.9 * (len(walls) - 1))],
            "least_ms": walls[0],
            "busy_ms": sum(e.self_device_time_total
                           for e in kernels) / 1e3 / PROFILED,
            "kernels": sum(e.count for e in kernels) / PROFILED,
            "host_events": host,
            "served_sha256": hashlib.sha256(
                json.dumps(served).encode()).hexdigest()[:16]}


def child():
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2,
                              sigma_init=1e-3)
    variational = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    model = svi_to_pfp(variational, calibration_factor=0.4)
    del variational
    row = {"off": _time(_engine(cfg, model, device, None))}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        eng = _engine(cfg, model, device, mesh)
        if eng is not None:
            row["on"] = _time(eng)
    finally:
        dist.destroy_process_group()
    print("ROW " + json.dumps(row), flush=True)


def main(trees):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    rows = []
    for tree in trees:
        tree = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child"], cwd=str(tree), env=env,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("ROW ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        row = {"tree": str(tree.relative_to(ROOT)
                           if tree.is_relative_to(ROOT) else tree),
               **json.loads(lines[-1][4:])}
        rows.append(row)
        for where in ("off", "on"):
            if where in row:
                r = row[where]
                print(f"{row['tree']:24s} {where:3s} the mesh: step median "
                      f"{r['median_ms']:.3f} ms, p90 {r['p90_ms']:.3f}, "
                      f"least {r['least_ms']:.3f}; device busy "
                      f"{r['busy_ms']:.3f} ms, {r['kernels']:.1f} kernels a "
                      f"step; served {r['served_sha256']}", flush=True)
    first = rows[0]["off"]["host_events"]
    for row in rows[1:]:
        got = row["off"]["host_events"]
        diff = {k: (first.get(k, 0), got.get(k, 0))
                for k in set(first) | set(got)
                if first.get(k, 0) != got.get(k, 0)}
        print(f"{row['tree']}: host events a step off the mesh that differ "
              f"from {rows[0]['tree']}'s: "
              + (", ".join(f"{k} {a:g} -> {b:g}"
                           for k, (a, b) in sorted(diff.items())) or "none"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "engine_step_ab.json").write_text(json.dumps(
        {"card": card.strip(), "rows": rows}, indent=1))


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        main(sys.argv[1:])
