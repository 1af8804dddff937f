#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check every kernel on it.

    python3 chip_smoke.py          # from the repo root; builds on first use

Phases, each printing its own lines; any failure exits non-zero:

  1. card   : nvidia-smi name and power limit, torch and CUDA versions
  2. build  : nvcc builds src/repro_torch/csrc/*.cu for sm_90a
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
              at the main-path shapes (batch 100) and ragged ones, plus the
              Eq. 12 cancellation check against an fp64 plain version
  4. serving: LeNet-5 and MLP at full width (random weights from a seed,
              sigma_init 1e-3, converted with calibration factor 0.4) answer
              Dirty-MNIST batches of 100 per split with impl="kernel"; the
              logits are held against impl="eager" on the card, and every
              kernel must have launched during this phase
  5. times  : device times (CUDA graph replays between CUDA events) of
              each kernel at batch 10, 100 and 1024 beside its plain
              version, a one-call PyTorch yardstick and its bound, plus
              its time per eager call; whole-model forwards, eager and
              captured in a CUDA graph
  6. profile: torch.profiler over each model's forwards at each batch:
              device busy share and the kernels that take the device time

Then one JSON line of per-kernel numbers, the card's name and power limit,
and a last JSON line ``{"ok": true, "device": {...}}``. Full numbers go to
chiprun_out/chip_smoke.json.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 SIMT flop/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
DENSE_TOL = dict(rtol=1e-5, atol=1e-4)       # tests/test_kernels.py
ELEMENTWISE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(mean=(1e-3, 1e-4), var=(1e-2, 1e-5))  # test_impl_dispatch.py
BATCHES = (10, 100, 1024)
MAIN_BATCH = 100
CALIBRATION = 0.4
# Approximate fp32 operations per element (erf and exp counted as one each).
RELU_OPS = 20
POOL_OPS_PER_OUTPUT = 75

KERNELS = {
    "dense": ("src/repro_torch/csrc/pfp_dense.cu",
              "src/repro/kernels/pfp_dense.py:246"),
    "dense_first_layer": ("src/repro_torch/csrc/pfp_dense.cu",
                          "src/repro/kernels/pfp_dense.py:246"),
    "dense_var": ("src/repro_torch/csrc/pfp_dense.cu",
                  "src/repro/kernels/pfp_dense.py:323"),
    "activation": ("src/repro_torch/csrc/pfp_activations.cu",
                   "src/repro/kernels/pfp_activations.py:101"),
    "maxpool2d": ("src/repro_torch/csrc/pfp_maxpool.cu",
                  "src/repro/kernels/pfp_maxpool.py:59"),
}


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# Main-path calls: (kernel, shape) per forward
# ---------------------------------------------------------------------------
def main_path_calls(batch, formulation="srm"):
    """Every kernel call of one LeNet-5 and one MLP PFP forward at ``batch``.
    Dense shapes are (M, K, N); activation and pool shapes the tensor's."""
    dense = "dense" if formulation == "srm" else "dense_var"
    b = batch
    return [
        # LeNet-5
        ("dense_first_layer", (784 * b, 25, 6)),
        ("activation", (b, 28, 28, 6)),
        ("maxpool2d", (b, 28, 28, 6)),
        (dense, (196 * b, 150, 16)),
        ("activation", (b, 14, 14, 16)),
        ("maxpool2d", (b, 14, 14, 16)),
        (dense, (b, 784, 120)),
        ("activation", (b, 120)),
        (dense, (b, 120, 84)),
        ("activation", (b, 84)),
        (dense, (b, 84, 10)),
        # MLP
        ("dense_first_layer", (b, 784, 100)),
        ("activation", (b, 100)),
        (dense, (b, 100, 100)),
        ("activation", (b, 100)),
        (dense, (b, 100, 10)),
    ]


def work(kernel, shape):
    """(bytes, fp32 operations) the function needs: each input read once,
    each output written once."""
    if kernel.startswith("dense"):
        m, k, n = shape
        if kernel == "dense_first_layer":
            return 4 * (m * k + 2 * k * n + 2 * m * n), 4 * m * n * k + m * k
        products = 3 if kernel == "dense" else 4
        return (4 * (2 * m * k + 2 * k * n + 2 * m * n),
                2 * products * m * n * k + m * k + k * n + m * n)
    numel = 1
    for d in shape:
        numel *= d
    if kernel == "activation":
        return 16 * numel, RELU_OPS * numel
    out = numel // 4
    return 4 * (2 * numel + 2 * out), POOL_OPS_PER_OUTPUT * out


def bound_ms(kernel, shape):
    nbytes, ops = work(kernel, shape)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def gaussian(shape, seed, device, scale=1.0):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    mu = scale * torch.randn(shape, generator=g)
    var = scale * torch.nn.functional.softplus(torch.randn(shape, generator=g))
    return mu.to(device), var.to(device)


def operands(kernel, shape, seed, device):
    """Kernel arguments on ``device`` for one call."""
    if kernel.startswith("dense"):
        m, k, n = shape
        mx, vx = gaussian((m, k), seed, device)
        mw, vw = gaussian((k, n), seed + 1, device, 0.1)
        if kernel == "dense":
            return (mx, vx + mx * mx, mw, vw + mw * mw)
        if kernel == "dense_var":
            return (mx, vx, mw, vw)
        return (mx, mx, mw, vw)
    return gaussian(shape, seed, device)


def run_kernel(kernel, args):
    from repro_torch.kernels import ops
    if kernel == "dense":
        return ops.pfp_dense(*args)
    if kernel == "dense_first_layer":
        return ops.pfp_dense(*args, first_layer=True)
    if kernel == "dense_var":
        return ops.pfp_dense_var(*args)
    if kernel == "activation":
        return ops.pfp_activation(*args, kind="relu")
    return ops.pfp_maxpool2d(*args)


def run_plain(kernel, args):
    from repro_torch.kernels import ref
    if kernel == "dense":
        return ref.pfp_dense_ref(*args)
    if kernel == "dense_first_layer":
        return ref.pfp_dense_first_layer_ref(args[0], args[2], args[3])
    if kernel == "dense_var":
        return ref.pfp_dense_var_ref(*args)
    if kernel == "activation":
        return ref.pfp_relu_ref(*args)
    return ref.pfp_maxpool2d_ref(*args)


def library_call(kernel, args):
    """One PyTorch call computing the same products, or None. For the dense
    kernels: one fp32 torch.bmm (TF32 off) over the stacked operand pairs of
    the formulation, without the final elementwise combine."""
    import torch
    if not kernel.startswith("dense"):
        return None
    xa, xb, wa, wb = args
    if kernel == "dense":
        a = torch.stack([xa, xb, xa * xa])
        b = torch.stack([wa, wb, wa * wa])
    elif kernel == "dense_var":
        a = torch.stack([xa, xb, xa * xa, xb])
        b = torch.stack([wa, wa * wa, wb, wb])
    else:
        a = torch.stack([xa, xa * xa])
        b = torch.stack([wa, wb])
    return lambda: torch.bmm(a, b)


def time_ms(fn, iters=30, warmup=3):
    """Mean time per call over ``iters`` back-to-back calls (CUDA events).
    Where the host issues calls more slowly than the device runs them,
    this is the host's time per call."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inner=10, replays=5):
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so no host work sits
    between the launches. Inputs stay where the previous call left them
    (in L2 when they fit), as between the layers of one forward."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * inner)
    del graph
    return ms


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the port must run IEEE fp32")
    return card


def phase_build():
    from repro_torch.kernels import _build
    _build.load()
    info = _build.BUILD_INFO
    print(f"[build] {'built' if info['built'] else 'loaded'} "
          f"{info['directory']} in {info['seconds']:.1f} s")
    log = (Path(info["directory"]) / "ptxas.log").read_text()
    (OUT_DIR / "ptxas.log").write_text(log)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    if not regs:
        fail("ptxas reported no kernels")
    print(f"[build] {len(regs)} kernels, {min(regs)}-{max(regs)} registers "
          f"per thread, {spills} bytes of spill stores in all "
          f"(chiprun_out/ptxas.log)")
    return info


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _check_close(name, got, want, tol):
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                 f"non-finite output")
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: max abs err {float((g - w).abs().max()):.3e} "
                 f"outside {tol}")


def phase_kernels(device):
    """Each kernel against its plain version; returns max abs err per kernel."""
    import torch
    from repro_torch.kernels import ops, ref
    errs = {k: 0.0 for k in KERNELS}
    cases = sorted(set(main_path_calls(MAIN_BATCH, "srm")
                       + main_path_calls(MAIN_BATCH, "var")))
    cases += [("dense", (33, 100, 53)), ("dense_first_layer", (7, 25, 6)),
              ("dense_var", (33, 100, 53)), ("activation", (3, 37, 70)),
              ("maxpool2d", (2, 6, 10, 5)), ("dense", (1, 784, 100)),
              ("dense_var", (1, 1, 1))]
    for i, (kernel, shape) in enumerate(cases):
        args = operands(kernel, shape, 100 + i, device)
        got = run_kernel(kernel, args)
        torch.cuda.synchronize()
        want = run_plain(kernel, args)
        tol = DENSE_TOL if kernel.startswith("dense") else ELEMENTWISE_TOL
        _check_close(f"{kernel}{shape}", got, want, tol)
        err = _max_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        print(f"[kernels] {kernel:18s} {str(shape):20s} max_abs_err {err:.3e}")
    # The Gauss-Hermite kinds share the activation kernel (not on the main
    # path of these models, checked all the same).
    mu, var = gaussian((100, 14, 14, 16), 7, device)
    var[0] = 0.0
    for kind in ("relu", "gelu", "silu", "tanh", "sigmoid"):
        got = ops.pfp_activation(mu, var, kind=kind)
        torch.cuda.synchronize()
        want = ref.pfp_activation_ref(mu, var, kind)
        _check_close(f"activation[{kind}]", got, want, ELEMENTWISE_TOL)
        print(f"[kernels] activation[{kind:7s}] max_abs_err "
              f"{_max_err(got, want):.3e}")
    cancellation_check(device)
    return errs


def cancellation_check(device):
    """Eq. 12 with srm ~= mu^2: the variance is a small difference of two
    large sums. The kernel's error against an fp64 version must be no worse
    than 4x the fp32 plain version's (TF32 would be ~1000x worse)."""
    import torch
    from repro_torch.kernels import ops, ref
    for m, k, n in ((100, 784, 100), (19600, 150, 16)):
        g = torch.Generator(device="cpu").manual_seed(m + k + n)
        mx = torch.relu(torch.randn((m, k), generator=g)) + 0.1
        mw = 0.05 * torch.randn((k, n), generator=g)
        sx = mx * mx + 1e-6 * torch.rand((m, k), generator=g)
        sw = mw * mw + 4e-7                       # sigma_init 1e-3, cal 0.4
        mx, mw, sx, sw = (a.to(device) for a in (mx, mw, sx, sw))
        _, var_k = ops.pfp_dense(mx, sx, mw, sw)
        _, var_p = ref.pfp_dense_ref(mx, sx, mw, sw)
        d = [a.double() for a in (mx, sx, mw, sw)]
        var_64 = d[1] @ d[3] - (d[0] * d[0]) @ (d[2] * d[2])
        torch.cuda.synchronize()
        err_k = float((var_k.double() - var_64).abs().max())
        err_p = float((var_p.double() - var_64).abs().max())
        scale = float(var_64.abs().max())
        print(f"[kernels] eq12 cancellation {(m, k, n)}: max var {scale:.3e}, "
              f"kernel err {err_k:.3e}, fp32 plain err {err_p:.3e}")
        if err_k > 4 * max(err_p, 1e-12):
            fail(f"Eq. 12 cancellation at {(m, k, n)}: kernel err {err_k:.3e} "
                 f"> 4 x plain err {err_p:.3e}")


def _models(device):
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.models.simple import MLP, LeNet5
    models = {}
    for name, cls in (("lenet5", LeNet5), ("mlp", MLP)):
        model = cls(sigma_init=1e-3, generator=torch.Generator().manual_seed(0),
                    device=device)
        models[name] = svi_to_pfp(model, calibration_factor=CALIBRATION)
    return models


def _requests(name, split_images):
    x = split_images
    return x[..., None] if name == "lenet5" else x.reshape(len(x), -1)


def phase_serving(device):
    """The main path: PFP forward with the kernels, Eq. 1-3, AUROC."""
    import torch
    from repro_torch.bayes import metrics
    from repro_torch.core.modes import Mode
    from repro_torch.data.dirty_mnist import dirty_mnist
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.nn.module import Context

    models = _models(device)
    _, evals = dirty_mnist(n_train=2, n_eval=MAIN_BATCH, seed=0)
    splits = {s: evals[s][0] for s in ("clean", "ambiguous", "ood")}
    outs = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    for name, model in models.items():
        for formulation in ("srm", "var"):
            ctx = Context(mode=Mode.PFP, impl="kernel", formulation=formulation,
                          device=device)
            for split, imgs in splits.items():
                if formulation == "var" and split != "clean":
                    continue  # one Eq. 7 pass per model is enough to run it
                out = model(_requests(name, imgs), ctx)
                outs[(name, formulation, split)] = out
                if formulation == "srm":
                    gen = torch.Generator(device=device).manual_seed(1)
                    outs[(name, "metrics", split)] = \
                        metrics.pfp_predictive_metrics(gen, out.mean, out.var,
                                                       100)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"[serving] main path: {len(outs)} results in {seconds:.3f} s "
          f"(first calls included); launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    for name, model in models.items():
        for formulation in ("srm", "var"):
            out = outs[(name, formulation, "clean")]
            ctx = Context(mode=Mode.PFP, impl="eager", formulation=formulation,
                          device=device)
            ref_out = model(_requests(name, splits["clean"]), ctx)
            for part in ("mean", "var"):
                got, want = getattr(out, part), getattr(ref_out, part)
                rtol, atol = MODEL_TOL[part]
                if tuple(got.shape) != (MAIN_BATCH, 10) or \
                        not torch.isfinite(got).all():
                    fail(f"{name}/{formulation} {part}: bad logits")
                if not torch.allclose(got, want, rtol=rtol, atol=atol):
                    fail(f"{name}/{formulation} {part} kernel vs eager: max "
                         f"abs err {float((got - want).abs().max()):.3e}")
            if float(out.var.min()) <= 0:
                fail(f"{name}/{formulation}: non-positive logit variance")
            err_m = float((out.mean - ref_out.mean).abs().max())
            err_v = float((out.var - ref_out.var).abs().max())
            print(f"[serving] {name} {formulation}: kernel vs eager logits "
                  f"max abs err mean {err_m:.3e} var {err_v:.3e}")
        mi = {s: outs[(name, "metrics", s)]["mi"] for s in splits}
        auc = metrics.auroc(mi["ood"], mi["clean"])
        print(f"[serving] {name} (untrained random weights, sigma_init 1e-3, "
              f"cal {CALIBRATION}): mean MI " + ", ".join(
                  f"{s} {float(v.mean()):.4e}" for s, v in mi.items())
              + f"; MI-AUROC ood vs clean {auc:.4f}")
    return launches


def phase_times(device):
    """Per-(kernel, shape) times at each batch, and whole-model forwards.

    ``ms``, ``plain_ms`` and ``library_ms`` are device times (CUDA graph
    replays); ``call_ms`` is the kernel's time per eager call, host work
    included."""
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.nn.module import Context
    rows = []
    for batch in BATCHES:
        seen = set()
        for formulation in ("srm", "var"):
            for kernel, shape in main_path_calls(batch, formulation):
                if (kernel, shape) in seen:
                    continue
                seen.add((kernel, shape))
                args = operands(kernel, shape, 1, device)
                lib = library_call(kernel, args)
                row = {
                    "batch": batch, "kernel": kernel, "shape": list(shape),
                    "ms": device_ms(lambda: run_kernel(kernel, args)),
                    "plain_ms": device_ms(lambda: run_plain(kernel, args)),
                    "library_ms": device_ms(lib) if lib else None,
                    "call_ms": time_ms(lambda: run_kernel(kernel, args)),
                }
                row["bound_ms"], row["bound_by"] = bound_ms(kernel, shape)
                rows.append(row)
                lib_s = "-" if lib is None else f"{row['library_ms']:.4f}"
                print(f"[times] B={batch:<5d} {kernel:18s} "
                      f"{str(shape):20s} kernel {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f}  library {lib_s}  bound "
                      f"{row['bound_ms']:.5f} ({row['bound_by']})  "
                      f"eager call {row['call_ms']:.4f}")
                del args, lib
    models = _models(device)
    forwards = []
    for batch in BATCHES:
        x = torch.rand((batch, 28, 28), generator=torch.Generator()
                       .manual_seed(batch)).to(device)
        for name, model in models.items():
            xin = _requests(name, x)
            row = {"batch": batch, "model": name}
            for impl in ("kernel", "eager"):
                ctx = Context(mode=Mode.PFP, impl=impl, device=device)
                row[f"{impl}_ms"] = time_ms(lambda: model(xin, ctx), iters=20)
            ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
            row["kernel_graph_ms"] = device_ms(lambda: model(xin, ctx))
            forwards.append(row)
            print(f"[times] forward {name:6s} B={batch:<5d} kernel "
                  f"{row['kernel_ms']:.4f} ms  eager {row['eager_ms']:.4f} ms"
                  f"  kernel in a CUDA graph {row['kernel_graph_ms']:.4f} ms")
    return rows, forwards


def phase_profile(device, reps=10):
    """torch.profiler over ``reps`` kernel-impl forwards of each model at
    each batch: device busy share and the kernels that take the device
    time. The wall time includes the profiler's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.modes import Mode
    from repro_torch.nn.module import Context
    models = _models(device)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    out = []
    for batch in BATCHES:
        x = torch.rand((batch, 28, 28), generator=torch.Generator()
                       .manual_seed(3)).to(device)
        for name, model in models.items():
            xin = _requests(name, x)
            for _ in range(3):
                model(xin, ctx)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    model(xin, ctx)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            if busy_ms == 0:
                print("[profile] the profiler saw no device time")
                return []
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
            out.append({"model": name, "batch": batch,
                        "wall_ms": wall_ms / reps, "busy_ms": busy_ms / reps,
                        "top": [(e.key, e.self_device_time_total / 1e3 / reps,
                                 e.count // reps) for e in top]})
            print(f"[profile] {name:6s} B={batch:<5d} {reps} forwards: wall "
                  f"{wall_ms / reps:.4f} ms, device busy "
                  f"{busy_ms / reps:.4f} ms per forward "
                  f"({100 * busy_ms / wall_ms:.1f}% busy)")
            for e in top[:3]:
                print(f"[profile]   {e.self_device_time_total / 1e3 / reps:8.4f}"
                      f" ms x{e.count // reps:<3d} {e.key[:80]}")
    return out


def kernel_summary(rows, launches, errs):
    """Per kernel: its main-path calls at batch 100, times and bounds summed
    over one LeNet-5 and one MLP forward (Eq. 12 forwards; Eq. 7 for
    dense_var)."""
    by_key = {(r["kernel"], tuple(r["shape"])): r for r in rows
              if r["batch"] == MAIN_BATCH}
    out = []
    for kernel, (source, replaces) in KERNELS.items():
        formulation = "var" if kernel == "dense_var" else "srm"
        calls = [by_key[(k, s)] for k, s in
                 main_path_calls(MAIN_BATCH, formulation) if k == kernel]
        t_bytes = t_ops = 0.0
        for r in calls:
            nbytes, ops = work(kernel, tuple(r["shape"]))
            t_bytes += nbytes / PEAK_BYTES * 1e3
            t_ops += ops / PEAK_FP32 * 1e3
        lib = [r["library_ms"] for r in calls]
        out.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": errs[kernel],
            "ms": sum(r["ms"] for r in calls),
            "plain_ms": sum(r["plain_ms"] for r in calls),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
        })
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets IEEE fp32 for cuBLAS and cuDNN)
    OUT_DIR.mkdir(exist_ok=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    card = phase_card()
    build = phase_build()
    errs = phase_kernels(device)
    launches = phase_serving(device)
    rows, forwards = phase_times(device)
    profile = phase_profile(device)
    kernels = kernel_summary(rows, launches, errs)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "kernels": kernels, "times": rows,
         "forwards": forwards, "profile": profile,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
