"""Time the same kernel calls from several checkouts of the port on one card.

Compares two trees of ``src/repro_torch`` (for example a change and its
parent) in one run, so that both see the same card, clocks and power
limit. Each tree is timed in a child process of its own, which imports
that tree's package, builds its kernels into the tree's own ``build/``
and times, with CUDA events around a CUDA graph of ``INNER`` calls
(``ACT_INNER`` for rows 3 and 4; median of ``REPLAYS`` replays):

  * rows 6 and 7, the norm kernels (``ACT_INNER`` calls a graph): RMSNorm
    at granite-8b's forward (2048, 4096) and 4-slot decode (4, 4096) and
    at deepseek-moe-16b's decode (4, 2048), LayerNorm at musicgen-medium's
    forward (2048, 1536) and decode (4, 1536), each on VAR and on SRM
    input; and row 8's norm pass, the device time torch.profiler gives
    ``pfp_norm_srm_kernel`` in the fused unit at the gate and decode
    shapes, beside the fused unit and its unfused chain at the tile the
    chain's dense runs, and the dense kernel at the gate on the norm
    kernel's and on the plain version's output (whether the dense's time
    follows its operands' bits); each call's outputs are hashed into the
    digests;
  * ``dense``: the Eq. 12 dense kernel at the gate projection
    (2048, 4096, 14336);
  * where the tree has the fused unit: ``norm_dense_act`` at the gate
    projection and at a 4-slot decode step (4, 4096, 14336), rmsnorm and
    silu, at every instantiated tile, and the unfused kernel chain it
    replaces at both shapes; each tree's fastest tile is set beside its
    chain;
  * the dense kernel at every dense shape of LeNet-5 and the MLP at batch
    100, in its three modes (Eq. 12, Eq. 13, Eq. 7), and at granite-8b's
    decode shapes (4, K, N);
  * the batched expert kernel at deepseek-moe-16b's decode shape
    (64, 6, 2048, 1408), with every row of every expert, and (where the
    tree takes ``rows=``) with 24 experts holding one row each, as a
    4-slot top-6 step at most fills; each call's outputs are hashed into
    the digests;
  * the large regime, Eq. 12 and Eq. 7: the dense kernel at granite-8b's
    five forward shapes at M 2048 (4 x 512 tokens) and at its paged
    prefill's chunks of 128 rows, and the batched kernel at
    deepseek-moe-16b's two forward shapes (64, 240, 2048, 1408) and
    (64, 240, 1408, 2048), also with kept-row counts of every row where
    the tree takes them; each call's outputs are hashed (``digests``),
    so that two trees can be shown bit for bit equal;
  * rows 10 and 11, the cache and the paged attention kernel (pages of 16
    rows), at granite-8b's and deepseek-moe-16b's 4-slot decode (kv_len
    1 / 341 / 682 / 1024 of 1024), one slot and 32 slots at 1024, a
    4 x 512 prefill (q_start 0 / 256 / 0 / 256) and a 128-row chunk of one
    slot at q_start 384; each hot (the same operands every call) and
    L2-cold (a graph that cycles through ``COLD_COPIES`` or more copies of
    the operands, over ``COLD_BYTES`` in all), with the plan where the
    tree has one, and row 9 (no cache) at granite's prefill; each call's
    outputs are hashed into the digests;
  * rows 3 and 4, the activation and the max-pool kernels: relu at the
    six activation shapes of LeNet-5 and the MLP, the pool at LeNet-5's
    two pool shapes, each at batch 10, 100 and 1024, and silu at
    granite-8b's (2048, 14336); the pool on VAR input and on SRM input,
    where the tree takes it (``rep=``), else as the CNN path ran it then
    (``to_var()``'s two launches and the pool); each call's outputs are
    hashed into the digests; row 5, the GLU product at granite-8b's
    (2048, 14336), hashed too; and, where the tree has it, the empty
    kernel (``csrc/pfp_floor.cu``): the floor no launch goes under;
  * LeNet-5 and the MLP forwards (batch 10, 100, 1024) in a CUDA graph,
    each with the device kernels one forward launches (torch.profiler),
    and one 4-slot decode step of granite-8b (2 layers) and of
    deepseek-moe-16b (3 layers) at full width, eager, with random
    weights from a seed: ms per step, the median and the least of
    ``STEP_BLOCKS`` blocks of 10 steps (CUDA events around each block),
    and the device-busy ms per step that torch.profiler sees over 10 more;
    and the device-busy ms of one granite-8b forward of 4 x 512 tokens.

Each child also reports which fused calls are not bit for bit the
unfused chain's, and ptxas' register count and spill stores of every
instantiation of the norm, fused and dense kernels (from the build's
``ptxas.log``). The parent prints which digests differ between the
trees, and whether those of rows 1, 2, 5 and 9-13 (every digest but
those of rows 3 and 4 and of the norms, rows 6-8) are equal in all.

Usage, on the card: give the trees in the order to run them, for an A/B
parent, change, change, parent::

    python3 tools/ab_kernel_times.py build/ab/parent build/ab/change \\
        build/ab/change build/ab/parent

``--only attention`` times rows 9-11 and the two decode steps alone;
``--only act_pool`` rows 3 and 4, the floor and the CNN forwards;
``--only norms`` rows 6-8 and the floor (about a minute a tree).

A tree is a directory holding ``src/repro_torch`` (``git archive <rev>
src/repro_torch | tar -x -C <dir>``). The rows go to stdout and, in full,
to ``chiprun_out/ab_kernel_times.json``; the digests that differ between
trees are listed last.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import _profile, ptxas_registers  # noqa: E402
INNER, REPLAYS = 5, 5
# Rows 3 and 4 and the empty kernel: a few microseconds a call, so more
# calls a graph, which spreads each replay's own launch over them.
ACT_INNER = 40
STEP_BLOCKS = 5   # blocks of 10 eager decode steps, each timed alone
NORM_SHAPE = (2048, 4096)
GATE, DECODE = (2048, 4096, 14336), (4, 4096, 14336)
# (M, K, N) of the paper's dense layers at batch 100.
CNN_DENSE = ((78400, 25, 6), (19600, 150, 16), (100, 784, 120),
             (100, 120, 84), (100, 84, 10), (100, 784, 100), (100, 100, 100),
             (100, 100, 10))
LM_DECODE = ((4, 4096, 4096), (4, 4096, 1024), (4, 4096, 14336),
             (4, 14336, 4096), (4, 4096, 49152))
MOE_FORWARD, MOE_DECODE = (64, 240, 2048, 1408), (64, 6, 2048, 1408)
MODES = ("srm", "first", "var")
# The large regime: granite-8b's forward (4 x 512 tokens) and paged
# prefill chunks, (M, K, N); deepseek-moe-16b's expert products at 4 x 512
# tokens, (E, C, K, N).
LM_FORWARD = ((2048, 4096, 4096), (2048, 4096, 1024), (2048, 4096, 14336),
              (2048, 14336, 4096), (2048, 4096, 49152))
LM_CHUNK = tuple((128, k, n) for _, k, n in LM_FORWARD)
MOE_LARGE = (MOE_FORWARD, (64, 240, 1408, 2048))
LARGE_MODES = ("srm", "var")
REG_KERNELS = ("pfp_norm_kernel", "pfp_norm_dense_act_kernel",
               "pfp_norm_srm_kernel", "pfp_dense_ring_kernel",
               "pfp_attention_kernel", "pfp_attention_kv_kernel")
# Rows 10 and 11: (B, H, Hkv, Tq, S, D, q_start, kv_len) by name.
DECODE_STARTS, DECODE_LENS = (0, 340, 681, 1023), (1, 341, 682, 1024)
ATTENTION = {
    "granite decode": (4, 32, 8, 1, 1024, 128, DECODE_STARTS, DECODE_LENS),
    "deepseek decode": (4, 16, 16, 1, 1024, 128, DECODE_STARTS,
                        DECODE_LENS),
    "granite 1 slot": (1, 32, 8, 1, 1024, 128, (1023,), (1024,)),
    "granite 32 slots": (32, 32, 8, 1, 1024, 128, (1023,) * 32,
                         (1024,) * 32),
    "granite prefill": (4, 32, 8, 512, 1024, 128, (0, 256, 0, 256),
                        (512, 768, 512, 768)),
    "granite chunk": (1, 32, 8, 128, 1024, 128, (384,), (512,)),
}
PAGE = 16
# Rows 3 and 4 at LeNet-5's and the MLP's shapes, (B, ...) at each batch;
# granite-8b's silu.
CNN_BATCHES = (10, 100, 1024)
ACT_SHAPES = ((28, 28, 6), (14, 14, 16), (120,), (84,), (100,))
POOL_SHAPES = ((28, 28, 6), (14, 14, 16))
LM_SILU = (2048, 14336)
# Rows 6 and 7: (rows, width) of each norm's forward and decode calls.
NORM_SHAPES = {"rmsnorm": ((2048, 4096), (4, 4096), (4, 2048)),
               "layernorm": ((2048, 1536), (4, 1536))}
COLD_COPIES, COLD_BYTES = 4, 100e6
ROW9 = (4, 32, 8, 512, 128)   # (B, H, Hkv, T, D), causal


def _device_ms(fn, inner=INNER):
    """Median ms per call of ``fn`` over REPLAYS replays of a CUDA graph of
    ``inner`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def _registers(ptxas_log):
    """{kernel: {template arguments: registers, or [registers, spill
    store bytes] where it spills}} for REG_KERNELS."""
    return {name: {args: [regs, spill] if spill else regs
                   for args, (regs, spill) in
                   ptxas_registers(ptxas_log, name).items()}
            for name in REG_KERNELS}


def _digest(tensors):
    h = hashlib.blake2b(digest_size=8)
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _dense(ops, mode, *args):
    if mode == "var":
        return ops.pfp_dense_var(*args)
    return ops.pfp_dense(*args, first_layer=mode == "first")


def _small_regime(ops, draw):
    """The dense kernel at the paper's shapes and at decode shapes, and
    the batched kernel at the MoE decode shape: (times, digests)."""
    import inspect

    import torch
    rows, digests = {}, {}

    def timed(name, fn):
        rows[name] = _device_ms(fn)
        digests[name] = _digest(fn())

    for m, k, n in CNN_DENSE:
        xa, xb = draw(m, k), draw(m, k).abs()
        wa, wb = draw(k, n, scale=0.1), draw(k, n, scale=0.1).abs()
        for mode in MODES:
            timed(f"dense {mode} {(m, k, n)}",
                  lambda: _dense(ops, mode, xa, xb, wa, wb))
    for m, k, n in LM_DECODE:
        xa, xb = draw(m, k), draw(m, k).abs()
        wa, wb = draw(k, n, scale=0.1), draw(k, n, scale=0.1).abs()
        timed(f"dense srm {(m, k, n)}", lambda: ops.pfp_dense(xa, xb, wa, wb))
    del xa, xb, wa, wb
    e, c, k, n = MOE_DECODE
    xa, xb = draw(e, c, k), draw(e, c, k).abs()
    wa, wb = draw(e, k, n, scale=0.1), draw(e, k, n, scale=0.1).abs()
    timed(f"dense_batched {MOE_DECODE}",
          lambda: ops.pfp_dense_batched(xa, xb, wa, wb))
    if "rows" in inspect.signature(ops.pfp_dense_batched).parameters:
        held = torch.zeros(e, dtype=torch.int32, device=xa.device)
        held[::e // 24][:24] = 1        # 24 experts, one row each
        keep = (torch.arange(c, device=xa.device)[None, :, None]
                < held[:, None, None])
        xa, xb = torch.where(keep, xa, 0.0), torch.where(keep, xb, 0.0)
        timed(f"dense_batched {MOE_DECODE} 24 experts",
              lambda: ops.pfp_dense_batched(xa, xb, wa, wb, rows=held))
    return rows, digests


def _large_regime(ops, dev):
    """The large regime's calls in Eq. 12 and Eq. 7: (times, digests).
    Operands come from a generator seeded by the shape, so every tree sees
    the same ones. Where the tree takes kept-row counts, the batched
    calls are also timed with every row kept."""
    import inspect

    import torch
    rows, digests = {}, {}
    for shape in LM_FORWARD + LM_CHUNK + MOE_LARGE:
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        *lead, k, n = shape

        def draw(*dims, scale=1.0):
            return scale * torch.randn(dims, generator=g, device=dev)

        xa, xb = draw(*lead, k), draw(*lead, k).abs()
        wa = draw(*lead[:-1], k, n, scale=0.1)
        wb = draw(*lead[:-1], k, n, scale=0.1).abs()
        for mode in LARGE_MODES:
            if len(shape) == 4:
                fn = (ops.pfp_dense_batched_var if mode == "var"
                      else ops.pfp_dense_batched)
            else:
                fn = ops.pfp_dense_var if mode == "var" else ops.pfp_dense
            name = f"large {mode} {shape}"
            rows[name] = _device_ms(lambda: fn(xa, xb, wa, wb))
            digests[name] = _digest(fn(xa, xb, wa, wb))
            if len(shape) == 4 and "rows" in inspect.signature(
                    fn).parameters:
                # Every row kept: what reading the counts costs.
                full = torch.full(lead[:1], lead[1], dtype=torch.int32,
                                  device=dev)
                rows[name + " rows"] = _device_ms(
                    lambda: fn(xa, xb, wa, wb, rows=full))
        del xa, xb, wa, wb
        torch.cuda.empty_cache()
    return rows, digests


def _attention(ops, dev):
    """Rows 9-11: (times, digests, plans). Rows 10 and 11 hot and L2-cold;
    operands from a generator seeded by the shape's name, so every tree
    sees the same ones."""
    import torch
    rows, digests, plans = {}, {}, {}
    try:
        from repro_torch.kernels.pfp_attention import attention_plan
    except ImportError:   # a tree from before the plan
        attention_plan = None
    for name, (b, h, hkv, tq, s, d, starts, lens) in ATTENTION.items():
        g = torch.Generator(device=dev).manual_seed(len(name) * 1000 + b)

        def draw(*dims):
            return torch.randn(dims, generator=g, device=dev)

        def operands():
            q = draw(b, h, tq, d)
            k, vm = draw(b, hkv, s, d), draw(b, hkv, s, d)
            vv = draw(b, hkv, s, d).abs()
            ints = [torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in (starts, lens)]
            # The same rows in pages of PAGE, the pool's pages in reverse:
            # logical page j of slot i at pool row b * p - 1 - (i * p + j).
            p = s // PAGE
            table = (b * p - 1 - torch.arange(b * p, device=dev,
                                              dtype=torch.int32)).view(b, p)
            pools = [c.view(b, hkv, p, PAGE, d).transpose(1, 2)
                     .reshape(b * p, hkv, PAGE, d).flip(0).contiguous()
                     for c in (k, vm, vv)]
            return (q, k, vm, vv, *ints), (q, *pools, table, *ints)

        cache_args, paged_args = operands()
        nbytes = 3 * 4 * b * hkv * s * d
        copies = max(COLD_COPIES, int(COLD_BYTES // nbytes) + 1)
        cold = [operands() for _ in range(copies - 1)]
        scale = d ** -0.5
        calls = {
            "attention_cache": lambda a: ops.pfp_attention_cache(
                *a, scale=scale),
            "attention_paged": lambda a: ops.pfp_attention_paged(
                *a, scale=scale),
        }
        for kernel, fn in calls.items():
            args = cache_args if kernel == "attention_cache" else paged_args
            sets = [args] + [c[0] if kernel == "attention_cache" else c[1]
                             for c in cold]
            label = f"{kernel} {name}"
            rows[f"{label} hot"] = _device_ms(lambda: fn(args))
            rows[f"{label} cold"] = _cold_ms(fn, sets)
            digests[label] = _digest(fn(args))
            if attention_plan is not None:
                plan = attention_plan(b, h, hkv, tq, s, d)
                plans[label] = list(plan)
        del cache_args, paged_args, cold
        torch.cuda.empty_cache()
    b, h, hkv, t, d = ROW9
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((b, h, t, d), generator=g, device=dev)
    k, vm = (torch.randn((b, hkv, t, d), generator=g, device=dev)
             for _ in range(2))
    vv = torch.randn((b, hkv, t, d), generator=g, device=dev).abs()
    rows[f"attention {ROW9}"] = _device_ms(
        lambda: ops.pfp_attention(q, k, vm, vv, scale=d ** -0.5))
    digests[f"attention {ROW9}"] = _digest(
        ops.pfp_attention(q, k, vm, vv, scale=d ** -0.5))
    return rows, digests, plans


def _act_pool(ops, dev):
    """Rows 3 and 4 and the empty kernel: (times, digests). Operands from
    a generator seeded by the shape, so every tree sees the same ones."""
    import inspect

    import torch
    from repro_torch.kernels import _launch
    rows, digests = {}, {}
    if hasattr(_launch, "launch_empty"):
        rows["empty kernel (floor)"] = _device_ms(
            lambda: _launch.launch_empty(dev), ACT_INNER)

    def operands(shape):
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        mu = torch.randn(shape, generator=g, device=dev)
        return mu, torch.randn(shape, generator=g, device=dev).abs()

    def timed(name, fn):
        rows[name] = _device_ms(fn, ACT_INNER)
        digests[name] = _digest(fn())

    calls = [("relu", (b, *s)) for b in CNN_BATCHES for s in ACT_SHAPES]
    for kind, shape in calls + [("silu", LM_SILU)]:
        mu, var = operands(shape)
        timed(f"activation {kind} {shape}",
              lambda: ops.pfp_activation(mu, var, kind=kind))
    mu, var = operands(LM_SILU)
    srm = var + mu * mu
    timed(f"glu_product {LM_SILU}",
          lambda: ops.pfp_glu_product(mu, srm, var, srm))
    srm_in = "rep" in inspect.signature(ops.pfp_maxpool2d).parameters
    for shape in ((b, *s) for b in CNN_BATCHES for s in POOL_SHAPES):
        mu, var = operands(shape)
        timed(f"maxpool2d var {shape}", lambda: ops.pfp_maxpool2d(mu, var))
        srm = var + mu * mu
        if srm_in:
            timed(f"maxpool2d srm {shape}",
                  lambda: ops.pfp_maxpool2d(mu, srm, rep="srm"))
        else:   # what the CNN path ran: to_var()'s two launches, the pool
            timed(f"maxpool2d srm {shape}",
                  lambda: ops.pfp_maxpool2d(mu, srm - torch.square(mu)))
    return rows, digests


def _empty_ms(dev):
    """The empty kernel's ms a launch, where the tree has it."""
    from repro_torch.kernels import _launch
    if hasattr(_launch, "launch_empty"):
        return {"empty kernel (floor)": _device_ms(
            lambda: _launch.launch_empty(dev), ACT_INNER)}
    return {}


def _kernel_device_ms(fn, name, reps=10):
    """Device ms a call of ``fn`` that torch.profiler gives the kernels
    whose name holds ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
             for e in prof.key_averages() if name in e.key)
    return us / 1e3 / reps


def _norms(ops, dev):
    """Rows 6-8: (times, digests). The norms at NORM_SHAPES on VAR and
    SRM input; row 8 at the gate and decode shapes, at the tile the
    chain's dense runs, beside its chain, with its norm pass's device time
    (torch.profiler), and the dense kernel at the gate on the norm
    kernel's and on the plain version's output. Operands from a generator
    seeded by the shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.tuning.measure import unfused_chain
    rows, digests = {}, {}
    for norm, shapes in NORM_SHAPES.items():
        for m, d in shapes:
            g = torch.Generator(device=dev).manual_seed(m * 10007 + d)
            mu = torch.randn((m, d), generator=g, device=dev)
            var = torch.rand((m, d), generator=g, device=dev) + 0.1
            gain = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
            bias = 0.1 * torch.randn(d, generator=g, device=dev)
            for rep in ("var", "srm"):
                second = var if rep == "var" else var + mu * mu
                if norm == "rmsnorm":
                    fn = (lambda: ops.pfp_rmsnorm(mu, second, gain, rep=rep))
                else:
                    fn = (lambda: ops.pfp_layernorm(mu, second, gain, bias,
                                                    rep=rep))
                name = f"{norm} {rep} {(m, d)}"
                rows[name] = _device_ms(fn, ACT_INNER)
                digests[name] = _digest(fn())
    if not hasattr(ops, "pfp_norm_dense_act"):
        return rows, digests
    g = torch.Generator(device=dev).manual_seed(8)
    m, k, n = GATE
    mu = torch.randn((m, k), generator=g, device=dev)
    var = torch.rand((m, k), generator=g, device=dev) + 0.1
    gain = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    wm = 0.1 * torch.randn((k, n), generator=g, device=dev)
    ws = (0.1 * torch.randn((k, n), generator=g, device=dev)).abs() + wm * wm
    # The dense kernel at the gate on the norm kernel's output and on the
    # plain version's (the same function, other rounding): whether its
    # time follows the operands' bits.
    for label, norm in (("the norm kernel's", ops.pfp_rmsnorm),
                        ("the plain version's", ref.pfp_rmsnorm_ref)):
        h_mu, h_var = norm(mu, var, gain)
        h_srm = h_var + torch.square(h_mu)
        rows[f"dense {GATE} on {label} output"] = _device_ms(
            lambda: ops.pfp_dense(h_mu, h_srm, wm, ws))
        del h_mu, h_var, h_srm
    for shape in (GATE, DECODE):
        args = (mu[:shape[0]], var[:shape[0]], gain, None, wm, ws)
        name = f"norm_dense_act {shape}"
        rows[name] = _device_ms(lambda: ops.pfp_norm_dense_act(*args))
        rows[f"unfused chain {shape}"] = _device_ms(
            lambda: unfused_chain(*args))
        rows[f"{name} norm pass (profiler)"] = _kernel_device_ms(
            lambda: ops.pfp_norm_dense_act(*args), "pfp_norm_srm_kernel")
        got = ops.pfp_norm_dense_act(*args)
        digests[name] = _digest(got)
        if not all(torch.equal(x, y)
                   for x, y in zip(got, unfused_chain(*args))):
            digests[f"{name} NOT the chain"] = "differs"
    return rows, digests


def _kernels_per_call(fn, reps=5):
    """Device kernels (and copies) one call of ``fn`` launches, as
    torch.profiler sees them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def _cold_ms(fn, sets):
    """Median ms per call over REPLAYS replays of a CUDA graph that calls
    ``fn`` once on each operand set in turn: each call finds its operands
    out of L2, which the other sets have flushed."""
    import torch
    for a in sets:
        fn(a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in sets:
            fn(a)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(sets))
    return sorted(times)[len(times) // 2]


def _forwards(dev, cnn=True, lm_steps=True):
    """CNN forwards in a CUDA graph and their device kernels (with
    ``cnn``); LM decode steps, eager (with ``lm_steps``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.configs import get_config
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.models.simple import MLP, LeNet5
    from repro_torch.nn.module import Context
    ctx = Context(mode=Mode.PFP, impl="kernel", device=dev)
    rows = {}
    for name, cls in (("lenet5", LeNet5), ("mlp", MLP)) if cnn else ():
        model = svi_to_pfp(cls(sigma_init=1e-3, device=dev,
                               generator=torch.Generator().manual_seed(0)),
                           calibration_factor=0.4)
        for b in (10, 100, 1024):
            x = torch.rand((b, 28, 28), generator=torch.Generator()
                           .manual_seed(b)).to(dev)
            x = x[..., None] if name == "lenet5" else x.reshape(b, -1)
            rows[f"forward {name} B={b} (CUDA graph)"] = _device_ms(
                lambda: model(x, ctx))
            rows[f"forward {name} B={b} device kernels"] = \
                _kernels_per_call(lambda: model(x, ctx))
    for arch, layers in (("granite-8b", 2), ("deepseek-moe-16b", 3)) \
            if lm_steps else ():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  sigma_init=1e-3)
        model = svi_to_pfp(lm.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev), calibration_factor=0.4)
        if arch == "granite-8b":   # the forward of 4 x 512 tokens
            tokens = {"tokens": np.random.default_rng(0).integers(
                0, cfg.vocab_size, (4, 512))}
            name = f"forward {arch} ({layers} layers, 4 x 512)"
            busy = _profile(name, lambda: lm.forward(model, cfg, tokens,
                                                     ctx), reps=2, warmup=1)
            rows[f"{name} device busy"] = busy["busy_ms"] if busy else 0.0
        pos = np.asarray([300, 400, 500, 540])
        inputs = {"tokens": np.asarray([[11], [257], [1031], [4099]]),
                  "positions": pos[:, None], "cache_len": pos + 1}
        states = lm.init_decode_state(cfg, 4, 1024, device=dev)
        step = lambda: lm.decode_step(model, cfg, inputs, states,  # noqa
                                      ctx)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        blocks = []
        for _ in range(STEP_BLOCKS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                step()
            end.record()
            end.synchronize()
            blocks.append(start.elapsed_time(end) / 10)
        name = f"decode step {arch} ({layers} layers, 4 slots)"
        rows[name] = sorted(blocks)[STEP_BLOCKS // 2]
        rows[f"{name} min"] = min(blocks)
        busy = _profile(name, step, reps=10, warmup=1)
        rows[f"{name} device busy"] = busy["busy_ms"] if busy else 0.0
        del model, states
        torch.cuda.empty_cache()
    return rows


def child(tree, only=None):
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import repro_torch  # noqa: F401  (IEEE fp32 for cuBLAS)
    from repro_torch.kernels import _build, ops
    _build.load()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    rows, differ, digests, fused_best = {}, [], {}, {}
    if only in (None, "act_pool"):
        rows, digests = _act_pool(ops, dev)
    if only == "norms":
        rows = _empty_ms(dev)
    if only in (None, "norms"):
        norm_rows, norm_digests = _norms(ops, dev)
        rows.update(norm_rows)
        digests.update(norm_digests)
    if only is None:
        m, d = NORM_SHAPE
        mu, var = draw(m, d), draw(m, d).abs()
        gain = 1.0 + 0.1 * draw(d)
        wm = draw(GATE[1], GATE[2], scale=0.1)
        ws = draw(GATE[1], GATE[2], scale=0.1).abs() + wm * wm
        srm = var + mu * mu
        rows[f"dense {GATE}"] = _device_ms(
            lambda: ops.pfp_dense(mu, srm, wm, ws))
        if hasattr(ops, "pfp_norm_dense_act"):
            from repro_torch.kernels.pfp_fused import TILES
            from repro_torch.tuning.measure import unfused_chain
            from repro_torch.tuning.schedules import Schedule
            for shape in (GATE, DECODE):
                x_mu, x_var = mu[:shape[0]], var[:shape[0]]
                args = (x_mu, x_var, gain, None, wm, ws)
                chain_ms = rows[f"unfused chain {shape}"] = _device_ms(
                    lambda: unfused_chain(*args))
                chain = unfused_chain(*args)
                for bm, bn in TILES:
                    sched = Schedule.make("norm_dense_act", block_m=bm,
                                          block_n=bn)
                    name = f"norm_dense_act {shape} ({bm}, {bn})"
                    rows[name] = _device_ms(
                        lambda: ops.pfp_norm_dense_act(*args,
                                                       schedule=sched))
                    got = ops.pfp_norm_dense_act(*args, schedule=sched)
                    if not all(torch.equal(x, y) for x, y in zip(got, chain)):
                        differ.append(name)
                    if str(shape) not in fused_best or \
                            rows[name] < fused_best[str(shape)][1]:
                        fused_best[str(shape)] = [(bm, bn), rows[name],
                                                  chain_ms]
        del mu, var, srm, wm, ws
        small, small_digests = _small_regime(ops, draw)
        rows.update(small)
        digests.update(small_digests)
        torch.cuda.empty_cache()
        large, large_digests = _large_regime(ops, dev)
        rows.update(large)
        digests.update(large_digests)
    plans = {}
    if only in (None, "attention"):
        att, att_digests, plans = _attention(ops, dev)
        rows.update(att)
        digests.update(att_digests)
        torch.cuda.empty_cache()
    if only != "norms":
        rows.update(_forwards(dev, cnn=only != "attention",
                              lm_steps=only != "act_pool"))
    log = (Path(_build.BUILD_INFO["directory"]) / "ptxas.log").read_text()
    print(json.dumps({"tree": tree, "ms": rows, "differ_from_chain": differ,
                      "fused_best": fused_best,
                      "digests": digests, "plans": plans,
                      "registers": _registers(log),
                      "build_s": _build.BUILD_INFO["seconds"]}))


def main(argv):
    import torch
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    trees = argv
    if not trees or not torch.cuda.is_available():
        print("ab_kernel_times: give tree directories, on a CUDA card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs, failed = [], 0
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--child", tree]
                             + ([only] if only else []),
                             capture_output=True, text=True)
        if out.returncode != 0:   # a tree that does not build or run
            print(f"{tree}: failed\n{out.stdout[-4000:]}"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            failed += 1
            runs.append({"tree": tree, "ms": {}, "registers": {},
                         "digests": {}, "plans": {}, "fused_best": {},
                         "build_s": None, "failed": True})
            continue
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f"card: {card.strip()}")
    names = list(dict.fromkeys(n for r in runs for n in r["ms"]))
    print(" " * 53 + "  ".join(f"{Path(r['tree']).name[-9:]:>9s}"
                               for r in runs))
    for name in names:
        cells = [f"{r['ms'][name]:.4f}" if name in r["ms"] else "-"
                 for r in runs]
        print(f"{name:52s} " + "  ".join(f"{c:>9s}" for c in cells))
    for r in runs:
        if not r.get("failed"):
            print(f"{r['tree']}: build {r['build_s']:.1f} s; not bit for "
                  f"bit the unfused chain: {r['differ_from_chain'] or 'none'}"
                  f"; registers {json.dumps(r['registers'])}")
        for shape, (tile, ms, chain_ms) in r.get("fused_best", {}).items():
            print(f"[fused] {Path(r['tree']).name}: {shape} fastest tile "
                  f"{tuple(tile)} {ms:.4f} ms against the unfused chain's "
                  f"{chain_ms:.4f} ms: "
                  + ("no slower" if ms <= chain_ms else "slower"))
    done = [r["digests"] for r in runs if not r.get("failed")]
    differ = sorted(n for n in done[0] if len({d.get(n) for d in done}) > 1
                    ) if done else []
    for r in runs:
        for label, plan in r.get("plans", {}).items():
            print(f"[plan] {Path(r['tree']).name}: {label} {plan}")
    print(f"digests ({len(done[0]) if done else 0} calls): "
          + (f"differ between trees at {differ}" if differ
             else "equal in every tree"))
    # Every digest but those of rows 3 and 4 and of the norms (6-8): the
    # dense kernels (rows 1, 2, 12, 13), the GLU (row 5) and the attention
    # kernels (rows 9, 10, 11).
    act_pool = ("activation ", "maxpool2d ")
    norms = ("rmsnorm ", "layernorm ", "norm_dense_act ")
    kept = [n for n in differ if not n.startswith(act_pool + norms)]
    print("digests of rows 1, 2, 5 and 9-13: "
          + (f"DIFFER at {kept}" if kept else "equal in every tree"))
    moved = [n for n in differ if n.startswith(act_pool)]
    print(f"digests of rows 3 and 4: {len(moved)} differ between trees")
    moved = [n for n in differ if n.startswith(norms)]
    print(f"digests of rows 6-8: {len(moved)} differ between trees")
    for r in runs:
        bad = [n for n in r["digests"] if n.endswith("NOT the chain")]
        if bad:
            print(f"{r['tree']}: row 8 is not its chain bit for bit at {bad}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_kernel_times.json").write_text(json.dumps(
        {"card": card.strip(), "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], *sys.argv[3:4])
    else:
        sys.exit(main(sys.argv[1:]))
