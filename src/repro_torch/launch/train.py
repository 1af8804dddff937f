"""SVI training CLI for the LM zoo, on one card or a mesh, with checkpoint
and resume.

Counterpart of ``repro/launch/train.py``: Adam on a cosine schedule (warmup
5 steps, peak 1e-3, global-norm clip 1.0), the SVI ELBO step with the KL
weight annealed to 0.25 over the run, batches from ``TokenPipeline``, a
checkpoint every 10 steps, ``--resume`` from the latest one, and the
``StepMonitor``'s straggler verdicts on the printed steps.

Step ``i`` draws its weight noise from a ``torch.Generator`` on the device
seeded with ``i`` (the reference's ``jax.random.PRNGKey(i)``) and its batch
from ``TokenPipeline.batch(i)``, so a resumed run draws what an
uninterrupted one draws and ends at the same state bit for bit.

The mesh: ``--devices N --mesh D,M`` trains on a (data, model) mesh of N =
D * M ranks, one rank a process (``--mesh`` alone implies ``--devices``,
``--devices`` alone the mesh (N, 1)). The parameters, Adam's moments (with
the parameters' placements) and each batch are placed by the sharding
rules of ``launch/sharding.py``; every rank draws the whole batch and the
whole noise from the same seeds and keeps its own block, so the sharded
step draws what the single-device step draws. ``--resume`` restores
elastically onto this run's mesh, whatever mesh saved the checkpoint.
Rank 0 alone prints and writes. The ranks come from:

* a launcher (``torchrun``, which sets ``WORLD_SIZE``): the world must
  equal ``--devices``;
* ``--devices 1``: an in-process group of one rank (gloo with ``--device
  cpu``, NCCL on the card);
* ``--device cpu`` with more ranks and no launcher: the CLI starts N local
  gloo processes itself, so the reference's command line runs as it is.

On the card NCCL takes one rank a card, so ``--devices`` may not exceed
the card count.

Differences from the reference: without ``--devices`` / ``--mesh`` it
trains on one device, with no process group; the weights are drawn on
``--device`` (the CUDA card by default; without one this raises unless
``--device cpu``) from seed 0, and ``--layers`` cuts the model;
checkpoints are written only where ``--ckpt-dir`` names a directory (the
reference defaults to one under ``/tmp``).

Usage (``PYTHONPATH=src``):
  python -m repro_torch.launch.train --device cpu --reduced --steps 6 \\
      --batch 4 --seq 32 --ckpt-dir build/ckpt
  python -m repro_torch.launch.train --device cpu --devices 8 --mesh 4,2 \\
      --reduced --steps 6 --batch 4 --seq 32 --ckpt-dir build/ckpt
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --devices 8 \\
      --mesh 4,2 --reduced --steps 6
  python -m repro_torch.launch.train --layers 2 --batch 1 --seq 256 \\
      --steps 12 --ckpt-dir build/ckpt     # granite-8b, full width, card

``main(argv)`` returns the exit code; ``run(args)`` returns the final
``TrainState``, so scripts and tests can read it in-process.
"""
import argparse
import contextlib
import dataclasses
import math
import os
import sys
import time

from repro_torch.launch.mesh import mesh_dims, process_group, silent
from repro_torch.launch.mesh import spawn as _spawn


def _parser():
    ap = argparse.ArgumentParser(
        description="SVI-train an LM of the zoo on one card or a mesh, "
                    "with checkpoints and resume.")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one); "
                         "'cpu' trains on the CPU")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save a checkpoint here every 10 steps (default: "
                         "no checkpoints)")
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--devices", type=int, default=None,
                    help="train on a mesh of this many ranks")
    ap.add_argument("--mesh", default=None, help="data,model (e.g. 4,2)")
    return ap


class _GradTap:
    """``optimizer`` with ``hook(step, grads)`` called on each step's
    gradients (before clipping) ahead of its update."""

    def __init__(self, optimizer, hook):
        self.optimizer, self.hook = optimizer, hook

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params):
        self.hook(state.step, grads)
        return self.optimizer.update(grads, state, params)


def run(args, *, eps=None, grad_hook=None, on_step=None):
    """Train as ``args`` say; on a mesh (``--devices`` / ``--mesh``) each
    rank calls this, inside its process group. Returns the final
    ``TrainState`` (on a mesh, its tensors are DTensors)."""
    dims = mesh_dims(args)
    if dims is None:
        return _run(args, None, None, eps=eps, grad_hook=grad_hook,
                    on_step=on_step)
    with process_group(args, dims) as (mesh, device):
        return _run(args, mesh, device, eps=eps, grad_hook=grad_hook,
                    on_step=on_step)


def _scalar(t) -> float:
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _run(args, mesh, mesh_device, *, eps=None, grad_hook=None, on_step=None):
    """Train as ``args`` (parsed and checked as ``main`` does) say and
    return the final ``TrainState``.

    Seams for tests and measurements: ``eps`` is handed to every step as
    ``Context.eps`` (the noise of each leaf in resolve order, in place of
    the step's generator); ``grad_hook(step, grads)`` sees each step's
    gradients ({name: tensor}) before the optimizer clips and applies
    them; ``on_step(i, metrics, seconds)`` sees each step's metrics and
    its time (host clock, after the loss reached the host). The writer
    thread of a checkpoint is joined however the loop ends."""
    import torch

    from repro_torch.bayes.variational import KLSchedule
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.device import resolve_device
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.fault_tolerance import StepMonitor
    from repro_torch.training.optimizer import (Adam, AdamState,
                                                cosine_schedule)
    from repro_torch.training.train_loop import (TrainState,
                                                 init_train_state,
                                                 load_train_state_tree,
                                                 make_svi_train_step,
                                                 train_state_layout,
                                                 train_state_tree)

    device = mesh_device or resolve_device(args.device)
    say = print
    placed = contextlib.nullcontext
    if mesh is not None:
        import torch.distributed as dist
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch import sharding as shlib
        if dist.get_rank() != 0:
            say = silent
        # Tensors the model makes itself (positions, masks) count as
        # replicas beside the DTensors.
        placed = implicit_replication
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    where = ("" if mesh is None else
             f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} ")
    say(f"{where}device={device.type} arch={cfg.name} "
        f"layers={cfg.num_layers} params~{cfg.param_count() / 1e6:.1f}M")

    model = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    if mesh is not None:
        shlib.distribute_params(model, mesh)
    opt = Adam(learning_rate=cosine_schedule(1e-3, 5, args.steps),
               clip_norm=1.0)

    def fwd(m, batch, ctx):
        logits, aux, _ = lm.forward(m, cfg, batch, ctx)
        return logits, aux

    step_fn = make_svi_train_step(
        fwd, opt if grad_hook is None else _GradTap(opt, grad_hook),
        num_data=args.batch * args.seq * args.steps,
        kl_schedule=KLSchedule(0.25, args.steps))
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StepMonitor()
    paused = {}   # checkpoint step -> seconds the loop waited for its copy
    start = 0
    if args.resume and mgr.latest_step() is not None:
        # The restored moments replace the fresh state's, so none is made.
        layout = train_state_layout(model)
        shardings = None
        if mesh is not None:   # elastic: onto this run's mesh
            ls = shlib.layout_shardings(layout["params"], model, mesh)
            shardings = {"params": ls, "opt_state": AdamState(None, ls, ls),
                         "step": None}
        tree, start = mgr.restore(layout, device=device, shardings=shardings)
        state = load_train_state_tree(TrainState(model, None, 0), tree)
        del tree
        read = mgr.restores[-1]
        onto = ("" if mesh is None else
                f" (elastic onto {tuple(mesh.shape)} mesh)")
        say(f"resumed from step {start} onto {device.type}: "
            f"{read['bytes'] / 1e9:.3f} GB read in {read['seconds']:.3f} s"
            f"{onto}")
    else:
        state = init_train_state(model, opt)

    try:
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).long().to(device)
                     for k, v in pipe.batch(i).items()}
            if mesh is not None:
                batch = shlib.distribute_tree(
                    batch, shlib.batch_shardings(batch, mesh), mesh)
            gen = torch.Generator(device=device).manual_seed(i)
            with placed():
                state, m = step_fn(state, batch, gen, eps=eps)
            loss = _scalar(m["loss"])   # waits for the step on the device
            dt = time.perf_counter() - t0
            verdict = monitor.record(i, dt)
            if on_step is not None:
                on_step(i, m, dt)
            if i % 5 == 0 or verdict == "straggle":
                say(f"step {i:4d} loss={loss:.3f} "
                    f"nll={_scalar(m['nll']):.3f} {dt * 1e3:.0f}ms "
                    f"[{verdict}]")
            if mgr is not None and (i + 1) % 10 == 0:
                t0 = time.perf_counter()
                mgr.save(i + 1, train_state_tree(state))
                paused[i + 1] = time.perf_counter() - t0
    finally:
        if mgr is not None:
            mgr.wait()
    for saved in mgr.saves if mgr is not None else ():
        say(f"checkpoint step {saved['step']}: {saved['bytes'] / 1e9:.3f} "
            f"GB, host copy {paused[saved['step']]:.3f} s, write "
            f"{saved['write_seconds']:.3f} s")
    say("done; latest checkpoint:",
        mgr.latest_step() if mgr is not None else None)
    return state


def _rank_entry(argv) -> int:
    """A spawned rank of ``--device cpu --devices N``."""
    run(_parser().parse_args(argv))
    return 0


def main(argv=None) -> int:
    import torch.distributed as dist

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    try:
        dims = mesh_dims(args)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if args.resume and not args.ckpt_dir:
        print("ERROR: --resume needs --ckpt-dir", file=sys.stderr)
        return 2
    world = math.prod(dims) if dims is not None else 1
    if (world > 1 and "WORLD_SIZE" not in os.environ
            and not dist.is_initialized()):
        return _spawn(_rank_entry, argv, world)   # --device cpu: gloo ranks
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
