"""SVI training CLI for the LM zoo on one card, with checkpoint and resume.

Counterpart of ``repro/launch/train.py``: Adam on a cosine schedule (warmup
5 steps, peak 1e-3, global-norm clip 1.0), the SVI ELBO step with the KL
weight annealed to 0.25 over the run, batches from ``TokenPipeline``, a
checkpoint every 10 steps, ``--resume`` from the latest one, and the
``StepMonitor``'s straggler verdicts on the printed steps.

Step ``i`` draws its weight noise from a ``torch.Generator`` on the device
seeded with ``i`` (the reference's ``jax.random.PRNGKey(i)``) and its batch
from ``TokenPipeline.batch(i)``, so a resumed run draws what an
uninterrupted one draws and ends at the same state bit for bit.

Differences from the reference: one card, so ``--devices`` and ``--mesh``
are refused (they come with the ``torch.distributed`` slice); the weights
are drawn on ``--device`` (the CUDA card by default; without one this
raises unless ``--device cpu``) from seed 0, and ``--layers`` cuts the
model; checkpoints are written only where ``--ckpt-dir`` names a
directory (the reference defaults to one under ``/tmp``).

Usage (``PYTHONPATH=src``):
  python -m repro_torch.launch.train --device cpu --reduced --steps 6 \\
      --batch 4 --seq 32 --ckpt-dir build/ckpt
  python -m repro_torch.launch.train --layers 2 --batch 1 --seq 256 \\
      --steps 12 --ckpt-dir build/ckpt     # granite-8b, full width, card

``main(argv)`` returns the exit code; ``run(args)`` returns the final
``TrainState``, so scripts and tests can read it in-process.
"""
import argparse
import dataclasses
import sys
import time

_REFUSED = ("devices", "mesh")


def _parser():
    ap = argparse.ArgumentParser(
        description="SVI-train an LM of the zoo on one card, with "
                    "checkpoints and resume.")
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
    for flag in _REFUSED:
        ap.add_argument(f"--{flag}", default=None,
                        help="refused: the mesh comes with the "
                             "torch.distributed slice (ROADMAP.md queue A "
                             "item 3)")
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
    from repro_torch.training.optimizer import Adam, cosine_schedule
    from repro_torch.training.train_loop import (TrainState,
                                                 init_train_state,
                                                 load_train_state_tree,
                                                 make_svi_train_step,
                                                 train_state_layout,
                                                 train_state_tree)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    print(f"device={device.type} arch={cfg.name} layers={cfg.num_layers} "
          f"params~{cfg.param_count() / 1e6:.1f}M")

    model = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
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
        tree, start = mgr.restore(train_state_layout(model))
        state = load_train_state_tree(TrainState(model, None, 0), tree)
        del tree
        read = mgr.restores[-1]
        print(f"resumed from step {start} onto {device.type}: "
              f"{read['bytes'] / 1e9:.3f} GB read in {read['seconds']:.3f} s")
    else:
        state = init_train_state(model, opt)

    try:
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).long().to(device)
                     for k, v in pipe.batch(i).items()}
            gen = torch.Generator(device=device).manual_seed(i)
            state, m = step_fn(state, batch, gen, eps=eps)
            loss = float(m["loss"])   # waits for the step on the device
            dt = time.perf_counter() - t0
            verdict = monitor.record(i, dt)
            if on_step is not None:
                on_step(i, m, dt)
            if i % 5 == 0 or verdict == "straggle":
                print(f"step {i:4d} loss={loss:.3f} "
                      f"nll={float(m['nll']):.3f} {dt * 1e3:.0f}ms "
                      f"[{verdict}]")
            if mgr is not None and (i + 1) % 10 == 0:
                t0 = time.perf_counter()
                mgr.save(i + 1, train_state_tree(state))
                paused[i + 1] = time.perf_counter() - t0
    finally:
        if mgr is not None:
            mgr.wait()
    for saved in mgr.saves if mgr is not None else ():
        print(f"checkpoint step {saved['step']}: {saved['bytes'] / 1e9:.3f} "
              f"GB, host copy {paused[saved['step']]:.3f} s, write "
              f"{saved['write_seconds']:.3f} s")
    print("done; latest checkpoint:",
          mgr.latest_step() if mgr is not None else None)
    return state


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    refused = [f"--{flag}" for flag in _REFUSED
               if getattr(args, flag) is not None]
    if refused:
        print(f"ERROR: {' and '.join(refused)}: the port trains on one card; "
              "the mesh comes with the torch.distributed slice (ROADMAP.md "
              "queue A item 3)", file=sys.stderr)
        return 2
    if args.resume and not args.ckpt_dir:
        print("ERROR: --resume needs --ckpt-dir", file=sys.stderr)
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
