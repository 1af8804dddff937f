"""The port's training CLI, ``repro_torch.launch.train``, on the CPU.

``main(argv)`` in-process at the reduced granite-8b (``--device cpu
--reduced``): 6 steps print the reference's step lines and its last line
and exit 0. A run of 20 steps, and the same run preempted at step 13
(an exception out of its gradient hook, after the step-10 checkpoint)
then restarted with ``--resume``, leave step-20 checkpoints equal bit for
bit, manifests included. (A ``--steps 10`` run is another run, not an
interrupted one: the cosine schedule, the KL annealing and the ELBO's
data count all follow ``--steps``, in the reference too.) ``--devices``
and ``--mesh`` exit 2, and without ``--device cpu`` and with no card the
CLI raises before it builds anything. The paper configs and
``ASSIGNED_ARCHS`` equal the reference's.

Against the reference: the CLI's first step through ``run(..., eps=)``,
with the reference's SVI noise of ``PRNGKey(0)`` handed in leaf by leaf,
gives the loss, NLL and KL of the reference's ``make_svi_train_step`` on
the same parameters (the CLI's own init, carried across with
``numpy_params``), batch and schedules, at ``tests/test_torch_train_lm.py``'s
tolerance (rtol 1e-4).
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes.variational import KLSchedule as JKLSchedule
from repro.configs import ASSIGNED_ARCHS as JASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.nn.module import BayesParam, numpy_params
from repro_torch.training.checkpoint import CheckpointManager
from torch_reference_noise import ReferenceLMEps, leaf_schedule

ARCH = "granite-8b"
CPU = ["--device", "cpu", "--reduced"]
SMALL = CPU + ["--batch", "2", "--seq", "16"]
LINE = re.compile(r"step +(\d+) loss=\d+\.\d{3} nll=\d+\.\d{3} \d+ms "
                  r"\[(warmup|ok|straggle)\]")
LM_METRIC_TOL = dict(rtol=1e-4, atol=0)    # tests/test_torch_train_lm.py


def test_cli_exits_zero_with_the_reference_lines(tmp_path, capsys):
    argv = CPU + ["--steps", "6", "--batch", "4", "--seq", "32",
                  "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [line for line in lines if line.startswith("step")]
    assert all(LINE.fullmatch(line) for line in steps), steps
    assert [int(LINE.fullmatch(line).group(1)) for line in steps] == [0, 5]
    assert lines[-1] == "done; latest checkpoint: None"   # no 10th step


class _Preempted(Exception):
    pass


def _step_files(directory, step):
    d = directory / f"step_{step:09d}"
    return (json.loads((d / "MANIFEST.json").read_text()),
            {p.name: np.load(p) for p in sorted(d.glob("*.npy"))})


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path, capsys):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    argv = SMALL + ["--steps", "20"]
    assert train.main(argv + ["--ckpt-dir", str(whole)]) == 0

    def preempt(step, grads):
        if step == 13:
            raise _Preempted

    with pytest.raises(_Preempted):
        train.run(train._parser().parse_args(argv + ["--ckpt-dir", str(cut)]),
                  grad_hook=preempt)
    assert CheckpointManager(str(cut)).list_steps() == [10]
    assert train.main(argv + ["--ckpt-dir", str(cut), "--resume"]) == 0
    assert "resumed from step 10 onto cpu" in capsys.readouterr().out
    for d in (whole, cut):
        assert CheckpointManager(str(d)).list_steps() == [10, 20]
    (want_manifest, want), (got_manifest, got) = (_step_files(d, 20)
                                                  for d in (whole, cut))
    assert got_manifest == want_manifest
    assert got_manifest["leaves"]["step"]["dtype"] == "int32"
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("argv", [["--devices", "8"], ["--mesh", "4,2"],
                                  ["--devices", "8", "--mesh", "4,2"]])
def test_mesh_flags_are_refused(argv, capsys):
    assert train.main(CPU + argv) == 2
    assert "ROADMAP.md queue A item 3" in capsys.readouterr().err


def test_resume_without_a_checkpoint_directory_is_refused(capsys):
    assert train.main(CPU + ["--resume"]) == 2
    assert "--resume needs --ckpt-dir" in capsys.readouterr().err


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


def test_paper_configs_and_assigned_archs_match_reference():
    assert ASSIGNED_ARCHS == JASSIGNED_ARCHS
    for name in ("paper-mlp", "paper-lenet5"):
        cfg, want = get_config(name), jget_config(name)
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(want, field.name), \
                (name, field.name)
        assert reduced_config(name) == cfg
        assert jreduced_config(name) == want


def test_first_step_matches_reference():
    """One step (``--steps 1``: at step 0 the KL weighs nothing, but its
    value is still a metric) on the reference's noise."""
    batch, seq = 2, 16
    cfg = reduced_config(ARCH)
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")          # the CLI's init on the CPU
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(model))
    jcfg = jreduced_config(ARCH)
    jadam = jopt.Adam(learning_rate=jopt.cosine_schedule(1e-3, 5, 1),
                      clip_norm=1.0)

    def jfwd(p, b, ctx):
        logits, aux, _ = jlm.forward(p, jcfg, b, ctx)
        return logits, aux

    jstep = jax.jit(jtrain.make_svi_train_step(
        jfwd, jadam, num_data=batch * seq, kl_schedule=JKLSchedule(0.25, 1)))
    jbatch = {k: jnp.asarray(v) for k, v in
              TokenPipeline(jcfg.vocab_size, seq, batch).batch(0).items()}
    _, want = jstep(jtrain.init_train_state(params, jadam), jbatch,
                    jax.random.PRNGKey(0))

    block = model.stack[0]["b0"]
    eps = ReferenceLMEps(jax.random.PRNGKey(0), leaf_schedule(
        cfg, sum(isinstance(m, BayesParam) for m in block.modules())))
    got = {}
    train.run(train._parser().parse_args(SMALL + ["--steps", "1"]), eps=eps,
              on_step=lambda i, metrics, dt: got.update(metrics))
    assert eps.calls == len(eps.schedule)
    for k in ("loss", "nll", "kl"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **LM_METRIC_TOL)
