"""The port's checkpointing and fault tolerance, on the CPU.

Counterparts of the reference's own tests (``tests/
test_training_pipeline.py``): a round trip pruned to ``keep_last`` 2, a
torn step (no ``COMMIT``) ignored, the supervisor's retry from the latest
checkpoint, the straggler verdicts. Then what the port adds: an async
save joined by ``wait()`` that holds the values of the moment it was
called, a writer's failure raised by ``wait()``, a ``.tmp`` directory
ignored even with a ``COMMIT`` in it, and a straggle snapshot that a
restart resumes from without running a step twice.

Across the packages: a reduced granite-8b train state (the reference's
init, Adam moments drawn with numpy, step 7) carried into the port with
``load_train_state_tree`` and saved by the port is read by the
reference's ``CheckpointManager.restore`` into its ``TrainState`` with
every leaf's path, shape, dtype and value equal; the reference's save of
the same state is read by the port's ``restore`` and
``load_train_state_tree``, and ``train_state_tree`` gives it back leaf for
leaf. Every writer thread is joined; files go under ``tmp_path`` only.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro.training.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.models import lm
from repro_torch.models.simple import MLP
from repro_torch.training.checkpoint import CheckpointManager, _flatten
from repro_torch.training.fault_tolerance import StepMonitor, TrainSupervisor
from repro_torch.training.optimizer import Adam
from repro_torch.training.train_loop import (TrainState, init_train_state,
                                             load_train_state_tree,
                                             train_state_layout,
                                             train_state_tree)

ARCH = "granite-8b"
STEP = 7


def _mlp_state():
    model = MLP(d_hidden=8, generator=torch.Generator().manual_seed(0),
                device="cpu")
    return init_train_state(model, Adam())


def _assert_trees_equal(got, want):
    """Same flat keys; each leaf of the same shape, dtype and value."""
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.shape, g.dtype) == (w.shape, w.dtype), k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# The reference's tests, on the port
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = _mlp_state()
    tree = train_state_tree(state)
    for step in (7, 13, 21):
        mgr.save(step, tree, blocking=True)
    assert mgr.list_steps() == [13, 21]   # pruned to keep_last
    restored, step = mgr.restore(train_state_layout(state.model))
    assert step == 21
    _assert_trees_equal(restored, tree)
    loaded = load_train_state_tree(state, restored)
    _assert_trees_equal(train_state_tree(loaded), tree)


def test_train_state_tree_copies_and_load_keeps_the_parameter_order():
    """The tree shares no memory with the live tensors (an async save
    must not see later in-place updates), and a loaded model lists its
    parameters in a new model's order (the order in which training sums
    the gradient norm)."""
    state = _mlp_state()
    tree = _flatten(train_state_tree(state))
    live = [p.detach().numpy() for p in state.model.parameters()]
    live += [t.numpy() for t in (*state.opt_state.m.values(),
                                 *state.opt_state.v.values())]
    assert not any(np.shares_memory(a, b) for a in tree.values()
                   for b in live)
    order = [n for n, _ in state.model.named_parameters()]
    loaded = load_train_state_tree(state, train_state_tree(state))
    assert [n for n, _ in loaded.model.named_parameters()] == order
    assert list(loaded.opt_state.m) == order


def test_checkpoint_torn_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)}, blocking=True)
    os.makedirs(tmp_path / "step_000000002")    # no COMMIT: torn
    assert mgr.latest_step() == 1


def test_tmp_directory_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)}, blocking=True)
    tmp = tmp_path / "step_000000009.tmp"
    os.makedirs(tmp)
    (tmp / "COMMIT").write_text("ok")
    assert mgr.list_steps() == [1]


def test_supervisor_retries_from_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def save(step, state):
        mgr.save(step, {"v": torch.tensor(state)}, blocking=True)

    def restore():
        tree, step = mgr.restore({"v": None})
        return float(tree["v"]), step

    def step_fn(state, step):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("simulated node failure")
        return state + 1.0, {}

    sup = TrainSupervisor(save, restore, save_every=2, max_restarts=2)
    state, _, step = sup.run(step_fn, 0.0, 0, 8)
    assert step == 8 and state == 8.0
    assert sup.restarts == 1


def test_step_monitor_flags_stragglers():
    mon = StepMonitor(window=20, threshold=2.0, min_samples=5)
    for i in range(10):
        assert mon.record(i, 1.0) in ("ok", "warmup")
    assert mon.record(10, 5.0) == "straggle"
    assert mon.record(11, 1.1) == "ok"
    assert mon.flagged == [(10, 5.0, 1.0)]


# ---------------------------------------------------------------------------
# What the port adds
# ---------------------------------------------------------------------------
def test_async_save_joined_by_wait(tmp_path):
    """``save`` copies the tree at once: writing into the tensors before
    ``wait()`` does not reach the files."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(1000, dtype=torch.float32)
    mgr.save(3, {"w": w, "step": torch.tensor(3, dtype=torch.int32)})
    thread = mgr._thread
    w.mul_(-1.0)
    mgr.wait()
    assert mgr._thread is None and not thread.is_alive()
    assert (tmp_path / "step_000000003" / "COMMIT").exists()
    tree, step = mgr.restore({"w": None, "step": None})
    assert step == 3 and tree["step"].dtype == torch.int32
    assert torch.equal(tree["w"], torch.arange(1000, dtype=torch.float32))


def test_wait_raises_the_writers_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_000000004.tmp").write_text("a file, not a directory")
    mgr.save(4, {"w": torch.ones(2)})
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    assert mgr._thread is None and mgr.latest_step() is None
    mgr.wait()   # the error is raised once


class _Straggles(StepMonitor):
    """A monitor whose verdict is 'straggle' at the given steps."""

    def __init__(self, steps):
        super().__init__()
        self.steps = steps

    def record(self, step, seconds):
        return "straggle" if step in self.steps else "ok"


@pytest.mark.parametrize("fail_at", [None, 6])
def test_straggle_snapshot_resumes_without_repeating_a_step(tmp_path,
                                                            fail_at):
    """A straggle at step 4 saves the state after it under 5 steps done;
    a failure at step 6 restores that snapshot and the run ends where an
    uninterrupted one ends."""
    mgr = CheckpointManager(str(tmp_path / str(fail_at)))
    failed = []

    def save(step, state):
        mgr.save(step, {"v": torch.tensor(state)}, blocking=True)

    def restore():
        tree, step = mgr.restore({"v": None})
        return tree["v"].tolist(), step

    def step_fn(state, step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError("simulated node failure")
        return state + [step], {}

    sup = TrainSupervisor(save, restore, save_every=100,
                          monitor=_Straggles({4}))
    state, _, step = sup.run(step_fn, [-1], 0, 8)
    assert mgr.list_steps() == [5]
    assert (state, step) == ([-1] + list(range(8)), 8)
    assert sup.restarts == (fail_at is not None)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_state():
    """The reference's reduced granite-8b TrainState at step 7, with Adam
    moments drawn with numpy, as numpy leaves."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jlm.init_params(jreduced_config(ARCH), k))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def moments():
        return jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            params)
    step = np.asarray(STEP, np.int32)
    return jtrain.TrainState(params, jopt.AdamState(step, moments(),
                                                    moments()), step)


def _port_state(tree):
    model = lm.init_params(reduced_config(ARCH), device="cpu")
    return load_train_state_tree(TrainState(model, None, 0), tree)


def _with_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_reads_the_ports_checkpoint(tmp_path, reference_state):
    state = _port_state(reference_state)
    assert state.step == STEP and state.opt_state.step == STEP
    assert all(p.requires_grad for p in state.model.parameters())
    CheckpointManager(str(tmp_path)).save(STEP, train_state_tree(state),
                                          blocking=True)
    proto = jax.tree_util.tree_map(jnp.zeros_like, reference_state)
    restored, step = JCheckpointManager(str(tmp_path)).restore(proto)
    assert step == STEP
    got, want = _with_paths(restored), _with_paths(reference_state)
    assert set(got) == set(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_reads_the_references_checkpoint(tmp_path, reference_state):
    JCheckpointManager(str(tmp_path)).save(
        STEP, jax.tree_util.tree_map(jnp.asarray, reference_state),
        blocking=True)
    model = lm.init_params(reduced_config(ARCH), device="cpu")
    tree, step = CheckpointManager(str(tmp_path)).restore(
        train_state_layout(model))
    assert step == STEP
    flat = _flatten(tree)
    assert set(flat) == set(_flatten(reference_state))
    order = [n for n, _ in model.named_parameters()]
    state = load_train_state_tree(TrainState(model, None, 0), tree)
    assert state.step == STEP and state.opt_state.step == STEP
    _assert_trees_equal(train_state_tree(state), reference_state)
    # The loaded model lists its parameters in a new one's order, and
    # Adam's moments are keyed by them.
    assert [n for n, _ in state.model.named_parameters()] == order
    assert list(state.opt_state.m) == list(state.opt_state.v) == order
