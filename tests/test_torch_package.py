"""Package rules of the port: what it imports, where it runs, what it counts."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import dirty_mnist as jax_data
from repro_torch.core import dispatch
from repro_torch.core.device import resolve_device
from repro_torch.core.modes import Mode
from repro_torch.data import dirty_mnist
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models.simple import MLP, LeNet5
from repro_torch.nn.module import Context

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_nothing_of_jax_or_the_reference(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLP()
    model = MLP(d_hidden=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model(np.zeros((1, 784), np.float32), Context(mode=Mode.PFP))


def test_kernel_impl_on_cpu_tensors_launches_nothing():
    assert dispatch.DEFAULT_IMPL == "kernel"
    reset_launch_counts()
    model = LeNet5(device="cpu")
    x = np.random.default_rng(0).random((2, 28, 28, 1), dtype=np.float32)
    for formulation in ("srm", "var"):
        out = model(x, Context(mode=Mode.PFP, formulation=formulation,
                               device="cpu"))  # impl None -> "kernel"
        assert tuple(out.mean.shape) == (2, 10)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_svi_mode_is_not_ported_yet():
    """SVI draws every leaf's eps from ctx.generator: one seed gives one
    sample, another seed another; without a generator it raises."""
    model = MLP(d_hidden=8, device="cpu")
    x = np.random.default_rng(0).random((2, 784), dtype=np.float32)

    def sample(seed):
        return model(x, Context(mode=Mode.SVI, device="cpu",
                                generator=torch.Generator().manual_seed(seed)))

    assert torch.equal(sample(1), sample(1))
    assert not torch.allclose(sample(1), sample(2))
    det = model(x, Context(mode=Mode.DETERMINISTIC, device="cpu"))
    assert not torch.equal(sample(1), det)
    with pytest.raises(ValueError, match="generator"):
        model(x, Context(mode=Mode.SVI, device="cpu"))


def test_unknown_impl_and_formulation_raise():
    model = MLP(d_hidden=8, device="cpu")
    x = np.zeros((1, 784), np.float32)
    with pytest.raises(ValueError, match="impl"):
        model(x, Context(mode=Mode.PFP, impl="xla", device="cpu"))
    with pytest.raises(ValueError, match="formulation"):
        model(x, Context(mode=Mode.PFP, formulation="joint", device="cpu"))


def test_init_is_reproducible_from_a_seeded_generator():
    make = lambda: LeNet5(  # noqa: E731
        generator=torch.Generator().manual_seed(7), device="cpu")
    a, b = make().state_dict(), make().state_dict()
    assert list(a) == [f"{layer}.{p}.{leaf}"
                       for layer in ("conv0", "conv1", "dense0", "dense1",
                                     "dense2")
                       for p in ("w", "b") for leaf in ("mu", "rho")]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tuple(a["conv1.w.mu"].shape) == (5, 5, 6, 16)


def test_dirty_mnist_copy_makes_the_reference_data():
    (xt, yt), evals = dirty_mnist.dirty_mnist(n_train=20, n_eval=6, seed=3)
    (jxt, jyt), jevals = jax_data.dirty_mnist(n_train=20, n_eval=6, seed=3)
    np.testing.assert_array_equal(xt, jxt)
    np.testing.assert_array_equal(yt, jyt)
    for split in ("clean", "ambiguous", "ood"):
        np.testing.assert_array_equal(evals[split][0], jevals[split][0])
