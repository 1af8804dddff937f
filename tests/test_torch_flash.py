"""Flash attention without a cache (row 9 of the TPU kernels) on the card.

On the CPU: the block's row count in the wrapper is the source's, and the
op runs the plain version. The tests marked ``gpu`` hold
``csrc/pfp_attention.cu`` ``pfp_attention_kernel`` against its plain
version (``kernels/ref.py`` ``pfp_attention_ref``) at ``ATT_TOL``: head_dim
16, 64 and 128, one and four query heads a KV head, Tq below Tk, causal and
not, Tq and Tk on no multiple of the block's 64 rows or the tile's 32
keys, and rows without a valid key (Tq above Tk, causal), which give 0; and
two calls give the same bits. No JAX: ``python -m pytest -m gpu
tests/test_torch_flash.py`` on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.pfp_attention import FLASH_ROWS
from repro_torch.kernels.ref import pfp_attention_ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "pfp_attention.cu")
ATT_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_decode.py
# (H, Hkv): G 4 as granite-8b, G 1 as deepseek-moe-16b.
HEADS = {"G4": (8, 2), "G1": (4, 4)}
# (Tq, Tk): equal and ragged, Tq below Tk, and one tile of keys or less.
LENGTHS = ((77, 77), (45, 203), (130, 161), (1, 40))


def _operands(b, h, hkv, tq, tk, d, seed, device="cpu"):
    rng = np.random.default_rng(seed)

    def draw(*shape, positive=False):
        a = rng.normal(size=shape).astype(np.float32)
        return np.log1p(np.exp(a)) if positive else a

    arrays = (draw(b, h, tq, d), draw(b, hkv, tk, d), draw(b, hkv, tk, d),
              draw(b, hkv, tk, d, positive=True))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_block_rows_are_the_sources():
    text = SOURCE.read_text()
    rows = re.findall(r"static constexpr int kRows = (\d+);", text)
    assert rows == [str(FLASH_ROWS)]


def test_op_on_the_cpu_is_the_plain_version():
    q, k, vm, vv = _operands(2, 8, 2, 9, 13, 16, seed=1)
    scale = 16 ** -0.5
    for causal in (True, False):
        got = ops.pfp_attention(q, k, vm, vv, scale=scale, causal=causal)
        want = pfp_attention_ref(q, k, vm, vv, scale, causal)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("d", (16, 64, 128))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("causal", (True, False))
def test_kernel_matches_plain_version(cuda, d, heads, causal):
    h, hkv = HEADS[heads]
    scale = d ** -0.5
    for i, (tq, tk) in enumerate(LENGTHS):
        args = _operands(2, h, hkv, tq, tk, d, seed=10 * i + d, device=cuda)
        got = ops.pfp_attention(*args, scale=scale, causal=causal)
        torch.cuda.synchronize()
        want = pfp_attention_ref(*(a.cpu() for a in args), scale, causal)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **ATT_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", (16, 64, 128))
def test_rows_without_a_key_give_zero(cuda, d):
    """Causal with Tq above Tk: the first Tq - Tk rows see no key."""
    h, hkv = HEADS["G4"]
    tq, tk = 70, 37
    args = _operands(2, h, hkv, tq, tk, d, seed=3, device=cuda)
    got = ops.pfp_attention(*args, scale=d ** -0.5, causal=True)
    want = pfp_attention_ref(*(a.cpu() for a in args), d ** -0.5, True)
    for g, w in zip(got, want):
        assert not g[:, :, :tq - tk].any()
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **ATT_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", (True, False))
def test_two_calls_give_the_same_bits(cuda, causal):
    args = _operands(4, 32, 8, 300, 300, 128, seed=7, device=cuda)
    first = ops.pfp_attention(*args, scale=128 ** -0.5, causal=causal)
    again = ops.pfp_attention(*args, scale=128 ** -0.5, causal=causal)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_musicgen_forward_shape(cuda):
    """musicgen-medium's forward: 24 heads of 64 over 24 KV heads (G 1),
    4 x 512 positions, causal; two calls give the same bits."""
    args = _operands(4, 24, 24, 512, 512, 64, seed=11, device=cuda)
    got = ops.pfp_attention(*args, scale=64 ** -0.5, causal=True)
    again = ops.pfp_attention(*args, scale=64 ** -0.5, causal=True)
    torch.cuda.synchronize()
    want = pfp_attention_ref(*(a.cpu() for a in args), 64 ** -0.5, True)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **ATT_TOL)
