"""The port's int8 gradient compression against the JAX reference, on the
CPU.

Hypothesis at the reference's example counts (``tests/
test_property_invariants.py``: 50 for the error bound, 30 for error
feedback), on sizes 1-300 that are not multiples of the 256-element block,
so every case pads its last block:

* ``q`` and the scales equal the reference's bit for bit on the same fp32
  numpy input (both packages divide, round half to even and clip alike);
* the reference's error bound, max |x - deq(q(x))| <= max|x| / 254 + 1e-7,
  and per block |x - deq(q(x))| <= scale / 2 + 2^-16 scale, the slack
  being the fp32 roundings of the division (at |x / scale| <= 127), the
  product and the difference, each at most 127 * 2^-24 scale;
* error feedback is lossless in sum over 5 steps (rtol / atol 1e-4, the
  reference's), with every step's ``q`` and scales the reference's.
"""
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.training import compression as jcomp
from repro_torch.training.compression import (compress_with_feedback,
                                              dequantize_int8, quantize_int8)

SIZES = st.integers(min_value=1, max_value=300).filter(lambda n: n % 256)
SCALES = st.floats(min_value=1e-3, max_value=1e3)
SLACK = 2.0 ** -16     # per-block error bound beyond scale / 2, in scales


def _block_error_bound_holds(x, q, scale):
    """Per block: |x - deq(q)| <= (1/2 + SLACK) * scale."""
    back = dequantize_int8(q, scale, x.shape)
    err = torch.zeros(q.numel())
    err[:x.numel()] = (x - back).abs().reshape(-1)
    return bool((err.reshape(q.shape) <= (0.5 + SLACK) * scale).all())


@settings(max_examples=50, deadline=None)
@given(SIZES, SCALES, st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_quantize_matches_reference_bit_for_bit(n, scale, seed):
    x = (scale * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_int8(q, s, (n,)).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, (n,))))


@settings(max_examples=50, deadline=None)
@given(SIZES, SCALES)
def test_int8_quantization_error_bound(n, scale):
    x = scale * torch.sin(torch.arange(n, dtype=torch.float32))
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, x.shape)
    max_err = float((back - x).abs().max())
    assert max_err <= float(x.abs().max()) / 254.0 + 1e-7
    assert _block_error_bound_holds(x, q, s)


@settings(max_examples=30, deadline=None)
@given(SIZES)
def test_error_feedback_is_lossless_in_sum(n):
    """Sum of reconstructions + final error == sum of gradients, and each
    step's q and scales equal the reference's on the same gradients."""
    grads = np.random.default_rng(n).standard_normal((5, n)).astype(
        np.float32)
    err, jerr = torch.zeros(n), jnp.zeros((n,))
    recon_sum = torch.zeros(n)
    for g in grads:
        target = torch.from_numpy(g) + err
        q, s, err = compress_with_feedback(torch.from_numpy(g), err)
        jq, js, jerr = jcomp.compress_with_feedback(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert _block_error_bound_holds(target, q, s)
        recon_sum = recon_sum + dequantize_int8(q, s, (n,))
    np.testing.assert_allclose((recon_sum + err).numpy(), grads.sum(0),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
