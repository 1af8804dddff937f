"""Uncertainty-speculative decoding in the port, port against port, on the
CPU.

The setting of ``tests/torch_engine_spec_common.py`` (reduced granite-8b
carried from one JAX init; 3 slots of 24 rows), at pages of 1, 4 and 24:
speculative == plain under always-accept, never-accept, MI-gated routing
and eos; speculation with escalations == plain with escalations; the
accounting of a low-uncertainty trace. These compare tokens, finish reasons and MI
traces bit for bit: the reference allows ``MI_ATOL`` between pass shapes,
but the port's passes keep a row's bits.
"""
import pytest

from torch_engine_spec_common import (  # noqa: F401  (fixtures)
    EOS, PAGES, _assert_bit_for_bit, _engine, _served, _trace, jax_ref,
    plain, port_model)


@pytest.mark.parametrize("page_size", PAGES)
@pytest.mark.parametrize("mode", ["accept", "never", "gated", "eos"])
def test_speculative_equals_plain(port_model, plain, mode, page_size):
    """speculate_k 4 serves the plain engine's stream: natural drafts
    under OPEN (every draft accepted), drafts forced to mismatch (none
    accepted), MI-gated escalations deferred out of mid-block, eos served
    mid-block."""
    router = "gated" if mode == "gated" else "open"
    kw = dict(eos_id=EOS) if mode == "eos" else {}
    want = plain(page_size, router, **kw)
    eng = _engine(port_model, page_size=page_size, router=router,
                  speculate_k=4, **kw)
    if mode == "never":
        eng._draft_override = lambda d: (d + 1) % 97
    _assert_bit_for_bit(_served(eng, _trace()), want)
    m = eng.metrics.summary()
    assert m["decode_passes"] == 0         # every token came from a verify
    if mode == "accept":
        assert m["draft_acceptance_rate"] == 1.0
        assert m["pfp_passes_per_token"] < 1.0
    if mode == "never":
        assert m["accepted_draft_tokens"] == 0
    if mode == "gated":
        assert m["escalations"] > 0
        assert m["max_svi_passes_per_step"] <= 1
        _assert_bit_for_bit(plain(page_size, router,
                                  batch_escalations=False), want)
    if mode == "eos":
        assert any(v[2] == "eos" for v in want.values())


@pytest.mark.parametrize("page_size", PAGES)
def test_speculative_with_escalations_equals_plain(port_model, plain,
                                                   page_size):
    want = plain(page_size, "force", batch_escalations=False)
    eng = _engine(port_model, page_size=page_size, router="force",
                  speculate_k=4)
    _assert_bit_for_bit(_served(eng, _trace()), want)
    m = eng.metrics.summary()
    assert m["max_svi_passes_per_step"] <= 1 and m["escalations"] > 0


def test_speculative_accounting_low_uncertainty(port_model):
    """A low-uncertainty trace: fewer than one full-PFP pass per served
    token and no SVI pass."""
    eng = _engine(port_model, speculate_k=4)
    _served(eng, _trace(n=8))
    m = eng.metrics.summary()
    assert m["svi_passes"] == 0
    assert m["verify_passes"] == m["spec_rounds"]
    assert m["pfp_passes_per_token"] < 1.0
    assert m["accepted_tokens_per_verify"] > 0
    assert m["draft_acceptance_rate"] == 1.0
    assert m["decode_passes"] == 0
