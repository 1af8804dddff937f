"""The port's serve CLI, op profiler, run metadata, schemas and validator.

``repro_torch.launch.serve.main(argv)`` runs in-process on the CPU at the
reduced granite-8b (``--device cpu --reduced``): a single engine; a paged
engine with prefix sharing and ``--expect-prefix-hits``; ``--speculate
2``; ``--replicas 2``; ``--replicas 2 --disaggregate``, whose three
exports pass ``repro_torch.obs.validate``; the reference's no-op
``--engine``. Each exits 0; ``--disaggregate``
without ``--page-size`` exits 2, and without ``--device cpu`` and with no
card the CLI raises. The summary key tuples equal the reference's letter
for letter; they are read from ``src/repro/launch/serve.py`` with ``ast``,
because importing it sets ``XLA_FLAGS``.

Observability: ``TRACE_EVENT_SCHEMA`` and the registry family schema equal
the reference's, and both packages' validators give the same errors on the
same good and broken trace events and metrics payloads (the payloads' meta
carries both packages' provenance keys, the one place the schemas
differ). ``run_metadata()`` on the CPU reads "unknown" for every device
fact and raises nothing. A profiled reduced forward (one init drawn in the
port from seed 0, converted, handed to the reference with
``numpy_params``) gives the bits of an unprofiled one, and its ``(op,
calls)`` rows equal the reference's ``profile_ops`` rows of the same
forward (``eager`` against ``xla``); the one difference is the impl
label of the residual add, which takes no impl in either package and so
runs under each registry's default (the port's ``kernel``, the
reference's ``xla``; both impls are one function). ``python -m
repro_torch.tuning`` runs the autotuner CLI. The ``gpu`` test serves the
fleet through the CLI under the kernel impl on the card and skips where
there is none.
"""
import ast
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.core import dispatch
from repro_torch.core.modes import Mode
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.nn.module import Context, numpy_params
from repro_torch.obs import profile_ops, run_metadata, validate
from repro_torch.obs import schema as port_schema

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-8b"
KEY_TUPLES = ("_SUMMARY_KEYS", "_PAGED_KEYS", "_PREFIX_KEYS", "_MOE_KEYS",
              "_SPEC_KEYS", "_FLEET_KEYS", "_DISAGG_KEYS")
CPU = ["--device", "cpu", "--reduced", "--requests", "6", "--tokens", "4",
       "--prompt-len", "12"]
FLEET = ["--page-size", "16", "--prefix-sharing", "--common-prefix", "8",
         "--expect-route-hits"]


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.core.modes import Mode as JMode
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    from repro.obs import profiler as jprofiler
    from repro.obs import schema as jschema
    return dict(jax=jax, jnp=jnp, reduced=jreduced, Mode=JMode, lm=jlm,
                Context=JContext, profiler=jprofiler, schema=jschema)


@pytest.fixture(scope="module")
def model():
    cfg = reduced_config(ARCH)
    return cfg, svi_to_pfp(lm.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_summary_key_tuples_match_reference():
    tree = ast.parse((ROOT / "src/repro/launch/serve.py").read_text())
    want = {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in KEY_TUPLES}
    assert set(want) == set(KEY_TUPLES)
    for name, keys in want.items():
        assert getattr(serve, name) == keys, name


@pytest.mark.parametrize("extra", [
    [],
    ["--page-size", "4", "--prefix-sharing", "--common-prefix", "8",
     "--expect-prefix-hits"],
    ["--page-size", "4", "--speculate", "2"],
    ["--replicas", "2"] + FLEET,
], ids=["engine", "prefix", "speculate", "replicas"])
def test_serve_cli_exits_zero(extra, capsys):
    assert serve.main(CPU + extra) == 0
    out = capsys.readouterr().out
    assert "summary" in out and "served" in out


def test_serve_cli_takes_the_no_op_engine_flag(capsys):
    """The reference's usage line without ``--devices``: ``--engine`` is a
    no-op compatibility flag in both packages."""
    assert serve.main(["--reduced", "--engine", "--tokens", "4",
                       "--device", "cpu"]) == 0
    assert "summary" in capsys.readouterr().out


def test_serve_cli_disaggregated_exports_validate(tmp_path, capsys):
    trace, metrics, prom = (tmp_path / "obs" / name for name in
                            ("trace.jsonl", "metrics.json", "metrics.prom"))
    rc = serve.main(CPU + ["--replicas", "2", "--disaggregate",
                           "--profile-ops", "--trace-out", str(trace),
                           "--metrics-out", str(metrics),
                           "--prom-out", str(prom)] + FLEET)
    assert rc == 0
    out = capsys.readouterr().out
    assert "bit-for-bit the single-engine stream" in out
    assert "handoffs" in out and "attention_paged" in out
    assert validate.main(["--trace", str(trace), "--metrics", str(metrics),
                          "--prom", str(prom)]) == 0
    payload = json.loads(metrics.read_text())
    assert set(payload["registries"]) == {
        "fleet", "r0.prefill", "r0.decode", "r1.prefill", "r1.decode"}
    assert payload["summary"]["handoffs"] == 6
    assert payload["op_profile"]["rows"]
    assert (tmp_path / "obs" / "trace.chrome.json").exists()


def test_serve_cli_refusals(monkeypatch, capsys):
    assert serve.main(CPU + ["--replicas", "2", "--disaggregate"]) == 2
    assert "--disaggregate requires" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_tuning_module_runs_the_autotuner(monkeypatch, tmp_path, capsys):
    from repro_torch.tuning import cache
    db = tmp_path / "db.json"
    monkeypatch.setattr(sys, "argv", [
        "repro_torch.tuning", "--device", "cpu", "--reduced", "--layers",
        "1", "--batch", "1", "--seq", "8", "--decode-slots", "0", "--fuse",
        "--save", str(db)])
    try:
        runpy.run_module("repro_torch.tuning", run_name="__main__")
    finally:
        cache.reset_global_cache()
    assert "[autotune] tuned" in capsys.readouterr().out
    assert db.exists()


# ---------------------------------------------------------------------------
# Schemas, validator, run metadata
# ---------------------------------------------------------------------------
def test_schemas_match_reference(jax_ref):
    assert port_schema.TRACE_EVENT_SCHEMA == \
        jax_ref["schema"].TRACE_EVENT_SCHEMA
    assert port_schema._FAMILY_SCHEMA == jax_ref["schema"]._FAMILY_SCHEMA


_GOOD_EVENT = {"step": 3, "seq": 7, "lane": "r0.decode", "event": "handoff",
               "uid": 4, "ticks": 0}
_EVENTS = [
    _GOOD_EVENT,
    dict(_GOOD_EVENT, wall=0.25),
    {k: v for k, v in _GOOD_EVENT.items() if k != "lane"},
    dict(_GOOD_EVENT, step=-1),
    dict(_GOOD_EVENT, event="teleport"),
    dict(_GOOD_EVENT, uid="4"),
    dict(_GOOD_EVENT, seq=True),
    dict(_GOOD_EVENT, wall=-1.0),
    [1, 2],
]


def _payloads():
    meta = dict(run_metadata(), jax_version="0", jaxlib_version="0",
                interpret_mode=True)
    fam = {"type": "counter", "help": "tokens served",
           "values": [{"labels": {}, "value": 3}]}
    good = {"meta": meta, "summary": {"tokens": 3},
            "registries": {"r0": {"tokens": fam}}}
    return [
        good,
        dict(good, op_profile={"rows": []}),
        {k: v for k, v in good.items() if k != "summary"},
        dict(good, registries={"r0": 5}),
        dict(good, registries={"r0": {"tokens": dict(fam, type="meter")}}),
        dict(good, registries={"r0": {"tokens": {"type": "gauge"}}}),
        dict(good, op_profile=[]),
        dict(good, meta=dict(meta, git_sha=7)),
        "not an object",
    ]


def test_validators_agree_with_reference(jax_ref):
    js = jax_ref["schema"]
    for event in _EVENTS:
        assert port_schema.validate(event, port_schema.TRACE_EVENT_SCHEMA) \
            == js.validate(event, js.TRACE_EVENT_SCHEMA), event
    verdicts = []
    for payload in _payloads():
        got = port_schema.validate_metrics_payload(payload)
        assert got == js.validate_metrics_payload(payload), payload
        verdicts.append(not got)
    assert verdicts == [True, True] + [False] * 7


def test_validate_cli_reports_every_problem(tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    trace.write_text("\n".join(json.dumps(e) for e in _EVENTS[:2]) + "\n")
    metrics = tmp_path / "m.json"
    metrics.write_text(json.dumps(_payloads()[0]))
    prom = tmp_path / "m.prom"
    prom.write_text("# TYPE tokens counter\ntokens{lane=\"r0\"} 3\n")
    args = ["--trace", str(trace), "--metrics", str(metrics), "--prom",
            str(prom)]
    assert validate.main(args) == 0
    trace.write_text("\n".join(json.dumps(e) for e in _EVENTS[2:5])
                     + "\nnot json\n")
    metrics.write_text("{")
    prom.write_text("")
    assert validate.main(args) == 1
    err = capsys.readouterr().err
    assert err.count("INVALID") == 6, err


def test_run_metadata_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.obs import runmeta
    runmeta.device_kind.cache_clear()
    try:
        meta = run_metadata()
    finally:
        runmeta.device_kind.cache_clear()
    assert set(meta) == {"git_sha", "device_kind", "backend",
                         "torch_version", "cuda_version", "power_limit",
                         "tf32_off"}
    assert meta["backend"] == "cpu"
    assert meta["device_kind"] == meta["power_limit"] == "unknown"
    assert meta["torch_version"] == torch.__version__
    assert meta["tf32_off"] is True
    assert not port_schema.validate(meta,
                                    port_schema.METRICS_SCHEMA[
                                        "properties"]["meta"])


# ---------------------------------------------------------------------------
# The op profiler
# ---------------------------------------------------------------------------
def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 8)).astype(np.int32)


def test_profiled_forward_same_bits_and_rows_as_reference(jax_ref, model):
    cfg, m = model
    tokens = _tokens(cfg)
    ctx = Context(mode=Mode.PFP, impl="eager", device="cpu")
    plain, _, _ = lm.forward(m, cfg, {"tokens": tokens}, ctx)
    with profile_ops() as prof:
        got, _, _ = lm.forward(m, cfg, {"tokens": tokens}, ctx)
    assert dispatch.get_profiler() is None
    assert torch.equal(got.mean, plain.mean)
    assert torch.equal(got.var, plain.var)
    rows = sorted((r["op"], r["calls"]) for r in prof.table())
    # The one difference: the residual add takes no impl in either
    # package, so it runs under the registry's default, which is the
    # port's "kernel" and the reference's "xla" (both impls of the op are
    # one function in each package).
    assert {r["op"]: r["impl"] for r in prof.table()
            if r["impl"] != "eager"} == {"residual": "kernel"}

    jax, J = jax_ref["jax"], jax_ref
    params = jax.tree_util.tree_map(J["jnp"].asarray, numpy_params(m))
    with J["profiler"].profile_ops() as jprof:
        J["lm"].forward(params, J["reduced"](ARCH),
                        {"tokens": J["jnp"].asarray(tokens)},
                        J["Context"](mode=J["Mode"].PFP, impl="xla"))
    assert rows == sorted((r["op"], r["calls"]) for r in jprof.table())
    assert all(r["impl"] == "xla" for r in jprof.table())
    summary = prof.summary()
    assert summary["cache_consults"] == 0 and summary["fallbacks"] == {}
    assert "tuning cache: 0 consults" in prof.format_table()


def test_profiler_counts_consults_and_fallbacks():
    x = torch.ones((2, 3))
    w = dispatch.as_gaussian(torch.ones((3, 4)))
    dispatch.reset_fallbacks()
    with profile_ops() as prof:
        dispatch._schedule_for("norm_dense_act", (2, 3, 4), torch.float32,
                               "cpu")
        dispatch.pfp_einsum("ij,jk->ik", x, w, impl="kernel")
    assert prof.cache_consults == prof.cache_misses == 1
    assert prof.cache_by_op == {"norm_dense_act": [1, 0]}
    assert prof.fallbacks == {"einsum:ij,jk->ik:srm": 1}
    assert dispatch.FALLBACKS == prof.fallbacks
    assert "eager fallbacks: einsum:ij,jk->ik:srm x1" in prof.format_table()
    assert [r["op"] for r in prof.table()] == ["einsum"]
    dispatch.reset_fallbacks()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_serve_cli_fleet_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    paths = [str(tmp_path / n) for n in ("t.jsonl", "m.json", "m.prom")]
    reset_launch_counts()
    rc = serve.main(["--reduced", "--impl", "kernel", "--replicas", "2",
                     "--disaggregate", "--profile-ops", "--trace-out",
                     paths[0], "--metrics-out", paths[1], "--prom-out",
                     paths[2]] + FLEET)
    assert rc == 0
    assert LAUNCHES["attention_paged"] > 0 and LAUNCHES["dense"] > 0
    assert validate.main(["--trace", paths[0], "--metrics", paths[1],
                          "--prom", paths[2]]) == 0
    meta = json.loads(Path(paths[1]).read_text())["meta"]
    assert meta["backend"] == "cuda" and meta["device_kind"] != "unknown"
