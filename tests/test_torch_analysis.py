"""The port's static audit (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

Each test of ``tests/test_analysis.py`` that has a counterpart has one here
(same name where the check is the same), and the port is held to
``repro`` on the same shapes: the ``chain_info`` tree of every factory
optimizer, ``expected_launches`` and ``lowrank_plan_stats`` on every
``matrix_configs()`` cell, the lint codes of the doctored chains,
``projected_state_bytes`` and ``per_shard_memory`` on llama-60m's SMOKE and
the fields of ``expected_collective_schedule`` the two schedules share.

The port traces an update on ``meta`` tensors where the reference traces a
jaxpr; its data-parallel step runs as rank 0 of a ``fake`` process group
where the reference traces on an ``AbstractMesh``.  Where a reference
function fails on this machine's jax (``trace_sharded_step`` builds an
``AbstractMesh`` without ``axis_names``; ``jax.experimental.enable_x64`` is
gone), the port is held to the reference test's own stated numbers, and the
test says so.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.analysis as J
from repro.analysis.audit import default_params as j_default_params
from repro.analysis.audit import matrix_configs as j_matrix_configs
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.core import combinators as JC
from repro.core.combinators import chain_info as j_chain_info
from repro_torch.analysis import (
    AuditReport,
    ChainLintError,
    CollectiveRecord,
    audit_optimizer,
    audit_sharded,
    audit_summary,
    collective_schedule_findings,
    dtype_flow_findings,
    expected_collective_schedule,
    expected_launches,
    inplace_findings,
    lint_chain,
    lowrank_plan_stats,
    memory_crosscheck,
    per_shard_memory,
    projected_state_bytes,
    recompile_findings,
    replication_findings,
    trace_sharded_step,
    trace_update,
    wire_bytes_model,
)
from repro_torch.analysis.audit import (
    _cell_name,
    arch_model,
    default_params,
    launch_findings,
    main,
    matrix_configs,
)
from repro_torch.analysis.findings import CODES
from repro_torch.core import OptimizerConfig, Transform, build_optimizer, chain_info
from repro_torch.core import combinators as C
from repro_torch.core.rank_policy import RankMap
from repro_torch.kernels import launch_count
from torch_threads import _one_thread  # noqa: F401  (autouse)

PARAMS = default_params()
J_PARAMS = j_default_params()


def codes(findings):
    return {f.code for f in findings}


def _msg(findings, code):
    return next(f.message for f in findings if f.code == code)


def _kw(cfg) -> dict:
    """An OptimizerConfig's fields for the other package (the reference's
    matrix traces at kernel_impl="jnp", the port's at "auto")."""
    out = {k: getattr(cfg, k) for k in ("name", "rank", "period", "gamma", "fuse_families",
                                        "fused_epilogue", "rank_ladder")}
    return out


# ------------------------------------------------------------ pass matrix


def test_audit_matrix_all_clean(capsys):
    """Acceptance: ``python -m repro_torch.analysis.audit --matrix --json``
    exits 0 — every factory optimizer x fuse_families x fused_epilogue
    audits clean: chain lint, launch model vs traced dispatch counts,
    dtype flow, signature stability across the rank ladder."""
    assert main(["--matrix", "--json"]) == 0
    reports = json.loads(capsys.readouterr().out)
    dirty = {k: r["findings"] for k, r in reports.items() if not r["ok"]}
    assert not dirty, dirty
    # 6 lowrank optimizers x 4 fuse combos + 4 full-rank baselines
    assert len(reports) == 28
    assert list(reports) == [_cell_name(c) for c in matrix_configs()]


@pytest.mark.parametrize("opt,epi,want", [
    ("gum", False, {"project": 3, "newton_schulz": 3, "back_project": 3}),
    ("gum", True, {"project": 3, "newton_schulz": 3, "back_project": 3}),
    ("galore_muon", True, {"lowrank_update": 3, "newton_schulz": 3,
                           "back_project_epilogue": 3}),
    ("golore", True, {"lowrank_update": 3, "newton_schulz": 3,
                      "back_project_epilogue": 3}),  # default base=muon
], ids=["gum", "gum_epilogue", "galore_muon_epilogue", "golore_epilogue"])
def test_static_launches_match_traced_on_family_tree(opt, epi, want):
    """The closed-form expectation equals the dispatch counts of an update on
    ``meta`` tensors, on the 3-family reference tree — one launch set per
    family (GUM: 9/step)."""
    cfg = OptimizerConfig(name=opt, rank=8, period=5, gamma=1, fuse_families=True,
                          fused_epilogue=epi)
    t = build_optimizer(cfg)
    expected, model_findings = expected_launches(t, PARAMS)
    assert not model_findings
    assert expected == want
    state = t.init(PARAMS)
    with launch_count.assert_launches(expected):
        t.update(PARAMS, state, PARAMS)


def test_assert_launches_raises_on_mismatch():
    t = build_optimizer(OptimizerConfig(name="galore", rank=8, period=5, fuse_families=True))
    state = t.init(PARAMS)
    with pytest.raises(launch_count.LaunchCountMismatch, match="project"):
        with launch_count.assert_launches({"project": 999, "back_project": 3}):
            t.update(PARAMS, state, PARAMS)
    with pytest.raises(ValueError, match="unknown op"):
        with launch_count.assert_launches({"warp_drive": 1}):
            pass


def test_format_counts_equals_the_reference():
    for counts in ({}, {"project": 3, "back_project_epilogue": 3, "newton_schulz": 6},
                   {"lowrank_update": 7, "project": 14, "back_project": 14,
                    "newton_schulz": 14}):
        assert launch_count.format_counts(counts) == J.audit.launch_count.format_counts(counts)


# ------------------------------------------------- parity with repro


FACTORY = ["adamw", "sgdm", "muon", "galore", "galore_muon", "golore", "gum",
           "unbiased_galore_adam", "fira", "lisa"]
VARIANTS = {"plain": {}, "fused": dict(fuse_families=True, fused_epilogue=True),
            "policy": dict(telemetry=True, rank_policy="spectral:0.9", rank_ladder=(4, 8, 16))}


def _same_info(want, got, path=""):
    """Key for key; ``label_fn`` by its labels on the reference tree,
    ``rank_policy`` by presence, a RankMap by its assignment."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (path, sorted(want), sorted(got))
        for k in want:
            if k == "label_fn":
                assert want[k](J_PARAMS) == got[k](PARAMS), path
            elif k == "rank_policy":
                assert (want[k] is None) == (got[k] is None), path
            elif k == "rank" and not isinstance(want[k], int):
                assert (want[k].default, tuple(want[k].overrides)) == \
                    (got[k].default, tuple(got[k].overrides)), path
            else:
                _same_info(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same_info(a, b, f"{path}[{i}]")
    else:
        assert want == got, (path, want, got)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", FACTORY)
def test_chain_info_equals_the_reference(name, variant):
    kw = dict(name=name, rank=16, **VARIANTS[variant])
    _same_info(j_chain_info(j_build_optimizer(JOptimizerConfig(**kw))),
               chain_info(build_optimizer(OptimizerConfig(**kw))))


def test_lowrank_update_variants_carry_the_same_chain_info():
    """Each update function ``lowrank`` returns carries the reference's
    dict: per leaf and family-stacked (which also runs the ZeRO split)."""
    for fuse in (False, True):
        t = C.lowrank(C.scale_by_momentum(0.9), rank=4, period=2, fuse_families=fuse)
        jt = JC.lowrank(JC.scale_by_momentum(0.9), rank=4, period=2, fuse_families=fuse)
        _same_info(j_chain_info(jt), chain_info(t))


@pytest.mark.parametrize("cell", range(28))
def test_launch_model_and_plans_equal_the_reference(cell):
    """``expected_launches``, ``lowrank_plan_stats`` and
    ``projected_state_bytes`` of each matrix cell equal the reference's on
    the same tree."""
    cfg, jcfg = matrix_configs()[cell], j_matrix_configs()[cell]
    assert _kw(cfg) == _kw(jcfg)
    t, jt = build_optimizer(cfg), j_build_optimizer(jcfg)
    assert expected_launches(t, PARAMS)[0] == J.expected_launches(jt, J_PARAMS)[0]
    assert lowrank_plan_stats(t, PARAMS) == J.lowrank_plan_stats(jt, J_PARAMS)
    assert projected_state_bytes(t, PARAMS) == J.projected_state_bytes(jt, J_PARAMS)


def _doctored(M):
    """The reference test's doctored chains, built from either package's
    combinators ``M``, with the ladder each is linted against."""
    return {
        "RC101": (M.chain(M.lowrank(M.lowrank(M.scale_by_momentum(0.9), rank=4, period=2),
                                    rank=8, period=2), M.scale_by_lr(1e-2)), ()),
        "RC102": (M.chain(M.layerwise_unbias(M.scale_by_momentum(0.9), gamma=1),
                          M.scale_by_lr(1e-2)), ()),
        "RC103": (M.chain(M.scale_by_lr(1e-2), M.scale_by_momentum(0.9)), ()),
        "RC103_inner": (M.chain(M.lowrank(M.chain(M.scale_by_momentum(0.9),
                                                  M.scale_by_lr(1e-2)), rank=4, period=2),
                                M.scale_by_lr(1e-2)), ()),
        "RC103_missing": (M.chain(M.lowrank(M.scale_by_momentum(0.9), rank=4, period=2)), ()),
        "RC104": (M.chain(M.lowrank(M.scale_by_momentum(0.9), rank=16, period=2),
                          M.scale_by_lr(1e-2)), (16, 8, 16)),
        "RC105": (M.chain(M.lowrank(M.scale_by_momentum(0.9), rank=5, period=2),
                          M.scale_by_lr(1e-2)), (8, 16)),
        "RC106": (M.chain(M.lowrank(M.scale_by_momentum(0.9), rank=4, period=2,
                                    pad_rank_to=96), M.scale_by_lr(1e-2)), ()),
        "clean": (M.chain(M.lowrank(M.scale_by_momentum(0.9), rank=8, period=2),
                          M.scale_by_lr(1e-2)), (8, 16)),
    }


@pytest.mark.parametrize("case", list(_doctored(C)))
def test_lint_codes_equal_the_reference(case):
    (t, ladder), (jt, _) = _doctored(C)[case], _doctored(JC)[case]
    got, want = lint_chain(t, ladder=ladder), J.lint_chain(jt, ladder=ladder)
    assert [(f.code, f.severity, f.where) for f in got] == \
        [(f.code, f.severity, f.where) for f in want]


def _smoke_trees():
    """llama-60m SMOKE: the port's parameters on ``meta`` and the
    reference's ``eval_shape``'d ones."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import build_model as j_build_model

    model = arch_model("llama-60m-smoke")
    jparams = jax.eval_shape(j_build_model(j_get_smoke("llama-60m")).init,
                             jax.random.PRNGKey(0))
    return model.params(), jparams


@pytest.mark.parametrize("name,kw", [
    ("gum", {}), ("gum", dict(fuse_families=True, shard_state=True)),
    ("galore", dict(fuse_families=True, fused_epilogue=True)), ("fira", {}),
    ("gum", dict(telemetry=True)), ("unbiased_galore_adam", {}), ("lisa", {}),
], ids=["gum", "gum_zero", "galore_epilogue", "fira", "gum_telemetry", "uga", "lisa"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_state_bytes_equal_the_reference_on_the_smoke_model(name, kw, n_shards):
    """``projected_state_bytes`` and ``per_shard_memory`` on llama-60m's
    SMOKE tree equal the reference's (its int32 counters and slot indices
    counted as it holds them)."""
    params, jparams = _smoke_trees()
    kw = dict(name=name, rank=4, gamma=1, period=3, **kw)
    t, jt = build_optimizer(OptimizerConfig(**kw)), j_build_optimizer(JOptimizerConfig(**kw))
    assert projected_state_bytes(t, params) == J.projected_state_bytes(jt, jparams)
    state = t.init(params)
    jstate = jax.eval_shape(jt.init, jparams)
    batch = {"tokens": torch.empty((8, 64), dtype=torch.int32, device="meta")}
    jbatch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
    shard = bool(kw.get("shard_state"))
    assert per_shard_memory(params, state, batch, n_shards=n_shards, shard_state=shard) == \
        J.per_shard_memory(jparams, jstate, jbatch, n_shards=n_shards, shard_state=shard)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_schedule_shared_fields_equal_the_reference(n_shards, fused):
    """``grad_psum`` and ``loss_psum`` — the fields the two schedules share —
    equal the reference's; the refresh-boundary gather the reference models
    is never issued by the port (count 0, the same families)."""
    params, jparams = _smoke_trees()
    kw = dict(name="gum", rank=4, gamma=1, period=3, fuse_families=fused)
    got = expected_collective_schedule(build_optimizer(OptimizerConfig(**kw)), params,
                                       n_shards=n_shards)
    want = J.expected_collective_schedule(j_build_optimizer(JOptimizerConfig(**kw)), jparams,
                                          n_shards=n_shards)
    for key in ("grad_psum", "loss_psum"):
        assert got[key] == want[key], key
    assert got["boundary_gather"]["count"] == 0
    assert got["boundary_gather"]["families"] == want["boundary_gather"]["families"]


# ------------------------------------------------- chain linter (RC1xx)


def test_rc101_nested_lowrank():
    fs = lint_chain(_doctored(C)["RC101"][0])
    assert "RC101" in codes(fs)
    assert "nested" in _msg(fs, "RC101")


def test_rc102_unbias_outside_lowrank():
    fs = lint_chain(_doctored(C)["RC102"][0])
    assert "RC102" in codes(fs)
    assert "lowrank" in _msg(fs, "RC102")


def test_rc103_scale_by_lr_not_terminal():
    fs = lint_chain(_doctored(C)["RC103"][0])
    assert any(f.code == "RC103" and f.severity == "error" for f in fs)
    # ... and inside lowrank() is also an error
    assert "RC103" in codes(lint_chain(_doctored(C)["RC103_inner"][0]))
    # missing entirely (with a lowrank stage) is only a warning
    fs3 = lint_chain(_doctored(C)["RC103_missing"][0])
    assert any(f.code == "RC103" and f.severity == "warning" for f in fs3)
    assert not any(f.severity == "error" for f in fs3)


def test_rc104_non_monotone_ladder():
    fs = lint_chain(_doctored(C)["RC104"][0], ladder=(16, 8, 16))
    assert "RC104" in codes(fs)
    assert "strictly increasing" in _msg(fs, "RC104")


def test_rc105_initial_rank_off_ladder():
    fs = lint_chain(_doctored(C)["RC105"][0], ladder=(8, 16))
    assert "RC105" in codes(fs)
    assert "[5]" in _msg(fs, "RC105")
    assert "RC105" not in codes(lint_chain(_doctored(C)["clean"][0], ladder=(8, 16)))


def test_rc106_unaligned_pad_rank():
    fs = lint_chain(_doctored(C)["RC106"][0])
    assert "RC106" in codes(fs)
    assert "128" in _msg(fs, "RC106")  # the fix-it suggests the granule


def test_build_optimizer_audit_raises():
    """audit=True turns lint errors into a build-time ChainLintError."""
    cfg = OptimizerConfig(name="gum", rank=5, period=5, gamma=1, rank_ladder=(8, 16))
    with pytest.raises(ChainLintError, match="RC105"):
        build_optimizer(cfg, audit=True)
    build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1,
                                    rank_ladder=(8, 16)), audit=True)


# ------------------------------------------- dtype-flow auditor (RA2xx)


def _elementwise_transform(fn):
    return Transform(lambda p: (), lambda g, s, p: ({k: fn(x) for k, x in g.items()}, s))


def test_ra201_f64_leak():
    """(The reference's test needs ``jax.experimental.enable_x64``, gone
    from this machine's jax; torch has float64 without a flag.)"""
    t = _elementwise_transform(lambda x: x.to(torch.float64))
    fs = dtype_flow_findings(trace_update(t, {"w": torch.empty(8, 8, device="meta")}))
    assert "RA201" in codes(fs)
    assert "f64" in _msg(fs, "RA201")


def test_ra202_bf16_roundtrip():
    t = _elementwise_transform(lambda x: x.to(torch.bfloat16).to(torch.float32) * 2.0)
    trace = trace_update(t, PARAMS)
    fs = dtype_flow_findings(trace)
    assert "RA202" in codes(fs)
    # the allowlist knob suppresses it
    assert "RA202" not in codes(dtype_flow_findings(trace, allow_bf16_roundtrip=True))
    # a downcast kept in bf16 is no round-trip
    keep = _elementwise_transform(lambda x: x.to(torch.bfloat16) * 2)
    assert not dtype_flow_findings(trace_update(keep, PARAMS))


def test_dtype_flow_clean_on_factory_step():
    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1))
    assert not dtype_flow_findings(trace_update(t, PARAMS))


# ---------------------------------------- launch/fusion auditor (RA3xx)


def test_ra301_launch_divergence():
    fs = launch_findings({"project": 3, "back_project": 3}, {"project": 8, "back_project": 3},
                         fused_epilogue=False, where="x")
    assert codes(fs) == {"RA301"}
    assert "expected 3, traced 8" in _msg(fs, "RA301")


def test_ra302_stray_back_projection():
    fs = launch_findings({"lowrank_update": 3, "back_project_epilogue": 3},
                         {"lowrank_update": 3, "back_project": 3}, fused_epilogue=True, where="x")
    assert codes(fs) == {"RA302"}
    assert "back_project" in _msg(fs, "RA302")


def test_ra303_unmodelable_stage():
    opaque = Transform(lambda p: (), lambda g, s, p: (g, s))
    t = C.chain(C.lowrank(opaque, rank=4, period=2), C.scale_by_lr(1e-2))
    _, fs = expected_launches(t, PARAMS)
    assert "RA303" in codes(fs)


def test_launch_model_counts_both_unbias_branches_when_q_lt_1():
    """Leaves with lead blocks (q = gamma/L < 1) run BOTH layerwise_unbias
    branches — the compensated sample AND the plain low-rank path — and the
    closed-form model counts both."""
    lead_params = {
        "blocks/wq": torch.empty(3, 64, 64, device="meta"),
        "blocks/wo": torch.empty(3, 64, 64, device="meta"),
        "norm/scale": torch.empty(64, device="meta"),
    }
    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1))
    expected, findings = expected_launches(t, lead_params, name="gum")
    assert findings == []
    assert expected == {"project": 2, "lowrank_update": 2, "newton_schulz": 4,
                        "back_project": 4}
    state = t.init(lead_params)
    with launch_count.assert_launches(expected):
        t.update(lead_params, state, lead_params)


# --------------------------------- recompilation-hazard detector (RA4xx)


def test_ra401_unstable_signature():
    counter = itertools.count(1)
    t = _elementwise_transform(lambda x: x * float(next(counter)))
    fs, _ = recompile_findings(lambda r: t, PARAMS, [4])
    assert "RA401" in codes(fs)


def test_ra402_has_no_eager_counterpart():
    """The reference flags a weak-typed 0-d constant captured by the jaxpr.
    Eager PyTorch has no weak types and compiles nothing: the code stays
    registered and the port never emits it, even for the reference's case
    (a 0-d tensor captured by the update)."""
    assert "RA402" in CODES
    weak = torch.tensor(0.5)
    t = _elementwise_transform(lambda x: x * weak.to(x.device))
    fs, _ = recompile_findings(lambda r: t, PARAMS, [4])
    assert "RA402" not in codes(fs) and not fs


def test_signature_stable_per_rank_for_factory():
    cfg = OptimizerConfig(name="galore", rank=8, period=5, rank_ladder=(4, 8))
    fs, hashes = recompile_findings(lambda r: build_optimizer(cfg, rank_map=RankMap(r)),
                                    PARAMS, (4, 8))
    assert not [f for f in fs if f.severity == "error"]
    # the ranks run different shapes, each rank's trace is stable
    assert len(set(hashes.values())) == 2


# ----------------------------------- static memory accountant (RA5xx)


def test_memory_crosscheck_matches_committed_bench():
    """The meta accountant reproduces the committed runtime proj_bytes_final
    of every rank-policy cell exactly, as the reference's does."""
    assert memory_crosscheck() == [] == J.memory_crosscheck()


def test_ra501_on_doctored_bench(tmp_path):
    real = json.loads(open("results/BENCH_rank_policy.json").read())
    real["results"]["fixed16"]["proj_bytes_final"] += 1
    doctored = tmp_path / "BENCH_rank_policy.json"
    doctored.write_text(json.dumps(real))
    fs = memory_crosscheck(doctored)
    assert "RA501" in codes(fs)
    assert any(f.code == "RA501" and "fixed16" in f.where for f in fs)
    assert "303137" in _msg(fs, "RA501")
    assert [f.severity for f in memory_crosscheck(tmp_path / "absent.json")] == ["info"]


# --------------------------------------------------------- integration


def test_audit_summary_one_liner():
    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1,
                                        fuse_families=True))
    line = audit_summary(t, PARAMS, name="gum")
    assert "launches/step=9" in line
    assert "proj_state=" in line and "sig=" in line
    assert "\n" not in line
    want = J.audit_summary(j_build_optimizer(JOptimizerConfig(
        name="gum", rank=8, period=5, gamma=1, kernel_impl="jnp", fuse_families=True)),
        J_PARAMS, name="gum")
    assert line.split(" sig=")[0] == want.split(" sig=")[0]


def test_audit_report_roundtrip():
    cfg = OptimizerConfig(name="golore", rank=8, period=5, fuse_families=True,
                          fused_epilogue=True, rank_ladder=(4, 8))
    rep = audit_optimizer(cfg, PARAMS, ladder=(4, 8))
    assert rep.ok, [f.format() for f in rep.errors]
    d = rep.to_json()
    assert d["ok"] and d["summary"]["launches_per_step"] == 9
    assert "back_project_epilogue" in d["summary"]["launch_counts"]
    assert d["summary"]["opt_state_realloc_bytes"] > 0
    assert isinstance(rep, AuditReport) and "clean" in rep.format()


def test_lowrank_plan_stats_geometry():
    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1,
                                        fuse_families=True))
    (s,) = lowrank_plan_stats(t, PARAMS, name="gum")
    assert s["fused"] and s["n_families"] == 3 and s["n_stacked"] == 8
    assert sorted(s["families"]) == ["128x64r8x2", "64x128r8x2", "64x64r8x4"]


def test_trace_draws_nothing():
    """A trace calls no sampler and no noise (they may hold state that a
    run's trajectory depends on) and adds to no outer launch counter."""
    def refuse(*args):
        raise AssertionError("drew on a trace")

    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1,
                                        projector="rsvd"), sampler=refuse, noise=refuse)
    with launch_count.count_launches() as outer:
        trace = trace_update(t, PARAMS)
    assert outer == {} and trace.counts
    lisa = build_optimizer(OptimizerConfig(name="lisa", gamma=1), sampler=refuse)
    trace_update(lisa, PARAMS)


# ------------------------------------------- sharded audit (RA6xx)
# The clean path at 1 / 2 / 8 shards on a fake process group (no second
# device); every RA6xx code then gets a doctored failing case.


def _rec(**kw):
    base = dict(primitive="all_reduce", tag="grad", axes=("data",), dtypes=("bfloat16",),
                shapes=((4096,),), n_operands=1, payload_bytes=8192, under_cond=False)
    base.update(kw)
    return CollectiveRecord(**base)


def _sharded_expected(n_leaves=1, payload=8192, update=0):
    return {
        "grad_psum": {"count": 1, "dtype": "bfloat16", "operands": n_leaves,
                      "payload_bytes": payload, "axis": "data", "phase": "steady"},
        "loss_psum": {"count": 1, "dtype": "float32", "operands": 1, "payload_bytes": 4,
                      "axis": "data", "phase": "steady"},
        "update_gather": {"count": int(update > 0), "dtype": "float32", "families": 1,
                          "payload_bytes": update, "axis": "data", "phase": "steady"},
        "probe_reduce": {"count": 0, "dtype": "float32", "payload_bytes": 0, "axis": "data",
                         "phase": "boundary"},
        "boundary_gather": {"count": 0, "families": 0, "payload_bytes": 0,
                            "phase": "boundary"},
        "n_shards": 2,
    }


_LOSS = dict(tag="loss", dtypes=("float32",), shapes=((1,),), payload_bytes=4)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_audit_clean_static_matches_traced(n_shards):
    """Acceptance: the data-parallel step's collectives match the closed-form
    schedule on 1/2/8-way meshes — one bf16 gradient all-reduce over every
    parameter leaf plus one fp32 loss all-reduce, nothing else — with the
    parameters written in place and a rank's rows of the batch.  (The
    reference's test traces on an ``AbstractMesh`` that this machine's jax
    refuses; its stated numbers — count 1, bfloat16, the ring's 2(N-1)/N —
    are held here.)"""
    cfg = OptimizerConfig(name="gum", rank=8, period=5, gamma=1)
    rep = audit_sharded(cfg, mesh_axes=(("data", n_shards),))
    assert rep.ok, [f.format() for f in rep.errors]
    exp = rep.summary["expected_schedule"]
    assert exp["grad_psum"]["count"] == 1
    assert exp["grad_psum"]["dtype"] == "bfloat16"
    wire = rep.summary["wire"]
    if n_shards == 1:
        assert wire["steady_bytes_per_step"] == 0
    else:
        want = int(exp["grad_psum"]["payload_bytes"] * 2 * (n_shards - 1) / n_shards) + int(
            exp["loss_psum"]["payload_bytes"] * 2 * (n_shards - 1) / n_shards)
        assert wire["steady_bytes_per_step"] == want, wire
    buf = rep.summary["buffers"]
    assert buf["params_in_place"] == buf["params"] and buf["rows_per_rank"] == [8 // n_shards]


def test_trace_sharded_step_schedule_shape():
    """The raw trace on an 8-way fake group: exactly two all-reduces a
    step — the bf16 gradient buffer of every leaf and the fp32 loss — and
    the group is gone afterwards.  (The reference's counterpart fails on
    this machine's jax; its numbers: 2 reductions, bf16 gradients carrying
    every leaf, an fp32 loss.)"""
    import torch.distributed as dist

    model = arch_model("llama-60m-smoke", device="cpu")
    model.init_params(0)
    t = build_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
    tr = trace_sharded_step(model, t, n_shards=8)
    assert not dist.is_initialized()
    steady = [r for r in tr.records if not r.under_cond]
    assert [(r.primitive, r.tag, r.dtypes) for r in steady] == \
        [("all_reduce", "grad", ("bfloat16",)), ("all_reduce", "loss", ("float32",))]
    grad = steady[0]
    assert grad.payload_bytes == 2 * sum(p.numel() for p in tr.params.values())
    assert steady[1].scalar_only and tr.counts["all_reduce"] == 2
    assert tr.rows == [1, 1]


def test_trace_sharded_step_refuses_a_live_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            trace_sharded_step(arch_model("llama-60m-smoke", device="cpu"),
                               build_optimizer(OptimizerConfig(name="adamw")), n_shards=2)
    finally:
        dist.destroy_process_group()


def test_sharded_state_audit_gathers_the_split_rows():
    """``shard_state`` at 2 ranks: the update all-gather each step carries
    what the closed form says (the split families' rows and the slots a
    rank cannot place), and a refresh adds the probe all-reduce when
    telemetry is on."""
    for tele in (False, True):
        cfg = OptimizerConfig(name="gum", rank=4, period=3, gamma=1, fuse_families=True,
                              shard_state=True, telemetry=tele)
        rep = audit_sharded(cfg, mesh_axes=(("data", 2),))
        assert rep.ok, [f.format() for f in rep.errors]
        exp = rep.summary["expected_schedule"]
        assert exp["update_gather"]["count"] == 1 and exp["probe_reduce"]["count"] == tele
        per = {(c["primitive"], c["tag"], c["phase"]): c["payload_bytes"]
               for c in rep.summary["wire"]["per_collective"]}
        assert per[("all_gather", "update", "steady")] == exp["update_gather"]["payload_bytes"]
        assert (("all_reduce", "probes", "boundary") in per) == tele


def test_ra601_wide_dtype_on_wire():
    recs = [_rec(dtypes=("float32",), payload_bytes=16384), _rec(**_LOSS)]
    fs = collective_schedule_findings(recs, _sharded_expected())
    assert "RA601" in codes(fs)
    assert "float32" in _msg(fs, "RA601")


def test_ra601_needs_no_barrier_pin():
    """The reference also flags a bf16 psum not pinned by an
    ``optimization_barrier`` (XLA may re-promote it); the port casts before
    it reduces, with no compiler to move the cast: a reduction at the
    declared dtype is clean."""
    assert not collective_schedule_findings([_rec(), _rec(**_LOSS)], _sharded_expected())


def test_ra602_unconditional_boundary_collective():
    recs = [_rec(), _rec(**_LOSS),
            _rec(tag="probes", dtypes=("float32",), shapes=((16,),), payload_bytes=64)]
    fs = collective_schedule_findings(recs, _sharded_expected())
    assert "RA602" in codes(fs)
    # an update gather where no state is split
    recs = [_rec(), _rec(**_LOSS),
            _rec(primitive="all_gather", tag="update", dtypes=("float32",), shapes=((8,),),
                 payload_bytes=32)]
    assert "RA602" in codes(collective_schedule_findings(recs, _sharded_expected()))


def test_ra603_full_gradient_gather_in_steady_state():
    params = {"w": torch.empty(64, 64, device="meta")}
    recs = [_rec(), _rec(**_LOSS),
            _rec(primitive="all_gather", tag="grads", dtypes=("float32",),
                 shapes=((2048,),), payload_bytes=8192)]
    fs = collective_schedule_findings(recs, _sharded_expected(), params=params)
    assert "RA603" in codes(fs)
    assert "RA602" not in codes(fs)


def test_ra606_schedule_divergence():
    # two gradient all-reduces where the model says one (per-leaf reduction)
    fs = collective_schedule_findings([_rec(), _rec(), _rec(**_LOSS)], _sharded_expected())
    assert "RA606" in codes(fs)
    # missing loss reduction
    assert "RA606" in codes(collective_schedule_findings([_rec()], _sharded_expected()))
    # an update gather of the wrong size, and none where one is due
    gather = _rec(primitive="all_gather", tag="update", dtypes=("float32",), shapes=((8,),),
                  payload_bytes=32)
    assert not collective_schedule_findings([_rec(), _rec(**_LOSS), gather],
                                            _sharded_expected(update=32))
    assert "RA606" in codes(collective_schedule_findings([_rec(), _rec(**_LOSS), gather],
                                                         _sharded_expected(update=64)))
    assert "RA606" in codes(collective_schedule_findings([_rec(), _rec(**_LOSS)],
                                                         _sharded_expected(update=32)))


def test_inplace_and_rows_clean_on_a_traced_step():
    """The counterpart of the reference's donation parse: a real step (two,
    on the fake group) writes every parameter in place and each rank's
    forward sees its rows."""
    model = arch_model("llama-60m-smoke", device="cpu")
    model.init_params(0)
    tr = trace_sharded_step(model, build_optimizer(OptimizerConfig(name="gum", rank=4,
                                                                   gamma=1, period=3)),
                            n_shards=2, batch_size=4)
    assert all(same and n > 0 for same, n in tr.param_writes.values())
    assert inplace_findings(tr.param_writes) == []
    assert replication_findings(tr.rows, global_batch=4, n_shards=2) == []
    assert tr.realloc_bytes > 0


def test_ra604_lost_inplace_update():
    writes = {"w": (True, 1), "v": (False, 1), "u": (True, 0)}
    fs = inplace_findings(writes)
    assert codes(fs) == {"RA604"}
    assert "2/3" in _msg(fs, "RA604")
    assert fs[0].detail == {"moved": ["v"], "unwritten": ["u"]}


def test_ra605_replicated_batch():
    fs = replication_findings([8, 8], global_batch=8, n_shards=2)
    assert codes(fs) == {"RA605"}
    # mesh of 1: replication is the only option, not a finding
    assert replication_findings([8], global_batch=8, n_shards=1) == []


def test_wire_bytes_ring_coefficients():
    recs = [_rec(payload_bytes=1000),
            _rec(primitive="all_gather", payload_bytes=1000, under_cond=True)]
    m = wire_bytes_model(recs, 8)
    assert m["steady_bytes_per_step"] == int(1000 * 2 * 7 / 8)
    assert m["boundary_bytes"] == int(1000 * 7 / 8)
    assert wire_bytes_model(recs, 1)["steady_bytes_per_step"] == 0
    j = J.wire_bytes_model([J.CollectiveRecord(
        primitive=p, axes=("data",), dtypes=("bfloat16",), shapes=((8,),), n_operands=1,
        payload_bytes=1000, under_cond=c, pinned=True, path=()) for p, c in
        (("psum", False), ("all_gather", True))], 8)
    assert (m["steady_bytes_per_step"], m["boundary_bytes"]) == \
        (j["steady_bytes_per_step"], j["boundary_bytes"])


def test_per_shard_memory_model():
    params = {"w": torch.empty(64, 64, device="meta")}
    opt = {"mu": torch.empty(64, 64, device="meta")}
    batch = {"tokens": torch.empty(8, 16, dtype=torch.int32, device="meta")}
    m = per_shard_memory(params, opt, batch, n_shards=8)
    assert m["params_bytes"] == 64 * 64 * 4
    assert m["grad_bytes_fp32"] == 64 * 64 * 4
    assert m["grad_wire_bytes"] == 64 * 64 * 2     # bf16 wire copy
    assert m["batch_bytes_per_shard"] == 8 * 16 * 4 // 8
    assert m["peak_bytes_per_shard"] == sum(
        m[k] for k in ("params_bytes", "opt_state_bytes", "grad_bytes_fp32",
                       "grad_wire_bytes", "batch_bytes_per_shard"))


def test_expected_schedule_counts_families():
    t = build_optimizer(OptimizerConfig(name="gum", rank=8, period=5, gamma=1,
                                        fuse_families=True))
    exp = expected_collective_schedule(t, PARAMS, n_shards=4)
    assert exp["grad_psum"]["operands"] == len(PARAMS)
    assert exp["boundary_gather"]["count"] == 0
    assert exp["boundary_gather"]["families"] == 3


def test_sharded_cli_is_clean(capsys):
    assert main(["--sharded", "--mesh", "data=2"]) == 0
    assert "audit sharded:gum@data=2: clean" in capsys.readouterr().out
