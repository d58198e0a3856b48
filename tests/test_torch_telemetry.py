"""The port's telemetry against the JAX package's (``repro.telemetry``).

* The bus: the reference test's ``FakeClock`` and ``_emit_fixture``
  reproduce ``tests/data/telemetry_golden.jsonl`` byte for byte (read,
  never written), and ``read_jsonl``, ``StdoutSink``, ``MemorySink`` and
  ``TelemetryConfig.parse`` behave as the reference's classes on the same
  input.
* The in-step probes: GUM at rank 4, gamma 1, period 3 over the reference
  test's two (16, 8) leaves and one bias (numpy-seeded), 7 updates, per
  leaf, family-stacked, and through the ``external_refresh`` hook: updates
  with telemetry on bitwise those with it off, ``lowrank_family_metrics``
  equal to the reference's after every update (names, rank and
  ``bias_step`` exactly; energy, drift and bias within 1e-5 absolute), and
  the ``GammaSlotTracker`` records equal.
* The Trainer: the reference test's ``_trainer`` (llama-60m SMOKE, 8 steps,
  period 4, checkpoints every 4, ``telemetry="stdout=0"``) against the port
  on the reference's initial parameters with its block draws injected, the
  two ``events.jsonl`` compared through the reference test's
  ``_stream_signature``; a seeded faulted run twice in the port and once in
  the reference.
* ``report.main`` of both packages on the same run directories, and the
  training CLI writing the run log and a CPU-only Chrome trace.
"""
import functools
import io
import json
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.core.gum import gum_matrices as j_gum_matrices
from repro.models import build_model as j_build_model
from repro.telemetry import GammaSlotTracker as JGammaSlotTracker
from repro.telemetry import JsonlSink as JJsonlSink
from repro.telemetry import MemorySink as JMemorySink
from repro.telemetry import StdoutSink as JStdoutSink
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import TelemetryConfig as JTelemetryConfig
from repro.telemetry import lowrank_family_metrics as j_lowrank_family_metrics
from repro.telemetry import report as j_report
from repro.telemetry.bus import read_jsonl as j_read_jsonl
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.gum import gum_matrices
from repro_torch.data import DataConfig
from repro_torch.launch import train as cli
from repro_torch.models import build_model
from repro_torch.telemetry import (
    SCHEMA_VERSION,
    GammaSlotTracker,
    JsonlSink,
    MemorySink,
    StdoutSink,
    Telemetry,
    TelemetryConfig,
    lowrank_family_metrics,
    report,
)
from repro_torch.telemetry.bus import read_jsonl
from repro_torch.train import Trainer
from test_telemetry import GOLDEN, FakeClock, _emit_fixture, _stream_signature, _trainer
from test_torch_optimizers import jax_sampler
from test_torch_trainer import jax_sampler as trainer_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)


# ------------------------------------------------------------------- the bus


def _bus_case(case, pkg, tmp):
    """One behaviour of a package's bus on fixed input, as comparable data."""
    Tele, Jsonl, Stdout, Memory, Config, read = pkg
    if case == "golden":
        path = str(tmp / "events.jsonl")
        tele = Tele([Jsonl(path)], run={"optimizer": "gum", "seed": 0}, clock=FakeClock())
        _emit_fixture(tele)
        with open(path, "rb") as f:
            return f.read()
    if case == "reader":
        path = str(tmp / "crashed.jsonl")
        tele = Tele([Jsonl(path)], clock=FakeClock())
        tele.metric(0, "loss", 1.0)
        tele.close()
        with open(path, "a") as f:
            f.write('{"kind": "metric", "truncat')  # a crashed writer's last line
        newer = str(tmp / "future.jsonl")
        with open(newer, "w") as f:
            f.write(json.dumps({"kind": "header", "schema": SCHEMA_VERSION + 1}) + "\n")
        with pytest.raises(ValueError, match="newer") as err:
            read(newer)
        return read(path), str(err.value).split(": ", 1)[1].split(" — ")[0]
    if case == "stdout":
        buf = io.StringIO()
        tele = Tele([Stdout(stream=buf)], clock=FakeClock())
        tele.metric(1, "loss", 4.25)
        tele.record_span("step", 0.01, step=1)
        tele.event("log", "loss 4.2500", step=10)
        tele.event("audit", "audit[gum]: summary")
        tele.event("checkpoint", "checkpoint: saved step 5", step=5, severity="debug")
        tele.event("health", "health[critical] nonfinite: x", step=7, severity="critical")
        tele.close()
        quiet = io.StringIO()
        Tele([Stdout(stream=quiet, min_severity="warn")], clock=FakeClock()).event("log", "x")
        return buf.getvalue(), quiet.getvalue()
    if case == "memory":
        ring = Memory(maxlen=2)
        tele = Tele([ring], clock=FakeClock())
        for i in range(5):
            tele.event("e", f"n{i}")
        none = Tele([], clock=FakeClock())
        none.metric(0, "loss", 1.0)
        none.close()
        return list(ring.records), tele.counters, tele.span_stats()
    assert case == "config"
    out = [Config.parse(None), Config.parse(False), Config.parse(True), Config.parse(""),
           Config.parse("every=5,stdout=0,memory=16,events=/tmp/x"),
           Config.parse("stdout=yes, every=3")]
    with pytest.raises(ValueError, match="unknown telemetry knob") as err:
        Config.parse("cadence=5")
    cfg = Config.parse("every=2")
    assert Config.parse(cfg) is cfg
    return [None if c is None else vars(c) for c in out], str(err.value)


PORT_BUS = (Telemetry, JsonlSink, StdoutSink, MemorySink, TelemetryConfig, read_jsonl)
REFERENCE_BUS = (JTelemetry, JJsonlSink, JStdoutSink, JMemorySink, JTelemetryConfig,
                 j_read_jsonl)


@pytest.mark.parametrize("case", ["golden", "reader", "stdout", "memory", "config"])
def test_bus_matches_reference(tmp_path, case):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _bus_case(case, PORT_BUS, tmp_path / "port")
    assert got == _bus_case(case, REFERENCE_BUS, tmp_path / "ref")
    if case == "golden":
        with open(GOLDEN, "rb") as f:
            assert got == f.read()


# ---------------------------------------------------------- in-step probes

# The reference test's tree (two (16, 8) leaves and a bias), numpy-seeded, in
# the reference's leaf order (its dict keys sorted).
_RNG = np.random.default_rng(0)
PARAMS = {k: (0.1 * _RNG.standard_normal(shape)).astype(np.float32)
          for k, shape in (("bias", (8,)), ("wk", (16, 8)), ("wq", (16, 8)))}
OPT = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3)
UPDATES = 7
MODES = ["per_leaf", "fused", "external"]


def _grads(i: int, params: dict) -> dict:
    """The reference test's gradients: ``p * 0.1 + 0.01 * (i + 1)``."""
    return {k: p * np.float32(0.1) + np.float32(0.01 * (i + 1)) for k, p in params.items()}


def _tree(mode: str) -> dict:
    # the external hook drives gum_matrices: the two matrix leaves alone
    return {k: v for k, v in PARAMS.items() if mode != "external" or k != "bias"}


def _reference_step(mode: str, opt):
    """One reference step as ``(grads, state, params) -> (updates, state)``;
    the external mode runs the lowrank stage's refresh hook first."""
    update = jax.jit(opt.update)
    if mode != "external":
        return update
    refresh = jax.jit(opt.update.lowrank_transform.update.refresh)

    def step(g, s, p):
        return update(g, (refresh(g, s[0], p),) + tuple(s[1:]), p)

    return step


@functools.lru_cache(maxsize=None)
def _reference_run(mode: str):
    """The reference's family metrics after each update, and its gamma-slot
    records at init and after 4 updates."""
    if mode == "external":
        opt = j_gum_matrices(1e-3, rank=4, gamma=1, period=3, external_refresh=True,
                             telemetry=True)
    else:
        opt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", telemetry=True,
                                                 fuse_families=mode == "fused", **OPT))
    params = {k: jax.numpy.asarray(v) for k, v in _tree(mode).items()}
    state, step, tracker = opt.init(params), _reference_step(mode, opt), JGammaSlotTracker()
    metrics, slots = [], [tracker.observe(state)]
    for i in range(UPDATES):
        _, state = step({k: jax.numpy.asarray(v) for k, v in _grads(i, _tree(mode)).items()},
                        state, params)
        metrics.append(j_lowrank_family_metrics(jax.device_get(state)))
        if i == 3:
            slots.append(tracker.observe(state))
    return metrics, slots


def _port_opt(mode: str, telemetry: bool):
    if mode == "external":
        return gum_matrices(1e-3, rank=4, gamma=1, period=3, external_refresh=True,
                            telemetry=telemetry, sampler=jax_sampler(1))
    return build_optimizer(OptimizerConfig(telemetry=telemetry, fuse_families=mode == "fused",
                                           **OPT), sampler=jax_sampler(1))


def _port_run(mode: str, telemetry: bool):
    opt = _port_opt(mode, telemetry)
    params = {k: torch.from_numpy(v) for k, v in _tree(mode).items()}
    state, tracker = opt.init(params), GammaSlotTracker()
    updates, metrics, slots = [], [], [tracker.observe(state)]
    for i in range(UPDATES):
        g = {k: torch.from_numpy(v) for k, v in _grads(i, _tree(mode)).items()}
        if mode == "external":
            refresh = opt.update.lowrank_transform.update.refresh
            state = (refresh(g, state[0], params),) + tuple(state[1:])
        u, state = opt.update(g, state, params)
        updates.append(u)
        metrics.append(lowrank_family_metrics(state))
        if i == 3:
            slots.append(tracker.observe(state))
    return updates, metrics, slots


@pytest.mark.parametrize("mode", MODES)
def test_probes_match_reference(mode):
    off, _, _ = _port_run(mode, False)
    on, metrics, _ = _port_run(mode, True)
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k  # telemetry is write-only
    want, _ = _reference_run(mode)
    for i, (got, ref) in enumerate(zip(metrics, want)):
        assert [r["family"] for r in got] == [r["family"] for r in ref] == ["16x8"]
        for g, r in zip(got, ref):
            assert g.keys() == r.keys(), i
            for k in ("m", "n", "rank", "bias_step"):
                assert g[k] == r[k], (i, k)
            for k in ("energy", "drift", "bias"):
                assert abs(g[k] - r[k]) <= 1e-5, (i, k, g[k], r[k])
            assert 0.0 <= g["drift"] <= 1.0 and 0.0 <= g["bias"] <= 1.0
    # the drift reads 1 against the zero projector of the first refresh, and
    # the bias is sampled only in the in-update path
    assert metrics[0][0]["drift"] == 1.0
    assert metrics[-1][0]["bias_step"] == (0 if mode == "external" else UPDATES)


@pytest.mark.parametrize("mode", ["per_leaf", "fused"])
def test_gamma_slot_tracker_matches_reference(mode):
    _, _, slots = _port_run(mode, True)
    assert slots == _reference_run(mode)[1]
    assert all(r["visits_max"] >= 1 for r in slots[-1]) and slots[-1]


# ---------------------------------------------------------------- trainer

# The startup audit's events, emitted by both packages since the port's
# analysis package: one "audit" summary and, with telemetry, one
# "launch_crosscheck" per run.  Their records are compared in full but for
# the summary's signature token: a jaxpr digest and an op-sequence digest
# cannot agree.
AUDIT_EVENTS = ("audit", "launch_crosscheck")


def _port_trainer(tmp, *, telemetry="stdout=0", inject=None, resilience=None, steps=8):
    """The reference test's ``_trainer`` recipe in the port, from the
    reference's initial parameters (its seed 0), with its block draws."""
    cfg = get_smoke("llama-60m")
    opt = OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=4,
                          telemetry=telemetry is not None)
    init = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    return Trainer(build_model(cfg, device="cpu"), opt,
                   RunConfig(steps=steps, ckpt_dir=str(tmp), ckpt_every=4, log_every=4,
                             resume=False),
                   DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2), device="cpu",
                   optimizer=build_optimizer(opt, sampler=trainer_sampler),
                   params=params_from_jax(jax.device_get(init)),
                   telemetry=telemetry, resilience=resilience, inject=inject)


def _signature(path, reference: bool) -> list[dict]:
    """The reference test's signature as records, the ``sig=`` token of an
    audit summary masked in either package's stream (``reference`` says
    which stream it is; both are read alike)."""
    sig = [json.loads(line) for line in _stream_signature(path)]
    for r in sig:
        if r.get("name") in AUDIT_EVENTS:
            r["detail"] = re.sub(r"sig=[0-9a-f]+", "sig=_", r["detail"])
    return sig


def _assert_same_stream(got: list[dict], want: list[dict]) -> None:
    """Records equal, but for metric values (loss and grad_norm within 1e-5
    relative, both NaN at an injected NaN; the family metrics within 1e-4
    absolute) and the "log" event's ``loss {loss:.4f}``: the same loss within
    1e-5 relative may round to neighbouring last digits, so those renderings
    may differ by one unit in the fourth decimal."""
    assert [(r["kind"], r.get("name"), r.get("step")) for r in got] == \
        [(r["kind"], r.get("name"), r.get("step")) for r in want]
    for g, w in zip(got, want):
        if g["kind"] == "event" and g["name"] == "log":
            (gl, gv), (wl, wv) = g.pop("detail").split(), w.pop("detail").split()
            assert gl == wl == "loss" and abs(round(float(gv) * 1e4) - round(float(wv) * 1e4)) <= 1
        if g["kind"] != "metric":
            assert g == w
            continue
        gv, wv = g.pop("value"), w.pop("value")
        assert g == w
        if g["name"] in ("loss", "grad_norm"):
            assert abs(gv - wv) <= 1e-5 * abs(wv) or (math.isnan(gv) and math.isnan(wv)), \
                (g, gv, wv)
        else:  # the per-family subspace metrics
            assert abs(gv - wv) <= 1e-4, (g, gv, wv)


@pytest.fixture(scope="module")
def clean_runs(tmp_path_factory):
    """The clean 8-step run of each package: (port run dir, reference run dir)."""
    root = tmp_path_factory.mktemp("telemetry_runs")
    port = _port_trainer(root / "port").train()
    ref = _trainer(root / "ref", steps=8).train()
    assert port.events_path == str(root / "port" / "events.jsonl")
    return root / "port", root / "ref", port, ref


def test_trainer_stream_matches_reference(clean_runs):
    port_dir, ref_dir, port, ref = clean_runs
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-5, atol=0)
    got = _signature(port.events_path, False)
    _assert_same_stream(got, _signature(ref.events_path, True))
    names = [r.get("name") for r in got]
    assert names.count("audit") == names.count("launch_crosscheck") == 1
    xc = next(r for r in got if r.get("name") == "launch_crosscheck")
    assert "cross-check ok" in xc["detail"] and xc["data"]["expected"] == xc["data"]["traced"]
    assert names.count("loss") == names.count("grad_norm") == 8
    assert names.count("gamma_slots") == 2 and names.count("ckpt_save") == 2
    assert {r["step"] for r in got if r.get("name") == "drift"} == {1, 5}


def test_audit_leaves_the_run_bitwise(tmp_path, monkeypatch):
    """The startup audit traces the optimizer on meta copies and draws
    nothing (the replayed block draws of the sampler included): a run's
    losses and parameters are bitwise those of the same run without it,
    and only its two events differ."""
    runs = []
    for audit in (True, False):
        if not audit:
            monkeypatch.setattr(Trainer, "_startup_audit", lambda self, params: None)
        t = _port_trainer(tmp_path / str(audit), steps=5)
        result = t.train()
        names = [r["name"] for r in read_jsonl(result.events_path) if r["kind"] == "event"]
        runs.append((result.losses, {k: p.detach().clone() for k, p in t.model.params().items()},
                     names))
    (la, pa, na), (lb, pb, nb) = runs
    assert la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert [n for n in na if n not in AUDIT_EVENTS] == nb
    assert na.count("audit") == na.count("launch_crosscheck") == 1


def test_faulted_stream_is_deterministic_and_matches_reference(tmp_path):
    def port_run(tag):
        t = _port_trainer(tmp_path / tag, resilience="", inject="grad_nan@5")
        t.monitor.z = float("inf")
        return t.train()

    a, b = port_run("a"), port_run("b")
    jt = _trainer(tmp_path / "ref", resilience="", inject="grad_nan@5")
    jt.monitor.z = float("inf")
    ref = jt.train()
    assert a.fault_log == b.fault_log == ref.fault_log == [(5, "grad_nan")]
    sig_a = _signature(a.events_path, False)
    assert sig_a == _signature(b.events_path, False)
    _assert_same_stream(sig_a, _signature(ref.events_path, True))
    assert any(r.get("name") == "health" for r in sig_a)


@pytest.mark.parametrize("diff", [False, True], ids=["summary", "diff"])
def test_report_matches_reference(clean_runs, capsys, diff):
    port_dir, ref_dir, _, _ = clean_runs
    argv = [str(port_dir)] + (["--diff", str(ref_dir)] if diff else [])
    assert report.main(argv) == 0
    got = capsys.readouterr().out
    assert j_report.main(argv) == 0
    assert got == capsys.readouterr().out
    assert ("## span means" if diff else "## families") in got


def test_cli_writes_events_and_a_cpu_trace(tmp_path, capsys):
    events = tmp_path / "log" / "events.jsonl"
    ckpt = tmp_path / "ckpt"
    cli.main(["--arch", "llama-60m", "--smoke", "--device", "cpu", "--steps", "3",
              "--batch", "2", "--seq", "32", "--rank", "4", "--period", "2",
              "--ckpt-dir", str(ckpt), "--telemetry", "--events-out", str(events),
              "--profile-steps", "1:2"])
    out = capsys.readouterr().out
    assert f"telemetry: {events} (python -m repro_torch.telemetry.report {ckpt})" in out
    assert "step      1 profiler: trace started" in out
    assert "step      2 profiler: trace stopped" in out
    recs = read_jsonl(str(events))
    assert recs[0]["kind"] == "header" and recs[-1]["kind"] == "counters"
    assert recs[-1]["counts"]["event.profile"] == 2
    (trace,) = os.listdir(ckpt / "profile")
    with open(ckpt / "profile" / trace) as f:
        trace_events = json.load(f)["traceEvents"]
    marks = [e["name"] for e in trace_events if e.get("cat") == "user_annotation"]
    assert marks == ["step 1"]
    device = {"kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime", "cuda_driver",
              "gpu_user_annotation"}
    assert not [e for e in trace_events if e.get("cat") in device]
