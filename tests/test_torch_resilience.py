"""The port's resilience subsystem (``repro_torch.resilience``, the
``Trainer``'s ``resilience=`` / ``inject=`` and the training CLI
``python -m repro_torch.launch.train``) against the JAX package's
``repro.resilience``, on the same inputs.

* Units: ``FaultPlan`` (parse, JSON round trip, fire-once, ``log``),
  ``FaultGate`` (mode 0 is the identity; modes 1–3), ``poison_projectors``
  and ``force_refresh`` on optimizer state converted from the reference's
  (per leaf and family-stacked, through the shared checkpoint layout),
  ``SnapshotRing`` (bitwise round trip, eviction, no aliasing of the live
  tensors), each ``HealthMonitor`` detector and ``RecoveryController``'s
  rungs and escalation (equal scalar sequences give equal events and
  actions), ``ResilienceConfig.parse``, and the checkpoint corruptions
  choosing the reference's leaf and byte.
* The step's extra metrics (``grad_norm_raw``, ``update_norm``,
  ``update_norm_lowrank``) against the reference's
  ``make_train_step(extra_metrics=True)`` within 1e-5 relative.
* The fault matrix through both ``Trainer``s on llama-60m ``SMOKE``: the
  reference's initial parameters, its block draws injected
  (``test_torch_trainer.jax_sampler``), and for GaLore its SVD signs (its
  moments cross the forced refresh).  Each case: the same ``fault_log``,
  ``recovery_trace``, ``recovery_counts`` and ``resumed_from``, losses within
  1e-5 and final parameters within 1e-5 relative.
* With resilience on and no fault due, the state is bitwise that of a run
  with resilience off.
* A kill -9 mid-save in a child process, resumed bitwise (rank-policy
  extras included), and the CLI against the reference's CLI.

Every run whose trace is compared sets ``monitor.z = inf``: the straggler
detector reads the wall clock, and a straggler warning drops that step's
snapshot (the reference's rule), which would move a later rollback's target.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import resilience as jres
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.core import find_lowrank_states as j_find_lowrank_states
from repro.data import DataConfig as JDataConfig
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.train import StepTimeMonitor as JStepTimeMonitor
from repro.train import Trainer as JTrainer
from repro_torch import resilience as tres
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _from_numpy, _rebuild, flatten_with_paths
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer, combinators, gum_accum_tools
from repro_torch.data import DataConfig
from repro_torch.launch import train as cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.train import StepTimeMonitor, Trainer
from test_torch_gum import _grads, _unflatten
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _jparams(seed: int = 0):
    return j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(seed))


def _to_port(jtree, template, tmp: Path):
    """A reference tree as the port's ``template``: the reference's
    checkpoint of it read back by leaf path (the shared layout's paths; the
    two packages may order a state's dict keys differently)."""
    mgr = JCheckpointManager(str(tmp))
    mgr.save(1, jtree)
    d = Path(mgr._step_dir(1))
    manifest = json.loads((d / "manifest.json").read_text())
    saved = {m["path"]: np.load(d / m["shards"][0]) for m in manifest["leaves"]}
    flat = flatten_with_paths(template)
    assert sorted(saved) == sorted(p for p, _ in flat)
    return _rebuild(template, iter([_from_numpy(saved[p], ref) for p, ref in flat]))


def _bitwise_diff(a, b) -> list[str]:
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    return [p for (p, x), (_, y) in zip(fa, fb)
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)]


# ------------------------------------------------------------------ fault plan


SPECS = ["grad_nan@5;grad_spike@9*1e6;refresh_zero@13;kill_save@20#3",
         "ckpt_bitflip@4;ckpt_truncate@4*0.25;grad_inf@2;refresh_illcond@2", ""]


def _fire_all(plan) -> list:
    """Every firing over steps 0..23, each asked twice (the second must be
    empty: events fire once); saves every 4 steps."""
    out = []
    for step in range(24):
        for _ in range(2):
            ev = plan.grad_event(step)
            out.append(None if ev is None else ev.to_json())
            out.append([e.to_json() for e in plan.state_events(step)])
            if step % 4 == 0:
                out.append([e.to_json() for e in plan.ckpt_events(step)])
                out.append(plan.save_observer(step) is None)
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_round_trips_and_fires_once_as_the_reference(spec):
    j, t = jres.FaultPlan.parse(spec, seed=3), tres.FaultPlan.parse(spec, seed=3)
    assert t.to_json() == j.to_json() and repr(t) == repr(j)
    assert tres.FaultPlan.from_json(t.to_json()).to_json() == t.to_json()
    assert t.needs_gate() == j.needs_gate()
    assert (t.gate() is None) == (j.gate() is None)
    assert _fire_all(t) == _fire_all(j)
    assert t.log == j.log and len(t.log) == len(t.events)


def test_fault_plan_rejects_what_the_reference_rejects():
    for pkg in (jres, tres):
        with pytest.raises(ValueError, match="unknown fault kind"):
            pkg.FaultEvent(1, "grad_bogus")
        with pytest.raises(ValueError, match="needs '@step'"):
            pkg.FaultPlan.parse("grad_nan")
        with pytest.raises(ValueError, match="poison mode"):
            pkg.poison_projectors({}, "grad_nan")


# ------------------------------------------------------------------ fault gate


def _gate_grads():
    rng = np.random.default_rng(0)
    return {"blocks/attn/wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
            "blocks/mlp/w_in": rng.standard_normal((2, 4, 8)).astype(np.float32),
            "embed/embedding": rng.standard_normal((16, 4)).astype(np.float32),
            "steps": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("leaf_filter", [(), ("attn",)], ids=["all", "attn"])
@pytest.mark.parametrize("kind", [None, "grad_nan", "grad_inf", "grad_spike"])
def test_fault_gate_matches_reference(kind, leaf_filter):
    flat = _gate_grads()
    grads = {k: torch.from_numpy(v) for k, v in flat.items()}
    ev = None if kind is None else tres.FaultEvent(3, kind, scale=3.3)
    jev = None if kind is None else jres.FaultEvent(3, kind, scale=3.3)
    fault = tres.FaultGate.disarmed() if ev is None else tres.FaultGate.armed(ev)
    jfault = jres.FaultGate.disarmed() if jev is None else jres.FaultGate.armed(jev)
    assert fault["mode"] == int(jfault["mode"]) and fault["scale"] == float(jfault["scale"])
    got = tres.FaultGate(leaf_filter).apply(grads, fault)
    want = jres.FaultGate(leaf_filter).apply(_unflatten(flat), jfault)
    for path, g in got.items():
        node = want
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_array_equal(g.numpy(), np.asarray(node), err_msg=path)
    if kind is None:  # mode 0: the gradients themselves, untouched
        assert got is grads


# ------------------------------------------- projector sabotage, forced refresh


@pytest.fixture(scope="module")
def lowrank_states(tmp_path_factory):
    """{layout: (reference state, the same state as the port's)} after one
    reference update (real projectors): GaLore per leaf, GUM family-stacked
    (a chain inside the matrix routing)."""
    jparams = _jparams()
    params = params_from_jax(jax.device_get(jparams))
    grads = _unflatten(_grads(np.random.default_rng(0), params))
    out = {}
    for layout, kw in {"leaf": dict(name="galore", rank=4, period=3),
                       "stacked": dict(name="gum", rank=4, gamma=1, period=3,
                                       fuse_families=True)}.items():
        jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
        _, jstate = jax.jit(jopt.update)(grads, jopt.init(jparams), jparams)
        template = build_optimizer(OptimizerConfig(**kw)).init(params)
        out[layout] = (jstate, _to_port(jstate, template, tmp_path_factory.mktemp(layout)),
                       template)
    return out


@pytest.mark.parametrize("mode", ["refresh_zero", "refresh_illcond"])
@pytest.mark.parametrize("layout", ["leaf", "stacked"])
def test_poison_projectors_matches_reference(lowrank_states, tmp_path, layout, mode):
    jstate, state, template = lowrank_states[layout]
    before = [p.clone() for st in combinators.find_lowrank_states(state)
              for p in st.projs.values() if p is not None]
    assert before and all(float(p.abs().max()) > 0 for p in before)
    got = tres.poison_projectors(state, mode)
    want = _to_port(jres.poison_projectors(jstate, mode), template, tmp_path)
    assert not _bitwise_diff(got, want)
    projs = [p for st in combinators.find_lowrank_states(got) for p in st.projs.values()
             if p is not None]
    if mode == "refresh_zero":
        assert all(float(p.abs().max()) == 0 for p in projs)
    else:
        assert all(torch.equal(p, p[..., :1].expand(p.shape)) for p in projs)
    # functional: the state given is untouched
    after = [p for st in combinators.find_lowrank_states(state) for p in st.projs.values()
             if p is not None]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("count", [0, 1, 4, 6])
@pytest.mark.parametrize("layout", ["leaf", "stacked"])
def test_force_refresh_matches_reference(lowrank_states, tmp_path, layout, count):
    jstate, state, template = lowrank_states[layout]
    is_lr = lambda x: isinstance(x, type(j_find_lowrank_states(jstate)[0]))  # noqa: E731
    jstate = jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(count, s.count.dtype)) if is_lr(s) else s,
        jstate, is_leaf=is_lr)
    state = tres.recovery.map_lowrank_states(lambda s: s._replace(count=count), state)
    got = tres.force_refresh(state, 3)
    want = _to_port(jres.force_refresh(jstate, 3), template, tmp_path)
    assert not _bitwise_diff(got, want)
    assert {st.count for st in combinators.find_lowrank_states(got)} == {-(-count // 3) * 3}


# ------------------------------------------------------------------ snapshot ring


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(3, 4, generator=g), "b/c": torch.randn(5, generator=g)}
    state = (combinators.LowRankState(count=seed, projs={"a": torch.randn(3, 2, generator=g),
                                                         "b/c": None},
                                      inner={"mu": torch.randn(2, 4, generator=g)}),)
    return params, state


def test_snapshot_ring_round_trip_and_eviction_as_the_reference():
    ring, jring = tres.SnapshotRing(2), jres.SnapshotRing(2)
    for step in (4, 8, 12):
        params, state = _tree(step)
        ring.add(step, params, state, extra={"rank_policy": {"map": step}})
        jring.add(step, {k: v.numpy() for k, v in params.items()}, {"count": step})
        assert ring.steps == jring.steps and len(ring) == len(jring)
    assert ring.steps == [8, 12] and ring.latest().step == 12
    snap = ring.pop_latest()
    assert snap.step == jring.pop_latest().step == 12
    got = ring.restore(snap, "cpu")
    assert not _bitwise_diff(got, _tree(12)) and snap.extra == {"rank_policy": {"map": 12}}
    assert ring.pop_latest().step == jring.pop_latest().step == 8
    assert ring.pop_latest() is None and jring.pop_latest() is None


def test_snapshot_does_not_alias_the_live_tensors():
    params, state = _tree(1)
    want = _tree(1)
    ring = tres.SnapshotRing(1)
    ring.add(2, params, state)
    with torch.no_grad():  # the step's in-place updates
        for p in params.values():
            p.add_(1.0)
        state[0].inner["mu"].mul_(3.0)
    restored = ring.restore(ring.latest(), "cpu")
    assert not _bitwise_diff(restored, want)
    restored[0]["a"].add_(1.0)  # a restored tensor is not the ring's either
    assert not _bitwise_diff(ring.restore(ring.latest(), "cpu"), want)


# ------------------------------------------------------------------ health monitor


def _steady(n, loss=2.0, gnorm=1.0, unorm=0.5):
    rng = np.random.default_rng(n)
    return [dict(loss=loss + 0.01 * float(rng.standard_normal()), applied=True,
                 grad_norm=gnorm + 0.01 * float(rng.standard_normal()),
                 update_norm=unorm + 0.01 * float(rng.standard_normal()))
            for _ in range(n)]


def _probes(frac):
    return {(64, 256): {"sv2": [frac * 10.0, 0.0], "g2": 10.0, "rank": 2}}


DETECTORS = {
    "loss_spike": _steady(10) + [dict(loss=9.0, applied=True, grad_norm=1.0, update_norm=0.5)],
    "grad_spike": _steady(10) + [dict(loss=2.0, applied=True, grad_norm=1e4, update_norm=0.5)],
    "blowup": [dict(loss=1.0 * 1.25 ** i, applied=True, grad_norm=1.0, update_norm=0.5)
               for i in range(8)],
    "dead_subspace": _steady(6) + [dict(loss=2.0, applied=True, grad_norm=1.0,
                                        update_norm=1e-3)],
    "nonfinite": _steady(3) + [dict(loss=float("nan"), applied=False,
                                    grad_norm=float("nan"), update_norm=0.0)] * 2,
    "grad_inf": _steady(5) + [dict(loss=2.0, applied=False, grad_norm=float("inf"),
                                   update_norm=0.0)],
    "subspace_energy": [dict(loss=2.0, applied=True, grad_norm=1.0, probes=_probes(f))
                        for f in (0.5, 0.01)],
    "straggler": [dict(loss=2.0, applied=True, grad_norm=1.0, dt=0.1 + 0.001 * (i % 3))
                  for i in range(12)] + [dict(loss=2.0, applied=True, grad_norm=1.0, dt=1.0)],
}


@pytest.mark.parametrize("name", list(DETECTORS))
def test_health_detectors_match_reference(name):
    seq = DETECTORS[name]
    jm = jres.HealthMonitor(jres.ResilienceConfig(), step_monitor=JStepTimeMonitor())
    tm = tres.HealthMonitor(tres.ResilienceConfig(), step_monitor=StepTimeMonitor())
    for step, kw in enumerate(seq):
        jr, tr = jm.observe(step, **kw), tm.observe(step, **kw)
        assert tr.status == jr.status
        assert [e.to_json() for e in tr.events] == [e.to_json() for e in jr.events]
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tm.counts == jm.counts
    kind = {"grad_inf": "dead_subspace"}.get(name, name)
    assert tm.counts[kind] >= 1, tm.counts
    tm.reset()
    assert not tm._losses and not tm._gnorms and not tm._unorms


# ------------------------------------------------------------------ recovery ladder


SCENARIOS = {
    # three skips, then the fourth consecutive one escalates to a rollback
    "skip_streak": [(s, ["nonfinite"]) for s in (1, 2, 3, 4, 5)] + [(6, [])],
    # rollback, a recurrence within the window escalates to restore; later,
    # a refresh and its recurrence (escalates to rollback)
    "escalation": [(10, ["grad_spike"]), (12, ["grad_spike"]), (20, []),
                   (30, ["dead_subspace"]), (33, ["dead_subspace"]),
                   (60, ["loss_spike", "dead_subspace"])],
    # a warn-only report does not reset the skip streak; an ok one does
    "warn_keeps_streak": [(1, ["nonfinite"]), (2, ["nonfinite"]), (3, ["straggler"]),
                          (4, ["nonfinite"]), (5, ["nonfinite"]), (6, []),
                          (7, ["nonfinite"]), (8, ["blowup"])],
}


def _report(pkg, step, kinds):
    warn = {"straggler", "subspace_energy"}
    events = [pkg.HealthEvent(step, k, "warn" if k in warn else "critical") for k in kinds]
    status = ("critical" if any(e.severity == "critical" for e in events)
              else "warn" if events else "ok")
    return pkg.HealthReport(step=step, status=status, events=events, loss=1.0, grad_norm=1.0)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_recovery_rungs_and_escalation_match_reference(name):
    jc = jres.RecoveryController(jres.ResilienceConfig())
    tc = tres.RecoveryController(tres.ResilienceConfig())
    actions = []
    for step, kinds in SCENARIOS[name]:
        ja, ta = jc.decide(_report(jres, step, kinds)), tc.decide(_report(tres, step, kinds))
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
        if ta.kind not in ("none", "skip"):
            jc.record(ja, target=step - 2)
            tc.record(ta, target=step - 2)
        actions.append(ta.kind)
    assert tc.trace == jc.trace and tc.counts == jc.counts
    assert {"skip_streak": "rollback", "escalation": "restore",
            "warn_keeps_streak": "rollback"}[name] in actions


@pytest.mark.parametrize("spec", ["", None, True, "ring=3,snapshot_every=5,spike_z=4",
                                  "probe_health=0,max_skips=1", " ring = 4 , ",
                                  "collapse_tol=0.2,escalation_window=3"])
def test_resilience_config_parse_matches_reference(spec):
    got, want = tres.ResilienceConfig.parse(spec), jres.ResilienceConfig.parse(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tres.ResilienceConfig.parse(got) is got
    for pkg in (jres, tres):
        with pytest.raises(ValueError, match="unknown resilience knob"):
            pkg.ResilienceConfig.parse("bogus=1")


# ------------------------------------------------------------------ checkpoint faults


@pytest.mark.parametrize("leaves", [(), ("b",)], ids=["any", "b"])
@pytest.mark.parametrize("fault", ["bitflip", "truncate"])
def test_checkpoint_corruption_picks_the_reference_leaf_and_byte(tmp_path, fault, leaves):
    tree = {"a": np.arange(64, dtype=np.float32).reshape(8, 8),
            "b": {"c": np.ones((40,), np.float32), "d": np.arange(100, dtype=np.int32)}}
    JCheckpointManager(str(tmp_path / "j")).save(3, tree)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(3, jax.tree_util.tree_map(torch.from_numpy, tree))
    corrupt = {"bitflip": (tres.bitflip_checkpoint, jres.bitflip_checkpoint),
               "truncate": (tres.truncate_checkpoint, jres.truncate_checkpoint)}[fault]
    got = corrupt[0](str(tmp_path / "t"), 3, rng=np.random.default_rng(7), leaves=leaves)
    want = corrupt[1](str(tmp_path / "j"), 3, rng=np.random.default_rng(7), leaves=leaves)
    assert got == want
    dj, dt = Path(JCheckpointManager(str(tmp_path / "j"))._step_dir(3)), Path(mgr._step_dir(3))
    for f in sorted(dj.glob("*.npy")):
        assert (dt / f.name).read_bytes() == f.read_bytes(), f.name
    assert not mgr.verify_step(3)


# ------------------------------------------------------------------ extra metrics


def _batch(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, 32)).astype(np.int32)


@pytest.mark.parametrize("name,clip", [("gum", 1.0), ("galore", 0.0)])
def test_extra_metrics_match_reference(name, clip):
    kw = dict(name=name, lr=1e-2, rank=4, gamma=1, period=3)
    jcfg = j_get_smoke("llama-60m")
    jmodel, jparams = j_build_model(jcfg), _jparams()
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
    tokens = _batch(jcfg)
    _, _, want = jax.jit(j_make_train_step(jmodel, jopt, grad_clip=clip, extra_metrics=True))(
        jparams, jopt.init(jparams), {"tokens": jnp.asarray(tokens)})

    model = build_model(get_smoke("llama-60m"), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    opt = build_optimizer(OptimizerConfig(**kw), sampler=jax_sampler)
    params = model.params()
    step = make_train_step(model, opt, grad_clip=clip, extra_metrics=True)
    _, got = step(params, opt.init({k: p.detach() for k, p in params.items()}),
                  {"tokens": torch.from_numpy(tokens)})
    assert got["update_applied"] and bool(want["update_applied"])
    for key in ("loss", "grad_norm", "grad_norm_raw", "update_norm", "update_norm_lowrank"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, err_msg=key)
    assert 0 < float(got["update_norm_lowrank"]) < float(got["update_norm"])


def test_fault_gate_is_not_wired_into_the_projected_accumulator():
    model = build_model(get_smoke("llama-60m"), device="cpu")
    tools = gum_accum_tools(1e-3, rank=4, gamma=1, period=3)
    with pytest.raises(NotImplementedError, match="projected-space"):
        make_train_step(model, tools.transform, microbatches=2, lowrank_accum=tools,
                        fault_gate=tres.FaultGate())


# ------------------------------------------------------------------ trainers


GUM = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=10)
DATA = dict(seq_len=32, global_batch=4, seed=0)


@pytest.fixture(scope="module")
def init_params():
    return params_from_jax(jax.device_get(_jparams()))


@pytest.fixture
def reference_signs(monkeypatch):
    """The reference's SVD column signs in the port's projectors (GaLore's
    moments cross a refresh, so a column the two LAPACK builds sign
    differently changes the next period): each column of the port's SVD is
    flipped to agree with ``jnp.linalg.svd`` of the same gradient."""
    orig = combinators.compute_projectors

    def aligned(kind, g, rank, side, **kw):
        u = orig(kind, g, rank, side, **kw)
        x = g.detach().numpy().astype(np.float32)
        if side == "right":
            x = np.swapaxes(x, -1, -2)
        want = torch.from_numpy(np.array(jnp.linalg.svd(x, full_matrices=False)[0]))
        sign = torch.where((u * want[..., :rank]).sum(-2, keepdim=True) < 0, -1.0, 1.0)
        return u * sign

    monkeypatch.setattr(combinators, "compute_projectors", aligned)


def _both(tmp, init_params, steps, *, opt=GUM, resilience="", inject=None, ckpt_every=10,
          tag=""):
    """The reference's Trainer and the port's on the same recipe; the port
    from the reference's initial parameters with its block draws."""
    cfg = j_get_smoke("llama-60m")
    jt = JTrainer(j_build_model(cfg), JOptimizerConfig(kernel_impl="jnp", **opt),
                  JRunConfig(steps=steps, ckpt_dir=str(tmp / f"j{tag}"), ckpt_every=ckpt_every,
                             log_every=0, seed=0),
                  JDataConfig(vocab=cfg.vocab, **DATA), resilience=resilience, inject=inject)
    t = Trainer(build_model(get_smoke("llama-60m"), device="cpu"), OptimizerConfig(**opt),
                RunConfig(steps=steps, ckpt_dir=str(tmp / f"t{tag}"), ckpt_every=ckpt_every,
                          log_every=0, seed=0),
                DataConfig(vocab=cfg.vocab, **DATA), device="cpu",
                optimizer=build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler),
                params=init_params, resilience=resilience, inject=inject)
    jt.monitor.z = t.monitor.z = float("inf")  # no straggler may drop a snapshot
    return jt, jt.train(), t, t.train()


def _assert_same_run(jt, jr, t, tr):
    for field in ("fault_log", "recovery_trace", "recovery_counts", "resumed_from",
                  "skipped_nonfinite", "final_step"):
        assert getattr(tr, field) == getattr(jr, field), field
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=RTOL, atol=0)
    (jparams, _), _ = JCheckpointManager(jt.ckpt.dir).restore(jr.final_step, jt.init_state())
    want = params_from_jax(jax.device_get(jparams))
    for path, p in t.model.params().items():
        err = float(torch.linalg.norm(p.detach() - want[path]) / torch.linalg.norm(want[path]))
        assert err <= RTOL, (path, err)


MATRIX = {
    "grad_nan": dict(steps=12, inject="grad_nan@6"),
    "grad_inf": dict(steps=12, inject="grad_inf@8"),
    "grad_spike": dict(steps=20, resilience="snapshot_every=4", inject="grad_spike@17*1e9"),
    "refresh_zero": dict(steps=18, opt=dict(GUM, name="galore"), inject="refresh_zero@14"),
    "restore": dict(steps=20, resilience="snapshot_every=0", inject="grad_spike@17*1e9"),
}
# The rung each case reaches.  grad_inf's is the reference's: its raw norm is
# inf, not NaN, so the dead-subspace detector fires too (the skipped update's
# norm is 0 against a healthy gradient norm) and its rung, refresh, outranks
# the skip.
RUNG = {"grad_nan": "skip", "grad_inf": "refresh", "grad_spike": "rollback",
        "refresh_zero": "refresh", "restore": "restore"}


@pytest.mark.parametrize("case", list(MATRIX))
def test_fault_matrix_matches_reference(tmp_path, init_params, reference_signs, case):
    jt, jr, t, tr = _both(tmp_path, init_params, **MATRIX[case])
    _assert_same_run(jt, jr, t, tr)
    assert tr.recovery_counts[RUNG[case]] == 1, tr.recovery_trace
    if case == "restore":
        assert tr.recovery_trace[-1]["target"] == 10


@pytest.mark.parametrize("fault", ["ckpt_bitflip", "ckpt_truncate"])
def test_fault_matrix_corrupt_checkpoint_falls_back_as_the_reference(tmp_path, init_params,
                                                                      fault):
    _, jr1, _, tr1 = _both(tmp_path, init_params, 8, inject=f"{fault}@8", ckpt_every=4)
    assert tr1.fault_log == jr1.fault_log == [(8, fault)]
    jt, jr, t, tr = _both(tmp_path, init_params, 10, ckpt_every=4)
    assert tr.resumed_from == 4
    _assert_same_run(jt, jr, t, tr)


@pytest.mark.parametrize("inject", [None, "grad_nan@100"], ids=["no-plan", "disarmed"])
def test_resilience_without_a_fault_is_bitwise_resilience_off(tmp_path, inject):
    def run(tag, **kw):
        cfg = get_smoke("llama-60m")
        t = Trainer(build_model(cfg, device="cpu"), OptimizerConfig(**dict(GUM, period=3)),
                    RunConfig(steps=7, ckpt_dir=str(tmp_path / tag), ckpt_every=100,
                              log_every=0, seed=0),
                    DataConfig(vocab=cfg.vocab, **DATA), device="cpu", **kw)
        t.monitor.z = float("inf")
        return t, t.train()

    off, roff = run("off")
    on, ron = run("on", resilience="snapshot_every=2", inject=inject)
    assert ron.losses == roff.losses and not ron.recovery_trace
    live = lambda t: ({k: p.detach() for k, p in t.model.params().items()}, t.opt_state)  # noqa: E731
    assert not _bitwise_diff(live(on), live(off))


# ------------------------------------------------------------------ kill -9, CLI

KILL_CHILD = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    cfg = get_smoke("llama-60m")
    t = Trainer(build_model(cfg, device="cpu"),
                OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=3,
                                rank_policy="stepwise:0=4,6=2", rank_ladder=(2, 4)),
                RunConfig(steps=16, ckpt_dir=sys.argv[1], ckpt_every=4, log_every=0, seed=0),
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0),
                device="cpu", resilience="", inject=sys.argv[2])
    t.train()
""")


def _policy_trainer(ckpt_dir, steps=16):
    cfg = get_smoke("llama-60m")
    return Trainer(build_model(cfg, device="cpu"),
                   OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=3,
                                   rank_policy="stepwise:0=4,6=2", rank_ladder=(2, 4)),
                   RunConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=4, log_every=0,
                             seed=0),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0),
                   device="cpu", resilience="")


def test_kill_midsave_resumes_bitwise_with_rank_policy(tmp_path):
    """kill -9 after 2 leaves of the step-12 save (the stepwise drop 4 -> 2
    lands at count 6, before it): the partial save stays invisible, and the
    resumed run equals an uninterrupted one bitwise, extras included."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    killed = subprocess.run([sys.executable, "-c", KILL_CHILD, str(tmp_path / "kill"),
                             "kill_save@12#2"], capture_output=True, text=True, env=env,
                            cwd=ROOT, timeout=300)
    assert killed.returncode == -9, (killed.returncode, killed.stdout, killed.stderr)
    mgr = CheckpointManager(str(tmp_path / "kill"))
    assert mgr.latest_step() == mgr.latest_verified_step() == 8
    assert any(n.endswith(".tmp") for n in os.listdir(tmp_path / "kill"))

    resumed = _policy_trainer(tmp_path / "kill")
    assert resumed.train().resumed_from == 8
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "kill"))
    straight = _policy_trainer(tmp_path / "straight")
    straight.train()
    ea, eb = mgr.read_extra(16), straight.ckpt.read_extra(16)
    assert ea == eb and ea["rank_policy"]["map"]["default"] == 2
    live = lambda t: ({k: p.detach() for k, p in t.model.params().items()}, t.opt_state)  # noqa: E731
    assert not _bitwise_diff(live(resumed), live(straight))


CLI_ARGS = ["--arch", "llama-60m", "--smoke", "--steps", "24", "--batch", "2", "--seq", "64",
            "--resilience", "ring=2,snapshot_every=4", "--inject", "grad_nan@5;grad_spike@17*1e9"]


def _closing(out: str) -> tuple:
    line = next(ln for ln in out.splitlines() if ln.startswith("resilience:"))
    return re.search(r"recoveries=(\{.*\}) health_events=\d+ faults_fired=(\d+)", line).groups()


def test_cli_prints_the_reference_recoveries(tmp_path, monkeypatch, capsys):
    from repro.launch import train as jcli

    monkeypatch.setattr(sys, "argv", ["train"] + CLI_ARGS + ["--ckpt-dir", str(tmp_path / "j")])
    jcli.main()
    want = capsys.readouterr().out
    cli.main(["--device", "cpu", *CLI_ARGS, "--ckpt-dir", str(tmp_path / "t")])
    got = capsys.readouterr().out
    assert _closing(got) == _closing(want) == ("{'skip': 1, 'rollback': 1}", "2")
    assert re.search(r"^done: step=24 first_loss=\S+ last_loss=\S+ skipped=1 stragglers=\d+$",
                     got, re.M)
    for line in ("step      5 fault-injection: grad_nan",
                 "step      5 health[critical] nonfinite: in-jit NaN/Inf guard skipped the update",
                 "step     17 recovery: rollback -> step 16"):
        assert line in got.splitlines() and line in want.splitlines()


@pytest.mark.parametrize("flags", [["--mesh", "data=2"], ["--shard-state"], ["--telemetry"],
                                   ["--telemetry", "every=2"], ["--events-out", "e.jsonl"],
                                   ["--profile-steps", "1:2"], ["--audit"]],
                         ids=lambda f: f[0])
def test_cli_unported_flags_raise(tmp_path, flags, capsys, monkeypatch):
    args = ["--device", "cpu", "--arch", "llama-60m", "--smoke", "--steps", "1",
            "--ckpt-dir", str(tmp_path), *flags]
    if flags[0] == "--audit":
        # ported since: the static audit runs before step 0; a clean config
        # trains, an error finding (here RC103: a chain whose scale_by_lr is
        # not its last stage) exits 1 before anything is trained or saved
        cli.main([*args, "--batch", "2", "--seq", "32", "--rank", "4"])
        out = capsys.readouterr().out
        assert "audit gum: clean" in out and "done: step=1" in out
        from repro_torch.core import combinators as C
        from repro_torch.core import factory

        build = factory._build
        monkeypatch.setattr(factory, "_build",
                            lambda *a: C.chain(C.scale_by_lr(1e-3), build(*a)))
        bad = tmp_path / "bad"
        with pytest.raises(SystemExit) as exit_:
            cli.main(["--device", "cpu", "--arch", "llama-60m", "--smoke", "--steps", "1",
                      "--ckpt-dir", str(bad), "--audit"])
        out = capsys.readouterr().out
        assert exit_.value.code == 1 and "RC103 error" in out
        assert "not training" in out and not bad.exists()
        return
    # ported since: the mesh runs one rank a process, started by torchrun
    # (tests/test_torch_distributed.py runs it); alone, each flag says how
    if flags[0] in ("--mesh", "--shard-state"):
        want = ((RuntimeError, r"torchrun --nproc-per-node 2 -m repro_torch.launch.train")
                if flags[0] == "--mesh" else (ValueError, "--mesh"))
        with pytest.raises(want[0], match=want[1]):
            cli.main(args)
        assert not os.listdir(tmp_path)
        return
    # ported since: telemetry, its events path and the profiler window run
    cli.main([*args, "--steps", "2", "--batch", "2", "--seq", "32", "--rank", "4"])
    out = capsys.readouterr().out
    if flags[0] == "--profile-steps":  # the window alone writes a trace, no run log
        assert "profiler: trace started" in out and "telemetry:" not in out
        assert os.listdir(tmp_path / "profile")
        return
    events = tmp_path / flags[1] if flags[0] == "--events-out" else tmp_path / "events.jsonl"
    if flags[0] == "--events-out":  # the path takes effect with --telemetry only
        assert not events.exists() and "telemetry:" not in out
        return
    assert f"telemetry: {events} (python -m repro_torch.telemetry.report {tmp_path})" in out
    kinds = [json.loads(line)["kind"] for line in events.read_text().splitlines()]
    assert kinds[0] == "header" and kinds[-1] == "counters"


def test_cli_raises_without_a_gpu_unless_asked_for_the_cpu(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "llama-60m", "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
