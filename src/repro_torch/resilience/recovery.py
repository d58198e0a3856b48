"""Recovery controller: a declarative escalation ladder over live training
(the port of the JAX package's ``resilience/recovery.py``).

The ladder:

    rung 0  ``skip``      the step's NaN/Inf guard already dropped the
                          update — count it; after ``max_skips``
                          consecutive skips escalate to ``rollback``
    rung 1  ``refresh``   force an off-cycle projector refresh: advance the
                          ``lowrank()`` step count to the next period
                          boundary so the very next update recomputes every
                          projector from live gradients (clears a poisoned
                          or collapsed subspace; GUM-style
                          ``reset_on_refresh`` inners also re-zero momenta)
    rung 2  ``rollback``  restore the last in-memory snapshot — params,
                          optimizer state and controller extras (rank-policy
                          state rides along so floors/TTLs don't desync) —
                          and rewind the data stream to the snapshot step
    rung 3  ``restore``   reload the last *verified* durable checkpoint
                          through :class:`repro_torch.checkpoint.CheckpointManager`
                          (checksum-verified, falling back past corrupt
                          saves)

Each critical :class:`~repro_torch.resilience.health.HealthEvent` kind
enters the ladder at its base rung (see ``BASE_RUNG``); a further critical
report within ``escalation_window`` steps of the previous action escalates
one rung, so a fault the cheaper rung could not clear climbs
deterministically.  Every decision lands in ``RecoveryController.trace``.

:class:`ResilienceConfig`, :class:`Action` and :class:`RecoveryController`
are the reference's host bookkeeping as they are.  :class:`SnapshotRing`
keeps host copies of PyTorch trees, and :func:`force_refresh` bumps the
port's Python-int ``LowRankState.count``."""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.api import tree_map

PyTree = Any

RUNGS = ("skip", "refresh", "rollback", "restore")
BASE_RUNG = {
    "nonfinite": "skip",
    "dead_subspace": "refresh",
    "loss_spike": "rollback",
    "grad_spike": "rollback",
    "blowup": "rollback",
}


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for the health monitor + recovery controller (CLI spec form:
    ``"ring=3,snapshot_every=5,spike_z=4"`` — any field by name)."""

    # snapshot ring (rung 2)
    ring: int = 2                  # in-memory snapshots kept
    snapshot_every: int = 8        # steps between snapshots (healthy only)
    # loss-spike detector
    spike_z: float = 8.0
    spike_window: int = 32
    spike_min_samples: int = 8
    spike_min_delta: float = 0.5   # absolute guard: tiny-σ windows can't flag noise
    # blowup detector
    blowup_k: int = 5
    blowup_factor: float = 2.0
    # dead-subspace detector
    collapse_tol: float = 0.05
    collapse_window: int = 16
    collapse_min_samples: int = 4
    # captured-energy floor (warn only)
    energy_min: float = 0.05
    probe_health: bool = True      # gather spectrum probes when available
    # escalation
    escalation_window: int = 8     # steps within which a recurrence escalates
    max_skips: int = 3             # consecutive rung-0 skips before rollback

    @staticmethod
    def parse(spec) -> "ResilienceConfig":
        """``None | bool | spec string | ResilienceConfig`` → config."""
        if isinstance(spec, ResilienceConfig):
            return spec
        cfg = ResilienceConfig()
        if spec is None or spec is True or spec == "":
            return cfg
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if not hasattr(cfg, k):
                raise ValueError(f"unknown resilience knob {k!r}")
            cur = getattr(cfg, k)
            setattr(cfg, k, type(cur)(float(v)) if isinstance(cur, (int, float))
                    and not isinstance(cur, bool) else v.strip() == "1"
                    if isinstance(cur, bool) else v)
        return cfg


# ---------------------------------------------------------------------------
# snapshot ring (rung 2)
# ---------------------------------------------------------------------------


def _on(device, tree: PyTree) -> PyTree:
    """A copy of every tensor of ``tree`` on ``device``: a copy on the CPU too
    (``.to("cpu")`` of a CPU tensor is the tensor itself), since the step
    updates the live parameters (and may update state tensors) in place and
    the ring's own tensors must never reach it."""
    return tree_map(lambda t: t.detach().to(device, copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


@dataclasses.dataclass
class Snapshot:
    step: int                     # the next step to run after restoring
    params: PyTree                # host copies
    opt_state: PyTree
    extra: Optional[dict] = None  # controller extras (rank-policy state…)


class SnapshotRing:
    """Last-K in-memory ``(params, opt_state, extras)`` snapshots.

    Tensors are copied to the host at capture (the step updates the live
    ones in place) and copied back to the trainer's device on restore; the
    round trip is bit-exact."""

    def __init__(self, k: int = 2):
        self.k = int(k)
        self._ring: list = []

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def steps(self) -> list:
        return [s.step for s in self._ring]

    def add(self, step: int, params: PyTree, opt_state: PyTree,
            extra: Optional[dict] = None) -> None:
        snap = Snapshot(step=int(step), params=_on("cpu", params),
                        opt_state=_on("cpu", opt_state),
                        extra=copy.deepcopy(extra))
        self._ring.append(snap)
        del self._ring[: -self.k]

    def latest(self) -> Optional[Snapshot]:
        return self._ring[-1] if self._ring else None

    def pop_latest(self) -> Optional[Snapshot]:
        """Take the newest snapshot *out* of the ring (a second rollback
        for the same incident should land on an older state, not loop on
        one that already failed to clear the fault)."""
        return self._ring.pop() if self._ring else None

    def restore(self, snap: Snapshot, device="cpu") -> tuple:
        """``(params, opt_state)`` of ``snap`` as new tensors on ``device``;
        the caller copies the parameters into the live ones."""
        return _on(device, snap.params), _on(device, snap.opt_state)


# ---------------------------------------------------------------------------
# forced off-cycle refresh (rung 1)
# ---------------------------------------------------------------------------


def map_lowrank_states(fn: Callable, state: PyTree) -> PyTree:
    """``state`` with ``fn`` applied to every ``LowRankState`` node (per
    leaf, family-stacked, inside chains and label partitions)."""
    from repro_torch.core.combinators import LowRankState, map_nodes

    return map_nodes(fn, state, LowRankState)


def force_refresh(opt_state: PyTree, period: int) -> PyTree:
    """Advance every ``LowRankState`` step count to its next period
    boundary so the next update recomputes all projectors from live
    gradients (``lowrank()`` refreshes when ``count % period == 0`` on
    entry).  This shifts the refresh clock forward by up to ``period - 1``
    counts — deterministic, and exactly what an off-cycle refresh means:
    the subspace is re-derived *now* instead of at the scheduled boundary."""
    period = int(period)
    return map_lowrank_states(
        lambda s: s._replace(count=s.count + (-int(s.count)) % period), opt_state)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                     # none | skip | refresh | rollback | restore
    step: int                     # step the triggering report came from
    event: str = ""               # triggering event kind
    target: Optional[int] = None  # filled by the trainer (snapshot/ckpt step)


class RecoveryController:
    """Maps critical health reports to ladder actions with escalation.

    The controller is pure host-side bookkeeping — the trainer owns the
    actual state surgery (it has the snapshot ring, checkpoint manager and
    jit caches).  ``decide`` returns at most one action per report;
    ``record`` is called by the trainer after executing it (with the
    resolved target step) so the trace carries what actually happened."""

    def __init__(self, cfg: Optional[ResilienceConfig] = None):
        self.cfg = cfg or ResilienceConfig()
        self.counts = {r: 0 for r in RUNGS}
        self.trace: list = []
        self._last_action_step: Optional[int] = None
        self._last_rung: int = -1
        self._skip_streak: int = 0

    def _escalate(self, step: int, base: int) -> int:
        recent = (self._last_action_step is not None
                  and step - self._last_action_step
                  <= self.cfg.escalation_window)
        if recent and base <= self._last_rung:
            return min(self._last_rung + 1, len(RUNGS) - 1)
        return base

    def decide(self, report) -> Action:
        crit = report.critical
        if not crit:
            if report.status == "ok":
                self._skip_streak = 0
            return Action("none", report.step)
        # Highest-base-rung event wins the decision for this step.
        ev = max(crit, key=lambda e: RUNGS.index(BASE_RUNG.get(e.kind,
                                                               "rollback")))
        base = RUNGS.index(BASE_RUNG.get(ev.kind, "rollback"))
        if ev.kind == "nonfinite":
            self._skip_streak += 1
            if self._skip_streak <= self.cfg.max_skips:
                # rung 0 — already handled in-jit, just count it
                self.counts["skip"] += 1
                self.trace.append({"step": report.step, "event": ev.kind,
                                   "action": "skip", "target": None})
                return Action("skip", report.step, ev.kind)
            base = RUNGS.index("rollback")
            self._skip_streak = 0
        rung = self._escalate(report.step, base)
        return Action(RUNGS[rung], report.step, ev.kind)

    def record(self, action: Action, target: Optional[int] = None) -> None:
        """Log an executed action (trainer callback)."""
        self.counts[action.kind] += 1
        self._last_action_step = action.step
        self._last_rung = RUNGS.index(action.kind)
        self.trace.append({"step": action.step, "event": action.event,
                           "action": action.kind, "target": target})
