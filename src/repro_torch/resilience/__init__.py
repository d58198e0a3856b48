"""Resilience: fault injection, training health, recovery (the port of the
JAX package's ``resilience``), wired through
:class:`repro_torch.train.Trainer` (``resilience=``, ``inject=``) and the
training CLI (``python -m repro_torch.launch.train --resilience ...
--inject ...``).

:mod:`repro_torch.resilience.inject`
    a declarative, seeded :class:`FaultPlan`: gradient corruption (NaN /
    Inf / spike) through a :class:`FaultGate` in the train step, projector
    sabotage, checkpoint truncation / bit flips, and a mid-save process
    kill.

:mod:`repro_torch.resilience.health`
    windowed detectors over the step's scalars (loss, raw gradient norm,
    the low-rank leaves' update norm, spectrum probes) — loss spike, grad
    spike, blowup, dead subspace, non-finite skip — with the straggler
    monitor, one :class:`HealthReport` per step.

:mod:`repro_torch.resilience.recovery`
    the escalation ladder — skip → forced off-cycle projector refresh →
    rollback to an in-memory ring of snapshots → restore of the last
    verified durable checkpoint — driven by :class:`RecoveryController`.
"""
from repro_torch.resilience.health import HealthEvent, HealthMonitor, HealthReport
from repro_torch.resilience.inject import (
    FaultEvent,
    FaultGate,
    FaultPlan,
    bitflip_checkpoint,
    poison_projectors,
    truncate_checkpoint,
)
from repro_torch.resilience.recovery import (
    RecoveryController,
    ResilienceConfig,
    SnapshotRing,
    force_refresh,
)

__all__ = [
    "FaultEvent",
    "FaultGate",
    "FaultPlan",
    "HealthEvent",
    "HealthMonitor",
    "HealthReport",
    "RecoveryController",
    "ResilienceConfig",
    "SnapshotRing",
    "bitflip_checkpoint",
    "force_refresh",
    "poison_projectors",
    "truncate_checkpoint",
]
