"""Training health monitor: cheap signals from the step, host-side
detectors (the port of the JAX package's ``resilience/health.py``: every
detector, threshold and window rule is the reference's, so equal scalar
inputs give equal events).

The train step already computes a loss and a gradient norm; with
``make_train_step(extra_metrics=True)`` it also reports the raw (pre-clip)
gradient norm and the applied update norm (all of it and the low-rank
leaves' share), fetched to the host in one copy with the loss.

Host-side, :class:`HealthMonitor` runs windowed detectors over those
signals and folds in the two guards the trainer already has — the step's
NaN/Inf skip (``update_applied``) and the straggler
:class:`~repro_torch.train.trainer.StepTimeMonitor` — emitting one
:class:`HealthReport` per step:

=================  ========================================  =============
detector           fires when                                default action
=================  ========================================  =============
``nonfinite``      the step's guard skipped the update       skip (rung 0);
                                                             rollback after
                                                             ``max_skips``
``loss_spike``     loss > mean + z·std of the window         rollback
``grad_spike``     raw (pre-clip) grad norm > mean + z·std   rollback
                   of its window AND > 10× its mean
``blowup``         ``blowup_k`` consecutive loss increases   rollback
                   totalling > ``blowup_factor``×
``dead_subspace``  update norm < ``collapse_tol`` × its      force refresh
                   trailing median, grad norm healthy
``subspace_energy``probe captured-energy fraction < floor    (warn only)
``straggler``      step wall time > mean + z·std             (warn only)
=================  ========================================  =============

Detector state is resettable (:meth:`HealthMonitor.reset`): after a
rollback the windows are cleared so replayed steps are judged fresh, which
makes an injected run's detection trace a function of the fault plan (and
of the straggler monitor, which reads the wall clock)."""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Any, Optional

PyTree = Any

WARN = "warn"
CRITICAL = "critical"


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    step: int
    kind: str           # nonfinite | loss_spike | blowup | dead_subspace |
                        # subspace_energy | straggler
    severity: str       # warn | critical
    value: float = 0.0
    detail: str = ""

    def to_json(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "severity": self.severity, "value": self.value,
                "detail": self.detail}


@dataclasses.dataclass
class HealthReport:
    """One step's verdict: ``ok`` (no events), ``warn`` or ``critical``."""

    step: int
    status: str
    events: list
    loss: float
    grad_norm: float
    update_norm: Optional[float] = None

    @property
    def critical(self) -> list:
        return [e for e in self.events if e.severity == CRITICAL]


class HealthMonitor:
    """Windowed detectors over the per-step scalar signals.

    ``observe`` is called once per step with host-side floats; it returns a
    :class:`HealthReport` and appends any events to ``self.events``.
    Unhealthy samples are *not* folded into the detector windows (a spike
    must not inflate the very std that detects the next one)."""

    def __init__(self, cfg=None, step_monitor=None):
        from repro_torch.resilience.recovery import ResilienceConfig

        self.cfg = cfg or ResilienceConfig()
        self.step_monitor = step_monitor
        self.events: list = []
        self.counts: collections.Counter = collections.Counter()
        self.reset()

    def reset(self) -> None:
        """Clear detector windows (called after a rollback/restore so
        replayed steps are judged against fresh statistics)."""
        c = self.cfg
        self._losses = collections.deque(maxlen=c.spike_window)
        self._gnorms = collections.deque(maxlen=c.spike_window)
        self._unorms = collections.deque(maxlen=c.collapse_window)
        self._trend: list = []

    # ------------------------------------------------------------- detectors

    def _detect_nonfinite(self, step, applied, out):
        if not applied:
            out.append(HealthEvent(step, "nonfinite", CRITICAL,
                                   detail="in-jit NaN/Inf guard skipped "
                                          "the update"))

    def _detect_spike(self, step, loss, out):
        c = self.cfg
        if len(self._losses) >= c.spike_min_samples:
            mu = statistics.fmean(self._losses)
            sd = statistics.pstdev(self._losses) or 1e-9
            if loss > mu + c.spike_z * sd and loss - mu > c.spike_min_delta:
                out.append(HealthEvent(
                    step, "loss_spike", CRITICAL, value=loss,
                    detail=f"loss {loss:.4g} > {mu:.4g} + "
                           f"{c.spike_z}*{sd:.4g}"))
                return True
        return False

    def _detect_grad_spike(self, step, grad_norm, out):
        """Raw (pre-clip) gradient-norm spike: grad_clip neutralizes the
        update magnitude, but a spiked gradient still poisons the clipped
        direction and the low-rank momenta — this is the detector that sees
        it.  The 10× relative guard keeps normal warmup drift quiet."""
        c = self.cfg
        if len(self._gnorms) >= c.spike_min_samples and grad_norm > 0:
            mu = statistics.fmean(self._gnorms)
            sd = statistics.pstdev(self._gnorms) or 1e-9
            if grad_norm > mu + c.spike_z * sd and grad_norm > 10.0 * mu:
                out.append(HealthEvent(
                    step, "grad_spike", CRITICAL, value=grad_norm,
                    detail=f"raw grad norm {grad_norm:.4g} > {mu:.4g} + "
                           f"{c.spike_z}*{sd:.4g} (pre-clip)"))
                return True
        return False

    def _detect_blowup(self, step, loss, out):
        c = self.cfg
        if self._trend and loss > self._trend[-1]:
            self._trend.append(loss)
        else:
            self._trend = [loss]
        if (len(self._trend) > c.blowup_k
                and self._trend[-1] > c.blowup_factor * self._trend[0]):
            out.append(HealthEvent(
                step, "blowup", CRITICAL, value=loss,
                detail=f"{len(self._trend) - 1} consecutive increases, "
                       f"{self._trend[0]:.4g} -> {loss:.4g}"))
            self._trend = [loss]
            return True
        return False

    def _detect_collapse(self, step, grad_norm, update_norm, out):
        c = self.cfg
        if update_norm is None:
            return False
        if len(self._unorms) >= c.collapse_min_samples and grad_norm > 1e-12:
            med = statistics.median(self._unorms)
            if med > 0 and update_norm < c.collapse_tol * med:
                out.append(HealthEvent(
                    step, "dead_subspace", CRITICAL, value=update_norm,
                    detail=f"update norm {update_norm:.3g} < "
                           f"{c.collapse_tol} * median {med:.3g} "
                           f"(grad norm {grad_norm:.3g})"))
                return True
        return False

    def _detect_energy(self, step, probes, out):
        """Per-family captured-energy fraction from the spectrum probes
        (only meaningful right after a refresh; callers gather them on
        refresh boundaries).  A starved subspace is a rank-policy problem,
        not a transient fault, so this warns rather than escalates."""
        c = self.cfg
        for (m, n), pr in sorted((probes or {}).items()):
            g2 = float(pr.get("g2", 0.0))
            if g2 <= 0.0:
                continue
            frac = float(sum(pr["sv2"])) / g2
            if frac < c.energy_min:
                out.append(HealthEvent(
                    step, "subspace_energy", WARN, value=frac,
                    detail=f"family {m}x{n} captures {frac:.3f} "
                           f"< {c.energy_min} of gradient energy"))

    # ------------------------------------------------------------- observe

    def observe(self, step: int, *, loss: float, applied: bool,
                grad_norm: float = 0.0, update_norm: Optional[float] = None,
                dt: Optional[float] = None,
                probes: Optional[dict] = None) -> HealthReport:
        events: list = []
        self._detect_nonfinite(step, applied, events)
        healthy_loss = True
        if applied:
            spiked = self._detect_spike(step, loss, events)
            blew = self._detect_blowup(step, loss, events)
            healthy_loss = not (spiked or blew)
        gspiked = (applied
                   and self._detect_grad_spike(step, grad_norm, events))
        collapsed = self._detect_collapse(step, grad_norm, update_norm,
                                          events)
        self._detect_energy(step, probes, events)
        if dt is not None and self.step_monitor is not None:
            if self.step_monitor.record(step, dt):
                events.append(HealthEvent(step, "straggler", WARN, value=dt))

        # Fold only healthy samples into the windows.
        if applied and healthy_loss:
            self._losses.append(loss)
        if applied and not gspiked and grad_norm > 0:
            self._gnorms.append(grad_norm)
        if update_norm is not None and not collapsed and applied:
            self._unorms.append(update_norm)

        status = "ok"
        if any(e.severity == CRITICAL for e in events):
            status = CRITICAL
        elif events:
            status = WARN
        for e in events:
            self.counts[e.kind] += 1
        self.events.extend(events)
        return HealthReport(step=step, status=status, events=events,
                            loss=loss, grad_norm=grad_norm,
                            update_norm=update_norm)
