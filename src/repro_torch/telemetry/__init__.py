"""Telemetry (the port of the JAX package's ``telemetry``): one training
run produces one schema-versioned ``events.jsonl`` of scalar metrics (loss,
gradient norm, per-family captured energy / projector drift / bias residual
/ rank), discrete events (health, recovery, fault injection, rank-policy
decisions, checkpoint save / GC / corrupt-skip, gamma slots, profiler
window), host-side timing spans (steady step, refresh step, rank
migration, checkpoint save) and closing counters.

:mod:`repro_torch.telemetry.bus`
    the record bus and its sinks (stdout in the trainer's console format,
    append-only JSONL, in-memory ring); stdlib only, the reference's
    on-disk format byte for byte.

:mod:`repro_torch.telemetry.instrument`
    host-side readers over the live optimizer state: the per-family probe
    metrics that ``lowrank(telemetry=True)`` stores during the update, the
    layerwise-unbias gamma-slot distribution, and ``launch_crosscheck``
    (the dispatch counts of one traced update against the closed-form
    launch model of :mod:`repro_torch.analysis`).

:mod:`repro_torch.telemetry.report`
    the run report / diff CLI: ``python -m repro_torch.telemetry.report
    RUN_DIR [--diff OTHER]``.
"""
from repro_torch.telemetry.bus import (
    SCHEMA_VERSION,
    JsonlSink,
    MemorySink,
    StdoutSink,
    Telemetry,
    TelemetryConfig,
)
from repro_torch.telemetry.instrument import (
    GammaSlotTracker,
    launch_crosscheck,
    lowrank_family_metrics,
)

__all__ = [
    "SCHEMA_VERSION",
    "Telemetry",
    "TelemetryConfig",
    "JsonlSink",
    "StdoutSink",
    "MemorySink",
    "GammaSlotTracker",
    "launch_crosscheck",
    "lowrank_family_metrics",
]
