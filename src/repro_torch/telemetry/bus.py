"""Structured event/metric bus with pluggable sinks (the JAX package's
``telemetry/bus.py``, unchanged: stdlib only; its on-disk format is the
reference's, byte for byte).

Record types (one JSON object per ``events.jsonl`` line, ``kind`` tagged):

  header    — first line of every log: ``schema`` version + run metadata
  metric    — scalar sample:  {step, name, value, tags?}
  event     — discrete occurrence: {step?, name, severity, detail, data?}
  span      — host-side timing: {step?, name, dur_us, tags?}
  counters  — closing summary: cumulative event counts + per-span
              aggregates (count / total_us / mean_us)

Every record carries ``t`` (seconds from the bus clock — wall time in
production, an injected deterministic clock in tests/golden files).  The
schema is versioned through :data:`SCHEMA_VERSION`; readers
(:mod:`repro_torch.telemetry.report`) refuse logs from a newer schema rather than
misparse them.

Sinks:

  :class:`JsonlSink`   — append-only JSONL file (the durable run log)
  :class:`StdoutSink`  — pretty-prints *event* records in the trainer's
                         historical console format (``step  N detail`` /
                         bare ``detail``), so migrating a ``print()`` onto
                         the bus keeps the console byte-compatible while
                         guaranteeing the JSONL saw the same record
  :class:`MemorySink`  — bounded in-memory ring (tests, report unit checks)

The bus itself is synchronous and dependency-free; emitting with no sinks
attached is a no-op, so call sites never need a null-object guard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from collections import deque
from typing import Any, Optional, TextIO

SCHEMA_VERSION = 1


def _clean(rec: dict) -> dict:
    """Drop empty optional fields so records stay one short line each."""
    return {k: v for k, v in rec.items()
            if v is not None and not (isinstance(v, dict) and not v)}


class JsonlSink:
    """Append-only JSONL writer — one run, one file, flushed per record
    (a crashed run keeps every record up to the crash)."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[TextIO] = open(path, "a")

    def write(self, record: dict) -> None:
        if self._f is None:
            return
        json.dump(record, self._f, separators=(",", ":"), sort_keys=True,
                  default=str)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutSink:
    """Console renderer for ``event`` records.

    Formats match the trainer's pre-bus ``print()`` lines exactly
    (``step {step:6d} {detail}``, or bare ``detail`` for step-less events),
    so the console log is unchanged by the migration — but now every line
    the user sees is a record the JSONL sink also received."""

    def __init__(self, stream: Optional[TextIO] = None,
                 min_severity: str = "info"):
        self.stream = stream
        # "debug" events (checkpoint save/gc — things the pre-bus trainer
        # never printed) land in the JSONL but stay off the console
        self._rank = {"debug": -1, "info": 0, "warn": 1, "error": 2,
                      "critical": 3}
        self.min_rank = self._rank.get(min_severity, 0)

    def write(self, record: dict) -> None:
        if record.get("kind") != "event":
            return
        if self._rank.get(record.get("severity", "info"), 0) < self.min_rank:
            return
        stream = self.stream or sys.stdout
        detail = record.get("detail") or record.get("name", "")
        step = record.get("step")
        if step is None:
            print(detail, file=stream, flush=True)
        else:
            print(f"step {step:6d} {detail}", file=stream, flush=True)

    def close(self) -> None:
        pass


class MemorySink:
    """Bounded in-memory record ring (newest ``maxlen`` records)."""

    def __init__(self, maxlen: int = 4096):
        self.records: deque = deque(maxlen=maxlen)

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


@dataclasses.dataclass
class TelemetryConfig:
    """Knobs behind ``--telemetry[=spec]`` (spec = ``k=v,k=v`` like the
    resilience flag): ``every`` is the step-metric emission cadence,
    ``events`` overrides the JSONL path (default ``<ckpt_dir>/events.jsonl``),
    ``stdout`` keeps/drops the console pretty-printer, ``memory`` attaches an
    in-memory ring of that size (tests)."""

    every: int = 1
    stdout: bool = True
    events: str = ""
    memory: int = 0

    @classmethod
    def parse(cls, spec) -> Optional["TelemetryConfig"]:
        if spec is None or spec is False:
            return None
        if isinstance(spec, cls):
            return spec
        if spec is True:
            spec = ""
        cfg = cls()
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if not hasattr(cfg, k):
                raise ValueError(
                    f"unknown telemetry knob {k!r} (have: "
                    f"{', '.join(f.name for f in dataclasses.fields(cls))})")
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                setattr(cfg, k, v.lower() in ("1", "true", "yes", "on", ""))
            elif isinstance(cur, int):
                setattr(cfg, k, int(v))
            else:
                setattr(cfg, k, v)
        return cfg


class Telemetry:
    """The bus: every emitter calls one of :meth:`metric` / :meth:`event` /
    :meth:`span` (or :meth:`record_span`) / :meth:`count`; every attached
    sink sees every record.  ``clock`` is injectable for deterministic
    logs (golden-file tests)."""

    def __init__(self, sinks, *, run: Optional[dict] = None, clock=time.time):
        self.sinks = list(sinks)
        self.clock = clock
        self.counters: dict[str, int] = {}
        self._spans: dict[str, list[float]] = {}
        self._closed = False
        self._emit({"kind": "header", "schema": SCHEMA_VERSION,
                    "run": run or {}, "t": self.clock()})

    # ------------------------------------------------------------- plumbing

    def _emit(self, record: dict) -> None:
        for sink in self.sinks:
            sink.write(record)

    def add_sink(self, sink) -> None:
        self.sinks.append(sink)

    # ------------------------------------------------------------- records

    def metric(self, step: int, name: str, value, **tags) -> None:
        self._emit(_clean({"kind": "metric", "t": self.clock(), "step": step,
                           "name": name, "value": float(value),
                           "tags": tags or None}))

    def event(self, name: str, detail: str = "", *, step: Optional[int] = None,
              severity: str = "info", **data) -> None:
        self.counters[f"event.{name}"] = self.counters.get(
            f"event.{name}", 0) + 1
        self._emit(_clean({"kind": "event", "t": self.clock(), "step": step,
                           "name": name, "severity": severity,
                           "detail": detail, "data": data or None}))

    def record_span(self, name: str, dur_s: float, *,
                    step: Optional[int] = None, **tags) -> None:
        self._spans.setdefault(name, []).append(dur_s)
        self._emit(_clean({"kind": "span", "t": self.clock(), "step": step,
                           "name": name, "dur_us": round(dur_s * 1e6, 1),
                           "tags": tags or None}))

    @contextlib.contextmanager
    def span(self, name: str, *, step: Optional[int] = None, **tags):
        t0 = self.clock()
        try:
            yield
        finally:
            self.record_span(name, self.clock() - t0, step=step, **tags)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    # ------------------------------------------------------------- close

    def span_stats(self) -> dict[str, dict]:
        out = {}
        for name, durs in sorted(self._spans.items()):
            total = sum(durs)
            out[name] = {"count": len(durs),
                         "total_us": round(total * 1e6, 1),
                         "mean_us": round(total / len(durs) * 1e6, 1)}
        return out

    def emit_counters(self, step: Optional[int] = None) -> None:
        """Emit a ``counters`` summary record (cumulative counts + span
        aggregates) without closing the bus — end-of-train() marker for a
        Trainer that may train again (benchmark reps, resume tests)."""
        self._emit(_clean({"kind": "counters", "t": self.clock(),
                           "step": step,
                           "counts": dict(sorted(self.counters.items())),
                           "spans": self.span_stats() or None}))

    def close(self, step: Optional[int] = None) -> None:
        """Emit the closing ``counters`` record and close every sink.
        Idempotent — a second close is a no-op."""
        if self._closed:
            return
        self._closed = True
        self.emit_counters(step)
        for sink in self.sinks:
            sink.close()


def read_jsonl(path: str) -> list[dict]:
    """Parse an events.jsonl; raises on a newer-schema header (readers must
    not silently misparse a future format), skips unparseable lines of a
    partially-written (crashed) log instead of dying."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # truncated final line of a crashed writer
    for rec in records:
        if rec.get("kind") == "header" and rec.get("schema", 0) > SCHEMA_VERSION:
            raise ValueError(
                f"{path}: schema {rec['schema']} is newer than this reader "
                f"({SCHEMA_VERSION}) — upgrade repro_torch.telemetry")
    return records
