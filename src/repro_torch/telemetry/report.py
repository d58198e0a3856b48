"""Run-report / diff CLI over a telemetry ``events.jsonl``.

    python -m repro_torch.telemetry.report RUN_DIR            # summary
    python -m repro_torch.telemetry.report RUN_DIR --diff B   # compare two runs

``RUN_DIR`` is either a directory containing ``events.jsonl`` (the trainer's
checkpoint dir) or a direct path to a jsonl file.  The summary renders: run
header, loss-curve stats, per-family rank / captured-energy / drift / bias
trajectories, the event timeline (warn+ always, info folded into counts),
span breakdown, and recovery/fault counters.  ``--diff`` lines the two runs'
loss stats, span means, and event counts up side by side.

Pure stdlib + :mod:`repro_torch.telemetry.bus` (the JAX package's
``telemetry/report.py`` under this package's name) — usable on a machine
without torch.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from .bus import read_jsonl


def _resolve(path: str) -> str:
    if os.path.isdir(path):
        cand = os.path.join(path, "events.jsonl")
        if not os.path.exists(cand):
            raise FileNotFoundError(f"{path}: no events.jsonl inside")
        return cand
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _stats(values: list[float]) -> dict:
    if not values:
        return {}
    s = sorted(values)
    return {
        "n": len(s),
        "first": s and values[0],
        "last": values[-1],
        "min": s[0],
        "max": s[-1],
        "median": s[len(s) // 2],
        "mean": sum(s) / len(s),
    }


class Run:
    """Parsed view of one events.jsonl."""

    def __init__(self, path: str):
        self.path = _resolve(path)
        self.records = read_jsonl(self.path)
        self.header: dict = {}
        self.counters: dict = {}
        self.span_agg: dict = {}
        self.metrics: dict[str, list[tuple[Optional[int], float]]] = {}
        self.events: list[dict] = []
        self.spans: dict[str, list[float]] = {}
        # family tag -> metric name -> [(step, value)]
        self.families: dict[str, dict[str, list[tuple[int, float]]]] = {}
        for rec in self.records:
            kind = rec.get("kind")
            if kind == "header":
                self.header = rec
            elif kind == "counters":
                self.counters = rec.get("counts", {})
                self.span_agg = rec.get("spans", {})
            elif kind == "metric":
                name, value = rec.get("name", "?"), rec.get("value", 0.0)
                step = rec.get("step")
                fam = (rec.get("tags") or {}).get("family")
                if fam is not None:
                    self.families.setdefault(fam, {}).setdefault(
                        name, []).append((step, value))
                else:
                    self.metrics.setdefault(name, []).append((step, value))
            elif kind == "event":
                self.events.append(rec)
            elif kind == "span":
                self.spans.setdefault(rec.get("name", "?"), []).append(
                    rec.get("dur_us", 0.0))

    # ------------------------------------------------------------ accessors

    def metric_values(self, name: str) -> list[float]:
        return [v for _, v in self.metrics.get(name, [])]

    def span_summary(self) -> dict[str, dict]:
        if self.span_agg:
            return self.span_agg
        out = {}
        for name, durs in sorted(self.spans.items()):
            out[name] = {"count": len(durs),
                         "total_us": round(sum(durs), 1),
                         "mean_us": round(sum(durs) / len(durs), 1)}
        return out

    def event_counts(self) -> dict[str, int]:
        if self.counters:
            return {k: v for k, v in self.counters.items()
                    if k.startswith("event.")}
        counts: dict[str, int] = {}
        for ev in self.events:
            key = f"event.{ev.get('name', '?')}"
            counts[key] = counts.get(key, 0) + 1
        return counts


# ---------------------------------------------------------------- rendering

def _fmt(v, width: int = 10) -> str:
    if isinstance(v, float):
        return f"{v:{width}.4g}"
    return f"{str(v):>{width}}"


def summarize(run: Run, out=None) -> None:
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    w(f"# telemetry report: {run.path}")
    hdr = run.header
    if hdr:
        meta = hdr.get("run", {})
        pairs = " ".join(f"{k}={v}" for k, v in sorted(meta.items()))
        w(f"schema {hdr.get('schema', '?')}  {pairs}")
    w()

    loss = run.metric_values("loss")
    if loss:
        st = _stats(loss)
        w("## loss")
        w(f"  steps={st['n']} first={st['first']:.4f} last={st['last']:.4f} "
          f"min={st['min']:.4f} median={st['median']:.4f}")
        w()

    other = sorted(n for n in run.metrics if n != "loss")
    if other:
        w("## metrics")
        for name in other:
            st = _stats(run.metric_values(name))
            w(f"  {name:24s} n={st['n']:<5d} last={_fmt(st['last'])} "
              f"mean={_fmt(st['mean'])} max={_fmt(st['max'])}")
        w()

    if run.families:
        w("## families")
        for fam in sorted(run.families):
            series = run.families[fam]
            parts = []
            for name in ("rank", "energy", "drift", "bias"):
                pts = series.get(name)
                if not pts:
                    continue
                first, last = pts[0][1], pts[-1][1]
                if name == "rank":
                    parts.append(f"rank {int(first)}->{int(last)}"
                                 if first != last else f"rank {int(last)}")
                else:
                    parts.append(f"{name} {last:.4f}")
            w(f"  {fam:16s} {'  '.join(parts)}")
        w()

    spans = run.span_summary()
    if spans:
        w("## spans")
        for name, st in sorted(spans.items()):
            w(f"  {name:24s} count={st['count']:<6d} "
          f"mean={st['mean_us'] / 1e3:9.3f}ms total={st['total_us'] / 1e3:9.1f}ms")
        w()

    counts = run.event_counts()
    if counts:
        w("## events")
        for name, n in sorted(counts.items()):
            w(f"  {name[len('event.'):]:24s} {n}")
        w()

    noisy = [ev for ev in run.events
             if ev.get("severity", "info") not in ("info", "debug")]
    if noisy:
        w("## timeline (warn+)")
        for ev in noisy:
            step = ev.get("step")
            at = f"step {step:6d}" if step is not None else " " * 11
            name, detail = ev.get("name", ""), ev.get("detail", "")
            prefix = "" if detail.startswith(name) else f"{name}: "
            w(f"  {at} [{ev.get('severity')}] {prefix}{detail}")
        w()


def diff(a: Run, b: Run, out=None) -> None:
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    w(f"# telemetry diff\n#   A: {a.path}\n#   B: {b.path}")
    w()

    w("## loss")
    for name, run in (("A", a), ("B", b)):
        st = _stats(run.metric_values("loss"))
        if st:
            w(f"  {name}: steps={st['n']} first={st['first']:.4f} "
              f"last={st['last']:.4f} min={st['min']:.4f}")
        else:
            w(f"  {name}: no loss metrics")
    la, lb = a.metric_values("loss"), b.metric_values("loss")
    if la and lb:
        n = min(len(la), len(lb))
        deltas = [abs(x - y) for x, y in zip(la[:n], lb[:n])]
        w(f"  max |A-B| over first {n} steps: {max(deltas):.6g}"
          + ("  (identical)" if max(deltas) == 0 else ""))
    w()

    w("## span means (us)")
    sa, sb = a.span_summary(), b.span_summary()
    for name in sorted(set(sa) | set(sb)):
        ma = sa.get(name, {}).get("mean_us")
        mb = sb.get(name, {}).get("mean_us")
        delta = ""
        if ma and mb:
            delta = f"{(mb - ma) / ma * 100:+8.1f}%"
        w(f"  {name:24s} A={_fmt(ma)} B={_fmt(mb)} {delta}")
    w()

    w("## event counts")
    ca, cb = a.event_counts(), b.event_counts()
    for name in sorted(set(ca) | set(cb)):
        na, nb = ca.get(name, 0), cb.get(name, 0)
        mark = "" if na == nb else "   <-- differs"
        w(f"  {name[len('event.'):]:24s} A={na:<6d} B={nb:<6d}{mark}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Summarize or diff telemetry events.jsonl run logs.")
    ap.add_argument("run", help="run directory (containing events.jsonl) "
                    "or a jsonl path")
    ap.add_argument("--diff", metavar="OTHER", default=None,
                    help="second run to compare against")
    ns = ap.parse_args(argv)
    try:
        run_a = Run(ns.run)
        if ns.diff is None:
            summarize(run_a)
        else:
            diff(run_a, Run(ns.diff))
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
