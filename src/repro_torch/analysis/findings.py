"""Structured findings with stable lint codes (a copy of the JAX package's
``analysis/findings.py``: the same codes, the same meanings).

Codes are append-only API: tests, CI filters and allowlists key on them, so
a code's meaning never changes and retired codes are not reused.  The texts
are the reference's, TPU words included (RC106's lane width, RA601's
barrier pin); :mod:`repro_torch.analysis` says which codes the port emits
and what each means for eager PyTorch.

  RC1xx — chain linter (static combinator composition)
  RA2xx — dtype-flow auditor (the traced aten ops)
  RA3xx — launch/fusion auditor (dispatch counts vs closed-form model)
  RA4xx — recompilation-hazard detector (op-sequence signatures)
  RA5xx — static memory accountant
  RA6xx — collective-schedule / buffer-lifetime auditor (sharded step)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

CODES: dict[str, str] = {
    # chain linter
    "RC101": "lowrank() nested inside another lowrank()",
    "RC102": "protocol combinator (layerwise_unbias / with_fira_residual) "
             "outside lowrank()",
    "RC103": "scale_by_lr missing or not the terminal chain stage",
    "RC104": "declared rank ladder not strictly increasing",
    "RC105": "initial rank assignment not on the declared ladder",
    "RC106": "pad_rank_to not TPU-lane aligned",
    # dtype-flow auditor
    "RA201": "f32 -> f64 dtype leak in the update path",
    "RA202": "bf16 round-trip inside f32 update math",
    # launch/fusion auditor
    "RA301": "traced kernel-launch counts diverge from the closed-form "
             "FamilyPlan expectation",
    "RA302": "fused_epilogue=True left stray unfused back-projection ops",
    "RA303": "chain contains stages the launch model cannot account for",
    # recompilation-hazard detector
    "RA401": "abstract step signature unstable across retraces at a fixed "
             "rank (unbounded recompilation hazard)",
    "RA402": "weak-typed Python-scalar capture in the traced step",
    # static memory accountant
    "RA501": "static projected-state bytes disagree with recorded runtime "
             "numbers",
    # collective-schedule / buffer-lifetime auditor (sharded step)
    "RA601": "gradient reduction not pinned at the declared reduce_dtype "
             "(wider-dtype collective, or convert not barrier-pinned so "
             "XLA re-promotes the all-reduce)",
    "RA602": "collective executes unconditionally that the schedule model "
             "says is boundary-only",
    "RA603": "full-gradient gather in the steady-state step",
    "RA604": "donated input buffer (params / opt state) does not alias an "
             "output in the lowered module",
    "RA605": "per-replica instead of per-shard buffer in the sharded step "
             "(memory accountant would over-count by the mesh size)",
    "RA606": "traced collective schedule diverges from the closed-form "
             "expectation (count / operands / payload bytes)",
}

_SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result: a stable code plus human-readable context."""

    code: str
    message: str
    severity: str = "error"
    hint: str = ""              # fix-it suggestion, shown after the message
    where: str = ""             # chain path / op / rank the finding is about
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered lint code: {self.code!r}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"bad severity: {self.severity!r}")

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        hint = f"\n    fix: {self.hint}" if self.hint else ""
        return f"{self.code} {self.severity}{loc}: {self.message}{hint}"


class AuditReport:
    """Findings from one audit run plus the derived summary numbers."""

    def __init__(self, findings: Iterable[Finding] = (),
                 summary: dict[str, Any] | None = None, name: str = ""):
        self.findings = list(findings)
        self.summary = dict(summary or {})
        self.name = name

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def codes(self) -> set[str]:
        return {f.code for f in self.findings}

    def format(self, verbose: bool = False) -> str:
        head = f"audit {self.name}: " if self.name else "audit: "
        head += "clean" if self.ok else f"{len(self.errors)} error(s)"
        lines = [head]
        for f in self.findings:
            if f.severity == "info" and not verbose:
                continue
            lines.append("  " + f.format().replace("\n", "\n  "))
        for k, v in self.summary.items():
            lines.append(f"  {k}={v}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "summary": self.summary,
        }
