"""Chain linter: combinator-composition rules checked statically (the port
of the JAX package's ``analysis/chain_lint.py``).

Walks the ``chain_info`` metadata every combinator attaches (see
:func:`repro_torch.core.combinators.chain_info`) — no tensors, nothing
runs.  Rules (stable codes, see :mod:`repro_torch.analysis.findings`):

  RC101  ``lowrank()`` must not nest: the projection owns the leaf protocol
         end-to-end; a nested projection would project projected gradients.
  RC102  ``layerwise_unbias`` / ``with_fira_residual`` consume the
         ProjGrad/ProjInit protocol, so they only work inside ``lowrank()``.
  RC103  ``scale_by_lr`` is the terminal stage of a chain: it materializes
         deferred epilogues and owns the -lr sign; a stage after it would
         scale an already-signed update, and inside ``lowrank()`` it would
         double-count steps.
  RC104  a declared rank ladder must be strictly increasing.
  RC105  the initial rank assignment must lie on the declared ladder —
         otherwise the first policy decision forces an extra, unplanned
         state migration.
  RC106  ``pad_rank_to`` must be a multiple of 128, the reference's TPU
         lane width, kept as the reference's value: the port has no lane
         (its dispatcher pads to a multiple of 8), but a configuration
         lints the same in both packages.

The rank-declaration checks (RC104/RC105) see the *declared* values; the
per-leaf ``min(rank, m, n)`` clamp is shape-dependent and out of scope here
(the traced update sees the clamped shapes).
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.api import Transform
from repro_torch.core.combinators import chain_info as _chain_info

from .findings import Finding

# The reference's TPU lane width (its dispatch._LANE), RC106's granule.
LANE = 128

_PROTOCOL_KINDS = ("layerwise_unbias", "with_fira_residual")


class ChainLintError(ValueError):
    """Raised by ``build_optimizer(..., audit=True)`` on lint errors."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        super().__init__(
            "chain lint failed:\n" + "\n".join(f.format() for f in findings)
        )


def _declared_ranks(rank) -> tuple[int, ...]:
    """Every rank an ``int | RankMap`` assignment declares."""
    if isinstance(rank, int):
        return (rank,)
    ranks = {rank.default}
    ranks.update(r for _, r in rank.overrides)
    return tuple(sorted(ranks))


def _lint_ladder(ladder, where: str, out: list[Finding]) -> None:
    lad = tuple(int(r) for r in ladder)
    if any(b <= a for a, b in zip(lad, lad[1:])):
        out.append(Finding(
            code="RC104", where=where,
            message=f"rank ladder {lad} is not strictly increasing",
            hint="declare the ladder sorted ascending with no duplicates, "
                 f"e.g. {tuple(sorted(set(lad)))}",
        ))


def _lint_lowrank(info: dict, where: str,
                  ladder: Optional[tuple[int, ...]], out: list[Finding]):
    pad = int(info.get("pad_rank_to") or 0)
    if pad and pad % LANE != 0:
        out.append(Finding(
            code="RC106", where=where,
            message=f"pad_rank_to={pad} is not a multiple of the lane "
                    f"width {LANE} (the reference's TPU granule)",
            hint=f"use pad_rank_to={((pad + LANE - 1) // LANE) * LANE} "
                 "(or 0 for the minimal granule)",
        ))
    policy = info.get("rank_policy")
    # The ladder the initial assignment is held against: an explicitly
    # declared one always wins; otherwise adaptive policies are checked
    # against their own ladder (static policies like stepwise may start at
    # the config rank off-ladder by design — at most one extra migration).
    check = None
    if ladder:
        check = tuple(int(r) for r in ladder)
    elif policy is not None and getattr(policy, "wants_probes", False):
        check = tuple(policy.ladder())
    if check:
        declared = _declared_ranks(info.get("rank"))
        off = [r for r in declared if r not in check]
        if off:
            out.append(Finding(
                code="RC105", where=where,
                message=f"initial rank(s) {off} not on the declared ladder "
                        f"{check}",
                hint="start on a ladder rank (or add the rank to "
                     "rank_ladder) so the first policy decision does not "
                     "force an unplanned state migration",
            ))


def _contains_kind(info: dict, kind: str) -> bool:
    if info.get("kind") == kind:
        return True
    for child in info.get("stages", []):
        if _contains_kind(child, kind):
            return True
    for child in info.get("branches", {}).values():
        if _contains_kind(child, kind):
            return True
    inner = info.get("inner")
    return bool(inner) and _contains_kind(inner, kind)


def _walk(info: dict, where: str, inside_lowrank: bool,
          ladder: Optional[tuple[int, ...]], out: list[Finding]) -> None:
    kind = info.get("kind", "opaque")
    if kind == "multi_transform":
        for label, branch in info.get("branches", {}).items():
            _walk(branch, f"{where}/{label}", inside_lowrank, ladder, out)
    elif kind == "chain":
        stages = info.get("stages", [])
        for i, stage in enumerate(stages):
            if stage.get("kind") == "scale_by_lr":
                if inside_lowrank:
                    out.append(Finding(
                        code="RC103", where=f"{where}/stage{i}",
                        message="scale_by_lr composed inside lowrank() — "
                                "it would scale the projected-space update "
                                "and keep its own step count",
                        hint="move scale_by_lr to the end of the outer "
                             "chain, after the lowrank() stage",
                    ))
                elif i != len(stages) - 1:
                    out.append(Finding(
                        code="RC103", where=f"{where}/stage{i}",
                        message=f"scale_by_lr at stage {i} of "
                                f"{len(stages)} — stages after it rescale "
                                "an already-signed update and deferred "
                                "epilogues are materialized too early",
                        hint="make scale_by_lr the last stage of the chain",
                    ))
        if (not inside_lowrank
                and _contains_kind(info, "lowrank")
                and not any(s.get("kind") == "scale_by_lr" for s in stages)):
            out.append(Finding(
                code="RC103", severity="warning", where=where,
                message="chain has a lowrank() stage but no terminal "
                        "scale_by_lr — fused epilogues fall back to "
                        "per-leaf materialization in apply_updates",
                hint="end the chain with scale_by_lr(lr)",
            ))
        for i, stage in enumerate(stages):
            _walk(stage, f"{where}/stage{i}", inside_lowrank, ladder, out)
    elif kind == "lowrank":
        if inside_lowrank:
            out.append(Finding(
                code="RC101", where=where,
                message="lowrank() nested inside another lowrank() — the "
                        "inner projection would re-project already-projected "
                        "gradients and double the projector state",
                hint="compose exactly one lowrank() per chain; put the "
                     "inner transform directly inside it",
            ))
        _lint_lowrank(info, where, ladder, out)
        _walk(info.get("inner", {}), f"{where}/inner", True, ladder, out)
    elif kind in _PROTOCOL_KINDS:
        if not inside_lowrank:
            out.append(Finding(
                code="RC102", where=where,
                message=f"{kind} outside lowrank() — it consumes the "
                        "ProjGrad/ProjInit leaf protocol that only "
                        "lowrank() emits (TypeError at the first step)",
                hint=f"wrap it: lowrank({kind}(...), rank=..., period=...)",
            ))
        _walk(info.get("inner", {}), f"{where}/inner", inside_lowrank,
              ladder, out)
    elif "inner" in info:
        _walk(info["inner"], f"{where}/inner", inside_lowrank, ladder, out)


def lint_chain(
    transform: Transform | dict,
    *,
    ladder: Iterable[int] = (),
    name: str = "chain",
) -> list[Finding]:
    """Lint a combinator-built transform (or a raw ``chain_info`` dict).

    ``ladder`` is the externally declared rank ladder
    (``OptimizerConfig.rank_ladder`` / ``--rank-ladder``) the initial rank
    assignment is held against; adaptive policies are additionally checked
    against their own ladder."""
    info = transform if isinstance(transform, dict) else _chain_info(transform)
    out: list[Finding] = []
    lad = tuple(int(r) for r in ladder)
    if lad:
        _lint_ladder(lad, name, out)
    _walk(info, name, False, lad or None, out)
    return out
