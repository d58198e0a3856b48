"""Closed-form expected kernel-launch counts (the port of the JAX package's
``analysis/launch_model.py``).

The fused step engine's contract is "one pipeline launch set per shape
family" (per matrix leaf on the per-leaf path).  This module derives the
*expected* per-step dispatch counts purely from static structure — the
``chain_info`` composition metadata plus the
:class:`~repro_torch.core.family_plan.FamilyPlan` of an abstract params tree — so
the audit can assert them against the dispatch layer's recorded counts
(:mod:`repro_torch.kernels.launch_count`).  The port counts per executed
call: an update on ``meta`` tensors (:mod:`repro_torch.analysis.trace_passes`)
gives the counts of one step without computing anything.

Per *unit* (family when ``fuse_families=True``, lowrank-routed leaf
otherwise) the inner transform determines the op mix:

  ====================================  =======================================
  inner                                 launches / unit
  ====================================  =======================================
  ``scale_by_adam``                     project, back_project
  ``scale_by_muon``                     lowrank_update, newton_schulz,
                                        back_project
  ``scale_by_momentum``                 lowrank_update, back_project
  ``layerwise_unbias(x)``               x's mix with lowrank_update -> project
                                        (the unbias needs the explicit
                                        projected gradient and emits a
                                        FullUpdate, so no epilogue fusion);
                                        units with sampling ratio
                                        ``q = gamma/L < 1`` (leaves with lead
                                        blocks) additionally run the plain
                                        low-rank branch, adding x's mix as-is
  ``with_fira_residual(x)``             x's mix + 1 back_project (the
                                        norm-matched residual)
  ====================================  =======================================

``fused_epilogue=True`` rewrites ``back_project`` ->
``back_project_epilogue`` for epilogue-able inners (those that return a
projected update rather than a FullUpdate).  Outside ``lowrank()``, plain
``scale_by_muon`` contributes one ``newton_schulz`` per >=2-D routed leaf;
every other combinator is elementwise PyTorch (zero dispatch launches).

The spectrum probe (rank policies, telemetry) projects once per unit at a
refresh only: the model counts it, as the reference's trace does, so its
counts are those of a refresh step; a steady step with probes on has one
``project`` per unit fewer.

Stages the model cannot account for produce an ``RA303`` finding instead of
a silently wrong expectation.
"""
from __future__ import annotations

from repro_torch.core.api import Transform
from repro_torch.core.combinators import chain_info as _chain_info
from repro_torch.core.family_plan import build_family_plan, plan_stats
from repro_torch.core.lowrank_common import family_shape

from .findings import Finding

# Combinators that never touch the dispatch layer (elementwise PyTorch).
_ELEMENTWISE = frozenset({
    "scale_by_lr", "scale_by_factor", "add_decayed_weights",
    "clip_by_global_norm",
})
# Zero-launch leaf optimizers when applied to raw (unprojected) gradients.
_RAW_ZERO = frozenset({"scale_by_adam", "scale_by_momentum", "lisa"})

_BASE_COEFFS = {
    "scale_by_adam": ({"project": 1, "back_project": 1}, True),
    "scale_by_muon": (
        {"lowrank_update": 1, "newton_schulz": 1, "back_project": 1}, True),
    "scale_by_momentum": ({"lowrank_update": 1, "back_project": 1}, True),
}


def _ra303(where: str, what: str) -> Finding:
    return Finding(
        code="RA303", where=where,
        message=f"launch model cannot account for {what}",
        hint="tag the transform with chain_info metadata (see "
             "repro_torch.core.combinators) or extend the coefficient table "
             "in repro_torch.analysis.launch_model",
    )


def _inner_coeffs(info: dict, where: str, out: list[Finding]):
    """Per-unit op coefficients of a lowrank() inner -> (coeffs, epilogue_able).

    ``epilogue_able`` means the inner returns a projected update that
    ``fused_epilogue`` can defer; protocol wrappers that emit a FullUpdate
    (layerwise_unbias, with_fira_residual) are not."""
    kind = info.get("kind", "opaque")
    if kind == "chain":
        cores = [s for s in info.get("stages", [])
                 if s.get("kind") not in _ELEMENTWISE]
        if len(cores) != 1:
            out.append(_ra303(where, f"a lowrank() inner chain with "
                                     f"{len(cores)} non-elementwise stages"))
            return None, False
        return _inner_coeffs(cores[0], where, out)
    if kind == "layerwise_unbias":
        coeffs, _ = _inner_coeffs(info.get("inner", {}), f"{where}/inner", out)
        if coeffs is None:
            return None, False
        coeffs = dict(coeffs)
        coeffs["project"] = coeffs.get("project", 0) + coeffs.pop(
            "lowrank_update", 0)
        return coeffs, False
    if kind == "with_fira_residual":
        coeffs, _ = _inner_coeffs(info.get("inner", {}), f"{where}/inner", out)
        if coeffs is None:
            return None, False
        coeffs = dict(coeffs)
        coeffs["back_project"] = coeffs.get("back_project", 0) + 1
        return coeffs, False
    if kind in _BASE_COEFFS:
        coeffs, able = _BASE_COEFFS[kind]
        return dict(coeffs), able
    out.append(_ra303(where, f"inner stage kind {kind!r} inside lowrank()"))
    return None, False


def _core(info: dict) -> dict | None:
    """Unwrap a chain down to its single non-elementwise core stage (or the
    node itself when it isn't a chain); ``None`` when ambiguous."""
    if info.get("kind") == "chain":
        cores = [s for s in info.get("stages", [])
                 if s.get("kind") not in _ELEMENTWISE]
        return cores[0] if len(cores) == 1 else None
    return info


def _add(total: dict, coeffs: dict, units: int) -> None:
    for op, c in coeffs.items():
        if c * units:
            total[op] = total.get(op, 0) + c * units


def _leaves(params: dict) -> list:
    return [p for p in params.values() if p is not None]


def _mask(params: dict, labels: dict, name: str) -> dict:
    """``params`` with the leaves not labelled ``name`` set to None."""
    return {k: (p if labels[k] == name else None) for k, p in params.items()}


def _walk(info: dict, params, where: str, total: dict,
          out: list[Finding]) -> None:
    kind = info.get("kind", "opaque")
    if kind == "multi_transform":
        label_fn = info.get("label_fn")
        if label_fn is None:
            out.append(_ra303(where, "a multi_transform without a label_fn"))
            return
        labels = label_fn(params)
        for name, branch in info.get("branches", {}).items():
            _walk(branch, _mask(params, labels, name), f"{where}/{name}", total, out)
    elif kind == "chain":
        for i, stage in enumerate(info.get("stages", [])):
            _walk(stage, params, f"{where}/stage{i}", total, out)
    elif kind == "lowrank":
        inner = info.get("inner", {})
        coeffs, epilogue_able = _inner_coeffs(inner, f"{where}/inner", out)
        if coeffs is None:
            return
        if info.get("fused_epilogue") and epilogue_able:
            coeffs["back_project_epilogue"] = coeffs.pop("back_project", 0)
        leaves = _leaves(params)
        rank = info.get("rank")
        if info.get("fuse_families"):
            # sampling unit under stacking is the MEMBER leaf, so L_eff is
            # the member's own block count, not the stacked lead
            unit_Ls = [f.member_fs.L
                       for f in build_family_plan(leaves, rank).families]
        else:
            unit_Ls = [family_shape(p, rank).L for p in leaves]
        _add(total, coeffs, len(unit_Ls))
        if info.get("probe_spectrum") and not info.get("external_refresh"):
            # The refresh's spectrum probe (rank policies / telemetry)
            # projects PᵀG through the dispatch layer once per unit.  The
            # reference's trace counts it on every step (its cond body is
            # traced); the port runs it at a refresh only, so this is a
            # refresh step's count.
            _add(total, {"project": 1}, len(unit_Ls))
        core = _core(inner)
        if core is not None and core.get("kind") == "layerwise_unbias":
            # q = gamma/L < 1: the plain low-rank branch runs alongside the
            # compensated sample, adding the inner's own mix per such unit
            gamma = int(core.get("gamma", 0))
            if gamma <= 0:
                out.append(_ra303(where, "layerwise_unbias with gamma<=0"))
                return
            low_units = sum(1 for L in unit_Ls if gamma < L)
            if low_units:
                low_core = _core(core.get("inner", {})) or {}
                lk = low_core.get("kind")
                if lk in _BASE_COEFFS:
                    _add(total, dict(_BASE_COEFFS[lk][0]), low_units)
                else:
                    out.append(_ra303(
                        f"{where}/inner",
                        f"the q<1 low branch of layerwise_unbias over "
                        f"inner kind {lk!r}"))
    elif kind == "scale_by_muon":
        units = sum(1 for p in _leaves(params) if getattr(p, "ndim", 0) >= 2)
        _add(total, {"newton_schulz": 1}, units)
    elif kind in _ELEMENTWISE or kind in _RAW_ZERO:
        pass
    elif "inner" in info:
        _walk(info["inner"], params, f"{where}/inner", total, out)
    else:
        out.append(_ra303(where, f"stage kind {kind!r}"))


def chain_ns_steps(transform: Transform | dict) -> int:
    """The iterations of the chain's Newton-Schulz: the ``ns_steps`` of its
    first ``scale_by_muon`` stage (0 without one).  With the dispatch
    counts it gives the CUDA launches
    (:func:`repro_torch.kernels.launch_count.kernel_launches`)."""
    info = transform if isinstance(transform, dict) else _chain_info(transform)
    if info.get("kind") == "scale_by_muon":
        return int(info["ns_steps"])
    children = (info.get("stages", []) + list(info.get("branches", {}).values())
                + ([info["inner"]] if "inner" in info else []))
    for child in children:
        n = chain_ns_steps(child)
        if n:
            return n
    return 0


def expected_launches(
    transform: Transform | dict, params, *, name: str = "chain",
) -> tuple[dict[str, int], list[Finding]]:
    """Expected per-step dispatch-launch counts for ``transform`` applied to
    a ``params`` tree (``{path: tensor}``, on any device, ``meta`` too).

    Returns ``(counts, findings)`` where ``counts`` maps dispatch op name to
    launches/step and ``findings`` holds ``RA303`` entries for any stage the
    model could not account for (in which case ``counts`` is a lower bound
    and must not be asserted)."""
    info = transform if isinstance(transform, dict) else _chain_info(transform)
    total: dict[str, int] = {}
    out: list[Finding] = []
    _walk(info, params, name, total, out)
    return total, out


def lowrank_nodes(transform: Transform | dict, params: dict, *,
                  name: str = "chain") -> list[tuple[str, dict, object]]:
    """``(where, chain_info node, FamilyPlan)`` of every ``lowrank()`` node
    the chain routes, on the same masked-leaf view ``_walk`` uses for the
    launch counts.  Purely static; unknown stages are skipped."""
    return [(where, node, build_family_plan(_leaves(view), node.get("rank")))
            for where, node, view in lowrank_views(transform, params, name=name)]


def lowrank_views(transform: Transform | dict, params: dict, *,
                  name: str = "chain") -> list[tuple[str, dict, dict]]:
    """``(where, chain_info node, masked params)`` of every ``lowrank()``
    node the chain routes: ``params`` with the leaves the node does not see
    set to None."""
    info = transform if isinstance(transform, dict) else _chain_info(transform)
    out: list[tuple[str, dict, dict]] = []

    def visit(node: dict, params, where: str) -> None:
        kind = node.get("kind", "opaque")
        if kind == "multi_transform":
            label_fn = node.get("label_fn")
            if label_fn is None:
                return
            labels = label_fn(params)
            for bname, branch in node.get("branches", {}).items():
                visit(branch, _mask(params, labels, bname), f"{where}/{bname}")
        elif kind == "chain":
            for i, stage in enumerate(node.get("stages", [])):
                visit(stage, params, f"{where}/stage{i}")
        elif kind == "lowrank":
            out.append((where, node, params))
        elif "inner" in node:
            visit(node["inner"], params, f"{where}/inner")

    visit(info, params, name)
    return out


def lowrank_plan_stats(
    transform: Transform | dict, params, *, name: str = "chain",
) -> list[dict]:
    """Family-plan geometry of every ``lowrank()`` node the chain routes:
    one :func:`~repro_torch.core.family_plan.plan_stats` dict per node (plus
    ``where`` / ``fused``), on the same masked-leaf view ``_walk`` uses for
    the launch counts.  Purely static; unknown stages are skipped."""
    return [{"where": where, "fused": bool(node.get("fuse_families")), **plan_stats(plan)}
            for where, node, plan in lowrank_nodes(transform, params, name=name)]
