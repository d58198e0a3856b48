"""Host-side gatherers over the live optimizer state (the JAX package's
``telemetry/instrument.py`` on torch tensors).

``lowrank(telemetry=True)`` stores its in-step measurements inside the
spectrum-probe dicts (``LowRankState.probes``); this module reads them out
between steps and turns them into bus metrics:

  * :func:`lowrank_family_metrics` — per shape family: captured-energy
    fraction at rank r (sum of the top-r squared singular values of PᵀG over
    total gradient energy), projector drift since the previous refresh
    (1 − mean subspace overlap via the r×r Gram), the sampled per-step bias
    residual (1 − ‖PᵀG‖²/‖G‖²) with the step it was sampled at, and the
    current rank.
  * :class:`GammaSlotTracker` — the layerwise-unbias gamma-slot sampling
    distribution: which blocks the debiasing currently runs full-rank, plus
    cumulative per-block visit counts across refreshes.
  * :func:`launch_crosscheck` — the dispatch counts of one traced update of
    the live optimizer against the closed-form launch model
    (:mod:`repro_torch.analysis.launch_model`), the Trainer's
    ``launch_crosscheck`` event.

Everything here only reads the state.  Each probe dict crosses to the host
in one copy, and a tracker's observation copies every slot index at once.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

PyTree = Any

# The probe fields read to the host, in the order they are packed.
_TELEMETRY_FIELDS = ("drift", "bias", "bias_step")


def _is_probe(x) -> bool:
    return isinstance(x, dict) and "sv2" in x and "g2" in x


def _probe_to_host(pr: dict) -> dict:
    """One probe dict as host values, through a single device-to-host copy
    (the scalars and ``mn`` ride in float64, exact for these integers)."""
    fields = ["mn", "g2", *(k for k in _TELEMETRY_FIELDS if k in pr)]
    device = pr["sv2"].device
    packed = torch.cat([pr[k].to(device=device, dtype=torch.float64).reshape(-1)
                        for k in fields] + [pr["sv2"].to(torch.float64)]).cpu().numpy()
    host = {"mn": (int(packed[0]), int(packed[1])), "g2": float(packed[2]),
            "sv2": packed[len(fields) + 1:]}
    for i, k in enumerate(fields[2:]):
        host[k] = float(packed[3 + i])
    return host


def lowrank_family_metrics(opt_state: PyTree) -> list[dict]:
    """Per-(m, n) family telemetry read from the probe dicts; one record per
    shape family, averaged over same-shape leaves on the per-leaf path.
    Keys ``drift`` / ``bias`` / ``bias_step`` appear only when the state was
    built with ``lowrank(telemetry=True)``; energy and rank work with plain
    ``probe_spectrum=True`` probes too.  Empty list when no probes exist."""
    from repro_torch.core.combinators import find_lowrank_states

    acc: dict[tuple[int, int], dict] = {}
    for st in find_lowrank_states(opt_state):
        if st.probes is None:
            continue
        for pr in st.probes.values():
            if not _is_probe(pr):
                continue
            host = _probe_to_host(pr)
            mn = host["mn"]
            cur = acc.setdefault(mn, {
                "m": mn[0], "n": mn[1], "rank": int(host["sv2"].shape[0]),
                "sv2_sum": 0.0, "g2": 0.0, "leaves": 0,
                "drift": 0.0, "bias": 0.0, "bias_step": -1,
                "has_telemetry": False,
            })
            cur["sv2_sum"] += float(host["sv2"].sum())
            cur["g2"] += host["g2"]
            cur["leaves"] += 1
            if "drift" in host:
                cur["has_telemetry"] = True
                cur["drift"] += host["drift"]
                cur["bias"] += host["bias"]
                cur["bias_step"] = max(cur["bias_step"], int(host["bias_step"]))

    out = []
    for mn in sorted(acc):
        cur = acc[mn]
        n_leaves = max(cur["leaves"], 1)
        rec = {
            "family": f"{mn[0]}x{mn[1]}",
            "m": cur["m"], "n": cur["n"], "rank": cur["rank"],
            "energy": (cur["sv2_sum"] / cur["g2"]) if cur["g2"] > 0 else 0.0,
        }
        if cur["has_telemetry"]:
            rec["drift"] = cur["drift"] / n_leaves
            rec["bias"] = cur["bias"] / n_leaves
            rec["bias_step"] = cur["bias_step"]
        out.append(rec)
    return out


def find_unbias_states(state: PyTree) -> list:
    """Every :class:`~repro_torch.core.combinators.LayerwiseUnbiasState`
    inside an optimizer state (they live inside ``LowRankState.inner``)."""
    from repro_torch.core.combinators import LayerwiseUnbiasState, find_nodes

    return find_nodes(state, LayerwiseUnbiasState)


class GammaSlotTracker:
    """Cumulative histogram of layerwise-unbias gamma-slot assignments.

    Call :meth:`observe` at refresh boundaries; it reads the current
    slot→block index tensors out of every ``LayerwiseUnbiasState`` and folds
    them into per-leaf visit counts.  The returned records expose both the
    live assignment and the cumulative distribution (min/max/mean visits per
    block), so a skewed sampler — blocks that never take their full-rank
    turn — is visible in one event."""

    def __init__(self):
        # (unbias-state index, idx-leaf index) -> np.ndarray of visit counts
        self.counts: dict[tuple[int, int], np.ndarray] = {}
        self.observations = 0

    def observe(self, opt_state: PyTree) -> list[dict]:
        records = []
        states = find_unbias_states(opt_state)
        if not states:
            return records
        self.observations += 1
        leaves = [[idx for idx in st.idx.values() if idx is not None] for st in states]
        flat = [idx.reshape(-1) for st_leaves in leaves for idx in st_leaves]
        host = (torch.cat([idx.to(device=flat[0].device, dtype=torch.int64) for idx in flat])
                .cpu().numpy() if flat else np.zeros(0, dtype=np.int64))
        at = 0
        for si, st_leaves in enumerate(leaves):
            for li, idx in enumerate(st_leaves):
                slots = host[at:at + idx.numel()].astype(int)
                at += idx.numel()
                key = (si, li)
                hist = self.counts.get(key)
                size = int(slots.max()) + 1 if slots.size else 0
                if hist is None or hist.shape[0] < size:
                    grown = np.zeros(max(size, 1), dtype=np.int64)
                    if hist is not None:
                        grown[: hist.shape[0]] = hist
                    hist = grown
                    self.counts[key] = hist
                np.add.at(hist, slots, 1)
                records.append({
                    "leaf": li,
                    "slots": [int(s) for s in slots],
                    "visits_min": int(hist.min()),
                    "visits_max": int(hist.max()),
                    "visits_mean": round(float(hist.mean()), 3),
                })
        return records


def launch_crosscheck(transform, params: dict, *, name: str = "optimizer") -> dict:
    """The launch-count cross-check of the optimizer about to train: the
    dispatch counts of one update traced on ``meta`` copies of ``params``
    (:func:`repro_torch.analysis.trace_update`) against the closed-form
    model (:func:`repro_torch.analysis.expected_launches`), as a telemetry
    event instead of a hard failure.  The traced update is the first after
    ``init``, a refresh: the model counts the refresh-only spectrum probe as
    the reference's trace does, so ``expected``, ``traced`` and ``ok`` are
    the reference's on the same configuration, telemetry on or off.
    Returns ``{expected, traced, ok, unmodeled}``; ``ok`` is False when the
    counts diverge or the model could not account for a stage (RA303)."""
    from repro_torch.analysis.launch_model import expected_launches
    from repro_torch.analysis.trace_passes import trace_update

    expected, findings = expected_launches(transform, params, name=name)
    traced = trace_update(transform, params).counts
    return {
        "expected": expected,
        "traced": traced,
        "ok": not findings and traced == expected,
        "unmodeled": [f.code for f in findings],
    }
