"""Buffer-lifetime auditor for the data-parallel step (RA604/RA605), the
port of the JAX package's ``analysis/buffers.py``.

The reference's jitted step donates ``params`` and ``opt_state``
(``donate_argnums=(0, 1)``) so XLA updates them in place, and its auditor
reads the lowered StableHLO module for the aliasing (``parse_main_args``,
``donation_findings``).  The port has no lowered module: its step is eager
Python, and its counterparts read what one traced step did
(:func:`repro_torch.analysis.collectives.trace_sharded_step`):

  * :func:`inplace_findings` — RA604 when the step did not write a parameter
    in place: the step rebinds no parameter (``p += u`` / ``p.copy_(new)``
    under ``no_grad``, ``launch/steps.py``), so each parameter keeps its
    storage and its version counter advances.  The optimizer state is
    functional (``update`` returns a new state), so a step briefly holds two
    of it: :func:`repro_torch.analysis.trace_passes.realloc_bytes` counts
    the bytes allocated anew, which the audit reports as
    ``opt_state_realloc_bytes`` (the reference avoids them by donation).
  * :func:`replication_findings` — RA605 when a rank's forward saw more
    than its ``global_batch / N`` rows of the batch (the accountant's
    per-shard model would silently become per-replica).
  * :func:`per_shard_memory` — the static per-shard peak-memory model
    (params + gradients at fp32 + the wire copy at ``reduce_dtype`` + the
    optimizer state + the batch / N), equal to the reference's on the same
    shapes: trees are counted as the reference holds them
    (:func:`repro_torch.analysis.trace_passes.reference_state_bytes`).

``parse_main_args`` and ``ArgInfo`` read StableHLO text and have no
counterpart here.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.combinators import find_lowrank_states

from .findings import Finding
from .trace_passes import reference_state_bytes

PyTree = Any


def param_versions(params: dict) -> dict:
    """Each parameter's storage and in-place version counter, taken before a
    step for :func:`param_writes`."""
    return {k: (p.untyped_storage().data_ptr(), p._version) for k, p in params.items()}


def param_writes(params: dict, before: dict) -> dict:
    """``{path: (same storage, in-place writes)}`` since ``before``
    (:func:`param_versions`)."""
    return {k: (p.untyped_storage().data_ptr() == before[k][0], p._version - before[k][1])
            for k, p in params.items()}


def inplace_findings(writes: dict, *, where: str = "sharded-step") -> list[Finding]:
    """RA604: every parameter of ``writes`` (:func:`param_writes` of one
    step) kept its storage and was written in place at least once."""
    moved = sorted(k for k, (same, _) in writes.items() if not same)
    unwritten = sorted(k for k, (same, n) in writes.items() if same and n <= 0)
    if not moved and not unwritten:
        return []
    return [Finding(
        code="RA604", where=where,
        message=f"{len(moved) + len(unwritten)}/{len(writes)} parameter(s) not "
                f"updated in place by the step ({len(moved)} moved to new storage, "
                f"{len(unwritten)} never written) — a second copy of the model "
                "lives per step",
        hint="update the live parameters in place under no_grad (p.add_ / "
             "p.copy_, launch/steps._apply_in_place) instead of rebinding them",
        detail={"moved": moved[:8], "unwritten": unwritten[:8]},
    )]


def replication_findings(rows: list[int], *, global_batch: int, n_shards: int,
                         where: str = "sharded-step") -> list[Finding]:
    """RA605: on a >1 mesh each forward of a rank sees its ``global_batch /
    n_shards`` rows, not the whole batch."""
    if n_shards <= 1:
        return []
    per = global_batch // n_shards
    bad = [r for r in rows if r != per]
    if not bad:
        return []
    return [Finding(
        code="RA605", where=where,
        message=f"{len(bad)} forward(s) of a rank saw {sorted(set(bad))} rows on the "
                f"{n_shards}-way mesh where the per-shard model charges "
                f"{per} ({global_batch} / {n_shards})",
        hint="give each rank its rows [k·B/n, (k+1)·B/n) of the batch "
             "(launch/shardmap_fsdp.make_shardmap_train_step)",
        detail={"rows": bad, "per_shard": per, "n_shards": n_shards},
    )]


def per_shard_memory(params: dict, opt_state: PyTree, batch: PyTree, *, n_shards: int,
                     reduce_dtype: torch.dtype = torch.bfloat16,
                     shard_state: bool = False, shard_params: bool = False,
                     tp: int = 1) -> dict:
    """Static per-shard peak bytes of one data-parallel step from tensors of
    any device (``meta`` too); nothing allocates.

    Model: parameters are replicated, gradients exist once at fp32 plus once
    at ``reduce_dtype`` (the all-reduce's buffer), and the batch is split
    1/N over the data axis.  The optimizer state is replicated; with
    ``shard_state=True`` the family-stacked low-rank leaves are charged 1/N
    (:func:`repro_torch.sharding.family_state_bytes`, the rule the runtime
    splits by).  ``shard_params``: the parameters charged per shard by
    :func:`repro_torch.sharding.per_shard_bytes` over a data axis of N
    (``params_bytes_per_shard``), the rest as above.  ``tp`` (a model axis
    of that size, tensor parallelism): the parameters charged per shard by
    the rules over the model axis too (over it alone without
    ``shard_params``)."""
    from repro_torch.sharding import family_state_bytes, per_shard_bytes

    rd = torch.empty((), dtype=reduce_dtype).element_size()
    n = max(int(n_shards), 1)
    p_elems = sum(p.numel() for p in params.values() if p is not None)
    opt_total = reference_state_bytes(opt_state)
    proj_total = sum(reference_state_bytes(lr) for lr in find_lowrank_states(opt_state))
    fam_total, fam_per_shard = family_state_bytes(opt_state, n)
    saved = (fam_total - fam_per_shard) if shard_state else 0
    out = {
        "n_shards": n,
        "shard_state": bool(shard_state),
        "params_bytes": reference_state_bytes(params),
        "opt_state_bytes": opt_total,
        "opt_state_bytes_per_shard": opt_total - saved,
        "proj_state_bytes": proj_total,
        "proj_state_bytes_per_shard": proj_total - saved,
        "grad_bytes_fp32": p_elems * 4,
        "grad_wire_bytes": p_elems * rd,
        "batch_bytes_per_shard": -(-reference_state_bytes(batch) // n),
    }
    params_held = out["params_bytes"]
    if shard_params or tp > 1:
        from repro_torch.launch.mesh import Mesh

        mesh = Mesh((n, int(tp)), ("data", "model"))
        axes = ("data", "model") if shard_params else ("model",)
        params_held = out["params_bytes_per_shard"] = per_shard_bytes(params, mesh, axes)
    out["peak_bytes_per_shard"] = (
        params_held + out["opt_state_bytes_per_shard"]
        + out["grad_bytes_fp32"] + out["grad_wire_bytes"]
        + out["batch_bytes_per_shard"]
    )
    return out
