"""repro_torch.analysis — the static audit of the optimizer step (the port of
the JAX package's ``analysis``).

The paper's promise — unbiased low-rank updates at GaLore-class memory cost
— holds only if the implementation keeps its invariants: the update stays
in fp32, the fused engine launches once per shape family, the projected
state is the Table-1 size and a data-parallel step reduces its gradients
once.  This package checks them on the program before a real step runs:

  * :mod:`~repro_torch.analysis.chain_lint` — combinator-composition rules
    on the static ``chain_info`` metadata (``RC1xx``).
  * :mod:`~repro_torch.analysis.launch_model` — the closed-form expected
    dispatch counts from the composition and the
    :class:`~repro_torch.core.family_plan.FamilyPlan`, held against the
    counts of a traced update (``RA3xx``).
  * :mod:`~repro_torch.analysis.trace_passes` — the counterpart of the
    reference's jaxpr passes: one update on ``meta`` tensors under a
    dispatch mode that records every aten op (nothing computes); the
    dtype-flow audit (``RA2xx``), the op-sequence signature across a rank
    ladder (``RA401``) and the static memory accountant (``RA5xx``).
  * :mod:`~repro_torch.analysis.collectives` — the collective schedule of
    the data-parallel step, two steps run as rank 0 of a ``fake`` process
    group (no second device), against the port's closed form
    (``RA601/602/603/606``), with a ring-coefficient wire-bytes model.
  * :mod:`~repro_torch.analysis.buffers` — the step writes the parameters in
    place (``RA604``'s counterpart of the reference's donation check), each
    rank sees its share of the batch (``RA605``), and the static per-shard
    memory model.
  * :mod:`~repro_torch.analysis.audit` — the orchestrator and CLI::

        PYTHONPATH=src python -m repro_torch.analysis.audit --optimizer gum \\
            --fuse-families --fused-epilogue --rank-ladder 16,32,64
        PYTHONPATH=src python -m repro_torch.analysis.audit --matrix
        PYTHONPATH=src python -m repro_torch.analysis.audit --sharded --mesh data=8

Wired into ``build_optimizer(..., audit=True)`` (chain lint at build time),
``launch/train.py --audit`` (the full audit, with the sharded passes under
``--mesh``, before step 0) and the ``Trainer`` startup log (one ``audit``
line: launches/step, state bytes, signature; with telemetry the
``launch_crosscheck`` event; on a mesh the in-place / batch-rows check of
the first step).

What has no counterpart: ``RA402`` (a weak-typed 0-d jaxpr constant: eager
PyTorch has no weak types and compiles nothing), the barrier-pin case of
``RA601`` (no compiler re-promotes the cast), and ``parse_main_args`` /
``ArgInfo`` (StableHLO text; the port's RA604 reads the step's parameters
instead).
"""
from .buffers import (
    inplace_findings,
    param_versions,
    param_writes,
    per_shard_memory,
    replication_findings,
)
from .chain_lint import ChainLintError, lint_chain
from .collectives import (
    CollectiveRecord,
    ShardedTrace,
    collect_collectives,
    collective_schedule_findings,
    expected_collective_schedule,
    trace_sharded_step,
    wire_bytes_model,
)
from .findings import CODES, AuditReport, Finding
from .launch_model import expected_launches, lowrank_plan_stats
from .trace_passes import (
    UpdateTrace,
    dtype_flow_findings,
    memory_crosscheck,
    projected_state_bytes,
    realloc_bytes,
    recompile_findings,
    reference_state_bytes,
    signature_hash,
    trace_update,
)

_AUDIT = ("audit_optimizer", "audit_sharded", "audit_summary", "run_matrix")


def __getattr__(name: str):
    # The orchestrator loads on first use, so ``python -m
    # repro_torch.analysis.audit`` does not find it imported already.
    if name in _AUDIT:
        from . import audit

        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AuditReport", "CODES", "ChainLintError", "CollectiveRecord", "Finding",
    "ShardedTrace", "UpdateTrace",
    "audit_optimizer", "audit_sharded", "audit_summary",
    "collect_collectives", "collective_schedule_findings",
    "dtype_flow_findings", "expected_collective_schedule", "expected_launches",
    "inplace_findings", "lint_chain", "lowrank_plan_stats", "memory_crosscheck",
    "param_versions", "param_writes",
    "per_shard_memory", "projected_state_bytes", "realloc_bytes",
    "recompile_findings", "reference_state_bytes", "replication_findings",
    "run_matrix", "signature_hash", "trace_sharded_step", "trace_update",
    "wire_bytes_model",
]
