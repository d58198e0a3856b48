"""Collective-schedule auditor for the data-parallel train step (RA6xx), the
port of the JAX package's ``analysis/collectives.py``.

The data-parallel step (:mod:`repro_torch.launch.shardmap_fsdp`) keeps
wire-level invariants that rot without a check: the gradients are reduced
exactly once a step, at the *declared* ``reduce_dtype``, and nothing
gathers a full gradient in the steady state.  This pass checks them the way
:mod:`repro_torch.analysis.launch_model` checks kernel-launch counts:

  * :func:`trace_sharded_step` runs two steps of the step (a refresh, then a
    steady one) as rank 0 of a ``fake`` process group of N ranks
    (``torch.distributed``'s backend whose collectives move no data), so no
    other rank and no second device is needed to audit an N-way mesh.  The
    port's own collective record (:mod:`repro_torch.kernels.collective_count`)
    logs every collective with its tag, dtype, shape and bytes;
    :func:`collect_collectives` turns the logs into
    :class:`CollectiveRecord`\\ s, marking those the refresh step adds as
    boundary-only (``under_cond``, the reference's collectives under a
    refresh ``cond``).
  * :func:`expected_collective_schedule` derives the port's closed-form
    schedule from the parameter tree, the optimizer's ``chain_info`` ×
    :class:`~repro_torch.core.family_plan.FamilyPlan` and the shard count:
    every step one gradient all-reduce at ``reduce_dtype`` over every leaf
    (one concatenated buffer) and one fp32 loss all-reduce; with
    ``shard_state`` one fp32 all-gather a step of the split families'
    update rows (and the slots a split family's ranks cannot place); at a
    refresh no gather, and one probe all-reduce when the spectrum probes
    are on and a family splits; on split parameters (``shard_params``,
    :func:`param_split_schedule`) a layer's all-gather per layer read and
    fp32 reduce-scatter per layer, the once leaves' pair, the whole
    leaves' fp32 all-reduce and one fp32 all-gather of the gradient parts.  The reference gathers at refresh
    boundaries instead (its ``boundary_gather``); the fields the two share
    are ``grad_psum`` and ``loss_psum``.
  * :func:`collective_schedule_findings` diffs traced against expected:
    RA601 (gradient reduction wider than the declared dtype), RA602
    (boundary-only collective running every step), RA603 (full-gradient
    gather in the steady state) and RA606 (schedule divergence).  The
    reference's second RA601 case, a bf16 psum not pinned by an
    ``optimization_barrier`` (which XLA may re-promote), has no eager
    counterpart: the port casts before it reduces and no compiler moves
    the cast.
  * :func:`wire_bytes_model` is the per-step wire-bytes accountant, with
    the reference's ring coefficients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, NamedTuple

import torch

from repro_torch.core.api import Transform
from repro_torch.core.lowrank_common import family_shape, lowrank_state_shape, stack_shardable
from repro_torch.kernels import collective_count, launch_count

from .buffers import param_versions, param_writes
from .findings import Finding
from .launch_model import _core, _inner_coeffs, lowrank_nodes, lowrank_plan_stats, lowrank_views
from .trace_passes import realloc_bytes

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective of a traced step."""

    primitive: str                       # all_reduce / all_gather
    tag: str                             # grad / loss / update / probes / ...
    axes: tuple[str, ...]                # mesh axes it runs over
    dtypes: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]  # the operand this rank sends
    n_operands: int
    payload_bytes: int                   # bytes this rank sends
    under_cond: bool                     # run at a refresh only

    @property
    def scalar_only(self) -> bool:
        return all(len(s) == 0 or s == (1,) for s in self.shapes)


def collect_collectives(log: list[dict]) -> list[CollectiveRecord]:
    """:class:`CollectiveRecord`\\ s of a :func:`record_collectives` log
    (every step; :func:`boundary_only` marks a refresh's extras), each over
    the mesh axis its entry names."""
    return [CollectiveRecord(primitive=e["op"], tag=e["tag"], axes=(e.get("axis", "data"),),
                             dtypes=(e["dtype"],), shapes=(tuple(e["shape"]),),
                             n_operands=1, payload_bytes=int(e["bytes"]),
                             under_cond=False) for e in log]


def _key(r: CollectiveRecord) -> tuple:
    return (r.primitive, r.tag, r.dtypes, r.shapes)


def boundary_only(refresh: list[CollectiveRecord],
                  steady: list[CollectiveRecord]) -> list[CollectiveRecord]:
    """The collectives the refresh step runs beyond the steady step's, as
    boundary-only records."""
    left = [_key(r) for r in steady]
    out = []
    for r in refresh:
        if _key(r) in left:
            left.remove(_key(r))
        else:
            out.append(dataclasses.replace(r, under_cond=True))
    return out


# ---------------------------------------------------------------------------
# closed-form schedule model
# ---------------------------------------------------------------------------


def _update_gather(transform: Transform | dict, params: dict, n: int,
                   step: int) -> tuple[int, int, int]:
    """``(split families, gathered bytes, probe all-reduce bytes)`` of the
    fused lowrank nodes under ``n``-way state sharding at update ``step``:
    the rules of ``lowrank``'s fused update, of ``layerwise_unbias`` and of
    ``with_fira_residual`` under ``family_sharding``.  A split family sends
    its update rows, ``m·n`` values a block; under ``fused_epilogue`` (an
    inner that returns a projected update) its projector rows and projected
    update rows instead, ``r·(m + n)``; Fira adds its norm memory's rows,
    one value a block."""
    split = nbytes = probe = 0
    for _, node, plan in lowrank_nodes(transform, params):
        if not node.get("fuse_families"):
            continue
        inner = node.get("inner", {})
        core = _core(inner) or {}
        gamma = int(core.get("gamma", 0)) if core.get("kind") == "layerwise_unbias" else 0
        fira = core.get("kind") == "with_fira_residual"
        epilogue = bool(node.get("fused_epilogue")) and _inner_coeffs(inner, "", [])[1]
        tele = bool(node.get("telemetry"))
        probes = tele or bool(node.get("probe_spectrum"))
        for fi, fam in enumerate(plan.families):
            L, m, nn, r = fam.fs.L, fam.fs.m, fam.fs.n, fam.fs.rank
            rows_split = n > 1 and stack_shardable(L, n)
            if rows_split:
                split += 1
                nbytes += L // n * (r * (m + nn) if epilogue else m * nn) * 4
                if fira:
                    nbytes += L // n * 4
                if probes:  # the eigenvalue sums, and the drift's overlap
                    probe += (fam.fs.rank + tele) * 4
                if tele and (step - 1) % len(plan.families) == fi:
                    nbytes += 4  # the bias site's sum over this rank's blocks
            if gamma:
                slots = fam.seg.members * min(gamma, fam.seg.member_L)
                aligned = rows_split and fam.seg.members % n == 0
                if n > 1 and stack_shardable(slots, n) and not aligned:
                    nbytes += slots // n * m * nn * 4
    return split, nbytes, probe


def accum_payload(transform: Transform | dict, params: dict) -> tuple[int, int, int]:
    """``(compact values, compact tensors, refresh bytes)`` of the
    projected-space accumulator (``gum_accum_tools``) over ``params``: a
    low-rank leaf contributes ``Pᵀ G`` (``r·n`` or ``m·r`` a block) and,
    with ``gamma``, its sampled blocks' ``m·n`` each; any other leaf its
    whole gradient.  The refresh bytes are the low-rank leaves' raw
    gradients at their common dtype (rank 0's broadcast)."""
    values = tensors = 0
    low: dict[str, torch.Tensor] = {}
    for _, node, view in lowrank_views(transform, params):
        core = _core(node.get("inner", {})) or {}
        gamma = int(core.get("gamma", 0)) if core.get("kind") == "layerwise_unbias" else 0
        for k, p in view.items():
            if p is None:
                continue
            low[k] = p
            fs = family_shape(p, node.get("rank"))
            g_f = min(gamma, fs.L)
            values += math.prod(lowrank_state_shape(fs)) + g_f * fs.m * fs.n
            tensors += 1 + (g_f > 0)
    for k, p in params.items():
        if p is not None and k not in low:
            values += p.numel()
            tensors += 1
    dtypes = [p.dtype for p in low.values()]
    dtype = dtypes[0] if dtypes else torch.float32
    for d in dtypes:
        dtype = torch.promote_types(dtype, d)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return values, tensors, sum(p.numel() for p in low.values()) * itemsize


def param_split_schedule(split, *, remat: bool = False, microbatches: int = 1) -> dict:
    """The collectives a step of split parameters (``shard_params``, a
    :class:`repro_torch.sharding.ParamSplit`) adds, per step on one rank:
    each layer read gathers that layer's parts of every layer leaf in ONE
    all-gather at their dtype (``param_gather``: the layers a forward reads,
    once more under remat for the recomputation, every microbatch), whose
    backward reduce-scatters the layer's whole fp32 gradient once
    (``grad_scatter``); the once leaves' parts gather once a forward
    (``param_gather_once``) and their fp32 gradients reduce-scatter once
    (``grad_scatter_once``); the whole leaves' fp32 gradients are summed in
    one all-reduce (``grad_psum``, no split leaf in it) and the reduced fp32
    parts gathered whole in one all-gather (``grad_gather``).  The layers a
    forward reads: the layer leaves grouped by their stack dims' shape, each
    group read once per index (the dense stack's L layers; maverick's G·per
    dense blocks and G MoE blocks)."""
    def nbytes(shape, dtype) -> int:
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    groups: dict[tuple, list[str]] = {}
    for k in split.shapes:
        if k in split.layer:
            groups.setdefault(split.shapes[k][:split.stack[k]], []).append(k)
    reads = sum(math.prod(lead) for lead in groups)
    passes = (2 if remat else 1) * int(microbatches)
    gather = scatter = 0
    dtypes = set()
    for lead, paths in groups.items():
        layers = math.prod(lead)
        dtype = split.dtypes[paths[0]]
        for k in paths[1:]:
            dtype = torch.promote_types(dtype, split.dtypes[k])
        dtypes.add(str(dtype).removeprefix("torch."))
        gather += layers * sum(nbytes(split.part_shape(k)[split.stack[k]:], dtype)
                               for k in paths)
        scatter += layers * sum(nbytes(split.model_part_shape(k)[split.stack[k]:],
                                       torch.float32) for k in paths)
    once_dtype = None
    for k in split.once:
        once_dtype = split.dtypes[k] if once_dtype is None else torch.promote_types(
            once_dtype, split.dtypes[k])
    whole = [k for k in split.shapes if k not in split.data_rules]
    mb = int(microbatches)
    return {
        "param_gather": {"count": reads * passes, "dtype": "/".join(sorted(dtypes)),
                         "layers": reads, "payload_bytes": gather * passes},
        "param_gather_once": {"count": mb if split.once else 0,
                              "dtype": str(once_dtype).removeprefix("torch."),
                              "payload_bytes": mb * sum(nbytes(split.part_shape(k), once_dtype)
                                                        for k in split.once)},
        "grad_scatter": {"count": reads * mb, "dtype": "float32",
                         "payload_bytes": scatter * mb},
        "grad_scatter_once": {"count": mb if split.once else 0, "dtype": "float32",
                              "payload_bytes": mb * sum(nbytes(split.model_part_shape(k),
                                                               torch.float32)
                                                        for k in split.once)},
        "grad_psum": {"count": int(bool(whole)), "dtype": "float32", "operands": len(whole),
                      "payload_bytes": sum(nbytes(split.model_part_shape(k), torch.float32)
                                           for k in whole)},
        "grad_gather": {"count": int(bool(split.data_rules)), "dtype": "float32",
                        "payload_bytes": sum(nbytes(split.part_shape(k), torch.float32)
                                             for k in split.data_rules)},
    }


def tensor_parallel_schedule(split, cfg, rows: int, seq: int, *, microbatches: int = 1) -> dict:
    """The collectives over the ``model`` axis that a tensor-parallel step
    (a :class:`repro_torch.sharding.ParamSplit` with ``tp > 1``, the model's
    config ``cfg``) adds, per step on one rank that trains ``rows`` rows of
    ``seq`` tokens in ``microbatches`` equal slices.  Each forward of a
    layer sums its attention's and its MLP's row-parallel products in two
    fp32 all-reduces of a ``(rows, seq, d)`` activation (``tp_fwd``), the
    embedding in one more; remat's recomputation of a layer runs its
    forward only as far as the last tensor its backward reads, so it sums
    the attention's products again but not the MLP's, whose sum is the
    layer's output; each backward of
    a layer sums the gradients at the entries of its two column-parallel
    regions (``tp_bwd``), the head's input in one more; the vocab-parallel
    loss reduces each row's max, sum of exponentials and target logit
    (``tp_loss``: three fp32 all-reduces of the ``rows · (seq - 1)`` shifted
    rows, a chunk's rows each under ``logit_chunk``); where the kv heads do
    not divide over the axis and a rule splits ``wk`` and ``wv``, each
    layer read gathers each of them whole (``tp_kv_gather``) and its
    backward reduce-scatters its fp32 gradient (``tp_kv_scatter``).  After
    the backward: one fp32 all-reduce of the gradients of the leaves a rank
    reads in slices (``tp_grad_psum``) and ONE fp32 all-gather of every
    model-split gradient part (``tp_grad_gather``)."""
    from repro_torch.models import tensor_parallel

    def nbytes(shape, dtype=torch.float32) -> int:
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    mb, L, T = int(microbatches), int(cfg.n_layers), split.tp
    r = int(rows) // mb
    passes = 2 if cfg.remat else 1
    fwd = (2 + int(bool(cfg.remat))) * L + 1
    act = r * int(seq) * int(cfg.d_model) * 4
    chunk = int(cfg.logit_chunk)
    if chunk > 0:
        loss_calls, loss_bytes = -(-(int(seq) - 1) // chunk), r * chunk * 4
    else:
        loss_calls, loss_bytes = 1, r * (int(seq) - 1) * 4
    kv = [k for k in ("blocks/attn/wk", "blocks/attn/wv") if k in split.model_rules]
    kv_gathered = cfg.kv_heads % T != 0 and kv
    kv_dtype = str(split.dtypes[kv[0]]).removeprefix("torch.") if kv else "float32"
    summed = sorted(tensor_parallel.summed_paths(split))
    parts = [k for k in split.shapes if k in split.model_rules]
    entry = {"dtype": "float32", "axis": "model", "phase": "steady"}
    return {
        "tp_fwd": entry | {"count": mb * fwd, "payload_bytes": mb * fwd * act},
        "tp_bwd": entry | {"count": mb * (2 * L + 1), "payload_bytes": mb * (2 * L + 1) * act},
        "tp_loss": entry | {"count": mb * 3 * loss_calls,
                            "payload_bytes": mb * 3 * loss_calls * loss_bytes},
        "tp_kv_gather": entry | {
            "count": mb * passes * L * len(kv) if kv_gathered else 0, "dtype": kv_dtype,
            "payload_bytes": mb * passes * sum(nbytes(split.model_part_shape(k),
                                                      split.dtypes[k]) for k in kv)
            if kv_gathered else 0},
        "tp_kv_scatter": entry | {
            "count": mb * L * len(kv) if kv_gathered else 0,
            "payload_bytes": mb * sum(nbytes(split.shapes[k]) for k in kv)
            if kv_gathered else 0},
        "tp_grad_psum": entry | {"count": int(bool(summed)), "operands": len(summed),
                                 "payload_bytes": sum(nbytes(split.shapes[k]) for k in summed)},
        "tp_grad_gather": entry | {"count": int(bool(parts)), "operands": len(parts),
                                   "payload_bytes": sum(nbytes(split.model_part_shape(k))
                                                        for k in parts)},
    }


# The tensor-parallel schedule's entries: (primitive, tag) of their records.
TP_OPS = {"tp_fwd": ("all_reduce", "tp_fwd"), "tp_bwd": ("all_reduce", "tp_bwd"),
          "tp_loss": ("all_reduce", "tp_loss"), "tp_kv_gather": ("all_gather", "tp_kv"),
          "tp_kv_scatter": ("reduce_scatter", "tp_kv"),
          "tp_grad_psum": ("all_reduce", "tp_grad"),
          "tp_grad_gather": ("all_gather", "tp_grad")}


def expected_collective_schedule(
    transform: Transform | dict,
    params: dict,
    *,
    n_shards: int,
    reduce_dtype: torch.dtype = torch.bfloat16,
    data_axis: str = "data",
    shard_state: bool = False,
    step: int = 2,
    lowrank_accum: bool = False,
    param_split=None,
    remat: bool = False,
    microbatches: int = 1,
    tensor_parallel: dict | None = None,
) -> dict:
    """The collective schedule the data-parallel step must show at update
    ``step`` (steady unless it is a refresh), derived from the parameter
    tree, the optimizer's composition and family plan, and the shard count.

    Every step: ONE gradient all-reduce at ``reduce_dtype`` carrying every
    parameter leaf (``operands``) in one buffer, and ONE fp32 loss
    all-reduce.  ``shard_state``: one fp32 all-gather a step of the split
    families' update rows, the slots ``layerwise_unbias`` cannot place on a
    rank's rows, and (telemetry) the bias site's 4 bytes.  At a refresh: no
    gather; one probe all-reduce of the split families' eigenvalue sums
    (and drift overlaps) when probes are on.  ``boundary_gather`` is the
    reference's refresh-boundary gather, which the port does not issue.

    ``lowrank_accum`` (the projected-space accumulator, ``transform`` its
    ``tools.transform``): the gradient all-reduce carries the compact
    accumulator (:func:`accum_payload`) in place of the gradients, and a
    refresh adds ONE broadcast of rank 0's raw low-rank gradients
    (``refresh_broadcast``).

    ``param_split`` (split parameters, a
    :class:`repro_torch.sharding.ParamSplit` of ``params``' model, with the
    model's ``remat`` and the step's ``microbatches``): the gradient
    all-reduce carries the whole leaves only, in fp32, and the entries of
    :func:`param_split_schedule` join the schedule.

    ``tensor_parallel`` (``{"cfg", "rows", "seq"}``: the model's config and
    a rank's rows and sequence length a step, with ``param_split`` a split
    over a model axis): the entries of :func:`tensor_parallel_schedule`
    join it, and ``n_shards`` is the data axis's size."""
    itemsize = torch.empty((), dtype=reduce_dtype).element_size()
    leaves = [p for p in params.values() if p is not None]
    grad_values, operands, refresh_bytes = sum(p.numel() for p in leaves), len(leaves), 0
    if lowrank_accum:
        grad_values, operands, refresh_bytes = accum_payload(transform, params)
    n_families = sum(int(r.get("n_families", 0)) for r in lowrank_plan_stats(transform, params))
    split = gather = probe = 0
    if shard_state:
        split, gather, probe = _update_gather(transform, params, int(n_shards), step)
    dtype = str(reduce_dtype).removeprefix("torch.")
    params_sched = {}
    if param_split is not None:
        params_sched = param_split_schedule(param_split, remat=remat,
                                            microbatches=microbatches)
        for entry in params_sched.values():
            entry.update(axis=data_axis, phase="steady")
        if tensor_parallel is not None:
            params_sched |= tensor_parallel_schedule(
                param_split, tensor_parallel["cfg"], tensor_parallel["rows"],
                tensor_parallel["seq"], microbatches=microbatches)
    return params_sched | {
        "grad_psum": params_sched.get("grad_psum") or {
            "count": 1, "dtype": dtype, "operands": operands,
            "payload_bytes": int(grad_values * itemsize), "axis": data_axis,
            "phase": "steady"},
        "loss_psum": {"count": 1, "dtype": "float32", "operands": 1, "payload_bytes": 4,
                      "axis": data_axis, "phase": "steady"},
        "update_gather": {"count": int(gather > 0), "dtype": "float32",
                          "families": split, "payload_bytes": int(gather),
                          "axis": data_axis, "phase": "steady"},
        "probe_reduce": {"count": int(probe > 0), "dtype": "float32",
                         "payload_bytes": int(probe), "axis": data_axis,
                         "phase": "boundary"},
        "boundary_gather": {"count": 0, "families": int(n_families), "payload_bytes": 0,
                            "phase": "boundary"},
        "refresh_broadcast": {"count": int(lowrank_accum), "payload_bytes": int(refresh_bytes),
                              "axis": data_axis, "phase": "boundary"},
        "n_shards": int(n_shards),
        "shard_state": bool(shard_state),
        "shard_params": param_split is not None and bool(param_split.data_rules),
        "tensor_parallel": tensor_parallel is not None,
    }


# ---------------------------------------------------------------------------
# traced-vs-model findings (RA601/602/603/606)
# ---------------------------------------------------------------------------


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def collective_schedule_findings(
    records: Iterable[CollectiveRecord],
    expected: dict,
    *,
    reduce_dtype: torch.dtype = torch.bfloat16,
    params: dict | None = None,
    where: str = "sharded-step",
) -> list[Finding]:
    """Diff the traced collectives against the closed-form schedule."""
    records = list(records)
    rd = str(reduce_dtype).removeprefix("torch.")
    rd_size = _itemsize(rd)
    n = max(int(expected.get("n_shards", 1)), 1)
    out: list[Finding] = []

    steady = [r for r in records if not r.under_cond]
    boundary = [r for r in records if r.under_cond]
    grad_red = [r for r in steady if r.primitive == "all_reduce" and r.tag == "grad"]
    loss_red = [r for r in steady if r.primitive == "all_reduce" and r.tag == "loss"]
    updates = [r for r in steady if r.primitive == "all_gather" and r.tag == "update"]
    # split parameters (shard_params): schedule entry -> (primitive, tag)
    split_ops = {"param_gather": ("all_gather", "layer"),
                 "param_gather_once": ("all_gather", "once"),
                 "grad_scatter": ("reduce_scatter", "layer"),
                 "grad_scatter_once": ("reduce_scatter", "once"),
                 "grad_gather": ("all_gather", "grad")}
    split_recs = {}
    if expected.get("shard_params"):
        split_recs = {name: [r for r in steady if (r.primitive, r.tag) == op]
                      for name, op in split_ops.items()}
    if expected.get("tensor_parallel"):
        split_ops |= TP_OPS
        split_recs |= {name: [r for r in steady if (r.primitive, r.tag) == op]
                       for name, op in TP_OPS.items()}
    split_all = [r for rs in split_recs.values() for r in rs]
    others = [r for r in steady if r not in grad_red + loss_red + updates + split_all]

    param_sizes = set()
    if params is not None:
        param_sizes = {p.numel() for p in params.values() if p is not None}

    # RA601 — the gradient reduction runs at the declared reduce_dtype.
    for r in grad_red:
        wide = [dt for dt in r.dtypes if _itemsize(dt) > rd_size]
        if wide:
            out.append(Finding(
                code="RA601", where=where,
                message=f"gradient all-reduce carries {'/'.join(wide)} operands "
                        f"where reduce_dtype={rd} was declared — "
                        f"{_bytes(r.payload_bytes)} on the wire instead of "
                        f"{_bytes(r.payload_bytes * rd_size // _itemsize(wide[0]))}",
                hint="cast the gradients to the declared reduce_dtype before the "
                     "all-reduce (see launch/steps.reduce_gradients)",
                detail={"dtypes": list(r.dtypes), "declared": rd},
            ))

    # RA602/RA603 — nothing else runs every step.
    update_expected = expected.get("update_gather", {}).get("count", 0)
    for r in others + (updates if not update_expected else []):
        numel = r.payload_bytes // max(_itemsize(r.dtypes[0]), 1)
        full = r.primitive == "all_gather" and bool(
            param_sizes & {numel, numel * n})
        if full:
            out.append(Finding(
                code="RA603", where=where,
                message=f"steady-state {r.primitive} ({r.tag}) materializes a "
                        f"full-gradient/param-sized buffer ({_bytes(r.payload_bytes * n)}) "
                        "every step — gathers belong to the split families' rows only",
                hint="gather the update rows of the split families, compute the "
                     "rest replicated",
                detail={"shapes": [list(s) for s in r.shapes]},
            ))
        else:
            out.append(Finding(
                code="RA602", where=where,
                message=f"unconditional {r.primitive} ({r.tag}) over "
                        f"axes={list(r.axes)} in the steady-state step — the "
                        "schedule model has no such collective every step",
                hint="run it at the refresh only, or not at all",
                detail={"primitive": r.primitive, "tag": r.tag,
                        "payload_bytes": r.payload_bytes},
            ))

    # RA606 — counts and payloads match the closed-form model.
    exp_g = expected["grad_psum"]
    got = {"count": len(grad_red), "payload_bytes": sum(r.payload_bytes for r in grad_red)}
    want = {k: exp_g[k] for k in got}
    dtype_ok = all(not [dt for dt in r.dtypes if _itemsize(dt) > rd_size] for r in grad_red)
    if got["count"] != want["count"] or (dtype_ok and got["payload_bytes"]
                                         != want["payload_bytes"]):
        out.append(Finding(
            code="RA606", where=where,
            message="traced gradient-reduction schedule diverges from the "
                    f"closed-form model: traced {got}, expected {want}",
            hint="one all-reduce of every parameter leaf's gradient at "
                 "reduce_dtype is the contract; per-leaf reductions or dropped "
                 "leaves break it",
            detail={"traced": got, "expected": want},
        ))
    if len(loss_red) != expected["loss_psum"]["count"]:
        out.append(Finding(
            code="RA606", where=where,
            message=f"{len(loss_red)} loss reduction(s) traced, expected "
                    f"{expected['loss_psum']['count']} (the mean over the ranks)",
            detail={"traced": len(loss_red)},
        ))
    exp_u = expected.get("update_gather", {"count": 0, "payload_bytes": 0})
    got_u = {"count": len(updates), "payload_bytes": sum(r.payload_bytes for r in updates)}
    if exp_u["count"] and got_u != {k: exp_u[k] for k in got_u}:
        out.append(Finding(
            code="RA606", where=where,
            message=f"traced update all-gather {got_u} diverges from the "
                    f"closed-form model {dict(count=exp_u['count'], payload_bytes=exp_u['payload_bytes'])}",
            detail={"traced": got_u, "expected": exp_u},
        ))
    for name, recs in split_recs.items():
        exp = expected[name]
        got_s = {"count": len(recs), "payload_bytes": sum(r.payload_bytes for r in recs)}
        want_s = {k: exp[k] for k in got_s}
        dtypes = sorted({dt for r in recs for dt in r.dtypes})
        axes = {a for r in recs for a in r.axes}
        if got_s != want_s or (recs and "/".join(dtypes) != exp["dtype"]) or (
                recs and axes != {exp.get("axis", axes and next(iter(axes)))}):
            out.append(Finding(
                code="RA606", where=where,
                message=f"traced {'/'.join(split_ops[name])} {got_s} ({'/'.join(dtypes)} over "
                        f"{sorted(axes)}) diverges from the closed-form model {want_s} "
                        f"({exp['dtype']} over {exp.get('axis')}) of the split parameters",
                hint="one all-gather of a layer's parts per layer read, one fp32 "
                     "reduce-scatter of its gradient, the once leaves once a step",
                detail={"traced": got_s, "expected": want_s, "entry": name},
            ))
    exp_p = expected.get("probe_reduce", {"count": 0})
    n_probe = len([r for r in boundary if r.primitive == "all_reduce"])
    if n_probe != exp_p["count"]:
        out.append(Finding(
            code="RA606", where=where,
            message=f"{n_probe} refresh-only all-reduce(s) traced, expected "
                    f"{exp_p['count']} (the split families' probe sums)",
            detail={"traced": n_probe, "expected": exp_p["count"]},
        ))
    exp_r = expected.get("refresh_broadcast", {"count": 0, "payload_bytes": 0})
    got_r = [r for r in boundary if r.primitive == "broadcast"]
    got_r = {"count": len(got_r), "payload_bytes": sum(r.payload_bytes for r in got_r)}
    if got_r != {k: exp_r[k] for k in got_r}:
        out.append(Finding(
            code="RA606", where=where,
            message=f"refresh-only broadcast {got_r} diverges from the closed-form model "
                    f"{dict(count=exp_r['count'], payload_bytes=exp_r['payload_bytes'])} "
                    "(the accumulator's refresh sends rank 0's low-rank gradients once)",
            detail={"traced": got_r, "expected": exp_r},
        ))
    exp_b = expected.get("boundary_gather", {"count": 0})
    n_boundary = len([r for r in boundary if r.primitive == "all_gather"])
    if n_boundary != exp_b["count"]:
        out.append(Finding(
            code="RA606", where=where,
            message=f"{n_boundary} refresh-only gather(s) traced, expected "
                    f"{exp_b['count']} (a refresh gathers nothing on this path)",
            detail={"traced": n_boundary, "expected": exp_b["count"]},
        ))
    return out


# ---------------------------------------------------------------------------
# wire-bytes accountant
# ---------------------------------------------------------------------------

# Bytes each rank moves over the wire per payload byte, ring algorithms: the
# reference's coefficient table, under the port's collective names too.
_RING_COEFF = {
    "psum": lambda n: 2.0 * (n - 1) / n,
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0 if n > 1 else 0.0,
}


def wire_bytes_model(records: Iterable[CollectiveRecord], n_shards: int,
                     axis_sizes: dict | None = None) -> dict:
    """Per-step wire bytes each rank sends, from the traced collectives and
    ring coefficients.  ``steady_bytes_per_step`` counts the collectives of
    every step; ``boundary_bytes`` the refresh-only ones.  A record over an
    axis of ``axis_sizes`` (e.g. ``{"model": T}``) takes that axis's ring
    size, the others ``n_shards``."""
    n = max(int(n_shards), 1)
    sizes = axis_sizes or {}
    per: list[dict] = []
    steady = boundary = 0
    for r in records:
        coeff = _RING_COEFF.get(r.primitive)
        if coeff is None:
            continue
        ring = max(int(sizes.get(r.axes[0], n)), 1) if r.axes else n
        wire = int(r.payload_bytes * coeff(ring)) if ring > 1 else 0
        per.append({"primitive": r.primitive, "tag": r.tag,
                    "payload_bytes": r.payload_bytes, "wire_bytes": wire,
                    "phase": "boundary" if r.under_cond else "steady",
                    "dtypes": list(r.dtypes)})
        if r.under_cond:
            boundary += wire
        else:
            steady += wire
    return {"n_shards": n, "steady_bytes_per_step": steady, "boundary_bytes": boundary,
            "per_collective": per}


def _bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


# ---------------------------------------------------------------------------
# tracing the step on a fake process group
# ---------------------------------------------------------------------------


class ShardedTrace(NamedTuple):
    """What :func:`trace_sharded_step` saw."""

    records: list[CollectiveRecord]  # the steady step's, then the refresh's extras
    counts: dict[str, int]           # the steady step: dispatch ops + collectives
    refresh_counts: dict[str, int]   # the refresh step's dispatch ops
    params: dict                     # the model's parameters (updated twice)
    opt_state: PyTree                # init's whole layout
    batch: dict                      # the global batch
    rows: list[int]                  # the rows of each forward the steps ran
    param_writes: dict               # path -> (same storage, in-place writes)
    realloc_bytes: int               # the steady step's new optimizer state
    param_split: Any = None          # the ParamSplit under shard_params


def _trace_mesh_class():
    from repro_torch.launch.mesh import Mesh

    class TraceMesh(Mesh):
        """A mesh over the ``fake`` group, whose collectives move no data:
        an all-gather's result is this rank's operand in every rank's part
        (so the trace's values stay finite; they are not a real run's)."""

        def all_gather(self, t: torch.Tensor, tag: str, *, axis=None) -> torch.Tensor:
            out = super().all_gather(t, tag, axis=axis)
            out.view(self.shape[axis or self.data_axis], -1).copy_(t.reshape(1, -1))
            return out

        def reduce_scatter(self, t: torch.Tensor, tag: str, *, axis=None) -> torch.Tensor:
            out = super().reduce_scatter(t, tag, axis=axis)
            # this rank's chunk
            out.copy_(t.reshape(self.shape[axis or self.data_axis], -1)[0])
            return out

    return TraceMesh


def trace_sharded_step(model, optimizer: Transform, *, n_shards: int,
                       batch_size: int = 8, seq_len: int | None = None,
                       reduce_dtype: torch.dtype = torch.bfloat16, grad_clip: float = 1.0,
                       data_axis: str = "data", shard_state: bool = False,
                       shard_params: bool = False, seed: int = 0, tp: int = 1) -> ShardedTrace:
    """Run :func:`repro_torch.launch.shardmap_fsdp.make_shardmap_train_step`
    as rank 0 of a ``fake`` process group of ``n_shards`` ranks: two steps
    (a refresh, then a steady one) on ``model``'s device, with its
    parameters (updated in place) and a global batch of ``batch_size`` rows
    of seeded tokens.  The group is made here and destroyed before
    returning; a process that already holds a group is refused.
    ``shard_params`` splits ``model``'s parameters (they stay split: the
    returned ``params`` are rank 0's parts, ``step.param_split`` has the
    layout).  ``tp > 1`` traces the tensor-parallel step of a ``Trainer``
    instead (:func:`repro_torch.launch.steps.make_train_step` on a
    ``(n_shards, tp)`` mesh of axes ``(data_axis, "model")``, fp32 reduction,
    rank 0 taking its data coordinate's rows); the fake group then has
    ``n_shards · tp`` ranks, and the values of a forward whose partial sums
    are never summed are not a real run's either."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.shardmap_fsdp import make_shardmap_train_step
    from repro_torch.core.combinators import shard_family_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import ParamSplit

    if dist.is_initialized():
        raise RuntimeError("trace_sharded_step makes its own fake process group; this "
                           "process already holds one (trace in a fresh process)")
    if batch_size % int(n_shards):
        raise ValueError(f"batch_size={batch_size} not divisible by n_shards={n_shards}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n_shards) * int(tp))
    try:
        if tp > 1:
            mesh = _trace_mesh_class()((int(n_shards), int(tp)), (data_axis, "model"),
                                       group=dist.group.WORLD, backend="fake",
                                       data_axis=data_axis)
            split = ParamSplit(model, mesh, data=shard_params)
            split.split_params()
            inner = make_train_step(model, optimizer, grad_clip=grad_clip, mesh=mesh,
                                    shard_state=shard_state, param_split=split)

            def step(params, opt_state, batch):
                per = next(iter(batch.values())).shape[0] // int(n_shards)
                return inner(params, opt_state, {k: v[:per] for k, v in batch.items()})

            step.param_split = split
            step.init_state = lambda opt: split.init_state(opt, next(
                iter(model.params().values())).device)
            step.place_state = ((lambda st: shard_family_state(st, mesh)) if shard_state
                                else (lambda st: st))
        else:
            mesh = _trace_mesh_class()((int(n_shards),), (data_axis,), group=dist.group.WORLD,
                                       backend="fake", data_axis=data_axis)
            step = make_shardmap_train_step(model, optimizer, mesh, grad_clip=grad_clip,
                                            reduce_dtype=reduce_dtype, shard_state=shard_state,
                                            shard_params=shard_params)
        params = model.params()
        device = next(iter(params.values())).device
        seq = int(seq_len if seq_len is not None else min(64, model.cfg.max_seq))
        gen = torch.Generator().manual_seed(seed)
        batch = {"tokens": torch.randint(0, model.cfg.vocab, (int(batch_size), seq),
                                         generator=gen, dtype=torch.int32).to(device)}
        with torch.no_grad(), launch_count.count_launches(isolated=True):
            whole = step.init_state(optimizer)
        opt_state = step.place_state(whole)
        rows: list[int] = []

        def seen(module, args, kwargs):
            x = args[0] if args and isinstance(args[0], torch.Tensor) else kwargs.get("frames")
            if isinstance(x, torch.Tensor):
                rows.append(int(x.shape[0]))

        hook = model.register_forward_pre_hook(seen, with_kwargs=True)
        try:
            logs, counts = [], []
            for i in range(2):
                if i == 1:
                    before, state_before = param_versions(params), opt_state
                with collective_count.record_collectives(isolated=True) as log, \
                        launch_count.count_launches(isolated=True) as dispatched:
                    opt_state, _ = step(params, opt_state, batch)
                logs.append(log)
                counts.append(dict(dispatched))
        finally:
            hook.remove()
        writes = param_writes(params, before)
        realloc = realloc_bytes(state_before, opt_state)
    finally:
        dist.destroy_process_group()
    steady = collect_collectives(logs[1])
    refresh = collect_collectives(logs[0])
    records = steady + boundary_only(refresh, steady)
    steady_counts = dict(counts[1])
    for r in steady:
        steady_counts[r.primitive] = steady_counts.get(r.primitive, 0) + 1
    return ShardedTrace(records=records, counts=steady_counts, refresh_counts=counts[0],
                        params=params, opt_state=whole, batch=batch, rows=rows,
                        param_writes=writes, realloc_bytes=realloc, param_split=step.param_split)

