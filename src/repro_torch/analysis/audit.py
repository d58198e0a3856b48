"""Audit orchestrator and CLI: every analyzer over a built optimizer (the
port of the JAX package's ``analysis/audit.py``).

One audit cell = one ``OptimizerConfig``: chain lint, the closed-form launch
model against the dispatch counts of a traced update, the dtype-flow pass,
the signature pass across the rank ladder and the static memory accountant,
all on ``meta`` tensors (:mod:`repro_torch.analysis.trace_passes`): nothing
computes.  A config whose ``kernel_impl`` is ``"cuda"`` is traced at
``"auto"`` (a ``meta`` tensor takes the plain route; the dispatch counts are
the same).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.audit --optimizer gum \\
        --fuse-families --fused-epilogue --rank-ladder 8,16
    PYTHONPATH=src python -m repro_torch.analysis.audit --matrix --json
    PYTHONPATH=src python -m repro_torch.analysis.audit --optimizer gum \\
        --check-memory          # cross-check results/BENCH_rank_policy.json
    PYTHONPATH=src python -m repro_torch.analysis.audit --sharded --mesh data=8
                                # collective schedule + in-place step on a
                                # fake process group (no second device)

Exit status 1 iff an error-severity finding survives.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.core.api import OptimizerConfig, Transform, sort_paths
from repro_torch.core.combinators import find_lowrank_states
from repro_torch.core.factory import build_optimizer
from repro_torch.core.rank_policy import RankMap
from repro_torch.kernels import launch_count

from .buffers import inplace_findings, per_shard_memory, replication_findings
from .chain_lint import lint_chain
from .collectives import (
    collective_schedule_findings,
    expected_collective_schedule,
    trace_sharded_step,
    wire_bytes_model,
)
from .findings import AuditReport, Finding
from .launch_model import expected_launches, lowrank_plan_stats
from .trace_passes import (
    dtype_flow_findings,
    memory_crosscheck,
    recompile_findings,
    reference_state_bytes,
    signature_hash,
    steady_realloc_bytes,
    trace_update,
)

# Factory optimizers that route matrices through lowrank() — audited across
# the full fuse_families x fused_epilogue grid — vs. full-rank baselines
# (one cell each; the fuse knobs are no-ops for them).
LOWRANK_OPTIMIZERS = ("gum", "galore", "galore_muon", "golore", "fira",
                      "unbiased_galore_adam")
FULLRANK_OPTIMIZERS = ("muon", "adamw", "sgdm", "lisa")


def default_params(dtype: torch.dtype = torch.float32) -> dict:
    """The audit's reference tree: three hidden-matrix shape families
    (4x 64x64, 2x 64x128, 2x 128x64) plus an embedding and a norm vector so
    the matrix/fallback routing is exercised.  ``meta`` tensors, in the
    reference's leaf order."""
    shapes = {
        "layers/0/attn/wq": (64, 64), "layers/0/attn/wo": (64, 64),
        "layers/1/attn/wq": (64, 64), "layers/1/attn/wo": (64, 64),
        "layers/0/mlp/up": (64, 128), "layers/1/mlp/up": (64, 128),
        "layers/0/mlp/down": (128, 64), "layers/1/mlp/down": (128, 64),
        "embed/table": (256, 64),
        "norm/scale": (64,),
    }
    return {k: torch.empty(shapes[k], dtype=dtype, device="meta") for k in sort_paths(shapes)}


def arch_config(arch: str):
    """The model config of a registered name (``name-smoke`` selects the
    tiny variant)."""
    from repro_torch.configs import get_config, get_smoke

    if arch.endswith("-smoke"):
        return get_smoke(arch[: -len("-smoke")])
    return get_config(arch)


def arch_model(arch: str, device: str | torch.device = "meta"):
    """The built model of a registered name; on ``meta`` nothing
    allocates."""
    from repro_torch.models import build_model

    return build_model(arch_config(arch), device=device)


def arch_params(arch: str) -> dict:
    """The parameter tree of a registered model config on ``meta``."""
    return arch_model(arch).params()


def _cell_name(cfg: OptimizerConfig) -> str:
    bits = [cfg.name]
    if cfg.fuse_families:
        bits.append("fused")
    if cfg.fused_epilogue:
        bits.append("epilogue")
    return "+".join(bits)


def _traceable(cfg: OptimizerConfig) -> OptimizerConfig:
    return dataclasses.replace(cfg, kernel_impl="auto") if cfg.kernel_impl == "cuda" else cfg


def launch_findings(expected: dict, traced: dict, *, fused_epilogue: bool,
                    where: str = "") -> list[Finding]:
    """Classify an expected-vs-traced launch-count diff into findings.

    Back-projection diffs under ``fused_epilogue=True`` are RA302 (the
    epilogue failed to fold — stray unfused back_projects); every other
    diff is RA301 (the one-launch-set-per-family contract broke, or the
    model's coefficient table is stale)."""
    if traced == expected:
        return []
    stray, other = [], []
    for op in sorted(set(traced) | set(expected)):
        e, a = expected.get(op, 0), traced.get(op, 0)
        if e != a:
            line = f"{op}: expected {e}, traced {a}"
            (stray if fused_epilogue and op.startswith("back_project")
             else other).append(line)
    out = []
    if stray:
        out.append(Finding(
            code="RA302", where=where,
            message="fused_epilogue=True left unfused back-projection "
                    "launches: " + "; ".join(stray),
            hint="the chain tail is not folding into "
                 "back_project_epilogue — check that scale_by_lr is "
                 "terminal and the inner emits a projected update",
            detail={"expected": expected, "traced": traced},
        ))
    if other:
        out.append(Finding(
            code="RA301", where=where,
            message="traced launch counts diverge from the closed-form "
                    "FamilyPlan expectation: " + "; ".join(other),
            hint="either the fused engine regressed (launches per leaf "
                 "instead of per family) or the launch model's "
                 "coefficient table is stale",
            detail={"expected": expected, "traced": traced},
        ))
    return out


def _proj_bytes(state) -> int:
    return sum(reference_state_bytes(lr) for lr in find_lowrank_states(state))


def audit_optimizer(
    cfg: OptimizerConfig,
    params: dict | None = None,
    *,
    ladder=None,
    check_memory: bool = False,
) -> AuditReport:
    """Run every analyzer over ``build_optimizer(cfg)`` on ``meta`` copies of
    ``params`` (default :func:`default_params`); nothing computes.

    The launch counts are those of the first update (a refresh: see
    :mod:`repro_torch.analysis.trace_passes`); ``opt_state_realloc_bytes``
    is the state a steady update (the second) allocates anew."""
    name = _cell_name(cfg)
    report = AuditReport(name=name)
    params = default_params() if params is None else params
    ladder = tuple(ladder if ladder is not None else cfg.rank_ladder)

    transform = build_optimizer(cfg)
    report.extend(lint_chain(transform, ladder=ladder, name=name))
    if not report.ok:
        return report  # a malformed chain runs garbage (or raises)
    transform = build_optimizer(_traceable(cfg))

    expected, model_findings = expected_launches(transform, params, name=name)
    report.extend(model_findings)

    trace = trace_update(transform, params)
    if not model_findings:
        report.extend(launch_findings(expected, trace.counts,
                                      fused_epilogue=cfg.fused_epilogue, where=name))
    report.extend(dtype_flow_findings(trace, where=name))

    hashes = {}
    if ladder:
        def at_rank(r: int) -> Transform:
            return build_optimizer(_traceable(cfg), rank_map=RankMap(r))

        rec, hashes = recompile_findings(at_rank, params, ladder, where=name)
        report.extend(rec)

    if check_memory:
        report.extend(memory_crosscheck())

    report.summary.update({
        "launches_per_step": sum(trace.counts.values()),
        "launch_counts": launch_count.format_counts(trace.counts),
        "proj_state_bytes": _proj_bytes(trace.state),
        "opt_state_realloc_bytes": steady_realloc_bytes(transform, trace),
        "signature": signature_hash(trace),
        "ladder_signatures": hashes,
        "family_plans": lowrank_plan_stats(transform, params, name=name),
    })
    return report


def audit_sharded(
    cfg: OptimizerConfig,
    *,
    arch: str = "llama-60m-smoke",
    model=None,
    mesh_axes=(("data", 8),),
    reduce_dtype: torch.dtype = torch.bfloat16,
    grad_clip: float = 1.0,
    batch_size: int = 8,
    seq_len: int | None = None,
    device: str | torch.device = "cpu",
    shard_params: bool = False,
) -> AuditReport:
    """Audit the data-parallel step of :mod:`repro_torch.launch.shardmap_fsdp`
    (with a ``model`` axis larger than 1 in ``mesh_axes``, the
    tensor-parallel step of the ``Trainer``, fp32 reduction) on a ``fake``
    process group (no second device): the collective schedule
    (RA601/602/603/606) and its wire bytes, the dispatch-launch contract,
    the parameters written in place (RA604's counterpart), each rank's
    batch rows (RA605's) and the per-shard memory model.

    The step runs two real steps of a fresh model of ``arch`` (or of
    ``model``'s config), seeded parameters on ``device``; ``model`` itself
    is not touched.  ``shard_params`` audits the step on split parameters
    (its reduction in fp32, whatever ``reduce_dtype`` says)."""
    from repro_torch.models import build_model

    axes = dict(mesh_axes)
    tp = int(axes.pop("model", 1))
    (data_axis, n_shards), = axes.items()  # one data axis, and the model axis
    n_shards = int(n_shards)
    shard_state = bool(cfg.shard_state)
    name = f"sharded:{_cell_name(cfg)}@{data_axis}={n_shards}"
    if tp > 1:
        name += f",model={tp}"
        reduce_dtype = torch.float32
    if shard_state:
        name += "+zero"
    if shard_params:
        name += "+fsdp"
        reduce_dtype = torch.float32
    report = AuditReport(name=name)

    transform = build_optimizer(cfg)
    report.extend(lint_chain(transform, ladder=cfg.rank_ladder, name=name))
    if not report.ok:
        return report

    mcfg = arch_config(arch) if model is None else model.cfg
    fresh = build_model(mcfg, device=device)
    fresh.init_params(0)
    batch_size = n_shards * -(-int(batch_size) // n_shards)  # round up to /N
    tr = trace_sharded_step(fresh, transform, n_shards=n_shards, batch_size=batch_size,
                            seq_len=seq_len, reduce_dtype=reduce_dtype, grad_clip=grad_clip,
                            data_axis=data_axis, shard_state=shard_state,
                            shard_params=shard_params, tp=tp)
    # the whole shapes the optimizer sees (stand-ins under shard_params)
    params = tr.params if tr.param_split is None else tr.param_split.standins()

    seq = int(tr.batch["tokens"].shape[1])
    expected = expected_collective_schedule(
        transform, params, n_shards=n_shards, reduce_dtype=reduce_dtype,
        data_axis=data_axis, shard_state=shard_state, param_split=tr.param_split,
        remat=bool(mcfg.remat),
        tensor_parallel={"cfg": mcfg, "rows": batch_size // n_shards, "seq": seq}
        if tp > 1 else None)
    report.extend(collective_schedule_findings(
        tr.records, expected, reduce_dtype=reduce_dtype, params=params, where=name))

    # the dispatch-launch contract holds on each rank: the refresh step's
    # counts are the model's (the spectrum probe runs at a refresh)
    exp_launch, model_findings = expected_launches(transform, params, name=name)
    report.extend(model_findings)
    if not model_findings:
        report.extend(launch_findings(exp_launch, tr.refresh_counts,
                                      fused_epilogue=cfg.fused_epilogue, where=name))
    report.extend(inplace_findings(tr.param_writes, where=name))
    report.extend(replication_findings(tr.rows, global_batch=batch_size,
                                       n_shards=n_shards, where=name))

    collectives = {op: n for op, n in tr.counts.items()
                   if op not in launch_count.DISPATCH_OPS}
    report.summary.update({
        "n_shards": n_shards,
        "collectives": launch_count.format_counts(collectives),
        "expected_schedule": expected,
        "wire": wire_bytes_model(tr.records, n_shards, {"model": tp}),
        "per_shard_memory": per_shard_memory(params, tr.opt_state, tr.batch,
                                             n_shards=n_shards, reduce_dtype=reduce_dtype,
                                             shard_state=shard_state,
                                             shard_params=shard_params, tp=tp),
        "launch_counts": launch_count.format_counts(tr.counts),
        "opt_state_realloc_bytes": tr.realloc_bytes,
        "buffers": {"params_in_place": sum(same and n > 0
                                           for same, n in tr.param_writes.values()),
                    "params": len(tr.param_writes),
                    "rows_per_rank": sorted(set(tr.rows))},
    })
    return report


def audit_summary(transform: Transform, params: dict, *, name: str = "optimizer") -> str:
    """One-line startup summary for the Trainer log: the launch counts of
    one traced update (the first, a refresh), the projected-state bytes
    and the op-sequence signature, from one ``meta`` trace."""
    trace = trace_update(transform, params)
    return (f"audit[{name}]: launches/step={launch_count.format_counts(trace.counts)} "
            f"proj_state={_proj_bytes(trace.state)}B sig={signature_hash(trace)}")


def matrix_configs(rank: int = 16, period: int = 10,
                   ladder=(8, 16)) -> list[OptimizerConfig]:
    """The full audit pass matrix: every lowrank factory optimizer across
    fuse_families x fused_epilogue, plus the full-rank baselines (the
    reference's 28 cells)."""
    cells = []
    for opt in LOWRANK_OPTIMIZERS:
        for fuse in (False, True):
            for epi in (False, True):
                cells.append(OptimizerConfig(
                    name=opt, rank=rank, period=period, gamma=1,
                    fuse_families=fuse, fused_epilogue=epi, rank_ladder=tuple(ladder)))
    for opt in FULLRANK_OPTIMIZERS:
        cells.append(OptimizerConfig(name=opt, period=period, gamma=1))
    return cells


def run_matrix(params: dict | None = None, *, rank: int = 16, period: int = 10,
               ladder=(8, 16), check_memory: bool = False) -> dict[str, AuditReport]:
    """Audit every matrix cell; returns ``{cell_name: AuditReport}``."""
    params = default_params() if params is None else params
    out: dict[str, AuditReport] = {}
    for cfg in matrix_configs(rank=rank, period=period, ladder=ladder):
        out[_cell_name(cfg)] = audit_optimizer(cfg, params, ladder=cfg.rank_ladder)
    if check_memory:
        mem = AuditReport(name="memory_crosscheck")
        mem.extend(memory_crosscheck())
        out[mem.name] = mem
    return out


def _parse_ladder(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x.strip())


def _parse_mesh(text: str) -> tuple[tuple[str, int], ...]:
    """``"data=8"`` -> ``(("data", 8),)``."""
    axes = []
    for part in text.split(","):
        if not part.strip():
            continue
        axis, _, size = part.partition("=")
        axes.append((axis.strip(), int(size)))
    if not axes:
        raise ValueError(f"unparseable mesh spec: {text!r}")
    return tuple(axes)


_REDUCE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
                  "fp32": torch.float32, "f16": torch.float16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Static audit of the optimizer step (traced on meta tensors; "
                    "--sharded runs two steps on a fake process group).",
    )
    ap.add_argument("--optimizer", default="gum", help="factory optimizer name (default: gum)")
    ap.add_argument("--arch", default=None, metavar="NAME",
                    help="audit against a registered model config's parameter tree "
                         "(on meta, nothing allocates) instead of the synthetic "
                         "reference tree; append -smoke for the tiny variant")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--period", type=int, default=10)
    ap.add_argument("--fuse-families", action="store_true")
    ap.add_argument("--fused-epilogue", action="store_true")
    ap.add_argument("--rank-ladder", type=_parse_ladder, default=(8, 16), metavar="R1,R2,...")
    ap.add_argument("--matrix", action="store_true",
                    help="audit the full optimizer x fuse x epilogue matrix")
    ap.add_argument("--check-memory", action="store_true",
                    help="also cross-check results/BENCH_rank_policy.json")
    ap.add_argument("--sharded", action="store_true",
                    help="audit the data-parallel step instead: collective schedule, "
                         "wire bytes, in-place parameters and per-shard buffers, on a "
                         "fake process group of the mesh's size")
    ap.add_argument("--mesh", default="data=8", metavar="AXIS=N",
                    help="mesh spec for --sharded (default: data=8; data=D,model=T audits "
                         "the tensor-parallel step on D·T fake ranks)")
    ap.add_argument("--shard-state", action="store_true",
                    help="audit the ZeRO-split fused step (implies --fuse-families)")
    ap.add_argument("--shard-params", action="store_true",
                    help="audit the step on split parameters (FSDP by PARAM_RULES; fp32 "
                         "reduction)")
    ap.add_argument("--reduce-dtype", default="bf16", choices=sorted(_REDUCE_DTYPES),
                    help="declared gradient-reduction dtype for --sharded")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.sharded:
        cfg = OptimizerConfig(
            name=args.optimizer, rank=args.rank, period=args.period, gamma=1,
            fuse_families=args.fuse_families or args.shard_state,
            fused_epilogue=args.fused_epilogue, rank_ladder=args.rank_ladder,
            shard_state=args.shard_state)
        rep = audit_sharded(cfg, arch=args.arch or "llama-60m-smoke",
                            mesh_axes=_parse_mesh(args.mesh),
                            reduce_dtype=_REDUCE_DTYPES[args.reduce_dtype],
                            shard_params=args.shard_params)
        reports = {rep.name: rep}
    else:
        params = arch_params(args.arch) if args.arch else None
        if args.matrix:
            reports = run_matrix(params, rank=args.rank, period=args.period,
                                 ladder=args.rank_ladder, check_memory=args.check_memory)
        else:
            cfg = OptimizerConfig(
                name=args.optimizer, rank=args.rank, period=args.period, gamma=1,
                fuse_families=args.fuse_families, fused_epilogue=args.fused_epilogue,
                rank_ladder=args.rank_ladder)
            reports = {_cell_name(cfg): audit_optimizer(cfg, params, ladder=args.rank_ladder,
                                                        check_memory=args.check_memory)}

    ok = all(r.ok for r in reports.values())
    if args.as_json:
        print(json.dumps({k: r.to_json() for k, r in reports.items()}, indent=2, default=str))
    else:
        for r in reports.values():
            print(r.format(verbose=args.verbose))
        if not args.sharded:
            print(f"audit matrix: {sum(r.ok for r in reports.values())}"
                  f"/{len(reports)} cells clean")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
