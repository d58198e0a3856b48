"""Training launcher: ``python -m repro_torch.launch.train --arch llama-130m ...``

The port of the JAX package's ``launch/train.py``: the same flags, the same
``Trainer`` wiring (resilience, fault injection, rank policy, telemetry, the
profiler window, the data mesh and the sharded state) and the same closing
lines.  It runs on the CUDA device unless ``--device cpu`` is given, and
raises where there is no GPU.  ``--audit`` runs the full static audit of
what is about to train before step 0 (:mod:`repro_torch.analysis`:
``audit_optimizer`` on the model's parameter tree, and with ``--mesh``
``audit_sharded`` of the data-parallel step on a fake process group of the
mesh's size, before the real group is joined), prints the reports and
exits 1 on an error finding, before anything is trained or saved.

``--mesh data=N`` runs one rank of N: start it under a launcher that sets the
rendezvous (``torchrun --nproc-per-node N -m repro_torch.launch.train ...
--mesh data=N``); the process group is ``nccl`` on CUDA (each rank on
``cuda:LOCAL_RANK``) and ``gloo`` with ``--device cpu``.  ``--shard-state``
splits the family-stacked optimizer state over the ranks and implies
``--fuse-families``, as in the reference.  ``--shard-params`` splits the
parameters over the ranks by the reference's ``PARAM_RULES`` (FSDP:
``Trainer(shard_params=True)``); with ``--audit`` the sharded audit traces
that step.  ``--mesh data=D,model=T`` (D·T ranks) adds tensor parallelism
over the model axis for the dense family (Megatron-split layers, the
vocab-parallel embedding and loss), with or without ``--shard-params``;
``--audit`` then traces the tensor-parallel step on D·T fake ranks.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) raises where there is no GPU")
    ap.add_argument("--opt", default="gum")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--gamma", type=int, default=2)
    ap.add_argument("--period", type=int, default=200)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--kernel-impl", default="auto", choices=["auto", "torch", "cuda"],
                    help="optimizer hot-loop implementation (OptimizerConfig.kernel_impl): "
                         "auto = the CUDA kernels on CUDA tensors, the plain PyTorch "
                         "versions on CPU tensors")
    ap.add_argument("--pad-rank-to", type=int, default=0,
                    help="rank padding of the low-rank kernels (e.g. 128)")
    ap.add_argument("--fuse-families", action="store_true",
                    help="family-stacked optimizer execution: one batched launch per shape "
                         "family instead of one per parameter leaf")
    ap.add_argument("--shard-state", action="store_true",
                    help="ZeRO-style sharded projected state: family-stacked low-rank "
                         "optimizer state splits over the mesh's data axis (implies "
                         "--fuse-families; needs --mesh)")
    ap.add_argument("--shard-params", action="store_true",
                    help="FSDP: split the parameters over the mesh's data axis by the "
                         "reference's PARAM_RULES, a per-layer all-gather and fp32 "
                         "reduce-scatter (needs --mesh)")
    ap.add_argument("--fused-epilogue", action="store_true",
                    help="fold chain-tail epilogues (-lr, weight decay) into the "
                         "back-projection (back_project_epilogue kernel; galore family)")
    ap.add_argument("--rank-policy", default=None,
                    help="time-varying / per-family rank: 'fixed:64', "
                         "'stepwise:0=128,500=64', 'family:512x512=32,...', "
                         "'spectral[:target_energy]'")
    ap.add_argument("--rank-ladder", default="",
                    help="comma-separated ranks an adaptive policy may emit, e.g. 32,64,128")
    ap.add_argument("--mesh", default="", metavar="AXIS=N",
                    help="mesh, e.g. 'data=2' or 'data=2,model=2' (tensor parallelism over "
                         "model): this process is one rank, started by torchrun "
                         "--nproc-per-node N (gloo on --device cpu, nccl on CUDA)")
    ap.add_argument("--resilience", nargs="?", const="", default=None, metavar="SPEC",
                    help="turn on the health monitor + recovery ladder: bare flag = "
                         "defaults, or a knob spec like 'ring=3,snapshot_every=5,spike_z=4' "
                         "(any ResilienceConfig field)")
    ap.add_argument("--inject", default=None, metavar="PLAN",
                    help="deterministic fault injection: 'kind@step[*scale][#arg];...' "
                         "e.g. 'grad_nan@5;grad_spike@9*1e6;refresh_zero@13;"
                         "ckpt_bitflip@20;kill_save@40#3'")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for the fault plan's corruption RNG (bit positions etc.)")
    ap.add_argument("--telemetry", nargs="?", const="", default=None, metavar="SPEC",
                    help="turn on the telemetry run log (repro_torch.telemetry): bare flag "
                         "= defaults, or a knob spec like 'every=10,stdout=0,memory=256' "
                         "(any TelemetryConfig field).  One run writes one schema-versioned "
                         "events.jsonl (step metrics, health/recovery/fault/rank-policy/"
                         "checkpoint events, timing spans) plus the in-step subspace "
                         "metrics (captured energy, projector drift, sampled bias "
                         "residual); summarize with python -m repro_torch.telemetry.report")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="events.jsonl path override (default <ckpt-dir>/events.jsonl)")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="torch.profiler window over steps [A, B), a Chrome trace written "
                         "under <ckpt-dir>/profile")
    ap.add_argument("--audit", action="store_true",
                    help="static audit before step 0 (chain lint, launch model, dtype "
                         "flow, signatures; with --mesh the collective schedule and the "
                         "in-place step); exit 1 on an error finding")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    if args.shard_state and not args.mesh:
        raise ValueError("--shard-state splits the optimizer state over a mesh: give --mesh")
    if args.shard_params and not args.mesh:
        raise ValueError("--shard-params splits the parameters over a mesh: give --mesh")

    from repro_torch.configs import RunConfig, get_config, get_smoke
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.resilience import FaultPlan
    from repro_torch.train import Trainer

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptimizerConfig(
        name=args.opt, lr=args.lr, rank=args.rank, gamma=args.gamma,
        period=args.period, kernel_impl=args.kernel_impl,
        pad_rank_to=args.pad_rank_to,
        fuse_families=args.fuse_families or args.shard_state,
        shard_state=args.shard_state,
        fused_epilogue=args.fused_epilogue, rank_policy=args.rank_policy,
        rank_ladder=tuple(int(r) for r in args.rank_ladder.split(",") if r),
        telemetry=args.telemetry is not None,
    )
    run_cfg = RunConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, resume=not args.no_resume,
        ckpt_every=max(args.steps // 4, 1), log_every=10,
    )
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    if args.audit and not _audit(args, cfg, opt_cfg, run_cfg):
        sys.exit(1)
    mesh, device = None, args.device
    if args.mesh:
        mesh, device = _join_mesh(args.mesh, args.device, argv)
    model = build_model(cfg, device=device)
    inject = FaultPlan.parse(args.inject, seed=args.inject_seed) if args.inject else None

    trainer = Trainer(model, opt_cfg, run_cfg, data_cfg, device=device,
                      microbatches=args.microbatches, resilience=args.resilience,
                      inject=inject, telemetry=args.telemetry, events_out=args.events_out,
                      profile_steps=args.profile_steps, mesh=mesh,
                      shard_params=args.shard_params)
    result = trainer.train()
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if not trainer.is_main:
            return
    print(
        f"done: step={result.final_step} "
        f"first_loss={result.losses[0]:.4f} last_loss={result.losses[-1]:.4f} "
        f"skipped={result.skipped_nonfinite} stragglers={len(result.straggler_steps)}"
        + (f" resumed_from={result.resumed_from}" if result.resumed_from else "")
    )
    if result.recovery_counts:
        fired = {k: v for k, v in result.recovery_counts.items() if v}
        print(f"resilience: recoveries={fired or '{}'} "
              f"health_events={len(result.health_events)} "
              f"faults_fired={len(result.fault_log)}")
    if result.events_path:
        # train() already emitted the closing counters record.
        print(f"telemetry: {result.events_path} "
              f"(python -m repro_torch.telemetry.report {args.ckpt_dir})")


def _audit(args, cfg, opt_cfg, run_cfg) -> bool:
    """The static audit of exactly what is about to train: the optimizer on
    the model's parameter tree (on ``meta``) and, with ``--mesh``, the
    data-parallel step (fp32 reduction, as the ``Trainer``'s mesh step) on
    a fake process group.  Each rank of a mesh run audits alike; rank 0
    prints.  Returns whether every report is clean."""
    import torch

    from repro_torch.analysis import audit_optimizer, audit_sharded
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import build_model

    model = build_model(cfg, device="meta")
    reports = [audit_optimizer(opt_cfg, model.params(), ladder=opt_cfg.rank_ladder)]
    if args.mesh:
        device = args.device
        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        reports.append(audit_sharded(opt_cfg, model=model, mesh_axes=tuple(parse_mesh(args.mesh)),
                                     reduce_dtype=torch.float32, grad_clip=run_cfg.grad_clip,
                                     batch_size=args.batch, seq_len=args.seq, device=device,
                                     shard_params=args.shard_params))
    ok = all(rep.ok for rep in reports)
    if int(os.environ.get("RANK", 0)) == 0:
        for rep in reports:
            print(rep.format(), flush=True)
        if not ok:
            print("audit: error finding(s) before step 0 — not training", flush=True)
    return ok


def _join_mesh(spec: str, device: str, argv: Optional[Sequence[str]]):
    """Join the launcher's process group as a rank of the ``spec`` mesh;
    returns the mesh and this rank's device."""
    from repro_torch.launch.mesh import Mesh, default_backend, init_distributed, parse_mesh

    axes = parse_mesh(spec)
    total = 1
    for _, size in axes:
        total *= size
    if "RANK" not in os.environ:
        args = " ".join(argv if argv is not None else sys.argv[1:])
        raise RuntimeError(f"--mesh {spec} runs one process per rank; start the {total} "
                           f"ranks with: torchrun --nproc-per-node {total} -m "
                           f"repro_torch.launch.train {args}")
    import torch
    import torch.distributed as dist

    backend = default_backend(device)
    if backend == "nccl":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    init_distributed(backend)
    if dist.get_world_size() != total:
        raise RuntimeError(f"--mesh {spec} has {total} ranks, the launcher started "
                           f"{dist.get_world_size()}")
    return Mesh([size for _, size in axes], [a for a, _ in axes], group=dist.group.WORLD,
                backend=backend), device


if __name__ == "__main__":
    main()
