#!/usr/bin/env python3
"""Measure how far tensor-parallel training's losses and parameters stray
from the one-process run's, for the basis of ``chip_smoke.py``'s
``TP_LOSS_TOL`` and ``TP_PARAM_TOL`` (a measurement script, not part of
the port).

    python3 tools/tp_loss_spread.py [--seeds 0,1,2] [--out FILE]
    python3 tools/tp_loss_spread.py --smoke      # the plumbing, on the CPU

Trains llama-130m at full width with ``chip_smoke.py`` phase 4i's
tensor-parallel settings: 3 steps (period 3: a refresh, then two steady
steps) of 8 x 1024 rows, GUM per leaf (lr 5e-3, rank 256, gamma 4) and
fused GaLore (lr 1e-2, rank 256, family-stacked, the fused epilogue), for
each seed (the parameters' and the data's).  Each runs once alone (no
mesh, on rank 0 while rank 1 waits) and once on a (data=1, model=2) mesh
of two gloo ranks on the one card, both with TF32 off as
``chip_smoke.py``.  The ranks then rerun GUM at the first seed (the
embedding's backward accumulates in an order the card does not fix), and
run a control of each optimizer at the first seed: Megatron's *f*
(``models/tensor_parallel.py``'s ``_Enter``) passing its gradient on
without the all-reduce over ``model``, a wrong backward that keeps the
forward exact.  Prints, for each run, the losses, each step's relative
distance to the one-process run's and the parameter leaf farthest from
its (relative Frobenius distance after step 3), then one JSON object of
them all with a summary per optimizer (also written to ``--out``).
``--smoke`` runs llama-60m's ``SMOKE`` at rank 4 on 4 x 64 rows on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS = 3
OPTS = {"gum": dict(name="gum", lr=5e-3, rank=256, gamma=4, period=3),
        "galore": dict(name="galore", lr=1e-2, rank=256, period=3, weight_decay=0.0,
                       fuse_families=True, fused_epilogue=True)}


def _setup(smoke: bool):
    """(config, batch, seq, device, the optimizers' configs)."""
    from repro_torch.configs import get_config, get_smoke

    if smoke:
        return (get_smoke("llama-60m"), 4, 64, "cpu",
                {k: dict(v, rank=4) for k, v in OPTS.items()})
    return get_config("llama-130m"), 8, 1024, "cuda", OPTS


def train(torch, smoke: bool, opt: str, seed: int, mesh=None,
          ckpt_root: str = "") -> tuple[list, dict]:
    """One 3-step run's losses and its whole parameters after step 3 (on
    the host), on ``mesh`` (None: this process alone)."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg, batch, seq, device, opts = _setup(smoke)
    ckpt_dir = tempfile.mkdtemp(prefix="tp_loss_spread_", dir=ckpt_root or None)
    try:
        trainer = Trainer(build_model(cfg, device=device), OptimizerConfig(**opts[opt]),
                          RunConfig(steps=STEPS, log_every=0, seed=seed, ckpt_dir=ckpt_dir),
                          DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                     seed=seed),
                          device=device, mesh=mesh)
        trainer.monitor.z = float("inf")
        losses = trainer.train().losses
        params = trainer.whole_params("cpu")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del trainer
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses, params


def leaf_rel(got: dict, want: dict) -> tuple[str, float]:
    """The leaf farthest from ``want`` by relative Frobenius distance."""
    rels = {k: float((got[k].double() - want[k].double()).norm() / want[k].double().norm())
            for k in want}
    worst = max(rels, key=rels.get)
    return worst, rels[worst]


def ranks(mesh, inputs: dict) -> dict:
    """The two ranks' side.  For each run (each optimizer and seed, then
    GUM's rerun at the first seed, then each optimizer's control there)
    rank 0 first trains the one-process twin alone, then both ranks train on
    the (data=1, model=2) mesh; rank 0 returns each run's losses beside the
    twin's and the farthest parameter leaf, rank 1 its losses."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import tensor_parallel

    if not inputs["smoke"]:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tp = Mesh((1, 2), ("data", "model"), group=mesh.group, backend=mesh.backend)
    first = inputs["runs"][0][1]
    plan = ([(f"{opt} seed {seed}", opt, seed, False) for opt, seed in inputs["runs"]]
            + [(f"gum seed {first} rerun", "gum", first, False)]
            + [(f"{opt} seed {first} control", opt, first, True) for opt in OPTS])
    twins, out = {}, {}
    exact = tensor_parallel._Enter.backward
    for name, opt, seed, control in plan:
        if mesh.rank == 0 and (opt, seed) not in twins:
            twins[opt, seed] = train(torch, inputs["smoke"], opt, seed, None, inputs["dir"])
        dist.barrier(group=mesh.group)
        if control:
            tensor_parallel._Enter.backward = staticmethod(lambda ctx, g: (None, g))
        try:
            losses, params = train(torch, inputs["smoke"], opt, seed, tp, inputs["dir"])
        finally:
            tensor_parallel._Enter.backward = exact
        out[name] = {"losses": losses}
        if mesh.rank == 0:
            base, want = twins[opt, seed]
            out[name] |= {"one_process": base,
                          "rel": [abs(x - y) / abs(y) for x, y in zip(losses, base)],
                          "leaf_rel": leaf_rel(params, want)}
        del params
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--out", default="")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args()
    import torch

    from repro_torch.launch.mesh import run_local_ranks

    seeds = [int(s) for s in a.seeds.split(",")]
    if not a.smoke and not torch.cuda.is_available():
        sys.exit("tp_loss_spread: needs an NVIDIA GPU (or --smoke)")
    runs = [(opt, seed) for seed in seeds for opt in OPTS]
    work = tempfile.mkdtemp(prefix="tp_loss_spread_ranks_")
    try:
        t0 = time.perf_counter()
        got = run_local_ranks("tp_loss_spread:ranks", 2,
                              args=({"runs": runs, "smoke": a.smoke, "dir": work},),
                              workdir=os.path.join(work, "spawn"), backend="gloo",
                              timeout=1500, threads=2, extra_path=[str(ROOT / "tools")])
        print(f"runs {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = got[0]
    for name, run in result.items():
        if run["losses"] != got[1][name]["losses"]:
            sys.exit(f"tp_loss_spread: {name}: the ranks' losses differ")
        print(f"{name}: losses {run['losses']}; one process {run['one_process']}; relative "
              f"{run['rel']}; farthest parameter leaf {run['leaf_rel']}", flush=True)
    summary = {}
    for opt in OPTS:
        held = [r for n, r in result.items() if n.startswith(opt) and "control" not in n]
        ctrl = result[f"{opt} seed {seeds[0]} control"]
        summary[opt] = {"largest_first_rel": max(r["rel"][0] for r in held),
                        "largest_later_rel": max(max(r["rel"][1:]) for r in held),
                        "largest_leaf_rel": max(r["leaf_rel"][1] for r in held),
                        "control_later_rel": min(ctrl["rel"][1:]),
                        "control_leaf_rel": ctrl["leaf_rel"][1]}
    print(f"summary {summary}", flush=True)
    line = json.dumps({"runs": result, "summary": summary})
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
