#!/usr/bin/env python3
"""Measure what telemetry costs the port's training step on one NVIDIA GPU,
for the record in PERF.md (a measurement script, not part of the port).

    python3 tools/telemetry_overhead.py [--pairs 3]

Trains llama-130m at full width through the port's ``Trainer`` with
``chip_smoke.py`` phase 4's settings (GUM, lr 5e-3, rank 256, gamma 4,
period 3, 6 steps, batch 8 x 1024, seed 0) with telemetry off
(``OptimizerConfig()``, no run log) and on (``OptimizerConfig(telemetry=
True)``, ``Trainer(telemetry="stdout=0")``, no profiler window), in the
order off, on, on, off, ... after one unrecorded warm-up run (a process's
first refresh pays the solver's set-up).  Prints each run's step times,
its steady median (steps 2, 3, 5, 6) and refresh steps (1, 4), and the
median over the runs of each setting; asserts that every run's losses
are bitwise the first's.  Then times, with a CUDA event pair around each
of 20 calls, the telemetry's own device work: the sampled bias residual
``1 − ‖PᵀG‖²/‖G‖²`` at each of llama-130m's three leaf shapes, and the
drift's cross-Gram ``P_oldᵀ P_new`` at each.
"""
from __future__ import annotations

import argparse
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def train(torch, telemetry: bool) -> tuple[list[float], list[float]]:
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg = get_config("llama-130m")
    ckpt_dir = tempfile.mkdtemp(prefix="telemetry_overhead_")
    try:
        trainer = Trainer(
            build_model(cfg, device="cuda"),
            OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4, period=3,
                            telemetry=telemetry),
            RunConfig(steps=6, log_every=1, seed=0, ckpt_dir=ckpt_dir),
            DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8, seed=0),
            device="cuda", telemetry="stdout=0" if telemetry else None)
        result = trainer.train()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del trainer
    torch.cuda.empty_cache()
    return result.losses, [t * 1e3 for t in result.step_seconds]


def event_ms(torch, fn, iters: int = 20) -> float:
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()} | torch {torch.__version__}", flush=True)
    from repro_torch.core.combinators import _bias_residual, _subspace_drift
    from repro_torch.kernels import build

    build.build()
    t0 = time.perf_counter()
    first, _ = train(torch, False)
    print(f"warm-up run (off): {time.perf_counter() - t0:.1f} s", flush=True)
    order = [False, True, True, False] * ((args.pairs + 1) // 2)
    runs = {False: [], True: []}
    for telemetry in order[:2 * args.pairs]:
        losses, ms = train(torch, telemetry)
        assert losses == first, (telemetry, losses, first)
        steady = statistics.median([ms[1], ms[2], ms[4], ms[5]])
        runs[telemetry].append((steady, ms[0], ms[3]))
        print(f"telemetry {'on ' if telemetry else 'off'}: step ms "
              f"{[round(t, 3) for t in ms]}; steady median {steady:.3f}; refresh steps "
              f"{ms[0]:.3f}, {ms[3]:.3f}", flush=True)
    med = {k: [statistics.median(x[i] for x in v) for i in range(3)] for k, v in runs.items()}
    print(f"median over {args.pairs} runs each: steady off {med[False][0]:.3f}, on "
          f"{med[True][0]:.3f} ({med[True][0] - med[False][0]:+.3f} ms, "
          f"{med[True][0] / med[False][0] - 1:+.2%}); refresh step 1 off {med[False][1]:.3f}, "
          f"on {med[True][1]:.3f}; refresh step 4 off {med[False][2]:.3f}, on "
          f"{med[True][2]:.3f} ({med[True][2] - med[False][2]:+.3f} ms)", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (m, n), side in [((768, 768), "left"), ((768, 2048), "left"), ((2048, 768), "right")]:
        s = m if side == "left" else n
        g = torch.randn(12, m, n, generator=gen, device="cuda")
        p = torch.linalg.qr(torch.randn(12, s, 256, generator=gen, device="cuda"))[0]
        q = torch.linalg.qr(torch.randn(12, s, 256, generator=gen, device="cuda"))[0]
        bias = event_ms(torch, lambda: _bias_residual(p, g, side))
        drift = event_ms(torch, lambda: _subspace_drift(p, q))
        print(f"(12, {m}, {n}) {side}: bias residual {bias:.4f} ms, drift {drift:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
