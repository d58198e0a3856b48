#!/usr/bin/env python3
"""Flash attention (kernel row 7) over many seeded inputs at one shape,
held against an fp64 reference: is the kernel farther from the exact
result than the plain fp32 path (``ref.flash_attention_ref``) is?

    python3 tools/flash_attention_seed_sweep.py [--seeds 256] \
        [--shape 2,77,200,6,3,128] [--causal 0] [--q-scale 8]

Each seed draws q (times ``--q-scale``), k and v in that order from a CUDA
``torch.Generator`` seeded with it, as ``tests/test_torch_cuda.py``'s
``_flash_case`` does.  Errors are max|out - want| / max|want|: the kernel
and the plain path each against fp64, and the kernel against the plain
path (the card test's yardstick, tolerance 1e-5).  Prints the card's name
and power limit, one line per seed where an error passes 1e-5, and a
summary (largest, median, count over 1e-5 of each error, and the seeds
where the kernel is farther from fp64 than the plain path).  Needs a card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TOL = 1e-5


def exact(q, k, v, causal: bool):
    """Softmax attention in fp64 (GQA, the S queries the last S of T)."""
    import torch

    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kd, vd = (x.double().repeat_interleave(rep, dim=2).transpose(1, 2) for x in (k, v))
    s = q.double().transpose(1, 2) @ kd.transpose(-1, -2) * D ** -0.5
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (T - S)
        s = s.masked_fill(torch.arange(T, device=q.device)[None, :] > rows, float("-inf"))
    return (torch.softmax(s, dim=-1) @ vd).transpose(1, 2)


def rel(out, want) -> float:
    return float((out.double() - want.double()).abs().max() / want.double().abs().max())


def main() -> None:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=256)
    ap.add_argument("--shape", default="2,77,200,6,3,128", help="B,S,T,H,KV,D")
    ap.add_argument("--causal", type=int, default=0)
    ap.add_argument("--q-scale", type=float, default=8.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_attention_seed_sweep.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    B, S, T, H, KV, D = (int(x) for x in args.shape.split(","))
    causal = bool(args.causal)
    errs = {"kernel-fp64": [], "plain-fp64": [], "kernel-plain": []}
    farther = []
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = args.q_scale * torch.randn(B, S, H, D, generator=gen, device="cuda")
        k = torch.randn(B, T, KV, D, generator=gen, device="cuda")
        v = torch.randn(B, T, KV, D, generator=gen, device="cuda")
        got = flash_attention(q, k, v, causal=causal)
        plain = ref.flash_attention_ref(q, k, v, causal=causal)
        want = exact(q, k, v, causal)
        e = {"kernel-fp64": rel(got, want), "plain-fp64": rel(plain, want),
             "kernel-plain": rel(got, plain)}
        for key, val in e.items():
            errs[key].append(val)
        if e["kernel-fp64"] > e["plain-fp64"]:
            farther.append(seed)
        if max(e.values()) > TOL:
            print(f"seed {seed}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items()), flush=True)
    print(f"flash_attention q{(B, S, H, D)} kv{(B, T, KV, D)} causal={causal} "
          f"q x {args.q_scale}, {args.seeds} seeds:", flush=True)
    for key, vals in errs.items():
        print(f"  {key:13s} max {max(vals):.3e}  median {statistics.median(vals):.3e}  "
              f"over {TOL}: {sum(v > TOL for v in vals)}", flush=True)
    print(f"  kernel farther from fp64 than the plain path on {len(farther)} of {args.seeds} "
          f"seeds; largest excess {max(errs['kernel-fp64'][s] - errs['plain-fp64'][s] for s in range(args.seeds)):.3e}",
          flush=True)


if __name__ == "__main__":
    main()
