#!/usr/bin/env python3
"""Flash attention (kernel row 7) over many seeded inputs at one shape,
held against an fp64 reference: is the kernel farther from the exact
result than the plain fp32 path (``ref.flash_attention_ref``) is?

    python3 tools/flash_attention_seed_sweep.py [--seeds 256] \
        [--shape 2,77,200,6,3,128] [--causal 0] [--q-scale 8] [--dtype fp32]

Each seed draws q (times ``--q-scale``), k and v in that order from a CUDA
``torch.Generator`` seeded with it, as ``tests/test_torch_cuda.py``'s
``_flash_case`` does, then casts them to ``--dtype``.  Errors are
max|out - want| / max|want|: the kernel and the plain path each against
fp64, and the kernel against the plain path.  In fp32 that last is the
card test's yardstick (tolerance 1e-5).  In bf16 / fp16 (the 16-bit
instantiations) the kernel is held to the plain path's fp32 output before
its rounding, against chip_smoke.py's TOL_FLASH_16 (one rounding: 2^-8 in
bf16, 2^-11 + 1e-5 in fp16), and the largest ratio to that bound is
printed; beside it the distance between the two rounded outputs, which can
reach a whole step (2^-7 of an output in bf16's top binade) where their
fp32 values straddle a rounding boundary, with the count of seeds where it
passes the bound.  Prints the card's name and power limit, one line per
seed where an error passes its tolerance, and a summary (largest, median,
count over the tolerance of each error, and the seeds where the kernel is
farther from fp64 than the plain path plus one rounding).  Needs a card.

The 16-bit sweeps of record run at the prefill shapes of chatglm3-6b and
dbrx-132b, causal, unscaled q:

    --dtype bf16 --q-scale 1 --causal 1 --seeds 64 --shape 4,2048,2048,32,2,128
    --dtype bf16 --q-scale 1 --causal 1 --seeds 64 --shape 4,2048,2048,48,8,128
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TOL = 1e-5
# the element type -> (torch dtype name, the bound against the unrounded
# plain output; chip_smoke.py's TOL_FLASH_16)
DTYPES = {"fp32": ("float32", TOL), "bf16": ("bfloat16", 2.0 ** -8),
          "fp16": ("float16", 2.0 ** -11 + TOL)}


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
    ap.add_argument("--dtype", default="fp32", choices=sorted(DTYPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_attention_seed_sweep.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    B, S, T, H, KV, D = (int(x) for x in args.shape.split(","))
    causal = bool(args.causal)
    name, bound = DTYPES[args.dtype]
    dtype = getattr(torch, name)
    low = dtype != torch.float32
    tols = {"kernel-fp64": TOL, "plain-fp64": TOL, "kernel-plain": bound}
    if low:  # the check's yardstick, and the rounded outputs' distance beside it
        tols = {"kernel-fp64": bound, "plain-fp64": bound, "kernel-unrounded": bound,
                "kernel-plain rounded": bound}
    errs = {key: [] for key in tols}
    farther = []
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = args.q_scale * torch.randn(B, S, H, D, generator=gen, device="cuda")
        k = torch.randn(B, T, KV, D, generator=gen, device="cuda")
        v = torch.randn(B, T, KV, D, generator=gen, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = flash_attention(q, k, v, causal=causal)
        plain = ref.flash_attention_ref(q, k, v, causal=causal)
        want = exact(q, k, v, causal)
        e = {"kernel-fp64": rel(got, want), "plain-fp64": rel(plain, want)}
        if low:
            unrounded = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
            e["kernel-unrounded"] = rel(got, unrounded)
            e["kernel-plain rounded"] = rel(got, plain)
            del unrounded
        else:
            e["kernel-plain"] = rel(got, plain)
        del got, plain, want
        for key, val in e.items():
            errs[key].append(val)
        if e["kernel-fp64"] > e["plain-fp64"] + (bound if low else 0.0):
            farther.append(seed)
        if any(val > tols[key] for key, val in e.items()):
            print(f"seed {seed}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items()), flush=True)
    print(f"flash_attention q{(B, S, H, D)} kv{(B, T, KV, D)} {name} causal={causal} "
          f"q x {args.q_scale}, {args.seeds} seeds:", flush=True)
    for key, vals in errs.items():
        print(f"  {key:20s} max {max(vals):.3e}  median {statistics.median(vals):.3e}  "
              f"over {tols[key]:.3e}: {sum(v > tols[key] for v in vals)}", flush=True)
    check = "kernel-unrounded" if low else "kernel-plain"
    print(f"  the check ({check}): largest ratio to its bound {bound:.3e}: "
          f"{max(errs[check]) / bound:.4f}", flush=True)
    print(f"  kernel farther from fp64 than the plain path{' plus one rounding' if low else ''} "
          f"on {len(farther)} of {args.seeds} seeds; largest excess "
          f"{max(errs['kernel-fp64'][s] - errs['plain-fp64'][s] for s in range(args.seeds)):.3e}",
          flush=True)
    if max(errs[check]) > bound:
        sys.exit(f"the kernel passed its bound on {sum(v > bound for v in errs[check])} seeds")


if __name__ == "__main__":
    main()
