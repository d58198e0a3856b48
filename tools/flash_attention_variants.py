#!/usr/bin/env python3
"""Time variants of the ``flash_attention`` kernel against the one the port
builds, on one NVIDIA GPU, to show what each design choice of
``src/repro_torch/kernels/csrc/flash_attention.cu`` buys.  A measurement
script for the record in PERF.md, not part of the port: a variant raises
when the source no longer has the text it edits.

    python3 tools/flash_attention_variants.py [--parent DIR ...]

Each variant is the kernel's source (``tf32x3.cuh`` inlined) with one
change made as text, built with the port's own ``nvcc`` flags into
``build/flash_attention_variants/`` and called through the same C entry
point:

  as_built      the source as it is;
  kv64          64-row kv tiles (twice the score registers, fewer barriers;
                head dims up to 128 only);
  fast_exp      ``__expf`` for ``expf`` (WRONG at the 1e-5 tolerance's
                scale: the time bounds what the accurate exponent costs);
  no_split      no split arithmetic, one TF32 product (WRONG results: the
                time bounds what 3xTF32 costs);
  score_one_sum the scores of a kv tile in one sum from zero at every D,
                as before the 32-deep slices (at D = 128 farther from
                fp64 than the fp32 plain path: what the slices cost);
  pv_group4, pv_group_half
                above D_pad 128, P V formed 4 column tiles at a time, or
                half the head (12 at 192, 16 at 256), not 8;
  parent:NAME   with ``--parent DIR`` (repeatable; NAME is the directory's
                name): ``DIR/flash_attention.cu`` with the headers beside
                it, an earlier version of the kernel with the same C entry
                point (``git archive <commit> src/repro_torch/kernels/csrc``).

Beside them, the port's Python wrapper and ``scaled_dot_product_attention``
on the same inputs.  Each is timed as ``chip_smoke.time_ms`` does (the
median of 20 calls, a CUDA event pair around each) and with the calls
queued behind a spin kernel (``tools/lowrank_update_variants.spin_time_ms``),
and each prints max|out - fp64| / max|fp64| at q/k/v (8, 1024, 12, 64)
causal (llama-130m's prefill), at the GQA short-query case q (2, 256,
16, 128), k/v (2, 1024, 4, 128), and in bf16 at chatglm3-6b's prefill, q
(4, 2048, 32, 128), k/v (4, 2048, 2, 128) and at nemotron-4-340b's, q (1,
4096, 96, 192), k/v (1, 4096, 8, 192) (an entry point without the dtype
argument, fp32 alone, is not timed in bf16, nor one whose head dim stops
below D at that D).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "build" / "flash_attention_variants"

# (B, S, T, H, KV, D, dtype)
SHAPES = [(8, 1024, 1024, 12, 12, 64, "float32"), (2, 256, 1024, 16, 4, 128, "float32"),
          (4, 2048, 2048, 32, 2, 128, "bfloat16"), (1, 4096, 4096, 96, 8, 192, "bfloat16")]


def variants(src: str) -> dict[str, str]:
    split = src[src.index("__device__ __forceinline__ void split_tf32"):]
    split = split[:split.index("\n}\n") + 2]
    three = src[src.index("  mma_tf32(acc, alo, bhi, c);"):]
    three = three[:three.index("\n}\n") + 1]
    # The tiers above D_pad 128 (64-row kv tiles would not fit their shared
    # memory in fp32: kv64 stops at 128).
    tiers = src[src.index("  if (a.D <= 128) return launch<EC, 128>"):]
    tiers = tiers[:tiers.index("\n}\n") + 1]
    out = {
        "as_built": src,
        "kv64": src.replace("constexpr int BKV = 32;", "constexpr int BKV = 64;")
                   .replace(tiers, "  return launch<EC, 128>(a, variant, stream);\n")
                   .replace("D > 256 ||", "D > 128 ||"),
        "fast_exp": src.replace("expf(", "__expf("),
        "score_one_sum": src.replace("constexpr int KSL = 4;", "constexpr int KSL = 16;"),
        "pv_group4": src.replace("int PG = DP <= 128 ? KD : 8;", "int PG = DP <= 128 ? KD : 4;"),
        "pv_group_half": src.replace("int PG = DP <= 128 ? KD : 8;",
                                     "int PG = DP <= 128 ? KD : KD / 2;"),
        "no_split": src.replace(split, "__device__ __forceinline__ void split_tf32(float x, "
                                       "uint32_t& hi, uint32_t& lo) {\n  hi = round_tf32(x);\n"
                                       "  lo = 0u;\n}\n")
                       .replace(three, "  mma_tf32(acc, ahi, bhi, c);\n"),
    }
    for name, text in out.items():
        if name != "as_built" and text == src:
            raise RuntimeError(f"variant {name}: the source no longer has the text it edits")
    return out


def main() -> None:
    import argparse

    import torch
    import torch.nn.functional as F

    from chip_smoke import time_ms  # puts src/ on the path
    from lowrank_update_variants import build_all, spin_time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import DTYPES, flash_attention

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="a directory holding an earlier flash_attention.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_attention_variants.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    header = (build.CSRC / "tf32x3.cuh").read_text().replace("#pragma once\n", "")
    src = (build.CSRC / "flash_attention.cu").read_text().replace('#include "tf32x3.cuh"\n',
                                                                  header)
    sources = variants(src)
    for parent in args.parent:  # its headers beside it, as #include "..." finds them
        name = f"parent:{parent.name}"
        (OUT / name).mkdir(parents=True, exist_ok=True)
        for header in parent.glob("*.cuh"):
            (OUT / name / header.name).write_text(header.read_text())
        sources[name] = (parent / "flash_attention.cu").read_text()
    fns = {}
    for name, (so, log) in build_all(sources, "flash_attention", OUT).items():
        # {template arguments (mangled): registers a thread}
        regs = dict(re.findall(r"kernelI((?:L[ib]\d+E)+)E.*?Used (\d+) registers", log, re.S))
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        print(f"{name:14s} registers {regs}, spill stores {spills} bytes", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "flash_attention")
        # An earlier entry point may lack the dtype argument (an fp32-only
        # kernel) and the variant out-argument (older still).
        has_dtype, has_variant = ("int dtype" in sources[name],
                                  "int* variant" in sources[name])
        sig = list(build.SIGNATURES["flash_attention"])  # ..., causal, dtype, variant, stream
        fn.argtypes = (sig[:-3] + sig[-3:-2] * has_dtype + sig[-2:-1] * has_variant
                       + sig[-1:])
        fn.restype = ctypes.c_int
        fns[name] = (lambda fn, has_dtype, has_variant: lambda *args: fn(
            *args[:-2], *args[-2:-1] * has_dtype, *[None] * has_variant, args[-1]))(
                fn, has_dtype, has_variant)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, T, H, KV, D, dtype in SHAPES:
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, T, KV, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, KV, D, generator=gen, device="cuda").to(dt)
        out = torch.empty_like(q)
        rep = H // KV
        kd, vd = (x.double().repeat_interleave(rep, dim=2).transpose(1, 2) for x in (k, v))
        qd = q.double().transpose(1, 2)
        s = qd @ kd.transpose(-1, -2) * D ** -0.5
        rows = torch.arange(S, device="cuda")[:, None] + (T - S)
        s = s.masked_fill(torch.arange(T, device="cuda")[None, :] > rows, float("-inf"))
        want = (torch.softmax(s, dim=-1) @ vd).transpose(1, 2)
        del s, kd, vd, qd
        code = DTYPES[dt]
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, KV, D,
                  D ** -0.5, 1, code, stream)  # causal

        def raw(fn):
            def call():
                if fn(*c_args):
                    sys.exit("launch failed")
                return out
            return call

        calls = {name: raw(fn) for name, fn in fns.items()
                 if (code == 0 or "int dtype" in sources[name])  # earlier: fp32 alone
                 and D <= int(re.search(r"D > (\d+) \|\|", sources[name]).group(1))}
        calls["wrapper"] = lambda: flash_attention(q, k, v)
        if S == T:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=KV != H).transpose(1, 2)
        print(f"q {(B, S, H, D)} kv {(B, T, KV, D)} causal {dtype}:", flush=True)
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            rel = float((got.double() - want).abs().max() / want.abs().max())
            print(f"  {name:14s} events {time_ms(call):.4f} ms  spin {spin_time_ms(call):.4f} ms"
                  f"  rel {rel:.1e}", flush=True)


if __name__ == "__main__":
    main()
