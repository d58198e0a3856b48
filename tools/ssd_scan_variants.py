#!/usr/bin/env python3
"""Time variants of the SSD scan kernel against the one the port builds, on
one NVIDIA GPU, to show what the design choices of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` buy.  A measurement script for
the record in PERF.md, not part of the port: a variant raises when the
source no longer has the text it edits.

    python3 tools/ssd_scan_variants.py [--parent DIR]

Each variant is the kernel's source (``tf32x3_gemm.cuh`` and ``tf32x3.cuh``
inlined) with one change made as text, built with the port's own ``nvcc``
flags into ``build/ssd_scan_variants/`` and called through the same C
entry point:

  as_built      the source as it is;
  wc1, wc2      one or two warps along P (32 or 64 columns of P a block)
                at every shape; as built, two while their blocks cover more
                than half the SMs;
  slices32_ring3  32-deep ring slices in three stages (twice the slices and
                barriers a chunk);
  warp64        one warp along P with 64 columns (8 n8 tiles) a warp:
                8-warp blocks, each A fragment split once for 64 columns;
  products_per_tile  the two or three TF32 products of each n8 tile issued
                back to back on its accumulator (the same values);
  x_three       three TF32 products where x is one operand, as if bf16 x
                had a low part (the same values);
  one_tf32      one TF32 product everywhere, no split (WRONG results: the
                time bounds what 3xTF32 costs);
  rows_balanced with two warps along P, row tiles paired so that each
                scheduler (warp % 4) holds equal intra-chunk work;
  fast_exp      __expf in M's exponentials (not the port's numerics);
  no_intra, no_inter, no_state  one phase's products skipped (WRONG
                results: the time left shows what the phase costs);
  chain_free    every (batch row, head, column block, chunk) its own block,
                each chunk scanned from a zero state (WRONG results: the
                same work without the chain of chunks, so the time bounds
                what a state-passing decomposition could gain before its
                extra passes over the states);
  parent        with ``--parent DIR``: ``DIR/ssd_scan.cu`` with the headers
                beside it, an earlier version whose C entry point takes no
                workspace, for instance the fp32 SIMT one unpacked by ``git
                archive <commit> src/repro_torch/kernels/csrc``.

Beside them the port's Python wrapper and the plain version.  Each is
timed as ``chip_smoke.time_ms`` does and with the calls queued behind a
spin kernel (``tools/lowrank_update_variants.spin_time_ms``), and prints
max|out - plain| / max|plain| over y and the state (the plain version sums
in fp32, as chip_smoke holds the kernel), at mamba2-370m's prefill
x (4, 4096, 32, 64) bf16, N 128, chunk 128, the ragged fp32 case x (2,
4000, 32, 64), chunk 64, and one prompt's prefill, x (1, 4096, 32, 64).  For the as-built wrapper at the prefill shape,
``torch.profiler`` splits the device time between the C Bᵀ pass and the
scan.  Each variant's registers and spill stores come from ptxas.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "build" / "ssd_scan_variants"

# (B, S, H, P, N, chunk, bf16 x)
SHAPES = [(4, 4096, 32, 64, 128, 128, True), (2, 4000, 32, 64, 128, 64, False),
          (1, 4096, 32, 64, 128, 128, True)]


def edit(src: str, name: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has the text it edits")
        src = src.replace(old, new)
    return src


def sources() -> dict[str, str]:
    """The variants of ssd_scan.cu, headers inlined."""
    from repro_torch.kernels import build

    helpers = (build.CSRC / "tf32x3.cuh").read_text().replace("#pragma once\n", "")
    core = ((build.CSRC / "tf32x3_gemm.cuh").read_text().replace("#pragma once\n", "")
            .replace('#include "tf32x3.cuh"\n', helpers))
    src = (build.CSRC / "ssd_scan.cu").read_text().replace('#include "tf32x3_gemm.cuh"\n',
                                                            core)
    rule = "2 * wide_blocks > tc::SMS"
    out = {"as_built": src,
           "wc1": edit(src, "wc1", [(rule, "false")]),
           "wc2": edit(src, "wc2", [(rule, "true")])}
    out["slices32_ring3"] = edit(src, "slices32_ring3", [
        ("constexpr int KS = 64;", "constexpr int KS = 32;"),
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")])
    out["warp64"] = edit(src, "warp64", [
        (rule, "false"),
        ("static constexpr int MIN_BLOCKS = 2 / WC;", "static constexpr int MIN_BLOCKS = 1;"),
        ("static constexpr int PC = 32 * WC;", "static constexpr int PC = 64;"),
        ("constexpr int NT = 4;", "constexpr int NT = 8;")])
    tiles = src[src.index("template <bool B_EXACT>\n__device__ __forceinline__ void mma_tiles"):]
    tiles = tiles[tiles.index("{\n") + 2:tiles.index("\n}\n") + 1]
    out["products_per_tile"] = edit(src, "products_per_tile", [
        (tiles, "#pragma unroll\n  for (int jn = 0; jn < NT; ++jn) {\n"
                "    mma_tf32(part[jn], alo, bhi[jn], part[jn]);\n"
                "    if (!B_EXACT) mma_tf32(part[jn], ahi, blo[jn], part[jn]);\n"
                "    mma_tf32(part[jn], ahi, bhi[jn], part[jn]);\n  }\n")])
    out["x_three"] = edit(src, "x_three", [
        ("constexpr bool X_EXACT = sizeof(XT) == 2;", "constexpr bool X_EXACT = false;")])
    out["one_tf32"] = edit(src, "one_tf32", [
        ("lo = round_tf32(x - __uint_as_float(hi));", "lo = 0u;"),
        ("  for (int jn = 0; jn < NT; ++jn) mma_tf32(part[jn], alo, bhi[jn], part[jn]);\n"
         "  if (!B_EXACT) {\n", "  if (false) {\n")])
    out["rows_balanced"] = edit(src, "rows_balanced", [
        ("  const int m0 = (warp & 7) * 16;   // this warp's rows of y (i) and of the state (n)\n"
         "  const int w0 = (warp >> 3) * 32;  // and its columns in the block's PC\n",
         "  const int q = warp >> 2, k4 = warp & 3;\n"
         "  const int m0 = (WC == 2 ? 2 * (3 - q) + (((k4 >> 1) + q) & 1) : warp) * 16;\n"
         "  const int w0 = WC == 2 ? (k4 & 1) * 32 : 0;\n")])
    out["fast_exp"] = edit(src, "fast_exp", [("* expf(e) * dtc[j]", "* __expf(e) * dtc[j]")])
    for phase, guard in (("intra", "if (m0 >= len || j0 > m0 + 15 || j0 >= len) break;"),
                         ("inter", "if (m0 >= len || n0 >= N) break;"),
                         ("state", "if (m0 >= N || j0 >= len) break;")):
        out[f"no_{phase}"] = edit(src, f"no_{phase}", [(guard, "break;")])
    out["chain_free"] = edit(src, "chain_free", [
        ("  const int bi = blockIdx.z;\n  const int z_first = 0, z_end = p.nch;",
         "  const int bi = blockIdx.z / p.nch;\n"
         "  const int z_first = blockIdx.z % p.nch, z_end = z_first + 1;"),
        ("const dim3 grid((a.P + Geo::PC - 1) / Geo::PC, a.H, a.B);",
         "const dim3 grid((a.P + Geo::PC - 1) / Geo::PC, a.H, a.B * a.nch);")])
    return out


def main() -> None:
    import argparse

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ptxas_report, time_ms  # puts src/ on the path
    from lowrank_update_variants import build_all, spin_time_ms, without_variant
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding an earlier ssd_scan.cu (and its headers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/ssd_scan_variants.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    srcs = sources()
    if args.parent is not None:  # its headers beside it, as #include "..." finds them
        (OUT / "parent").mkdir(parents=True, exist_ok=True)
        for header in args.parent.glob("*.cuh"):
            (OUT / "parent" / header.name).write_text(header.read_text())
        srcs["parent"] = (args.parent / "ssd_scan.cu").read_text()
    fns = {}
    for name, (so, log) in build_all(srcs, "ssd_scan", OUT).items():
        kernels = [(re.sub(r"^void |\(.*$", "", k), r, s) for k, r, s in ptxas_report(log)]
        print(f"{name:10s} " + "; ".join(f"{k} {r} registers, {s} B spilled"
                                         for k, r, s in kernels if "ssd_scan" in k), flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "ssd_scan")
        sig = list(build.SIGNATURES["ssd_scan"])
        # the parent: no workspace and no variant out-argument
        fn.argtypes = sig[:5] + sig[6:-2] + sig[-1:] if name == "parent" else sig
        fn.restype = ctypes.c_int
        fns[name] = fn if name == "parent" else without_variant(fn)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, H, P, N, chunk, bf16 in SHAPES:
        x = torch.randn(B, S, H, P, generator=gen, device="cuda")
        x = x.to(torch.bfloat16) if bf16 else x
        dt = F.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 1.0)
        a = -torch.exp(torch.linspace(0.0, math.log(16.0), H, device="cuda"))
        b = torch.randn(B, S, N, generator=gen, device="cuda")
        c = torch.randn(B, S, N, generator=gen, device="cuda")
        G = ref.ssd_chunk_cumsum(dt, a, chunk)
        want = [w.double() for w in ref.ssd_chunked_scan_ref(x, dt, G, b, c, chunk)]
        y = torch.empty(B, S, H, P, device="cuda")
        state = torch.empty(B, H, N, P, device="cuda")
        cb = torch.empty(B, -(-S // chunk), chunk, -(-chunk // 4) * 4, device="cuda")
        head = (x.data_ptr(), dt.data_ptr(), G.data_ptr(), b.data_ptr(), c.data_ptr())
        tail = (y.data_ptr(), state.data_ptr(), B, S, H, P, N, chunk, int(bf16), stream)

        def raw(fn, *c_args):
            def call():
                if fn(*c_args):
                    sys.exit("launch failed")
                return y, state
            return call

        calls = {name: raw(fn, *head, *tail) if name == "parent" else
                 raw(fn, *head, cb.data_ptr(), *tail) for name, fn in fns.items()}
        calls["wrapper"] = lambda: ssd_scan(x, dt, a, b, c, chunk=chunk)
        calls["plain"] = lambda: ref.ssd_chunked_scan_ref(x, dt, G, b, c, chunk)
        print(f"x{(B, S, H, P)} {'bf16' if bf16 else 'fp32'} N={N} chunk={chunk}:", flush=True)
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            rel = max(float((o.double() - w).abs().max() / w.abs().max())
                      for o, w in zip(got, want))
            print(f"  {name:10s} events {time_ms(call):.4f} ms  spin {spin_time_ms(call):.4f} ms"
                  f"  rel {rel:.1e}", flush=True)
        if bf16:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    calls["wrapper"]()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if "ssd_" in ev.key:
                    us = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
                    print(f"  profiler {ev.key[:60]}: {us / ev.count / 1e3:.4f} ms a call",
                          flush=True)


if __name__ == "__main__":
    main()
