#!/usr/bin/env python3
"""Time variants of the Newton–Schulz kernels ``gram`` and ``poly_apply``
against the ones the port builds, on one NVIDIA GPU, to show what the
design choices of ``src/repro_torch/kernels/csrc/gram.cu``,
``poly_apply.cu`` and their core ``tf32x3_gemm.cuh`` buy.  A measurement
script for the record in PERF.md, not part of the port: a variant raises
when the source no longer has the text it edits.

    python3 tools/newton_schulz_variants.py [--parent DIR]

Each variant is a kernel's source (``tf32x3_gemm.cuh`` and ``tf32x3.cuh``
inlined) with one change made as text, built with the port's own ``nvcc``
flags into ``build/newton_schulz_variants/`` and called through the same C
entry point:

  as_built      the source as it is;
  square        gram over the full square of tiles, no triangle and no
                mirror (the same values up to rounding);
  b_from_host   gram without setting B from A in the kernel (the 64 x 64
                kernel with 4-byte copies then spills);
  one_tf32      one TF32 product, no split (WRONG results: the time bounds
                what 3xTF32 costs);
  parent        with ``--parent DIR``: ``DIR/gram.cu`` and
                ``DIR/poly_apply.cu`` with the headers beside them, an
                earlier version with the same C entry points, for instance
                the fp32 SIMT one unpacked by ``git archive <commit>
                src/repro_torch/kernels/csrc``.

Beside them, the port's Python wrappers and the PyTorch call of the same
function (``bmm`` for X Xᵀ, ``baddbmm`` for a·X + A2 X).  Each is timed as
``chip_smoke.time_ms`` does and with the calls queued behind a spin kernel
(``tools/lowrank_update_variants.spin_time_ms``), and prints max|out -
fp64| / max|fp64| and, for gram, whether the output is exactly symmetric,
at llama-130m's full slots X (4, 768, 2048), its low-rank momenta X (12,
256, 2048), and X (4, 768, 2047), whose rows take the 4-byte copies.
Each variant's registers and spill stores come from ptxas.
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
OUT = ROOT / "build" / "newton_schulz_variants"

# (L, s, n)
SHAPES = [(4, 768, 2048), (12, 256, 2048), (4, 768, 2047)]
A = 3.4445  # Newton-Schulz's a


def edit(src: str, name: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has the text it edits")
        src = src.replace(old, new)
    return src


ONE_TF32 = [
    ("lo = round_tf32(x - __uint_as_float(hi));", "lo = 0u;"),
    ("mma_tf32(part[i][j], alo[i], bhi[j], kk == 0 ? zero : part[i][j]);",
     "mma_tf32(part[i][j], ahi[i], bhi[j], kk == 0 ? zero : part[i][j]);"),
    ("for (int j = 0; j < T::NT; ++j) mma_tf32(part[i][j], ahi[i], blo[j], part[i][j]);",
     "for (int j = 0; j < T::NT; ++j) {}"),
    ("for (int j = 0; j < T::NT; ++j) mma_tf32(part[i][j], ahi[i], bhi[j], part[i][j]);",
     "for (int j = 0; j < T::NT; ++j) {}"),
]


def sources(kernel: str) -> dict[str, str]:
    """The variants of ``kernel`` ("gram" or "poly_apply"), headers inlined."""
    from repro_torch.kernels import build

    helpers = (build.CSRC / "tf32x3.cuh").read_text().replace("#pragma once\n", "")
    core = ((build.CSRC / "tf32x3_gemm.cuh").read_text().replace("#pragma once\n", "")
            .replace('#include "tf32x3.cuh"\n', helpers))
    src = (build.CSRC / f"{kernel}.cu").read_text().replace('#include "tf32x3_gemm.cuh"\n',
                                                             core)
    out = {"as_built": src, "one_tf32": edit(src, "one_tf32", ONE_TF32)}
    if kernel == "gram":
        out["square"] = edit(src, "square", [
            ("gemm_tile<B, B, true, true, VEC, true>(p);",
             "gemm_tile<B, B, true, true, VEC, false>(p);"),
            ("launch<kernel, Tile<B, B, true, true>, true>(p, L, stream);",
             "launch<kernel, Tile<B, B, true, true>>(p, L, stream);")])
        out["b_from_host"] = edit(src, "b_from_host", [
            ("  p.b = p.a;\n  p.ldb = p.lda;\n  p.b_batch = p.a_batch;\n", "")])
    return out


def main() -> None:
    import argparse

    import torch

    from chip_smoke import time_ms  # puts src/ on the path
    from lowrank_update_variants import build_all, spin_time_ms, without_variant
    from repro_torch.kernels import build
    from repro_torch.kernels.newton_schulz import gram, poly_matmul_axpy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding an earlier gram.cu and poly_apply.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/newton_schulz_variants.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fns = {}
    for kernel in ("gram", "poly_apply"):
        srcs = sources(kernel)
        if args.parent is not None:  # its headers beside it, as #include "..." finds them
            (OUT / kernel / "parent").mkdir(parents=True, exist_ok=True)
            for header in args.parent.glob("*.cuh"):
                (OUT / kernel / "parent" / header.name).write_text(header.read_text())
            srcs["parent"] = (args.parent / f"{kernel}.cu").read_text()
        for name, (so, log) in build_all(srcs, kernel, OUT / kernel).items():
            # {mangled template arguments (none for the parent): registers a thread}
            regs = {targs[:12] or "-": int(n) for targs, n in re.findall(
                r"entry function '\w*?_kernel(\w*)'.*?Used (\d+) registers", log, re.S)}
            spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
            print(f"{kernel:10s} {name:12s} registers {regs}, spill stores {spills} bytes",
                  flush=True)
            fn = getattr(ctypes.CDLL(str(so)), kernel)
            sig = list(build.SIGNATURES[kernel])
            fn.argtypes = sig[:-2] + sig[-1:] if name == "parent" else sig  # no variant
            fn.restype = ctypes.c_int
            fns[kernel, name] = fn if name == "parent" else without_variant(fn)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def run(label, calls, want, symmetric=False):
        print(f"{label}:", flush=True)
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            rel = float((got.double() - want).abs().max() / want.abs().max())
            sym = f"  symmetric {bool(torch.equal(got, got.mT))}" if symmetric else ""
            print(f"  {name:12s} events {time_ms(call):.4f} ms  spin {spin_time_ms(call):.4f} ms"
                  f"  rel {rel:.1e}{sym}", flush=True)

    def raw(fn, out, *c_args):
        def call():
            if fn(*c_args, stream):
                sys.exit("launch failed")
            return out
        return call

    for L, s, n in SHAPES:
        x = torch.randn(L, s, n, generator=gen, device="cuda")
        x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
        g = torch.empty(L, s, s, device="cuda")
        calls = {name: raw(fn, g, x.data_ptr(), g.data_ptr(), L, s, n)
                 for (k, name), fn in fns.items() if k == "gram"}
        calls["wrapper"] = lambda: gram(x)
        calls["library"] = lambda: torch.bmm(x, x.mT)
        xd = x.double()
        run(f"gram X{(L, s, n)}", calls, xd @ xd.mT, symmetric=True)
        gd = xd @ xd.mT
        a2 = (-4.7750 * gd + 2.0315 * (gd @ gd)).float()
        y = torch.empty(L, s, n, device="cuda")
        calls = {name: raw(fn, y, a2.data_ptr(), x.data_ptr(), y.data_ptr(), L, s, n, A)
                 for (k, name), fn in fns.items() if k == "poly_apply"}
        calls["wrapper"] = lambda: poly_matmul_axpy(a2, x, A)
        calls["library"] = lambda: torch.baddbmm(x, a2, x, beta=A)
        run(f"poly_apply A2{(L, s, s)} X{(L, s, n)}", calls, A * xd + a2.double() @ xd)


if __name__ == "__main__":
    main()
