#!/usr/bin/env python3
"""Time variants of the ``lowrank_update`` kernel against the one the port
builds, on one NVIDIA GPU, to show what each design choice of
``src/repro_torch/kernels/csrc/lowrank_update.cu`` and of the core it runs
on, ``csrc/tf32x3_gemm.cuh``, buys.  A measurement script for the record in
PERF.md, not part of the port: a variant raises when the source no longer
has the text it edits.

    python3 tools/lowrank_update_variants.py [--parent DIR]

Each variant is the kernel's source with one change made as text, built
with the port's own ``nvcc`` flags into ``build/lowrank_update_variants/``
and called through the same C entry point:

  as_built         the source as it is;
  slices16_ring4   16-deep slices in a 4-stage ring (the first design);
  one_accumulator  no per-slice sums: the tensor cores add every product
                   into one accumulator, so their truncation biases the sum;
  cvt_rna          the split by ``cvt.rna.tf32.f32`` instead of integer
                   rounding (the same values);
  no_split         no split arithmetic at all (WRONG results: the time
                   bounds what the split costs);
  parent           with ``--parent DIR``: ``DIR/lowrank_update.cu``, an
                   earlier left-side-only version of the kernel (C entry
                   point without the side argument), for instance the fp32
                   SIMT one unpacked by ``git archive <commit>
                   src/repro_torch/kernels/csrc``; timed on the left only.

Beside them, the port's Python wrapper (``lowrank_update_batched``) and the
PyTorch call of the same function (``baddbmm`` with R, ``bmm`` without).
Each is timed two ways, as the median of 20 calls:

  events  a pair of CUDA events around each call, as ``chip_smoke.time_ms``
          does: when the host launches more slowly than the card runs, the
          host's launch cost lands inside the pair;
  spin    the same, with the calls queued behind a spin kernel
          (``torch.cuda._sleep``) that outlasts their launches, so the
          events time the card's work alone;

and the host's microseconds a call (200 calls launched back to back).  It
prints max|out - fp64| / max|fp64| at llama-130m's main shapes, then, from
``cuobjdump -sass``, the instructions in the main loop of the 64 x 64
left-side kernel and how many of them are HMMA.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "lowrank_update_variants"

# (L, m, r, n, side, with R): row 1, row 2, GUM's w_out update on the right,
# GaLore's mlp family projection, and a left-side projection over m = 2048
# (a reduction 2.7 times as deep).
SHAPES = [(12, 768, 256, 2048, 0, True), (4, 768, 256, 2048, 0, False),
          (12, 2048, 256, 768, 1, True), (24, 768, 256, 2048, 0, False),
          (4, 2048, 256, 768, 0, False)]


def variants(src: str) -> dict[str, str]:
    split = src[src.index("__device__ __forceinline__ void split_tf32"):]
    split = split[:split.index("\n}\n") + 2]

    def body(hi: str, lo: str) -> str:
        return ("__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, "
                f"uint32_t& lo) {{\n{hi}\n{lo}\n}}")

    cvt = body('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));',
               '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')
    first = "mma_tf32(part[i][j], alo[i], bhi[j], kk == 0 ? zero : part[i][j]);"
    one_acc = (src.replace(first, "mma_tf32(part[i][j], alo[i], bhi[j], "
                                  "(kk == 0 && kt == 0) ? zero : part[i][j]);")
               .replace("acc[i][j][v] += part[i][j][v];", "acc[i][j][v] = part[i][j][v];")
               .replace("    float part[T::MT][T::NT][4];\n", "")
               .replace("  float acc[T::MT][T::NT][4];",
                        "  float acc[T::MT][T::NT][4];\n  float part[T::MT][T::NT][4];"))
    out = {
        "as_built": src,
        "slices16_ring4": src.replace("constexpr int BK = 32;", "constexpr int BK = 16;")
                             .replace("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
        "one_accumulator": one_acc,
        "cvt_rna": src.replace(split, cvt),
        "no_split": src.replace(split, body("  hi = __float_as_uint(x);", "  lo = hi;")),
    }
    for name, text in out.items():
        if name != "as_built" and text == src:
            raise RuntimeError(f"variant {name}: the source no longer has the text it edits")
    return out


def loop_mix(so: Path, cuobjdump: str) -> str:
    """Instructions between the barrier and the backward branch of the
    64 x 64 left-side (16-byte copy) kernel's main loop."""
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        if "lowrank_update_kernelILi64ELi64ELb0ELb1E" not in func.split("\n")[0]:
            continue
        lines = [l for l in func.split("\n") if re.match(r"\s+/\*[0-9a-f]{4}\*/", l)]
        mma = [i for i, l in enumerate(lines) if "HMMA" in l]
        start = max(i for i, l in enumerate(lines) if "BAR.SYNC" in l and i < mma[0])
        end = next(i for i in range(mma[-1], len(lines)) if "BRA" in lines[i])
        return f"main loop {end - start + 1} instructions, {len(mma)} HMMA"
    return "main loop not found"


def without_variant(fn):
    """A raw C entry point ``fn`` (argument types ``build.SIGNATURES``) as
    a function of its arguments and the stream, passing a null variant
    out-argument."""
    return lambda *args: fn(*args[:-1], None, args[-1])


def spin_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """``chip_smoke.time_ms`` with the timed calls queued behind a spin
    kernel that lasts about 1.5 times as long as the host takes to launch
    them, so the events time the card's work back to back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(max(1.5 * iters * (time.perf_counter() - t0), 1e-3), 0.05)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(int(spin_s * 2e9))  # cycles at up to 2 GHz
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds a call over ``calls`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def build_all(sources: dict[str, str], kernel: str = "lowrank_update",
              out_dir: Path = OUT) -> dict[str, tuple[Path, str]]:
    """Compile each ``{name: source}`` of ``kernel`` at once, each into
    ``out_dir/name/``; ``{name: (.so, log)}``."""
    from repro_torch.kernels import build

    procs = {}
    for name, text in sources.items():
        cu, so = out_dir / name / f"{kernel}.cu", out_dir / name / f"lib{kernel}.so"
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed\n{log}")
        out[name] = (so, log)
    return out


def main() -> None:
    import argparse

    import torch

    from chip_smoke import time_ms  # puts src/ on the path
    from repro_torch.kernels import build
    from repro_torch.kernels.lowrank_update import lowrank_update_batched

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding an earlier lowrank_update.cu (and its headers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/lowrank_update_variants.py: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    # The main loop lives in tf32x3_gemm.cuh and the split and the mma in
    # tf32x3.cuh: inline both, so that the variants can edit them and each
    # source builds on its own.
    header = (build.CSRC / "tf32x3.cuh").read_text().replace("#pragma once\n", "")
    core = ((build.CSRC / "tf32x3_gemm.cuh").read_text().replace("#pragma once\n", "")
            .replace('#include "tf32x3.cuh"\n', header))
    src = (build.CSRC / "lowrank_update.cu").read_text().replace(
        '#include "tf32x3_gemm.cuh"\n', core)
    sources = variants(src)
    if args.parent is not None:  # its headers beside it, as #include "..." finds them
        (OUT / "parent").mkdir(parents=True, exist_ok=True)
        for header in args.parent.glob("*.cuh"):
            (OUT / "parent" / header.name).write_text(header.read_text())
        sources["parent"] = (args.parent / "lowrank_update.cu").read_text()
    cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
    fns = {}
    for name, (so, log) in build_all(sources).items():
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers", log)})
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        mix = "" if name == "parent" else "; " + loop_mix(so, cuobjdump)
        print(f"{name:16s} registers {regs}, spill stores {spills} bytes{mix}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "lowrank_update")
        sig = list(build.SIGNATURES["lowrank_update"])
        # the parent: no side and no variant out-argument
        fn.argtypes = sig[:-3] + sig[-1:] if name == "parent" else sig
        fn.restype = ctypes.c_int
        fns[name] = fn if name == "parent" else without_variant(fn)

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for L, m, r, n, side, with_r in SHAPES:
        p = torch.randn(L, n if side else m, r, generator=gen, device="cuda")
        g = torch.randn(L, m, n, generator=gen, device="cuda")
        out_shape = (L, m, r) if side else (L, r, n)
        rs = torch.randn(*out_shape, generator=gen, device="cuda") if with_r else None
        out = torch.empty(out_shape, device="cuda")
        coeff = 1.5 if with_r else 1.0  # as chip_smoke: bmm is the library call without R
        want = g.double() @ p.double() if side else p.double().mT @ g.double()
        want = coeff * want + (0.95 * rs.double() if with_r else 0.0)
        c_args = (p.data_ptr(), g.data_ptr(), None if rs is None else rs.data_ptr(),
                  out.data_ptr(), L, m, r, n, 0.95, coeff)

        def raw(fn, *tail):
            def call():
                if fn(*c_args, *tail):
                    sys.exit("launch failed")
                return out
            return call

        calls = {name: raw(fn, stream) if name == "parent" else raw(fn, side, stream)
                 for name, fn in fns.items() if not (name == "parent" and side)}
        sname = "right" if side else "left"
        calls["wrapper"] = lambda: lowrank_update_batched(p, g, rs, 0.95, coeff, side=sname)
        a, b = (g, p) if side else (p.mT, g)
        calls["library"] = ((lambda: torch.baddbmm(rs, a, b, beta=0.95, alpha=coeff))
                            if with_r else (lambda: torch.bmm(a, b)))
        print(f"{sname} L={L} m={m} r={r} n={n} R={with_r}:", flush=True)
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            rel = float((got.double() - want).abs().max() / want.abs().max())
            print(f"  {name:16s} events {time_ms(call):.4f} ms  spin {spin_time_ms(call):.4f} ms"
                  f"  host {host_us(call):.1f} us/call  rel {rel:.1e}", flush=True)


if __name__ == "__main__":
    main()
