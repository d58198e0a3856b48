#!/usr/bin/env python3
"""Which ops of the optimizer's path give a matrix of a family stack a result
that depends on the stack around it, on one NVIDIA GPU: the evidence for why
a ZeRO-split family (a rank's rows of the stack, ``shard_state``) is not
bitwise the whole stack on the card, and what the alternative would cost.
Newton–Schulz normalises by a batched ``torch.linalg.vector_norm``, whose
rounding depends on the stack height there; a multi-tensor norm
(``torch._foreach_norm`` over the matrices, :func:`foreach_norms`) does not,
but costs more.  A measurement script for the record in PERF.md, not part of
the port.

    python3 tools/ns_norm_stack_invariance.py

For each stack that fused GUM's steps hand Newton–Schulz at llama-130m
(rank 256, gamma 4), and for rows 1–5, ``g @ g`` and the svd projector at
the family stacks, it compares the op on the whole stack with the op on
its halves, its quarters and each matrix alone (contiguous copies and
slices), and prints, per piece size, whether the pieces' results are
bitwise the whole stack's, and the largest difference.  Then it times the
two norms (a CUDA-event pair around 20 calls after 3 warm-ups) and sums
their time over one fused step's stacks.  Last, a step A/B: ``chip_smoke``
phase 4's GUM step at llama-130m (8 x 1024, rank 256, gamma 4, no refresh),
per leaf and with ``fuse_families``, 16 steps after one warm-up with
Newton–Schulz normed one way or the other in the order new, old, old, new,
each step timed on the host around a synchronize; it prints the median and
every step's ms of each.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))  # chip_smoke, for phase 4's data

# Fused GUM at llama-130m, rank 256, gamma 4: the projected momenta of the
# attention, MLP-in and w_down stacks (transposed to s <= n) and the slots.
NS_STACKS = [(48, 256, 768), (24, 256, 2048), (12, 256, 2048), (16, 768, 768),
             (8, 768, 2048), (4, 768, 2048)]
# (L, m, n) family stacks for rows 1-3 and the svd projector.
FAMILIES = [(48, 768, 768), (24, 768, 2048), (12, 2048, 768)]
RANK = 256


def pieces(x):
    """The stack cut into halves, quarters and single matrices, as
    contiguous copies and as slices."""
    L = x.shape[0]
    out = []
    for parts in (2, 4, L):
        if L % parts:
            continue
        c = L // parts
        out.append([x[i * c:(i + 1) * c] for i in range(parts)])
        out.append([x[i * c:(i + 1) * c].contiguous() for i in range(parts)])
    return out


def invariant(torch, fn, *xs) -> dict:
    """``{piece size: bitwise the whole stack}`` over :func:`pieces`, and
    the largest difference under ``"max"``."""
    whole = fn(*xs)
    out, worst = {}, 0.0
    for cut in zip(*(pieces(x) for x in xs)):
        got = torch.cat([fn(*args) for args in zip(*cut)])
        size = cut[0][0].shape[0]
        out[size] = out.get(size, True) and torch.equal(got, whole)
        worst = max(worst, float((got - whole).abs().max()))
    return out | {"max": worst}


def foreach_norms(x):
    """Each matrix's Frobenius norm, ``(L, 1, 1)``, by the multi-tensor
    norm: it cuts each matrix into fixed chunks and adds their sums in
    order, so its result depends on the matrix alone."""
    import torch

    return torch.stack(torch._foreach_norm(list(x.unbind(0)))).reshape(-1, 1, 1)


def newton_schulz_foreach(x, *, steps: int = 5, eps: float = 1e-7):
    """``kernels.newton_schulz.newton_schulz_cuda`` normed by
    :func:`foreach_norms`."""
    import torch

    from repro_torch.kernels.newton_schulz import ns_iteration

    x = x.to(torch.float32)
    x = x / (foreach_norms(x) + eps)
    for _ in range(steps):
        x = ns_iteration(x)
    return x


def step_ab(torch, dispatch) -> None:
    """Phase 4's steady GUM step with each normalisation (see the module
    docstring)."""
    import statistics
    import time

    import chip_smoke as cs
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.data import build_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    batched = dispatch.newton_schulz_cuda
    cfg, data = cs.llama130m_data()
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    batch = {"tokens": torch.from_numpy(next(build_stream(data))).cuda()}
    for fuse in (False, True):
        opt = build_optimizer(OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4,
                                              period=1000, fuse_families=fuse))
        params = model.params()
        state = opt.init({k: p.detach() for k, p in params.items()})
        step = make_train_step(model, opt)
        state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        times = {"foreach_norms": [], "vector_norm": []}
        try:
            for i in range(16):
                which = ("foreach_norms", "vector_norm", "vector_norm", "foreach_norms")[i % 4]
                dispatch.newton_schulz_cuda = (newton_schulz_foreach
                                               if which == "foreach_norms" else batched)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(params, state, batch)
                float(m["loss"])
                torch.cuda.synchronize()
                times[which].append((time.perf_counter() - t0) * 1e3)
        finally:
            dispatch.newton_schulz_cuda = batched
        print(f"step A/B, fuse_families={fuse}: " + "; ".join(
            f"{k} median {statistics.median(v):.3f} ms, steps {[round(t, 2) for t in v]}"
            for k, v in times.items()), flush=True)


def time_ms(torch, fn, x, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.lowrank_common import compute_projectors
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.newton_schulz import gram, poly_matmul_axpy

    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {smi.strip()} | torch {torch.__version__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batched(x):
        return torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)

    totals = {"vector_norm": 0.0, "foreach_norms": 0.0}
    for shape in NS_STACKS:
        x = torch.randn(*shape, device="cuda", generator=gen)
        g = gram(x)
        row = {"vector_norm": invariant(torch, batched, x),
               "foreach_norms": invariant(torch, foreach_norms, x),
               "newton_schulz": invariant(torch, dispatch.newton_schulz, x),
               "gram": invariant(torch, gram, x), "g @ g": invariant(torch, lambda t: t @ t, g),
               "poly_apply": invariant(torch, lambda a, t: poly_matmul_axpy(a, t, 3.4445), g, x)}
        ms = {k: time_ms(torch, f, x) for k, f in (("vector_norm", batched),
                                                    ("foreach_norms", foreach_norms))}
        for k, v in ms.items():
            totals[k] += v
        print(f"NS stack {shape}: bitwise / max diff {row}; ms {ms}", flush=True)
    print(f"one fused GUM step's norms (ms): {totals}", flush=True)

    for L, m, n in FAMILIES:
        side = "left" if m <= n else "right"
        s = m if side == "left" else n
        p = torch.linalg.qr(torch.randn(L, s, RANK, device="cuda", generator=gen)).Q
        g = torch.randn(L, m, n, device="cuda", generator=gen)
        r = dispatch.project(p, g, side=side)
        row = {"project": invariant(torch, lambda a, b: dispatch.project(a, b, side=side), p, g),
               "lowrank_update": invariant(torch, lambda a, b, c: dispatch.lowrank_update(
                   a, b, c, 0.95, 1.3, side=side), p, g, r),
               "back_project": invariant(torch, lambda a, b: dispatch.back_project(
                   a, b, side=side), p, r),
               "svd projector": invariant(torch, lambda t: compute_projectors(
                   "svd", t, RANK, side), g)}
        print(f"family {(L, m, n)}: bitwise / max diff {row}", flush=True)
    step_ab(torch, dispatch)


if __name__ == "__main__":
    main()
