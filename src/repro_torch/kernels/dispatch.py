"""Kernel dispatch: route the optimizer's hot ops to the CUDA kernels or
to their plain PyTorch versions.

Mirrors the JAX package's ``kernels/dispatch.py`` op for op:

  impl="auto"  — the CUDA kernel for CUDA tensors, plain PyTorch for CPU
                 tensors (default).
  impl="cuda"  — the CUDA kernel; raises for CPU tensors.
  impl="torch" — plain PyTorch; raises for CUDA tensors.

There is no quiet fallback: on a CUDA tensor an op launches its kernel or
raises, whatever the shape — the kernels mask ragged edges themselves, so
there are no shape-legality limits.  ``pad_rank_to > 0`` (the reference's
opt-in lane alignment) zero-pads the rank axis to a multiple of
:func:`_rank_granule` before the momentum update, the projection and both
back-projections, and slices the pad off after, on either impl: zero
projector columns add zero rows to PᵀG and nothing to P S, so the numbers
are those of ``pad_rank_to=0``, which pads nothing.  On top of the
kernels' ``(L, a, b)`` contract the dispatchers add lead flattening of
``(*lead, m, n)`` families and Newton–Schulz's transposition to the short
side.  The momentum update, the projection, the back-projection and the
fused epilogue take both sides natively, so their dispatchers only flatten
leads (the JAX ones transpose the right side).  ``KernelEntry`` /
:data:`REGISTRY` name each op with its plain reference; names must be in
``launch_count.DISPATCH_OPS``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import launch_count, ref
from repro_torch.kernels.fused_step import back_project_epilogue_batched
from repro_torch.kernels.lowrank_update import (
    back_project_batched,
    lowrank_update_batched,
    project_batched,
)
from repro_torch.kernels.newton_schulz import newton_schulz_cuda

VALID_IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``impl`` for an op on tensor ``x``: "cuda" or "torch"."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    on_cuda = x.device.type == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    if impl == "torch" and on_cuda:
        raise ValueError("impl='torch' on a CUDA tensor: the port runs its "
                         "CUDA kernels on the card (use 'auto' or 'cuda')")
    return impl


def _check_side(side: str) -> None:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")


def _flatten_lead(x: torch.Tensor) -> torch.Tensor:
    """(*lead, a, b) -> contiguous (L, a, b)."""
    return x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


_SUBLANE = 8  # the reference's fp32 sublane granule


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _rank_granule(pad_rank_to: int) -> int:
    """The multiple the rank axis is padded to: ``pad_rank_to`` rounded up
    to the 8-row granule (e.g. 128: r = 96 runs at 128).  At 0 the
    reference pads to the granule itself, which the CUDA kernels do not
    need (they mask ragged edges), so the port pads nothing there."""
    if pad_rank_to < 0:
        raise ValueError(f"pad_rank_to must be >= 0, got {pad_rank_to}")
    return max(_SUBLANE, _round_up(pad_rank_to, _SUBLANE)) if pad_rank_to else _SUBLANE


def _padded_rank(r: int, pad_rank_to: int) -> int:
    granule = _rank_granule(pad_rank_to)
    return _round_up(r, granule) if pad_rank_to else r


def _pad_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` (negative) to ``size``."""
    if x.shape[axis] == size:
        return x
    widths = [0, 0] * (-axis - 1) + [0, size - x.shape[axis]]
    return torch.nn.functional.pad(x, widths)


def _unpad(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    return x if x.shape[axis] == size else x.narrow(axis, 0, size).contiguous()


def _rank_axis(side: str) -> int:
    """The rank axis of a projected-space array: (r, n) left, (m, r) right."""
    return -2 if side == "left" else -1


# --------------------------------------------------------------------------
# Fused low-rank momentum update:  R' = beta·R + coeff·<P, G>
# --------------------------------------------------------------------------


def _project_torch(p, g, side):
    from repro_torch.core.lowrank_common import project

    return project(_f32(p), _f32(g), side)


def lowrank_update(p, g, r_state, beta: float, coeff: float, *,
                   side: str = "left", impl: str = "auto",
                   pad_rank_to: int = 0) -> torch.Tensor:
    """Dispatched momentum update over a family ``g (*lead, m, n)``.

    left  side: p (*lead, m, r), r_state (*lead, r, n) -> beta·R + coeff·PᵀG
    right side: p (*lead, n, r), r_state (*lead, m, r) -> beta·R + coeff·G P
    """
    _check_side(side)
    impl = resolve_impl(impl, g)
    launch_count.record("lowrank_update")
    r, axis = p.shape[-1], _rank_axis(side)
    rp = _padded_rank(r, pad_rank_to)
    p = _pad_axis(p, -1, rp)
    if r_state is not None:
        r_state = _pad_axis(r_state, axis, rp)
    if impl == "torch":
        return _unpad(beta * _f32(r_state) + coeff * _project_torch(p, g, side), axis, r)
    # Leads flatten; both sides keep their own layout (the kernel takes the
    # right side natively).
    rk = None if r_state is None else _flatten_lead(_f32(r_state))
    out = lowrank_update_batched(_flatten_lead(_f32(p)), _flatten_lead(_f32(g)), rk,
                                 beta, coeff, side=side)
    return _unpad(out.reshape(tuple(g.shape[:-2]) + tuple(out.shape[-2:])), axis, r)


def project(p, g, *, side: str = "left", impl: str = "auto",
            pad_rank_to: int = 0) -> torch.Tensor:
    """Low-rank projection PᵀG / G P through the projection kernel."""
    _check_side(side)
    impl = resolve_impl(impl, g)
    launch_count.record("project")
    r, axis = p.shape[-1], _rank_axis(side)
    p = _pad_axis(p, -1, _padded_rank(r, pad_rank_to))
    if impl == "torch":
        return _unpad(_project_torch(p, g, side), axis, r)
    out = project_batched(_flatten_lead(_f32(p)), _flatten_lead(_f32(g)), side=side)
    return _unpad(out.reshape(tuple(g.shape[:-2]) + tuple(out.shape[-2:])), axis, r)


# --------------------------------------------------------------------------
# Back-projection GEMM:  P @ S  /  S @ Pᵀ
# --------------------------------------------------------------------------


def _pad_rank_pair(p, s, side: str, pad_rank_to: int):
    """P and the projected-space S, both zero-padded on the rank axis."""
    rp = _padded_rank(p.shape[-1], pad_rank_to)
    return _pad_axis(p, -1, rp), _pad_axis(s, _rank_axis(side), rp)


def back_project(p, s, *, side: str = "left", impl: str = "auto",
                 pad_rank_to: int = 0) -> torch.Tensor:
    """Dispatched back-projection of a projected-space array to full shape.

    left  side: p (*lead, m, r), s (*lead, r, n) -> P @ S
    right side: p (*lead, n, r), s (*lead, m, r) -> S @ Pᵀ
    """
    _check_side(side)
    impl = resolve_impl(impl, s)
    launch_count.record("back_project")
    p, s = _pad_rank_pair(p, s, side, pad_rank_to)
    if impl == "torch":
        from repro_torch.core.lowrank_common import back_project as bp

        return bp(_f32(p), _f32(s), side)
    out = back_project_batched(_flatten_lead(_f32(p)), _flatten_lead(_f32(s)), side=side)
    return out.reshape(tuple(s.shape[:-2]) + tuple(out.shape[-2:]))


def back_project_epilogue(p, s, *, w=None, scale: float = 1.0, decay: float = 0.0,
                          side: str = "left", impl: str = "auto",
                          pad_rank_to: int = 0) -> torch.Tensor:
    """Fused write-back of a projected-space update, ``scale·back_project(p,
    s) + decay·W`` in one launch (see :mod:`repro_torch.kernels.fused_step`):
    the materialization of ``combinators.PendingBack``, where scale carries
    -lr (and GaLore's alpha), decay -lr·wd and ``w`` the (family-stacked)
    params; a bf16 ``w`` (bf16-stored params) reaches the kernel as it is,
    any other dtype as fp32.

    left  side: p (*lead, m, r), s (*lead, r, n), w (*lead, m, n) or None
    right side: p (*lead, n, r), s (*lead, m, r), w (*lead, m, n) or None
    """
    _check_side(side)
    impl = resolve_impl(impl, s)
    launch_count.record("back_project_epilogue")
    p, s = _pad_rank_pair(p, s, side, pad_rank_to)
    if impl == "torch":
        from repro_torch.core.lowrank_common import back_project as bp

        out = scale * bp(_f32(p), _f32(s), side)
        if w is not None:
            out = out + decay * _f32(w)
        return out
    lead = tuple(s.shape[:-2])
    if w is not None and w.dtype != torch.bfloat16:  # bf16 W is read as stored
        w = _f32(w)
    out = back_project_epilogue_batched(
        _flatten_lead(_f32(p)), _flatten_lead(_f32(s)),
        None if w is None else _flatten_lead(w), scale, decay, side=side)
    return out.reshape(lead + tuple(out.shape[-2:]))


# --------------------------------------------------------------------------
# Newton–Schulz orthogonalization
# --------------------------------------------------------------------------


def newton_schulz(x: torch.Tensor, *, steps: int = 5, eps: float = 1e-7,
                  impl: str = "auto") -> torch.Tensor:
    """Dispatched Newton–Schulz over (..., m, n): the CUDA kernels, or
    :func:`repro_torch.core.newton_schulz.newton_schulz_plain` (Frobenius
    normalisation, ``steps`` quintic iterations, transposed when m > n)."""
    from repro_torch.core.newton_schulz import newton_schulz_plain

    launch_count.record("newton_schulz")
    if resolve_impl(impl, x) == "torch":
        return newton_schulz_plain(x, steps=steps, eps=eps)
    orig_dtype = x.dtype
    lead = tuple(x.shape[:-2])
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.mT
    out = newton_schulz_cuda(_flatten_lead(_f32(x)), steps=steps, eps=eps)
    out = out.reshape(lead + tuple(out.shape[-2:]))
    if transposed:
        out = out.mT
    return out.to(orig_dtype)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One dispatched op: its entry point and its plain reference."""

    name: str
    fn: Callable         # dispatching wrapper; accepts impl=
    reference: Callable  # plain PyTorch version (repro_torch.kernels.ref)


REGISTRY: dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> KernelEntry:
    if entry.name not in launch_count.DISPATCH_OPS:
        raise ValueError(
            f"kernel name {entry.name!r} is not in launch_count.DISPATCH_OPS "
            f"{launch_count.DISPATCH_OPS}: the op vocabulary is closed")
    REGISTRY[entry.name] = entry
    return entry


def get_kernel(name: str) -> KernelEntry:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: {sorted(REGISTRY)}") from None


def _newton_schulz_ref(x, *, steps=5, eps=1e-7):
    from repro_torch.core.newton_schulz import newton_schulz_plain

    return newton_schulz_plain(x, steps=steps, eps=eps)


register(KernelEntry("lowrank_update", lowrank_update, ref.lowrank_update_ref))
register(KernelEntry("project", project, ref.project_ref))
register(KernelEntry("back_project", back_project, ref.back_project_ref))
register(KernelEntry("back_project_epilogue", back_project_epilogue,
                     ref.back_project_epilogue_ref))
register(KernelEntry("newton_schulz", newton_schulz, _newton_schulz_ref))
