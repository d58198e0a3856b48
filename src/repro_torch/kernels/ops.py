"""Public attention, SSD and optimizer ops with the JAX package's ``impl``
names (the port of its ``kernels/ops.py``).

``impl`` for :func:`attention` and :func:`ssd` (``cfg.attn_impl``):
  "xla"          — the plain full-sequence version (``ref.attention_ref``,
                   ``ref.ssd_chunked_ref``), plain torch on either device.
  "xla_chunked"  — attention: the flash algorithm in plain torch
                   (``ref.attention_chunked_ref``, kv blocks of 512).
  "pallas"       — the kernel: resolved like ``dispatch.resolve_impl("auto",
                   x)``, the CUDA kernel on a CUDA tensor and its plain
                   version on a CPU tensor.
As in the reference, :func:`ssd` runs the kernel for every impl but "xla"
(``models/mamba2.py`` passes "xla" through and any other name on).  Decode
has no kernel in the reference either: :func:`decode_attention` and
:func:`ssd_decode_step` are the plain versions.  :func:`newton_schulz` and
:func:`lowrank_update` take "xla" for the plain version and hand any other
name to :mod:`repro_torch.kernels.dispatch` ("pallas" as "auto").  The kernel ops are not
dispatch ops: ``launch_count.DISPATCH_OPS`` keeps the reference's optimizer
vocabulary, and the kernels count their launches in ``build.LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

ATTN_IMPLS = ("xla", "xla_chunked", "pallas")


def check_impl(impl: str) -> None:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              impl: str = "xla") -> torch.Tensor:
    check_impl(impl)
    if impl == "xla":
        return ref.attention_ref(q, k, v, causal=causal)
    if impl == "xla_chunked":
        return ref.attention_chunked_ref(q, k, v, causal=causal, block_kv=512)
    return flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, pos) -> torch.Tensor:
    """One query token per row over the (B, Smax, KV, D) cache, positions
    0..pos of each row (``pos`` an int or (B,))."""
    return ref.decode_attention_ref(q, k, v, pos)


def _dispatch_impl(impl: str) -> str:
    return "auto" if impl == "pallas" else impl


def newton_schulz(x: torch.Tensor, *, steps: int = 5, impl: str = "xla") -> torch.Tensor:
    """Batched (…, m, n) Newton–Schulz."""
    if impl == "xla":
        from repro_torch.core.newton_schulz import newton_schulz_plain

        return newton_schulz_plain(x, steps=steps)
    return dispatch.newton_schulz(x, steps=steps, impl=_dispatch_impl(impl))


def lowrank_update(p: torch.Tensor, g: torch.Tensor, r_state: torch.Tensor, beta: float,
                   coeff: float, *, impl: str = "xla") -> torch.Tensor:
    """``beta·R + coeff·PᵀG`` for p (L, m, r), g (L, m, n), R (L, r, n)."""
    if impl == "xla":
        return ref.lowrank_update_ref(p, g, r_state, beta, coeff)
    return dispatch.lowrank_update(p, g, r_state, beta, coeff, impl=_dispatch_impl(impl))


def ssd(x, dt, a, b, c, d, *, chunk: int = 64,
        impl: str = "xla") -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD over a full sequence; returns (y in x's dtype, final
    state fp32)."""
    check_impl(impl)
    if impl == "xla":
        return ref.ssd_chunked_ref(x, dt, a, b, c, d, chunk)
    y, state = ssd_scan(x, dt, a, b, c, chunk=chunk)
    y = y + d[None, None, :, None] * x.to(torch.float32)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, a, b, c, d):
    return ref.ssd_decode_ref(state, x, dt, a, b, c, d)
