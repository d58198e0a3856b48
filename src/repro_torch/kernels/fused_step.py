"""Fused back-projection epilogue:  out = scale·back_project(P, S) + decay·W.

The write-back of every galore-family step with ``fused_epilogue=True``: the
chain tail's elementwise epilogues (``-lr`` from ``scale_by_lr``, ``+ wd·W``
from ``add_decayed_weights``, GaLore's alpha from ``scale_by_factor``) fold
into the back-projection GEMM's store, one launch per family stack.

The wrapper runs the CUDA kernel (``csrc/back_project_epilogue.cu``) for
CUDA tensors and the plain version in :mod:`repro_torch.kernels.ref` for CPU
tensors — and takes the plain version for no other reason: on a CUDA tensor
it launches the kernel or raises.  ``scale`` and ``decay`` are Python floats
passed by value.  P, S and the output are fp32; W is fp32, or bf16 (a
bf16-stored parameter stack, read as it is stored and widened in the
kernel's epilogue).  Both projection sides run natively, W and the output in
their own ``(L, m, n)`` layout:

  left   p (L, m, r), s (L, r, n), w (L, m, n) or None -> scale·P S + decay·W
  right  p (L, n, r), s (L, m, r), w (L, m, n) or None -> scale·S Pᵀ + decay·W
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref


def back_project_epilogue_batched(
    p: torch.Tensor, s: torch.Tensor, w: Optional[torch.Tensor],
    scale: float, decay: float, *, side: str = "left",
) -> torch.Tensor:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    right = side == "right"
    if s.device.type == "cpu":
        if right:  # S Pᵀ is the left-side product with (S, Pᵀ) as (P, S)
            return ref.back_project_epilogue_ref(s, p.mT, w, scale, decay)
        return ref.back_project_epilogue_ref(p, s, w, scale, decay)
    build.check_operands(s.device, p=p, s=s)
    build.check_operands(s.device, dtypes=(torch.float32, torch.bfloat16), w=w)
    w_bf16 = w is not None and w.dtype == torch.bfloat16
    L, r = p.shape[0], p.shape[-1]
    m, n = (s.shape[1], p.shape[1]) if right else (p.shape[1], s.shape[-1])
    want_s = (L, m, r) if right else (L, r, n)
    if s.shape != want_s or (w is not None and w.shape != (L, m, n)):
        raise ValueError(f"shape mismatch ({side}): p {tuple(p.shape)}, "
                         f"s {tuple(s.shape)}, w {None if w is None else tuple(w.shape)}")
    out = torch.empty((L, m, n), device=s.device, dtype=torch.float32)
    build.launch("back_project_epilogue", s.device, p.data_ptr(), s.data_ptr(),
                 None if w is None else w.data_ptr(), out.data_ptr(),
                 L, m, r, n, int(right), int(w_bf16), float(scale), float(decay))
    return out
