"""Causal GQA flash attention (kernel row 7), forward only.

``flash_attention(q, k, v)`` runs the CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`) for CPU tensors — and
takes the plain version for no other reason: on a CUDA tensor it launches
the kernel or raises.  Layouts follow the JAX package's
``kernels/flash_attention.py``: q (B, S, H, D), k/v (B, T, KV, D) with
H % KV == 0, out (B, S, H, D); under ``causal`` the S queries are the last S
of the T keys.  q, k and v share one dtype, fp32, bf16 or fp16, and the
output is in it; inside, as in the Pallas kernel, the scores, the online
softmax, P and the accumulator are fp32, rounded only at the store.  The
kernel takes D % 4 == 0 and D <= 256 (padded to 16, 32, 64, 128, 192 or 256
in shared memory: nemotron-4-340b's head dim is 192), ragged S and T (the
reference asks for multiples of its blocks), and 16-bit operands on 4-byte
boundaries; on a CUDA tensor any other D raises.

Like the Pallas kernel it has no backward: a call that autograd would
record raises, on either device, instead of returning a result whose
gradient is silently missing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

MAX_HEAD_DIM = 256
# The element types the kernel is instantiated for, by the code its C entry
# point takes.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_operands(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != (B, T, KV, D) or v.shape != k.shape or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (need k == v == (B, T, KV, D), H % KV == 0)")
    if causal and S > T:
        raise ValueError(f"causal attention needs S <= T, got S={S}, T={T}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"q, k, v must share one dtype of "
                                  f"{[str(d)[6:] for d in DTYPES]}, got {q.dtype}, "
                                  f"{k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention is forward-only (as the reference "
                                  "kernel); run it under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v, scale = D^-½ by default."""
    _check_operands(q, k, v, causal)
    D = q.shape[-1]
    scale = float(scale) if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    build.check_operands(q.device, ndim=4, dtypes=tuple(DTYPES), q=q, k=k, v=v)
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernel takes D % 4 == 0, D <= {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("16-bit q, k, v must start on a 4-byte boundary")
    B, S, H, _ = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    build.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, S, T, H, KV, D, scale, int(causal), DTYPES[q.dtype])
    return out
