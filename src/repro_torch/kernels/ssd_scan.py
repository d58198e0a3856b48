"""Mamba-2 SSD chunked scan (kernel row 8), forward only.

``ssd_scan(x, dt, a, b, c, chunk=)`` returns ``(y, final_state)`` without
the D·x skip, as the JAX package's ``kernels/ssd_scan.py::ssd_scan`` does.
G, the per-chunk inclusive cumulative sum of ``a·dt``, is computed here with
``torch.cumsum`` (:func:`repro_torch.kernels.ref.ssd_chunk_cumsum`), outside
the kernel as in the reference.  Then the CUDA kernel (``csrc/ssd_scan.cu``)
runs for CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.ssd_chunked_scan_ref`) for CPU tensors —
for no other reason: on a CUDA tensor it launches the kernel or raises.
The kernel computes C Bᵀ once per (batch row, chunk), shared by all heads,
into a workspace this wrapper allocates (B, ⌈S/chunk⌉, chunk, chunk rounded
up to 4) fp32, then scans; both passes count as one launch.

Layouts: x (B, S, H, P) fp32 or bf16 (read as it is, no fp32 copy), dt
(B, S, H) fp32 (post-softplus), a (H,) negative, b/c (B, S, N) fp32 shared
by all heads (ngroups = 1); y (B, S, H, P) fp32, state (B, H, N, P) fp32.
The kernel takes chunk <= 128, N <= 128, P <= 64 and a ragged last chunk
(the reference asks for S % chunk == 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 128, 128, 64


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if dt.shape != (B, S, H) or a.shape != (H,) or b.shape != (B, S, N) or c.shape != b.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        raise NotImplementedError("ssd_scan is forward-only (as the reference kernel); "
                                  "run it under torch.no_grad()")
    chunk = min(chunk, S)
    G = ref.ssd_chunk_cumsum(dt, a, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_scan_ref(x, dt, G, b, c, chunk)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    build.check_operands(x.device, ndim=3, dt=dt, G=G, b=b, c=c)
    if not x.is_contiguous() or x.device != dt.device:
        raise ValueError("x must be contiguous and on the operands' device")
    if chunk > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"chunk {chunk}, N {N}, P {P}: the kernel takes chunk <= "
                         f"{MAX_CHUNK}, N <= {MAX_STATE}, P <= {MAX_HEAD_DIM}")
    y = torch.empty((B, S, H, P), device=x.device, dtype=torch.float32)
    state = torch.empty((B, H, N, P), device=x.device, dtype=torch.float32)
    # C Bᵀ of every (batch row, chunk), rows padded to 16 bytes: the kernel's
    # workspace, written by its first pass and read by the scan.
    cb = torch.empty((B, -(-S // chunk), chunk, -(-chunk // 4) * 4), device=x.device,
                     dtype=torch.float32)
    build.launch("ssd_scan", x.device, x.data_ptr(), dt.data_ptr(), G.data_ptr(),
                 b.data_ptr(), c.data_ptr(), cb.data_ptr(), y.data_ptr(), state.data_ptr(),
                 B, S, H, P, N, chunk, int(x.dtype == torch.bfloat16))
    return y, state
