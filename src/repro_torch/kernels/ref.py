"""Plain PyTorch versions of every op on the port's path.

Each kernel wrapper in :mod:`lowrank_update`, :mod:`fused_step`,
:mod:`newton_schulz`, :mod:`flash_attention` and :mod:`ssd_scan` runs the
matching function here when its tensors lie on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against it on the card.  The
attention and SSD functions are also the ``xla`` / ``xla_chunked`` paths of
:mod:`repro_torch.kernels.ops`, as their counterparts are in the JAX
package; flash attention's plain version is :func:`flash_attention_ref`,
which keeps P in fp32 where the ``xla`` routes round it to v's dtype.  All
functions compute in fp32; the matrix ops accept a leading batch
``(..., a, b)``.

Shapes convention (as in the JAX package's ``kernels/ref.py``):
  attention:      q (B, S, H, D), k/v (B, T, KV, D), GQA via H % KV == 0
  newton-schulz:  x (..., m, n)
  lowrank update: p (..., m, r), g (..., m, n), r_state (..., r, n)
  epilogue:       p (..., m, r), s (..., r, n), w (..., m, n) or None
  ssd (Mamba-2):  x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, N)
"""
from __future__ import annotations

from typing import Optional

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ------------------------------------------------------------ attention


def _attention(q, k, v, *, causal: bool, scale: Optional[float], kv_len,
               round_p: bool) -> torch.Tensor:
    """Softmax attention from fp32 logits of the inputs' exact values, an
    fp32 softmax and P·V summed in fp32, out in q's dtype; ``round_p``
    rounds P to v's dtype before P·V."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = _f32(q).reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, _f32(k)) * scale
    cols = torch.arange(T, device=q.device)
    mask = torch.ones((1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (T - S)
        mask = mask & (cols[None, :] <= rows)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1)
        mask = mask & (cols[None, None, :] < kv_len)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    del logits
    if round_p:
        p = _f32(p.to(v.dtype))
    o = torch.einsum("bkgst,btkd->bskgd", p, _f32(v))
    return o.reshape(B, S, H, D).to(q.dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_len=None,
) -> torch.Tensor:
    """Softmax attention with GQA, as the JAX package's ``attention_ref``
    (``impl="xla"``): fp32 logits and softmax, **P rounded to v's dtype**
    before P·V, which sums in fp32; out in q's dtype.  Under ``causal`` the
    S queries are the last S positions of the T-long kv sequence (row
    offset ``T - S``).  ``kv_len`` (an int or a (B,) tensor, one length per
    batch row) masks the kv positions at and past it.  In fp32 it equals
    :func:`flash_attention_ref`."""
    return _attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len, round_p=True)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The flash attention kernel's plain version (kernel row 7): what the
    Pallas ``_flash_kernel`` computes, every block cast to fp32, fp32
    logits, softmax and **P kept in fp32** for P·V; out in q's dtype.  The
    wrapper runs it for CPU tensors, and the card holds the kernel
    against it."""
    return _attention(q, k, v, causal=causal, scale=scale, kv_len=None, round_p=False)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos) -> torch.Tensor:
    """Single-step decode: q (B, 1, H, D) over a (B, Smax, KV, D) cache with
    valid length pos + 1 (positions 0..pos); ``pos`` an int or one position
    per batch row (B,).  P is rounded to the cache's dtype, as in
    :func:`attention_ref`."""
    return attention_ref(q, k, v, causal=False,
                         kv_len=torch.as_tensor(pos, device=q.device) + 1)


def attention_chunked_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """Flash-algorithm attention in plain torch (``impl="xla_chunked"``): a
    loop over kv blocks with a running (max, denominator, accumulator) in
    fp32, each block's P rounded to v's dtype for P·V (the denominator sums
    it unrounded), as the JAX package's ``attention_chunked_ref``; equal
    to :func:`attention_ref` in fp32.  Peak score memory is O(S·block_kv)
    per head."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    block_kv = min(block_kv, T)
    if T % block_kv:
        raise ValueError(f"kv length {T} is not a multiple of block_kv {block_kv}")
    qg = _f32(q).reshape(B, S, KV, G, D)
    rows = torch.arange(S, device=q.device) + (T - S)
    neg_inf = float("-inf")
    m = torch.full((B, KV, G, S), neg_inf, device=q.device)
    l = torch.zeros((B, KV, G, S), device=q.device)
    acc = torch.zeros((B, KV, G, S, D), device=q.device)
    for start in range(0, T, block_kv):
        kblk = _f32(k[:, start:start + block_kv])
        vblk = _f32(v[:, start:start + block_kv])
        s = torch.einsum("bskgd,btkd->bkgst", qg, kblk) * scale
        if causal:
            cols = start + torch.arange(block_kv, device=q.device)
            s = s.masked_fill(~(cols[None, :] <= rows[:, None]), neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) is nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isneginf(s), 0.0, p)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bkgst,btkd->bkgsd",
                                                    _f32(p.to(v.dtype)), vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,KV,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


# ------------------------------------------------------------ newton-schulz


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """X Xᵀ."""
    x = _f32(x)
    return x @ x.mT


def poly_matmul_axpy_ref(a2: torch.Tensor, x: torch.Tensor, a: float) -> torch.Tensor:
    """a X + A2 @ X (the second half of an NS iteration)."""
    return a * _f32(x) + _f32(a2) @ _f32(x)


def ns_iteration_ref(x: torch.Tensor, a: float, b: float, c: float) -> torch.Tensor:
    """One quintic NS iteration: a X + (b XXᵀ + c (XXᵀ)²) X, fp32."""
    x = _f32(x)
    xxt = x @ x.mT
    return a * x + (b * xxt + c * (xxt @ xxt)) @ x


# ------------------------------------------------------------ low-rank update


def lowrank_update_ref(
    p: torch.Tensor, g: torch.Tensor, r_state: Optional[torch.Tensor],
    beta: float, coeff: float,
) -> torch.Tensor:
    """Fused momentum update: R' = beta R + coeff · Pᵀ G (R None: the
    projection coeff · Pᵀ G)."""
    out = coeff * (_f32(p).mT @ _f32(g))
    if r_state is not None:
        out = beta * _f32(r_state) + out
    return out


def project_ref(p: torch.Tensor, g: torch.Tensor, coeff: float = 1.0) -> torch.Tensor:
    """Projection: coeff · Pᵀ G."""
    return lowrank_update_ref(p, g, None, 0.0, coeff)


def back_project_ref(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Back-projection GEMM: P (..., m, r) @ S (..., r, n) -> (..., m, n)."""
    return _f32(p) @ _f32(s)


def back_project_epilogue_ref(
    p: torch.Tensor, s: torch.Tensor, w: Optional[torch.Tensor], scale: float,
    decay: float,
) -> torch.Tensor:
    """Fused write-back: scale·(P @ S) + decay·W (W optional)."""
    out = scale * (_f32(p) @ _f32(s))
    if w is not None:
        out = out + decay * _f32(w)
    return out


# ------------------------------------------------------------ Mamba-2 SSD


def ssd_ref(x, dt, a, b, c, d) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the slow exact oracle).

    state S_t = exp(a·dt_t) S_{t-1} + dt_t · b_t ⊗ x_t        (N, P) per head
    y_t     = c_tᵀ S_t + d · x_t
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) fp32).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    x32, dt32, b32, c32 = _f32(x), _f32(dt), _f32(b), _f32(c)
    state = torch.zeros((B, H, N, P), device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(a[None, :] * dt32[:, t])                       # (B, H)
        upd = torch.einsum("bn,bh,bhp->bhnp", b32[:, t], dt32[:, t], x32[:, t])
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, t], state))
    y = torch.stack(ys, dim=1) + d[None, None, :, None] * x32
    return y.to(x.dtype), state


def ssd_chunk_cumsum(dt: torch.Tensor, a: torch.Tensor, chunk: int) -> torch.Tensor:
    """G (B, S, H): the inclusive cumulative sum of the log-decay a·dt within
    each chunk of ``chunk`` steps (reset at chunk boundaries), fp32.  A
    ragged last chunk is summed as far as it goes."""
    B, S, H = dt.shape
    pad = (-S) % chunk
    g = a[None, None, :] * _f32(dt)
    if pad:
        g = torch.cat([g, g.new_zeros(B, pad, H)], dim=1)
    G = torch.cumsum(g.reshape(B, -1, chunk, H), dim=2).reshape(B, -1, H)
    return G[:, :S].contiguous()


def ssd_chunked_scan_ref(x, dt, G, b, c, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """What the SSD scan kernel computes: the chunked SSD form without the
    D·x skip, from the per-chunk cumulative log-decay ``G``
    (:func:`ssd_chunk_cumsum`).  A ragged last chunk behaves as zero-padded
    (dt = 0: decay 1, no state increment).

    Per chunk (length c), L_ij = exp(G_i - G_j) for i >= j else 0:
      intra:  Y = ((C Bᵀ) ⊙ L) (dt ⊙ X)
      inter:  Y += (C ⊙ exp(G)) S_prev
      state:  S = exp(G_c) S_prev + (B ⊙ dt ⊙ exp(G_c - G))ᵀ X
    Returns (y (B,S,H,P) fp32, final_state (B,H,N,P) fp32).  The intra-chunk
    products of all chunks run at once; the state is carried by a loop.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk

    def padded(t):
        t = _f32(t)
        if pad:
            t = torch.cat([t, t.new_zeros((B, pad) + tuple(t.shape[2:]))], dim=1)
        return t.reshape((B, -1, chunk) + tuple(t.shape[2:]))

    x32, dt32, G32, b32, c32 = padded(x), padded(dt), padded(G), padded(b), padded(c)
    if pad:  # the padded steps continue the last valid cumulative sum
        last = (S - 1) % chunk
        G32[:, -1, last + 1:] = G32[:, -1, last:last + 1]
    nch = x32.shape[1]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    diff = G32[:, :, :, None, :] - G32[:, :, None, :, :]          # (B,nch,c,c,H)
    # mask BEFORE exp: upper-triangle differences are positive and overflow
    L = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bzin,bzjn->bzij", c32, b32)                 # (B,nch,c,c)
    m = cb[..., None] * L * dt32[:, :, None, :, :]
    y = torch.einsum("bzijh,bzjhp->bzihp", m, x32)
    Gl = G32[:, :, -1, :]                                          # (B,nch,H)
    w = dt32 * torch.exp(Gl[:, :, None, :] - G32)                  # (B,nch,c,H)
    inc = torch.einsum("bzjn,bzjh,bzjhp->bzhnp", b32, w, x32)      # (B,nch,H,N,P)
    ce = c32[:, :, :, None, :] * torch.exp(G32)[..., None]         # (B,nch,c,H,N)
    state = torch.zeros((B, H, N, P), device=x.device)
    inter = []
    for z in range(nch):
        inter.append(torch.einsum("bihn,bhnp->bihp", ce[:, z], state))
        state = torch.exp(Gl[:, z])[..., None, None] * state + inc[:, z]
    y = (y + torch.stack(inter, dim=1)).reshape(B, nch * chunk, H, P)[:, :S]
    return y, state


def ssd_chunked_ref(x, dt, a, b, c, d, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (state-space duality form) with the D·x skip — the
    algorithm the scan kernel implements; mathematically equal to
    :func:`ssd_ref`.  A ragged tail is zero-padded (dt = 0 makes padded
    steps identity updates, so the final state and the real outputs are
    untouched).  Returns (y in x's dtype, final_state fp32)."""
    G = ssd_chunk_cumsum(dt, a, min(chunk, x.shape[1]))
    y, state = ssd_chunked_scan_ref(x, dt, G, b, c, chunk)
    y = y + d[None, None, :, None] * _f32(x)
    return y.to(x.dtype), state


def ssd_decode_ref(state, x, dt, a, b, c, d):
    """One decode step. state (B,H,N,P); x (B,H,P); dt (B,H); b/c (B,N)."""
    decay = torch.exp(a[None, :] * dt)
    state = decay[..., None, None] * state + torch.einsum("bn,bh,bhp->bhnp", b, dt, x)
    y = torch.einsum("bn,bhnp->bhp", c, state) + d[None, :, None] * x
    return y, state
