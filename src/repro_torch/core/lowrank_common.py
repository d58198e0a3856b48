"""Shared machinery for blockwise low-rank optimizers.

A *family* is one parameter of shape ``(*lead, m, n)`` whose leading dims are
stacked blocks (layer-stacked ``(L, m, n)``).  The projector ``P`` acts on the
shorter side, as in GaLore:

  left  (m <= n): state = Pᵀ G in (*lead, r, n);  back-projection  P @ S
  right (m >  n): state = G P in (*lead, m, r);   back-projection  S @ Pᵀ

``project`` / ``back_project`` here are the plain einsums; the optimizer's
hot path goes through :mod:`repro_torch.kernels.dispatch` instead.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.rank_policy import resolve_rank


class FamilyShape(NamedTuple):
    lead: tuple[int, ...]  # leading block dims
    L: int                 # total block count = prod(lead)
    m: int
    n: int
    side: str              # "left" | "right"
    rank: int


def family_shape(p: torch.Tensor, rank) -> FamilyShape:
    """Geometry of one family.  ``rank`` is an int or a per-shape
    :class:`~repro_torch.core.rank_policy.RankMap`, resolved for this
    leaf's ``(m, n)`` before the ``min(rank, m, n)`` clamp."""
    if p.dim() < 2:
        raise ValueError(f"low-rank families need >=2 dims, got {tuple(p.shape)}")
    m, n = int(p.shape[-2]), int(p.shape[-1])
    lead = tuple(int(d) for d in p.shape[:-2])
    L = 1
    for d in lead:
        L *= d
    side = "left" if m <= n else "right"
    rank = min(resolve_rank(rank, m, n), m, n)
    return FamilyShape(lead=lead, L=L, m=m, n=n, side=side, rank=rank)


def proj_dim(fs: FamilyShape) -> int:
    """Dim P projects: m for left, n for right."""
    return fs.m if fs.side == "left" else fs.n


def proj_shape(fs: FamilyShape) -> tuple[int, ...]:
    return fs.lead + (proj_dim(fs), fs.rank)


def lowrank_state_shape(fs: FamilyShape) -> tuple[int, ...]:
    """(*lead, r, n) for left, (*lead, m, r) for right."""
    if fs.side == "left":
        return fs.lead + (fs.rank, fs.n)
    return fs.lead + (fs.m, fs.rank)


def stack_shardable(L: int, n_shards: int) -> bool:
    """Whether an ``(L, ...)`` family stack partitions evenly over
    ``n_shards`` data shards — the one rule that the state sharding
    (:func:`repro_torch.sharding.family_state_sharding`) and the sharded
    fused step (``combinators.family_sharding``) both apply.  A stack that
    does not divide stays replicated rather than padded."""
    return n_shards >= 1 and L % n_shards == 0


def stacked_grad_bytes(fs: FamilyShape) -> int:
    """fp32 bytes of one family's stacked ``(L, m, n)`` gradient (or update)."""
    return fs.L * fs.m * fs.n * 4


def project(p: torch.Tensor, g: torch.Tensor, side: str) -> torch.Tensor:
    """Low-rank projection. p: (*lead, s, r), g: (*lead, m, n)."""
    if side == "left":
        return torch.einsum("...mr,...mn->...rn", p, g)
    return torch.einsum("...mn,...nr->...mr", g, p)


def back_project(p: torch.Tensor, s: torch.Tensor, side: str) -> torch.Tensor:
    """Back-projection of low-rank states to (*lead, m, n)."""
    if side == "left":
        return torch.einsum("...mr,...rn->...mn", p, s)
    return torch.einsum("...mr,...nr->...mn", s, p)


def gather_blocks(x: torch.Tensor, idx: torch.Tensor, fs: FamilyShape) -> torch.Tensor:
    """(*lead, a, b) -> (gamma, a, b): the blocks at flat ids ``idx``."""
    if not fs.lead:  # single-block family: gamma is necessarily 1
        return x[None]
    return x.reshape((fs.L,) + tuple(x.shape[-2:]))[idx]


def scatter_blocks(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                   fs: FamilyShape) -> torch.Tensor:
    """A copy of ``x`` with the blocks at flat ids ``idx`` set to ``vals``."""
    if not fs.lead:
        return vals[0]
    out = x.reshape((fs.L,) + tuple(x.shape[-2:])).index_copy(0, idx, vals)
    return out.reshape(x.shape)


# noise(key, kind, shape) -> a float32 tensor of ``shape``: standard normal
# ("normal"), standard Gumbel ("gumbel") or uniform on [0, 1) ("uniform")
# draws.  ``key`` is (seed, count, leaf index), the inputs the reference folds
# into its PRNG key; a caller that draws twice from one key draws two kinds.
Noise = Callable[[tuple[int, int, int], str, tuple[int, ...]], torch.Tensor]
NOISE_KINDS = ("normal", "gumbel", "uniform")


class BlockSel(NamedTuple):
    """Some blocks of a family stack: their global ids and the stack's
    blocks per member (block ``b`` is row ``b % member_L`` of member
    ``b // member_L``)."""

    ids: tuple[int, ...]
    member_L: int


def generator_noise(key: tuple[int, int, int], kind: str,
                    shape: tuple[int, ...]) -> torch.Tensor:
    """Default noise: draws on the CPU from a ``torch.Generator`` seeded by
    the key and the kind, so a draw depends only on (seed, step, leaf, kind)
    and the card and the CPU draw the same numbers.  Not the reference's
    threefry bits: parity tests inject those."""
    seed, count, leaf = key
    mixed = ((seed * 1_000_003 + count) * 1_000_003 + leaf) * 4 + 1 + NOISE_KINDS.index(kind)
    gen = torch.Generator().manual_seed(mixed & (2**63 - 1))
    if kind == "normal":
        return torch.randn(shape, generator=gen)
    if kind == "uniform":
        return torch.rand(shape, generator=gen)
    # Gumbel(0, 1) = -log(E), E ~ Exp(1)
    return -torch.log(torch.empty(shape).exponential_(generator=gen))


def _draw(noise: Noise, key, kind: str, lead: tuple[int, ...], tail: tuple[int, ...],
          device: torch.device, blocks: Optional[BlockSel] = None) -> torch.Tensor:
    """``lead + tail`` draws on ``device``.  ``key`` is one leaf's key, or a
    list of per-member keys of a family stack (``lead = (members *
    member_L,)``), each member drawing its own ``(member_L,) + tail`` block
    as its leaf does on the per-leaf path.  With ``blocks`` only those
    blocks' rows, each cut from its member's whole draw.  On the ``meta``
    device (the static audit's shape-only trace) nothing is drawn."""
    if torch.device(device).type == "meta":
        shape = ((len(blocks.ids),) if blocks is not None else tuple(lead)) + tuple(tail)
        return torch.empty(shape, dtype=torch.float32, device=device)
    if blocks is not None:
        draws: dict[int, torch.Tensor] = {}
        rows = []
        for b in blocks.ids:
            j = b // blocks.member_L
            if j not in draws:
                draws[j] = noise(key[j], kind, (blocks.member_L,) + tail)
            rows.append(draws[j][b % blocks.member_L])
        out = torch.stack(rows)
    elif isinstance(key, list):
        per = lead[0] // len(key)
        out = torch.cat([noise(k, kind, (per,) + tail) for k in key])
    else:
        out = noise(key, kind, lead + tail)
    return out.to(device=device, dtype=torch.float32)


def compute_projectors(kind: str, g: torch.Tensor, rank: int, side: str, *,
                       key=None, subspace_iters: int = 2,
                       noise: Optional[Noise] = None,
                       blocks: Optional[BlockSel] = None) -> torch.Tensor:
    """Batched per-block projectors ``(*lead, s, rank)`` with orthonormal
    columns (Property I), for every block of ``g (*lead, m, n)`` (of Gᵀ on
    the right side, so ``s`` is the projected side):

      svd       top-``rank`` left singular vectors (``torch.linalg.svd``,
                then one QR to hold Property I to fp32 rounding)
      subspace  orth((G Gᵀ)^iters G Ω), QR between the power steps
      rsvd      orth(G Ω): the subspace projector with zero iterations
      random    orth(Z), Z Gaussian: independent of the gradient (GoLore)
      grass     ``rank`` one-hot columns: rows by Gumbel top-k over the log
                row norms (sampling without replacement ∝ row norm)

    Ω, Z and the Gumbel draw come from ``noise`` (default
    :func:`generator_noise`) under ``key`` — one leaf's (seed, count, leaf)
    or a list of them, one per member of a family stack.  ``blocks`` says
    that ``g`` holds only those blocks of a family stack (``key`` still the
    whole stack's list): each block draws its member's rows, so the result
    is those blocks' rows of the whole stack's projectors."""
    if side == "right":
        g = g.mT
    g32 = g.to(torch.float32)
    lead = tuple(g32.shape[:-2])
    m, n = int(g32.shape[-2]), int(g32.shape[-1])
    noise = noise or generator_noise
    if kind == "svd":
        u = torch.linalg.svd(g32, full_matrices=False).U[..., :, :rank]
        # The card's Jacobi SVD leaves |UᵀU − I| up to 4e-4 at 768 x 768: one
        # QR restores Property I without moving span(U), each column's sign
        # kept (Q R = U with R ≈ I up to signs).
        q, r = torch.linalg.qr(u)
        sign = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) < 0, -1.0, 1.0)
        return (q * sign.unsqueeze(-2)).contiguous()
    if kind in ("subspace", "rsvd"):
        iters = 0 if kind == "rsvd" else subspace_iters
        y = g32 @ _draw(noise, key, "normal", lead, (n, rank), g32.device, blocks)
        for _ in range(iters):
            y = torch.linalg.qr(y).Q
            y = g32 @ (g32.mT @ y)
        return torch.linalg.qr(y).Q.contiguous()
    if kind == "random":
        z = _draw(noise, key, "normal", lead, (m, rank), g32.device, blocks)
        return torch.linalg.qr(z).Q.contiguous()
    if kind == "grass":
        logits = torch.log(torch.linalg.vector_norm(g32, dim=-1) + 1e-30)  # (*lead, m)
        scores = logits + _draw(noise, key, "gumbel", lead, (m,), g32.device, blocks)
        idx = torch.topk(scores, rank, dim=-1).indices                      # (*lead, rank)
        p = torch.nn.functional.one_hot(idx, m).to(torch.float32)           # (*lead, rank, m)
        return p.mT.contiguous()
    raise ValueError(f"unknown projector kind: {kind!r}")


def default_lowrank_filter(path: str, p) -> bool:
    """Which leaves get low-rank treatment: hidden matrices (attention + MLP
    kernels).  Embeddings / head / norms / biases / routers / conv taps /
    per-layer vector stacks fall through to the fallback optimizer."""
    if p.dim() < 2:
        return False
    if min(int(p.shape[-1]), int(p.shape[-2])) < 8:
        return False  # per-layer vectors stacked into 2-D, conv taps, gates
    lowered = path.lower()
    return not any(
        k in lowered
        for k in ("embed", "lm_head", "norm", "scale", "bias",
                  "conv_w", "skip_d", "a_log", "router")
    )
