"""Mixture-of-Experts FFN with capacity-based token-choice dispatch (the JAX
package's ``models/moe.py``), on one layer's weights ``p``.

Top-k routing in fp32, a per-expert capacity per dispatch group, a gather
of each expert's tokens, three batched expert products and a weighted
combine; over-capacity tokens are dropped, and the router returns the
Switch load-balancing aux loss.  The reference has no Pallas kernel here:
its expert products are plain einsums, so these are ``torch.bmm``.

Two orders the reference fixes are kept exactly:

* ``jax.lax.top_k`` puts the lower index first among equal values.  In
  maverick (top-1) every routed token's combine weight is ``p / p = 1.0``,
  so the capacity choice is decided by index alone; :func:`_top_k` takes a
  stable descending sort, which keeps that order on either device.
* The reference scatter-adds each expert's rows into the output in the
  update order, experts ascending.  :func:`_combine` adds each token's
  contributions in that order, in ``y``'s dtype, with no atomics, so two
  calls on the card give the same bits.

:class:`RoutingLog` (``record_routing`` / ``replay_routing``) is an
instrument, off unless one of those blocks is open: it records each call's
routing on one run and replays it on another, whose weights still come from
its own probabilities.  Routing is discontinuous (a 1e-6 move can take a
token to another expert or out of capacity), so two numerically close runs
are compared on one routing.

Parameters (``param_shapes``): ``router`` (d, E), ``experts_w_in`` /
``experts_w_gate`` (E, d, f), ``experts_w_out`` (E, f, d) and, with shared
experts, ``shared_w_in`` / ``shared_w_gate`` (d, f·n_shared) and
``shared_w_out`` (f·n_shared, d); ``w_gate`` only for swiglu / geglu.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_act, trunc_normal_


def _gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's MoE parameters by name, as the reference's ``init_moe``."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_dff or cfg.d_ff
    shapes = {"router": (d, E), "experts_w_in": (E, d, f), "experts_w_out": (E, f, d)}
    if _gated(cfg):
        shapes["experts_w_gate"] = (E, d, f)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes["shared_w_in"] = (d, fs)
        if _gated(cfg):
            shapes["shared_w_gate"] = (d, fs)
        shapes["shared_w_out"] = (fs, d)
    return shapes


def init_moe(p: dict[str, torch.Tensor], cfg: ModelConfig, gen: torch.Generator) -> None:
    """Truncated normals at the reference's scales, in place over the whole
    stacks: d^-½ for the router and the input-side products, f^-½ (f·n_shared
    for the shared expert) for the output side."""
    f = cfg.moe_dff or cfg.d_ff
    for name, t in p.items():
        fan_in = {"experts_w_out": f, "shared_w_out": f * max(cfg.n_shared_experts, 1)}
        trunc_normal_(t, fan_in.get(name, cfg.d_model) ** -0.5, gen)


def n_groups(T: int, groups: int) -> int:
    """The dispatch groups of T tokens, as the reference picks them: the
    largest G <= max(groups, 1) that divides T."""
    G = max(groups, 1)
    while T % G:
        G -= 1
    return G


def capacity(cfg: ModelConfig, Tg: int) -> int:
    """Tokens each expert keeps per group, in the reference's float
    arithmetic: max(1, min(Tg, int(cf · Tg · k / E)))."""
    return max(1, min(Tg, int(cfg.capacity_factor * Tg * cfg.top_k / cfg.n_experts)))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, descending, the lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ------------------------------------------------------------ routing log


class RoutingLog:
    """Each ``apply_moe`` call's routing, in call order: the top-k experts
    of every token (G, Tg, k), the token in every (expert, slot) (G, E, cap)
    and whether that slot is kept (weight > 0)."""

    def __init__(self) -> None:
        self.calls: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def kept_pairs(self, i: int) -> torch.Tensor:
        """Call ``i``'s kept (token, expert) pairs as a (G, Tg, E) mask, on
        the CPU (two logs from two devices compare)."""
        topi, g_idx, kept = self.calls[i]
        G, Tg, _ = topi.shape
        mask = torch.zeros((G, Tg, g_idx.shape[1]), dtype=torch.bool, device=g_idx.device)
        g, e, _ = torch.nonzero(kept, as_tuple=True)
        mask[g, g_idx[kept], e] = True
        return mask.cpu()


# (mode, log, next call to replay) while a record or replay block is open
_ACTIVE: Optional[list] = None


@contextlib.contextmanager
def record_routing() -> Iterator[RoutingLog]:
    """Record the routing of every ``apply_moe`` call in the block."""
    global _ACTIVE
    log = RoutingLog()
    _ACTIVE = ["record", log, 0]
    try:
        yield log
    finally:
        _ACTIVE = None


@contextlib.contextmanager
def replay_routing(log: RoutingLog) -> Iterator[RoutingLog]:
    """Route the block's ``apply_moe`` calls as ``log`` recorded them, call
    by call (each call's top-k experts and its (expert, slot) tokens); the
    weights are the block's own probabilities at those experts.  Every
    recorded call must be replayed."""
    global _ACTIVE
    _ACTIVE = ["replay", log, 0]
    try:
        yield log
        if _ACTIVE[2] != len(log.calls):
            raise RuntimeError(f"replayed {_ACTIVE[2]} of {len(log.calls)} recorded MoE calls")
    finally:
        _ACTIVE = None


def flips(want: RoutingLog, got: RoutingLog) -> list[int]:
    """Per call, the kept (token, expert) pairs of ``got`` that ``want``
    does not keep."""
    if len(want.calls) != len(got.calls):
        raise ValueError(f"{len(want.calls)} != {len(got.calls)} recorded calls")
    return [int((got.kept_pairs(i) & ~want.kept_pairs(i)).sum())
            for i in range(len(want.calls))]


# ------------------------------------------------------------ the layer


def _expert_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, E, c, K) x (E, K, N) -> (G, E, c, N), one product per expert over
    its G·c rows.  The weight is cast to a's dtype at its use, and the cast
    is freed when the product returns: one expert stack's copy at a time."""
    G, E, c, K = a.shape
    out = torch.bmm(a.transpose(0, 1).reshape(E, G * c, K), w.to(a.dtype))
    return out.reshape(E, G, c, -1).transpose(0, 1)


def _combine(y: torch.Tensor, g_idx: torch.Tensor, kept: torch.Tensor, Tg: int,
             k: int) -> torch.Tensor:
    """(G, E, cap, D) weighted expert rows -> (G, Tg, D): each token's kept
    rows summed in ``y``'s dtype, experts ascending, from zero — the
    reference's scatter-add in its update order (its dropped slots add
    y · 0 = ±0, which changes no sum).  A token has at most k kept rows: row
    j of its sum goes to column j of a (G, Tg, k, D) buffer, which has no
    two writes to one place, and the columns are added in order."""
    G, E, _, D = y.shape
    member = torch.zeros((G, Tg, E), dtype=torch.int64, device=y.device)
    g, e, c = torch.nonzero(kept, as_tuple=True)
    t = g_idx[g, e, c]
    member[g, t, e] = 1
    j = (torch.cumsum(member, dim=-1) - member)[g, t, e]  # kept experts below e
    buf = y.new_zeros((G, Tg, k, D)).index_put((g, t, j), y[g, e, c])
    out = buf[:, :, 0]
    for col in range(1, k):
        out = out + buf[:, :, col]
    return out


def apply_moe(p: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
              groups: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar).

    The B·S tokens route in ``n_groups`` groups (``groups``, default
    ``cfg.moe_groups``), each under its own capacity; ``groups = B`` with
    one token a row routes every row alone, as the reference's engine does
    by decoding each slot at batch 1."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = n_groups(T, cfg.moe_groups if groups is None else groups)
    Tg = T // G
    xt = x.reshape(G, Tg, D)
    replay = _ACTIVE is not None and _ACTIVE[0] == "replay"
    if replay:  # a log recorded on another device replays here too
        topi_rec, g_idx_rec, _ = (t.to(x.device) for t in _ACTIVE[1].calls[_ACTIVE[2]])
        _ACTIVE[2] += 1

    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)       # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    if replay:
        topi = topi_rec
        topw = torch.gather(probs, -1, topi)
    else:
        topw, topi = _top_k(probs, k)                                 # (G, Tg, k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    # Switch-style load-balance aux: E * sum_e fraction_e * prob_e
    onehot = F.one_hot(topi, E).to(torch.float32)                     # (G, Tg, k, E)
    frac = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))           # (E,)
    aux = E * torch.sum(frac * torch.mean(probs, dim=(0, 1)))

    combine = torch.sum(topw[..., None] * onehot, dim=2)              # (G, Tg, E)
    cap = capacity(cfg, Tg)
    score = torch.where(combine > 0, combine, -1.0).transpose(1, 2)   # (G, E, Tg)
    if replay:
        g_idx = g_idx_rec
        g_score = torch.gather(score, -1, g_idx)
    else:
        g_score, g_idx = _top_k(score, cap)                           # (G, E, cap)
    kept = g_score > 0
    g_w = torch.where(kept, g_score, 0.0)
    if _ACTIVE is not None and _ACTIVE[0] == "record":
        _ACTIVE[1].calls.append((topi, g_idx, kept))

    xg = xt[torch.arange(G, device=x.device)[:, None, None], g_idx]   # (G, E, cap, D)
    h = _expert_mm(xg, p["experts_w_in"])
    g = _expert_mm(xg, p["experts_w_gate"]) if "experts_w_gate" in p else None
    y = _expert_mm(mlp_act(h, g, cfg.act), p["experts_w_out"])
    y = y * g_w[..., None].to(y.dtype)
    out = _combine(y, g_idx, kept, Tg, k).reshape(T, D)

    if "shared_w_in" in p:
        xt = xt.reshape(T, D)
        hs = xt @ p["shared_w_in"].to(xt.dtype)
        gs = xt @ p["shared_w_gate"].to(xt.dtype) if "shared_w_gate" in p else None
        out = out + mlp_act(hs, gs, cfg.act) @ p["shared_w_out"].to(xt.dtype)
    return out.reshape(B, S, D), aux
