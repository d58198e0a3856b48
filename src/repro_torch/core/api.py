"""Minimal functional optimizer API (optax-style), on PyTorch tensors.

A :class:`Transform` is a pair of functions:

    init(params)                     -> state
    update(grads, state, params)     -> (updates, new_state)

``updates`` are *added* to params (they already include the -lr sign).  A
parameter tree is a flat ``{path: tensor}`` dict in the JAX package's leaf
order (paths are ``/``-joined; sorted by their parts, which is the order
``jax.tree_util`` flattens nested dicts in), so leaf index ``i`` and every
path line up with the reference.  Masked-out leaves are ``None``.  States
are nested tuples / NamedTuples / dicts of tensors; step counters are Python
ints (PyTorch runs eagerly, so they never need to live on the device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

PyTree = Any
Schedule = Union[float, Callable[[int], float]]


class Transform(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def sort_paths(paths) -> list[str]:
    """Paths in ``jax.tree_util``'s flatten order for nested dicts."""
    return sorted(paths, key=lambda p: p.split("/"))


def schedule_value(lr: Schedule, count: int) -> float:
    return float(lr(count) if callable(lr) else lr)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of nested dicts / tuples / NamedTuples
    (``None`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def apply_updates(params: dict, updates: dict) -> dict:
    """Functional ``params + updates`` (``None`` updates leave a leaf as is).
    A deferred-epilogue leaf (``combinators.PendingBack``) from a chain that
    ended without ``scale_by_lr`` is materialized leaf by leaf (correct, just
    not family-grouped)."""

    def one(p, u):
        if u is None:
            return p
        if hasattr(u, "materialize_update"):
            u = u.materialize_update()
        return p + u.to(p.dtype)

    return {k: one(p, updates.get(k)) for k, p in params.items()}


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(grads: dict, max_norm: float, norm=None) -> dict:
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is their global norm when the caller has it already (the same bits)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: None if g is None else g * scale.to(g.dtype), grads)


def tree_paths(tree: dict) -> dict:
    """``{path: path}`` — the flat tree's own paths, same structure."""
    return {k: k for k in tree}


def state_bytes(state: PyTree) -> int:
    """Total bytes of all tensors in an optimizer state (memory accounting)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(state)
               if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# Label-partitioned composition (like optax.multi_transform).
# ---------------------------------------------------------------------------


class MultiState(NamedTuple):
    inner: dict  # label -> state


def multi_transform(
    transforms: dict[str, Transform], label_fn: Callable[[dict], dict]
) -> Transform:
    """Route each leaf to the transform named by ``label_fn(params)``; each
    inner transform sees the full tree with non-owned leaves ``None``."""

    def mask(tree: dict, labels: dict, label: str) -> dict:
        return {k: (v if labels[k] == label else None) for k, v in tree.items()}

    def init(params: dict) -> MultiState:
        labels = label_fn(params)
        return MultiState(inner={k: t.init(mask(params, labels, k))
                                 for k, t in transforms.items()})

    def update(grads: dict, state: MultiState, params: dict):
        labels = label_fn(params)
        new_inner, upds = {}, {}
        for k, t in transforms.items():
            upds[k], new_inner[k] = t.update(mask(grads, labels, k), state.inner[k],
                                             mask(params, labels, k))
        merged = {path: upds[labels[path]][path] for path in grads}
        return merged, MultiState(inner=new_inner)

    # Static composition metadata for the audit (repro_torch.analysis): each
    # branch's chain_info and the label_fn, which resolves the leaf routing
    # of a params tree.
    update.chain_info = {
        "kind": "multi_transform",
        "branches": {k: dict(getattr(t.update, "chain_info", None) or {"kind": "opaque"})
                     for k, t in transforms.items()},
        "label_fn": label_fn,
    }
    return Transform(init, update)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Config resolved by :func:`repro_torch.core.factory.build_optimizer`:
    the JAX package's fields and defaults."""

    # gum | galore | galore_muon | golore | muon | adamw | sgdm | fira | lisa
    # | unbiased_galore_adam
    name: str = "gum"
    lr: float = 1e-3
    weight_decay: float = 0.0
    beta: float = 0.95          # momentum (muon-family)
    b1: float = 0.9             # adam
    b2: float = 0.999
    eps: float = 1e-8
    rank: int = 128             # low-rank projection rank
    q: float = 0.25             # full-rank sampling probability (gum) == gamma/L
    gamma: int = 2              # full-rank layers per period (gum/lisa)
    period: int = 200           # K, projector refresh / resampling period
    projector: str = "svd"      # svd | subspace | rsvd | random | grass
    base: str = "muon"          # base optimizer inside low-rank space
    ns_steps: int = 5
    compensation: str = "paper"  # paper | finetune (App. C.1 variant)
    grad_clip: float = 0.0
    seed: int = 0
    # Hot-loop implementation: auto | cuda | torch — "auto" runs the CUDA
    # kernels on CUDA tensors and plain PyTorch on CPU tensors.
    kernel_impl: str = "auto"
    # Zero-pad the rank axis of the dispatched ops to a multiple of this
    # (rounded up to 8); 0 pads nothing.
    pad_rank_to: int = 0
    # Family-stacked execution: one batched launch per shape family.
    fuse_families: bool = False
    # Fold the chain tail (-lr, wd, alpha) into the back-projection through
    # the fused back_project_epilogue kernel (galore / galore_muon).
    fused_epilogue: bool = False
    # Muon's sqrt(max(1, m/n)) RMS-matching factor.  None = each optimizer's
    # default (muon: on; gum: off, as Algorithm 2).
    use_muon_scale: bool | None = None
    # None | a spec string ("stepwise:0=256,3000=128", "spectral:0.99", ...)
    # | a RankPolicy (core/rank_policy.py); the ladder bounds adaptive specs.
    rank_policy: Any = None
    rank_ladder: tuple[int, ...] = ()
    # Split the family-stacked low-rank state over a mesh's data axis
    # (ZeRO-style; needs fuse_families and the Trainer's mesh).
    shard_state: bool = False
    # Store the projector drift and a sampled bias residual in the spectrum
    # probes of every lowrank stage (repro_torch.telemetry reads them); the
    # parameter trajectory is bitwise that of telemetry off.
    telemetry: bool = False

    def __post_init__(self):
        if self.pad_rank_to < 0:
            raise ValueError(f"pad_rank_to must be >= 0, got {self.pad_rank_to}")
