"""Logical sharding rules (the port of the JAX package's ``sharding.py``),
as functions over paths and shapes.

A :class:`Spec` is a tuple with one entry per dimension: a mesh axis name,
a tuple of them, or ``None`` (replicated) — the port's stand-in for a
``PartitionSpec``.  Logical axes resolve against a mesh (anything with
``axis_names`` and ``shape[axis]``: :class:`repro_torch.launch.mesh.Mesh`,
or a ``jax.sharding`` mesh):

  "fsdp"  -> ("pod", "data") on the multi-pod mesh, "data" on one pod
  "tp"    -> "model"
  "ep"    -> "model"   (expert parallelism reuses the model axis)
  None    -> replicated

What the port runs on a mesh: parameters replicated over the data axis (the
rules below say how the reference's pjit step splits them; the port does
not, ROADMAP queue 1), and with ``shard_state`` the family-stacked low-rank
optimizer state split on its leading stack dim by
:func:`family_state_sharding`.  The port's models make no activation
annotations, so :func:`shard` passes its input through on a data-only mesh.

The port's paths call only :func:`family_state_sharding`,
:func:`family_state_bytes` and the row helpers (:class:`RowSplit`,
:func:`row_splits`, :func:`split_tree`, :func:`gather_tree`,
:func:`zip_map`).  The rest — :func:`use_mesh`, :func:`shard`,
``PARAM_RULES``, :func:`spec_for_param`, :func:`param_specs`,
:func:`param_shardings`, :func:`per_shard_bytes` and
:func:`opt_state_sharding` — is held to the reference's decisions by
``tests/test_torch_sharding.py`` and waits for parameter sharding (ROADMAP
queue 1 item 5a): nothing else calls it yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.lowrank_common import stack_shardable

PyTree = Any


class Spec(tuple):
    """A per-dimension spec: a mesh axis name, a tuple of them or ``None``
    for each dimension (a tree walker takes it as one leaf)."""

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


_state = threading.local()


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one :func:`resolve_spec` and :func:`shard` read."""
    prev = _mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def resolve_axis(logical: Optional[str], mesh) -> Any:
    if logical is None:
        return None
    names = mesh.axis_names
    if logical == "fsdp":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    if logical in ("tp", "ep"):
        return "model" if "model" in names else None
    if logical in names:
        return logical
    return None


def resolve_spec(logical_spec: Sequence[Optional[str]], mesh=None) -> Spec:
    mesh = mesh or _mesh()
    if mesh is None:
        return Spec()
    return Spec(resolve_axis(ax, mesh) for ax in logical_spec)


def _axis_size(ax: Any, mesh) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def logical_axis_size(logical: str) -> int:
    """Size of a logical axis on the active mesh (1 without one)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return _axis_size(resolve_axis(logical, mesh), mesh)


def validate_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop axes whose dim is not divisible by the shard count."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        out.append(ax if ax is not None and dim % _axis_size(ax, mesh) == 0 else None)
    return Spec(out)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """An activation annotation: ``x`` itself.  On a mesh with a model axis
    larger than 1 the annotation would place activations, which the port
    does not, so it raises there."""
    mesh = _mesh()
    if mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1:
        raise NotImplementedError("activation sharding over a model axis is not ported "
                                  "(tensor parallelism, ROADMAP queue 1 item 5b)")
    return x


# ---------------------------------------------------------------------------
# Parameter rules: ordered (regex on path, logical spec) pairs, the
# reference's.  A rule covers the trailing dims; leading stacked-layer dims
# get None.
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    # embeddings / lm head: vocab tensor-parallel, d_model fsdp
    (r"embed", ("tp", "fsdp")),
    (r"lm_head", ("fsdp", "tp")),
    # MoE experts (E, d_in, d_out): expert-parallel over model axis, fsdp rows
    (r"experts?.*(w_in|w_gate)", ("ep", "fsdp", None)),
    (r"experts?.*w_out", ("ep", None, "fsdp")),
    (r"router", ("fsdp", None)),
    # attention projections
    (r"(wq|wk|wv|wqkv|q_proj|k_proj|v_proj|in_proj)", ("fsdp", "tp")),
    (r"(wo|o_proj|out_proj)", ("tp", "fsdp")),
    # mlp
    (r"(w_in|w_gate|w_up|gate_proj|up_proj)", ("fsdp", "tp")),
    (r"(w_out|w_down|down_proj)", ("tp", "fsdp")),
    # mamba projections
    (r"(ssm_in)", ("fsdp", "tp")),
    (r"(ssm_out)", ("tp", "fsdp")),
    (r"conv_w", (None, "fsdp")),
    (r"pos_embed", ("fsdp", None)),
    (r"frame_proj", ("fsdp", "tp")),
    # everything 1-D (norms, biases, dt, A) replicated
]


def _ndim(p) -> int:
    return p.ndim if hasattr(p, "ndim") else len(p.shape)


def spec_for_param(path: str, p: Any) -> tuple[Optional[str], ...]:
    """The logical spec of the parameter at ``path`` (anything with a
    ``shape``)."""
    ndim = _ndim(p)
    if ndim <= 1:
        return (None,) * ndim
    for pat, spec in PARAM_RULES:
        if re.search(pat, path):
            pad = ndim - len(spec)
            if pad < 0:
                return spec[-ndim:]  # a rule for the trailing dims
            return (None,) * pad + tuple(spec)
    return (None,) * (ndim - 2) + ("fsdp", None)  # the penultimate dim by default


def param_specs(params: dict) -> dict:
    """``{path: logical spec}`` for a ``{path: parameter}`` tree."""
    return {k: spec_for_param(k, p) for k, p in params.items()}


def param_shardings(params: dict, mesh) -> dict:
    """``{path: spec}`` resolved on ``mesh`` and validated against each
    parameter's shape (the reference's ``named_sharding_tree``)."""
    return {k: validate_spec(p.shape, resolve_spec(spec_for_param(k, p), mesh), mesh)
            for k, p in params.items()}


def _paths_and_leaves(tree: PyTree) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in tree order, paths joined with ``/`` as the
    reference's ``tree_paths``; ``None`` is no leaf."""
    from repro_torch.checkpoint.manager import flatten_with_paths

    return flatten_with_paths(tree)


def per_shard_bytes(tree: PyTree, mesh) -> int:
    """Bytes ONE device holds of ``tree`` split by the parameter rules on
    ``mesh``: each leaf's bytes over the shard count of its resolved,
    divisibility-validated spec.  Leaves without a shape count nothing."""
    total = 0
    for path, x in _paths_and_leaves(tree):
        if not hasattr(x, "shape"):
            continue
        nbytes = x.numel() * x.element_size()
        spec = validate_spec(x.shape, resolve_spec(spec_for_param(path, x), mesh), mesh)
        shards = 1
        for ax in spec:
            shards *= _axis_size(ax, mesh)
        total += nbytes // max(shards, 1)
    return total


# ---------------------------------------------------------------------------
# ZeRO-style family state
# ---------------------------------------------------------------------------


def _map(fn, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts / tuples / NamedTuples / lists;
    a :class:`Spec`, a :class:`RowSplit` and ``None`` are leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _family_stack_leaf_ids(opt_state: PyTree) -> set:
    """ids of the tensors inside family-stacked ``LowRankState`` nodes (whose
    ``projs`` are keyed by family index); per-leaf states are left out, since
    their leading dims are one parameter's blocks, not a member stack."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.combinators import find_lowrank_states, is_family_state

    ids: set = set()
    for st in find_lowrank_states(opt_state):
        if is_family_state(st):
            ids.update(id(x) for x in tree_leaves(st) if isinstance(x, torch.Tensor))
    return ids


def _family_shardable(x: Any, n_shards: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= 2
            and stack_shardable(int(x.shape[0]), n_shards))


def family_state_sharding(opt_state: PyTree, mesh, axis: str = "data") -> PyTree:
    """The spec of every leaf of a ``fuse_families=True`` optimizer state
    (its structure, ``None`` at non-tensor leaves): each tensor of a
    family-stacked low-rank state with ``ndim >= 2`` whose leading dim
    divides the ``axis`` splits there, ``(axis,)``; everything else is
    replicated, ``()``."""
    n = _axis_size(axis, mesh)
    fam_ids = _family_stack_leaf_ids(opt_state)

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return None
        if id(x) in fam_ids and n > 1 and _family_shardable(x, n):
            return Spec((axis,))
        return Spec()

    return _map(leaf, opt_state)


def family_state_bytes(opt_state: PyTree, n_shards: int) -> tuple[int, int]:
    """``(total, per_shard)`` bytes of the family-stacked low-rank state under
    ``n_shards``-way splitting; a leaf that does not split is charged whole
    to every shard."""
    from repro_torch.core.api import tree_leaves

    fam_ids = _family_stack_leaf_ids(opt_state)
    total = per_shard = 0
    for x in tree_leaves(opt_state):
        if id(x) not in fam_ids:
            continue
        nbytes = x.numel() * x.element_size()
        total += nbytes
        per_shard += nbytes // n_shards if _family_shardable(x, n_shards) else nbytes
    return total, per_shard


def opt_state_sharding(opt_state: PyTree, mesh, *, family_axis: Optional[str] = None) -> PyTree:
    """Specs for an optimizer state.  State leaves of a flat ``{path: ...}``
    parameter tree live under their parameter's path, so the parameter rules
    apply to them; with ``family_axis``, family-stacked low-rank leaves split
    on that axis by :func:`family_state_sharding`'s rule instead."""
    fam_ids = _family_stack_leaf_ids(opt_state) if family_axis else set()
    fam_n = _axis_size(family_axis, mesh) if family_axis else 1
    specs = {id(x): None for _, x in _paths_and_leaves(opt_state)}
    for path, x in _paths_and_leaves(opt_state):
        if not isinstance(x, torch.Tensor):
            continue
        if family_axis and id(x) in fam_ids and fam_n > 1 and _family_shardable(x, fam_n):
            specs[id(x)] = Spec((family_axis,))
        elif x.ndim <= 1:
            specs[id(x)] = Spec()
        else:
            specs[id(x)] = validate_spec(x.shape, resolve_spec(spec_for_param(path, x), mesh),
                                         mesh)
    return _map(lambda x: specs.get(id(x)) if isinstance(x, torch.Tensor) else None,
                opt_state)


# ---------------------------------------------------------------------------
# Applying a spec on one rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """Rank ``index`` of ``count`` keeps rows ``[index·d/count,
    (index+1)·d/count)`` of a leaf's leading dim ``d``."""

    index: int
    count: int

    def rows(self, d: int) -> tuple[int, int]:
        per = d // self.count
        return self.index * per, (self.index + 1) * per

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.rows(int(x.shape[0]))
        return x[a:b].clone()


def row_splits(specs: PyTree, mesh) -> PyTree:
    """Each ``(axis,)`` spec as this rank's :class:`RowSplit` (its
    coordinate on that axis), every other spec as ``None`` (kept whole): the
    per-leaf rule :meth:`CheckpointManager.restore` takes as ``shardings``."""
    def one(spec):
        if not isinstance(spec, Spec) or all(a is None for a in spec):
            return None
        if spec[0] is not None and all(a is None for a in spec[1:]) \
                and isinstance(spec[0], str):
            return RowSplit(mesh.coordinate(spec[0]), mesh.shape[spec[0]])
        raise NotImplementedError(f"spec {spec}: only a split of the leading dim over one "
                                  "axis is ported (parameter sharding, ROADMAP queue 1 item 5a)")

    return _map(one, specs)


def zip_map(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """``fn(leaf, spec)`` over ``tree`` and a tree of its structure whose
    leaves are specs or rules (``None`` where ``tree`` has a non-tensor)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def split_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's part of every leaf of ``tree`` (its rows where its spec
    splits the leading dim, the leaf itself elsewhere)."""
    splits = row_splits(specs, mesh)
    return zip_map(lambda x, rs: rs.apply(x) if rs is not None else x, tree, splits)


def gather_tree(tree: PyTree, specs: PyTree, mesh, tag: str) -> PyTree:
    """The whole of every leaf :func:`split_tree` split, from every rank's
    rows, in one all-gather over the mesh (every rank calls it).  The split
    leaves must share one dtype."""
    splits = row_splits(specs, mesh)
    parts: list[torch.Tensor] = []
    zip_map(lambda x, rs: parts.append(x) if rs is not None else None, tree, splits)
    if not parts:
        return tree
    dtypes = {t.dtype for t in parts}
    if len(dtypes) > 1:
        raise TypeError(f"split leaves of several dtypes {sorted(map(str, dtypes))}")
    axis = mesh.data_axis
    n = mesh.shape[axis]
    gathered = mesh.all_gather(torch.cat([t.reshape(-1) for t in parts]), tag).view(n, -1)
    at = 0

    def whole(x, rs):
        nonlocal at
        if rs is None:
            return x
        z = x.numel()
        out = gathered[:, at:at + z].reshape((n * x.shape[0],) + tuple(x.shape[1:]))
        at += z
        return out

    return zip_map(whole, tree, splits)
