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

What the port runs on a mesh: parameters replicated over the data axis, or
with ``shard_params`` split by the parameter rules below
(:class:`ParamSplit`: :func:`param_shardings` resolved on the mesh, a leaf
split on one dim over the data axis, a per-layer all-gather in the forward
and a per-layer fp32 reduce-scatter in the backward); on a ``model`` axis
larger than 1 every leaf whose rule names ``model`` split on that dim, for
good (tensor parallelism: the layers of
:mod:`repro_torch.models.tensor_parallel` compute on the parts), so a leaf
may be split on two dims, one per axis; and with ``shard_state`` the
family-stacked low-rank optimizer state split on its leading stack dim by
:func:`family_state_sharding`.  The port's layers place their work
explicitly, so :func:`shard`, the reference's activation annotation, passes
its input through.

The rules (``PARAM_RULES``, :func:`spec_for_param`, :func:`param_shardings`,
:func:`per_shard_bytes`, :func:`opt_state_sharding`) are held to the
reference's decisions by ``tests/test_torch_sharding.py``; the helpers
(:class:`RowSplit`, :class:`GridSplit`, :func:`row_splits`,
:func:`split_tree`, :func:`gather_tree`, :func:`gather_parts`,
:func:`reduce_scatter_parts`, :func:`zip_map`) apply a spec that splits up
to two dims, each over one axis, on a rank.  :func:`use_mesh` and
:func:`shard` are the reference's activation annotations, which no port
path needs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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
    """An activation annotation: ``x`` itself, on any mesh.  The port's
    tensor-parallel layers (:mod:`repro_torch.models.tensor_parallel`) place
    their work explicitly, where the reference leaves it to GSPMD."""
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


# The untied head's rule in PARAM_RULES, (d, vocab): the tensor-parallel
# layout reads it (see ParamSplit); param_shardings resolves ``embed/lm_head``
# by the ``embed`` rule that precedes it, as the reference does.
HEAD_RULE = ("fsdp", "tp")


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


def per_shard_bytes(tree: PyTree, mesh, axes: Optional[Sequence[str]] = None) -> int:
    """Bytes ONE device holds of ``tree`` split by the parameter rules on
    ``mesh``: each leaf's bytes over the shard count of its resolved,
    divisibility-validated spec.  Leaves without a shape count nothing.
    ``axes`` (e.g. ``("model",)``: tensor parallelism with the data side
    replicated) counts only the splits over those axes."""
    total = 0
    for path, x in _paths_and_leaves(tree):
        if not hasattr(x, "shape"):
            continue
        nbytes = x.numel() * x.element_size()
        spec = validate_spec(x.shape, resolve_spec(spec_for_param(path, x), mesh), mesh)
        shards = 1
        for ax in spec:
            if axes is None or ax in axes:
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
    (index+1)·d/count)`` of a leaf's dim ``dim`` (of size ``d``): the
    leading dim of family state, any one dim of a parameter."""

    index: int
    count: int
    dim: int = 0

    @property
    def cuts(self) -> tuple["RowSplit", ...]:
        return (self,)

    def rows(self, d: int) -> tuple[int, int]:
        per = d // self.count
        return self.index * per, (self.index + 1) * per

    def narrow(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``x``, a view."""
        a, b = self.rows(int(x.shape[self.dim]))
        return x.narrow(self.dim, a, b - a)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.narrow(x).clone()

    def part_shape(self, shape) -> tuple[int, ...]:
        """The shape of this rank's part of a leaf of ``shape``."""
        shape = list(shape)
        shape[self.dim] //= self.count
        return tuple(shape)


@dataclasses.dataclass(frozen=True)
class GridSplit:
    """Two :class:`RowSplit` cuts of two dims, each over its own mesh axis
    (a parameter split over ``data`` and ``model``): this rank keeps the
    block where its rows of both meet."""

    cuts: tuple[RowSplit, ...]

    def narrow(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.cuts:
            x = c.narrow(x)
        return x

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.narrow(x).clone()

    def part_shape(self, shape) -> tuple[int, ...]:
        for c in self.cuts:
            shape = c.part_shape(shape)
        return tuple(shape)


def axis_cut(spec, mesh, axis: str) -> Optional[RowSplit]:
    """The cut ``spec`` makes over ``axis`` on this rank (its coordinate
    there), or None."""
    if not isinstance(spec, Spec):
        return None
    for d, a in enumerate(spec):
        if a == axis:
            return RowSplit(mesh.coordinate(axis), mesh.shape[axis], d)
    return None


def row_splits(specs: PyTree, mesh) -> PyTree:
    """Each spec as this rank's rule (its coordinate on each axis the spec
    names): a :class:`RowSplit` for one split dim, a :class:`GridSplit` for
    two dims over two axes, ``None`` (kept whole) for a spec that splits
    nothing; the per-leaf rule :meth:`CheckpointManager.restore` takes as
    ``shardings``.  A spec that splits one dim over two axes raises (the
    multi-pod mesh's ``("pod", "data")``, ROADMAP queue 1 item 5d), as does
    one that names an axis twice."""
    def one(spec):
        if not isinstance(spec, Spec) or all(a is None for a in spec):
            return None
        dims = [d for d, a in enumerate(spec) if a is not None]
        axes = [spec[d] for d in dims]
        if not all(isinstance(a, str) for a in axes):
            raise NotImplementedError(f"spec {spec}: a split of one dim over two axes is not "
                                      "ported (the multi-pod mesh, ROADMAP queue 1 item 5d)")
        if len(set(axes)) != len(axes):
            raise ValueError(f"spec {spec} names an axis twice")
        cuts = tuple(RowSplit(mesh.coordinate(a), mesh.shape[a], d) for d, a in zip(dims, axes))
        return cuts[0] if len(cuts) == 1 else GridSplit(cuts)

    return _map(one, specs)


def zip_map(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """``fn(leaf, spec)`` over ``tree`` and a tree of its structure whose
    leaves are specs or rules (``None`` where ``tree`` has a non-tensor); a
    :class:`Spec` in ``tree`` is a leaf."""
    if isinstance(tree, Spec):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def paths_map(tree: PyTree, prefix: str = "") -> PyTree:
    """``tree``'s structure with each leaf's path in its place (keys and
    field names joined with ``/``, sequence positions by index)."""
    def join(part) -> str:
        return f"{prefix}/{part}" if prefix else str(part)

    if isinstance(tree, dict):
        return {k: paths_map(v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(paths_map(v, join(f)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(paths_map(v, join(i)) for i, v in enumerate(tree))
    return prefix


def split_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's part of every leaf of ``tree`` (its block of the dims its
    spec splits, the leaf itself elsewhere)."""
    splits = row_splits(specs, mesh)
    return zip_map(lambda x, rs: rs.apply(x) if rs is not None else x, tree, splits)


def gather_parts(mesh, parts: Sequence[torch.Tensor], dims: Sequence[int],
                 tag: str, axis: Optional[str] = None) -> list[torch.Tensor]:
    """The whole of each rank's ``parts`` (split on ``dims`` in coordinate
    order) in ONE all-gather of their concatenation over the mesh's ``axis``
    (default its data axis; every rank of the line calls it).  The parts
    must share one dtype."""
    dtypes = {t.dtype for t in parts}
    if len(dtypes) > 1:
        raise TypeError(f"split leaves of several dtypes {sorted(map(str, dtypes))}")
    n = mesh.shape[axis or mesh.data_axis]
    on = {} if axis in (None, mesh.data_axis) else {"axis": axis}
    gathered = mesh.all_gather(torch.cat([t.reshape(-1) for t in parts]), tag, **on).view(n, -1)
    out, at = [], 0
    for t, d in zip(parts, dims):
        z = t.numel()
        x = gathered[:, at:at + z].reshape((n,) + tuple(t.shape)).movedim(0, d)
        shape = list(t.shape)
        shape[d] *= n
        out.append(x.reshape(shape))
        at += z
    return out


def reduce_scatter_parts(mesh, wholes: Sequence[torch.Tensor], dims: Sequence[int],
                         tag: str, axis: Optional[str] = None) -> list[torch.Tensor]:
    """This rank's part (on ``dims``) of the sum over the mesh's ``axis``
    (default its data axis) of each of ``wholes``, cast to fp32, in ONE
    reduce-scatter (every rank of the line calls it)."""
    n = mesh.shape[axis or mesh.data_axis]
    rows, shapes = [], []
    for t, d in zip(wholes, dims):
        shape = list(t.shape)
        shape[d] //= n
        shapes.append(shape)
        x = t.to(torch.float32).reshape(shape[:d] + [n] + shape[d:]).movedim(d, 0)
        rows.append(x.reshape(n, -1))
    on = {} if axis in (None, mesh.data_axis) else {"axis": axis}
    flat = mesh.reduce_scatter(torch.cat(rows, dim=1).reshape(-1), tag, **on)
    out, at = [], 0
    for shape in shapes:
        z = math.prod(shape)
        out.append(flat[at:at + z].view(shape))
        at += z
    return out


def gather_tree(tree: PyTree, specs: PyTree, mesh, tag: str) -> PyTree:
    """The whole of every leaf :func:`split_tree` split, from every rank's
    part: one all-gather over each axis the specs name (the data axis
    first; every rank calls it).  The split leaves must share one dtype."""
    axes = []
    for spec in _leaves_of(specs):
        for a in spec:
            if a is not None and a not in axes:
                axes.append(a)
    axes.sort(key=lambda a: a != mesh.data_axis)
    for axis in axes:
        cuts = _map(lambda spec: axis_cut(spec, mesh, axis), specs)
        parts: list[torch.Tensor] = []
        dims: list[int] = []

        def collect(x, rs):
            if rs is not None:
                parts.append(x)
                dims.append(rs.dim)

        zip_map(collect, tree, cuts)
        if not parts:
            continue
        wholes = iter(gather_parts(mesh, parts, dims, tag, axis=axis))
        tree = zip_map(lambda x, rs: x if rs is None else next(wholes), tree, cuts)
    return tree


def _leaves_of(specs: PyTree) -> list:
    out: list = []
    _map(lambda s: out.append(s) if isinstance(s, Spec) else None, specs)
    return out


# ---------------------------------------------------------------------------
# Parameter sharding (ZeRO-3) on a data mesh
# ---------------------------------------------------------------------------

# The split the model's layers read (see ParamSplit.gathered): process-wide,
# not per thread, since autograd runs a CUDA backward (and remat's
# recomputation inside it) on a thread of its own.
_GATHER: list = [None]


def active_param_split() -> Optional["ParamSplit"]:
    """The :class:`ParamSplit` whose forward and backward are running, or None."""
    return _GATHER[0]


class _Gathered(torch.autograd.Function):
    """The whole of parameter parts, from one all-gather; backward
    reduce-scatters the wholes' gradients in one fp32 collective into the
    split's accumulator and hands autograd no gradient for the parts."""

    @staticmethod
    def forward(ctx, split, key, *parts):
        ctx.split, ctx.key = split, key
        return tuple(split._gather(key, parts))

    @staticmethod
    def backward(ctx, *grads):
        ctx.split._scatter(ctx.key, grads)
        return (None, None) + (None,) * len(grads)


class ParamSplit:
    """Parameters split over a mesh by :data:`PARAM_RULES` (the reference's
    ``named_sharding_tree``): each rank holds its part of every leaf
    :func:`param_shardings` splits and the whole of the others (an
    indivisible dim stays whole).  The split's axes: ``data`` when ``data``
    is set (``shard_params``), and ``model`` whenever the mesh's model axis
    is larger than 1 (tensor parallelism), so a leaf may be split on two
    dims, one per axis (``rules``: its :class:`RowSplit` or
    :class:`GridSplit`; ``data_rules`` and ``model_rules``: the cut over
    each axis).

    The data side is gathered as the layers read it.  A leaf with a data
    cut is a **layer** leaf when ``model.stack_dims(path)`` stack dims lead
    it and its data dim is not one of them (``wq`` (L, d, d) split on d):
    the model's layer loop gathers layer ``l``'s slices of all such leaves
    over ``data`` in ONE all-gather (tag ``layer``) each time it reads them,
    in the forward and again in remat's recomputation, and the backward of
    that gather reduce-scatters their gradients in ONE fp32 collective (tag
    ``layer``).  Every other leaf with a data cut (``embed``, the stacked
    norms split on the layer dim, an unstacked block's leaves) is a
    **once** leaf: its data side is gathered in one all-gather (tag
    ``once``) before the forward, and its gradient comes back in one fp32
    reduce-scatter (tag ``once``).  The reduced gradient parts land in an
    fp32 accumulator (``grads``), summed over the ranks and over the
    microbatches of a step; autograd returns no gradient for such a leaf,
    so the whole gradient of a layer leaf never exists during backward.

    The model side stays split through the forward and the backward: the
    tensor-parallel layers (:mod:`repro_torch.models.tensor_parallel`)
    compute on it, and autograd returns a model-split leaf's gradient in
    its part's shape (``tp``: the model axis's size, ``tp_index`` this
    rank's coordinate on it)."""

    def __init__(self, model, mesh, *, data: bool = True):
        params = model.params()
        self.mesh = mesh
        self.n = int(mesh.shape[mesh.data_axis])
        self.tp = int(mesh.shape.get("model", 1))
        self.tp_index = mesh.coordinate("model") if self.tp > 1 else 0
        keep = ({mesh.data_axis} if data else set()) | ({"model"} if self.tp > 1 else set())
        specs = param_shardings(params, mesh)
        if self.tp > 1:
            # the untied head splits on its vocab over ``model`` (vocab-parallel
            # logits): its own rule, which the ``embed`` rule shadows on the
            # path ``embed/lm_head``
            specs.update({k: validate_spec(p.shape, resolve_spec(HEAD_RULE, mesh), mesh)
                          for k, p in params.items() if k.endswith("lm_head")})
        self.specs = {k: Spec(a if a in keep or isinstance(a, tuple) else None for a in spec)
                      for k, spec in specs.items()}
        rules = row_splits(self.specs, mesh)
        self.rules = {k: r for k, r in rules.items() if r is not None}
        self.data_rules = {k: c for k, c in ((k, axis_cut(s, mesh, mesh.data_axis))
                                             for k, s in self.specs.items()) if c is not None}
        self.model_rules = ({k: c for k, c in ((k, axis_cut(s, mesh, "model"))
                                               for k, s in self.specs.items()) if c is not None}
                            if self.tp > 1 else {})
        self.shapes = {k: tuple(p.shape) for k, p in params.items()}
        self.dtypes = {k: p.dtype for k, p in params.items()}
        self.stack = {k: int(model.stack_dims(k)) for k in params}
        self.layer = {k for k, r in self.data_rules.items() if 0 < self.stack[k] <= r.dim}
        self.once = [k for k in params if k in self.data_rules and k not in self.layer]
        self.paths = {id(p): k for k, p in params.items()}
        self.model = model
        self.grads: dict[str, torch.Tensor] = {}
        self._written: set = set()
        # (kind, layer, shapes) of every gather and reduce-scatter, while on
        self.log: Optional[list] = None

    # -- layout -------------------------------------------------------------

    def part_shape(self, path: str) -> tuple[int, ...]:
        """The shape of this rank's part of the leaf at ``path``."""
        rule = self.rules.get(path)
        return self.shapes[path] if rule is None else rule.part_shape(self.shapes[path])

    def model_part_shape(self, path: str) -> tuple[int, ...]:
        """The shape of the leaf's model-side part (its data side whole):
        what the layers compute on, and its gradient's shape before the
        gather over ``model``."""
        rule = self.model_rules.get(path)
        return self.shapes[path] if rule is None else rule.part_shape(self.shapes[path])

    def split_params(self) -> None:
        """Cut the model's parameters to this rank's parts, in place (each
        ``Parameter`` keeps its identity; its data becomes the part)."""
        with torch.no_grad():
            for k, p in self.model.params().items():
                if k in self.rules and tuple(p.shape) == self.shapes[k]:
                    p.data = self.rules[k].apply(p.data)

    def whole_params(self, tag: str = "params", device=None) -> dict:
        """Every parameter whole (every rank calls it), one all-gather over
        each axis that splits a leaf (data, then model), each whole moved to
        ``device`` (default: where the parts are) before the next is
        gathered, so at most one leaf's gather is in flight on the card."""
        out = {}
        for k, p in self.model.params().items():
            whole = p.detach()
            for axis, cuts in ((self.mesh.data_axis, self.data_rules),
                               ("model", self.model_rules)):
                if k in cuts:
                    whole = gather_parts(self.mesh, [whole], [cuts[k].dim], tag, axis=axis)[0]
            out[k] = whole if device is None else whole.to(device)
        return out

    def standins(self, device="meta") -> dict:
        """Whole-shaped stand-ins of the parameters for the optimizer: on
        ``meta`` (the update reads only their shapes; a stage that read their
        values would fail there), or on a real device as a zero-sized
        expansion (``init`` allocates its state where they are)."""
        out = {}
        for k, shape in self.shapes.items():
            if torch.device(device).type == "meta":
                out[k] = torch.empty(shape, dtype=self.dtypes[k], device="meta")
            else:
                out[k] = torch.zeros((), dtype=self.dtypes[k], device=device).expand(shape)
        return out

    def init_state(self, optimizer, device):
        """``optimizer.init`` of the whole shapes (stand-ins on ``device``)
        under :func:`repro_torch.core.combinators.param_parts`: the low-rank
        state whole, the elementwise stages' state of a split parameter in
        its part's shape."""
        from repro_torch.core.combinators import param_parts

        with param_parts(self.parts()):
            return optimizer.init(self.standins(device))

    def parts(self) -> dict:
        """``{path: (tensor, rule)}``: the live parameters, this rank's part
        and its rule for a split leaf, the whole and None for the others."""
        return {k: (p.detach(), self.rules.get(k)) for k, p in self.model.params().items()}

    # -- the forward and backward ------------------------------------------

    def begin_step(self) -> None:
        """Start a step's gradient accumulator (every microbatch adds in)."""
        self.grads = {}
        self._written = set()

    @contextlib.contextmanager
    def gathered(self):
        """Run the model's forward and backward inside: the once leaves are
        gathered whole (one all-gather) and stand in for their parameters'
        module attributes, and the layer loop's reads gather their layer."""
        params = self.model.params()
        swapped = []
        if self.once:
            wholes = _Gathered.apply(self, ("once",), *[params[k] for k in self.once])
            for k, w in zip(self.once, wholes):
                mod_path, _, name = k.rpartition("/")
                mod = self.model.get_submodule(mod_path.replace("/", "."))
                swapped.append((mod, name, mod._parameters[name]))
                mod._parameters[name] = w
        prev, _GATHER[0] = _GATHER[0], self
        try:
            yield
        finally:
            _GATHER[0] = prev
            for mod, name, p in swapped:
                mod._parameters[name] = p

    def layer_params(self, groups: dict, l) -> dict:
        """Layer ``l`` of every group's stacks (``{name: {leaf: tensor}}``),
        the layer leaves' slices whole from ONE all-gather over all groups."""
        out, need = {}, []
        for name, group in groups.items():
            d = out[name] = {}
            for leaf, p in group.named_parameters():
                path = self.paths.get(id(p))
                if path in self.layer:
                    need.append((name, leaf, path, p[l]))
                else:
                    d[leaf] = p[l]
        if need:
            key = ("layer", l, tuple(path for _, _, path, _ in need))
            wholes = _Gathered.apply(self, key, *[x for *_, x in need])
            for (name, leaf, _, _), w in zip(need, wholes):
                out[name][leaf] = w
        return out

    def _dims(self, key) -> list[int]:
        if key[0] == "once":
            return [self.data_rules[k].dim for k in self.once]
        return [self.data_rules[k].dim - self.stack[k] for k in key[2]]

    def _gather(self, key, parts) -> list[torch.Tensor]:
        if self.log is not None:
            self.log.append(("all_gather", key[0], key[1] if key[0] == "layer" else None,
                             [tuple(t.shape) for t in parts]))
        dtype = parts[0].dtype
        for t in parts[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        wholes = gather_parts(self.mesh, [t.to(dtype) for t in parts], self._dims(key), key[0])
        return [w.to(t.dtype) for w, t in zip(wholes, parts)]

    def _scatter(self, key, grads) -> None:
        if self.log is not None:
            self.log.append(("reduce_scatter", key[0], key[1] if key[0] == "layer" else None,
                             [tuple(g.shape) for g in grads]))
        paths = self.once if key[0] == "once" else key[2]
        parts = reduce_scatter_parts(self.mesh, grads, self._dims(key), key[0])
        for path, part in zip(paths, parts):
            at = key[1] if key[0] == "layer" else None
            acc = self.grads.get(path)
            if acc is None:
                acc = self.grads[path] = torch.empty(self.part_shape(path), dtype=torch.float32,
                                                     device=part.device)
            dst = acc if at is None else acc[at]
            if (path, at) in self._written:
                dst.add_(part)
            else:
                dst.copy_(part)
                self._written.add((path, at))
