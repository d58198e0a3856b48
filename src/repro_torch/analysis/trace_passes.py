"""Trace passes, the counterpart of the JAX package's ``analysis/jaxpr_passes.py``.

The update runs on ``meta`` tensors, never on data.

The reference traces ``jax.make_jaxpr`` of the update over
``ShapeDtypeStruct`` trees.  PyTorch runs eagerly, so the port's trace is
one real call of ``init`` and ``update`` on ``meta`` copies of the
parameters (shapes and dtypes, no storage) under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that records every
aten op with its input and output dtypes and shapes, and the dispatch
layer's launch counts of that call.  Nothing allocates device memory, no
kernel runs (a ``meta`` tensor takes the plain route of every dispatched
op), and the samplers and projector noise draw nothing on ``meta``, so a
trace never moves a run's trajectory.

Passes (stable codes in :mod:`repro_torch.analysis.findings`):

  * dtype-flow audit — ``RA201`` flags a float64 output anywhere in the
    update, ``RA202`` an fp32 → bf16/fp16 ``_to_copy`` whose result is
    copied back to fp32 (16 bits of mantissa lost for nothing).
  * recompilation hazards — ``RA401`` traces the update twice at one rank
    and compares the digests of the op sequences (:func:`signature_hash`).
    The reference also has ``RA402``, a weak-typed 0-d constant captured by
    the jaxpr (a Python scalar that re-keys the jit cache).  Eager PyTorch
    compiles nothing and has no weak types, so the code is kept in
    ``CODES`` and never emitted here.
  * static memory accountant — the projected-state bytes of the ``meta``
    state (Table 1's quantity, counted as the reference holds it: see
    :func:`reference_state_bytes`), cross-checked (``RA501``) against the
    runtime numbers recorded in ``results/BENCH_rank_policy.json``.

Which update is traced: the first after ``init``, a refresh.  A refresh
step's dispatch counts are the reference's (its trace counts the
refresh-only spectrum probe too); without probes a steady step's counts
are the same.
"""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Any, Callable, Iterable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.api import Transform, tree_leaves
from repro_torch.core.combinators import find_lowrank_states
from repro_torch.kernels import launch_count

from .findings import Finding

PyTree = Any

_LOW = (torch.bfloat16, torch.float16)
_HIGH = (torch.float32, torch.float64)

# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


class OpRecord(NamedTuple):
    """One aten op of a traced update."""

    op: str                                  # e.g. "aten.mm.default"
    in_dtypes: tuple[str, ...]
    in_shapes: tuple[tuple[int, ...], ...]
    out_dtypes: tuple[str, ...]
    out_shapes: tuple[tuple[int, ...], ...]
    scalars: tuple[str, ...]                 # the non-tensor arguments
    reads_downcast: bool                     # an input came out of an
                                             # fp32 -> 16-bit _to_copy


class UpdateTrace(NamedTuple):
    """What :func:`trace_update` saw of one update call."""

    ops: list[OpRecord]
    counts: dict[str, int]   # dispatch-layer launch counts of the call
    state: PyTree            # the (meta) state the traced update received
    new_state: PyTree        # the state it returned
    params: dict             # the meta parameters


_DTYPES: dict[torch.dtype, str] = {}


def _dtype(t: torch.Tensor) -> str:
    name = _DTYPES.get(t.dtype)
    if name is None:
        name = _DTYPES[t.dtype] = str(t.dtype).removeprefix("torch.")
    return name


def _scalar(x) -> str:
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_scalar(v) for v in x) + ")"
    return repr(x)


def _split(values, tensors: list, scalars: list) -> None:
    """The tensors and the other leaves of an op's arguments (lists and
    tuples of tensors opened, other lists kept whole)."""
    for x in values:
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
            _split(x, tensors, scalars)
        else:
            scalars.append(x)


class _Recorder(TorchDispatchMode):
    """Records every aten op that runs under it (``ops``)."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        # fp32 -> 16-bit copies, by id, kept alive so an id is not reused
        self._down: dict[int, torch.Tensor] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        t_in: list = []
        scalars: list = []
        _split(args, t_in, scalars)
        _split(kwargs.values(), t_in, scalars)
        t_out: list = []
        _split(out if isinstance(out, (list, tuple)) else (out,), t_out, [])
        name = str(func)
        reads_down = bool(self._down) and any(id(x) in self._down for x in t_in)
        if (name.startswith("aten._to_copy") and t_in and t_out
                and t_in[0].dtype in _HIGH and t_out[0].dtype in _LOW):
            self._down[id(t_out[0])] = t_out[0]
        self.ops.append(OpRecord(
            op=name,
            in_dtypes=tuple(_dtype(x) for x in t_in),
            in_shapes=tuple(tuple(x.shape) for x in t_in),
            out_dtypes=tuple(_dtype(x) for x in t_out),
            out_shapes=tuple(tuple(x.shape) for x in t_out),
            scalars=tuple(_scalar(x) for x in scalars),
            reads_downcast=reads_down))
        return out


def meta_like(params: dict) -> dict:
    """``{path: meta tensor}`` of the shapes and dtypes of ``params`` (None
    stays None)."""
    return {k: None if p is None else torch.empty(p.shape, dtype=p.dtype, device="meta")
            for k, p in params.items()}


def trace_update(transform: Transform, params: dict) -> UpdateTrace:
    """Run ``init`` and one update of ``transform`` on ``meta`` copies of
    ``params`` (the gradients shaped like them) and record the update: its
    aten ops and its dispatch counts.  The counts go to an isolated
    counter, never to the ``count_launches`` contexts around the call."""
    p = meta_like(params)
    with torch.no_grad(), launch_count.count_launches(isolated=True):
        state = transform.init(p)
    rec = _Recorder()
    with torch.no_grad(), launch_count.count_launches(isolated=True) as counts, rec:
        _, new_state = transform.update(p, state, p)
    return UpdateTrace(ops=rec.ops, counts=dict(counts), state=state, new_state=new_state,
                       params=p)


# ---------------------------------------------------------------------------
# dtype flow (RA2xx)
# ---------------------------------------------------------------------------


def dtype_flow_findings(trace: UpdateTrace, *, allow_bf16_roundtrip: bool = False,
                        where: str = "step") -> list[Finding]:
    """RA201 (float64 outputs) and RA202 (16-bit round-trips) over a traced
    update.  ``allow_bf16_roundtrip`` is the per-optimizer allowlist knob
    for transforms that stage through bf16 on purpose."""
    out: list[Finding] = []
    f64_ops: dict[str, int] = {}
    roundtrips = 0
    for r in trace.ops:
        n64 = sum(dt == "float64" for dt in r.out_dtypes)
        if n64:
            f64_ops[r.op] = f64_ops.get(r.op, 0) + n64
        if (r.op.startswith("aten._to_copy") and r.reads_downcast
                and r.out_dtypes and r.out_dtypes[0] in ("float32", "float64")):
            roundtrips += 1
    if f64_ops:
        total = sum(f64_ops.values())
        tops = ", ".join(f"{k}x{v}" for k, v in sorted(f64_ops.items())[:4])
        out.append(Finding(
            code="RA201", where=where,
            message=f"{total} f64 value(s) in the traced update ({tops}) — "
                    "the update path is f32-by-contract",
            hint="find the float64 promotion (usually a numpy array or a "
                 "torch.float64 default dtype) and cast to torch.float32",
            detail={"per_op": f64_ops},
        ))
    if roundtrips and not allow_bf16_roundtrip:
        out.append(Finding(
            code="RA202", where=where,
            message=f"{roundtrips} bf16/f16 round-trip(s) inside f32 update "
                    "math — a downcast immediately re-upcast loses mantissa "
                    "for no memory win",
            hint="keep optimizer math in f32 end-to-end, or allowlist the "
                 "optimizer (allow_bf16_roundtrip=True) if the staging is "
                 "deliberate",
            detail={"roundtrips": roundtrips},
        ))
    return out


# ---------------------------------------------------------------------------
# recompilation hazards (RA4xx)
# ---------------------------------------------------------------------------


def signature_hash(trace: UpdateTrace) -> str:
    """Digest of a traced update's op sequence: each op with its input and
    output dtypes and shapes and its non-tensor arguments.  Equal digests:
    the same program ran."""
    h = hashlib.sha256()
    for r in trace.ops:
        h.update(repr((r.op, r.in_dtypes, r.in_shapes, r.out_dtypes, r.out_shapes,
                       r.scalars)).encode())
    return h.hexdigest()[:16]


def recompile_findings(make_transform: Callable[[int], Transform], params: dict,
                       ladder: Iterable[int], *,
                       where: str = "step") -> tuple[list[Finding], dict[int, str]]:
    """Trace the update twice per ladder rank and compare signatures.

    Returns ``(findings, {rank: signature_hash})``.  RA401 (error): the two
    traces of the *same* rank disagree — something nondeterministic or
    Python-id-dependent decides what the update runs.  RA402 is not emitted
    (see the module docstring)."""
    out: list[Finding] = []
    hashes: dict[int, str] = {}
    for rank in ladder:
        t = make_transform(int(rank))
        h1 = signature_hash(trace_update(t, params))
        h2 = signature_hash(trace_update(t, params))
        hashes[int(rank)] = h1
        if h1 != h2:
            out.append(Finding(
                code="RA401", where=f"{where}@rank{rank}",
                message=f"update signature unstable across retraces at rank "
                        f"{rank} ({h1} != {h2}) — the same step runs a "
                        "different op sequence each time",
                hint="hunt for trace-order nondeterminism (dict iteration "
                     "over id()s, fresh closures per call) in the chain",
            ))
    return out, hashes


# ---------------------------------------------------------------------------
# static memory accountant (RA5xx)
# ---------------------------------------------------------------------------


def reference_state_bytes(tree: PyTree) -> int:
    """Bytes of a state as the reference holds it: every float tensor at its
    own width, every integer tensor at 4 bytes an element and every Python
    int step counter as one 4-byte scalar.  The reference keeps its step
    counters and slot indices on the device in int32; the port keeps its
    counters on the host and its slot indices in torch's int64 index dtype
    (:func:`repro_torch.core.api.state_bytes` counts those)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            wide_int = not x.dtype.is_floating_point and x.dtype != torch.bool
            total += x.numel() * (4 if wide_int else x.element_size())
        elif isinstance(x, int) and not isinstance(x, bool):
            total += 4
    return total


def projected_state_bytes(transform: Transform, params: dict) -> int:
    """Bytes of every LowRankState (projectors + projected momenta + probe
    slots) in ``init``'s state on ``meta`` — the Table-1 quantity, counted
    as the reference does (:func:`reference_state_bytes`); nothing is
    allocated."""
    with torch.no_grad(), launch_count.count_launches(isolated=True):
        state = transform.init(meta_like(params))
    return sum(reference_state_bytes(lr) for lr in find_lowrank_states(state))


def realloc_bytes(old_state: PyTree, new_state: PyTree) -> int:
    """Bytes of the tensors of ``new_state`` allocated anew by the update:
    those that are not a tensor of ``old_state`` (by identity, or on a real
    device by storage).  The optimizer is functional, so a step briefly
    holds both states; the reference avoids that by donation."""
    old = [x for x in tree_leaves(old_state) if isinstance(x, torch.Tensor)]
    ids = {id(x) for x in old}
    ptrs = {x.untyped_storage().data_ptr() for x in old if x.device.type != "meta"}
    total = 0
    for x in tree_leaves(new_state):
        if not isinstance(x, torch.Tensor) or id(x) in ids:
            continue
        if x.device.type != "meta" and x.untyped_storage().data_ptr() in ptrs:
            continue
        total += x.numel() * x.element_size()
    return total


def steady_realloc_bytes(transform: Transform, trace: UpdateTrace) -> int:
    """:func:`realloc_bytes` of the update after ``trace``'s (the second,
    a steady one unless the period is 1), run unrecorded on the trace's
    ``meta`` tensors."""
    p = trace.params
    with torch.no_grad(), launch_count.count_launches(isolated=True):
        _, new_state = transform.update(p, trace.new_state, p)
    return realloc_bytes(trace.new_state, new_state)


_RANKMAP_RE = re.compile(r"RankMap\(default=(\d+), overrides=\{([^}]*)\}\)")
_OVERRIDE_RE = re.compile(r"'(\d+)x(\d+)':\s*(\d+)")


def _parse_rank_map(text: str):
    from repro_torch.core.rank_policy import RankMap

    m = _RANKMAP_RE.match(text)
    if not m:
        raise ValueError(f"unparseable RankMap repr: {text!r}")
    overrides = {(int(a), int(b)): int(r) for a, b, r in _OVERRIDE_RE.findall(m.group(2))}
    return RankMap(int(m.group(1)), overrides)


def memory_crosscheck(bench_path: str | Path = "results/BENCH_rank_policy.json"
                      ) -> list[Finding]:
    """RA501: recompute each policy's final projected-state bytes statically
    (the factory's optimizer at the recorded final RankMap, on ``meta``) and
    require exact agreement with the runtime ``proj_bytes_final`` recorded
    by the reference's rank-policy benchmark.  An info finding when the
    file is absent."""
    path = Path(bench_path)
    if not path.exists():
        return [Finding(
            code="RA501", severity="info", where=str(path),
            message="no recorded rank-policy benchmark to cross-check against",
            hint="the reference's benchmarks/rank_policy.py records one",
        )]

    from repro_torch.configs import get_smoke
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.core.rank_policy import RankMap
    from repro_torch.models import build_model

    data = json.loads(path.read_text())
    cfg = data["config"]
    params = build_model(get_smoke(cfg["arch"].replace("-smoke", "")), device="meta").params()

    out: list[Finding] = []
    for policy, res in data["results"].items():
        history = res.get("rank_history") or []
        final_map = (_parse_rank_map(history[-1][1]) if history else RankMap(int(cfg["rank"])))
        opt_cfg = OptimizerConfig(
            name=cfg["opt"], lr=1e-2, rank=int(cfg["rank"]), gamma=1,
            period=int(cfg["period"]), base="muon",
            rank_policy=cfg.get("policies", {}).get(policy),
            rank_ladder=tuple(cfg.get("ladder", ())),
        )
        static = projected_state_bytes(build_optimizer(opt_cfg, rank_map=final_map), params)
        recorded = int(res["proj_bytes_final"])
        if static != recorded:
            out.append(Finding(
                code="RA501", where=f"{path.name}:{policy}",
                message=f"static projected-state bytes {static} != recorded "
                        f"proj_bytes_final {recorded} (final map {final_map!r})",
                hint="the state layout changed since the benchmark was "
                     "recorded — re-record it or fix the regression",
                detail={"static": static, "recorded": recorded},
            ))
    return out
