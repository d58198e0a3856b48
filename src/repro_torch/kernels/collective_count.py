"""A record of the collectives the port issues, beside the dispatch-level
launch counts of :mod:`repro_torch.kernels.launch_count`.

Every collective of :class:`repro_torch.launch.mesh.Mesh` (the data-parallel
step's gradient and loss all-reduces, the sharded step's update all-gather,
the parameter split's per-layer all-gathers and fp32 reduce-scatters, the
refresh's probe all-reduce, the projected-space accumulator's refresh
broadcast, the checkpoint's gathers, and over a ``model`` axis the
tensor-parallel layers' activation sums, the vocab-parallel loss's
reductions and the split gradients' gather) appends one entry
``{"op", "tag", "axis", "dtype", "shape", "bytes"}`` to every active record, before
it is issued.  ``shape`` and ``bytes`` are the operand this rank sends (an
all-gather's input, not its ``n``-fold output; a reduce-scatter's whole
input, not its ``1/n`` output).  ``record_collectives(
isolated=True)`` logs the body's collectives there only, not in the records
active around it (the static audit's own trace of a step).

Usage::

    with record_collectives() as log:
        step(params, opt_state, batch)
    tally(log)   # {"all_reduce:grad": 1, "all_reduce:loss": 1, ...}
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

COLLECTIVE_OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")

_ACTIVE: list[list[dict]] = []


def record(op: str, tag: str, tensor: torch.Tensor, axis: str = "data") -> None:
    """Log one collective on ``tensor`` over the mesh axis ``axis`` in every
    active record (no-op otherwise)."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}; expected one of {COLLECTIVE_OPS}")
    if not _ACTIVE:
        return
    entry = {"op": op, "tag": tag, "axis": axis, "dtype": str(tensor.dtype).removeprefix("torch."),
             "shape": list(tensor.shape), "bytes": tensor.numel() * tensor.element_size()}
    for log in _ACTIVE:
        log.append(dict(entry))


@contextlib.contextmanager
def record_collectives(isolated: bool = False) -> Iterator[list[dict]]:
    global _ACTIVE
    log: list[dict] = []
    outer = _ACTIVE
    _ACTIVE = [log] if isolated else outer + [log]
    try:
        yield log
    finally:
        _ACTIVE = outer


def tally(log: list[dict]) -> dict[str, int]:
    """Calls per ``"op:tag"`` over the data axis, per ``"op:tag@axis"`` over
    any other (``"all_reduce:tp_fwd@model"``)."""
    out: dict[str, int] = {}
    for e in log:
        axis = e.get("axis", "data")
        key = f"{e['op']}:{e['tag']}" + ("" if axis == "data" else f"@{axis}")
        out[key] = out.get(key, 0) + 1
    return out
