"""Dispatch-level launch counting, with the JAX package's op vocabulary.

Every dispatched optimizer op (``lowrank_update``, ``project``,
``back_project``, ``back_project_epilogue``, ``newton_schulz``) records one
count per call while a :func:`count_launches` context is active.  PyTorch
runs eagerly, so the counts are per executed call, one step at a time.  The
CUDA kernels under these ops keep their own per-kernel counts
(``kernels.build.LAUNCHES``).

Usage::

    with count_launches() as counts:
        opt.update(grads, state, params)
    # counts == {"lowrank_update": 7, "project": 7, ...}
"""
from __future__ import annotations

import contextlib
from typing import Iterator

# Every op name the dispatch layer may record — the same closed vocabulary
# as the JAX package's launch counter, so counts compare name for name.
DISPATCH_OPS = (
    "lowrank_update",
    "project",
    "back_project",
    "back_project_epilogue",
    "newton_schulz",
)

_ACTIVE: list[dict[str, int]] = []


def record(op: str) -> None:
    """Count one call of ``op`` in every active counter (no-op otherwise)."""
    for counts in _ACTIVE:
        counts[op] = counts.get(op, 0) + 1


@contextlib.contextmanager
def count_launches() -> Iterator[dict[str, int]]:
    counts: dict[str, int] = {}
    _ACTIVE.append(counts)
    try:
        yield counts
    finally:
        _ACTIVE.remove(counts)
