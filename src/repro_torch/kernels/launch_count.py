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

:func:`assert_launches` turns the counter into an assertion: the static
audit (:mod:`repro_torch.analysis`) derives the expected counts from the
optimizer's composition and family plan, and a mismatch raises
:class:`LaunchCountMismatch`.  ``count_launches(isolated=True)`` hides the
enclosing counters for the body, so an audit's trace of an update never adds
to the counts of the run around it.
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

# The CUDA kernels (``kernels.build`` names) one call of each dispatched op
# launches on CUDA tensors: project runs the lowrank_update kernel (no
# momentum), and a Newton-Schulz call runs ``steps`` gram and ``steps``
# poly_apply launches.
_KERNELS_PER_CALL = {"lowrank_update": {"lowrank_update": 1},
                     "project": {"lowrank_update": 1},
                     "back_project": {"back_project": 1},
                     "back_project_epilogue": {"back_project_epilogue": 1}}

_ACTIVE: list[dict[str, int]] = []


def kernel_launches(counts: dict[str, int], ns_steps: int) -> dict[str, int]:
    """The CUDA kernel launches that dispatch ``counts`` make on the card,
    each Newton-Schulz call at ``ns_steps`` iterations."""
    out: dict[str, int] = {}
    for op, n in counts.items():
        per = ({"gram": ns_steps, "poly_apply": ns_steps} if op == "newton_schulz"
               else _KERNELS_PER_CALL[op])
        for kernel, k in per.items():
            out[kernel] = out.get(kernel, 0) + n * k
    return {k: v for k, v in out.items() if v}


def record(op: str) -> None:
    """Count one call of ``op`` in every active counter (no-op otherwise)."""
    for counts in _ACTIVE:
        counts[op] = counts.get(op, 0) + 1


@contextlib.contextmanager
def count_launches(isolated: bool = False) -> Iterator[dict[str, int]]:
    """Count the body's dispatched calls; ``isolated`` counts them here
    only, not in the counters active around it."""
    global _ACTIVE
    counts: dict[str, int] = {}
    outer = _ACTIVE
    _ACTIVE = [counts] if isolated else outer + [counts]
    try:
        yield counts
    finally:
        _ACTIVE = outer


class LaunchCountMismatch(AssertionError):
    """Counted launches diverged from the closed-form expectation."""

    def __init__(self, expected: dict[str, int], actual: dict[str, int]):
        self.expected = dict(expected)
        self.actual = dict(actual)
        diff = []
        for op in sorted(set(expected) | set(actual)):
            e, a = expected.get(op, 0), actual.get(op, 0)
            if e != a:
                diff.append(f"{op}: expected {e}, traced {a}")
        super().__init__(
            "kernel-launch count mismatch — " + "; ".join(diff)
            + f" (expected {format_counts(expected)}, traced {format_counts(actual)})")


def format_counts(counts: dict[str, int]) -> str:
    """Stable one-line rendering, ``total [op=n, ...]``: the dispatch ops in
    vocabulary order, then any other name sorted."""
    total = sum(counts.values())
    parts = [f"{op}={counts[op]}" for op in DISPATCH_OPS if counts.get(op)]
    parts += [f"{op}={n}" for op, n in sorted(counts.items()) if op not in DISPATCH_OPS]
    return f"{total} [{', '.join(parts)}]"


@contextlib.contextmanager
def assert_launches(expected: dict[str, int]) -> Iterator[dict[str, int]]:
    """Count the body's dispatched calls and raise
    :class:`LaunchCountMismatch` unless they equal ``expected`` exactly (an
    op absent from ``expected`` must not appear).  A body on ``meta``
    tensors checks the counts without computing anything::

        with assert_launches({"project": 3, "back_project": 3}):
            opt.update(grads, state, params)
    """
    for op in expected:
        if op not in DISPATCH_OPS:
            raise ValueError(f"unknown op in expectation: {op!r} (known: {DISPATCH_OPS})")
    with count_launches() as counts:
        yield counts
    clean = {op: n for op, n in expected.items() if n}
    if counts != clean:
        raise LaunchCountMismatch(clean, counts)
