"""Declarative, seeded fault injection — every recovery path gets a
reproducible trigger (the port of the JAX package's
``resilience/inject.py``; a plan parses, fires and logs as the reference's
does, and its seeded RNG picks the same leaf and byte of the same
checkpoint layout).

A :class:`FaultPlan` is a list of :class:`FaultEvent` entries, each naming a
fault class and the train step it fires at.  Events fire **once** (so a
rollback past a fired event does not re-trigger it — recovery converges)
and every firing is appended to ``plan.log``, which together with the
recovery trace makes an injected run reproducible end to end.

Fault classes and how they are delivered:

``grad_nan`` / ``grad_inf`` / ``grad_spike``
    gradient corruption inside the train step through a
    :class:`FaultGate`: the step takes a fourth argument ``{"mode",
    "scale"}`` and rewrites the raw gradients before the clip; mode 0
    returns them untouched.  ``grad_spike`` multiplies by ``scale``
    (default 1e6); the leaf set is the plan's ``leaf_filter``.

``refresh_zero`` / ``refresh_illcond``
    projector-refresh sabotage: :func:`poison_projectors` replaces every
    projector in the optimizer state's ``LowRankState`` nodes — all-zeros
    (the whole update back-projects to zero) or ill-conditioned (every
    column a copy of the first) — per leaf, family-stacked and inside
    chains.

``ckpt_truncate`` / ``ckpt_bitflip``
    durable-checkpoint corruption after the next committed save at or after
    ``step``: :func:`truncate_checkpoint` cuts a shard file short,
    :func:`bitflip_checkpoint` flips one bit of one leaf (position drawn
    from the plan's seeded RNG) — both must be caught by the manifest
    checksums on the next verify/restore.

``kill_save``
    preemption mid-save: a save observer that SIGKILLs the process after
    ``arg`` leaves of the next save at or after ``step`` have been written
    — the atomic tmp+rename commit must leave the previous checkpoint as
    the restorable one.  Run it in a process of its own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any

GRAD_KINDS = ("grad_nan", "grad_inf", "grad_spike")
STATE_KINDS = ("refresh_zero", "refresh_illcond")
CKPT_KINDS = ("ckpt_truncate", "ckpt_bitflip")
KILL_KINDS = ("kill_save",)
ALL_KINDS = GRAD_KINDS + STATE_KINDS + CKPT_KINDS + KILL_KINDS

_GRAD_MODE = {"grad_nan": 1, "grad_inf": 2, "grad_spike": 3}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault: ``kind`` fired at train step ``step``.

    ``scale`` is the spike multiplier (``grad_spike``) or truncation
    fraction kept (``ckpt_truncate``); ``arg`` is the leaf count written
    before a ``kill_save`` fires; ``leaves`` restricts checkpoint
    corruption to paths containing any of the substrings."""

    step: int
    kind: str
    scale: float = 1e6
    arg: int = 0
    leaves: tuple = ()

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {ALL_KINDS}")

    def to_json(self) -> dict:
        return {"step": self.step, "kind": self.kind, "scale": self.scale,
                "arg": self.arg, "leaves": list(self.leaves)}


class FaultGate:
    """Gradient-corruption gate of the train step.

    The step takes a fourth argument ``fault = {"mode": int, "scale":
    float}``; :meth:`apply` rewrites every selected float gradient leaf:
    mode 1 all NaN, 2 all Inf, 3 times ``scale`` (rounded to fp32, as the
    reference's float32 scalar), and mode 0 returns the gradients as they
    are.  ``leaf_filter`` (path-substring tuple, empty = every float leaf)
    selects the leaves."""

    def __init__(self, leaf_filter: tuple = ()):
        self.leaf_filter = tuple(leaf_filter)

    def _match(self, path: str) -> bool:
        return not self.leaf_filter or any(s in path for s in self.leaf_filter)

    def apply(self, grads: dict, fault: dict) -> dict:
        mode = int(fault["mode"])
        if mode == 0:
            return grads
        scale = float(np.float32(fault["scale"]))

        def one(path, g):
            if g is None or not g.is_floating_point() or not self._match(path):
                return g
            if mode == 1:
                return torch.full_like(g, float("nan"))
            if mode == 2:
                return torch.full_like(g, float("inf"))
            return g * scale

        return {k: one(k, g) for k, g in grads.items()}

    @staticmethod
    def disarmed() -> dict:
        return {"mode": 0, "scale": 1.0}

    @staticmethod
    def armed(event: FaultEvent) -> dict:
        return {"mode": _GRAD_MODE[event.kind],
                "scale": float(np.float32(event.scale))}


class FaultPlan:
    """A seeded schedule of :class:`FaultEvent` entries.

    Events are consumed (fire once); ``log`` records every firing as
    ``(step, kind)`` so tests can assert the exact injection trace.  The
    seeded RNG drives only corruption internals (bit positions), never
    *whether* an event fires — reproducibility is structural."""

    def __init__(self, events, seed: int = 0,
                 leaf_filter: tuple = ()):
        self.events = sorted(
            (e if isinstance(e, FaultEvent) else FaultEvent(**e)
             for e in events),
            key=lambda e: (e.step, e.kind),
        )
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.leaf_filter = tuple(leaf_filter)
        self._fired: set = set()
        self.log: list = []

    # ------------------------------------------------------------- parsing

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultPlan":
        """CLI form: ``kind@step[*scale][#arg]`` joined by ``;`` — e.g.
        ``"grad_nan@5;grad_spike@9*1e6;refresh_zero@13;kill_save@20#3"``."""
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, rest = part.partition("@")
            if not rest:
                raise ValueError(f"fault spec {part!r} needs '@step'")
            arg = 0
            scale = 1e6
            if "#" in rest:
                rest, _, a = rest.partition("#")
                arg = int(a)
            if "*" in rest:
                rest, _, s = rest.partition("*")
                scale = float(s)
            events.append(FaultEvent(step=int(rest), kind=kind.strip(),
                                     scale=scale, arg=arg))
        return FaultPlan(events, seed=seed)

    def to_json(self) -> dict:
        return {"seed": self.seed, "leaf_filter": list(self.leaf_filter),
                "events": [e.to_json() for e in self.events]}

    @staticmethod
    def from_json(d: dict) -> "FaultPlan":
        return FaultPlan([FaultEvent(step=e["step"], kind=e["kind"],
                                     scale=e.get("scale", 1e6),
                                     arg=e.get("arg", 0),
                                     leaves=tuple(e.get("leaves", ())))
                          for e in d.get("events", [])],
                         seed=d.get("seed", 0),
                         leaf_filter=tuple(d.get("leaf_filter", ())))

    # ------------------------------------------------------------- firing

    def _take(self, predicate) -> list:
        out = []
        for i, e in enumerate(self.events):
            if i in self._fired or not predicate(e):
                continue
            self._fired.add(i)
            self.log.append((e.step, e.kind))
            out.append(e)
        return out

    def needs_gate(self) -> bool:
        return any(e.kind in GRAD_KINDS for e in self.events)

    def gate(self) -> Optional[FaultGate]:
        return FaultGate(self.leaf_filter) if self.needs_gate() else None

    def grad_event(self, step: int) -> Optional[FaultEvent]:
        """The gradient fault firing at exactly this step, if any."""
        ev = self._take(lambda e: e.kind in GRAD_KINDS and e.step == step)
        return ev[0] if ev else None

    def state_events(self, step: int) -> list:
        """Projector-sabotage events firing at exactly this step."""
        return self._take(lambda e: e.kind in STATE_KINDS and e.step == step)

    def ckpt_events(self, saved_step: int) -> list:
        """Checkpoint-corruption events due at a save committed for
        ``saved_step`` (fires at the first save at or after ``e.step``)."""
        return self._take(
            lambda e: e.kind in CKPT_KINDS and e.step <= saved_step)

    def save_observer(self, saved_step: int) -> Optional[Callable]:
        """A per-leaf save hook that SIGKILLs the process mid-save, or None
        when no ``kill_save`` event is due for this save."""
        ev = self._take(
            lambda e: e.kind in KILL_KINDS and e.step <= saved_step)
        if not ev:
            return None
        after = ev[0].arg

        def observer(leaf_index: int, total: int):
            if leaf_index >= after:
                os.kill(os.getpid(), signal.SIGKILL)

        return observer

    def apply_ckpt_events(self, ckpt_dir: str, saved_step: int) -> list:
        """Run any due checkpoint-corruption events against the committed
        checkpoint for ``saved_step``; returns the fired events."""
        fired = self.ckpt_events(saved_step)
        for e in fired:
            if e.kind == "ckpt_truncate":
                truncate_checkpoint(ckpt_dir, saved_step, rng=self.rng,
                                    keep_frac=min(abs(e.scale), 0.9)
                                    if e.scale < 1.0 else 0.5,
                                    leaves=e.leaves)
            else:
                bitflip_checkpoint(ckpt_dir, saved_step, rng=self.rng,
                                   leaves=e.leaves)
        return fired

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, "
                f"events={[ (e.step, e.kind) for e in self.events ]})")


# ---------------------------------------------------------------------------
# projector sabotage (state surgery)
# ---------------------------------------------------------------------------


def poison_projectors(opt_state: PyTree, mode: str = "refresh_zero") -> PyTree:
    """Replace every projector in the state's ``LowRankState`` nodes with a
    degenerate one — the state a sabotaged refresh would leave behind.

    ``refresh_zero``: all-zeros projectors — ``PᵀG = 0``, the projected
    momenta decay and every back-projected update is exactly zero (the
    dead-subspace signature the health monitor's collapse detector keys
    on).  ``refresh_illcond``: every column a copy of the first — the
    subspace collapses to a single direction.  Works on per-leaf
    (``projs[path]``) and family-stacked (``projs[family index]``, (L, s,
    r)) layouts, and on a rank's share of a split one (its slot projectors,
    ``layerwise_unbias``'s ``proj``, poisoned alike)."""
    from repro_torch.core.combinators import LayerwiseUnbiasState, map_nodes
    from repro_torch.resilience.recovery import map_lowrank_states

    if isinstance(mode, FaultEvent):
        mode = mode.kind
    if mode not in STATE_KINDS:
        raise ValueError(f"unknown projector poison mode {mode!r}")

    def poison_leaf(p):
        if p is None:
            return None
        if mode == "refresh_zero":
            return torch.zeros_like(p)
        return p[..., :, :1].expand(p.shape).contiguous()

    def poison_slots(u):
        if u.proj is None:
            return u
        return u._replace(proj={k: poison_leaf(p) for k, p in u.proj.items()})

    return map_lowrank_states(
        lambda s: s._replace(projs={k: poison_leaf(p) for k, p in s.projs.items()},
                             inner=map_nodes(poison_slots, s.inner, LayerwiseUnbiasState)),
        opt_state)


# ---------------------------------------------------------------------------
# checkpoint corruption
# ---------------------------------------------------------------------------


def _shard_files(ckpt_dir: str, step: int, leaves: tuple = ()) -> list:
    from repro_torch.checkpoint.manager import CheckpointManager

    d = CheckpointManager(ckpt_dir)._step_dir(step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for meta in manifest["leaves"]:
        if leaves and not any(s in meta["path"] for s in leaves):
            continue
        for fn in meta["shards"]:
            out.append((os.path.join(d, fn), meta["path"]))
    if not out:
        raise ValueError(f"no shard files match leaves={leaves} in {d}")
    return out


def truncate_checkpoint(ckpt_dir: str, step: int, *, rng=None,
                        keep_frac: float = 0.5, leaves: tuple = ()) -> str:
    """Truncate one committed shard file to ``keep_frac`` of its bytes (a
    partial write that slipped past the commit).  Returns the leaf path."""
    rng = rng or np.random.default_rng(0)
    files = _shard_files(ckpt_dir, step, leaves)
    fn, path = files[int(rng.integers(len(files)))]
    size = os.path.getsize(fn)
    with open(fn, "r+b") as f:
        f.truncate(max(int(size * keep_frac), 1))
    return path


def bitflip_checkpoint(ckpt_dir: str, step: int, *, rng=None,
                       leaves: tuple = ()) -> str:
    """Flip one bit of one committed shard file (seeded position) — silent
    media corruption that only a content checksum can catch.  Returns the
    leaf path.  The flip lands in the array payload, not the .npy header,
    so the file still *loads* — the checksum is the only defense."""
    rng = rng or np.random.default_rng(0)
    files = _shard_files(ckpt_dir, step, leaves)
    fn, path = files[int(rng.integers(len(files)))]
    size = os.path.getsize(fn)
    # .npy v1 headers are 128 bytes for these arrays; flip past them (any
    # file this small has no payload worth flipping).
    lo = min(128, size - 1)
    pos = int(rng.integers(lo, size))
    bit = int(rng.integers(8))
    with open(fn, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ (1 << bit)]))
    return path
