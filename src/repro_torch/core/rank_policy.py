"""Rank-policy engine: WHEN and WHAT rank each shape family runs at (the
port of the JAX package's ``core/rank_policy.py``).

declarative policies (each yields a :class:`RankMap` per decision point)
    fixed(r)                     one rank forever (the legacy behavior)
    stepwise({step: r})          piecewise-constant rank schedule over steps
    per_family({(m, n): r})      static per-shape-family rank assignment
    spectral(target_energy=...)  adaptive: estimate the captured spectral
                                 energy from the projected-gradient sketch
                                 the refresh already computes and shrink /
                                 grow rank within [r_min, r_max] along a
                                 declared ladder

Rank is a *shape* of the optimizer state (projectors, projected momenta,
family signatures, kernel grids), so a rank change is a host-side event at
a projector-refresh boundary:

1. the policy decides a new :class:`RankMap` (for ``spectral``, from the
   per-family spectrum probes ``lowrank(probe_spectrum=True)`` stores in
   ``LowRankState.probes`` at each refresh),
2. :func:`migrate_opt_state` resizes the optimizer state — rank-axis
   tensors (projectors, projected momenta, probes) are truncated or
   zero-padded, everything else (Python-int counts, gamma slot assignments,
   ``layerwise_unbias`` full-rank slots, fallback AdamW state) is carried
   over unchanged,
3. the transform is rebuilt at the new map (under ``fuse_families=True`` the
   family plan re-plans: rank is part of the family signature).

Policies only emit ranks from their declared ``ladder``, which bounds the
transforms a run builds.  :class:`RankPolicyController` packages the loop
for the trainer: boundary detection from the lowrank step count, probe
aggregation, decision, state migration, a per-map transform cache, and
checkpoint round-tripping (``state_dict`` / ``load_state_dict`` ride in the
checkpoint's extras, so resume is exact across a rank change).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any


# ---------------------------------------------------------------------------
# RankMap — a frozen, hashable per-shape rank assignment
# ---------------------------------------------------------------------------


class RankMap:
    """Static per-family rank assignment: ``(m, n) -> rank``.

    Everywhere the low-rank stack takes an ``int`` rank it also takes a
    RankMap (``family_shape`` resolves it per leaf shape).  Hashable and
    comparable, so the controller's transform cache keys on it."""

    __slots__ = ("default", "overrides")

    def __init__(self, default: int, overrides: dict | tuple = ()):
        self.default = int(default)
        items = overrides.items() if isinstance(overrides, dict) else overrides
        # Canonical form: overrides equal to the default are dropped, so maps
        # that assign identical ranks compare (and hash) equal — a policy
        # re-emitting the current assignment is a no-op, not a migration.
        self.overrides = tuple(sorted(
            ((int(m), int(n)), int(r)) for (m, n), r in items
            if int(r) != self.default
        ))

    def rank_for(self, m: int, n: int) -> int:
        for (om, on), r in self.overrides:
            if om == m and on == n:
                return r
        return self.default

    def with_override(self, m: int, n: int, r: int) -> "RankMap":
        d = dict(self.overrides)
        d[(int(m), int(n))] = int(r)
        return RankMap(self.default, d)

    def __eq__(self, other) -> bool:
        return (isinstance(other, RankMap)
                and self.default == other.default
                and self.overrides == other.overrides)

    def __hash__(self) -> int:
        return hash((self.default, self.overrides))

    def __repr__(self) -> str:
        ov = {f"{m}x{n}": r for (m, n), r in self.overrides}
        return f"RankMap(default={self.default}, overrides={ov})"

    # JSON round-trip (checkpoint extras are json.dump'd)
    def to_json(self) -> dict:
        return {"default": self.default,
                "overrides": [[m, n, r] for (m, n), r in self.overrides]}

    @staticmethod
    def from_json(d: dict) -> "RankMap":
        return RankMap(d["default"],
                       {(m, n): r for m, n, r in d.get("overrides", [])})


def resolve_rank(rank, m: int, n: int) -> int:
    """An ``int | RankMap`` rank argument resolved for one ``(m, n)`` shape
    (before the usual ``min(rank, m, n)`` clamp)."""
    if isinstance(rank, int):
        return rank
    return rank.rank_for(m, n)


def default_ladder(r_min: int, r_max: int) -> tuple[int, ...]:
    """Power-of-two ladder from ``r_min`` up to and including ``r_max``."""
    out = []
    r = int(r_min)
    while r < r_max:
        out.append(r)
        r *= 2
    out.append(int(r_max))
    return tuple(sorted(set(out)))


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class RankPolicy:
    """Base: a policy maps (its own state, step/probes) -> RankMap.

    ``wants_probes`` turns on spectrum probing inside ``lowrank()``;
    ``ladder`` declares every rank the policy may ever emit; decisions are
    evaluated only at refresh boundaries."""

    wants_probes: bool = False

    def ladder(self) -> tuple[int, ...]:
        raise NotImplementedError

    def initial_map(self, default_rank: int) -> RankMap:
        raise NotImplementedError

    def init_state(self) -> dict:
        return {}

    def decide(self, pstate: dict, step: int, probes: dict,
               current: RankMap) -> tuple[dict, Optional[RankMap]]:
        """(policy state, lowrank step count, {(m, n): {"sv2", "g2"}},
        current map) -> (new policy state, new RankMap or None for "no
        change").  Emitting a map equal to ``current`` is also a no-op."""
        return pstate, None


class fixed(RankPolicy):
    """The legacy behavior as a policy: one rank, forever."""

    def __init__(self, rank: int):
        self.rank = int(rank)

    def ladder(self) -> tuple[int, ...]:
        return (self.rank,)

    def initial_map(self, default_rank: int) -> RankMap:
        return RankMap(self.rank)

    def __repr__(self) -> str:
        return f"fixed({self.rank})"


class stepwise(RankPolicy):
    """Piecewise-constant rank schedule ``{step: rank}``: at lowrank step
    count ``t`` the rank is the value at the largest key ``<= t``.  Before
    the first threshold the configured base rank applies (so
    ``stepwise({500: 64})`` with ``cfg.rank=128`` trains at 128 until step
    500, then drops).  Changes take effect at the first refresh boundary at
    or after each threshold, where the projector is about to be recomputed."""

    def __init__(self, schedule: dict[int, int]):
        if not schedule:
            raise ValueError("stepwise needs a non-empty {step: rank} schedule")
        self.schedule = tuple(sorted((int(s), int(r))
                                     for s, r in schedule.items()))

    def _rank_at(self, step: int, default: int) -> int:
        r = default
        for s, v in self.schedule:
            if step >= s:
                r = v
        return r

    def ladder(self) -> tuple[int, ...]:
        # (plus the pre-first-threshold base rank, which is config-supplied)
        return tuple(sorted({r for _, r in self.schedule}))

    def initial_map(self, default_rank: int) -> RankMap:
        return RankMap(self._rank_at(0, default_rank))

    def decide(self, pstate, step, probes, current):
        return pstate, RankMap(self._rank_at(step, current.default))

    def __repr__(self) -> str:
        return f"stepwise({dict(self.schedule)})"


class per_family(RankPolicy):
    """Static per-shape-family ranks: ``{(m, n): rank}`` with a default for
    unlisted shapes.  Never changes over time."""

    def __init__(self, ranks: dict[tuple[int, int], int],
                 default: Optional[int] = None):
        self.ranks = {(int(m), int(n)): int(r) for (m, n), r in ranks.items()}
        self.default = default

    def ladder(self) -> tuple[int, ...]:
        out = set(self.ranks.values())
        if self.default is not None:
            out.add(int(self.default))
        return tuple(sorted(out))

    def initial_map(self, default_rank: int) -> RankMap:
        d = default_rank if self.default is None else self.default
        return RankMap(d, self.ranks)

    def __repr__(self) -> str:
        return f"per_family({self.ranks}, default={self.default})"


class spectral(RankPolicy):
    """Spectrum-driven adaptive rank.

    At each refresh, ``lowrank(probe_spectrum=True)`` stores per family the
    squared singular values ``sv2`` of the projected gradient sketch ``PᵀG``
    (summed over stacked blocks) and the total gradient energy ``g2 =
    ||G||_F²``.  The captured-energy curve ``E(k) = (sv2[0] + ... +
    sv2[k-1]) / g2`` drives the decision per ``(m, n)`` family, snapped to
    the declared ``ladder`` within ``[r_min, r_max]``:

      * shrink to the smallest ladder rank ``k`` with ``E(k) >= target_energy``,
      * or grow one ladder step above the current rank when even the full
        current rank misses the target.

    ``probe_every`` rate-limits decisions to every that-many steps; None
    decides at every refresh boundary.

    Hysteresis: a starvation grow sets a per-family rank floor at the grown
    rank; shrink decisions clamp to it until it expires ``floor_ttl``
    decisions later, so a shrink-grow-shrink oscillation cannot start."""

    wants_probes = True

    def __init__(
        self,
        target_energy: float = 0.99,
        probe_every: Optional[int] = None,
        r_min: int = 8,
        r_max: int = 256,
        ladder: Optional[tuple[int, ...]] = None,
        init_rank: Optional[int] = None,
        floor_ttl: int = 8,
    ):
        if not 0.0 < target_energy <= 1.0:
            raise ValueError(f"target_energy must be in (0, 1]: {target_energy}")
        self.target_energy = float(target_energy)
        self.probe_every = probe_every
        self.r_min = int(r_min)
        self.r_max = int(r_max)
        lad = tuple(sorted(ladder)) if ladder else default_ladder(r_min, r_max)
        self._ladder = tuple(r for r in lad if self.r_min <= r <= self.r_max)
        if not self._ladder:
            raise ValueError(f"empty ladder within [{r_min}, {r_max}]: {lad}")
        self.init_rank = init_rank
        self.floor_ttl = int(floor_ttl)

    def ladder(self) -> tuple[int, ...]:
        return self._ladder

    def _snap(self, r: int) -> int:
        """Smallest ladder rank >= r (largest ladder rank if none)."""
        for v in self._ladder:
            if v >= r:
                return v
        return self._ladder[-1]

    def initial_map(self, default_rank: int) -> RankMap:
        r0 = self.init_rank if self.init_rank is not None else default_rank
        return RankMap(self._snap(min(max(r0, self.r_min), self.r_max)))

    def init_state(self) -> dict:
        # "floors": {"MxN": [floor_rank, expires_at_decision]} (JSON-friendly
        # for the checkpoint's extras).
        return {"last_decision_step": None, "decisions": 0, "floors": {}}

    def decide(self, pstate, step, probes, current):
        last = pstate.get("last_decision_step")
        if self.probe_every and last is not None \
                and step - last < self.probe_every:
            return pstate, None
        if not probes:
            return pstate, None
        new = dict(pstate)
        new["last_decision_step"] = int(step)
        decisions = int(pstate.get("decisions", 0)) + 1
        new["decisions"] = decisions
        floors = {k: [int(v[0]), int(v[1])]
                  for k, v in dict(pstate.get("floors", {})).items()
                  if int(v[1]) > decisions}
        new_map = current
        for (m, n), pr in sorted(probes.items()):
            g2 = float(pr["g2"])
            sv2 = np.sort(np.asarray(pr["sv2"], dtype=np.float64))[::-1]
            cur = int(pr["rank"])
            if g2 <= 0.0 or sv2.size == 0:
                continue
            key = f"{m}x{n}"
            energy = np.cumsum(sv2) / g2
            hit = np.nonzero(energy >= self.target_energy)[0]
            if hit.size:
                r_new = self._snap(int(hit[0]) + 1)
                if key in floors:
                    # A recent starvation grow owns this family: hold the floor.
                    r_new = max(r_new, floors[key][0])
            else:
                # Even the full probed rank misses the target: grow one
                # ladder step above the current rank (bounded by r_max) and
                # floor the family there for floor_ttl decisions.
                above = [v for v in self._ladder if v > cur]
                r_new = above[0] if above else self._ladder[-1]
                floors[key] = [r_new, decisions + self.floor_ttl]
            # Never emit more rank than the family can hold.
            new_map = new_map.with_override(m, n, min(r_new, m, n))
        new["floors"] = floors
        return new, new_map

    def __repr__(self) -> str:
        return (f"spectral(target_energy={self.target_energy}, "
                f"ladder={self._ladder})")


# ---------------------------------------------------------------------------
# Spec parsing (OptimizerConfig.rank_policy / rank_ladder)
# ---------------------------------------------------------------------------


def parse_rank_policy(
    spec: str,
    ladder: tuple[int, ...] = (),
    r_min: int = 8,
    r_max: int = 256,
) -> RankPolicy:
    """Parse a policy spec:

      "fixed:64"  (or just "64")            -> fixed(64)
      "stepwise:0=128,500=64,2000=32"       -> stepwise({0:128,500:64,2000:32})
      "family:512x512=32,1024x4096=128"     -> per_family({...})
      "spectral" | "spectral:0.99"          -> spectral(target_energy=0.99,
                                               ladder=<ladder or powers of
                                               two in [r_min, r_max]>)
    """
    kind, _, arg = spec.partition(":")
    kind = kind.strip().lower()
    if kind.isdigit():
        return fixed(int(kind))
    if kind == "fixed":
        return fixed(int(arg))
    if kind == "stepwise":
        sched = {}
        for part in arg.split(","):
            s, _, r = part.partition("=")
            sched[int(s)] = int(r)
        return stepwise(sched)
    if kind == "family":
        ranks = {}
        for part in arg.split(","):
            mn, _, r = part.partition("=")
            m, _, n = mn.partition("x")
            ranks[(int(m), int(n))] = int(r)
        return per_family(ranks)
    if kind == "spectral":
        kw: dict = {"r_min": r_min, "r_max": r_max}
        if ladder:
            kw["ladder"] = tuple(ladder)
            kw["r_min"] = min(ladder)
            kw["r_max"] = max(ladder)
        if arg:
            kw["target_energy"] = float(arg)
        return spectral(**kw)
    raise ValueError(f"unknown rank-policy spec: {spec!r}")


def as_policy(
    policy, ladder: tuple[int, ...] = (), r_min: int = 8, r_max: int = 256
) -> Optional[RankPolicy]:
    """None | spec string | RankPolicy -> RankPolicy (None passes through)."""
    if policy is None or isinstance(policy, RankPolicy):
        return policy
    if isinstance(policy, str):
        return parse_rank_policy(policy, ladder=ladder, r_min=r_min, r_max=r_max)
    raise TypeError(f"rank_policy must be None, a spec string or a "
                    f"RankPolicy, got {type(policy).__name__}")


# ---------------------------------------------------------------------------
# State migration
# ---------------------------------------------------------------------------


def _structure(tree: PyTree):
    """A comparable description of a state tree's containers: dicts with
    their keys, tuples and NamedTuples with their types, ``None``, and the
    kind of each leaf (a tensor or a Python scalar type) — not shapes."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if isinstance(tree, torch.Tensor):
        return "tensor"
    return type(tree).__name__


def _slice_copy(old, new_tmpl):
    """The overlapping hyperrectangle of ``old`` in zeros shaped like
    ``new_tmpl`` (truncate / zero-pad per axis), on ``old``'s device in the
    template's dtype.  A non-tensor leaf (a Python-int count) is carried."""
    if not isinstance(old, torch.Tensor):
        return old
    if old.shape == new_tmpl.shape:
        return old if old.dtype == new_tmpl.dtype else old.to(new_tmpl.dtype)
    if old.dim() != new_tmpl.dim():
        raise ValueError(
            f"cannot migrate leaf: rank-{old.dim()} tensor {tuple(old.shape)} -> "
            f"rank-{new_tmpl.dim()} template {tuple(new_tmpl.shape)}")
    sl = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, new_tmpl.shape))
    out = torch.zeros(new_tmpl.shape, dtype=new_tmpl.dtype, device=old.device)
    out[sl] = old[sl].to(new_tmpl.dtype)
    return out


def _migrate(old, new):
    if old is None:
        return None
    if isinstance(old, dict):
        return {k: _migrate(v, new[k]) for k, v in old.items()}
    if isinstance(old, tuple) and hasattr(old, "_fields"):
        return type(old)(*(_migrate(o, n) for o, n in zip(old, new)))
    if isinstance(old, (tuple, list)):
        return type(old)(_migrate(o, n) for o, n in zip(old, new))
    return _slice_copy(old, new)


def migrate_opt_state(old_state: PyTree, new_template: PyTree) -> PyTree:
    """Resize an optimizer state onto a new rank assignment.

    ``new_template`` is ``new_transform.init(params)`` — the exact target
    shapes.  Tensors whose shapes match are carried over (step counts,
    gamma slot assignments, full-rank slots, fallback AdamW moments);
    mismatched ones — projectors ``(*lead, s, r)``, projected momenta
    ``(*lead, r, n)`` / ``(*lead, m, r)``, spectrum probes ``(r,)`` — are
    truncated (a projector's leading columns are its top singular
    directions) or zero-padded (grown columns stay inert until the next
    refresh recomputes the projector at the new rank).  Python-int counters
    are carried as they are.

    Both trees must have the same *structure*: rank changes shapes, never
    the chain or family layout (same-(m, n) leaves always share one rank,
    so the family plan regroups identically)."""
    old_def, new_def = _structure(old_state), _structure(new_template)
    if old_def != new_def:
        raise ValueError(
            "optimizer-state structure changed across the rank migration — "
            "rank policies may only change shapes, not the transform "
            f"composition (old: {old_def}, new: {new_def})")
    return _migrate(old_state, new_template)


# ---------------------------------------------------------------------------
# Controller — the host-side decision/migration loop
# ---------------------------------------------------------------------------


def gather_probes(opt_state: PyTree) -> dict[tuple[int, int], dict]:
    """Aggregate the spectrum probes out of every ``LowRankState`` in an
    optimizer state: ``{(m, n): {"sv2": (r,), "g2": float, "rank": int}}``,
    summed over leaves / families of the same shape (one rank decision per
    shape family).  Every probe crosses to the host in one copy."""
    from repro_torch.core.combinators import find_lowrank_states

    probes = [pr for st in find_lowrank_states(opt_state) if st.probes is not None
              for pr in st.probes.values() if pr is not None]
    if not probes:
        return {}
    device = probes[0]["sv2"].device
    parts = [torch.cat([pr["mn"].to(device=device, dtype=torch.float64),
                        pr["g2"].to(device=device, dtype=torch.float64).reshape(1),
                        pr["sv2"].to(device=device, dtype=torch.float64)])
             for pr in probes]
    flat = torch.cat(parts).cpu().numpy()
    out: dict[tuple[int, int], dict] = {}
    at = 0
    for pr in probes:
        r = int(pr["sv2"].shape[0])
        mn = (int(flat[at]), int(flat[at + 1]))
        g2, sv2 = float(flat[at + 2]), flat[at + 3:at + 3 + r]
        at += 3 + r
        cur = out.setdefault(mn, {"sv2": np.zeros_like(sv2), "g2": 0.0, "rank": r})
        k = min(cur["sv2"].shape[0], r)
        cur["sv2"][:k] += sv2[:k]
        cur["g2"] += g2
    return out


class RankPolicyController:
    """Drives a :class:`RankPolicy` over a live training run.

    ``build(rank_map) -> Transform`` rebuilds the optimizer at a given
    assignment (e.g. ``lambda m: build_optimizer(cfg, rank_map=m)``).  Call
    :meth:`maybe_update` every step BEFORE the train step: at refresh
    boundaries (decided from the lowrank step count, so NaN-skipped steps
    cannot desync it) the policy is consulted and, when the map changes,
    the optimizer state is migrated and :meth:`transform` returns the
    rebuilt chain.  Transforms are cached per map."""

    def __init__(self, policy: RankPolicy, build: Callable[[RankMap], Any],
                 *, period: int, default_rank: int = 128,
                 reshard: Optional[Callable[[PyTree], PyTree]] = None):
        """``reshard(state) -> state`` maps a state in the whole layout to
        this rank's (``combinators.shard_family_state`` under a mesh with
        ``shard_state``): the new rank's template goes through it before
        the migration, so a split state migrates row by row, and the
        migrated state is this rank's share of the replicated run's."""
        self.policy = policy
        self.build = build
        self.period = int(period)
        self.reshard = reshard
        self._pstate = policy.init_state()
        self._map = policy.initial_map(default_rank)
        self._cache: dict[RankMap, Any] = {}
        self.history: list[tuple[int, RankMap]] = [(0, self._map)]

    @property
    def current_map(self) -> RankMap:
        return self._map

    def transform(self, rank_map: Optional[RankMap] = None):
        m = rank_map if rank_map is not None else self._map
        t = self._cache.get(m)
        if t is None:
            t = self._cache[m] = self.build(m)
        return t

    def _count(self, opt_state) -> int:
        from repro_torch.core.combinators import find_lowrank_states

        states = find_lowrank_states(opt_state)
        if not states:
            raise ValueError(
                "RankPolicyController found no LowRankState in the optimizer "
                "state — rank policies require a lowrank() stage")
        return int(states[0].count)

    def maybe_update(self, opt_state: PyTree,
                     params: PyTree) -> tuple[PyTree, bool]:
        """Consult the policy at a refresh boundary; migrate the state when
        the rank assignment changes.  Returns ``(opt_state, changed)`` — on
        ``changed`` the caller must re-fetch :meth:`transform`."""
        count = self._count(opt_state)
        if count <= 0 or count % self.period != 0:
            return opt_state, False
        probes = gather_probes(opt_state) if self.policy.wants_probes else {}
        self._pstate, new_map = self.policy.decide(
            self._pstate, count, probes, self._map)
        if new_map is None or new_map == self._map:
            return opt_state, False
        new_t = self.transform(new_map)
        template = new_t.init(params)
        if self.reshard is not None:
            template = self.reshard(template)
        migrated = migrate_opt_state(opt_state, template)
        self._map = new_map
        self.history.append((count, new_map))
        return migrated, True

    def state_dict(self) -> dict:
        """JSON-serializable snapshot (rides in the checkpoint's extras):
        restoring it before the optimizer-state restore makes resume exact
        across rank changes (the template must be built at the saved map).
        Deep-copied, since the policy state nests (spectral's floors)."""
        return copy.deepcopy({
            "map": self._map.to_json(),
            "pstate": {k: (int(v) if isinstance(v, (bool, np.integer)) else v)
                       for k, v in self._pstate.items()},
            "history": [[s, m.to_json()] for s, m in self.history],
        })

    def load_state_dict(self, d: dict) -> None:
        self._map = RankMap.from_json(d["map"])
        self._pstate = copy.deepcopy(dict(d.get("pstate", {})))
        self.history = [(int(s), RankMap.from_json(m))
                        for s, m in d.get("history", [])] or [(0, self._map)]
