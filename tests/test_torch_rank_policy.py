"""The port's rank-policy engine (``repro_torch.core.rank_policy``) against
the JAX package's, in process, at the reference test's sizes
(``tests/test_rank_policy.py``: ``PARAMS`` with a stacked (3, 16, 24)
leaf, a single (16, 24) one and a ragged (20, 9) one on the right side;
the llama-60m SMOKE recipe for the trainer).

* ``RankMap``, the spec parser and the stepwise threshold: equal reprs,
  JSON and ladders.
* ``migrate_opt_state``: truncation, zero padding, carried leaves (Python
  counts, sampled block ids) and the structure error, beside the
  reference's migration of its own state.
* The migration contract: a stepwise 8 -> 3 drop at a refresh boundary
  gives bitwise the updates of a fresh rank-3 run from the first refresh
  after it, per leaf and family-stacked, at ``pad_rank_to`` 0 and 128; and
  the same drop tracks the reference's updates within 1e-5 of each leaf's
  largest entry at every step, with the reference's block draws
  (``sampler``) and range-finder draws (``noise``, the rsvd projector, so
  projector signs agree) injected.
* The spectrum probe (``gather_probes``): ``sv2`` sums and ``g2`` within
  1e-4 relative of the reference's; spectral decisions, the grow
  hysteresis and the floor's expiry give equal maps and policy state;
  rank-2 gradients shrink the ladder along the same history, to a smaller
  state.
* Checkpoints: the rank-mismatch and ``fuse_families`` layout errors, and a
  probed state's leaf paths, shapes and dtypes equal to the reference's.
* The ``Trainer`` across a stepwise drop: 8 steps + 2 resumed equal 10
  bitwise; the final controller state equals the reference trainer's, and
  GUM's leaves agree within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import combinators as JC
from repro.core import family_plan as jfamily_plan
from repro.core import rank_policy as JRP
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.core import combinators as C
from repro_torch.core import family_plan
from repro_torch.core import rank_policy as RP
import repro_torch.core as core
from torch_threads import _one_thread  # noqa: F401  (autouse)

KEY = jax.random.PRNGKey(0)

J_PARAMS = {
    "blocks": jax.random.normal(jax.random.fold_in(KEY, 0), (3, 16, 24)) * 0.1,
    "single": jax.random.normal(jax.random.fold_in(KEY, 1), (16, 24)) * 0.1,
    "ragged": jax.random.normal(jax.random.fold_in(KEY, 2), (20, 9)) * 0.1,
}


def to_torch(tree: dict) -> dict:
    """A flat dict of arrays as the port's tree: its leaves in the
    reference's flatten order (sorted keys)."""
    return {k: torch.from_numpy(np.array(tree[k])) for k in sorted(tree)}


PARAMS = to_torch(J_PARAMS)


@functools.lru_cache(maxsize=None)
def j_grads_at(step):
    """The reference test's per-step synthetic gradients."""
    return jax.tree_util.tree_map(
        lambda p, i=step: p + 0.03 * jax.random.normal(jax.random.fold_in(KEY, 1000 + i),
                                                       p.shape),
        J_PARAMS)


def jax_key(key, split):
    """The reference's key for the port's ``key = (seed, count, leaf)``:
    ``fold_in`` twice, then the projector half (``split=0``) or the
    sampling half (``split=1``) of its split, as ``lowrank`` derives them
    for an inner transform that samples (``layerwise_unbias``)."""
    seed, count, leaf = key
    return jax.random.split(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), count), leaf))[split]


def jax_noise(key, kind, shape):
    draw = {"normal": jax.random.normal, "gumbel": jax.random.gumbel,
            "uniform": jax.random.uniform}[kind]
    return torch.from_numpy(np.array(draw(jax_key(key, 0), shape)))


def jax_sampler(key, L, g_f):
    return torch.from_numpy(np.array(jax.random.choice(
        jax_key(key, 1), L, (g_f,), replace=False)).astype(np.int64))


def assert_close_leaves(got: dict, want, what: str, tol: float = 1e-5) -> None:
    """Each leaf within ``tol`` of the reference leaf's largest entry."""
    for k, g in got.items():
        w = np.asarray(want[k])
        assert tuple(g.shape) == w.shape, (what, k)
        err = float(np.max(np.abs(g.numpy() - w))) / max(float(np.max(np.abs(w))), 1e-30)
        assert err <= tol, f"{what} {k}: {err:.2e} > {tol}"


def assert_same_state(state, jstate) -> None:
    """The port's state against the reference's, leaf for leaf (the port's
    trees flatten in the reference's order): shapes equal, counts and block
    ids exact, floats within 1e-5 of the leaf's largest entry."""
    ours, theirs = flatten_with_paths(state), jax.tree_util.tree_leaves(jstate)
    assert len(ours) == len(theirs)
    for (path, x), y in zip(ours, theirs):
        y = np.asarray(y)
        if not isinstance(x, torch.Tensor):
            assert x == int(y), path
            continue
        assert tuple(x.shape) == y.shape, path
        if not x.is_floating_point():
            assert np.array_equal(x.numpy(), y), path
        else:
            scale = max(float(np.max(np.abs(y))), 1e-30)
            assert float(np.max(np.abs(x.numpy() - y))) <= 1e-5 * scale, path


# ----------------------------------------------------------- RankMap / specs


def test_rank_map_matches_reference():
    for args in [(64, {(16, 24): 8, (20, 9): 4}), (8, {(16, 24): 8}), (8,),
                 (4, (((20, 9), 2),))]:
        ours, theirs = RP.RankMap(*args), JRP.RankMap(*args)
        assert repr(ours) == repr(theirs) and ours.to_json() == theirs.to_json()
        assert hash(ours) == hash(theirs)
        assert RP.RankMap.from_json(theirs.to_json()) == ours
    m = RP.RankMap(64, {(16, 24): 8, (20, 9): 4})
    assert (m.rank_for(16, 24), m.rank_for(20, 9), m.rank_for(100, 100)) == (8, 4, 64)
    assert RP.RankMap(8, {(16, 24): 8}) == RP.RankMap(8)  # canonical form
    assert m.with_override(20, 9, 64) == RP.RankMap(64, {(16, 24): 8})
    assert RP.default_ladder(8, 100) == JRP.default_ladder(8, 100) == (8, 16, 32, 64, 100)
    jm = JRP.RankMap.from_json(m.to_json())
    assert RP.resolve_rank(m, 20, 9) == JRP.resolve_rank(jm, 20, 9) == 4
    assert RP.resolve_rank(7, 20, 9) == JRP.resolve_rank(7, 20, 9) == 7


SPECS = [("fixed:64", ()), ("64", ()), ("stepwise:0=128,500=64", ()),
         ("stepwise:500=64", ()), ("family:512x512=32,1024x256=64", ()),
         ("spectral", ()), ("spectral:0.9", (4, 8, 16))]


@pytest.mark.parametrize("spec,ladder", SPECS)
def test_parse_rank_policy_matches_reference(spec, ladder):
    ours = RP.parse_rank_policy(spec, ladder=ladder)
    theirs = JRP.parse_rank_policy(spec, ladder=ladder)
    assert repr(ours) == repr(theirs) and type(ours).__name__ == type(theirs).__name__
    assert ours.ladder() == theirs.ladder() and ours.wants_probes == theirs.wants_probes
    assert ours.initial_map(128).to_json() == theirs.initial_map(128).to_json()
    assert ours.init_state() == theirs.init_state()
    for step in (0, 499, 500, 600):
        mine = ours.decide(ours.init_state(), step, {}, RP.RankMap(128))
        ref = theirs.decide(theirs.init_state(), step, {}, JRP.RankMap(128))
        assert mine[0] == ref[0]
        assert (mine[1] is None) == (ref[1] is None)
        assert mine[1] is None or mine[1].to_json() == ref[1].to_json()
    # the OptimizerConfig entry point, with and without a ladder
    for kw in (dict(), dict(rank_ladder=(4, 8, 16)), dict(rank=300)):
        got = core.resolve_rank_policy(core.OptimizerConfig(rank_policy=spec, **kw))
        want = jcore.resolve_rank_policy(jcore.OptimizerConfig(rank_policy=spec, **kw))
        assert repr(got) == repr(want) and got.ladder() == want.ladder()


def test_bad_specs_raise_as_the_reference_does():
    for pkg in (RP, JRP):
        with pytest.raises(ValueError):
            pkg.parse_rank_policy("nope:1")
        with pytest.raises(ValueError):
            pkg.stepwise({})
        with pytest.raises(ValueError):
            pkg.spectral(target_energy=0.0)
        with pytest.raises(TypeError):
            pkg.as_policy(3.5)
    assert RP.as_policy(None) is None
    pol = RP.fixed(4)
    assert RP.as_policy(pol) is pol


def test_stepwise_threshold_snapping():
    for pkg in (RP, JRP):
        pol = pkg.stepwise({0: 8, 10: 4, 20: 2})
        assert [pol._rank_at(s, 99) for s in (0, 9, 10, 19, 20, 99)] == [8, 8, 4, 4, 2, 2]
        assert pol.ladder() == (2, 4, 8)
        # without a step-0 key the configured base rank applies until the
        # first threshold
        pol = pkg.stepwise({500: 64})
        assert pol.initial_map(128) == pkg.RankMap(128)
        assert pol.decide({}, 400, {}, pkg.RankMap(128))[1] == pkg.RankMap(128)
        assert pol.decide({}, 500, {}, pkg.RankMap(128))[1] == pkg.RankMap(64)


@pytest.mark.parametrize("spec", ["fixed:4", "4", "stepwise:0=8,6=4", "family:16x24=4",
                                  "spectral:0.9"])
def test_every_spec_builds_a_chain_like_the_reference(spec):
    """``OptimizerConfig(rank_policy=..., rank_ladder=...)`` builds GUM in
    both packages, with equal projector shapes and the same probes."""
    kw = dict(name="gum", lr=1e-2, rank=8, gamma=1, period=3, rank_policy=spec,
              rank_ladder=(2, 4, 8) if spec.startswith("spectral") else ())
    state = core.build_optimizer(core.OptimizerConfig(**kw)).init(PARAMS)
    jstate = jcore.build_optimizer(jcore.OptimizerConfig(kernel_impl="jnp", **kw)).init(J_PARAMS)
    low, jlow = core.find_lowrank_states(state)[0], jcore.find_lowrank_states(jstate)[0]
    assert {k: tuple(p.shape) for k, p in low.projs.items() if p is not None} == \
        {k: tuple(p.shape) for k, p in jlow.projs.items() if p is not None}
    assert (low.probes is None) == (jlow.probes is None)


def test_rank_map_splits_families_as_the_reference_plan_does():
    """A per-family map's resolved rank enters the family signature: the
    SMOKE model's hidden matrices group into the same families, at the same
    ranks, as in the reference's plan."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.lowrank_common import default_lowrank_filter
    from repro_torch.models import build_model

    params = build_model(get_smoke("llama-60m"), device="meta").params()
    leaves = [p if default_lowrank_filter(k, p) else None for k, p in params.items()]
    jleaves = [None if p is None else jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
               for p in leaves]
    for rank in (8, RP.RankMap(8, {(64, 256): 4}), RP.RankMap(16, {(64, 64): 2})):
        jrank = rank if isinstance(rank, int) else JRP.RankMap.from_json(rank.to_json())
        plan = family_plan.build_family_plan(leaves, rank)
        jplan = jfamily_plan.build_family_plan(jleaves, jrank)
        assert [(f.members, tuple(f.member_fs), tuple(f.fs)) for f in plan.families] == \
            [(f.members, tuple(f.member_fs), tuple(f.fs)) for f in jplan.families]


# ----------------------------------------------------------- migration


def _chain(rank, period=4, ff=False, prt=0, gamma=1, projector="svd", draws=False,
           rank_policy=None):
    extra = dict(sampler=jax_sampler) if draws else {}
    return C.chain(
        C.lowrank(C.layerwise_unbias(C.scale_by_momentum(beta=0.9), gamma=gamma, **extra),
                  rank=rank, period=period, reset_on_refresh=True, pad_rank_to=prt,
                  fuse_families=ff, projector=projector, rank_policy=rank_policy,
                  noise=jax_noise if draws else None),
        C.scale_by_lr(0.1))


def _j_chain(rank, period=4, ff=False, prt=0, gamma=1, projector="svd", rank_policy=None):
    return JC.chain(
        JC.lowrank(JC.layerwise_unbias(JC.scale_by_momentum(beta=0.9), gamma=gamma),
                   rank=rank, period=period, reset_on_refresh=True, kernel_impl="jnp",
                   pad_rank_to=prt, fuse_families=ff, projector=projector,
                   rank_policy=rank_policy),
        JC.scale_by_lr(0.1))


@pytest.mark.parametrize("ff", [False, True], ids=["perleaf", "fused"])
def test_migrate_truncates_pads_and_carries(ff):
    """(The reference's migration of its own state is held leaf for leaf
    against this one in ``test_stepwise_drop_tracks_the_reference``.)"""
    t_hi, t_lo = _chain(RP.RankMap(6), ff=ff), _chain(RP.RankMap(3), ff=ff)
    st = t_hi.init(PARAMS)
    for step in range(3):
        _, st = t_hi.update(to_torch(j_grads_at(step)), st, PARAMS)
    mig = RP.migrate_opt_state(st, t_lo.init(PARAMS))
    for (path, x), (_, y) in zip(flatten_with_paths(mig),
                                 flatten_with_paths(t_lo.init(PARAMS))):
        assert type(x) is type(y), path
        assert not isinstance(x, torch.Tensor) or (x.shape, x.dtype) == (y.shape, y.dtype), path

    # within the port: truncation keeps the leading columns, everything else
    # is carried (the Python count and the sampled ids as they were)
    lr_hi, lr_lo = core.find_lowrank_states(st)[0], core.find_lowrank_states(mig)[0]
    assert lr_lo.count == lr_hi.count == 3 and isinstance(lr_lo.count, int)
    for k, hi in lr_hi.projs.items():
        lo = lr_lo.projs[k]
        assert torch.equal(hi[..., :lo.shape[-1]], lo)
        assert lr_lo.inner.idx[k] is lr_hi.inner.idx[k]
    assert mig[1] == st[1]  # ScaleByLrState, carried
    # growing back zero-pads the new columns
    grown = core.find_lowrank_states(RP.migrate_opt_state(mig, t_hi.init(PARAMS)))[0]
    for k, lo in lr_lo.projs.items():
        gr = grown.projs[k]
        assert torch.equal(gr[..., :lo.shape[-1]], lo)
        assert not gr[..., lo.shape[-1]:].any()


def test_migrate_rejects_structure_change():
    other = C.chain(C.lowrank(C.scale_by_momentum(0.9), rank=4), C.scale_by_lr(0.1))
    with pytest.raises(ValueError, match="structure"):
        RP.migrate_opt_state(_chain(RP.RankMap(4)).init(PARAMS), other.init(PARAMS))
    jother = JC.chain(JC.lowrank(JC.scale_by_momentum(0.9), rank=4), JC.scale_by_lr(0.1))
    with pytest.raises(ValueError, match="structure"):
        JRP.migrate_opt_state(_j_chain(JRP.RankMap(4)).init(J_PARAMS), jother.init(J_PARAMS))
    # a leaf whose number of dims changes cannot be migrated either
    with pytest.raises(ValueError, match="cannot migrate"):
        RP.migrate_opt_state({"a": torch.zeros(2, 3)}, {"a": torch.zeros(2, 3, 1)})
    # a policy on a chain without lowrank() has no step count to read
    for pkg, chain, params in ((RP, core.adamw(1e-3), PARAMS),
                               (JRP, jcore.adamw(1e-3), J_PARAMS)):
        ctrl = pkg.RankPolicyController(pkg.fixed(4), lambda m, c=chain: c, period=3)
        with pytest.raises(ValueError, match="LowRankState"):
            ctrl.maybe_update(chain.init(params), params)


def test_migrate_keeps_device_and_casts_to_the_template_dtype():
    old = {"p": torch.arange(6.0).reshape(2, 3), "n": 7, "same": torch.ones(2)}
    new = {"p": torch.zeros(2, 5, dtype=torch.float64), "n": 0, "same": torch.zeros(2)}
    out = RP.migrate_opt_state(old, new)
    assert out["p"].dtype == torch.float64 and out["p"].device == old["p"].device
    assert torch.equal(out["p"][:, :3], old["p"].double()) and not out["p"][:, 3:].any()
    assert out["n"] == 7 and out["same"] is old["same"]


@pytest.mark.parametrize("ff", [False, True], ids=["perleaf", "fused"])
@pytest.mark.parametrize("prt", [0, 128], ids=["nopad", "pad128"])
def test_stepwise_drop_matches_fresh_low_rank_run(ff, prt):
    """A stepwise 8 -> 3 drop at step 8 (a refresh boundary of period 4)
    gives bitwise the updates of a fresh rank-3 run from the first
    refresh after the drop on — per leaf and family-stacked, the ragged
    right-side leaf included, with and without rank padding."""
    period, drop, total = 4, 8, 16
    pol = RP.stepwise({0: 8, drop: 3})
    build = lambda m: _chain(m, period=period, ff=ff, prt=prt)  # noqa: E731
    ctrl = RP.RankPolicyController(pol, build, period=period, default_rank=8)
    opt = ctrl.transform()
    st = opt.init(PARAMS)
    mig_updates, changed_at = [], None
    for step in range(total):
        st, changed = ctrl.maybe_update(st, PARAMS)
        if changed:
            opt, changed_at = ctrl.transform(), step
        u, st = opt.update(to_torch(j_grads_at(step)), st, PARAMS)
        mig_updates.append(u)
    assert changed_at == drop and ctrl.current_map == RP.RankMap(3)
    assert ctrl.history == [(0, RP.RankMap(8)), (drop, RP.RankMap(3))]

    fresh = build(RP.RankMap(3))
    st_f = fresh.init(PARAMS)
    for step in range(total):
        u_f, st_f = fresh.update(to_torch(j_grads_at(step)), st_f, PARAMS)
        if step >= drop:
            for k in PARAMS:
                assert torch.equal(mig_updates[step][k], u_f[k]), (step, k)
    # and the state itself, leaf for leaf
    for (path, x), (_, y) in zip(flatten_with_paths(st), flatten_with_paths(st_f)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, path


def test_stepwise_drop_tracks_the_reference():
    """The same drop in both packages, family-stacked (rsvd projector, so
    the reference's range-finder draws fix each projector's signs too; the
    per-leaf layout is held bitwise to a fresh run above, and to the
    reference at a fixed rank in ``test_torch_gum.py``): updates within 1e-5
    of each leaf's largest entry at every step, before and after the
    migration; the migrated states leaf for leaf (truncated projectors and
    momenta, carried counts and block ids); the same map history."""
    period, drop, total, ff = 4, 8, 12, True
    pol, jpol = RP.stepwise({0: 8, drop: 3}), JRP.stepwise({0: 8, drop: 3})
    ctrl = RP.RankPolicyController(
        pol, lambda m: _chain(m, period=period, ff=ff, projector="rsvd", draws=True),
        period=period, default_rank=8)
    jctrl = JRP.RankPolicyController(
        jpol, lambda m: _j_chain(m, period=period, ff=ff, projector="rsvd"),
        period=period, default_rank=8)
    opt, jopt = ctrl.transform(), jctrl.transform()
    jupdate = jax.jit(jopt.update)
    st, jst = opt.init(PARAMS), jopt.init(J_PARAMS)
    for step in range(total):
        st, changed = ctrl.maybe_update(st, PARAMS)
        jst, jchanged = jctrl.maybe_update(jst, J_PARAMS)
        assert changed == jchanged == (step == drop)
        if changed:
            assert_same_state(st, jst)
            opt, jopt = ctrl.transform(), jctrl.transform()
            jupdate = jax.jit(jopt.update)
        u, st = opt.update(to_torch(j_grads_at(step)), st, PARAMS)
        ju, jst = jupdate(j_grads_at(step), jst, J_PARAMS)
        assert_close_leaves(u, ju, f"step {step}")
    assert [(s, m.to_json()) for s, m in ctrl.history] == \
        [(s, m.to_json()) for s, m in jctrl.history]


# ----------------------------------------------------------- spectral


@functools.lru_cache(maxsize=None)
def j_probes() -> dict:
    """The reference's probes after one refresh, per leaf."""
    jpol = JRP.spectral(target_energy=0.99, r_min=2, r_max=8, ladder=(2, 4, 8))
    jt = JC.chain(JC.lowrank(JC.scale_by_momentum(0.9), rank=8, period=4, kernel_impl="jnp",
                             rank_policy=jpol), JC.scale_by_lr(0.1))
    _, jst = jt.update(j_grads_at(0), jt.init(J_PARAMS), J_PARAMS)
    return JRP.gather_probes(jst)


@pytest.mark.parametrize("ff", [False, True], ids=["perleaf", "fused"])
def test_spectrum_probe_matches_reference(ff):
    """One refresh stores each leaf's (family's) probe; ``gather_probes``
    aggregates them per (m, n) as the reference does: ``sv2`` sums and
    ``g2`` within 1e-4 relative, the same ranks and shapes.  The
    reference's per-leaf probes are the want of both layouts (per (m, n)
    both sum the same blocks)."""
    pol = RP.spectral(target_energy=0.99, r_min=2, r_max=8, ladder=(2, 4, 8))
    t = C.chain(C.lowrank(C.scale_by_momentum(0.9), rank=8, period=4, rank_policy=pol,
                          fuse_families=ff), C.scale_by_lr(0.1))
    _, st = t.update(to_torch(j_grads_at(0)), t.init(PARAMS), PARAMS)
    got, want = RP.gather_probes(st), j_probes()
    assert sorted(got) == sorted(want) == [(16, 24), (20, 9)]
    for mn in want:
        assert got[mn]["rank"] == want[mn]["rank"]
        assert got[mn]["sv2"].shape == want[mn]["sv2"].shape
        np.testing.assert_allclose(got[mn]["sv2"].sum(), want[mn]["sv2"].sum(), rtol=1e-4)
        np.testing.assert_allclose(got[mn]["g2"], want[mn]["g2"], rtol=1e-4)
        assert got[mn]["sv2"].sum() <= got[mn]["g2"] * (1 + 1e-5)
        assert np.all(np.diff(got[mn]["sv2"]) <= 0)  # descending
    # a steady step keeps the refresh's probes
    _, st2 = t.update(to_torch(j_grads_at(1)), st, PARAMS)
    assert st2[0].probes == st[0].probes


SPECTRAL_CASES = {
    # concentrated spectrum: the top 2 carry 99% of the energy -> shrink to 2
    "shrink": ([{(16, 24): {"sv2": [50.0, 49.0, 0.5, 0.25] + [0.0] * 4, "g2": 100.0,
                            "rank": 8}}], 8, {}),
    # flat spectrum far from the target -> grow one ladder step
    "grow": ([{(16, 24): {"sv2": [1.0] * 4, "g2": 100.0, "rank": 4}}], 4, {}),
    # never more than the family holds: a grow to 16 emits 9
    "clamp": ([{(20, 9): {"sv2": [1.0] * 8, "g2": 1e6, "rank": 8}}], 8,
              dict(r_max=16, ladder=(2, 4, 8, 16))),
    # probe_every rate-limits decisions
    "probe_every": ([{(20, 9): {"sv2": [1.0] * 8, "g2": 1e6, "rank": 8}}] * 2, 8,
                    dict(probe_every=100)),
    # the floor's expiry: held at 8 while it lasts, then the shrink wins
    "floor_expires": ([{(16, 24): {"sv2": [95.0] + [0.5] * 7, "g2": 100.0,
                                   "rank": 8}}] * 2, 8, dict(floor_ttl=2)),
}


@pytest.mark.parametrize("case", list(SPECTRAL_CASES))
def test_spectral_decisions_match_reference(case):
    seq, r0, kw = SPECTRAL_CASES[case]
    kw = dict(dict(target_energy=0.9, r_min=2, r_max=8, ladder=(2, 4, 8)), **kw)
    pol, jpol = RP.spectral(**kw), JRP.spectral(**kw)
    ps, jps = pol.init_state(), jpol.init_state()
    if case == "floor_expires":
        ps = {"last_decision_step": None, "decisions": 0, "floors": {"16x24": [8, 2]}}
        jps = {"last_decision_step": None, "decisions": 0, "floors": {"16x24": [8, 2]}}
    cur, jcur = RP.RankMap(r0), JRP.RankMap(r0)
    maps = []
    for i, probes in enumerate(seq):
        probes = {mn: dict(pr, sv2=np.array(pr["sv2"])) for mn, pr in probes.items()}
        ps, m = pol.decide(ps, 4 * (i + 1), probes, cur)
        jps, jm = jpol.decide(jps, 4 * (i + 1), probes, jcur)
        assert ps == jps and (m is None) == (jm is None), (i, ps, jps)
        if m is not None:
            assert m.to_json() == jm.to_json()
            cur, jcur = m, jm
        maps.append(cur.to_json())
    want = {"shrink": 2, "grow": 8, "clamp": 9, "probe_every": 8, "floor_expires": 2}[case]
    mn = next(iter(seq[-1]))
    assert cur.rank_for(*mn) == want, maps
    if case == "floor_expires":
        assert [m["overrides"] for m in maps] == [[], [[16, 24, 2]]] and ps["floors"] == {}


def test_spectral_grow_hysteresis_matches_reference():
    """The oscillating probe sequence (a shrink to 4 starves the next probe,
    which grows back to 8): both packages pin the family at 8 by the floor,
    with the same policy state, which survives a JSON round trip."""
    import json

    at8 = np.array([50.0, 30.0, 9.0, 5.0, 2.0, 1.5, 1.5, 1.0])
    at4 = np.array([40.0, 25.0, 10.0, 5.0])
    hists = []
    for pkg in (RP, JRP):
        pol = pkg.spectral(target_energy=0.9, r_min=2, r_max=8, ladder=(2, 4, 8))
        ps, cur, hist = pol.init_state(), pkg.RankMap(8), []
        for i in range(8):
            r = cur.rank_for(16, 24)
            pr = {"sv2": at8 if r == 8 else at4, "g2": 100.0, "rank": r}
            ps, m = pol.decide(ps, 4 * (i + 1), {(16, 24): pr}, cur)
            cur = m if m is not None else cur
            hist.append(cur.rank_for(16, 24))
        assert json.loads(json.dumps(ps)) == ps
        hists.append((hist, ps))
    assert hists[0] == hists[1]
    assert hists[0][0] == [4, 8, 8, 8, 8, 8, 8, 8]
    assert hists[0][1]["floors"] == {"16x24": [8, 10]}


def lowrank_grads() -> dict:
    """The reference test's rank-2 gradients (rank 1 on the ragged leaf)."""
    u = jax.random.normal(jax.random.fold_in(KEY, 7), (16, 2))
    v = jax.random.normal(jax.random.fold_in(KEY, 8), (2, 24))
    return {"blocks": jnp.stack([u @ v] * 3), "single": u @ v,
            "ragged": jax.random.normal(jax.random.fold_in(KEY, 10), (20, 1))
            @ jax.random.normal(jax.random.fold_in(KEY, 11), (1, 9))}


def spectral_run(pkg, chain, params, grads, ff: bool, jit=lambda f: f):
    """Six updates under a spectral controller (period 2): the controller's
    map history and the state's bytes before and after."""
    pol = pkg.spectral(target_energy=0.95, r_min=2, r_max=8, ladder=(2, 4, 8))
    ctrl = pkg.RankPolicyController(
        pol, lambda m: chain(m, period=2, ff=ff, rank_policy=pol), period=2, default_rank=8)
    opt = ctrl.transform()
    update = jit(opt.update)
    st = opt.init(params)
    state_bytes = (core if pkg is RP else jcore).state_bytes
    before = state_bytes(st)
    for _ in range(6):
        st, changed = ctrl.maybe_update(st, params)
        if changed:
            update = jit(ctrl.transform().update)
        _, st = update(grads, st, params)
    return [(s, m.to_json()) for s, m in ctrl.history], before, state_bytes(st)


@functools.lru_cache(maxsize=None)
def j_spectral_history() -> list:
    """The reference's history, per leaf (its family-stacked run gives the
    same: one decision per (m, n) from the same summed probes)."""
    return spectral_run(JRP, _j_chain, J_PARAMS, lowrank_grads(), False, jax.jit)[0]


@pytest.mark.parametrize("ff", [False, True], ids=["perleaf", "fused"])
def test_spectral_shrinks_on_lowrank_gradients(ff):
    """Rank-2 gradients drive the spectral policy down the ladder along the
    reference's history; the shrunken state is smaller."""
    history, before, after = spectral_run(RP, _chain, PARAMS, to_torch(lowrank_grads()), ff)
    assert history == j_spectral_history()
    assert RP.RankMap.from_json(history[-1][1]).rank_for(16, 24) == 2, history
    assert after < before


# ----------------------------------------------------------- checkpoints


def test_checkpoint_rank_mismatch_and_layout_errors(tmp_path):
    """Both packages refuse a restore at another rank (naming the saved
    RankMap and ``migrate_opt_state`` as the ways out) and a fused state
    into a per-leaf template (naming ``fuse_families``)."""
    for label, mgr_cls, chain, pkg, params, gum, extra in (
            ("torch", CheckpointManager, _chain, RP, PARAMS, core.gum, {}),
            ("jax", JCheckpointManager, _j_chain, JRP, J_PARAMS, jcore.gum,
             dict(kernel_impl="jnp"))):
        mgr = mgr_cls(str(tmp_path / label / "rank"))
        mgr.save(1, chain(pkg.RankMap(6)).init(params))
        with pytest.raises(ValueError, match="rank.*RankMap.*migrate_opt_state"):
            mgr.restore(1, chain(pkg.RankMap(3)).init(params))
        cfg = dict(rank=4, gamma=1, period=3, **extra)
        mgr = mgr_cls(str(tmp_path / label / "layout"))
        mgr.save(1, gum(1e-2, fuse_families=True, **cfg).init(params))
        with pytest.raises(ValueError, match="fuse_families"):
            mgr.restore(1, gum(1e-2, **cfg).init(params))


@pytest.mark.parametrize("ff", [False, True], ids=["perleaf", "fused"])
def test_probed_state_checkpoint_layout_matches_reference(tmp_path, ff):
    """A probed GUM state (spectral policy) checkpoints its low-rank state
    under the reference's leaf paths, shapes and dtypes — the probes' to
    the dtype; the step count and block ids are int64 here, int32 there —
    and after a refresh it round-trips."""
    import json

    kw = dict(rank=8, gamma=1, period=3, fuse_families=ff)
    pol = RP.spectral(0.9, r_min=2, r_max=8, ladder=(2, 4, 8))
    jpol = JRP.spectral(0.9, r_min=2, r_max=8, ladder=(2, 4, 8))
    opt = core.gum(1e-2, rank_policy=pol, **kw)
    jopt = jcore.gum(1e-2, rank_policy=jpol, kernel_impl="jnp", **kw)
    low = core.find_lowrank_states(opt.init(PARAMS))[0]
    jlow = jcore.find_lowrank_states(jopt.init(J_PARAMS))[0]
    CheckpointManager(str(tmp_path / "torch")).save(1, low)
    JCheckpointManager(str(tmp_path / "jax")).save(1, jlow)
    metas = []
    for label in ("torch", "jax"):
        with open(tmp_path / label / "step_000000001" / "manifest.json") as f:
            metas.append([(m["path"], m["shape"], m["dtype"] if m["path"].startswith("probes/")
                           or not m["dtype"].startswith("int") else "int")
                          for m in json.load(f)["leaves"]])
    assert metas[0] == metas[1]
    assert [p for p, _, _ in metas[0] if p.startswith("probes/")][:3] == \
        (["probes/0/g2", "probes/0/mn", "probes/0/sv2"] if ff else
         ["probes/blocks/g2", "probes/blocks/mn", "probes/blocks/sv2"])
    _, st = opt.update(to_torch(j_grads_at(0)), opt.init(PARAMS), PARAMS)
    CheckpointManager(str(tmp_path / "torch")).save(2, st)
    restored, _ = CheckpointManager(str(tmp_path / "torch")).restore(2, opt.init(PARAMS))
    for (path, x), (_, y) in zip(flatten_with_paths(restored), flatten_with_paths(st)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, path


# ----------------------------------------------------------- the trainer


def test_trainer_resume_across_rank_change(tmp_path, monkeypatch):
    """A stepwise drop at step 6 (period 3) through the ``Trainer``: 8 steps,
    then a new ``Trainer`` resuming to 10, equals 10 uninterrupted steps
    bitwise (losses, parameters, optimizer state, controller state); the
    reference's trainer (its initial parameters, its block draws injected)
    ends with the same controller state, losses within rel 1e-4
    (``tests/test_torch_trainer.py``'s bound) and GUM's leaves within
    1e-5.  The AdamW leaves are held within 1e-4 in each leaf's Frobenius
    norm: Adam's step on the embedding's small gradient entries amplifies
    fp32 rounding (1.9e-5 apart after these 10 steps at a fixed rank, with
    no policy)."""
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_smoke as j_get_smoke
    from repro.data import DataConfig as JDataConfig
    from repro.models import build_model as j_build_model
    from repro.train import Trainer as JTrainer
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    monkeypatch.setattr(C, "generator_sampler", jax_sampler)
    opt = dict(name="gum", lr=5e-3, rank=8, gamma=1, period=3,
               rank_policy="stepwise:0=8,6=4")
    cfg = get_smoke("llama-60m")
    data = dict(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0)
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    params0 = params_from_jax(jax.device_get(jparams))

    def run(ckpt_dir, steps):
        tr = Trainer(build_model(cfg, device="cpu"), core.OptimizerConfig(**opt),
                     RunConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=0,
                               log_every=0, seed=0),
                     DataConfig(**data), device="cpu", params=params0)
        return tr, tr.train()

    full, r_full = run(tmp_path / "a", 10)
    assert full.rank_ctrl.current_map == RP.RankMap(4)
    assert full.rank_ctrl.history == [(0, RP.RankMap(8)), (6, RP.RankMap(4))]
    _, r_first = run(tmp_path / "b", 8)  # stops after the rank change
    resumed, r_second = run(tmp_path / "b", 10)
    assert r_second.resumed_from == 8 and len(r_second.losses) == 2
    assert r_first.losses + r_second.losses == r_full.losses
    assert resumed.rank_ctrl.state_dict() == full.rank_ctrl.state_dict()
    pa, pb = full.model.params(), resumed.model.params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    fa, fb = flatten_with_paths(full.opt_state), flatten_with_paths(resumed.opt_state)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, path
    # the low-rank state is at rank 4 after the drop
    low = core.find_lowrank_states(full.opt_state)[0]
    assert all(p.shape[-1] == 4 for p in low.projs.values() if p is not None)

    jtr = JTrainer(j_build_model(j_get_smoke("llama-60m")),
                   jcore.OptimizerConfig(kernel_impl="jnp", **opt),
                   JRunConfig(steps=10, ckpt_dir=str(tmp_path / "jax"), ckpt_every=0,
                              log_every=0, seed=0),
                   JDataConfig(**data))
    j_result = jtr.train()
    assert full.rank_ctrl.state_dict() == jtr.rank_ctrl.state_dict()
    np.testing.assert_allclose(r_full.losses, j_result.losses, rtol=1e-4, atol=0)
    (jp, _), _ = jtr.ckpt.restore(10, jtr.init_state())
    jflat = params_from_jax(jax.device_get(jp))
    for k, p in pa.items():
        diff = p.detach() - jflat[k]
        if k.startswith("blocks/") and "norm" not in k:  # GUM's leaves, rank 8 then 4
            assert float(diff.abs().max()) <= 1e-5, k
        rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(jflat[k]))
        assert rel <= 1e-4, (k, rel)


def test_chip_smoke_phase_4f_counts(tmp_path):
    """``chip_smoke.py`` phase 4f's per-step dispatch counts under a
    spectral policy, at the smoke size on the CPU: GUM's every step, plus
    one projection per probed leaf (the spectrum probe) on the refresh
    steps 1 and 4."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.data import DataConfig
    from repro_torch.kernels import launch_count
    from repro_torch.models import build_model

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_smoke("llama-60m")
    with launch_count.count_launches() as dispatched:
        trainer = cs.policy_trainer_class(torch)(
            build_model(cfg, device="cpu"),
            core.OptimizerConfig(name="gum", lr=5e-3, rank=8, gamma=1, period=3,
                                 rank_policy="spectral:0.99", rank_ladder=(2, 4, 8)),
            RunConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=0, log_every=0, seed=0),
            DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0),
            device="cpu", dispatched=dispatched)
        trainer.train()
    got = [d for _, d, _ in trainer.per_step]
    want = [dict(cs.GUM_DISPATCH, project=cs.GUM_DISPATCH["project"] + 7 * (step % 3 == 1))
            for step in range(1, 7)]
    assert got == want
