"""The port's GUM optimizer against the live JAX reference
(``repro.core.build_optimizer``, ``kernel_impl="jnp"``) for 8 update steps
on the llama-60m SMOKE parameter tree, across refresh boundaries
(``period=3``: refreshes at steps 1, 4 and 7).

Each step both sides get the same gradients (numpy, seeded): a planted
rank-4 signal above a noise floor, so the top-4 SVD subspace is separated
by a gap and stable across LAPACK builds, with most of the energy outside
it, as in real gradients.  The reference's sampled blocks are read from its
state and injected through the port's ``sampler``.  Projectors are compared
as ``P Pᵀ`` (SVD sign freedom, atol 1e-5); updates within rtol 1e-4 in each
leaf's Frobenius norm.  (Why a norm: with the paper compensation the sampled
block's residual ``G − P Pᵀ G`` is exactly zero in span(P) but for fp32
rounding, and Newton–Schulz amplifies such tiny singular values up to
a⁵ ≈ 485×, so those few entries carry ~1e-4 of rounding on either side.)
Per-step dispatch counts equal the reference's trace-time counts.  The
same holds family-stacked (``fuse_families=True``), with the reference's
stacked sampled blocks split per member and injected by each member's leaf
index."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import apply_updates as j_apply_updates
from repro.core import build_optimizer as j_build_optimizer
from repro.kernels import launch_count as j_launch_count
from repro.models import build_model as j_build_model
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, apply_updates, build_optimizer
from repro_torch.core.family_plan import build_family_plan
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.kernels import launch_count
from torch_threads import _one_thread  # noqa: F401  (autouse)


RTOL = 1e-4
STEPS = 8


def _close(got: torch.Tensor, want, name):
    want = np.asarray(want)
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= RTOL, f"{name}: relative error {err:.2e} > {RTOL}"


def _grads(rng, params):
    out = {}
    for path, p in params.items():
        shape = tuple(p.shape)
        if len(shape) == 3:
            L, m, n = shape
            u = rng.standard_normal((L, m, 4))
            v = rng.standard_normal((L, 4, n))
            s = np.array([5.3, 5.1, 4.9, 4.7])
            g = np.einsum("lmk,k,lkn->lmn", u, s, v) / np.sqrt(m * n)
            g = g + 0.25 * rng.standard_normal(shape)
        else:
            g = 0.1 * rng.standard_normal(shape)
        out[path] = g.astype(np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


# gamma=1 of L=2 blocks runs both branches (q = 1/2); gamma=2 only the
# full-rank one (q = 1, no low-rank state); gamma=0 only the low-rank one.
GRID = [("paper", 1), ("finetune", 1), ("paper", 2), ("paper", 0)]


def _injected_per_leaf(jidx, paths):
    """{leaf index: the reference's sampled blocks} from its per-leaf idx tree."""
    out = {}
    for i, path in enumerate(paths):
        node = jidx
        for part in path.split("/"):
            node = node[part] if node is not None else None
        if node is not None:
            out[i] = np.asarray(node).astype(np.int64)
    return out


def _injected_per_member(jidx, plan):
    """{leaf index: blocks} from the reference's stacked idx (one array of
    ``members * g_f`` global block ids per family)."""
    out = {}
    for fam, idx in zip(plan.families, jidx):
        if idx is None:
            continue
        idx = np.asarray(idx).astype(np.int64)
        g_f = len(idx) // fam.seg.members
        for j, i in enumerate(fam.members):
            out[i] = idx[j * g_f:(j + 1) * g_f] - j * fam.seg.member_L
    return out


def _check_gum(compensation, gamma, fuse):
    kw = dict(name="gum", lr=1e-2, rank=4, gamma=gamma, period=3,
              compensation=compensation, weight_decay=0.01, fuse_families=fuse)
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    paths = list(params)
    plan = build_family_plan(
        [p if default_lowrank_filter(k, p) else None for k, p in params.items()], 4)

    injected: dict[int, np.ndarray] = {}
    opt = build_optimizer(OptimizerConfig(**kw),
                          sampler=lambda key, L, g_f: torch.from_numpy(injected[key[2]]))
    jstate, state = jopt.init(jparams), opt.init(params)
    # the reference counts at trace time, once: every step has the same ops
    with j_launch_count.count_launches() as jcounts:
        jax.eval_shape(jopt.update, jparams, jstate, jparams)
    assert jcounts
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(0)

    for step in range(STEPS):
        g = _grads(rng, params)
        jg = _unflatten(g)
        jupd, jstate = jupdate(jg, jstate, jparams)
        jlr = jstate.inner["gum"][0]
        jidx = jax.device_get(jlr.inner.idx)
        injected.clear()
        injected.update(_injected_per_member(jidx, plan) if fuse
                        else _injected_per_leaf(jidx, paths))

        with launch_count.count_launches() as counts:
            upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                    state, params)
        assert counts == jcounts, (step, counts, jcounts)

        jflat = {"/".join(str(k.key) for k in kp): v for kp, v in
                 jax.tree_util.tree_flatten_with_path(jax.device_get(jupd))[0]}
        for path in paths:
            _close(upd[path], jflat[path], f"step {step} update {path}")

        lr = state.inner["gum"][0]
        assert lr.count == step + 1
        if fuse:  # per family: the stacked idx and projectors
            pairs = [(lr.inner.idx[fi], None if idx is None else np.asarray(idx),
                      lr.projs[fi].numpy(), np.asarray(jp))
                     for fi, (idx, jp) in enumerate(zip(jidx, jlr.projs))]
        else:
            jprojs = {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
                      jax.tree_util.tree_flatten_with_path(jax.device_get(jlr.projs))[0]}
            pairs = [(lr.inner.idx[paths[i]], idx, lr.projs[paths[i]].numpy(),
                      jprojs[paths[i]]) for i, idx in injected.items()]
        assert len(pairs) == (3 if fuse else len(injected))
        for idx, jidx_f, p, jp in pairs:
            if jidx_f is not None:
                assert torch.equal(idx, torch.from_numpy(jidx_f.astype(np.int64)))
            np.testing.assert_allclose(p @ np.swapaxes(p, -1, -2),
                                       jp @ np.swapaxes(jp, -1, -2),
                                       rtol=0, atol=1e-5, err_msg=f"step {step} P Pᵀ")
        params = apply_updates(params, upd)
        jparams = j_apply_updates(jparams, jupd)


@pytest.mark.parametrize("compensation,gamma", GRID)
def test_gum_matches_reference(compensation, gamma):
    _check_gum(compensation, gamma, fuse=False)


@pytest.mark.parametrize("compensation,gamma", GRID)
def test_gum_fused_families_matches_reference(compensation, gamma):
    """``fuse_families=True``: three family stacks, sampled per member with
    each member's own injected blocks."""
    _check_gum(compensation, gamma, fuse=True)
