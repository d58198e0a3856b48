"""The port's GaLore and GaLore-Muon against the live JAX reference
(``repro.core.build_optimizer``, ``kernel_impl="jnp"``) for 8 update steps
on the llama-60m SMOKE parameter tree, across refresh boundaries
(``period=3``: refreshes at steps 1, 4 and 7), with ``weight_decay=0.01``,
per leaf, family-stacked, and family-stacked with the fused epilogue.

Gradients are those of ``tests/test_torch_gum.py``: numpy, seeded, a planted
rank-4 signal above a noise floor, so the top-4 subspace is separated by a
gap.  SVD columns are defined up to sign, and the two packages' LAPACK
builds choose signs differently.  GaLore carries its moments across a
refresh (no reset), so a column whose sign flips at one refresh changes
the next period's update.  The test therefore injects the reference's choice
of sign into the port's projectors: each column of the port's own SVD is
flipped to agree with the reference's column, as GUM's test injects sampled
blocks.  Projectors are compared as ``P Pᵀ`` (atol 1e-5); updates within
rtol 1e-4 in each leaf's Frobenius norm (fp32 sums in another order,
compounded over 8 steps of Adam's elementwise division or Newton–Schulz's
quintic).  Per-step dispatch counts equal the reference's trace-time
counts."""
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
from repro_torch.core import OptimizerConfig, apply_updates, build_optimizer, combinators
from repro_torch.kernels import launch_count
from test_torch_gum import _close, _grads, _unflatten
from torch_threads import _one_thread  # noqa: F401  (autouse)


STEPS = 8
# (fuse_families, fused_epilogue)
FUSION = [(False, False), (True, False), (True, True)]


def _flat(tree):
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.mark.parametrize("fuse,epilogue", FUSION, ids=["leaf", "fused", "fused-epilogue"])
@pytest.mark.parametrize("name", ["galore", "galore_muon"])
def test_galore_matches_reference(monkeypatch, name, fuse, epilogue):
    kw = dict(name=name, lr=1e-2, rank=4, period=3, weight_decay=0.01,
              fuse_families=fuse, fused_epilogue=epilogue)
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    opt = build_optimizer(OptimizerConfig(**kw))
    jstate, state = jopt.init(jparams), opt.init(params)
    with j_launch_count.count_launches() as jcounts:
        jax.eval_shape(jopt.update, jparams, jstate, jparams)
    assert jcounts
    jupdate = jax.jit(jopt.update)

    # The reference's projectors of this step, in the order the port
    # computes its own (leaf order, or family order when stacked).
    ref_projs: list[np.ndarray] = []
    svd = combinators.compute_projectors

    def sign_aligned(kind, g, rank, side, **kw):
        u = svd(kind, g, rank, side, **kw)
        want = torch.from_numpy(ref_projs.pop(0))
        assert u.shape == want.shape
        sign = torch.where((u * want).sum(-2, keepdim=True) < 0, -1.0, 1.0)
        return u * sign

    monkeypatch.setattr(combinators, "compute_projectors", sign_aligned)
    rng = np.random.default_rng(0)
    for step in range(STEPS):
        g = _grads(rng, params)
        jupd, jstate = jupdate(_unflatten(g), jstate, jparams)
        jprojs = [np.asarray(p) for p in
                  jax.tree_util.tree_leaves(jax.device_get(jstate.inner["galore"][0].projs))]
        ref_projs[:] = jprojs if step % 3 == 0 else []

        with launch_count.count_launches() as counts:
            upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                    state, params)
        assert counts == jcounts, (step, counts, jcounts)
        assert not ref_projs

        jflat = _flat(jupd)
        for path in params:
            _close(upd[path], jflat[path], f"step {step} update {path}")
        lr = state.inner["galore"][0]
        assert lr.count == step + 1
        projs = [p for p in lr.projs.values() if p is not None]
        assert len(projs) == len(jprojs) == (3 if fuse else 7)
        for p, jp in zip(projs, jprojs):
            p = p.numpy()
            np.testing.assert_allclose(p @ np.swapaxes(p, -1, -2),
                                       jp @ np.swapaxes(jp, -1, -2),
                                       rtol=0, atol=1e-5, err_msg=f"step {step} P Pᵀ")
        params = apply_updates(params, upd)
        jparams = j_apply_updates(jparams, jupd)


def _compositions(c):
    """Two hand-composed chains from one package's combinators ``c``: alpha
    as a chain tail on PendingBack leaves (stacked, fused epilogue), and
    alpha inside ``lowrank`` on ProjGrad leaves (per leaf)."""
    tail = c.chain(c.lowrank(c.scale_by_adam(), rank=4, period=3, fuse_families=True,
                             fused_epilogue=True),
                   c.scale_by_factor(0.25), c.add_decayed_weights(0.01), c.scale_by_lr(1e-2))
    inner = c.chain(c.lowrank(c.chain(c.scale_by_factor(0.5), c.scale_by_muon()),
                              rank=4, period=3),
                    c.add_decayed_weights(0.01), c.scale_by_lr(1e-2))
    return {"tail": tail, "inner": inner}


@pytest.mark.parametrize("where", ["tail", "inner"])
def test_scale_by_factor_matches_reference(where):
    """``scale_by_factor`` on each leaf kind it folds into, 3 steps within
    one period (so no sign injection is needed), on the smoke tree's seven
    hidden matrices."""
    from repro.core import combinators as jc

    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    params = {k: v for k, v in params_from_jax(jax.device_get(jparams)).items()
              if v.dim() == 3}
    jparams = _unflatten({k: v.numpy() for k, v in params.items()})
    jopt, opt = _compositions(jc)[where], _compositions(combinators)[where]
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(1)
    for step in range(3):
        g = _grads(rng, params)
        jupd, jstate = jopt.update(_unflatten(g), jstate, jparams)
        with launch_count.count_launches() as counts:
            upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                    state, params)
        assert counts.get("back_project_epilogue", 0) == (3 if where == "tail" else 0)
        jflat = _flat(jupd)
        for path in params:
            _close(upd[path], jflat[path], f"step {step} update {path}")
        params = apply_updates(params, upd)
        jparams = j_apply_updates(jparams, jupd)
