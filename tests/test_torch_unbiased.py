"""The theory checks on the port: Algorithm 3 (``unbiased_lowrank``, the
Bernoulli reference semantics) against the live JAX reference with the
same draws injected; Property II (Newton–Schulz commutes with an
orthonormal P); Lemma 1/2 (the estimator identity, and a Monte-Carlo mean
of the unbiased update); Table 1's state count on the port's GUM and
GaLore states; and GUM at gamma = 0 equal to GaLore-Muon.  Ports of
``tests/test_unbiasedness.py`` and ``tests/test_optimizers.py``.

Algorithm 3's draws: per period and leaf the reference folds (seed, period
index, leaf) into a key and splits it, the projector drawing from one half
and xi ~ Bernoulli(q) from the other (``uniform < q``); the port's noise
gets ``(seed, period, leaf)`` and the kind, so the injected noise takes the
projector half for "normal" and the Bernoulli half for "uniform".  Updates
within rtol 1e-5 in each leaf's Frobenius norm with the sgdm base, 1e-4
with Newton–Schulz; the muon case uses the finetune compensation, whose
full-rank estimate keeps a component in span(P) (with the paper's it is
zero there but for rounding, which Newton–Schulz amplifies)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply_updates as j_apply_updates
from repro.core import unbiased_lowrank as j_unbiased_lowrank
from repro_torch.core import (
    apply_updates,
    galore_matrices,
    gum_matrices,
    make_projector,
    unbiased_lowrank,
)
from repro_torch.core.lowrank_common import back_project, project
from repro_torch.core.newton_schulz import newton_schulz_plain
from torch_threads import _one_thread  # noqa: F401  (autouse)


def alg3_noise(key, kind, shape):
    seed, period_index, leaf = key
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), period_index), leaf)
    k_proj, k_xi = jax.random.split(k)
    if kind == "uniform":
        return torch.from_numpy(np.array(jax.random.uniform(k_xi, shape)))
    draw = jax.random.normal if kind == "normal" else jax.random.gumbel
    return torch.from_numpy(np.array(draw(k_proj, shape)))


@pytest.mark.parametrize("base,compensation,projector", [
    ("muon", "finetune", "svd"), ("sgdm", "paper", "svd"), ("sgdm", "paper", "random")])
def test_unbiased_lowrank_matches_reference(base, compensation, projector):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8, 12), "w": (10, 6)}
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    kw = dict(rank=2, q=0.5, period=2, projector=projector, base=base,
              compensation=compensation, seed=3)
    jopt = j_unbiased_lowrank(1e-2, **kw)
    opt = unbiased_lowrank(1e-2, noise=alg3_noise, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jstate, state = jopt.init(jparams), opt.init(tparams)
    jupdate = jax.jit(jopt.update)
    tol = 1e-4 if base == "muon" else 1e-5
    for step in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jupd, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tparams)
        for k in shapes:
            want = np.asarray(jupd[k])
            err = np.linalg.norm(upd[k].numpy() - want) / np.linalg.norm(want)
            assert err <= tol, f"step {step} {k}: relative error {err:.2e} > {tol}"
            assert np.array_equal(state.families[k].xi.numpy(),
                                  np.asarray(jstate.families[k].xi))
        tparams, jparams = apply_updates(tparams, upd), j_apply_updates(jparams, jupd)


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_property_ii_newton_schulz_commutes():
    p = torch.linalg.qr(_randn(0, 24, 6)).Q
    x = _randn(1, 6, 16)
    torch.testing.assert_close(newton_schulz_plain(p @ x), p @ newton_schulz_plain(x),
                               atol=2e-4, rtol=2e-4)
    # NS is a matrix polynomial: NS(P X) lies in span(P)
    out = newton_schulz_plain(p @ x)
    assert float(torch.linalg.norm(out - p @ (p.mT @ out))) < 1e-4 * float(torch.linalg.norm(out))


@pytest.mark.parametrize("q", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("comp", ["paper", "finetune"])
def test_estimator_identity_exact(q, comp):
    """E[Ĝ] = G is a deterministic two-branch identity given P (Lemma 2)."""
    g = _randn(0, 10, 14)
    p = make_projector("svd", g + _randn(1, 10, 14), 4)
    pptg = back_project(p, project(p, g, "left"), "left")
    if comp == "paper":
        full, low = (g - pptg) / q, pptg / (1 - q)
    else:
        full, low = (g - (1 - q) * pptg) / q, pptg
    torch.testing.assert_close(q * full + (1 - q) * low, g, atol=1e-5, rtol=0)


def test_lemma1_monte_carlo_unbiased():
    """Through the optimizer (sgdm base, beta 0, period 1, lr 1), the mean
    update over 400 seeds of the port's own draws approximates -G."""
    g = _randn(0, 6, 9)
    params = {"w": torch.zeros(6, 9)}
    total = torch.zeros(6, 9, dtype=torch.float64)
    n = 400
    for seed in range(n):
        opt = unbiased_lowrank(1.0, rank=2, q=0.5, period=1, projector="svd", base="sgdm",
                               beta=0.0, seed=seed)
        upd, _ = opt.update({"w": g}, opt.init(params), params)
        total += upd["w"].double()
    err = float(torch.linalg.norm(total / n + g.double()) / torch.linalg.norm(g.double()))
    assert err < 0.15, err


def test_gum_memory_matches_table1():
    """Table 1: GUM's state = (2-q)·L·m·r + q·L·m·n floats, plus the
    low-rank momentum kept for the sampled blocks too (q·L·r·n); GaLore's
    2·L·m·r (projector and one projected moment)."""
    L, m, r, gamma = 8, 32, 4, 2
    q = gamma / L
    params = {"w": torch.zeros(L, m, m)}
    lrs = gum_matrices(1e-2, rank=r, gamma=gamma, period=10).init(params)[0]
    floats = (lrs.projs["w"].numel() + lrs.inner.low["w"].numel()
              + lrs.inner.full["w"].numel())
    paper = (2 - q) * L * m * r + q * L * m * m
    assert floats == paper + q * L * r * m
    gal = galore_matrices(1e-2, rank=r, period=10, base="muon").init(params)[0]
    assert gal.projs["w"].numel() + gal.inner["w"].numel() == 2 * L * m * r


def test_gum_gamma0_equals_galore_muon():
    """GUM with no sampled full-rank blocks is GaLore-Muon (q = 0)."""
    gum = gum_matrices(1e-2, rank=4, gamma=0, period=3, projector="svd", base="muon", seed=7)
    gal = galore_matrices(1e-2, rank=4, period=3, projector="svd", base="muon",
                          reset_on_update=True, seed=7)
    params = {"w": 0.5 * _randn(0, 2, 12, 20)}
    sg, sl = gum.init(params), gal.init(params)
    p_g, p_l = params, params
    for _ in range(7):
        ug, sg = gum.update(dict(p_g), sg, p_g)  # the gradient of 0.5 ||w||²
        ul, sl = gal.update(dict(p_l), sl, p_l)
        torch.testing.assert_close(ug["w"], ul["w"], atol=1e-5, rtol=1e-5)
        p_g, p_l = apply_updates(p_g, ug), apply_updates(p_l, ul)
