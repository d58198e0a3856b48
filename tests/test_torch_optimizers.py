"""The port's other optimizers against the live JAX reference
(``repro.core.build_optimizer``, ``kernel_impl="jnp"``): 8 update steps on
the small tree of ``tests/test_optimizers.py`` (two 3-block stacks, one on
each projection side, an embedding and a norm scale), ``period=3`` where
the optimizer has one (refreshes at steps 1, 4 and 7).

Gradients are numpy, seeded: a planted rank-4 signal above a noise floor on
the stacks, so the top-4 subspace is separated by a gap.  The reference's
random draws are injected: its sampled blocks through ``sampler`` (GUM,
unbiased GaLore-Adam, LISA) and its projector draws through ``noise``, each
from the key material the reference folds (``jax_key``).  GoLore and Fira
carry their moments across a refresh, so the reference's column signs are
injected into the port's own projectors too, as
``tests/test_torch_galore.py`` does.  Updates are held within rtol 1e-5 in
each leaf's Frobenius norm, 1e-4 where Newton–Schulz runs, and the per-step
dispatch counts equal the reference's trace-time counts.  Also: every name
descends a quadratic, and the port's ``Trainer`` tracks the reference's
losses over 4 llama-60m SMOKE steps for muon, fira and golore."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import apply_updates as j_apply_updates
from repro.core import build_optimizer as j_build_optimizer
from repro.core import combinators as jc
from repro.core import find_lowrank_states as j_find_lowrank_states
from repro.data import DataConfig as JDataConfig
from repro.kernels import launch_count as j_launch_count
from repro.models import build_model as j_build_model
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    OptimizerConfig,
    apply_updates,
    build_optimizer,
    combinators,
    find_lowrank_states,
)
from repro_torch.data import DataConfig
from repro_torch.kernels import launch_count
from repro_torch.models import build_model
from repro_torch.train import Trainer
from test_torch_galore import _flat
from test_torch_gum import _grads, _unflatten
from torch_threads import _one_thread  # noqa: F401  (autouse)


STEPS = 8
KEY = jax.random.PRNGKey(0)
J_PARAMS = {
    "blocks": {
        "wq": jax.random.normal(KEY, (3, 16, 24)) * 0.1,
        "w_out": jax.random.normal(jax.random.fold_in(KEY, 1), (3, 24, 16)) * 0.1,
    },
    "embed": jax.random.normal(jax.random.fold_in(KEY, 2), (64, 16)) * 0.1,
    "norm_scale": jax.numpy.ones((16,)),
}


def jax_key(key, split):
    """The reference's key for ``key = (seed, count, leaf)``: ``fold_in``
    twice, then the projector half (``split=0``) or the sampling half
    (``split=1``) where the inner transform asks for a sampling key
    (``layerwise_unbias``), the folded key itself otherwise (None)."""
    seed, count, leaf = key
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), count), leaf)
    return k if split is None else jax.random.split(k)[split]


def jax_noise(split):
    def noise(key, kind, shape):
        draw = {"normal": jax.random.normal, "gumbel": jax.random.gumbel,
                "uniform": jax.random.uniform}[kind]
        return torch.from_numpy(np.array(draw(jax_key(key, split), shape)))

    return noise


def jax_sampler(split):
    def sampler(key, L, g_f):
        return torch.from_numpy(np.array(jax.random.choice(
            jax_key(key, split), L, (g_f,), replace=False)).astype(np.int64))

    return sampler


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))


# name -> (OptimizerConfig fields, tolerance, sampler/noise split, inject signs)
CASES = {
    "sgdm": (dict(name="sgdm", lr=1e-2), 1e-5, None, False),
    "muon": (dict(name="muon", lr=1e-2), 1e-4, None, False),
    "golore": (dict(name="golore", lr=1e-2, rank=4, period=3, base="sgdm"), 1e-5, None, True),
    "golore-fused-epilogue": (dict(name="golore", lr=1e-2, rank=4, period=3, base="sgdm",
                                   fuse_families=True, fused_epilogue=True), 1e-5, None, True),
    "fira": (dict(name="fira", lr=1e-2, rank=4, period=3), 1e-5, None, True),
    "lisa": (dict(name="lisa", lr=1e-2, gamma=1, period=3), 1e-5, None, False),
    "unbiased_galore_adam": (dict(name="unbiased_galore_adam", lr=1e-2, rank=4, gamma=1,
                                  period=3), 1e-5, 1, False),
    "gum-sgdm": (dict(name="gum", lr=1e-2, rank=4, gamma=1, period=3, base="sgdm"),
                 1e-5, 1, False),
    "gum-sgdm-rsvd-muon-scale": (dict(name="gum", lr=1e-2, rank=4, gamma=1, period=3,
                                      base="sgdm", projector="rsvd", use_muon_scale=True),
                                 1e-5, 1, False),
    # finetune: with the paper's compensation the sampled block's residual
    # is zero in span(P) but for rounding, which Newton–Schulz amplifies
    # (tests/test_torch_gum.py); finetune keeps q P Pᵀ G there.
    "gum-muon-scale": (dict(name="gum", lr=1e-2, rank=4, gamma=1, period=3,
                            use_muon_scale=True, weight_decay=0.01,
                            compensation="finetune"), 1e-4, 1, False),
}


def lisa_sampler(key, L, g_f):
    """LISA folds (seed, period index, leaf) into its key with no split."""
    return jax_sampler(None)(key, L, g_f)


def _run(monkeypatch, jopt, opt, tol, inject_signs, params, jparams):
    jstate, state = jopt.init(jparams), opt.init(params)
    # the reference counts at trace time, once: every step has the same ops
    with j_launch_count.count_launches() as jcounts:
        jax.eval_shape(jopt.update, jparams, jstate, jparams)
    jupdate = jax.jit(jopt.update)

    ref_projs: list[np.ndarray] = []
    if inject_signs:
        own = combinators.compute_projectors

        def sign_aligned(kind, g, rank, side, **kw):
            u = own(kind, g, rank, side, **kw)
            want = torch.from_numpy(np.array(ref_projs.pop(0)))
            return u * torch.where((u * want).sum(-2, keepdim=True) < 0, -1.0, 1.0)

        monkeypatch.setattr(combinators, "compute_projectors", sign_aligned)

    rng = np.random.default_rng(0)
    for step in range(STEPS):
        g = _grads(rng, params)
        jupd, jstate = jupdate(_unflatten(g), jstate, jparams)
        if inject_signs and step % 3 == 0:
            ref_projs[:] = [np.asarray(p) for p in jax.tree_util.tree_leaves(
                jax.device_get(j_find_lowrank_states(jstate)[0].projs))]
        with launch_count.count_launches() as counts:
            upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                    state, params)
        assert counts == jcounts, (step, counts, jcounts)
        assert not ref_projs
        jflat = _flat(jupd)
        for path in params:
            err = _rel(upd[path], jflat[path])
            assert err <= tol, f"step {step} {path}: relative error {err:.2e} > {tol}"
        params = apply_updates(params, upd)
        jparams = j_apply_updates(jparams, jupd)
    return state, jstate


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_reference(monkeypatch, case):
    kw, tol, split, inject_signs = CASES[case]
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
    extra = {}
    if kw["name"] == "lisa":
        extra["sampler"] = lisa_sampler
    elif split is not None:
        extra["sampler"] = jax_sampler(split)
    if kw.get("projector", "svd") != "svd" or kw["name"] == "golore":
        extra["noise"] = jax_noise(0 if split is not None else None)
    opt = build_optimizer(OptimizerConfig(**kw), **extra)
    params = params_from_jax(jax.device_get(J_PARAMS))
    state, jstate = _run(monkeypatch, jopt, opt, tol, inject_signs, params, J_PARAMS)
    lows, jlows = find_lowrank_states(state), j_find_lowrank_states(jstate)
    assert len(lows) == len(jlows)
    for low, jlow in zip(lows, jlows):
        assert low.count == int(jlow.count) == STEPS
        projs = [p for p in (low.projs.values() if isinstance(low.projs, dict) else low.projs)
                 if p is not None]
        for p, jp in zip(projs, jax.tree_util.tree_leaves(jax.device_get(jlow.projs)),
                         strict=True):
            p, jp = p.numpy(), np.asarray(jp)
            np.testing.assert_allclose(p @ np.swapaxes(p, -1, -2),
                                       jp @ np.swapaxes(jp, -1, -2), rtol=0, atol=1e-5)


def _compositions(c, nesterov_kw):
    """Hand-composed chains from one package's combinators ``c``: Nesterov
    Muon inside ``lowrank`` (the projection kernel's branch) and on full
    leaves, and global-norm clipping as a chain head."""
    return {
        "nesterov-lowrank": c.chain(
            c.lowrank(c.scale_by_muon(nesterov=True, **nesterov_kw), rank=4, period=3,
                      reset_on_refresh=True),
            c.add_decayed_weights(0.01), c.scale_by_lr(1e-2)),
        "nesterov-full": c.chain(c.scale_by_muon(nesterov=True, use_muon_scale=True,
                                                 **nesterov_kw), c.scale_by_lr(1e-2)),
        "clip": c.chain(c.clip_by_global_norm(0.5), c.scale_by_adam(), c.scale_by_lr(1e-2)),
    }


@pytest.mark.parametrize("where", ["nesterov-lowrank", "nesterov-full", "clip"])
def test_combinator_matches_reference(monkeypatch, where):
    j_params = {"blocks": J_PARAMS["blocks"]}
    params = params_from_jax(jax.device_get(j_params))
    jopt = _compositions(jc, {"kernel_impl": "jnp"})[where]
    opt = _compositions(combinators, {})[where]
    _run(monkeypatch, jopt, opt, 1e-5 if where == "clip" else 1e-4, False, params, j_params)


ALL_OPTS = ["adamw", "sgdm", "muon", "galore", "galore_muon", "golore", "gum", "fira",
            "lisa", "unbiased_galore_adam"]


@pytest.mark.parametrize("name", ALL_OPTS)
def test_descends_quadratic(name):
    """The port of ``tests/test_optimizers.py``'s descent check, with the
    port's own default draws."""
    opt = build_optimizer(OptimizerConfig(name=name, lr=3e-2, rank=4, gamma=1, period=4,
                                          projector="svd"))
    params = params_from_jax(jax.device_get(J_PARAMS))
    state = opt.init(params)

    def loss(p):
        return 0.5 * sum(float(torch.sum(x.double() ** 2)) for x in p.values())

    l0 = loss(params)
    for _ in range(30):
        upd, state = opt.update(dict(params), state, params)  # grad of the quadratic
        params = apply_updates(params, upd)
    assert loss(params) < 0.7 * l0, name


@pytest.mark.parametrize("name", ["muon", "fira", "golore"])
def test_trainer_tracks_reference_losses(tmp_path, name):
    """4 steps at period 3: the losses read the first period's updates
    only, where a projector column's sign cancels, so no sign injection."""
    opt = dict(name=name, lr=1e-2, rank=4, period=3) | ({"base": "sgdm"} if name == "golore"
                                                        else {})
    jcfg = j_get_smoke("llama-60m")
    data = dict(vocab=jcfg.vocab, seq_len=64, global_batch=2, seed=0)
    jlosses = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
        JRunConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=100, log_every=0,
                   resume=False, seed=0),
        JDataConfig(**data)).train().losses
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    trainer = Trainer(
        build_model(get_smoke("llama-60m"), device="cpu"), OptimizerConfig(**opt),
        RunConfig(steps=4, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data), device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**opt), noise=jax_noise(None)),
        params=params_from_jax(jax.device_get(jparams)))
    losses = trainer.train().losses
    assert len(losses) == len(jlosses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)


def test_every_reference_name_builds():
    """Every name of the reference's factory builds, every projector kind
    and ``use_muon_scale`` are accepted."""
    for name in ALL_OPTS:
        build_optimizer(OptimizerConfig(name=name))
    for projector in ("svd", "subspace", "rsvd", "random", "grass"):
        build_optimizer(OptimizerConfig(name="gum", projector=projector, use_muon_scale=True))
    with pytest.raises(ValueError):
        build_optimizer(OptimizerConfig(name="sgd"))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_baseline_counts_match_reference():
    """``chip_smoke.py``'s phase 4c asserts per-step dispatch and launch
    counts at llama-130m; the llama-60m smoke tree has the same 7 hidden
    leaves in 3 families, so the dispatch counts must equal the
    reference's ``count_launches`` and the port's own at that size (rank
    4; gamma 1 of its 2 blocks, so both branches run, as gamma 4 of 12
    does), and the launches must follow from them."""
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    for label, kw, want_dispatch, want_launch in _chip_smoke().BASELINES:
        kw = kw | {k: v for k, v in (("rank", 4), ("gamma", 1)) if k in kw}
        jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
        with j_launch_count.count_launches() as jcounts:
            jax.eval_shape(jopt.update, jparams, jopt.init(jparams), jparams)
        opt = build_optimizer(OptimizerConfig(**kw))
        with launch_count.count_launches() as counts:
            opt.update(grads, opt.init(params), params)
        assert counts == jcounts == want_dispatch, (label, counts, jcounts)
        launch = {"lowrank_update": counts.get("lowrank_update", 0) + counts.get("project", 0),
                  "back_project": counts.get("back_project", 0),
                  "back_project_epilogue": counts.get("back_project_epilogue", 0),
                  "gram": 5 * counts.get("newton_schulz", 0),
                  "poly_apply": 5 * counts.get("newton_schulz", 0)}
        assert {k: v for k, v in launch.items() if v} == want_launch, label
