"""Training on bf16-stored parameters (``ModelConfig.param_dtype="bfloat16"``)
against the JAX package, which keeps fp32 optimizer state over bf16
matrices: each gradient is cast to fp32 inside the optimizer and each
update is rounded into the bf16 leaf (``p + u.astype(p.dtype)``).  The
larger cases ((b) at nemotron-4-340b and maverick, (d)) are in
``tests/test_torch_bf16_trainer.py``, so the suite's workers share them.

(a) Every optimizer name, per leaf and family-stacked (and with the fused
    epilogue where it applies), on the small tree of
    ``tests/test_torch_optimizers.py`` cast as the reference's init casts
    it (matrices bf16, the norm scale fp32), fed the same bf16 gradients
    for 3 updates: every fp32 state leaf within 1e-5 relative (1e-4 where
    Newton–Schulz runs), every bf16 parameter at most one bf16 ulp from
    the reference's (the count of entries that differ at all is printed),
    every fp32 parameter within the state's tolerance.  The reference's
    draws are injected, and its projectors' column signs (the projected
    moments carry them).
(b) The ``Trainer``, 3 steps: llama-60m ``SMOKE`` at fp32 and bf16
    activations with GUM and with fused GaLore (row 6's new input, a bf16
    W, is also held alone to the Pallas kernel in interpret mode).
(c) Accumulation over 2 microbatches, the fp32 accumulator and
    ``gum_accum_tools``.
(e) Checkpoints: bitwise resume, the reference's ``.npy`` layout, either
    package's bf16 checkpoint restoring in the port, and the reference's
    own restore failing on it.
(f) The static audit of a bf16-stored llama-130m on ``meta`` tensors.
Also: the storage dtypes that stay refused raise ``NotImplementedError``
(a mesh over bf16 storage trains: ``tests/test_torch_distributed_paths.py``).

The precision rule of (b) and (c) is the serving slices' (ROADMAP ground
rules, Precision): bf16 rounds at other places in the two packages, so the
port's losses and each parameter leaf lie no farther, in relative
Frobenius distance, from the reference's bf16-stored run than that run lies
from the reference's fp32 run of the same draws (fp32 storage and fp32
activations: at bf16 activations the two storages give the same first
step, so only the fp32 run measures the rounding).  One exception, stated:
the fp32 leaves that AdamW trains (the norm scales) take a first step of
lr·sign(g), so a gradient entry within rounding of zero may step the other
way in either package; under bf16 activations those leaves are held
elementwise within 2·lr per step, the most that opposite Adam steps can
open.
"""
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import apply_updates as j_apply_updates
from repro.core import build_optimizer as j_build_optimizer
from repro.core import find_lowrank_states as j_find_lowrank_states
from repro.checkpoint.manager import _leaf_paths as j_leaf_paths
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    OptimizerConfig,
    apply_updates,
    build_optimizer,
    combinators,
    find_lowrank_states,
)
from repro_torch.core.api import tree_leaves
from test_torch_gum import _grads
from test_torch_optimizers import J_PARAMS, jax_noise, jax_sampler, lisa_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)


def _bf16_tree(tree):
    """The reference init's cast: every leaf of two or more dims to bf16."""
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, tree)


def _ordered_bits(x: np.ndarray) -> np.ndarray:
    """bf16 values as integers in the order of the values (one apart =
    one ulp apart): the sign-magnitude words mapped onto a number line."""
    w = np.asarray(x).view(np.uint16).astype(np.int32)
    return np.where(w & 0x8000, -(w & 0x7FFF), w & 0x7FFF)


def _bf16_words(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------- (a)

# label -> (OptimizerConfig fields, tolerance, sampler/noise split)
OPT_CASES = {
    "adamw": (dict(name="adamw", lr=1e-2, weight_decay=0.01), 1e-5, None),
    "sgdm": (dict(name="sgdm", lr=1e-2), 1e-5, None),
    "muon": (dict(name="muon", lr=1e-2), 1e-4, None),
    "gum": (dict(name="gum", lr=1e-2, rank=4, gamma=1, period=3,
                 compensation="finetune"), 1e-4, 1),
    "gum-fused": (dict(name="gum", lr=1e-2, rank=4, gamma=1, period=3,
                       compensation="finetune", fuse_families=True), 1e-4, 1),
    "galore": (dict(name="galore", lr=1e-2, rank=4, period=3, weight_decay=0.01),
               1e-5, None),
    "galore-fused": (dict(name="galore", lr=1e-2, rank=4, period=3, weight_decay=0.01,
                          fuse_families=True), 1e-5, None),
    "galore-fused-epilogue": (dict(name="galore", lr=1e-2, rank=4, period=3,
                                   weight_decay=0.01, fuse_families=True,
                                   fused_epilogue=True), 1e-5, None),
    "galore_muon": (dict(name="galore_muon", lr=1e-2, rank=4, period=3,
                         weight_decay=0.01), 1e-4, None),
    "galore_muon-fused-epilogue": (dict(name="galore_muon", lr=1e-2, rank=4, period=3,
                                        weight_decay=0.01, fuse_families=True,
                                        fused_epilogue=True), 1e-4, None),
    "golore": (dict(name="golore", lr=1e-2, rank=4, period=3, base="sgdm"), 1e-5, None),
    "golore-fused-epilogue": (dict(name="golore", lr=1e-2, rank=4, period=3, base="sgdm",
                                   fuse_families=True, fused_epilogue=True), 1e-5, None),
    "fira": (dict(name="fira", lr=1e-2, rank=4, period=3), 1e-5, None),
    "fira-fused": (dict(name="fira", lr=1e-2, rank=4, period=3, fuse_families=True),
                   1e-5, None),
    "lisa": (dict(name="lisa", lr=1e-2, gamma=1, period=3), 1e-5, None),
    "unbiased_galore_adam": (dict(name="unbiased_galore_adam", lr=1e-2, rank=4, gamma=1,
                                  period=3), 1e-5, 1),
    "unbiased_galore_adam-fused": (dict(name="unbiased_galore_adam", lr=1e-2, rank=4,
                                        gamma=1, period=3, fuse_families=True), 1e-5, 1),
}
OPT_STEPS = 3


def _injected(kw, split) -> dict:
    extra = {}
    if kw["name"] == "lisa":
        extra["sampler"] = lisa_sampler
    elif split is not None:
        extra["sampler"] = jax_sampler(split)
    if kw["name"] == "golore":
        extra["noise"] = jax_noise(None)
    return extra


def _sign_aligned_projectors(monkeypatch, ref_projs: list):
    """The port's projectors with each column's sign turned to the
    reference's (popped from ``ref_projs`` in leaf order)."""
    own = combinators.compute_projectors

    def aligned(kind, g, rank, side, **kw):
        u = own(kind, g, rank, side, **kw)
        want = torch.from_numpy(np.array(ref_projs.pop(0)))
        return u * torch.where((u * want).sum(-2, keepdim=True) < 0, -1.0, 1.0)

    monkeypatch.setattr(combinators, "compute_projectors", aligned)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_on_bf16_parameters_matches_reference(monkeypatch, case):
    kw, tol, split = OPT_CASES[case]
    jparams = _bf16_tree(J_PARAMS)
    params = params_from_jax(jax.device_get(jparams))
    assert {str(p.dtype) for p in params.values()} == {"torch.bfloat16", "torch.float32"}
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **kw))
    opt = build_optimizer(OptimizerConfig(**kw), **_injected(kw, split))
    jstate, state = jopt.init(jparams), opt.init(params)
    jupdate = jax.jit(jopt.update)
    ref_projs: list = []
    _sign_aligned_projectors(monkeypatch, ref_projs)
    rng = np.random.default_rng(0)
    differ = 0
    for step in range(OPT_STEPS):
        g32 = _grads(rng, params)
        jg = {k: v.astype(ml_dtypes.bfloat16) if params[k].dtype == torch.bfloat16 else v
              for k, v in g32.items()}
        jupd, jstate = jupdate(_nest(jg), jstate, jparams)
        if step == 0 and (lows := j_find_lowrank_states(jstate)):
            ref_projs[:] = [np.asarray(p) for low in lows for p in
                            jax.tree_util.tree_leaves(jax.device_get(low.projs))]
        grads = params_from_jax(jg)
        upd, state = opt.update(grads, state, params)
        assert not ref_projs, "every refresh consumed the reference's signs"
        params = apply_updates(params, upd)
        jparams = j_apply_updates(jparams, jupd)

        # fp32 state, matched by path
        jflat = dict(zip(j_leaf_paths(jstate), jax.tree_util.tree_leaves(jstate)))
        flat = dict(flatten_with_paths(state))
        assert set(jflat) == set(flat), (case, sorted(set(jflat) ^ set(flat)))
        for path, leaf in flat.items():
            want = np.asarray(jflat[path])
            if not isinstance(leaf, torch.Tensor):
                assert leaf == int(want), (step, path)
            elif leaf.is_floating_point():
                assert leaf.dtype == torch.float32 and want.dtype == np.float32, path
                assert _rel(leaf.numpy(), want) <= tol, (step, path, _rel(leaf.numpy(), want))
            else:
                assert np.array_equal(leaf.numpy(), want), (step, path)
        # parameters: bf16 within one ulp, fp32 within the tolerance
        jp = params_from_jax(jax.device_get(jparams))
        for path, p in params.items():
            assert p.dtype == jp[path].dtype, path
            if p.dtype == torch.bfloat16:
                gap = np.abs(_ordered_bits(_bf16_words(p)) - _ordered_bits(_bf16_words(jp[path])))
                assert gap.max() <= 1, (step, path, int(gap.max()))
                differ += int((gap > 0).sum())
            else:
                assert _rel(p.numpy(), jp[path].numpy()) <= tol, (step, path)
    total = sum(p.numel() for p in params.values() if p.dtype == torch.bfloat16)
    print(f"{case}: {differ} of {OPT_STEPS} x {total} bf16 entries one ulp apart")


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("side", ["left", "right"])
def test_epilogue_on_a_bf16_w_matches_pallas(side):
    """Row 6's new input: the port's fused epilogue (its plain version, on
    the CPU) on a bf16 W against the reference's Pallas kernel in interpret
    mode on the same bf16 W (its body casts W to fp32); the output is fp32
    and within 1e-5 of the largest entry."""
    from repro.kernels import dispatch as j_dispatch
    from repro_torch.kernels import dispatch

    rng = np.random.default_rng(0)
    m, n, r = (64, 128, 16) if side == "left" else (128, 64, 16)
    p = (rng.standard_normal((2, m if side == "left" else n, r)) / 8).astype(np.float32)
    s = rng.standard_normal((2, *((r, n) if side == "left" else (m, r)))).astype(np.float32)
    w = rng.standard_normal((2, m, n)).astype(np.float32).astype(ml_dtypes.bfloat16)
    want = np.asarray(j_dispatch.back_project_epilogue(
        jnp.asarray(p), jnp.asarray(s), w=jnp.asarray(w), scale=-0.5, decay=-0.01, side=side,
        impl="interpret"))
    got = dispatch.back_project_epilogue(
        torch.from_numpy(p), torch.from_numpy(s),
        w=torch.from_numpy(w.view(np.int16)).view(torch.bfloat16), scale=-0.5, decay=-0.01,
        side=side)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------------------- (b), (c)

SEQ = 16
TRAIN_OPTS = {
    # GUM at period 2: refreshes on steps 1 and 3
    "gum": dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2),
    # GaLore keeps its moments across a refresh, so one period: a second
    # refresh would turn on the two LAPACK builds' column signs
    "galore": dict(name="galore", lr=1e-2, rank=4, period=3, weight_decay=0.01,
                   fuse_families=True, fused_epilogue=True),
}


def _ref_params(ckpt_dir, step: int) -> dict:
    """The parameters of a reference checkpoint, read from its files (the
    reference cannot restore its own bf16 leaves: test (e)), as float64."""
    import json
    import os

    d = os.path.join(str(ckpt_dir), f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for meta in manifest["leaves"]:
        if meta["path"].startswith("0/"):
            arr = np.load(os.path.join(d, meta["shards"][0]))
            if meta["dtype"] == "bfloat16":
                arr = arr.view(ml_dtypes.bfloat16)
            out[meta["path"][2:]] = arr.astype(np.float64)
    return out


_REF_RUNS: dict = {}
# the checkpoint directories of those runs, and of check_trainer_case's
# port runs under ("port", arch, opt, dtype)
_REF_DIRS: dict = {}


@contextlib.contextmanager
def _reference_routing():
    """Record the routing of every MoE call the reference runs in the
    block, as the port's :class:`~repro_torch.models.moe.RoutingLog` (each
    token's top-k experts, each (expert, slot)'s token, whether the slot is
    kept): the wrapped ``repro.models.moe.apply_moe`` hands the steps of
    its own routing, recomputed from the same traced values, to an ordered
    host callback.  The JAX package itself is not changed."""
    from repro.models import moe as j_moe
    from repro_torch.models import moe

    log, orig = moe.RoutingLog(), j_moe.apply_moe

    def keep(topi, g_idx, kept):
        log.calls.append((torch.from_numpy(np.array(topi, np.int64)),
                          torch.from_numpy(np.array(g_idx, np.int64)),
                          torch.from_numpy(np.array(kept))))

    def recording(p, x, cfg):
        B, S, D = x.shape
        G = max(cfg.moe_groups, 1)
        while (B * S) % G:
            G -= 1
        xt = x.reshape(G, B * S // G, D)
        probs = jax.nn.softmax((xt @ p["router"].astype(xt.dtype)).astype(jnp.float32), axis=-1)
        topw, topi = jax.lax.top_k(probs, cfg.top_k)
        topw = topw / jnp.sum(topw, axis=-1, keepdims=True)
        combine = jnp.sum(topw[..., None] * jax.nn.one_hot(topi, cfg.n_experts), axis=2)
        Tg = B * S // G
        cap = max(1, min(Tg, int(cfg.capacity_factor * Tg * cfg.top_k / cfg.n_experts)))
        g_score, g_idx = jax.lax.top_k(
            jnp.swapaxes(jnp.where(combine > 0, combine, -1.0), 1, 2), cap)
        jax.debug.callback(keep, topi, g_idx, g_score > 0, ordered=True)
        return orig(p, x, cfg)

    j_moe.apply_moe = recording
    try:
        yield log
    finally:
        j_moe.apply_moe = orig


def _ref_run(tmp_factory, arch, opt, param_dtype, dtype, microbatches=1):
    """The reference Trainer's 3-step run (losses, final parameters and,
    for the moe family, its routing log), cached for the module: the fp32
    run is every case's yardstick."""
    key = (arch, opt, param_dtype, dtype, microbatches)
    if key not in _REF_RUNS:
        from repro.configs import RunConfig as JRunConfig
        from repro.configs import get_smoke as j_get_smoke
        from repro.data import DataConfig as JDataConfig
        from repro.models import build_model as j_build_model
        from repro.train import Trainer as JTrainer

        jcfg = j_get_smoke(arch).replace(param_dtype=param_dtype, dtype=dtype)
        tmp = tmp_factory.mktemp("ref")
        with _reference_routing() as routing:
            result = JTrainer(
                j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **TRAIN_OPTS[opt]),
                JRunConfig(steps=3, ckpt_dir=str(tmp), ckpt_every=0, log_every=0,
                           resume=False, seed=0),
                JDataConfig(vocab=jcfg.vocab, seq_len=SEQ, global_batch=2, seed=0),
                microbatches=microbatches).train()
        _REF_RUNS[key] = (np.array(result.losses), _ref_params(tmp, 3), routing)
        _REF_DIRS[key] = tmp
    return _REF_RUNS[key]


def _init_params(arch, param_dtype="bfloat16") -> dict:
    """The reference Trainer's initial parameters (its seed 0)."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import build_model as j_build_model

    jcfg = j_get_smoke(arch).replace(param_dtype=param_dtype)
    return params_from_jax(jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(0))))


def _port_trainer(tmp, arch, opt, dtype, *, steps=3, microbatches=1, ckpt_every=0, **kw):
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    from test_torch_trainer import jax_sampler as trainer_sampler

    cfg = get_smoke(arch).replace(param_dtype="bfloat16", dtype=dtype)
    return Trainer(
        build_model(cfg, device="cpu"), OptimizerConfig(**TRAIN_OPTS[opt]),
        RunConfig(steps=steps, ckpt_dir=str(tmp), ckpt_every=ckpt_every, log_every=0,
                  seed=0),
        DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2, seed=0), device="cpu",
        microbatches=microbatches,
        optimizer=build_optimizer(OptimizerConfig(**TRAIN_OPTS[opt]), sampler=trainer_sampler),
        params=_init_params(arch), **kw)


def _hold_to_reference(losses, params: dict, ref16, ref32, *, lr, bf16_act):
    """The precision rule of the module docstring: the losses (as one
    vector over the steps: a single step's rounding is noise of the size
    of the yardstick) and every leaf no farther from the bf16-stored
    reference than it lies from the fp32 one."""
    jl16, jp16, _ = ref16
    jl32, jp32, _ = ref32
    gap, own = np.asarray(losses) - jl16, jl16 - jl32
    assert np.linalg.norm(gap) <= np.linalg.norm(own), (gap, own)
    for path, p in params.items():
        got = p.detach().float().numpy().astype(np.float64)
        if bf16_act and p.dtype == torch.float32:
            assert np.abs(got - jp16[path]).max() <= 2 * lr * len(losses), path
            continue
        d, yard = _rel(got, jp16[path]), _rel(jp16[path], jp32[path])
        assert d <= yard, (path, d, yard)


def check_trainer_case(tmp_path_factory, arch, opt, dtype) -> None:
    """(b): 3 steps of the port's Trainer on bf16-stored parameters from the
    reference's initial draws, its block samples injected (the moe family
    on the reference's routing), held to the reference by the precision
    rule; the optimizer state stays fp32."""
    from repro_torch.models import moe

    ref16 = _ref_run(tmp_path_factory, arch, opt, "bfloat16", dtype)
    tmp = _REF_DIRS[("port", arch, opt, dtype)] = tmp_path_factory.mktemp("port")
    t = _port_trainer(tmp, arch, opt, dtype)
    # the moe family trains on the reference's routing: a token that one
    # ulp sends to another expert moves the loss by far more than rounding
    replay = moe.replay_routing(ref16[2]) if ref16[2].calls else contextlib.nullcontext()
    with replay:
        result = t.train()
    assert bool(ref16[2].calls) == arch.startswith("llama4")
    params = t.model.params()
    assert {p.dtype for p in params.values()} == {torch.bfloat16, torch.float32}
    for low in find_lowrank_states(t.opt_state):
        assert all(x.dtype != torch.bfloat16 for x in tree_leaves(low)
                   if isinstance(x, torch.Tensor))
    assert result.skipped_nonfinite == 0 and np.isfinite(result.losses).all()
    _hold_to_reference(result.losses, params, ref16,
                       _ref_run(tmp_path_factory, arch, opt, "float32", "float32"),
                       lr=TRAIN_OPTS[opt]["lr"], bf16_act=dtype == "bfloat16")


# llama-60m here; nemotron-4-340b and maverick in tests/test_torch_bf16_trainer.py
@pytest.mark.parametrize("opt,dtype", [("gum", "float32"), ("gum", "bfloat16"),
                                       ("galore", "float32"), ("galore", "bfloat16")])
def test_trainer_on_bf16_storage_within_references_own_distance(tmp_path_factory, opt, dtype):
    check_trainer_case(tmp_path_factory, "llama-60m", opt, dtype)


def test_trainer_microbatches_on_bf16_storage(tmp_path_factory):
    """(c): 2 microbatches into the fp32 accumulator (each microbatch's
    bf16 gradients cast as they are added, as the reference's scan adds
    them), 3 GUM steps.  The yardstick is the reference's fp32 run at one
    microbatch of the same batch: its gradient is the two halves' mean up
    to fp32 rounding (~1e-7, far below the bf16 spread it measures)."""
    t = _port_trainer(tmp_path_factory.mktemp("port"), "llama-60m", "gum", "float32",
                      microbatches=2)
    result = t.train()
    _hold_to_reference(result.losses, t.model.params(),
                       _ref_run(tmp_path_factory, "llama-60m", "gum", "bfloat16", "float32", 2),
                       _ref_run(tmp_path_factory, "llama-60m", "gum", "float32", "float32"),
                       lr=TRAIN_OPTS["gum"]["lr"], bf16_act=False)


def test_gum_accum_tools_on_bf16_storage():
    """(c): the projected-space accumulator (``gum_accum_tools`` through
    ``make_train_step(lowrank_accum=)``, 2 microbatches, family-stacked) on
    bf16-stored llama-60m SMOKE, 3 steps at period 2, against the
    reference's jitted step on the same bf16 parameters, its fp32-stored
    step the yardstick."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.core.gum import gum_accum_tools as j_gum_accum_tools
    from repro.launch.steps import make_train_step as j_make_train_step
    from repro.models import build_model as j_build_model
    from repro_torch.configs import get_smoke
    from repro_torch.core import gum_accum_tools
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from test_torch_trainer import jax_sampler as trainer_sampler

    kw = dict(rank=4, gamma=1, period=2, fuse_families=True, weight_decay=0.01)
    tokens = [np.random.default_rng(i).integers(0, 256, (4, SEQ)).astype(np.int32)
              for i in range(3)]

    def reference(param_dtype):
        jmodel = j_build_model(j_get_smoke("llama-60m").replace(param_dtype=param_dtype))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tools = j_gum_accum_tools(1e-2, kernel_impl="jnp", **kw)
        step = jax.jit(j_make_train_step(jmodel, tools.transform, microbatches=2,
                                         lowrank_accum=tools))
        state, losses = tools.transform.init(jparams), []
        for t in tokens:
            jparams, state, metrics = step(jparams, state, {"tokens": jnp.asarray(t)})
            losses.append(float(metrics["loss"]))
        return np.array(losses), {k: v.float().numpy().astype(np.float64) for k, v in
                                  params_from_jax(jax.device_get(jparams)).items()}, None

    model = build_model(get_smoke("llama-60m").replace(param_dtype="bfloat16"), device="cpu")
    model.load_params(_init_params("llama-60m"))
    tools = gum_accum_tools(1e-2, sampler=trainer_sampler, **kw)
    step = make_train_step(model, tools.transform, microbatches=2, lowrank_accum=tools)
    params = model.params()
    state, losses = tools.transform.init({k: p.detach() for k, p in params.items()}), []
    for t in tokens:
        state, metrics = step(params, state, {"tokens": torch.from_numpy(t)})
        losses.append(float(metrics["loss"]))
    assert {p.dtype for p in params.values()} == {torch.bfloat16, torch.float32}
    assert state.inner["gum"][0].count == 3
    _hold_to_reference(losses, params, reference("bfloat16"), reference("float32"), lr=1e-2,
                       bf16_act=False)


# ----------------------------------------------------------------- (e)


def test_resume_on_bf16_storage_is_bitwise(tmp_path):
    """A bf16-stored GUM run saved at step 2 and resumed to step 4 ends
    bitwise where the uninterrupted 4-step run does (parameters and
    optimizer state)."""
    whole = _port_trainer(tmp_path / "whole", "llama-60m", "gum", "float32", steps=4)
    whole.train()
    first = _port_trainer(tmp_path / "split", "llama-60m", "gum", "float32", steps=2)
    first.train()
    second = _port_trainer(tmp_path / "split", "llama-60m", "gum", "float32", steps=4)
    result = second.train()
    assert result.resumed_from == 2
    a, b = dict(flatten_with_paths((whole.model.params(), whole.opt_state))), \
        dict(flatten_with_paths((second.model.params(), second.opt_state)))
    assert list(a) == list(b)
    assert any(x.dtype == torch.bfloat16 for x in a.values() if isinstance(x, torch.Tensor))
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path
        else:
            assert x == b[path], path


def test_rank_migration_on_bf16_storage_resumes_bitwise(tmp_path):
    """A rank drop (``stepwise:0=8,3=4``) over bf16-stored parameters: the
    migrated state stays fp32, and 3 steps + a resumed 2 across the drop
    end bitwise where 5 uninterrupted steps do."""
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg = get_smoke("llama-60m").replace(param_dtype="bfloat16")
    opt = OptimizerConfig(name="gum", lr=1e-3, rank=8, gamma=1, period=2,
                          rank_policy="stepwise:0=8,3=4")

    def run(tag, steps):
        t = Trainer(build_model(cfg, device="cpu"), opt,
                    RunConfig(steps=steps, ckpt_dir=str(tmp_path / tag), ckpt_every=3,
                              log_every=0, seed=0),
                    DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2, seed=0),
                    device="cpu")
        return t, t.train()

    whole, _ = run("whole", 5)
    run("split", 3)
    resumed, result = run("split", 5)
    assert result.resumed_from == 3
    assert [m.default for _, m in whole.rank_ctrl.history] == [8, 4]
    for x in tree_leaves(whole.opt_state):
        assert not isinstance(x, torch.Tensor) or x.dtype != torch.bfloat16
    a = dict(flatten_with_paths((whole.model.params(), whole.opt_state)))
    b = dict(flatten_with_paths((resumed.model.params(), resumed.opt_state)))
    assert list(a) == list(b)
    for path, x in a.items():
        assert (torch.equal(x, b[path]) if isinstance(x, torch.Tensor) else x == b[path]), path


def _bf16_array(seed: int = 0, shape=(5, 7)) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16)


def test_bf16_checkpoint_file_is_the_references(tmp_path):
    """The port writes a bf16 leaf as the reference does: the same .npy
    bytes (its 2-byte words under a ``'<V2'`` header), manifest dtype
    ``"bfloat16"`` and CRC32; the reference's restore of that checkpoint
    raises (a reference-side fact: numpy has no cast from its void type),
    the port restores either package's file bitwise."""
    import json

    from repro.checkpoint import CheckpointManager as JCheckpointManager
    from repro_torch.checkpoint import CheckpointManager

    arr = _bf16_array()
    # (the reference flattens a dict in sorted key order, the port in its own)
    tree = {"s": torch.ones(3),
            "w": torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)}
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    JCheckpointManager(str(tmp_path / "ref")).save(1, {"w": jnp.asarray(arr),
                                                       "s": jnp.ones(3)})
    leaves = {}
    for who in ("port", "ref"):
        d = tmp_path / who / "step_000000001"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves[who] = [(m, (d / m["shards"][0]).read_bytes()) for m in manifest["leaves"]]
    assert leaves["port"] == leaves["ref"]
    w_meta, w_raw = leaves["port"][1]
    assert w_meta["dtype"] == "bfloat16" and b"'descr': '<V2'" in w_raw
    assert w_raw.endswith(arr.tobytes())

    like = {"s": torch.zeros(3), "w": torch.zeros(arr.shape, dtype=torch.bfloat16)}
    for who in ("port", "ref"):
        mgr = CheckpointManager(str(tmp_path / who))
        assert mgr.verify_step(1)
        restored, _ = mgr.restore(1, like)
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16),
                           torch.from_numpy(arr.view(np.int16))), who
    jlike = {"s": jnp.zeros(3), "w": jnp.zeros(arr.shape, jnp.bfloat16)}
    jmgr = JCheckpointManager(str(tmp_path / "port"))
    assert jmgr.verify_step(1)
    with pytest.raises(ValueError, match="No cast function available"):
        jmgr.restore(1, jlike)


def test_bf16_checkpoint_detects_a_flipped_bit(tmp_path):
    from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager

    arr = _bf16_array(1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)})
    path = tmp_path / "step_000000001" / "arr_00000.shard0.npy"
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x10
    path.write_bytes(bytes(raw))
    assert not mgr.verify_step(1)
    with pytest.raises(CheckpointCorruptionError, match="checksum"):
        mgr.restore(1, {"w": torch.zeros(arr.shape, dtype=torch.bfloat16)})


def test_params_to_numpy_gives_bf16_words():
    from repro_torch.convert import params_to_numpy

    arr = _bf16_array(2)
    out = params_to_numpy({"a/w": torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)})
    assert out["a"]["w"].dtype == np.uint16
    assert np.array_equal(out["a"]["w"].view(ml_dtypes.bfloat16), arr)


# ----------------------------------------------------------------- (f)


def test_audit_of_bf16_stored_llama_130m():
    """The static audit on ``meta`` tensors: GUM (rank 256, gamma 4, period
    3) over bf16-stored llama-130m reads the fp32 run's 42 dispatches, its
    projected-state and per-step realloc bytes (the state is fp32), and
    half the parameter bytes but for the fp32 final norm, a device's share
    at data=8 (``sharding.per_shard_bytes``) the reference's."""
    from repro_torch.analysis.audit import audit_optimizer
    from repro_torch.analysis.buffers import per_shard_memory
    from repro_torch.analysis.trace_passes import reference_state_bytes
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = OptimizerConfig(name="gum", lr=1e-3, rank=256, gamma=4, period=3)
    trees = {pd: build_model(get_config("llama-130m").replace(param_dtype=pd),
                             device="meta").params() for pd in ("float32", "bfloat16")}
    low = trees["bfloat16"]
    assert [k for k, p in low.items() if p.dtype == torch.float32] == ["final_norm/norm_scale"]
    report = audit_optimizer(cfg, low)
    assert report.ok, report.findings
    assert report.summary["launches_per_step"] == 42
    assert report.summary["proj_state_bytes"] == 292552820
    assert report.summary["opt_state_realloc_bytes"] == 423254016
    full = reference_state_bytes(trees["float32"])
    norm = low["final_norm/norm_scale"].numel() * 4
    assert reference_state_bytes(low) == (full - norm) // 2 + norm
    batch = {"tokens": torch.empty(8, 1024, dtype=torch.int32, device="meta")}
    mem = per_shard_memory(low, {}, batch, n_shards=1)
    assert mem["params_bytes"] == reference_state_bytes(low)
    # a device's share at data=8, against the reference's of its bf16-stored tree
    from jax.sharding import AbstractMesh

    from repro import sharding as jsharding
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro_torch import sharding
    from repro_torch.launch.mesh import Mesh

    jtree = jax.eval_shape(j_build_model(j_get_config("llama-130m").replace(
        param_dtype="bfloat16")).init, jax.random.PRNGKey(0))
    got = sharding.per_shard_bytes(low, Mesh((8,), ("data",)))
    assert got == jsharding.per_shard_bytes(jtree, AbstractMesh((8,), ("data",)))
    assert got < sharding.per_shard_bytes(trees["float32"], Mesh((8,), ("data",))) * 0.51


# ------------------------------------------------------ paths still refused


def test_unported_storage_paths_raise():
    """fp16 storage (ROADMAP queue 1 item 2i), on the dense family and on
    ``Mamba2``, raises ``NotImplementedError`` naming its item; bf16 storage
    builds for the ssm and hybrid families (``tests/test_torch_ssm_bf16.py``)
    and trains on a mesh (item 5h, ``tests/test_torch_distributed_paths.py``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    for arch, dtype in (("llama-60m", "float16"), ("mamba2-370m", "float16"),
                        ("mamba2-370m", "float64"), ("zamba2-1.2b", "float16")):
        with pytest.raises(NotImplementedError, match="item 2i"):
            build_model(get_smoke(arch).replace(param_dtype=dtype), device="cpu")
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        build_model(get_smoke(arch).replace(param_dtype="bfloat16"), device="cpu")
