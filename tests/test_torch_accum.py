"""The accumulation path of the port against the JAX package, on llama-60m
SMOKE with the reference's initial parameters (``params_from_jax``).

* ``make_train_step(microbatches=2, 4)``, and with ``logit_chunk`` set:
  the step's accumulated gradient (handed to a transform that keeps it as
  its state) and loss, rtol 1e-4 with atol 1e-4 of each tensor's largest
  entry, as ``tests/test_torch_model.py``; a batch that does not split
  raises.
* ``chunked_lm_loss``: value and every parameter gradient, tied and untied
  head, a ragged last chunk; the same tolerance, and against the port's
  unchunked loss within 1e-6 (value) and 1e-5 (gradients).
* ``gum_accum_tools`` through ``make_train_step(lowrank_accum=)`` against
  the reference's ``_make_lowrank_accum_step`` for 4 steps at period 2
  (refreshes on steps 1 and 3), per leaf and family-stacked, with the
  reference's sampled blocks injected (``jax_sampler``): losses rtol 1e-4
  and each step's parameter change within rtol 1e-4 in each leaf's
  Frobenius norm, as ``tests/test_torch_gum.py``; the per-step dispatch
  counts that ``chip_smoke.py`` phase 4d asserts.
* ``pad_rank_to``: the four padded ops against ``pad_rank_to=0`` (within
  1e-6) and against the reference's; GUM with padding against without.
* ``kernels/ops.py``'s ``newton_schulz`` and ``lowrank_update`` helpers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.core.api import Transform as JTransform
from repro.core.gum import gum_accum_tools as j_gum_accum_tools
from repro.kernels import dispatch as j_dispatch
from repro.kernels import ops as j_ops
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.models.transformer import chunked_lm_loss as j_chunked_lm_loss
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer, gum_accum_tools
from repro_torch.core.api import Transform
from repro_torch.kernels import dispatch, launch_count, ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, chunked_lm_loss, lm_loss
from test_torch_optimizers import _chip_smoke
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)


RTOL = 1e-4


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _flat(jtree) -> dict:
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]}


def _setup(**cfg_kw):
    jcfg = j_get_smoke("llama-60m").replace(**cfg_kw)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke("llama-60m").replace(**cfg_kw), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def _tokens(rows: int, seq: int = 24, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (rows, seq)).astype(np.int32)


# Transforms that keep the gradient they are handed as their state and
# update nothing: the step's accumulated (and guarded) gradient, read back.
J_KEEP = JTransform(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                    lambda g, s, p: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
KEEP = Transform(lambda p: {k: None for k in p}, lambda g, s, p: ({k: None for k in g}, g))


@pytest.mark.parametrize("microbatches,logit_chunk", [(2, 0), (4, 0), (2, 5), (1, 7)])
def test_train_step_gradient_matches_reference(microbatches, logit_chunk):
    jmodel, jparams, model = _setup(logit_chunk=logit_chunk)
    tokens = _tokens(4)
    jstep = j_make_train_step(jmodel, J_KEEP, microbatches=microbatches)
    _, jgrads, jmetrics = jstep(jparams, J_KEEP.init(jparams), {"tokens": jnp.asarray(tokens)})
    step = make_train_step(model, KEEP, microbatches=microbatches)
    params = model.params()
    grads, metrics = step(params, KEEP.init(params), {"tokens": torch.from_numpy(tokens)})
    _close(metrics["loss"], jmetrics["loss"], "loss")
    jflat = _flat(jgrads)
    assert list(grads) == list(jflat)
    for k, g in grads.items():
        _close(g, jflat[k], k)


def test_microbatches_that_do_not_split_the_batch_raise():
    _, _, model = _setup()
    step = make_train_step(model, KEEP, microbatches=3)
    params = model.params()
    with pytest.raises(ValueError, match="3 equal microbatches"):
        step(params, KEEP.init(params), {"tokens": torch.from_numpy(_tokens(4)).long()})
    with pytest.raises(ValueError):
        make_train_step(model, KEEP, microbatches=0)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("chunk", [5, 8, 64])
def test_chunked_lm_loss_matches_reference(tied, chunk):
    """S = 23 after the shift: chunk 5 leaves a last chunk of 3, 8 one of
    7, and 64 is one padded chunk."""
    cfg_kw = dict(tie_embeddings=tied, logit_chunk=chunk)
    jmodel, jparams, model = _setup(**cfg_kw)
    tokens = _tokens(2)

    def jloss(p):
        hidden, aux, _ = jmodel.forward(p, jnp.asarray(tokens), return_hidden=True)
        return j_chunked_lm_loss(p, jmodel.cfg, hidden, jnp.asarray(tokens), aux)

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    t = torch.from_numpy(tokens).long()
    params = model.params()
    head = getattr(model.embed, "lm_head", None)
    assert (head is None) == tied
    loss = chunked_lm_loss(model(t, return_hidden=True), t, chunk, model.embed.embed, head)
    grads = torch.autograd.grad(loss, list(params.values()))
    _close(loss, jl, "loss")
    jflat = _flat(jgrads)
    for (k, _), g in zip(params.items(), grads):
        _close(g, jflat[k], k)
    # against the port's own unchunked loss
    plain = lm_loss(model(t), t)
    plain_grads = torch.autograd.grad(plain, list(params.values()))
    assert abs(float(loss - plain)) <= 1e-6 * abs(float(plain))
    for g, want in zip(grads, plain_grads):
        assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_chunked_loss_without_autograd_is_the_same_number():
    _, _, model = _setup(logit_chunk=8)
    t = torch.from_numpy(_tokens(2)).long()
    hidden = model(t, return_hidden=True)
    want = chunked_lm_loss(hidden, t, 8, model.embed.embed)
    with torch.no_grad():
        assert torch.equal(chunked_lm_loss(hidden, t, 8, model.embed.embed), want.detach())


def _accum_kw(fuse: bool) -> dict:
    return dict(rank=4, gamma=1, period=2, fuse_families=fuse, weight_decay=0.01)


@pytest.mark.parametrize("fuse", [False, True], ids=["per_leaf", "fused"])
def test_gum_accum_tools_matches_reference(fuse):
    jmodel, jparams, model = _setup()
    jtools = j_gum_accum_tools(1e-2, kernel_impl="jnp", **_accum_kw(fuse))
    tools = gum_accum_tools(1e-2, sampler=jax_sampler, **_accum_kw(fuse))
    jstep = jax.jit(j_make_train_step(jmodel, jtools.transform, microbatches=2,
                                      lowrank_accum=jtools))
    step = make_train_step(model, tools.transform, microbatches=2, lowrank_accum=tools)
    params = model.params()
    jstate = jtools.transform.init(jparams)
    state = tools.transform.init({k: p.detach() for k, p in params.items()})
    for i in range(4):
        tokens = _tokens(4, seed=i)
        before = {k: p.detach().clone() for k, p in params.items()}
        jbefore = _flat(jparams)
        jparams, jstate, jmetrics = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        state, metrics = step(params, state, {"tokens": torch.from_numpy(tokens)})
        _close(metrics["loss"], jmetrics["loss"], f"step {i} loss")
        jafter = _flat(jparams)
        for k, p in params.items():
            got, want = (p.detach() - before[k]).numpy(), jafter[k] - jbefore[k]
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= RTOL, f"step {i} {k}: relative error {err:.2e} > {RTOL}"
        assert state.inner["gum"][0].count == i + 1


@pytest.mark.parametrize("fuse", [False, True], ids=["per_leaf", "fused"])
def test_gum_accum_dispatch_counts_are_chip_smokes(fuse):
    """Per step, at 4 microbatches over the smoke tree's 7 hidden leaves (3
    families when stacked): what ``chip_smoke.accum_counts`` says and
    phase 4d asserts at llama-130m, on a refresh step and a steady one."""
    _, _, model = _setup()
    tools = gum_accum_tools(1e-2, **_accum_kw(fuse))
    step = make_train_step(model, tools.transform, microbatches=4, lowrank_accum=tools)
    params = model.params()
    state = tools.transform.init({k: p.detach() for k, p in params.items()})
    want_dispatch, want_launch = _chip_smoke().accum_counts(4, 7, 3 if fuse else 7)
    for i in range(2):
        with launch_count.count_launches() as counts:
            state, _ = step(params, state, {"tokens": torch.from_numpy(_tokens(8, seed=i))})
        assert counts == want_dispatch, (i, counts)
    launches = {"lowrank_update": counts["lowrank_update"] + counts["project"],
                "back_project": counts["back_project"],
                "gram": 5 * counts["newton_schulz"], "poly_apply": 5 * counts["newton_schulz"]}
    assert launches == want_launch


def test_reconstruction_is_the_projected_accumulation():
    """``reconstruct(sum of project(G_i))`` is P Pᵀ (sum G_i) with the
    sampled blocks of the raw sum, within 1e-5."""
    _, _, model = _setup()
    params = {k: p.detach() for k, p in model.params().items()}
    tools = gum_accum_tools(1e-2, **_accum_kw(False))
    state = tools.transform.init(params)
    gen = torch.Generator().manual_seed(0)
    gs = [{k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
          for _ in range(3)]
    state = tools.refresh(gs[0], state, params)
    acc = None
    for g in gs:
        c = tools.project(g, state, params)
        acc = c if acc is None else {k: {n: a[n] + c[k][n] for n in a} for k, a in acc.items()}
    got = tools.reconstruct(acc, state, params)
    lr = state.inner["gum"][0]
    for k, p in params.items():
        total = sum(g[k] for g in gs)
        if k not in lr.inner.idx or lr.inner.idx[k] is None:
            assert torch.equal(got[k], total), k
            continue
        proj, idx = lr.projs[k], lr.inner.idx[k]
        if p.shape[-2] <= p.shape[-1]:
            want = proj @ (proj.mT @ total)
        else:
            want = (total @ proj) @ proj.mT
        want[idx] = total[idx]
        assert float((got[k] - want).abs().max()) <= 1e-5 * float(want.abs().max()), k


def _pad_operands(side: str, r: int = 13):
    gen = torch.Generator().manual_seed(1)
    L, m, n = 3, 40, 56
    p = torch.randn(L, m if side == "left" else n, r, generator=gen)
    g = torch.randn(L, m, n, generator=gen)
    st = torch.randn(*((L, r, n) if side == "left" else (L, m, r)), generator=gen)
    return p, g, st


PAD_OPS = {
    "lowrank_update": lambda d, p, g, st, side, **kw: d.lowrank_update(p, g, st, 0.9, 1.5,
                                                                       side=side, **kw),
    "project": lambda d, p, g, st, side, **kw: d.project(p, g, side=side, **kw),
    "back_project": lambda d, p, g, st, side, **kw: d.back_project(p, st, side=side, **kw),
    "back_project_epilogue": lambda d, p, g, st, side, **kw: d.back_project_epilogue(
        p, st, w=g, scale=-0.5, decay=0.1, side=side, **kw),
}


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", list(PAD_OPS))
def test_pad_rank_to_gives_the_unpadded_numbers(op, side):
    p, g, st = _pad_operands(side)
    want = PAD_OPS[op](dispatch, p, g, st, side)
    for pad in (8, 128):
        got = PAD_OPS[op](dispatch, p, g, st, side, pad_rank_to=pad)
        assert got.shape == want.shape and got.is_contiguous()
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    jwant = PAD_OPS[op](j_dispatch, *(jnp.asarray(x.numpy()) for x in (p, g, st)), side,
                        impl="jnp", pad_rank_to=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jwant).max()))
    with pytest.raises(ValueError, match="pad_rank_to"):
        PAD_OPS[op](dispatch, p, g, st, side, pad_rank_to=-1)


def test_gum_with_pad_rank_to_matches_unpadded_and_reference():
    _, jparams, model = _setup()
    params = {k: p.detach() for k, p in model.params().items()}
    kw = dict(name="gum", lr=1e-2, rank=4, gamma=1, period=2)
    states, outs = {}, {}
    opts = {pad: build_optimizer(OptimizerConfig(pad_rank_to=pad, **kw), sampler=jax_sampler)
            for pad in (0, 128)}
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", pad_rank_to=128, **kw))
    gen = torch.Generator().manual_seed(0)
    grads = {k: 0.1 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    for pad, opt in opts.items():
        outs[pad], states[pad] = opt.update(grads, opt.init(params), params)
    jout, _ = jopt.update(_unflatten({k: jnp.asarray(v.numpy()) for k, v in grads.items()}),
                          jopt.init(jparams), jparams)
    jflat = _flat(jout)
    for k in params:
        assert float((outs[128][k] - outs[0][k]).abs().max()) <= \
            1e-6 * float(outs[0][k].abs().max()), k
        err = np.linalg.norm(outs[128][k].numpy() - jflat[k]) / np.linalg.norm(jflat[k])
        assert err <= RTOL, (k, err)
    with pytest.raises(ValueError, match="pad_rank_to"):
        OptimizerConfig(pad_rank_to=-8)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def test_ops_newton_schulz_and_lowrank_update_helpers():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 16, 24, generator=gen)
    p, g, r = (torch.randn(20, 4, generator=gen), torch.randn(20, 12, generator=gen),
               torch.randn(4, 12, generator=gen))  # the reference's ref is 2-D
    for impl in ("xla", "pallas"):
        _close(ops.newton_schulz(x, impl=impl), j_ops.newton_schulz(jnp.asarray(x.numpy())),
               f"newton_schulz {impl}")
        _close(ops.lowrank_update(p, g, r, 0.9, 1.5, impl=impl),
               j_ops.lowrank_update(*(jnp.asarray(t.numpy()) for t in (p, g, r)), 0.9, 1.5),
               f"lowrank_update {impl}")
