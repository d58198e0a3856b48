"""The port's moe family (dbrx-132b: an MoE in every block, top-4 of 16;
llama4-maverick-400b: groups of a dense block and an MoE block, top-1 of
128 with a shared expert) against the JAX package's, at their SMOKE
configs, with the reference's own initial parameters (``params_from_jax``):

* the expert layer alone (``models/moe.apply_moe``) on identical inputs, in
  fp32 and bf16, one dispatch group and two, on random inputs and on inputs
  built to tie (two experts with one router column, tokens in equal pairs,
  and a bias that sends every token to those two experts, so the top-k
  choice and the capacity choice are decided by index alone): the routing
  (each token's experts, each (expert, slot)'s token) equal, the output
  within the fp32 tolerance, in bf16 by Frobenius distance (below);
* the routing log: a replayed run equals the recorded one, and the flips
  between two runs are counted;
* parameter paths and shapes (4-D expert stacks, maverick's grouped
  ``(G, per, ...)`` dense stack), in ``jax.tree_util``'s order;
* logits, the aux loss, ``lm_loss`` and ``chunked_lm_loss`` with the aux,
  and every parameter gradient;
* the prefill cache and 4 decode steps in the reference's layouts (flat for
  dbrx, grouped ``{"dense", "moe"}`` for maverick), the decode rows routed
  together as the reference's ``decode_step`` routes them;
* the port's engine against the reference's ``ServeEngine``: the same
  requests in the same slots give the same tokens (the reference decodes
  each slot at batch 1, so slots do not meet through capacity), and each
  equals the port's direct decode;
* remat on against off: losses and gradients bitwise equal;
* ``param_dtype="bfloat16"``: paths, per-leaf dtypes (the router bf16 too)
  and bf16 logits by Frobenius distance;
* a 3-step GUM ``Trainer`` run per arch (the 4-D expert leaves and the
  grouped dense leaves go through GUM's block sampling and the lead
  flattening) against the reference's, its sampled blocks injected;
* an unknown family raises ``ValueError``.

fp32 tolerance: rtol 1e-4 with atol 1e-4 of each tensor's largest entry, as
``tests/test_torch_dense_variants.py`` (fp32 sums in another order through
a few layers and a softmax); the trainer's losses rtol 1e-4.  bf16: the
two packages round at other places, so the port's bf16 result must lie no
farther from the reference's bf16 result, in Frobenius norm, than that
lies from the reference's fp32 result (``chip_smoke.
check_low_precision_prefill``'s rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.data import DataConfig as JDataConfig
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.transformer import chunked_lm_loss as j_chunked_lm_loss
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.data import DataConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, chunked_lm_loss, lm_loss, moe
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import greedy_decode
from repro_torch.train import Trainer
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

RTOL = 1e-4
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
PROMPT, DECODE = 12, 4


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _flat(jtree) -> dict:
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]}


def _fro(a, b) -> float:
    a, b = (np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(vocab, seed, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _cache_leaves(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One SMOKE model in both packages and the reference's outputs:
    logits, aux, both losses and their gradients, the prefill cache, and 4
    decode steps (2 rows routed together) from that cache."""
    arch = request.param
    jcfg = j_get_smoke(arch)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(arch), device="cpu")
    model.load_params(params)
    tokens = _tokens(jcfg.vocab, 0, (2, PROMPT))
    steps = _tokens(jcfg.vocab, 1, (DECODE, 2, 1))
    chunked_cfg = jcfg.replace(logit_chunk=5)

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jnp.asarray(tokens))
        return jmodel.loss(logits, jnp.asarray(tokens), aux), (logits, aux)

    def jchunked(p):
        hidden, aux, _ = jmodel.forward(p, jnp.asarray(tokens), return_hidden=True)
        return j_chunked_lm_loss(p, chunked_cfg, hidden, jnp.asarray(tokens), aux)

    (jl, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jcl, jcgrads = jax.jit(jax.value_and_grad(jchunked))(jparams)
    _, jcache = jax.jit(j_make_prefill_step(jmodel))(jparams, {"tokens": jnp.asarray(tokens)})
    def grow(v):  # room for DECODE more positions after the prompt
        pad = [(0, 0)] * v.ndim
        pad[-3] = (0, DECODE)  # (..., B, S, KV, hd)
        return jnp.pad(v.astype(jnp.float32), pad)

    cache = jax.tree_util.tree_map(grow, jcache)
    start = cache_from_jax(jax.device_get(cache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    jsteps = []
    for i in range(DECODE):
        jlog, cache = jstep(jparams, cache, jnp.asarray(steps[i]), jnp.int32(PROMPT + i))
        jsteps.append(np.asarray(jlog))
    return dict(arch=arch, jcfg=jcfg, jmodel=jmodel, jparams=jparams, params=params,
                model=model, tokens=tokens, steps=steps, loss=np.asarray(jl),
                logits=np.asarray(jlogits), aux=np.asarray(jaux), grads=_flat(jgrads),
                chunked_loss=np.asarray(jcl), chunked_grads=_flat(jcgrads),
                prefill_cache=dict(_cache_leaves(jax.device_get(jcache))),
                decode_start=start, decode_logits=jsteps,
                decode_cache=dict(_cache_leaves(jax.device_get(cache))))


# ------------------------------------------------------------ the expert layer


def _layer0(jparams, arch):
    """The first MoE layer's parameters of a reference tree."""
    blocks = jparams["blocks"]
    moe_p = blocks["moe"] if get_smoke(arch).moe_every == 1 else blocks["moe"]["moe"]
    return jax.tree_util.tree_map(lambda x: x[0], moe_p)


# the reference's layer, compiled once per (shapes, config)
_j_apply_moe = jax.jit(j_moe.apply_moe, static_argnums=2)


def _j_routing(p, x, cfg):
    """The reference's routing (``repro.models.moe.apply_moe``'s steps up to
    the capacity choice): each token's top-k experts and each (expert,
    slot)'s token and weight sign."""
    B, S, D = x.shape
    T = B * S
    G = max(cfg.moe_groups, 1)
    while T % G:
        G -= 1
    xt = x.reshape(G, T // G, D)
    probs = jax.nn.softmax((xt @ p["router"].astype(xt.dtype)).astype(jnp.float32), axis=-1)
    topw, topi = jax.lax.top_k(probs, cfg.top_k)
    topw = topw / jnp.sum(topw, axis=-1, keepdims=True)
    combine = jnp.sum(topw[..., None] * jax.nn.one_hot(topi, cfg.n_experts), axis=2)
    cap = max(1, min(T // G, int(cfg.capacity_factor * (T // G) * cfg.top_k / cfg.n_experts)))
    g_score, g_idx = jax.lax.top_k(jnp.swapaxes(jnp.where(combine > 0, combine, -1.0), 1, 2),
                                   cap)
    return np.asarray(topi), np.asarray(g_idx), np.asarray(g_score > 0)


def _layer_inputs(arch, ties: bool, seed: int = 0):
    """The reference's layer-0 MoE parameters and x (2, 16, d).  With
    ``ties``: router column 1 = column 0, x's tokens in equal pairs, and x
    moved along column 0 so that experts 0 and 1 lead for every token: their
    probabilities tie exactly, every token's weight on expert 0 is the same,
    and the experts' capacity (dbrx 20 of 32 tokens, maverick 10) is filled
    by index."""
    jparams = j_build_model(j_get_smoke(arch)).init(jax.random.PRNGKey(0))
    p = {k: np.asarray(v) for k, v in _layer0(jparams, arch).items()}
    x = np.random.default_rng(seed).standard_normal((2, 16, p["router"].shape[0]))
    x = x.astype(np.float32)
    if ties:
        p["router"] = p["router"].copy()
        p["router"][:, 1] = p["router"][:, 0]
        x[:, 1::2] = x[:, 0::2]
        col = p["router"][:, 0]
        x = x + (8.0 * col / float(col @ col)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("groups", [0, 2])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_layer_matches_reference(arch, ties, groups):
    cfg = get_smoke(arch).replace(moe_groups=groups)
    jcfg = j_get_smoke(arch).replace(moe_groups=groups)
    p, x = _layer_inputs(arch, ties)
    want, want_aux = _j_apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), jcfg)
    with moe.record_routing() as log:
        out, aux = moe.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), cfg)
    topi, g_idx, kept = _j_routing({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                   jcfg)
    (got_topi, got_idx, got_kept), = log.calls
    np.testing.assert_array_equal(got_topi.numpy(), topi)
    np.testing.assert_array_equal(got_idx.numpy(), g_idx)
    np.testing.assert_array_equal(got_kept.numpy(), kept)
    if ties:  # the capacity binds, and the tie went to the lower index
        assert not kept.all() and (topi[..., 0] == 0).all()
        assert (g_idx[:, 0] == np.arange(g_idx.shape[-1])).all()
    _close(out, want, "moe out")
    _close(aux, want_aux, "aux")


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_layer_bf16_within_bf16s_own_distance(arch, ties):
    """bf16 x, fp32 weights cast at use: the same routing as the
    reference's bf16 layer, and the output by Frobenius distance.  The fp32
    result that sets the scale is the layer in fp32 on the same (bf16) x,
    routed as the reference's bf16 layer routes (the port's fp32 layer,
    which test_expert_layer_matches_reference holds to the reference's, with
    that routing replayed): in fp32 the reference may route a token
    otherwise, and a flip moves the output by far more than rounding."""
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    p, x = _layer_inputs(arch, ties, seed=1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    x32 = torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
    want, _ = _j_apply_moe(jp, xb, jcfg)
    with moe.record_routing() as log:
        out, _ = moe.apply_moe(tp, x32.to(torch.bfloat16), cfg)
    routing = [torch.from_numpy(a) for a in _j_routing(jp, xb, jcfg)]
    for got, ref in zip(log.calls[0], routing):
        assert torch.equal(got, ref)
    with moe.replay_routing(log):
        fp32, _ = moe.apply_moe(tp, x32, cfg)
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    bf16_vs_fp32 = _fro(want, fp32.numpy())
    assert 0 < bf16_vs_fp32 < 0.05
    assert _fro(out.float().numpy(), want) <= bf16_vs_fp32


def test_routing_replay_pins_and_flips_count():
    """A replay of a recorded routing gives the recorded run's output
    bitwise, here on inputs that route otherwise; the flips count the kept
    pairs the other run moved."""
    cfg = get_smoke("dbrx-132b")
    p, x = _layer_inputs("dbrx-132b", ties=False)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x)
    with moe.record_routing() as log:
        out, aux = moe.apply_moe(p, x, cfg)
    with moe.replay_routing(log):
        again, again_aux = moe.apply_moe(p, x, cfg)
    assert torch.equal(out, again) and torch.equal(aux, again_aux)
    moved = x.clone()
    moved[0, :4] = -moved[0, :4]
    with moe.record_routing() as other:
        moe.apply_moe(p, moved, cfg)
    assert moe.flips(log, log) == [0]
    n = moe.flips(log, other)[0]
    assert 0 < n <= 4 * cfg.top_k
    with moe.replay_routing(log):
        moe.apply_moe(p, moved, cfg)
    with pytest.raises(RuntimeError, match="replayed 0 of 1"):
        with moe.replay_routing(log):
            pass


def test_combine_sums_in_expert_order():
    """Each token's rows added in y's dtype, experts ascending from zero:
    in bf16, ((0 + a) + b) + c, not a sum in another order."""
    y = torch.tensor([[[[1.0]], [[2.0 ** -8]], [[2.0 ** -8]]]], dtype=torch.bfloat16)
    g_idx = torch.zeros((1, 3, 1), dtype=torch.int64)
    kept = torch.ones((1, 3, 1), dtype=torch.bool)
    out = moe._combine(y, g_idx, kept, Tg=1, k=3)
    # 1 + 2^-8 rounds to 1 in bf16, twice; 2^-8 + 2^-8 + 1 would round to 1 + 2^-7
    assert out.item() == 1.0


# ------------------------------------------------------------ the model


def test_param_paths_and_shapes_match(case):
    ours = {k: tuple(v.shape) for k, v in case["model"].params().items()}
    theirs = {k: v.shape for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)  # same leaf order as jax.tree_util
    assert ours == theirs
    cfg = case["model"].cfg
    f, E, d = cfg.moe_dff, cfg.n_experts, cfg.d_model
    if cfg.moe_every == 1:
        assert ours["blocks/moe/experts_w_in"] == (cfg.n_layers, E, d, f)
        assert ours["blocks/moe/router"] == (cfg.n_layers, d, E)
    else:
        G, per = cfg.n_layers // cfg.moe_every, cfg.moe_every - 1
        assert ours["blocks/dense/mlp/w_in"] == (G, per, d, cfg.d_ff)
        assert ours["blocks/moe/moe/experts_w_out"] == (G, E, f, d)
        assert ours["blocks/moe/moe/shared_w_in"] == (G, d, f * cfg.n_shared_experts)
    lowrank = {k for k, p in case["model"].params().items() if default_lowrank_filter(k, p)}
    assert all("router" not in k and "norm" not in k for k in lowrank)
    assert any("experts_w_in" in k for k in lowrank)


def test_logits_aux_losses_and_grads_match(case):
    model, t = case["model"], torch.from_numpy(case["tokens"]).long()
    logits, aux = model(t, return_aux=True)
    loss = lm_loss(logits, t, aux)
    _close(logits, case["logits"], "logits")
    _close(aux, case["aux"], "aux")
    _close(loss, case["loss"], "loss")
    assert float(aux) > 0
    params = model.params()
    for (path, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        _close(g, case["grads"][path], path)
    hidden, aux = model(t, return_hidden=True, return_aux=True)
    chunked = chunked_lm_loss(hidden, t, 5, model.embed.embed, model.embed.lm_head, aux=aux)
    _close(chunked, case["chunked_loss"], "chunked loss")
    for (path, _), g in zip(params.items(),
                            torch.autograd.grad(chunked, list(params.values()))):
        _close(g, case["chunked_grads"][path], f"chunked {path}")


def test_prefill_cache_matches(case):
    """The port at attn_impl="pallas" (flash attention's plain version on
    the CPU) against the reference's prefill at "xla", in its layout."""
    model = build_model(get_smoke(case["arch"]).replace(attn_impl="pallas"), device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(case["tokens"]).long()})
    _close(logits, case["logits"], "prefill logits")
    ours = dict(_cache_leaves(cache))
    assert set(ours) == set(case["prefill_cache"])
    assert set(ours) == ({"k", "v"} if model.cfg.moe_every == 1 else
                         {"dense/k", "dense/v", "moe/k", "moe/v"})
    for key, t in ours.items():
        assert tuple(t.shape) == case["prefill_cache"][key].shape, key
        _close(t, case["prefill_cache"][key], key)
    empty = model.init_cache(batch=2, max_seq=PROMPT + DECODE)
    assert {k: tuple(v.shape) for k, v in _cache_leaves(empty)} == {
        k: tuple(v.shape) for k, v in _cache_leaves(case["decode_start"])}


def test_decode_steps_match(case):
    step = make_serve_step(case["model"])
    cache = jax.tree_util.tree_map(torch.clone, case["decode_start"])
    for i in range(DECODE):
        logits, cache = step(cache, torch.from_numpy(case["steps"][i]).long(), PROMPT + i)
        _close(logits, case["decode_logits"][i], f"decode step {i}")
    for key, t in _cache_leaves(cache):
        _close(t, case["decode_cache"][key], f"decode {key}")


def test_engine_matches_reference_engine(case):
    """Two slots, four requests: the port's engine gives the reference
    engine's tokens, request by request, and each equals the port's direct
    decode of the request alone."""
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4], [4, 4], [11, 3, 6, 2, 9, 1, 5]]
    jeng = JServeEngine(case["jmodel"], case["jparams"], slots=2, max_seq=32)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    eng = ServeEngine(case["model"], slots=2, max_seq=32)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == 4
    assert [r.reused_slot for r in reqs] == [False, False, True, True]
    for req, jreq in zip(reqs, jreqs):
        assert req.output == jreq.output, (req.uid, req.output, jreq.output)
        assert greedy_decode(case["model"], req.prompt, 6, 32) == req.output


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat_bitwise(arch):
    params = params_from_jax(jax.device_get(
        j_build_model(j_get_smoke(arch)).init(jax.random.PRNGKey(1))))
    tokens = torch.from_numpy(_tokens(128, 3, (2, 16))).long()
    out = []
    for remat in (False, True):
        model = build_model(get_smoke(arch).replace(remat=remat), device="cpu")
        model.load_params(params)
        logits, aux = model(tokens, return_aux=True)
        loss = lm_loss(logits, tokens, aux)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_storage_paths_dtypes_and_logits(arch):
    """param_dtype and dtype bf16, as the card serves maverick: every leaf
    of two or more dims stored bf16 (router included), as the reference's
    init casts them; the bf16 logits held by Frobenius distance against the
    reference's fp32 logits of the same draws stored in fp32."""
    jcfg = j_get_smoke(arch).replace(param_dtype="bfloat16")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(arch).replace(param_dtype="bfloat16", dtype="bfloat16"),
                        device="cpu")
    model.load_params(params)
    for path, p in model.params().items():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), path
        assert p.dtype == params[path].dtype, path
    assert any(p.dtype == torch.bfloat16 for k, p in model.params().items() if "router" in k)
    tokens = _tokens(jcfg.vocab, 2, (2, 16))
    j32 = j_build_model(jcfg.replace(param_dtype="float32"))
    jfp32, _, _ = jax.jit(j32.forward)(j32.init(jax.random.PRNGKey(0)), jnp.asarray(tokens))
    jlogits, _, _ = jax.jit(j_build_model(jcfg.replace(dtype="bfloat16")).forward)(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    bf16_vs_fp32 = _fro(jlogits, jfp32)
    assert 0 < bf16_vs_fp32 < 0.05
    assert _fro(logits.float().numpy(), jlogits) <= bf16_vs_fp32


@pytest.mark.parametrize("arch", ARCHS)
def test_gum_trainer_tracks_reference(arch, tmp_path):
    """3 GUM steps (rank 4, gamma 1, period 2: a refresh on steps 1 and 3)
    from the reference's initial parameters, its block samples injected;
    the expert stacks are 4-D leaves whose blocks GUM samples across."""
    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    jcfg = j_get_smoke(arch)
    data = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2, seed=0)
    jtrainer = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
        JRunConfig(steps=3, ckpt_dir=str(tmp_path / "jax"), ckpt_every=100, log_every=0,
                   resume=False, seed=0),
        JDataConfig(**data))
    jlosses = jtrainer.train().losses
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    trainer = Trainer(
        build_model(get_smoke(arch), device="cpu"), OptimizerConfig(**opt),
        RunConfig(steps=3, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data), device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler),
        params=params_from_jax(jax.device_get(jparams)))
    result = trainer.train()
    assert len(result.losses) == len(jlosses) == 3
    np.testing.assert_allclose(result.losses, jlosses, rtol=1e-4, atol=0)
    assert result.skipped_nonfinite == 0


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        build_model(ModelConfig(name="x", family="rnn"), device="cpu")
