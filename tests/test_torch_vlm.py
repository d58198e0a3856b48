"""The port's vlm family (llama-3.2-vision-11b: groups of ``cross_attn_every``
dense blocks and one gated cross-attention block over projected image
embeddings) against the JAX package's, at its SMOKE config (2 groups of 2
self blocks and a cross block, 16 image tokens), with the reference's own
initial parameters (``params_from_jax``).  The gates ``gate_attn`` and
``gate_mlp`` are zero at init, which makes every cross block the identity
and would let a wrong cross-attention pass, so both trees get the same
nonzero seeded gates first.

* parameter paths and shapes: ``blocks/self`` (G, per, ...), ``blocks/cross``
  (G, ...) with the (G,) gates, in ``jax.tree_util``'s order;
* logits, ``lm_loss`` and every gradient at "xla" (the gates' too); the
  prefill at "pallas" (flash attention's plain version on the CPU, the
  cross-attention unmasked at S != T) against the reference's at
  "interpret", its cache (self KV, the image K/V "xk", "xv") included;
* the bf16 SMOKE forward at "xla" and "pallas" by Frobenius distance;
* 4 decode steps from the reference's prefill cache, the cross blocks at
  S = 1 over the cached image K/V; token-by-token decode, its image K/V
  filled from the prefill, reproducing the forward;
* the port's engine against the reference's ``ServeEngine`` (neither fills
  the image K/V: the reference's engine starts from ``init_cache``'s zeros,
  so its vlm tokens are text-only, and the port's give the same);
* 3 GUM steps of ``make_train_step`` on a fixed batch with images against
  the reference's ``make_train_step`` (its ``Trainer`` feeds tokens only):
  losses, and every parameter afterwards; the gates go to AdamW.

fp32 tolerance: rtol 1e-5 with atol 1e-5 of each tensor's largest entry;
the training losses 1e-4, parameters 1e-5 (``test_torch_hybrid._params_match``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import build_model, lm_loss
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import greedy_decode
from test_torch_hybrid import _close as _close_at
from test_torch_hybrid import _flat, _fro, _leaves, _params_match
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "llama-3.2-vision-11b"
RTOL = 1e-5
PROMPT, DECODE = 12, 4


_close = functools.partial(_close_at, rtol=RTOL)


def _reference_params(seed=0):
    """The reference's init with seeded nonzero gates (|tanh| 0.3–0.8)."""
    jparams = j_build_model(j_get_smoke(ARCH)).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(7)
    cross = dict(jparams["blocks"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        g = cross[name].shape[0]
        cross[name] = jnp.asarray(rng.uniform(0.3, 1.1, g) * rng.choice([-1.0, 1.0], g),
                                  jnp.float32)
    return {**jparams, "blocks": {**jparams["blocks"], "cross": cross}}


def _inputs(cfg, seed, batch, seq):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    images = (rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model)) * 0.02)
    return tokens, images.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """Both packages' SMOKE model on the reference's parameters (nonzero
    gates); the reference's logits, loss and gradients at "xla", its
    prefill cache and 4 decode steps of 2 rows from it."""
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = _reference_params()
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params(params)
    tokens, images = _inputs(jcfg, 0, 2, PROMPT)
    steps = np.random.default_rng(1).integers(0, jcfg.vocab, (DECODE, 2, 1)).astype(np.int32)
    jt, ji = jnp.asarray(tokens), jnp.asarray(images)

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jt, images=ji)
        return jmodel.loss(logits, jt, aux), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    _, jcache = jax.jit(j_make_prefill_step(jmodel))(jparams, {"tokens": jt, "images": ji})

    def grow(path, v):  # room for DECODE more positions in the self KV
        if path[0].key != "self":
            return v
        pad = [(0, 0)] * v.ndim
        pad[-3] = (0, DECODE)
        return jnp.pad(v, pad)

    cache = jax.tree_util.tree_map_with_path(grow, jcache)
    start = cache_from_jax(jax.device_get(cache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    jsteps = []
    for i in range(DECODE):
        jlog, cache = jstep(jparams, cache, jnp.asarray(steps[i]), jnp.int32(PROMPT + i))
        jsteps.append(np.asarray(jlog))
    return dict(jmodel=jmodel, jparams=jparams, params=params, model=model, tokens=tokens,
                images=images, steps=steps, loss=np.asarray(jl), logits=np.asarray(jlogits),
                grads=_flat(jgrads), prefill_cache=dict(_leaves(jax.device_get(jcache))),
                decode_start=start, decode_logits=jsteps,
                decode_cache=dict(_leaves(jax.device_get(cache))))


def _batch(case, **extra):
    return {"tokens": torch.from_numpy(case["tokens"]).long(),
            "images": torch.from_numpy(case["images"]), **extra}


def test_param_paths_and_shapes_match(case):
    ours = {k: tuple(v.shape) for k, v in case["model"].params().items()}
    theirs = {k: v.shape for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)
    assert ours == theirs
    cfg = case["model"].cfg
    G, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every
    assert ours["blocks/self/attn/wq"] == (G, per, cfg.d_model, cfg.n_heads * cfg.hd)
    assert ours["blocks/cross/xattn/wk"] == (G, cfg.d_model, cfg.kv_heads * cfg.hd)
    assert ours["blocks/cross/gate_attn"] == ours["blocks/cross/gate_mlp"] == (G,)
    params = case["model"].params()
    assert not default_lowrank_filter("blocks/cross/gate_attn", params["blocks/cross/gate_attn"])
    assert default_lowrank_filter("blocks/self/mlp/w_in", params["blocks/self/mlp/w_in"])
    assert float(params["blocks/cross/gate_mlp"].abs().min()) > 0.3


def test_logits_loss_and_grads_match(case):
    model, t = case["model"], torch.from_numpy(case["tokens"]).long()
    logits = model(t, images=torch.from_numpy(case["images"]))
    loss = lm_loss(logits, t)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for path, g in grads.items():
        _close(g, case["grads"][path], path)
    assert float(grads["blocks/cross/xattn/wk"].abs().max()) > 0  # the images reach the loss
    with pytest.raises(ValueError, match="images"):
        model(t)


def test_prefill_at_pallas_matches_reference_interpret(case):
    """The port at "pallas" (flash attention's plain version on the CPU:
    the self-attention causal, the cross-attention unmasked over 16 image
    tokens) against the reference's prefill at "interpret": logits and the
    cache, the image K/V included."""
    jmodel = j_build_model(j_get_smoke(ARCH).replace(attn_impl="interpret"))
    jlogits, jcache = jax.jit(j_make_prefill_step(jmodel))(
        case["jparams"], {"tokens": jnp.asarray(case["tokens"]),
                          "images": jnp.asarray(case["images"])})
    model = build_model(get_smoke(ARCH).replace(attn_impl="pallas"), device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)(_batch(case))
    _close(logits, jlogits, "prefill logits")
    ours, theirs = dict(_leaves(cache)), dict(_leaves(jax.device_get(jcache)))
    assert set(ours) == set(theirs) == {"self/k", "self/v", "xk", "xv"}
    for key, t in ours.items():
        assert tuple(t.shape) == theirs[key].shape, key
        _close(t, theirs[key], key)
        _close(t, case["prefill_cache"][key], f"{key} vs xla")


def test_bf16_logits_within_bf16s_own_distance(case):
    """dtype="bfloat16" on fp32 parameters (as published; the images cast
    to bf16 too): the port at "xla" and "pallas" no farther from the
    reference's bf16 logits (at "xla" and "interpret"), in Frobenius norm,
    than those lie from the reference's fp32 logits."""
    jt, ji = jnp.asarray(case["tokens"]), jnp.asarray(case["images"])
    for impl, j_impl in (("xla", "xla"), ("pallas", "interpret")):
        jmodel = j_build_model(j_get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=j_impl))
        jlogits, _, _ = jax.jit(jmodel.forward)(case["jparams"], jt, images=ji)
        model = build_model(get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=impl),
                            device="cpu")
        model.load_params(case["params"])
        with torch.no_grad():
            logits = model(torch.from_numpy(case["tokens"]).long(),
                           images=torch.from_numpy(case["images"]))
        assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
        bf16_vs_fp32 = _fro(jlogits, case["logits"])
        assert 0 < bf16_vs_fp32 < 0.05, (impl, bf16_vs_fp32)
        assert _fro(logits.float().numpy(), jlogits) <= bf16_vs_fp32, impl


def test_decode_steps_match(case):
    """4 steps of 2 rows from the reference's prefill cache (the self KV
    grown by 4 positions, the image K/V as the prefill made them): logits
    and the final cache."""
    step = make_serve_step(case["model"])
    cache = jax.tree_util.tree_map(torch.clone, case["decode_start"])
    empty = case["model"].init_cache(batch=2, max_seq=PROMPT + DECODE)
    assert {k: tuple(v.shape) for k, v in _leaves(empty)} == {
        k: tuple(v.shape) for k, v in _leaves(cache)}
    for i in range(DECODE):
        logits, cache = step(cache, torch.from_numpy(case["steps"][i]).long(), PROMPT + i)
        _close(logits, case["decode_logits"][i], f"decode step {i}")
    for key, t in _leaves(cache):
        _close(t, case["decode_cache"][key], f"decode {key}")


def test_decode_reproduces_the_forward(case):
    """Token-by-token decode from an empty self cache, the image K/V filled
    from the port's prefill (as the reference's own test fills them), gives
    the forward's logits at every position; with the image K/V left zero it
    does not (the cross blocks see no image)."""
    model = case["model"]
    with torch.no_grad():
        want, prefill_cache = model(torch.from_numpy(case["tokens"]).long(),
                                    return_cache=True, images=torch.from_numpy(case["images"]))
    step = make_serve_step(model)
    for fill in (True, False):
        cache = model.init_cache(batch=2, max_seq=PROMPT)
        if fill:
            cache["xk"].copy_(prefill_cache["xk"])
            cache["xv"].copy_(prefill_cache["xv"])
        got = []
        for i in range(PROMPT):
            logits, cache = step(cache, torch.from_numpy(case["tokens"][:, i:i + 1]).long(), i)
            got.append(logits[:, 0])
        got = torch.stack(got, 1)
        if fill:
            _close(got, want.numpy(), "decode vs forward", rtol=1e-4)
        else:
            assert _fro(got.numpy(), want.numpy()) > 1e-3


def test_engine_matches_reference_engine(case):
    """Three slots, three requests (no slot reused): the port's engine gives
    the reference engine's tokens, which are text-only (both start from
    zero image K/V), and each equals the port's direct decode."""
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4], [11, 3, 6, 2, 9, 1, 5]]
    jeng = JServeEngine(case["jmodel"], case["jparams"], slots=3, max_seq=32)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    eng = ServeEngine(case["model"], slots=3, max_seq=32)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == 3 and not any(r.reused_slot for r in reqs)
    assert not eng.cache["xk"].any() and not eng.cache["xv"].any()
    for req, jreq in zip(reqs, jreqs):
        assert req.output == jreq.output, (req.uid, req.output, jreq.output)
        assert greedy_decode(case["model"], req.prompt, 6, 32) == req.output


def test_gum_train_steps_track_reference():
    """3 GUM steps (rank 4, gamma 1, period 2) of ``make_train_step`` on one
    batch with images, against the reference's ``make_train_step``, its
    block samples injected: losses within 1e-4, parameters within 1e-5.
    The gates move under AdamW."""
    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = _reference_params(seed=1)
    tokens, images = _inputs(jcfg, 3, 2, 16)
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **opt))
    jstep = jax.jit(j_make_train_step(jmodel, jopt))
    jstate = jopt.init(jparams)
    jbatch = {"tokens": jnp.asarray(tokens), "images": jnp.asarray(images)}
    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    optimizer = build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler)
    step = make_train_step(model, optimizer)
    params = model.params()
    gates = params["blocks/cross/gate_attn"].detach().clone()
    state = optimizer.init({k: p.detach() for k, p in params.items()})
    batch = {"tokens": torch.from_numpy(tokens).long(), "images": torch.from_numpy(images)}
    for i in range(3):
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch)
        state, metrics = step(params, state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert not torch.equal(params["blocks/cross/gate_attn"].detach(), gates)
    _params_match(params, params_from_jax(jax.device_get(jparams)))
