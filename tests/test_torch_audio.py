"""The port's audio family (hubert-xlarge: an encoder-only stack of the dense
blocks, LayerNorm and GELU, no RoPE, behind the frames front end) against
the JAX package's, at its SMOKE config, with the reference's own initial
parameters (``params_from_jax``):

* parameter paths and shapes: ``embed/{frame_proj, pos_embed, lm_head}`` in
  place of the token embedding, in ``jax.tree_util``'s order;
* logits, the loss on the frames' targets (no shift, as the reference's
  ``_loss_from_batch``), the chunked loss through the frames head's
  ``lm_head`` and every gradient at "xla"; the prefill at "pallas" (flash
  attention's plain version, unmasked) against the reference's at
  "interpret"; the attention is unmasked (a later frame moves an earlier
  position's logits);
* the bf16 SMOKE forward at "xla" and "pallas" by Frobenius distance;
* encoder-only: ``init_cache``, ``decode_step`` and the engine raise;
* 3 GUM steps of ``make_train_step`` on a fixed batch of frames and
  targets against the reference's ``make_train_step``: losses, and every
  parameter afterwards (``frame_proj`` and ``pos_embed`` go to AdamW).

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
from repro.models.transformer import chunked_lm_loss as j_chunked_lm_loss
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.launch import steps
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import build_model, lm_loss
from repro_torch.serve import ServeEngine
from test_torch_hybrid import _close as _close_at
from test_torch_hybrid import _flat, _fro, _params_match
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "hubert-xlarge"
RTOL = 1e-5
SEQ = 32


_close = functools.partial(_close_at, rtol=RTOL)


def _inputs(cfg, seed, batch, seq):
    """Seeded frames (B, S, d) x 0.02 and unit targets (B, S)."""
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((batch, seq, cfg.d_model)) * 0.02).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def case():
    """Both packages' SMOKE model on the reference's parameters; the
    reference's logits, loss and gradients, and its chunked loss (chunk 5)
    and gradients, at "xla"."""
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params(params)
    frames, targets = _inputs(jcfg, 0, 2, SEQ)
    jf, jt = jnp.asarray(frames), jnp.asarray(targets)

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, frames=jf)
        return jmodel.loss(logits, jt, aux, shift=False), logits

    def jchunked(p):
        hidden, aux, _ = jmodel.forward(p, frames=jf, return_hidden=True)
        return j_chunked_lm_loss(p, jcfg.replace(logit_chunk=5), hidden, jt, aux, shift=False)

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jcl, jcgrads = jax.jit(jax.value_and_grad(jchunked))(jparams)
    return dict(jparams=jparams, params=params, model=model, frames=frames, targets=targets,
                loss=np.asarray(jl), logits=np.asarray(jlogits), grads=_flat(jgrads),
                chunked_loss=np.asarray(jcl), chunked_grads=_flat(jcgrads))


def _batch(case):
    return {"frames": torch.from_numpy(case["frames"]),
            "targets": torch.from_numpy(case["targets"]).long()}


def test_param_paths_and_shapes_match(case):
    ours = {k: tuple(v.shape) for k, v in case["model"].params().items()}
    theirs = {k: v.shape for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)
    assert ours == theirs
    cfg = case["model"].cfg
    assert ours["embed/frame_proj"] == (cfg.d_model, cfg.d_model)
    assert ours["embed/pos_embed"] == (cfg.max_seq, cfg.d_model)
    assert ours["embed/lm_head"] == (cfg.d_model, cfg.vocab)
    params = case["model"].params()
    lowrank = {k for k, p in params.items() if default_lowrank_filter(k, p)}
    assert not lowrank & {"embed/frame_proj", "embed/pos_embed", "embed/lm_head"}
    assert "blocks/mlp/w_in" in lowrank


def test_logits_loss_and_grads_match(case):
    """Logits, the unshifted loss and every gradient; then the chunked loss
    (``logit_chunk=5``, through ``embed/lm_head``) and its gradients, as the
    train step computes it."""
    model = case["model"]
    logits = model(frames=torch.from_numpy(case["frames"]))
    loss = lm_loss(logits, torch.from_numpy(case["targets"]).long(), shift=False)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    for (path, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        _close(g, case["grads"][path], path)
    chunked_model = build_model(get_smoke(ARCH).replace(logit_chunk=5), device="cpu")
    chunked_model.load_params(case["params"])
    chunked = steps._loss_from_batch(chunked_model, _batch(case))
    _close(chunked, case["chunked_loss"], "chunked loss")
    params = chunked_model.params()
    for (path, _), g in zip(params.items(),
                            torch.autograd.grad(chunked, list(params.values()))):
        _close(g, case["chunked_grads"][path], f"chunked {path}")


def test_prefill_at_pallas_matches_reference_interpret(case):
    jmodel = j_build_model(j_get_smoke(ARCH).replace(attn_impl="interpret"))
    jlogits, jcache = jax.jit(j_make_prefill_step(jmodel))(
        case["jparams"], {"frames": jnp.asarray(case["frames"])})
    model = build_model(get_smoke(ARCH).replace(attn_impl="pallas"), device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)(_batch(case))
    assert cache is None and jcache is None
    _close(logits, jlogits, "prefill logits")
    _close(logits, case["logits"], "prefill logits vs xla")


def test_attention_is_unmasked(case):
    """Encoder-only: the last frame moves the first position's logits."""
    model = case["model"]
    frames = torch.from_numpy(case["frames"])
    moved = frames.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a, b = model(frames=frames), model(frames=moved)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def test_bf16_logits_within_bf16s_own_distance(case):
    jf = jnp.asarray(case["frames"])
    for impl, j_impl in (("xla", "xla"), ("pallas", "interpret")):
        jmodel = j_build_model(j_get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=j_impl))
        jlogits, _, _ = jax.jit(lambda p, f: jmodel.forward(p, frames=f))(case["jparams"], jf)
        model = build_model(get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=impl),
                            device="cpu")
        model.load_params(case["params"])
        with torch.no_grad():
            logits = model(frames=torch.from_numpy(case["frames"]))
        assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
        bf16_vs_fp32 = _fro(jlogits, case["logits"])
        assert 0 < bf16_vs_fp32 < 0.05, (impl, bf16_vs_fp32)
        assert _fro(logits.float().numpy(), jlogits) <= bf16_vs_fp32, impl


def test_encoder_only_has_no_decode(case):
    model = case["model"]
    assert not model.cfg.has_decode
    with pytest.raises(ValueError, match="encoder-only"):
        model.init_cache(batch=1, max_seq=8)
    with pytest.raises(ValueError, match="encoder-only"):
        make_serve_step(model)({}, torch.zeros((1, 1), dtype=torch.long), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(model, slots=1, max_seq=8)
    with pytest.raises(ValueError, match="frames"):
        model(torch.zeros((1, 4), dtype=torch.long))


def test_gum_train_steps_track_reference():
    """3 GUM steps (rank 4, gamma 1, period 2) of ``make_train_step`` on one
    batch of frames and targets against the reference's
    ``make_train_step``, its block samples injected: losses within 1e-4,
    parameters within 1e-5."""
    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    frames, targets = _inputs(jcfg, 3, 2, SEQ)
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **opt))
    jstep = jax.jit(j_make_train_step(jmodel, jopt))
    jstate = jopt.init(jparams)
    jbatch = {"frames": jnp.asarray(frames), "targets": jnp.asarray(targets)}
    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    optimizer = build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler)
    step = make_train_step(model, optimizer)
    params = model.params()
    state = optimizer.init({k: p.detach() for k, p in params.items()})
    batch = {"frames": torch.from_numpy(frames), "targets": torch.from_numpy(targets).long()}
    for i in range(3):
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch)
        state, metrics = step(params, state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    _params_match(params, params_from_jax(jax.device_get(jparams)))
