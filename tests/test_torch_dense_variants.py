"""The dense variants of the port (chatglm3-6b, qwen1.5-4b, starcoder2-7b)
against the JAX package's, at their SMOKE configs, with the reference's own
initial parameters (carried across with ``params_from_jax``):

* parameter paths (the qkv and mlp biases, layernorm's ``norm_bias``, no
  ``w_gate`` for gelu / relu2) and shapes, in ``jax.tree_util``'s order;
* logits, loss and every parameter gradient; the prefill's KV cache (the
  port at attn_impl="pallas", whose flash attention runs its plain version
  on the CPU); 4 decode steps from the reference's prefill cache;
* the same for SMOKE variants: geglu (qwen1.5-4b), relu2 (starcoder2-7b,
  with its layernorm and biases) and RoPE on half the head dims
  (``rope_fraction=0.5``, qwen1.5-4b);
* each SMOKE with ``dtype="bfloat16"``: the port's logits at "xla" and at
  "pallas" (the reference at "interpret": its Pallas kernel in interpret
  mode) lie no farther from the reference's bf16 logits, in Frobenius
  norm, than those lie from the reference's fp32 logits at the same
  parameters — the rule ``chip_smoke.check_low_precision_prefill`` applies
  on the card (both packages round bf16 at other places, so bf16 itself
  sets the scale);
* a 3-step GUM ``Trainer`` run on chatglm3-6b SMOKE (biases and norms go to
  the fallback by ``default_lowrank_filter``) with the reference's sampled
  blocks injected.

fp32 tolerance: rtol 1e-4 with atol 1e-4 of each tensor's largest entry, as
``tests/test_torch_model.py`` (fp32 sums in another order through two
layers and a softmax); the trainer's losses rtol 1e-4.
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
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.data import DataConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, lm_loss
from repro_torch.train import Trainer
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)


RTOL = 1e-4
ARCHS = ["chatglm3-6b", "qwen1.5-4b", "starcoder2-7b"]
# (case id, arch, config overrides)
CASES = [(arch, arch, {}) for arch in ARCHS] + [
    ("qwen1.5-4b-geglu", "qwen1.5-4b", {"act": "geglu"}),
    ("starcoder2-7b-relu2", "starcoder2-7b", {"act": "relu2"}),
    ("qwen1.5-4b-rope-half", "qwen1.5-4b", {"rope_fraction": 0.5}),
]
PROMPT, DECODE = 12, 4


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _flat(jtree) -> dict:
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]}


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """One SMOKE model in both packages, the reference's outputs computed
    once: logits, loss and gradients, the prefill cache, and 4 decode steps
    from that cache."""
    _, arch, over = request.param
    jcfg = j_get_smoke(arch).replace(**over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(arch).replace(**over), device="cpu")
    model.load_params(params)
    tokens = _tokens(jcfg, 0, (2, PROMPT))
    steps = _tokens(jcfg, 1, (DECODE, 2, 1))

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jnp.asarray(tokens))
        return jmodel.loss(logits, jnp.asarray(tokens), aux), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    _, jcache = jax.jit(j_make_prefill_step(jmodel))(jparams, {"tokens": jnp.asarray(tokens)})
    cache = {k: jnp.zeros(v.shape[:2] + (PROMPT + DECODE,) + v.shape[3:], jnp.float32)
             .at[:, :, :PROMPT].set(v) for k, v in jcache.items()}
    start = cache_from_jax(jax.device_get(cache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    jsteps = []
    for i in range(DECODE):
        jlog, cache = jstep(jparams, cache, jnp.asarray(steps[i]), jnp.int32(PROMPT + i))
        jsteps.append(np.asarray(jlog))
    return dict(arch=arch, over=over, jparams=jparams, params=params, model=model,
                tokens=tokens, steps=steps, loss=np.asarray(jl), logits=np.asarray(jlogits),
                grads=_flat(jgrads), prefill_cache=_flat(jcache), decode_start=start,
                decode_logits=jsteps, decode_cache=_flat(cache))


def test_param_paths_and_shapes_match(case):
    ours = {k: tuple(v.shape) for k, v in case["model"].params().items()}
    theirs = {k: v.shape for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)  # same leaf order as jax.tree_util
    assert ours == theirs
    cfg = case["model"].cfg
    assert ("blocks/attn/bias_q" in ours) == cfg.qkv_bias
    assert ("blocks/mlp/bias_in" in ours) == cfg.mlp_bias
    assert ("final_norm/norm_bias" in ours) == (cfg.norm == "layernorm")
    assert ("blocks/mlp/w_gate" in ours) == (cfg.act in ("swiglu", "geglu"))
    lowrank = {k for k, p in case["model"].params().items() if default_lowrank_filter(k, p)}
    assert all("bias" not in k and "norm" not in k for k in lowrank)


def test_logits_loss_and_grads_match(case):
    model, t = case["model"], torch.from_numpy(case["tokens"]).long()
    logits = model(t)
    loss = lm_loss(logits, t)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    for (path, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        _close(g, case["grads"][path], path)


def test_prefill_cache_matches(case):
    """The port at attn_impl="pallas" (flash attention's plain version on
    the CPU) against the reference's prefill at "xla": in fp32 the two
    attention routes compute the same."""
    model = build_model(get_smoke(case["arch"]).replace(attn_impl="pallas", **case["over"]),
                        device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(case["tokens"]).long()})
    _close(logits, case["logits"], "prefill logits")
    assert set(cache) == {"k", "v"}
    for key in cache:
        _close(cache[key], case["prefill_cache"][key], key)


def test_decode_steps_match(case):
    step = make_serve_step(case["model"])
    cache = {k: v.clone() for k, v in case["decode_start"].items()}
    for i in range(DECODE):
        logits, cache = step(cache, torch.from_numpy(case["steps"][i]).long(), PROMPT + i)
        _close(logits, case["decode_logits"][i], f"decode step {i}")
    for key in cache:
        _close(cache[key], case["decode_cache"][key], f"decode {key}")


def _fro(a, b) -> float:
    a, b = (np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_bf16s_own_distance(arch):
    """dtype="bfloat16", fp32 parameters (as published): the port at "xla"
    and at "pallas" against the reference at "xla" and at "interpret"."""
    jparams = j_build_model(j_get_smoke(arch)).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    tokens = _tokens(get_smoke(arch), 2, (2, 16))
    jfp32, _, _ = jax.jit(j_build_model(j_get_smoke(arch)).forward)(jparams,
                                                                    jnp.asarray(tokens))
    for impl, j_impl in (("xla", "xla"), ("pallas", "interpret")):
        jmodel = j_build_model(j_get_smoke(arch).replace(dtype="bfloat16", attn_impl=j_impl))
        jlogits, _, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens))
        model = build_model(get_smoke(arch).replace(dtype="bfloat16", attn_impl=impl),
                            device="cpu")
        model.load_params(params)
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens).long())
        assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
        port_vs_ref = _fro(logits.float().numpy(), jlogits)
        bf16_vs_fp32 = _fro(jlogits, jfp32)
        assert 0 < bf16_vs_fp32 < 0.05, (impl, bf16_vs_fp32)
        assert port_vs_ref <= bf16_vs_fp32, (impl, port_vs_ref, bf16_vs_fp32)


def test_gum_trainer_tracks_reference_on_chatglm(tmp_path):
    """3 GUM steps (rank 4, gamma 1, period 2: a refresh on steps 1 and 3)
    from the reference's initial parameters, its block samples injected."""
    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    jcfg = j_get_smoke("chatglm3-6b")
    data = dict(vocab=jcfg.vocab, seq_len=32, global_batch=2, seed=0)
    jtrainer = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
        JRunConfig(steps=3, ckpt_dir=str(tmp_path / "jax"), ckpt_every=100, log_every=0,
                   resume=False, seed=0),
        JDataConfig(**data))
    jlosses = jtrainer.train().losses
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    trainer = Trainer(
        build_model(get_smoke("chatglm3-6b"), device="cpu"), OptimizerConfig(**opt),
        RunConfig(steps=3, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data), device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler),
        params=params_from_jax(jax.device_get(jparams)))
    result = trainer.train()
    assert len(result.losses) == len(jlosses) == 3
    np.testing.assert_allclose(result.losses, jlosses, rtol=1e-4, atol=0)
    assert result.skipped_nonfinite == 0
