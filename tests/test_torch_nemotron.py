"""nemotron-4-340b (dense: GQA, squared-ReLU MLP, layernorm, untied head)
in the port against the JAX package, at its SMOKE config, with the
reference's own initial parameters (carried across with
``params_from_jax``):

* three cases: SMOKE (fp32); ``SMOKE.replace(head_dim=192)``, the full
  model's head dim, which flash attention pads to its 192 tier; and
  ``SMOKE.replace(param_dtype="bfloat16")``, the reference's storage knob,
  run at ``dtype`` fp32;
* for each: parameter paths, shapes and per-leaf dtypes in
  ``jax.tree_util``'s order (under bf16 storage every leaf with two or more
  dims is bf16, the layer-stacked norms included, and only ``final_norm``
  stays fp32: the reference's code, whose comment says otherwise); logits,
  loss and every gradient; the prefill logits and KV cache, the port at
  attn_impl="pallas" (flash attention's plain version on the CPU) against
  the reference at "interpret" (its Pallas kernel in interpret mode, at
  D = 192 in the second case); 4 decode steps from the reference's cache;
* bf16 storage at ``dtype="bfloat16"`` (head dim 16 and 192): the port's
  logits at "xla" and "pallas" lie no farther from the reference's bf16
  logits, in Frobenius norm, than those lie from the reference's fp32
  logits of the same draws stored in fp32 (the rule of
  ``tests/test_torch_dense_variants.py``, bf16 being storage and
  activations here);
* the bf16-stored init: each leaf is the fp32 init's draw, rounded.
Training on bf16-stored parameters is held in
``tests/test_torch_bf16_train.py``.

fp32 tolerance: rtol 1e-4 with atol 1e-4 of each tensor's largest entry, as
``tests/test_torch_dense_variants.py``.  Gradients of bf16-stored leaves are
bf16 on both sides, each an fp32 gradient rounded once: they may part by one
bf16 step, 2^-7 of the element's magnitude.  The embedding's too: the port
gathers the bf16 rows and then casts them (an fp32 copy of the whole table
would take 18.9 GB at full width), and its backward sums a token's rows'
gradients in fp32 and rounds once, as the reference's cast-then-gather does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, lm_loss
from torch_threads import _one_thread  # noqa: F401  (autouse)


ARCH = "nemotron-4-340b"
RTOL = 1e-4
# (case id, config overrides)
CASES = [("smoke", {}), ("head-dim-192", {"head_dim": 192}),
         ("bf16-params", {"param_dtype": "bfloat16"})]
PROMPT, DECODE = 12, 4


def _close(got: torch.Tensor, want, name="", rtol=RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _flat(jtree) -> dict:
    return {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]}


def _tokens(vocab, seed, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_config_is_the_references():
    from repro.configs import get_config as j_get_config

    for ours, theirs in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_smoke(ARCH), j_get_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_ff, cfg.vocab) == (
        18432, 96, 8, 192, 73728, 256000)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """One SMOKE model in both packages and the reference's outputs: logits,
    loss and gradients, the prefill at "interpret", and 4 decode steps from
    its cache."""
    _, over = request.param
    jcfg = j_get_smoke(ARCH).replace(**over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(ARCH).replace(**over), device="cpu")
    model.load_params(params)
    tokens = _tokens(jcfg.vocab, 0, (2, PROMPT))
    steps = _tokens(jcfg.vocab, 1, (DECODE, 2, 1))

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jnp.asarray(tokens))
        return jmodel.loss(logits, jnp.asarray(tokens), aux), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jpallas = j_build_model(jcfg.replace(attn_impl="interpret"))
    jprefill_logits, jcache = jax.jit(j_make_prefill_step(jpallas))(
        jparams, {"tokens": jnp.asarray(tokens)})
    cache = {k: jnp.zeros(v.shape[:2] + (PROMPT + DECODE,) + v.shape[3:], jnp.float32)
             .at[:, :, :PROMPT].set(v) for k, v in jcache.items()}
    start = cache_from_jax(jax.device_get(cache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    jsteps = []
    for i in range(DECODE):
        jlog, cache = jstep(jparams, cache, jnp.asarray(steps[i]), jnp.int32(PROMPT + i))
        jsteps.append(np.asarray(jlog))
    return dict(over=over, jparams=jparams, params=params, model=model, tokens=tokens,
                steps=steps, loss=np.asarray(jl), logits=np.asarray(jlogits),
                grads=_flat(jgrads), prefill_logits=np.asarray(jprefill_logits),
                prefill_cache=_flat(jcache), decode_start=start, decode_logits=jsteps,
                decode_cache=_flat(cache))


def test_param_paths_shapes_and_dtypes_match(case):
    ours = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in case["model"].params().items()}
    theirs = {k: (v.shape, v.dtype.name) for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)  # same leaf order as jax.tree_util
    assert ours == theirs
    assert "blocks/mlp/w_gate" not in ours and "embed/lm_head" in ours  # relu2, untied
    low = {k for k, (shape, dtype) in ours.items() if dtype == "bfloat16"}
    if case["over"].get("param_dtype") == "bfloat16":
        assert low == {k for k, (shape, _) in ours.items() if len(shape) >= 2}
        assert "blocks/ln1/norm_scale" in low and "final_norm/norm_scale" not in low
    else:
        assert not low
    # convert carried the reference's dtypes, and load_params kept them
    assert {k: str(v.dtype)[6:] for k, v in case["params"].items()} == {
        k: dtype for k, (_, dtype) in ours.items()}


def test_logits_loss_and_grads_match(case):
    model, t = case["model"], torch.from_numpy(case["tokens"]).long()
    logits = model(t)
    loss = lm_loss(logits, t)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    for (path, p), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        want = case["grads"][path]
        assert g.dtype == p.dtype and str(g.dtype)[6:] == want.dtype.name, path
        _close(g, want, path, rtol=RTOL if p.dtype == torch.float32 else 2.0 ** -7)


def test_prefill_at_pallas_matches_interpret(case):
    """The port at attn_impl="pallas" against the reference's Pallas kernel
    in interpret mode (at head dim 192 in the second case)."""
    model = build_model(get_smoke(ARCH).replace(attn_impl="pallas", **case["over"]),
                        device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(case["tokens"]).long()})
    _close(logits, case["prefill_logits"], "prefill logits")
    _close(logits, case["logits"], "prefill logits against the forward")
    assert set(cache) == {"k", "v"}
    for key in cache:
        assert cache[key].shape[-1] == model.cfg.hd
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


@pytest.mark.parametrize("head_dim", [16, 192])
def test_bf16_storage_in_bf16_within_bf16s_own_distance(head_dim):
    """param_dtype and dtype both bf16, as the card serves the full model:
    the port at "xla" and at "pallas" against the reference at "xla" and at
    "interpret", held as test_torch_dense_variants holds bf16 logits, bf16
    here being storage and activations both: the reference's fp32 logits
    come from the same draws stored in fp32 (its init casts after drawing).
    (Against the bf16-stored parameters run in fp32, the reference's bf16
    logits lie about as far as the two packages' bf16 roundings lie from
    each other: 7.90e-3 against 8.35e-3 at head dim 192.)"""
    jcfg = j_get_smoke(ARCH).replace(param_dtype="bfloat16", head_dim=head_dim)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    tokens = _tokens(jcfg.vocab, 2, (2, 16))
    j32cfg = jcfg.replace(param_dtype="float32")
    jfp32, _, _ = jax.jit(j_build_model(j32cfg).forward)(
        j_build_model(j32cfg).init(jax.random.PRNGKey(0)), jnp.asarray(tokens))
    for impl, j_impl in (("xla", "xla"), ("pallas", "interpret")):
        jmodel = j_build_model(jcfg.replace(dtype="bfloat16", attn_impl=j_impl))
        jlogits, _, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens))
        model = build_model(get_smoke(ARCH).replace(param_dtype="bfloat16", head_dim=head_dim,
                                                    dtype="bfloat16", attn_impl=impl),
                            device="cpu")
        model.load_params(params)
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens).long())
        assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
        port_vs_ref = _fro(logits.float().numpy(), jlogits)
        bf16_vs_fp32 = _fro(jlogits, jfp32)
        assert 0 < bf16_vs_fp32 < 0.05, (impl, bf16_vs_fp32)
        assert port_vs_ref <= bf16_vs_fp32, (impl, port_vs_ref, bf16_vs_fp32)


def test_bf16_storage_init_is_the_fp32_draw_rounded():
    fp32 = build_model(get_smoke(ARCH), device="cpu")
    fp32.init_params(3)
    low = build_model(get_smoke(ARCH).replace(param_dtype="bfloat16"), device="cpu")
    low.init_params(3)
    for (path, a), b in zip(fp32.params().items(), low.params().values()):
        assert b.dtype == (torch.bfloat16 if a.dim() >= 2 else torch.float32), path
        assert torch.equal(a.to(b.dtype), b), path
