"""The port's hybrid family (zamba2-1.2b: a Mamba-2 stack and one shared
attention-and-MLP block, not stacked, applied after every
``shared_attn_every``-th Mamba layer) against the JAX package's, at its
SMOKE config (4 layers, the shared block after layers 0 and 2), with the
reference's own initial parameters (``params_from_jax``):

* parameter paths and shapes, in ``jax.tree_util``'s order: the L-stacked
  ``blocks/{ln1, mamba}`` and the unstacked ``shared/{ln1, attn, ln2,
  mlp}``;
* logits, ``lm_loss`` and every parameter gradient at "xla"; the prefill at
  "pallas" (the SSD scan's and flash attention's plain versions on the CPU)
  against the reference's at "interpret" (its Pallas kernels in interpret
  mode), which builds no decode cache in either package;
* the bf16 SMOKE forward at "xla" and "pallas" by Frobenius distance;
* 6 decode steps from the reference's zero cache (``cache_from_jax``): the
  Mamba state and one KV slot a shared-block application, written only at
  the applying layer; token-by-token decode reproducing the forward;
* the port's engine against the reference's ``ServeEngine`` on requests in
  fresh slots, and a request in a reused slot against direct decode (the
  port zeroes the slot's Mamba state; the reference's engine does not);
* a 3-step GUM ``Trainer`` run against the reference's, its sampled blocks
  injected: losses, and every parameter afterwards.  GUM sees the shared
  matrices as L = 1 leaves, so gamma / L >= 1 and they take the full-rank
  branch on every step, as in the reference.

Tolerance: 1e-4 relative, with atol 1e-4 of each tensor's largest entry,
since the SSD scan is on every path (fp32 sums in another order through
cumulative sums and exponentials); parameters after training 1e-5.
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
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.data import DataConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, lm_loss
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import greedy_decode
from repro_torch.train import Trainer
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "zamba2-1.2b"
RTOL = 1e-4
SEQ, DECODE = 32, 6


def _close(got: torch.Tensor, want, name="", rtol=RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=name)


def _flat(jtree) -> dict:
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]}


def _fro(a, b) -> float:
    a, b = (np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _leaves(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def case():
    """Both packages' SMOKE model on the reference's parameters, and the
    reference's logits, loss and gradients at "xla", and 6 decode steps of 2
    rows from its zero cache."""
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params(params)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, SEQ)).astype(np.int32)
    steps = np.random.default_rng(1).integers(0, jcfg.vocab, (DECODE, 2, 1)).astype(np.int32)

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jnp.asarray(tokens))
        return jmodel.loss(logits, jnp.asarray(tokens), aux), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jcache = jmodel.init_cache(batch=2, max_seq=16, dtype=jnp.float32)
    start = cache_from_jax(jax.device_get(jcache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    jsteps = []
    for i in range(DECODE):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(steps[i]), jnp.int32(i))
        jsteps.append(np.asarray(jlog))
    return dict(jmodel=jmodel, jparams=jparams, params=params, model=model, tokens=tokens,
                steps=steps, loss=np.asarray(jl), logits=np.asarray(jlogits),
                grads=_flat(jgrads), decode_start=start, decode_logits=jsteps,
                decode_cache=dict(_leaves(jax.device_get(jcache))))


def test_param_paths_and_shapes_match(case):
    ours = {k: tuple(v.shape) for k, v in case["model"].params().items()}
    theirs = {k: v.shape for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)
    assert ours == theirs
    cfg = case["model"].cfg
    assert ours["blocks/mamba/ssm_in"][0] == cfg.n_layers
    assert ours["shared/attn/wq"] == (cfg.d_model, cfg.n_heads * cfg.hd)  # one copy
    assert ours["shared/mlp/w_out"] == (cfg.d_ff, cfg.d_model)
    lowrank = {k for k, p in case["model"].params().items() if default_lowrank_filter(k, p)}
    assert {"shared/attn/wq", "shared/mlp/w_in", "blocks/mamba/ssm_in"} <= lowrank


def test_logits_loss_and_grads_match(case):
    model, t = case["model"], torch.from_numpy(case["tokens"]).long()
    logits = model(t)
    loss = lm_loss(logits, t)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    for (path, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        _close(g, case["grads"][path], path)


def test_prefill_at_pallas_matches_reference_interpret(case):
    """The port at "pallas" (plain versions of the SSD scan and flash
    attention on the CPU) against the reference's prefill at "interpret";
    neither builds a decode cache."""
    jmodel = j_build_model(j_get_smoke(ARCH).replace(attn_impl="interpret"))
    tokens = case["tokens"]
    jlogits, jcache = jax.jit(j_make_prefill_step(jmodel))(case["jparams"],
                                                           {"tokens": jnp.asarray(tokens)})
    model = build_model(get_smoke(ARCH).replace(attn_impl="pallas"), device="cpu")
    model.load_params(case["params"])
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(tokens).long()})
    assert cache is None and jcache is None
    _close(logits, jlogits, "prefill logits")


def test_bf16_logits_within_bf16s_own_distance(case):
    """dtype="bfloat16" on fp32 parameters (as zamba2-1.2b is published):
    the port at "xla" and "pallas" no farther from the reference's bf16
    logits (at "xla" and "interpret"), in Frobenius norm, than those lie
    from the reference's fp32 logits."""
    tokens = jnp.asarray(case["tokens"])
    jfp32 = case["logits"]
    for impl, j_impl in (("xla", "xla"), ("pallas", "interpret")):
        jmodel = j_build_model(j_get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=j_impl))
        jlogits, _, _ = jax.jit(jmodel.forward)(case["jparams"], tokens)
        model = build_model(get_smoke(ARCH).replace(dtype="bfloat16", attn_impl=impl),
                            device="cpu")
        model.load_params(case["params"])
        with torch.no_grad():
            logits = model(torch.from_numpy(case["tokens"]).long())
        assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
        bf16_vs_fp32 = _fro(jlogits, jfp32)
        assert 0 < bf16_vs_fp32 < 0.05, (impl, bf16_vs_fp32)
        assert _fro(logits.float().numpy(), jlogits) <= bf16_vs_fp32, impl


def test_decode_steps_match(case):
    """6 steps of 2 rows from the reference's zero cache: the logits of
    every step and the final cache (Mamba conv window and SSD state, and
    the shared block's KV slots) in the reference's layout."""
    step = make_serve_step(case["model"])
    cache = jax.tree_util.tree_map(torch.clone, case["decode_start"])
    assert {k: tuple(v.shape) for k, v in _leaves(cache)} == {
        k: tuple(v.shape) for k, v in _leaves(case["model"].init_cache(2, 16, torch.float32))}
    assert cache["attn"]["k"].shape[0] == 2  # applications after layers 0 and 2
    for i in range(DECODE):
        logits, cache = step(cache, torch.from_numpy(case["steps"][i]).long(), i)
        _close(logits, case["decode_logits"][i], f"decode step {i}")
    for key, t in _leaves(cache):
        _close(t, case["decode_cache"][key], f"decode {key}")


def test_decode_reproduces_the_forward(case):
    """Token-by-token decode from an empty cache gives the forward's logits
    at every position."""
    model = case["model"]
    tokens = torch.from_numpy(case["tokens"][:, :12]).long()
    with torch.no_grad():
        want = model(tokens)
    step = make_serve_step(model)
    cache = model.init_cache(batch=2, max_seq=12)
    got = []
    for i in range(tokens.shape[1]):
        logits, cache = step(cache, tokens[:, i:i + 1], i)
        got.append(logits[:, 0])
    _close(torch.stack(got, 1), want.numpy(), "decode vs forward")


def test_engine_matches_reference_engine(case):
    """Three slots, three requests (no slot reused): the port's engine gives
    the reference engine's tokens and each equals the port's direct decode.
    Then one slot and two requests: the second, in the reused slot, equals
    its direct decode (the port zeroes the slot's Mamba state)."""
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4], [11, 3, 6, 2, 9, 1, 5]]
    jeng = JServeEngine(case["jmodel"], case["jparams"], slots=3, max_seq=32)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    eng = ServeEngine(case["model"], slots=3, max_seq=32)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == 3 and not any(r.reused_slot for r in reqs)
    for req, jreq in zip(reqs, jreqs):
        assert req.output == jreq.output, (req.uid, req.output, jreq.output)
        assert greedy_decode(case["model"], req.prompt, 6, 32) == req.output
    eng = ServeEngine(case["model"], slots=1, max_seq=32)
    first, second = eng.submit(prompts[1], 6), eng.submit([4, 4], 6)
    eng.run()
    assert second.reused_slot
    assert first.output == reqs[1].output
    assert second.output == greedy_decode(case["model"], [4, 4], 6, 32)


def test_gum_trainer_tracks_reference(tmp_path):
    """3 GUM steps (rank 4, gamma 1, period 2) from the reference's initial
    parameters, its block samples injected: losses within 1e-4 and every
    parameter afterwards within 1e-5 of the reference's.  On each refresh
    (steps 1 and 3) the shared block's matrices reach the sampler as L = 1
    leaves (q = gamma / L = 1: the full-rank branch), the stacked ones as
    L = 4."""
    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    jcfg = j_get_smoke(ARCH)
    data = dict(vocab=jcfg.vocab, seq_len=SEQ, global_batch=2, seed=0)
    jtrainer = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
        JRunConfig(steps=3, ckpt_dir=str(tmp_path / "jax"), ckpt_every=0, log_every=0,
                   resume=False, seed=0),
        JDataConfig(**data))
    jlosses = jtrainer.train().losses
    (jp, _), _ = jtrainer.ckpt.restore(3, jtrainer.init_state())
    want = params_from_jax(jax.device_get(jp))
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    seen = []

    def sampler(key, L, g_f):
        seen.append((L, g_f))
        return jax_sampler(key, L, g_f)

    trainer = Trainer(
        build_model(get_smoke(ARCH), device="cpu"), OptimizerConfig(**opt),
        RunConfig(steps=3, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data), device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**opt), sampler=sampler),
        params=params_from_jax(jax.device_get(jparams)))
    result = trainer.train()
    assert len(result.losses) == len(jlosses) == 3
    np.testing.assert_allclose(result.losses, jlosses, rtol=1e-4, atol=0)
    assert result.skipped_nonfinite == 0
    shared = sum(1 for k, p in trainer.model.params().items()
                 if k.startswith("shared/") and default_lowrank_filter(k, p))
    assert shared == 7 and seen.count((1, 1)) == 2 * shared
    assert {L for L, _ in seen} == {1, get_smoke(ARCH).n_layers}
    _params_match(trainer.model.params(), want)


def _params_match(params: dict, want: dict) -> None:
    """Every leaf within 1e-5 of the reference's in relative Frobenius
    distance, GUM's leaves also element by element within 1e-5 (as
    ``tests/test_torch_rank_policy.py`` holds them).  AdamW's leaves are
    held by norm alone: Adam's first steps divide by |g|, so an entry whose
    gradient is near zero carries fp32 rounding up to the learning rate's
    scale (ROADMAP queue 3)."""
    for k, p in params.items():
        p = p.detach()
        if default_lowrank_filter(k, p):
            assert float((p - want[k]).abs().max()) <= 1e-5, k
        rel = float(torch.linalg.vector_norm(p - want[k]) / torch.linalg.vector_norm(want[k]))
        assert rel <= 1e-5, (k, rel)
