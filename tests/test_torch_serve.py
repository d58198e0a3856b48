"""The port's serving path against the JAX package's, with the reference's
own initial parameters (``params_from_jax``), on llama-60m SMOKE (dense) and
mamba2-370m SMOKE (ssm), fp32:

* ``make_prefill_step`` at attn_impl="pallas" (the kernels' plain versions
  on the CPU) against ``repro.launch.steps.make_prefill_step`` at
  attn_impl="interpret" (the Pallas kernels in interpret mode): logits and
  the KV cache;
* twelve ``decode_step``s from a reference cache (``cache_from_jax``):
  logits of every step and the final cache;
* ``ServeEngine`` on mixed prompt lengths with reused slots against the
  reference's direct greedy decode (``tests/test_serve_engine.py``'s
  oracle), including a mamba request in a reused slot — where the
  reference's own engine, which does not reset the slot's recurrent state,
  differs;
* one bf16 mamba forward.

Tolerance: 1e-4 of each tensor's largest entry in fp32 (sums in another
order through a few layers); bf16 see the test.  Token outputs are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import build_model as j_build_model
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import greedy_decode
from torch_threads import _one_thread  # noqa: F401  (autouse)


TOL = 1e-4
ARCHS = ["llama-60m", "mamba2-370m"]


def _close(got: torch.Tensor, want, tol=TOL, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()), err_msg=name)


def _models(arch, j_impl="xla", impl="xla", **over):
    jcfg = j_get_smoke(arch).replace(attn_impl=j_impl, **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch).replace(attn_impl=impl, **over), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def greedy_reference(model, params, prompt, n_new, max_seq):
    """Direct single-request greedy decode in the JAX package (the oracle of
    ``tests/test_serve_engine.py``)."""
    cache = model.init_cache(batch=1, max_seq=max_seq, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, pos: model.decode_step(p, cache=c, tokens=t, pos=pos))
    logits = None
    for i, tok in enumerate(prompt):
        logits, cache = step(params, cache, jnp.asarray([[tok]], jnp.int32), jnp.int32(i))
    out = []
    tok = int(jnp.argmax(logits[0, -1]))
    for i in range(len(prompt), len(prompt) + n_new):
        out.append(tok)
        logits, cache = step(params, cache, jnp.asarray([[tok]], jnp.int32), jnp.int32(i))
        tok = int(jnp.argmax(logits[0, -1]))
    return out[:n_new]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_interpret(arch):
    jmodel, jparams, model = _models(arch, j_impl="interpret", impl="pallas")
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 32)).astype(np.int32)
    jlogits, jcache = j_make_prefill_step(jmodel)(jparams, {"tokens": jnp.asarray(tokens)})
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(tokens).long()})
    _close(logits, jlogits, name="logits")
    if model.cfg.family == "dense":
        assert set(cache) == set(jcache) == {"k", "v"}
        for key in cache:
            _close(cache[key], jcache[key], name=key)
    else:
        assert cache is None and jcache is None


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    jmodel, jparams, model = _models(arch)
    jcache = jmodel.init_cache(batch=2, max_seq=16, dtype=jnp.float32)
    cache = cache_from_jax(jax.device_get(jcache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    step = make_serve_step(model)
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab, (12, 2, 1)).astype(np.int32)
    for i in range(12):
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tokens[i]), jnp.int32(i))
        logits, cache = step(cache, torch.from_numpy(tokens[i]).long(), i)
        _close(logits, jlogits, name=f"logits step {i}")
    for key in cache:
        _close(cache[key], jcache[key], name=key)


def test_decode_step_takes_one_position_per_row():
    """Rows at different positions in one batched step equal each row
    decoded alone at its position."""
    _, _, model = _models("llama-60m")
    step = make_serve_step(model)
    rng = np.random.default_rng(2)
    cache = model.init_cache(batch=2, max_seq=16)
    cache = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in cache.items()}
    tokens = torch.tensor([[3], [7]])
    pos = torch.tensor([4, 11])
    logits, new = step({k: v.clone() for k, v in cache.items()}, tokens, pos)
    for b in range(2):
        one = {k: v[:, b:b + 1].clone() for k, v in cache.items()}
        want, one = step(one, tokens[b:b + 1], int(pos[b]))
        torch.testing.assert_close(logits[b:b + 1], want, rtol=TOL, atol=TOL)
        for k in one:
            torch.testing.assert_close(new[k][:, b:b + 1], one[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_direct_decode(arch):
    jmodel, jparams, model = _models(arch)
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4], [4, 4], [11, 3, 6, 2, 9, 1, 5]]
    eng = ServeEngine(model, slots=2, max_seq=48)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == 4
    assert [r.reused_slot for r in reqs] == [False, False, True, True]
    for req in reqs:
        want = greedy_reference(jmodel, jparams, req.prompt, 6, 48)
        assert req.output == want, (arch, req.uid, req.output, want)
        assert greedy_decode(model, req.prompt, 6, 48) == want


def test_mamba_reused_slot_starts_from_an_empty_state():
    """One slot, two requests: the second starts from a zero conv window
    and SSD state and equals the direct decode.  The reference engine keeps
    the first request's state in the slot and gives another output."""
    jmodel, jparams, model = _models("mamba2-370m")
    eng = ServeEngine(model, slots=1, max_seq=48)
    first, second = eng.submit([5, 9, 3, 11, 2], 6), eng.submit([7, 1], 6)
    eng.run()
    assert second.reused_slot
    assert first.output == greedy_reference(jmodel, jparams, first.prompt, 6, 48)
    assert second.output == greedy_reference(jmodel, jparams, second.prompt, 6, 48)


def test_mamba_bf16_forward_matches_reference():
    """dtype="bfloat16" with fp32 parameters, as mamba2-370m is published:
    the two packages round bf16 at other places (XLA fuses elementwise work
    that torch rounds op by op), so the logits agree to 2^-5 of their
    largest entry — a few bf16 roundings (2^-8 each) through three
    blocks."""
    jmodel, jparams, model = _models("mamba2-370m", dtype="bfloat16")
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 32)).astype(np.int32)
    jlogits, _, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    _close(logits, jlogits, 2.0 ** -5, "bf16 logits")
