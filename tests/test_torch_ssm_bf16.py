"""The ssm family (mamba2-370m) on bf16-stored parameters
(``ModelConfig.param_dtype="bfloat16"``) against the JAX package, at its
SMOKE config, from the reference's own initial draws (``params_from_jax`` of
its init at ``param_dtype="bfloat16"``).  The hybrid family runs the same
checks in ``tests/test_torch_hybrid_bf16.py`` (its own file, so the suite's
workers share the two), through the helpers here:

* every leaf's dtype is the reference's: the stacked per-layer vectors are
  2-D, so the reference's cast stores them in bf16 too, and only the final
  norm (and the hybrid's unstacked shared norms) stays fp32;
* logits, ``lm_loss`` and every gradient at "xla", with fp32 and with bf16
  activations, and the prefill at "pallas" (the SSD scan's plain version on
  the CPU) against the reference's at "interpret" (its Pallas kernel in
  interpret mode);
* 6 decode steps from the reference's zero cache, and the port's
  ``ServeEngine`` against the reference's (bf16 ``conv_w`` meets the fp32
  conv window in decode: the reference's einsum promotes it);
* a 3-step GUM ``Trainer`` against the reference's, its block samples
  injected (``test_torch_bf16_train.check_trainer_case``, fp32 activations);
* here only: a resume from step 2 bitwise, and a bf16 checkpoint whose
  files have the reference's layout.

Tolerances.  At fp32 activations every fp32 result within 1e-4 relative
(atol 1e-4 of the largest entry: the SSD scan sums in another order); the
gradient of a bf16 leaf is an fp32 gradient rounded once on both sides (the
embedding's too: the port's gather sums its rows' gradients in fp32 before
rounding, as the reference's cast-then-gather does), so the two may part by
one bf16 step, 2^-7 of the element.  At bf16 activations the two
packages round at other places (the reference's XLA keeps fp32 between
fused bf16 ops, eager torch rounds after each), so the port is held by the
rule of ``tests/test_torch_bf16_train.py``: no farther, in relative
Frobenius distance, from the reference's bf16-stored result than that lies
from the reference's fp32-stored fp32 result of the same draws
(``test_torch_bf16_train._hold_to_reference``).
The rule holds the logits, the prefill, and the gradient as one vector of
all leaves.  A single leaf's distance is one draw of rounding noise of its
yardstick's size (0.65–1.10 of it on mamba2-370m, 0.82–1.15 on
zamba2-1.2b), so each leaf is held within twice its yardstick.  The loss of
bf16 logits is held through them: the port's ``lm_loss`` of the
reference's bf16 logits is the reference's loss within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, lm_loss
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import greedy_decode
from test_torch_bf16_train import _REF_DIRS, _port_trainer, check_trainer_case
from test_torch_hybrid import _flat, _fro, _leaves
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "mamba2-370m"
RTOL = 1e-4
SEQ, DECODE = 32, 6
ACTS = ("float32", "bfloat16")
BF16 = "bfloat16"


def _close(got: torch.Tensor, want, name="", rtol=RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _own_distance(got: torch.Tensor, want16, want32, name="", slack=1.0) -> None:
    """The bf16 rule: ``got`` no farther from the bf16-stored reference's
    result than that lies from the fp32-stored reference's (``slack`` times
    that for a single gradient leaf)."""
    d, yard = _fro(got.detach().float().numpy(), want16), _fro(want16, want32)
    assert 0 < yard < 0.1, (name, yard)
    assert d <= slack * yard, (name, d, yard)


def _as_one(tensors) -> np.ndarray:
    return np.concatenate([np.asarray(jnp.asarray(t, jnp.float32)).ravel() for t in tensors])


def reference_case(arch: str) -> dict:
    """The reference's bf16-stored SMOKE model from its init draws, and its
    results: per activation dtype the logits, loss and gradients at "xla" and
    the logits at "interpret"; the fp32-stored model of the same draws at fp32
    (the yardstick); 6 decode steps of 2 rows from its zero fp32 cache (the
    engine's) at fp32 activations."""
    jcfg = j_get_smoke(arch).replace(param_dtype=BF16)
    key = jax.random.PRNGKey(0)
    jparams = j_build_model(jcfg).init(key)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, SEQ)).astype(np.int32)
    steps = np.random.default_rng(1).integers(0, jcfg.vocab, (DECODE, 2, 1)).astype(np.int32)
    jt = jnp.asarray(tokens)

    def run(cfg, params, grads=True):
        jmodel = j_build_model(cfg)

        def jloss(p):
            logits, aux, _ = jmodel.forward(p, jt)
            return jmodel.loss(logits, jt, aux), logits

        if not grads:
            logits = jax.jit(lambda p: jmodel.forward(p, jt)[0])(params)
            return dict(logits=np.asarray(logits))
        (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        return dict(loss=np.asarray(jl), logits=np.asarray(jlogits), grads=_flat(jgrads))

    j32cfg = j_get_smoke(arch)
    out = dict(jparams=jparams, params=params_from_jax(jax.device_get(jparams)),
               tokens=tokens, steps=steps, fp32=run(j32cfg, j_build_model(j32cfg).init(key)))
    for act in ACTS:
        out[("xla", act)] = run(jcfg.replace(dtype=act), jparams)
        out[("pallas", act)] = run(jcfg.replace(dtype=act, attn_impl="interpret"), jparams,
                                   grads=False)
    jmodel = j_build_model(jcfg)
    jcache = jmodel.init_cache(batch=2, max_seq=16, dtype=jnp.float32)
    out["decode_start"] = cache_from_jax(jax.device_get(jcache))
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cache=c, tokens=t, pos=pos))
    out["decode_logits"] = []
    for i in range(DECODE):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(steps[i]), jnp.int32(i))
        out["decode_logits"].append(np.asarray(jlog))
    out["decode_cache"] = dict(_leaves(jax.device_get(jcache)))
    out["jmodel"] = jmodel
    return out


def port_model(arch: str, case: dict, **changes):
    model = build_model(get_smoke(arch).replace(param_dtype=BF16, **changes), device="cpu")
    model.load_params(case["params"])
    return model


def check_leaf_dtypes(arch: str, case: dict, fp32_leaves: set) -> None:
    """Every leaf's shape and dtype is the reference's, in its order; the fp32
    ones are exactly ``fp32_leaves``."""
    model = port_model(arch, case)
    ours = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in model.params().items()}
    theirs = {k: (v.shape, v.dtype.name) for k, v in _flat(case["jparams"]).items()}
    assert list(ours) == list(theirs)
    assert ours == theirs
    assert {k for k, (_, dtype) in ours.items() if dtype == "float32"} == fp32_leaves
    assert {"blocks/ln1/norm_scale", "blocks/mamba/a_log", "blocks/mamba/dt_bias",
            "blocks/mamba/conv_w", "embed/embed"} <= {
        k for k, (_, dtype) in ours.items() if dtype == BF16}


def check_forward_and_grads(arch: str, case: dict, act: str) -> None:
    """Logits, loss and every gradient at "xla" on bf16-stored parameters."""
    model, t = port_model(arch, case, dtype=act), torch.from_numpy(case["tokens"]).long()
    want = case[("xla", act)]
    logits = model(t)
    loss = lm_loss(logits, t)
    params = model.params()
    grads = torch.autograd.grad(loss, list(params.values()))
    assert logits.dtype == getattr(torch, act)
    if act == "bfloat16":
        _own_distance(logits, want["logits"], case["fp32"]["logits"], "logits")
    else:
        _close(logits, want["logits"], "logits")
        _close(loss, want["loss"], "loss")
    for (path, p), g in zip(params.items(), grads):
        assert g.dtype == p.dtype and str(g.dtype)[6:] == want["grads"][path].dtype.name, path
        if act == "bfloat16":
            _own_distance(g, want["grads"][path], case["fp32"]["grads"][path], path, slack=2)
        elif p.dtype == torch.float32:
            _close(g, want["grads"][path], path)
        else:
            _close(g, want["grads"][path], path, rtol=2.0 ** -7)
    if act == "bfloat16":
        paths = list(params)
        _own_distance(torch.from_numpy(_as_one(g.float() for g in grads)),
                      _as_one(want["grads"][k] for k in paths),
                      _as_one(case["fp32"]["grads"][k] for k in paths), "all gradients")
        j16 = torch.tensor(np.asarray(jnp.asarray(want["logits"], jnp.float32)))
        _close(lm_loss(j16.to(torch.bfloat16), t), want["loss"], "loss of the same logits",
               rtol=1e-5)


def check_kernel_route(arch: str, case: dict, act: str) -> None:
    """The prefill at "pallas" (no decode cache, as the reference's) against
    the reference's at "interpret"."""
    model = port_model(arch, case, dtype=act, attn_impl="pallas")
    logits, cache = make_prefill_step(model)({"tokens": torch.from_numpy(case["tokens"]).long()})
    assert cache is None and logits.dtype == getattr(torch, act)
    want = case[("pallas", act)]["logits"]
    if act == "bfloat16":
        _own_distance(logits, want, case["fp32"]["logits"], "prefill logits")
    else:
        _close(logits, want, "prefill logits")
        _close(logits, case[("xla", act)]["logits"], "prefill logits against xla")


def check_decode(arch: str, case: dict) -> None:
    """6 decode steps of 2 rows from the reference's zero cache: every
    step's logits and the final cache in the reference's layout."""
    model = port_model(arch, case)
    step = make_serve_step(model)
    cache = jax.tree_util.tree_map(torch.clone, case["decode_start"])
    for i in range(DECODE):
        logits, cache = step(cache, torch.from_numpy(case["steps"][i]).long(), i)
        _close(logits, case["decode_logits"][i], f"decode step {i}")
    for key, t in _leaves(cache):
        _close(t, case["decode_cache"][key], f"decode {key}")


def check_engine(arch: str, case: dict) -> None:
    """Three slots, three requests: the port's engine gives the reference
    engine's tokens, and each equals the port's direct decode."""
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4], [11, 3, 6, 2, 9, 1, 5]]
    jeng = JServeEngine(case["jmodel"], case["jparams"], slots=3, max_seq=32)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    model = port_model(arch, case)
    eng = ServeEngine(model, slots=3, max_seq=32)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == 3
    for req, jreq in zip(reqs, jreqs):
        assert req.output == jreq.output, (req.uid, req.output, jreq.output)
        assert greedy_decode(model, req.prompt, 6, 32) == req.output


@pytest.fixture(scope="module")
def case():
    return reference_case(ARCH)


def test_leaf_dtypes_are_the_references(case):
    check_leaf_dtypes(ARCH, case, {"final_norm/norm_scale"})
    with pytest.raises(NotImplementedError, match="item 2i"):
        build_model(get_smoke(ARCH).replace(param_dtype="float16"), device="cpu")


@pytest.mark.parametrize("act", ACTS)
def test_logits_loss_and_grads_at_xla(case, act):
    check_forward_and_grads(ARCH, case, act)


@pytest.mark.parametrize("act", ACTS)
def test_prefill_at_pallas_matches_interpret(case, act):
    check_kernel_route(ARCH, case, act)


def test_decode_steps_match(case):
    check_decode(ARCH, case)


def test_engine_matches_reference_engine(case):
    check_engine(ARCH, case)


def test_gum_trainer_on_bf16_storage(tmp_path_factory):
    check_trainer_case(tmp_path_factory, ARCH, "gum", "float32")


def test_resume_from_step_2_is_bitwise(tmp_path):
    """A bf16-stored GUM run saved at step 2 and resumed to step 4 ends
    bitwise where the uninterrupted 4-step run does (parameters and
    optimizer state)."""
    whole = _port_trainer(tmp_path / "whole", ARCH, "gum", "float32", steps=4)
    whole.train()
    _port_trainer(tmp_path / "split", ARCH, "gum", "float32", steps=2).train()
    second = _port_trainer(tmp_path / "split", ARCH, "gum", "float32", steps=4)
    assert second.train().resumed_from == 2
    a = dict(flatten_with_paths((whole.model.params(), whole.opt_state)))
    b = dict(flatten_with_paths((second.model.params(), second.opt_state)))
    assert list(a) == list(b)
    assert any(x.dtype == torch.bfloat16 for x in a.values() if isinstance(x, torch.Tensor))
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path
        else:
            assert x == b[path], path


def test_bf16_checkpoint_has_the_references_layout(tmp_path_factory):
    """The port's Trainer checkpoint at step 3 against the reference's
    (the runs of :func:`test_gum_trainer_on_bf16_storage`): the parameter
    leaves alike by id, path, shape, dtype and ``.npy`` header (a bf16 leaf
    as 2-byte words under ``'<V2'``); the optimizer state the same leaves by
    path and shape, every float one fp32 (the port orders the chain's
    states as it runs them and keeps its counters in int64)."""
    if ("port", ARCH, "gum", "float32") not in _REF_DIRS:  # this test alone
        check_trainer_case(tmp_path_factory, ARCH, "gum", "float32")
    params, state = {}, {}
    for who, root in (("port", _REF_DIRS[("port", ARCH, "gum", "float32")]),
                      ("ref", _REF_DIRS[(ARCH, "gum", BF16, "float32", 1)])):
        d = root / "step_000000003"
        leaves = json.loads((d / "manifest.json").read_text())["leaves"]
        params[who] = [({k: m[k] for k in ("id", "path", "shape", "dtype")},
                        (d / m["shards"][0]).read_bytes()[:128].split(b"}")[0])
                       for m in leaves if m["path"].startswith("0/")]
        state[who] = {m["path"]: (m["shape"], m["dtype"] if m["dtype"].startswith("float")
                                  else "int") for m in leaves if m["path"].startswith("1/")}
    assert params["port"] == params["ref"]
    assert {m["dtype"] for m, _ in params["port"]} == {BF16, "float32"}
    for m, head in params["port"]:
        assert (b"'<V2'" in head) == (m["dtype"] == BF16), m["path"]
    assert state["port"] == state["ref"]
    assert {dtype for _, dtype in state["port"].values()} == {"float32", "int"}
