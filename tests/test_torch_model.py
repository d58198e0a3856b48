"""The port's dense decoder against the JAX package's, on llama-60m SMOKE
with the reference's own initial parameters (carried across with
``params_from_jax``): logits, loss and every parameter gradient agree within
rtol 1e-4 (atol 1e-4 of each tensor's largest entry: fp32 sums in another
order through two layers and a softmax)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import build_model, lm_loss
from torch_threads import _one_thread  # noqa: F401  (autouse)


RTOL = 1e-4


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke("llama-60m")
    jmodel = j_build_model(j_get_smoke("llama-60m"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    model = build_model(cfg, device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return cfg, jmodel, jparams, model, tokens


def test_param_paths_and_shapes_match(setup):
    cfg, _, jparams, model, _ = setup
    ours = {k: tuple(v.shape) for k, v in model.params().items()}
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    theirs = {"/".join(str(k.key) for k in kp): tuple(v.shape) for kp, v in flat}
    assert list(ours) == list(theirs)  # same leaf order as jax.tree_util
    assert ours == theirs
    round_trip = params_to_numpy(model.params())
    np.testing.assert_array_equal(round_trip["blocks"]["attn"]["wq"],
                                  np.asarray(jparams["blocks"]["attn"]["wq"]))


def test_logits_loss_and_grads_match(setup):
    _, jmodel, jparams, model, tokens = setup
    _check_logits_loss_and_grads(jmodel, jparams, model, tokens)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_logits_loss_and_grads_match_with_remat(setup, policy):
    """Both sides rematerialise each layer (jax.checkpoint against
    torch.utils.checkpoint) and still agree as without it."""
    cfg, _, jparams, _, tokens = setup
    jmodel = j_build_model(j_get_smoke("llama-60m").replace(remat=True, remat_policy=policy))
    model = build_model(cfg.replace(remat=True, remat_policy=policy), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    _check_logits_loss_and_grads(jmodel, jparams, model, tokens)


def _check_logits_loss_and_grads(jmodel, jparams, model, tokens):
    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jax.numpy.asarray(tokens))
        return jmodel.loss(logits, jax.numpy.asarray(tokens), aux), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    t = torch.from_numpy(tokens).long()
    logits = model(t)
    loss = lm_loss(logits, t)
    _close(logits, jlogits, "logits")
    _close(loss, jl, "loss")
    params = model.params()
    grads = torch.autograd.grad(loss, list(params.values()))
    flat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    jflat = {"/".join(str(k.key) for k in kp): v for kp, v in flat.items()}
    for (path, _), g in zip(params.items(), grads):
        _close(g, jflat[path], path)


def test_registry_holds_every_reference_arch():
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS

    assert set(ARCHS) == set(J_ARCHS)


@pytest.mark.parametrize("arch", ["llama-60m", "chatglm3-6b", "qwen1.5-4b", "starcoder2-7b",
                                  "nemotron-4-340b", "mamba2-370m", "zamba2-1.2b",
                                  "dbrx-132b", "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_every_family_builds_the_reference_tree(arch):
    """``build_model`` builds each arch's SMOKE config (every family) on the
    CPU with the reference's paths, shapes and dtypes in its leaf order
    (the reference's tree from ``jax.eval_shape``: nothing is drawn), and
    ``init_params`` gives finite values."""
    jtree = jax.eval_shape(j_build_model(j_get_smoke(arch)).init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in kp): (tuple(v.shape), str(v.dtype)) for kp, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    model = build_model(get_smoke(arch), device="cpu")
    got = {k: (tuple(p.shape), str(p.dtype)[6:]) for k, p in model.params().items()}
    assert list(got) == list(want)
    assert got == want
    model.init_params(0)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
