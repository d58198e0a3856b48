"""Training through the port's ssm family (mamba2-370m) against the JAX
package's, at its SMOKE config, with the reference's own initial parameters
(``params_from_jax``):

* logits, ``lm_loss`` and every parameter gradient at "xla" (the plain SSD,
  ``ref.ssd_chunked_ref``), and the chunked loss (``logit_chunk=5``) and its
  gradients;
* at the kernel route ("pallas": the SSD scan's plain version on the CPU)
  the logits and the loss against the reference's at "interpret" (its
  Pallas kernel in interpret mode).  The SSD kernel is forward-only in both
  packages, so a gradient at this route raises in the port, and training
  runs at "xla";
* a 3-step GUM ``Trainer`` run against the reference's, its sampled blocks
  injected: losses, and every parameter afterwards.

Tolerance: 1e-4 relative, with atol 1e-4 of each tensor's largest entry
(the SSD scan sums through cumulative sums and exponentials in another
order); the trainer's losses 1e-4, parameters 1e-5
(``test_torch_hybrid._params_match``).
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
from repro.models import build_model as j_build_model
from repro.models.transformer import chunked_lm_loss as j_chunked_lm_loss
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.data import DataConfig
from repro_torch.launch import steps
from repro_torch.models import build_model, lm_loss
from repro_torch.train import Trainer
from test_torch_hybrid import _close, _flat, _params_match
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)

ARCH = "mamba2-370m"
SEQ = 32


@pytest.fixture(scope="module")
def case():
    jcfg = j_get_smoke(ARCH)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, SEQ)).astype(np.int32)
    jt = jnp.asarray(tokens)

    def jloss(p):
        logits, aux, _ = jmodel.forward(p, jt)
        return jmodel.loss(logits, jt, aux), logits

    def jchunked(p):
        hidden, aux, _ = jmodel.forward(p, jt, return_hidden=True)
        return j_chunked_lm_loss(p, jcfg.replace(logit_chunk=5), hidden, jt, aux)

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jcl, jcgrads = jax.jit(jax.value_and_grad(jchunked))(jparams)
    jkernel = j_build_model(jcfg.replace(attn_impl="interpret"))
    jklogits, jkaux, _ = jax.jit(jkernel.forward)(jparams, jt)
    return dict(params=params, tokens=tokens, loss=np.asarray(jl), logits=np.asarray(jlogits),
                grads=_flat(jgrads), chunked_loss=np.asarray(jcl),
                chunked_grads=_flat(jcgrads), kernel_logits=np.asarray(jklogits),
                kernel_loss=np.asarray(jkernel.loss(jklogits, jt, jkaux)))


def _model(case, **changes):
    model = build_model(get_smoke(ARCH).replace(**changes), device="cpu")
    model.load_params(case["params"])
    return model


def test_logits_loss_and_grads_match_at_xla(case):
    model, t = _model(case), torch.from_numpy(case["tokens"]).long()
    logits = model(t)
    loss = lm_loss(logits, t)
    _close(logits, case["logits"], "logits")
    _close(loss, case["loss"], "loss")
    params = model.params()
    grads = torch.autograd.grad(loss, list(params.values()))
    assert len(grads) == len(case["grads"])
    for (path, _), g in zip(params.items(), grads):
        _close(g, case["grads"][path], path)


def test_chunked_loss_and_grads_match(case):
    model = _model(case, logit_chunk=5)
    loss = steps._loss_from_batch(model, {"tokens": torch.from_numpy(case["tokens"]).long()})
    _close(loss, case["chunked_loss"], "chunked loss")
    params = model.params()
    for (path, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        _close(g, case["chunked_grads"][path], f"chunked {path}")


def test_kernel_route_logits_and_loss_match(case):
    """At "pallas" the port's logits and loss against the reference's at
    "interpret"; a gradient through the forward-only scan raises."""
    model, t = _model(case, attn_impl="pallas"), torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        logits = model(t)
    _close(logits, case["kernel_logits"], "kernel-route logits")
    _close(lm_loss(logits, t), case["kernel_loss"], "kernel-route loss")
    _close(logits, case["logits"], "kernel-route logits vs xla")
    with pytest.raises(NotImplementedError, match="forward-only"):
        model(t)


def test_gum_trainer_tracks_reference(tmp_path):
    """3 GUM steps (rank 4, gamma 1, period 2: refreshes on steps 1 and 3)
    from the reference's initial parameters, its block samples injected:
    losses within 1e-4, parameters within 1e-5."""
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
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    trainer = Trainer(
        build_model(get_smoke(ARCH), device="cpu"), OptimizerConfig(**opt),
        RunConfig(steps=3, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data), device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler),
        params=params_from_jax(jax.device_get(jparams)))
    result = trainer.train()
    assert len(result.losses) == len(jlosses) == 3
    np.testing.assert_allclose(result.losses, jlosses, rtol=1e-4, atol=0)
    assert result.skipped_nonfinite == 0
    _params_match(trainer.model.params(), params_from_jax(jax.device_get(jp)))
