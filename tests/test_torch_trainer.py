"""The slice as a whole: the port's ``Trainer`` against the JAX package's on
the llama-60m smoke recipe (GUM ``rank=4, gamma=1, period=3``, 6 steps,
``seq_len=64``, ``global_batch=2``), from the reference's own initial
parameters, with the reference's sampled blocks injected.

The injected sampler reproduces the reference's draw from the same key
material: ``jax.random.choice`` on the sampling half of
``fold_in(fold_in(PRNGKey(seed), count), leaf)``, exactly as
``repro.core.combinators.lowrank`` / ``layerwise_unbias`` derive it.
Losses must agree within rel 1e-4 (fp32 sums in another order, compounded
over 6 optimizer steps), and the data stream must be byte-identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro.models import build_model as j_build_model
from repro.train import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.models import build_model
from repro_torch.train import Trainer
from torch_threads import _one_thread  # noqa: F401  (autouse)


OPT = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3)
STEPS = 6


def jax_sampler(key, L, g_f):
    seed, count, leaf = key
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), count), leaf)
    _, k_samp = jax.random.split(k)
    return torch.from_numpy(np.asarray(
        jax.random.choice(k_samp, L, (g_f,), replace=False)).astype(np.int64))


def test_data_stream_is_byte_identical():
    for cfg in (DataConfig(vocab=256, seq_len=64, global_batch=2, seed=0),
                DataConfig(vocab=32000, seq_len=300, global_batch=3, seed=7)):
        ours, theirs = SyntheticLMStream(cfg), JStream(JDataConfig(**vars(cfg)))
        for step in (0, 1, 5):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_trainer_tracks_reference_losses(tmp_path):
    jcfg = j_get_smoke("llama-60m")
    data = dict(vocab=jcfg.vocab, seq_len=64, global_batch=2, seed=0)
    jtrainer = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **OPT),
        JRunConfig(steps=STEPS, ckpt_dir=str(tmp_path), ckpt_every=100, log_every=0,
                   resume=False, seed=0),
        JDataConfig(**data))
    jlosses = jtrainer.train().losses

    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))  # the trainer's init
    trainer = Trainer(
        build_model(get_smoke("llama-60m"), device="cpu"), OptimizerConfig(**OPT),
        RunConfig(steps=STEPS, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0),
        DataConfig(**data),
        device="cpu",
        optimizer=build_optimizer(OptimizerConfig(**OPT), sampler=jax_sampler),
        params=params_from_jax(jax.device_get(jparams)))
    result = trainer.train()
    assert len(result.losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(result.losses, jlosses, rtol=1e-4, atol=0)
    assert result.skipped_nonfinite == 0


def test_sampler_reproduces_reference_state():
    """The injected sampler equals the slot indices the reference stores."""
    from repro.core import build_optimizer as j_build_optimizer

    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    jopt = j_build_optimizer(JOptimizerConfig(kernel_impl="jnp", **OPT))
    _, state = jax.jit(jopt.update)(jparams, jopt.init(jparams), jparams)
    idx = state.inner["gum"][0].inner.idx
    paths = list(params_from_jax(jax.device_get(jparams)))
    for i, path in enumerate(paths):
        node = idx
        for part in path.split("/"):
            node = None if node is None else node[part]
        if node is not None:
            assert np.array_equal(np.asarray(node), jax_sampler((0, 1, i), 2, 1).numpy())
