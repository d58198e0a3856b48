"""Exact resume in the port's ``Trainer``.

A run of 2N steps and a run of N steps, then N more in a new ``Trainer``
resuming from the same checkpoint directory, must agree **bitwise**:
losses, parameters and every leaf of the optimizer state (Python-int
counters included).  N = 3 at period 3, so the resumed run starts on a
refresh step (count 4).  Held for GUM per leaf and family-stacked, GaLore
family-stacked with the fused epilogue, LISA and unbiased GaLore-Adam on
the llama-60m SMOKE recipe.

Against the JAX package (ROADMAP queue 3, item 3): the same ``RunConfig``
trained twice — first stopped at step 3, then run to its end — resumes at
the same step in both packages, with losses within rel 1e-4 (the rtol of
``tests/test_torch_trainer.py``), from the reference's initial parameters
and with its sampled blocks injected.  And a corrupt newest checkpoint
makes resume fall back to the previous verified one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.data import DataConfig as JDataConfig
from repro.models import build_model as j_build_model
from repro.resilience.inject import bitflip_checkpoint
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.data import DataConfig
from repro_torch.models import build_model
from repro_torch.train import Trainer
from repro_torch.train.trainer import StepTimeMonitor
from test_torch_trainer import jax_sampler
from torch_threads import _one_thread  # noqa: F401  (autouse)


N = 3
CFG = get_smoke("llama-60m")
DATA = dict(vocab=CFG.vocab, seq_len=64, global_batch=2, seed=0)
OPTS = {
    "gum": dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3),
    "gum fused": dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3, fuse_families=True),
    "galore fused epilogue": dict(name="galore", lr=1e-2, rank=4, period=3,
                                  weight_decay=0.01, fuse_families=True,
                                  fused_epilogue=True),
    "lisa": dict(name="lisa", lr=1e-3, gamma=1, period=3),
    "unbiased_galore_adam": dict(name="unbiased_galore_adam", lr=1e-2, rank=4, gamma=1,
                                 period=3),
}


def _trainer(ckpt_dir, steps: int, opt: dict, **run) -> Trainer:
    return Trainer(build_model(CFG, device="cpu"), OptimizerConfig(**opt),
                   RunConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=N, log_every=0,
                             seed=0, **run),
                   DataConfig(**DATA), device="cpu")


def _assert_bitwise(a: Trainer, b: Trainer) -> None:
    pa, pb = a.model.params(), b.model.params()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    fa, fb = flatten_with_paths(a.opt_state), flatten_with_paths(b.opt_state)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), path
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, path


@pytest.mark.parametrize("label", list(OPTS))
def test_resumed_run_equals_the_uninterrupted_one_bitwise(tmp_path, label):
    full = _trainer(tmp_path / "full", 2 * N, OPTS[label])
    full_result = full.train()
    first = _trainer(tmp_path / "split", N, OPTS[label]).train()
    resumed = _trainer(tmp_path / "split", 2 * N, OPTS[label])
    result = resumed.train()
    assert first.resumed_from is None and result.resumed_from == N
    assert first.losses + result.losses == full_result.losses
    assert len(result.losses) == N and len(result.step_seconds) == N
    _assert_bitwise(full, resumed)


def test_resume_false_starts_afresh(tmp_path):
    a = _trainer(tmp_path, N, OPTS["gum"]).train()
    b = _trainer(tmp_path, N, OPTS["gum"], resume=False).train()
    assert b.resumed_from is None and b.losses == a.losses


def test_corrupt_newest_checkpoint_falls_back_to_the_verified_one(tmp_path, capsys):
    """Steps 3 and 6 committed, step 6 corrupted: a 9-step run resumes from
    3 (saying so) and reproduces the uninterrupted run's steps 3..8."""
    _trainer(tmp_path / "run", 2 * N, OPTS["gum"]).train()
    bitflip_checkpoint(str(tmp_path / "run"), 2 * N, rng=np.random.default_rng(0),
                       leaves=("projs",))
    result = _trainer(tmp_path / "run", 3 * N, OPTS["gum"]).train()
    assert result.resumed_from == N
    assert f"newest committed step {2 * N} failed verification" in capsys.readouterr().out
    want = _trainer(tmp_path / "full", 3 * N, OPTS["gum"]).train().losses
    assert result.losses == want[N:]


def test_periodic_and_final_saves(tmp_path):
    trainer = _trainer(tmp_path, 4, OPTS["gum"])
    trainer.train()
    assert trainer.ckpt.all_steps() == [3, 4]  # every 3 steps, and the end
    _trainer(tmp_path / "b", 6, OPTS["gum"]).train()
    assert _trainer(tmp_path / "b", 6, OPTS["gum"]).ckpt.all_steps() == [3, 6]


def test_step_time_monitor_flags_a_straggler():
    mon = StepTimeMonitor(window=20, z=3.0, min_samples=10)
    for step in range(12):
        assert not mon.record(step, 1.0 + 0.01 * (step % 3))
    assert mon.record(12, 5.0)
    assert mon.flagged == [(12, 5.0)]


def test_a_second_run_of_one_config_resumes_where_the_reference_does(tmp_path):
    """ROADMAP queue 3, item 3: both packages, one ``RunConfig`` (default
    checkpoint cadence, resume on): stopped at step 3, then run again to
    its 6 steps.  The second run resumes from 3 in both, with losses
    within rel 1e-4; a third resumes at the end and trains nothing."""
    opt = OPTS["gum"]
    jcfg = j_get_smoke("llama-60m")
    jrun = JRunConfig(steps=2 * N, ckpt_dir=str(tmp_path / "jax"), log_every=0, seed=0)

    def jtrainer():
        return JTrainer(j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
                        jrun, JDataConfig(**DATA))

    jparams = params_from_jax(jax.device_get(
        j_build_model(jcfg).init(jax.random.PRNGKey(0))))  # the trainer's init
    run = RunConfig(steps=2 * N, ckpt_dir=str(tmp_path / "torch"), log_every=0, seed=0)

    def trainer():
        return Trainer(build_model(CFG, device="cpu"), OptimizerConfig(**opt), run,
                       DataConfig(**DATA), device="cpu",
                       optimizer=build_optimizer(OptimizerConfig(**opt), sampler=jax_sampler),
                       params=jparams)

    j_first, first = jtrainer().train(steps=N), trainer().train(steps=N)
    j_second, second = jtrainer().train(), trainer().train()
    j_third, third = jtrainer().train(), trainer().train()
    assert (j_first.resumed_from, j_second.resumed_from, j_third.resumed_from) == \
        (first.resumed_from, second.resumed_from, third.resumed_from) == (None, N, 2 * N)
    np.testing.assert_allclose(first.losses + second.losses,
                               j_first.losses + j_second.losses, rtol=1e-4, atol=0)
    assert len(second.losses) == N and third.losses == j_third.losses == []
