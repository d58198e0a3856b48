"""Data parallelism over ``torch.distributed``: the port's mesh ``Trainer``,
its ZeRO-split family state and ``make_shardmap_train_step``, run by 2 and 4
local ranks over gloo (``repro_torch.launch.mesh.run_local_ranks``: a file
rendezvous under the test's temporary directory, one intra-op thread a
rank, a time limit on every spawn and join), and the training CLI under
``torchrun``.  llama-60m ``SMOKE``, GUM ``rank=4, gamma=1, period=3``
family-stacked, from the reference's initial parameters with the
reference's block draws injected.  The rank side is
``tests/torch_dist_workers.py``; two spawns run every scenario.

(a) ``Trainer(mesh=data 2)`` (fp32 reduction) against ``repro.train.Trainer``
    with no mesh: losses and GUM's leaves within 1e-5 relative (the fp32
    sums of the two ranks' means in another order), AdamW's leaves by
    Frobenius distance within 1e-4 (its first steps divide by |g|).
    At 2 ranks the mesh run is also bitwise one process at
    ``microbatches=2`` (the same fp32 sum of the same rows' gradients).
(b) ``shard_state`` on against off at 2 and 4 ranks: bitwise on the CPU
    (the same gradient, keys and per-row math; on the card Newton–Schulz's
    batched norm rounds a rank's rows otherwise than the whole stack, so
    ``chip_smoke.py`` phase 4i holds a tolerance there); each rank holds
    ``family_state_bytes(...)[1]`` bytes of family state (its slot
    projectors counted apart); every rank's parameters equal.
(c) ``make_shardmap_train_step`` at 2 ranks against the reference's on a
    2-device ``AxisType.Auto`` mesh (``tests/jax_shardmap_reference.py``, a
    JAX process of its own), AdamW and GUM, ``shard_state`` off and on,
    4 steps: both reduce each rank's gradient in bf16 with one rounding of
    the 2-term sum, so the two differ by the fp32 gradient's last bits
    flipping a bf16 rounding.  Losses within 1e-5 relative, parameters by
    Frobenius distance within 1e-5 (GUM) and 1e-4 (AdamW, as (a)).
(d) bitwise resume under ``shard_state``: 2 steps, a checkpoint, a second
    ``Trainer`` to 6 across the refresh at count 4 equals the uninterrupted
    run; ``restore(shardings=)`` with the state rule equals
    ``shard_family_state`` of the whole restore.
(e) the spectral rank policy under ``shard_state``: the same rank history
    and losses as the replicated run, and the same probes on every rank;
    telemetry's probes (the bias residual sampled every step) against the
    replicated run's, step by step.
(f) ``grad_nan@2`` at 2 ranks: both skip that step and stay equal.
(g) the collectives: a steady step makes one bf16 gradient all-reduce and
    one fp32 loss all-reduce, plus one fp32 update all-gather under
    ``shard_state``; a refresh adds only the probe all-reduce, and only
    when probes are on under ``shard_state``.
(h) ``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu
    --smoke --mesh data=2 --shard-state``: rank 0 alone prints and writes
    the checkpoints.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.data import DataConfig as JDataConfig
from repro.models import build_model as j_build_model
from repro.train import Trainer as JTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core.family_plan import build_family_plan
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.launch.mesh import run_local_ranks
from torch_threads import _one_thread  # noqa: F401  (autouse)
from torch_dist_workers import ARCH, GUM, STEPS

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SCENARIOS_2 = ["train:replicated", "train:shard", "resume", "spectral:replicated",
               "spectral:shard", "nan"] + [
    f"shardmap:{case}:{mode}" for case in ("adamw", "gum", "gum_probes")
    for mode in ("replicated", "shard")]
SCENARIOS_4 = ["train:replicated", "train:shard"]
SPAWN_TIMEOUT = 240


def jax_sampler(key, L, g_f):
    """The reference's block draw for ``key`` (``tests/test_torch_trainer.py``)."""
    seed, count, leaf = key
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), count), leaf)
    _, k_samp = jax.random.split(k)
    return np.asarray(jax.random.choice(k_samp, L, (g_f,), replace=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist")
    jcfg = j_get_smoke(ARCH)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(jparams)).items()}
    samples = {((0, count, i), jcfg.n_layers, GUM["gamma"]):
               jax_sampler((0, count, i), jcfg.n_layers, GUM["gamma"])
               for count in (1, 4) for i in range(len(params))}
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 4, 32))
    np.savez(base / "tokens.npz", tokens=tokens)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    reference = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "jax_shardmap_reference.py"),
         str(base / "reference.npz"), str(base / "tokens.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        out = {}
        for n, names in ((2, SCENARIOS_2), (4, SCENARIOS_4)):
            inputs = {"dir": str(base / f"n{n}"), "params": params, "samples": samples,
                      "tokens": tokens, "scenarios": names}
            out[n] = run_local_ranks("torch_dist_workers:scenarios", n, args=(inputs,),
                                     workdir=str(base / f"ranks{n}"), extra_path=[TESTS],
                                     timeout=SPAWN_TIMEOUT)
        # (a)'s reference: the JAX package's Trainer with no mesh, in process
        jtrainer = JTrainer(
            j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **GUM),
            JRunConfig(steps=STEPS, ckpt_dir=str(base / "jax"), ckpt_every=0, log_every=0,
                       resume=False, seed=0),
            JDataConfig(vocab=jcfg.vocab, seq_len=64, global_batch=4, seed=0))
        out["jax_losses"] = jtrainer.train().losses
        (jp, _), _ = jtrainer.ckpt.restore(STEPS, jtrainer.init_state())
        out["jax_params"] = {k: v.numpy() for k, v in params_from_jax(
            jax.device_get(jp)).items()}
        log, _ = reference.communicate(timeout=SPAWN_TIMEOUT)
        assert reference.returncode == 0, log.decode()[-4000:]
        out["jax_steps"] = dict(np.load(base / "reference.npz"))
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()
    return out


def result(runs, n: int, name: str, rank: int = 0) -> dict:
    got = runs[n][rank][name]
    assert "error" not in got, got.get("error")
    return got


def rel_max(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def params_close(got: dict, want: dict, lowrank_tol: float, adamw_tol: float) -> None:
    for k, w in want.items():
        g = got[k]
        if default_lowrank_filter(k, torch.from_numpy(w)):
            assert rel_max(g, w) <= lowrank_tol, (k, rel_max(g, w))
        else:
            assert rel_fro(g, w) <= adamw_tol, (k, rel_fro(g, w))


def params_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", ["replicated", "shard"])
def test_mesh_trainer_tracks_reference(runs, mode):
    got = result(runs, 2, f"train:{mode}")
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], runs["jax_losses"], rtol=1e-5, atol=0)
    params_close(got["params"], runs["jax_params"], 1e-5, 1e-4)


def test_mesh_trainer_is_the_microbatched_run(runs, tmp_path):
    """2 ranks sum their rows' gradients in fp32 and halve the sum, as one
    process at ``microbatches=2`` does with the same rows: bitwise (a sum
    of two terms is the same either way round; 4 ranks add in gloo's ring
    order, not the accumulator's)."""
    n = 2
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    from torch_dist_workers import table_sampler

    cfg = get_smoke(ARCH)
    jcfg = j_get_smoke(ARCH)
    samples = {((0, count, i), jcfg.n_layers, GUM["gamma"]):
               jax_sampler((0, count, i), jcfg.n_layers, GUM["gamma"])
               for count in (1, 4) for i in range(len(runs["jax_params"]))}
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    trainer = Trainer(build_model(cfg, device="cpu"), OptimizerConfig(**GUM),
                      RunConfig(steps=STEPS, log_every=0, seed=0, ckpt_dir=str(tmp_path)),
                      DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0),
                      device="cpu", microbatches=n,
                      optimizer=build_optimizer(OptimizerConfig(**GUM),
                                                sampler=table_sampler(samples)),
                      params=params_from_jax(jax.device_get(jparams)))
    losses = trainer.train().losses
    got = result(runs, n, "train:replicated")
    assert got["losses"] == losses
    assert params_equal(got["params"], {k: p.detach().numpy()
                                        for k, p in trainer.model.params().items()})


@pytest.mark.parametrize("n", [2, 4])
def test_shard_state_is_bitwise_and_splits_the_bytes(runs, n):
    for rank in range(n):
        on, off = result(runs, n, "train:shard", rank), result(runs, n, "train:replicated", rank)
        assert on["losses"] == off["losses"]
        assert params_equal(on["params"], off["params"])
        assert params_equal(on["params"], result(runs, n, "train:shard", 0)["params"])
        b = on["bytes"]
        assert b["held"] == b["rule"] < b["whole"], b
        assert off["bytes"]["held"] == off["bytes"]["whole"]
        assert off["bytes"]["slot_projs"] == 0
    # 2 ranks: the one-member family's stack (2) splits, its one slot does not,
    # so a rank keeps the projectors of blocks of the other's rows
    assert result(runs, 2, "train:shard")["bytes"]["slot_projs"] > 0


@pytest.mark.parametrize("case", ["adamw", "gum"])
@pytest.mark.parametrize("mode", ["replicated", "shard"])
def test_shardmap_step_tracks_reference(runs, case, mode):
    got = result(runs, 2, f"shardmap:{case}:{mode}")
    ref = runs["jax_steps"]
    prefix = f"{case}_{mode}"
    np.testing.assert_allclose(got["losses"], ref[f"{prefix}/losses"], rtol=1e-5, atol=0)
    tol = 1e-4 if case == "adamw" else 1e-5
    for k, p in got["params"].items():
        want = ref[f"{prefix}/{k}"]
        assert rel_fro(p, want) <= (1e-4 if not default_lowrank_filter(
            k, torch.from_numpy(p)) else tol), (k, rel_fro(p, want))
    other = result(runs, 2, f"shardmap:{case}:{'shard' if mode == 'replicated' else 'replicated'}")
    assert got["losses"] == other["losses"] and params_equal(got["params"], other["params"])
    assert got["info"] == {"reduce_dtype": "torch.bfloat16", "data_axis": "data",
                           "n_shards": "2", "grad_clip": "0.0",
                           "shard_state": str(mode == "shard")}


def test_sharded_resume_is_bitwise(runs):
    got = result(runs, 2, "resume")
    whole = result(runs, 2, "train:shard")
    assert got["resumed_from"] == 2
    assert got["first"] + got["second"] == whole["losses"]
    assert params_equal(got["params"], whole["params"])
    assert got["restore_shardings_equal"]
    # llama-60m SMOKE's family stacks (8, 4, 2) each keep half their rows
    assert sorted(s[0] for s in got["restore_shapes"].values()) == [1, 2, 4]


def test_spectral_policy_under_shard_state(runs):
    on, off = result(runs, 2, "spectral:shard"), result(runs, 2, "spectral:replicated")
    assert len(off["history"]) > 1, off["history"]  # the policy migrated
    assert on["history"] == off["history"]
    assert on["losses"] == off["losses"]
    assert params_equal(on["params"], off["params"])
    other = result(runs, 2, "spectral:shard", rank=1)
    for a, b in zip(on["probes"], other["probes"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_grad_nan_skips_on_every_rank(runs):
    ranks = [result(runs, 2, "nan", r) for r in range(2)]
    for r in ranks:
        assert r["skipped"] == 1 and len(r["losses"]) == 3
        assert r["recoveries"].get("skip") == 1
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert params_equal(ranks[0]["params"], ranks[1]["params"])


def update_gather_bytes(n: int) -> int:
    """One rank's update all-gather operand: each split family's fp32 rows,
    and the slots of a family whose members do not divide the ranks (a
    slot's block may then lie in another rank's rows)."""
    from repro_torch.models import build_model
    from repro_torch.configs import get_smoke

    params = build_model(get_smoke(ARCH), device="meta").params()
    leaves = [p if default_lowrank_filter(k, p) else None for k, p in params.items()]
    total = 0
    for fam in build_family_plan(leaves, GUM["rank"]).families:
        L, m, nn = fam.fs.L, fam.fs.m, fam.fs.n
        slots = fam.seg.members * min(GUM["gamma"], fam.seg.member_L)
        if L % n == 0:
            total += L // n * m * nn * 4
            if fam.seg.members % n and slots % n == 0:
                total += slots // n * m * nn * 4
        elif slots % n == 0:
            total += slots // n * m * nn * 4
    return total


@pytest.mark.parametrize("case", ["adamw", "gum", "gum_probes"])
@pytest.mark.parametrize("mode", ["replicated", "shard"])
def test_collectives_per_step(runs, case, mode):
    got = result(runs, 2, f"shardmap:{case}:{mode}")
    for step, (counts, log) in enumerate(zip(got["counts"], got["logs"])):
        want = {"all_reduce:grad": 1, "all_reduce:loss": 1}
        if mode == "shard" and case != "adamw":
            want["all_gather:update"] = 1
        if case == "gum_probes" and mode == "shard" and step % GUM["period"] == 0:
            want["all_reduce:probes"] = 1  # the split families' probe sums
        assert counts == want, (step, counts)
        kinds = {f"{e['op']}:{e['tag']}": e for e in log}
        assert kinds["all_reduce:grad"]["dtype"] == "bfloat16"
        assert kinds["all_reduce:loss"]["dtype"] == "float32"
        if "all_gather:update" in kinds:
            assert kinds["all_gather:update"]["dtype"] == "float32"
            # with telemetry, the bias site's sum over this rank's blocks
            # (every family splits at 2 ranks) rides the gather: one fp32
            bias = 4 if case == "gum_probes" else 0
            assert kinds["all_gather:update"]["bytes"] == update_gather_bytes(2) + bias


def test_sharded_probes_track_the_replicated_run(runs):
    """Telemetry's probes under ``shard_state`` against the replicated run,
    after each of the 4 steps: the bias residual is sampled every step,
    round-robin over the families, as without sharding (a split site's sum
    over each rank's blocks rides the update all-gather); ``g2``, ``mn``
    and ``bias_step`` equal; the sums over blocks (``bias``, ``drift``,
    ``sv2``), added per rank and then across the ranks, within 1e-6
    relative (``bias`` and ``drift`` 1e-7 absolute: 1 minus a ratio).
    Both ranks read the same probes."""
    on = result(runs, 2, "shardmap:gum_probes:shard")
    off = result(runs, 2, "shardmap:gum_probes:replicated")
    assert len(on["probes"]) == len(off["probes"]) == 4
    for step, (got, want) in enumerate(zip(on["probes"], off["probes"])):
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in ("g2", "mn", "bias_step"):
                assert np.array_equal(a[key], b[key]), (step, key, a[key], b[key])
            for key in ("bias", "drift"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-7)
            np.testing.assert_allclose(a["sv2"], b["sv2"], rtol=1e-6, atol=0)
        # this step's sample landed on family (step % 3)
        assert [int(p["bias_step"]) for p in got][step % 3] == step + 1
    other = result(runs, 2, "shardmap:gum_probes:shard", rank=1)["probes"]
    for got, theirs in zip(on["probes"], other):
        for a, b in zip(got, theirs):
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", ARCH, "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
           "--rank", "4", "--gamma", "1", "--period", "3", "--ckpt-dir", str(tmp_path),
           "--mesh", "data=2", "--shard-state"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    done = [line for line in out.stdout.splitlines() if line.startswith("done: step=4")]
    assert len(done) == 1, out.stdout  # rank 0 alone prints
    # a checkpoint every step, the newest 3 kept
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003",
                                            "step_000000004"]
