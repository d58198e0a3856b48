"""The data-parallel paths that a mesh used to refuse, run by 2 and 4 local
gloo ranks (``repro_torch.launch.mesh.run_local_ranks``; the rank side is
``tests/torch_dist_workers.py``), on llama-60m ``SMOKE`` from the
reference's initial parameters (its bf16-stored init for bf16 runs) with
the reference's block draws injected.  One 2-rank and one 4-rank spawn run
every scenario; the runs take 3 steps at period 2 (refreshes at steps 1
and 3).

(a) ``Trainer(mesh=data 2)`` over bf16-stored parameters, GUM: bitwise the
    port's one-process bf16 run at ``microbatches=2`` (each rank's bf16
    gradient cast to fp32 and the two casts summed, as the accumulator
    adds them), and against ``repro.train.Trainer`` on bf16 storage with
    no mesh within the bf16 precision rule of ``tests/test_torch_bf16_train.py``
    (the losses and every leaf no farther from the reference's bf16-stored
    run than that run lies from its fp32-stored one of the same draws).
(b) ``shard_state`` on against off, bitwise at 2 and 4 ranks, for bf16
    GUM, fp32 and bf16 Fira, and GaLore with ``fused_epilogue`` and weight
    decay 0.01 (fp32 and bf16 W); every rank's parameters equal; each rank
    holds ``family_state_bytes(...)[1]`` bytes of family state.
(c) a bitwise resume across the refresh at step 3 under ``shard_state`` on
    bf16 storage.
(d) ``make_shardmap_train_step`` (bf16 reduction) on bf16 storage at 2
    ranks, GUM, ``shard_state`` off and on, against the reference's
    shard_map step on a 2-device ``AxisType.Auto`` mesh at
    ``param_dtype="bfloat16"`` (``tests/jax_shardmap_reference.py``): the
    same rule, with the reference's fp32-stored step as the yardstick; its
    bf16 gradient all-reduce is RA601's declared ``reduce_dtype``.
(e) the projected-space accumulator at 2 ranks x 2 microbatches against the
    port's one-process run at 4 microbatches of the same global batch, and
    against the reference's ``make_train_step(lowrank_accum=
    gum_accum_tools(...), microbatches=4)`` jitted on one CPU device:
    losses within 1e-6 relative, each parameter leaf within 1e-5 relative
    Frobenius distance (the ranks' partial sums add in another order; the
    leaves AdamW trains 1e-4 against the reference, as
    ``tests/test_torch_distributed.py`` (a) holds them).
(f) each new path's collectives, step by step, against
    ``analysis/collectives.py``'s model: no finding from
    ``collective_schedule_findings``, exactly one update all-gather a step
    under ``shard_state``, and the accumulator's compact all-reduce (and
    rank 0's refresh broadcast) at the model's bytes; ``audit_sharded`` of
    Fira and of the fused epilogue under ``shard_state`` is clean.
(g) what is still refused: the accumulator under ``shard_state`` raises
    ``NotImplementedError`` naming ROADMAP queue 1 item 5i.
(h) the training CLI under ``torchrun``: ``--opt galore --fused-epilogue
    --shard-state --mesh data=2``, rank 0 alone printing.
"""
import os
import subprocess
import sys

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
from repro.train import Trainer as JTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.launch.mesh import run_local_ranks
from test_torch_bf16_train import _hold_to_reference, _ref_params
from test_torch_distributed import jax_sampler, params_equal, rel_fro, result
from torch_threads import _one_thread  # noqa: F401  (autouse)
from torch_dist_workers import (
    ACCUM,
    ACCUM_LR,
    ARCH,
    GUM,
    PATH_OPTS,
    PATH_STEPS,
    accum_run,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PATH_CASES = [("gum", "bf16"), ("fira", "fp32"), ("fira", "bf16"), ("galore_epi", "fp32"),
              ("galore_epi", "bf16")]
PATHS = [f"path:{opt}:{dtype}:{mode}" for opt, dtype in PATH_CASES
         for mode in ("replicated", "shard")]
SCENARIOS = {2: PATHS + ["bf16_resume", "shardmap_bf16:replicated", "shardmap_bf16:shard",
                         "accum:2"],
             4: PATHS}
SPAWN_TIMEOUT = 240
ACCUM_LOSS_TOL = 1e-6
ACCUM_PARAM_TOL = 1e-5
ADAMW_TOL = 1e-4


def _draws(n_leaves: int, L: int) -> dict:
    """The reference's block draws of every key a run here reaches."""
    return {((0, count, i), L, GUM["gamma"]): jax_sampler((0, count, i), L, GUM["gamma"])
            for count in (1, 3, 4) for i in range(n_leaves)}


def _jax_init(param_dtype: str) -> dict:
    jcfg = j_get_smoke(ARCH).replace(param_dtype=param_dtype)
    return params_from_jax(jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(0))))


def _jax_trainer(tmp, param_dtype: str):
    """``repro.train.Trainer`` of ``PATH_OPTS["gum"]`` with no mesh, the same
    batches as the mesh runs: ``(losses, final parameters as float64,
    None)``, the tuple ``_hold_to_reference`` reads."""
    jcfg = j_get_smoke(ARCH).replace(param_dtype=param_dtype)
    losses = JTrainer(
        j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **PATH_OPTS["gum"]),
        JRunConfig(steps=PATH_STEPS, ckpt_dir=str(tmp), ckpt_every=0, log_every=0,
                   resume=False, seed=0),
        JDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=0)).train().losses
    return np.array(losses), _ref_params(tmp, PATH_STEPS), None


def _jax_accum(tokens: np.ndarray) -> tuple[list, dict]:
    """The reference's jitted accumulator step at 4 microbatches."""
    from repro.core.gum import gum_accum_tools as j_gum_accum_tools
    from repro.launch.steps import make_train_step as j_make_train_step

    jmodel = j_build_model(j_get_smoke(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tools = j_gum_accum_tools(ACCUM_LR, kernel_impl="jnp", **ACCUM)
    step = jax.jit(j_make_train_step(jmodel, tools.transform, microbatches=4,
                                     lowrank_accum=tools))
    state, losses = tools.transform.init(jparams), []
    for t in tokens:
        jparams, state, metrics = step(jparams, state, {"tokens": jnp.asarray(t)})
        losses.append(float(metrics["loss"]))
    return losses, {k: v.numpy() for k, v in params_from_jax(jax.device_get(jparams)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_paths")
    params = {"fp32": _jax_init("float32"), "bf16": _jax_init("bfloat16")}
    tokens = np.random.default_rng(0).integers(0, 256, (4, 4, 32))
    np.savez(base / "tokens.npz", tokens=tokens)
    inputs = {"params_fp32": params["fp32"], "params_bf16": params["bf16"],
              "samples": _draws(len(params["fp32"]), j_get_smoke(ARCH).n_layers),
              "tokens": tokens,
              "accum_tokens": np.random.default_rng(1).integers(0, 256, (PATH_STEPS, 8, 32))}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    reference = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "jax_shardmap_reference.py"),
         str(base / "reference.npz"), str(base / "tokens.npz"), "gum,gum_bf16"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        out = {"inputs": inputs}
        for n, names in SCENARIOS.items():
            out[n] = run_local_ranks(
                "torch_dist_workers:scenarios", n,
                args=(dict(inputs, dir=str(base / f"n{n}"), scenarios=names),),
                workdir=str(base / f"ranks{n}"), extra_path=[TESTS], timeout=SPAWN_TIMEOUT)
        out["jax_bf16"] = _jax_trainer(base / "jax_bf16", "bfloat16")
        out["jax_fp32"] = _jax_trainer(base / "jax_fp32", "float32")
        out["jax_accum"] = _jax_accum(inputs["accum_tokens"])
        log, _ = reference.communicate(timeout=SPAWN_TIMEOUT)
        assert reference.returncode == 0, log.decode()[-4000:]
        out["jax_steps"] = dict(np.load(base / "reference.npz"))
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()
    return out


def _as_torch(params: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in params.items()}


# ----------------------------------------------------------------- (a)


def test_bf16_mesh_trainer_is_the_microbatched_run(runs, tmp_path):
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    from torch_dist_workers import table_sampler

    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16")
    opt_cfg = OptimizerConfig(**PATH_OPTS["gum"])
    trainer = Trainer(build_model(cfg, device="cpu"), opt_cfg,
                      RunConfig(steps=PATH_STEPS, log_every=0, seed=0, ckpt_dir=str(tmp_path)),
                      DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0),
                      device="cpu", microbatches=2, params=runs["inputs"]["params_bf16"],
                      optimizer=build_optimizer(
                          opt_cfg, sampler=table_sampler(runs["inputs"]["samples"])))
    losses = trainer.train().losses
    want = {k: p.detach().float().numpy() for k, p in trainer.model.params().items()}
    for rank in range(2):
        got = result(runs, 2, "path:gum:bf16:replicated", rank)
        assert got["losses"] == losses
        assert params_equal(got["params"], want)
        assert {k: d for k, d in got["dtypes"].items() if d != "torch.bfloat16"} == \
            {"final_norm/norm_scale": "torch.float32"}


def test_bf16_mesh_trainer_tracks_reference(runs):
    got = result(runs, 2, "path:gum:bf16:replicated")
    _hold_to_reference(got["losses"], _as_torch(got["params"]), runs["jax_bf16"],
                       runs["jax_fp32"], lr=PATH_OPTS["gum"]["lr"], bf16_act=False)


# ----------------------------------------------------------------- (b)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("opt,dtype", PATH_CASES, ids=[f"{o}-{d}" for o, d in PATH_CASES])
def test_shard_state_is_bitwise(runs, n, opt, dtype):
    first = result(runs, n, f"path:{opt}:{dtype}:shard", 0)
    for rank in range(n):
        on = result(runs, n, f"path:{opt}:{dtype}:shard", rank)
        off = result(runs, n, f"path:{opt}:{dtype}:replicated", rank)
        assert len(on["losses"]) == PATH_STEPS and np.isfinite(on["losses"]).all()
        assert on["losses"] == off["losses"]
        assert params_equal(on["params"], off["params"])
        assert params_equal(on["params"], first["params"])
        b = on["bytes"]
        assert b["held"] == b["rule"] < b["whole"], b
        assert off["bytes"]["held"] == off["bytes"]["whole"]


# ----------------------------------------------------------------- (c)


def test_bf16_sharded_resume_is_bitwise(runs):
    got = result(runs, 2, "bf16_resume")
    whole = result(runs, 2, "path:gum:bf16:shard")
    assert got["resumed_from"] == 1
    assert got["first"] + got["second"] == whole["losses"]
    assert params_equal(got["params"], whole["params"])


# ----------------------------------------------------------------- (d)


@pytest.mark.parametrize("mode", ["replicated", "shard"])
def test_bf16_shardmap_step_tracks_reference(runs, mode):
    """Both packages sum the two ranks' bf16 gradients with one rounding,
    and each rounds the bf16 forward at its own places, so the port is held
    by the bf16 precision rule: no farther from the reference's bf16-stored step than
    that step lies from the reference's fp32-stored one."""
    got = result(runs, 2, f"shardmap_bf16:{mode}")
    ref = runs["jax_steps"]
    want = (ref[f"gum_bf16_{mode}/losses"],
            {k: ref[f"gum_bf16_{mode}/{k}"].astype(np.float64) for k in got["params"]}, None)
    yard = (ref[f"gum_{mode}/losses"],
            {k: ref[f"gum_{mode}/{k}"].astype(np.float64) for k in got["params"]}, None)
    _hold_to_reference(got["losses"], _as_torch(got["params"]), want, yard,
                       lr=GUM["lr"], bf16_act=False)
    other = result(runs, 2, f"shardmap_bf16:{'shard' if mode == 'replicated' else 'replicated'}")
    assert got["losses"] == other["losses"] and params_equal(got["params"], other["params"])
    for log in got["logs"]:
        grad = [e for e in log if e["tag"] == "grad"]
        assert len(grad) == 1 and grad[0]["dtype"] == "bfloat16"
    from repro_torch.core import OptimizerConfig, build_optimizer

    findings, _ = _schedule_findings(got["logs"], build_optimizer(OptimizerConfig(**GUM)),
                                     _meta_params("bf16"), 2, mode == "shard",
                                     reduce_dtype=torch.bfloat16)
    assert not findings, [f.format() for f in findings]


# ----------------------------------------------------------------- (e)


def _hold_accum(losses, params: dict, want_losses, want_params: dict,
                adamw_tol: float = ACCUM_PARAM_TOL) -> None:
    rel = np.abs(np.subtract(losses, want_losses)) / np.abs(want_losses)
    assert (rel <= ACCUM_LOSS_TOL).all(), rel
    for k, w in want_params.items():
        tol = ACCUM_PARAM_TOL if default_lowrank_filter(k, torch.from_numpy(w)) else adamw_tol
        assert rel_fro(params[k], w) <= tol, (k, rel_fro(params[k], w))


def test_accumulator_on_a_mesh_is_the_one_process_run(runs):
    one = accum_run(None, runs["inputs"], 4)
    got = result(runs, 2, "accum:2")
    _hold_accum(got["losses"], got["params"], one["losses"], one["params"])
    other = result(runs, 2, "accum:2", rank=1)
    assert got["losses"] == other["losses"] and params_equal(got["params"], other["params"])


def test_accumulator_on_a_mesh_tracks_reference(runs):
    """The leaves AdamW trains are held as ``tests/test_torch_distributed.py``
    (a) holds them against the reference, by Frobenius distance within
    1e-4: its first steps divide by |g|, so an entry whose gradient is
    rounding (an embedding row no token of the batch reaches) moves by a
    step of lr either way."""
    got = result(runs, 2, "accum:2")
    _hold_accum(got["losses"], got["params"], *runs["jax_accum"], adamw_tol=ADAMW_TOL)


# ----------------------------------------------------------------- (f)


def _schedule_findings(logs: list, transform, params: dict, n: int, shard: bool,
                       accum: bool = False,
                       reduce_dtype: torch.dtype = torch.float32) -> tuple[list, dict]:
    """The findings of the traced steps (step 2 steady, step 1's extras
    boundary-only) against the closed-form model, and the model."""
    from repro_torch.analysis.collectives import (
        boundary_only,
        collect_collectives,
        collective_schedule_findings,
        expected_collective_schedule,
    )

    steady = collect_collectives(logs[1])
    records = steady + boundary_only(collect_collectives(logs[0]), steady)
    expected = expected_collective_schedule(transform, params, n_shards=n,
                                            reduce_dtype=reduce_dtype, shard_state=shard,
                                            lowrank_accum=accum)
    return collective_schedule_findings(records, expected, reduce_dtype=reduce_dtype,
                                        params=params), expected


def _meta_params(dtype: str) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16" if dtype == "bf16" else "float32")
    return build_model(cfg, device="meta").params()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("opt,dtype", PATH_CASES, ids=[f"{o}-{d}" for o, d in PATH_CASES])
def test_collectives_match_the_model(runs, n, opt, dtype):
    from repro_torch.core import OptimizerConfig, build_optimizer

    params = _meta_params(dtype)
    for mode in ("replicated", "shard"):
        shard = mode == "shard"
        transform = build_optimizer(OptimizerConfig(**PATH_OPTS[opt], shard_state=shard))
        logs = result(runs, n, f"path:{opt}:{dtype}:{mode}")["logs"]
        assert len(logs) == PATH_STEPS
        findings, expected = _schedule_findings(logs, transform, params, n, shard)
        assert not findings, [f.format() for f in findings]
        for log in logs:  # every step, the refreshes' too
            gathers = [e for e in log if e["op"] == "all_gather"]
            assert len(gathers) == int(shard), log
            if shard:
                assert gathers[0]["bytes"] == expected["update_gather"]["payload_bytes"]
            assert [e["tag"] for e in log if e["op"] == "all_reduce"] == ["grad", "loss"]


def test_fused_epilogue_gathers_fewer_bytes_than_the_update_rows(runs):
    """Under ``fused_epilogue`` a split family's gather carries its
    projector rows and projected update rows, ``r·(m + n)`` a block, in
    place of the update rows' ``m·n``."""
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.analysis.collectives import expected_collective_schedule

    params = _meta_params("fp32")
    got = result(runs, 2, "path:galore_epi:fp32:shard")["logs"][1]
    gathered = [e["bytes"] for e in got if e["op"] == "all_gather"]
    rows = expected_collective_schedule(
        build_optimizer(OptimizerConfig(**dict(PATH_OPTS["galore_epi"], fused_epilogue=False))),
        params, n_shards=2, shard_state=True)["update_gather"]["payload_bytes"]
    # llama-60m SMOKE at rank 4: (8, 64, 64), (4, 64, 128), (2, 128, 64) stacks
    assert gathered == [4 * (4 * 4 * 128 + 2 * 4 * 192 + 1 * 4 * 192)]
    assert rows == 4 * (4 * 64 * 64 + 2 * 64 * 128 + 1 * 128 * 64) > gathered[0]


def test_accumulator_collectives_match_the_model(runs):
    from repro_torch.analysis.collectives import accum_payload
    from torch_dist_workers import accum_tools

    params = _meta_params("fp32")
    transform = accum_tools(runs["inputs"]).transform
    logs = result(runs, 2, "accum:2")["logs"]
    findings, expected = _schedule_findings(logs, transform, params, 2, False, accum=True)
    assert not findings, [f.format() for f in findings]
    full = 4 * sum(p.numel() for p in params.values())
    for step, log in enumerate(logs):
        tags = [f"{e['op']}:{e['tag']}" for e in log]
        refresh = step % PATH_OPTS["gum"]["period"] == 0
        assert tags == ["broadcast:refresh"] * refresh + ["all_reduce:grad", "all_reduce:loss"]
        grad = log[refresh]
        assert grad["dtype"] == "float32"
        assert grad["bytes"] == expected["grad_psum"]["payload_bytes"] < full
    values, _, refresh_bytes = accum_payload(transform, params)
    assert logs[0][0]["bytes"] == refresh_bytes == expected["refresh_broadcast"]["payload_bytes"]


@pytest.mark.parametrize("opt", ["fira", "galore_epi"])
def test_sharded_audit_of_the_new_paths(opt):
    from repro_torch.analysis import audit_sharded
    from repro_torch.core import OptimizerConfig

    rep = audit_sharded(OptimizerConfig(**PATH_OPTS[opt], shard_state=True),
                        mesh_axes=(("data", 2),))
    assert rep.ok, [f.format() for f in rep.errors]
    assert rep.summary["expected_schedule"]["update_gather"]["count"] == 1


# ----------------------------------------------------------------- (g)


def test_accumulator_under_shard_state_raises():
    from repro_torch.configs import get_smoke
    from repro_torch.core import gum_accum_tools
    from repro_torch.core.combinators import family_sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    mesh = Mesh((2,), ("data",))  # a shape only: refused before any collective
    model = build_model(get_smoke(ARCH), device="cpu")
    model.init_params(0)
    tools = gum_accum_tools(ACCUM_LR, **ACCUM)
    with pytest.raises(NotImplementedError, match="item 5i"):
        make_train_step(model, tools.transform, microbatches=2, lowrank_accum=tools, mesh=mesh,
                        shard_state=True)
    params = {k: p.detach() for k, p in model.params().items()}
    state = tools.transform.init(params)
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    with family_sharding(mesh), pytest.raises(NotImplementedError, match="item 5i"):
        tools.refresh(grads, state, params)
    with family_sharding(mesh), pytest.raises(NotImplementedError, match="item 5i"):
        tools.transform.update(grads, state, params)


# ----------------------------------------------------------------- (h)


def test_cli_fused_galore_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", ARCH, "--smoke", "--opt", "galore", "--fused-epilogue", "--steps", "2",
           "--batch", "4", "--seq", "32", "--rank", "4", "--period", "2",
           "--ckpt-dir", str(tmp_path), "--mesh", "data=2", "--shard-state"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    done = [line for line in out.stdout.splitlines() if line.startswith("done: step=2")]
    assert len(done) == 1, out.stdout  # rank 0 alone prints
