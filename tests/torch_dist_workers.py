"""The rank side of ``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_paths.py``: scenarios each rank of a
``repro_torch.launch.mesh.run_local_ranks`` group runs, on llama-60m
``SMOKE`` over gloo.  Imports no JAX: the tests hand in the reference's
initial parameters and block draws (``inputs``).

:func:`scenarios` runs the named scenarios in order and returns, per name,
its result or the traceback it raised, so that each test reads its own.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_smoke
from repro_torch.core import OptimizerConfig, build_optimizer, find_lowrank_states
from repro_torch.core.combinators import (
    shard_family_state,
    slot_projector_bytes,
    strip_slot_projectors,
)
from repro_torch.data import DataConfig
from repro_torch.kernels.collective_count import record_collectives, tally
from repro_torch.launch.shardmap_fsdp import make_shardmap_train_step
from repro_torch.models import build_model
from repro_torch.sharding import family_state_bytes, family_state_sharding, row_splits
from repro_torch.train import Trainer

ARCH = "llama-60m"
GUM = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3, fuse_families=True)
STEPS = 6


def table_sampler(table: dict):
    """The reference's block draws, looked up by ``(key, L, g_f)``."""
    def sampler(key, L, g_f):
        return torch.from_numpy(table[(tuple(key), L, g_f)].astype(np.int64))

    return sampler


def _numpy(params: dict) -> dict:
    """The parameters as numpy (a bf16 leaf as its exact fp32 cast)."""
    return {k: p.detach().cpu().float().numpy().copy() if p.dtype == torch.bfloat16
            else p.detach().cpu().numpy().copy() for k, p in params.items()}


def _state_bytes(trainer: Trainer, mesh) -> dict:
    """This rank's family-stacked state bytes (slot projectors apart) beside
    ``family_state_bytes``'s per-shard figure for the whole layout."""
    n = mesh.shape["data"]
    like = {k: p.detach() for k, p in trainer.model.params().items()}
    whole = trainer.optimizer.init(like)
    held = family_state_bytes(strip_slot_projectors(trainer.opt_state), 1)[0]
    return {"held": held, "rule": family_state_bytes(whole, n)[1],
            "whole": family_state_bytes(whole, n)[0],
            "slot_projs": slot_projector_bytes(trainer.opt_state)}


def _probes(opt_state) -> list:
    """Every low-rank state's probe dicts, as numpy."""
    return [{k: v.cpu().numpy() for k, v in pr.items()}
            for st in find_lowrank_states(opt_state) if st.probes
            for pr in st.probes.values() if pr is not None]


def train(mesh, inputs: dict, label: str, *, shard: bool, steps: int = STEPS,
          ckpt_every: int = 100, opt: dict = GUM, reference_draws: bool = True,
          **trainer_kw) -> dict:
    cfg = get_smoke(ARCH)
    opt_cfg = OptimizerConfig(**opt, shard_state=shard)
    optimizer = None
    if reference_draws:
        optimizer = build_optimizer(opt_cfg, sampler=table_sampler(inputs["samples"]))
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    trainer = Trainer(build_model(cfg, device="cpu"), opt_cfg,
                      RunConfig(steps=steps, log_every=0, seed=0, ckpt_every=ckpt_every,
                                ckpt_dir=os.path.join(inputs["dir"], label)),
                      DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0),
                      device="cpu", mesh=mesh, optimizer=optimizer, params=params,
                      **trainer_kw)
    trainer.monitor.z = float("inf")
    result = trainer.train()
    out = {"losses": result.losses, "params": _numpy(trainer.model.params()),
           "resumed_from": result.resumed_from, "skipped": result.skipped_nonfinite,
           "recoveries": result.recovery_counts, "bytes": _state_bytes(trainer, mesh)}
    if trainer.rank_ctrl is not None:
        out["history"] = [(c, str(m)) for c, m in trainer.rank_ctrl.history]
    out["probes"] = _probes(trainer.opt_state)
    return out


def resume(mesh, inputs: dict) -> dict:
    """2 sharded steps and a checkpoint, then a second ``Trainer`` on the
    directory to step 6 (across the refresh at count 4); and the checkpoint
    put back on this rank by ``restore(shardings=)``."""
    first = train(mesh, inputs, "resume", shard=True, steps=2)
    second = train(mesh, inputs, "resume", shard=True, steps=STEPS)
    out = {"first": first["losses"], "second": second["losses"],
           "resumed_from": second["resumed_from"], "params": second["params"]}
    # restore(shardings=) with the state rule: each leaf's rows, as
    # shard_family_state cuts them
    from repro_torch.checkpoint import CheckpointManager

    cfg = get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    like = {k: p.detach() for k, p in model.params().items()}
    opt = build_optimizer(OptimizerConfig(**GUM, shard_state=True))
    whole_like = opt.init(like)
    mgr = CheckpointManager(os.path.join(inputs["dir"], "resume"))
    rules = ({k: None for k in like}, row_splits(family_state_sharding(whole_like, mesh), mesh))
    (_, local), _ = mgr.restore(STEPS, (like, whole_like), shardings=rules)
    (_, whole), _ = mgr.restore(STEPS, (like, whole_like))
    want = strip_slot_projectors(shard_family_state(whole, mesh))
    from repro_torch.checkpoint.manager import flatten_with_paths

    a, b = flatten_with_paths(local), flatten_with_paths(want)
    out["restore_shardings_equal"] = (
        [p for p, _ in a] == [p for p, _ in b]
        and all((torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
                for (_, x), (_, y) in zip(a, b)))
    out["restore_shapes"] = {p: tuple(x.shape) for p, x in a if isinstance(x, torch.Tensor)
                             and "projs" in p}
    return out


STEP_CASES = {"adamw": dict(name="adamw", lr=1e-3), "gum": GUM,
              "gum_probes": dict(GUM, telemetry=True)}


def shardmap(mesh, inputs: dict, case: str, shard: bool) -> dict:
    """``make_shardmap_train_step`` (bf16 reduction) from the reference's
    initial parameters over ``inputs["tokens"]``, one batch a step, with
    each step's collectives."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    model.load_params({k: torch.from_numpy(v) for k, v in inputs["params"].items()})
    opt = build_optimizer(OptimizerConfig(**STEP_CASES[case]),
                          sampler=table_sampler(inputs["samples"]))
    step = make_shardmap_train_step(model, opt, mesh, shard_state=shard)
    params = model.params()
    state = step.place_state(opt.init({k: p.detach() for k, p in params.items()}))
    losses, logs, probes = [], [], []
    for tokens in inputs["tokens"]:
        with record_collectives() as log:
            state, metrics = step(params, state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(metrics["loss"]))
        logs.append(log)
        probes.append(_probes(state))
    return {"losses": losses, "params": _numpy(params), "logs": logs, "probes": probes,
            "counts": [tally(log) for log in logs], "info": {
                k: str(v) for k, v in step.sharded_step_info.items()}}


# ---------------------------------------------------------------------------
# tests/test_torch_distributed_paths.py: the paths a mesh refused before
# ---------------------------------------------------------------------------

PATH_STEPS = 3  # period 2: refreshes at steps 1 and 3
PATH_OPTS = {
    "gum": dict(GUM, period=2),
    "fira": dict(name="fira", lr=1e-3, rank=4, period=2, fuse_families=True),
    "galore_epi": dict(name="galore", lr=1e-2, rank=4, period=2, weight_decay=0.01,
                       fuse_families=True, fused_epilogue=True),
}
ACCUM = dict(rank=4, gamma=1, period=2, fuse_families=True, weight_decay=0.01)
ACCUM_LR = 1e-2


def _counted(step_fn, logs: list):
    """``step_fn`` recording each call's collectives into ``logs``."""
    def step(*args):
        with record_collectives() as log:
            out = step_fn(*args)
        logs.append(log)
        return out

    return step


def path_train(mesh, inputs: dict, opt: str, dtype: str, shard: bool, *,
               steps: int = PATH_STEPS, label: str = "") -> dict:
    """``Trainer(mesh=)`` with ``PATH_OPTS[opt]`` from the reference's initial
    parameters (``dtype`` "bf16": the reference's bf16-stored init), its
    block draws injected; each step's collectives."""
    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16" if dtype == "bf16" else "float32")
    opt_cfg = OptimizerConfig(**PATH_OPTS[opt], shard_state=shard)
    params = {k: torch.as_tensor(v) for k, v in inputs[f"params_{dtype}"].items()}
    label = label or f"{opt}_{dtype}_{'shard' if shard else 'replicated'}"
    trainer = Trainer(build_model(cfg, device="cpu"), opt_cfg,
                      RunConfig(steps=steps, log_every=0, seed=0, ckpt_every=100,
                                ckpt_dir=os.path.join(inputs["dir"], label)),
                      DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0),
                      device="cpu", mesh=mesh, params=params,
                      optimizer=build_optimizer(opt_cfg,
                                                sampler=table_sampler(inputs["samples"])))
    trainer.monitor.z = float("inf")
    logs: list = []
    trainer.step_fn = _counted(trainer.step_fn, logs)
    result = trainer.train()
    return {"losses": result.losses, "params": _numpy(trainer.model.params()),
            "dtypes": {k: str(p.dtype) for k, p in trainer.model.params().items()},
            "logs": logs, "resumed_from": result.resumed_from,
            "bytes": _state_bytes(trainer, mesh)}


def bf16_resume(mesh, inputs: dict) -> dict:
    """bf16-stored GUM under ``shard_state``: 1 step and a checkpoint, then a
    second ``Trainer`` on the directory to step 3, across the refresh."""
    first = path_train(mesh, inputs, "gum", "bf16", True, steps=1, label="bf16_resume")
    second = path_train(mesh, inputs, "gum", "bf16", True, label="bf16_resume")
    return {"first": first["losses"], "second": second["losses"],
            "resumed_from": second["resumed_from"], "params": second["params"]}


def shardmap_bf16(mesh, inputs: dict, shard: bool) -> dict:
    """``make_shardmap_train_step`` (bf16 reduction) of GUM on the
    reference's bf16-stored initial parameters, one batch of
    ``inputs["tokens"]`` a step."""
    model = build_model(get_smoke(ARCH).replace(param_dtype="bfloat16"), device="cpu")
    model.load_params({k: torch.as_tensor(v) for k, v in inputs["params_bf16"].items()})
    opt = build_optimizer(OptimizerConfig(**GUM), sampler=table_sampler(inputs["samples"]))
    step = make_shardmap_train_step(model, opt, mesh, shard_state=shard)
    params = model.params()
    state = step.place_state(opt.init({k: p.detach() for k, p in params.items()}))
    losses, logs = [], []
    step = _counted(step, logs)
    for tokens in inputs["tokens"]:
        state, metrics = step(params, state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": _numpy(params), "logs": logs}


def accum_tools(inputs: dict):
    from repro_torch.core import gum_accum_tools

    return gum_accum_tools(ACCUM_LR, sampler=table_sampler(inputs["samples"]), **ACCUM)


def accum_run(mesh, inputs: dict, microbatches: int) -> dict:
    """``make_train_step(lowrank_accum=gum_accum_tools(...))`` over
    ``inputs["accum_tokens"]`` (this rank's rows of each global batch on a
    mesh, the whole batch without one), from the reference's initial
    parameters and draws; each step's collectives."""
    from repro_torch.launch.steps import make_train_step

    model = build_model(get_smoke(ARCH), device="cpu")
    model.load_params({k: torch.as_tensor(v) for k, v in inputs["params_fp32"].items()})
    tools = accum_tools(inputs)
    step = make_train_step(model, tools.transform, microbatches=microbatches,
                           lowrank_accum=tools, mesh=mesh)
    params = model.params()
    state = tools.transform.init({k: p.detach() for k, p in params.items()})
    n = 1 if mesh is None else mesh.shape["data"]
    k = 0 if mesh is None else mesh.coordinate("data")
    losses, logs = [], []
    step = _counted(step, logs)
    for tokens in inputs["accum_tokens"]:
        per = tokens.shape[0] // n
        state, metrics = step(params, state,
                              {"tokens": torch.from_numpy(tokens[k * per:(k + 1) * per])})
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": _numpy(params), "logs": logs}


# ---------------------------------------------------------------------------
# tests/test_torch_fsdp.py: split parameters (shard_params)
# ---------------------------------------------------------------------------

FSDP_STEPS = 4  # period 3: refreshes at steps 1 and 4
FSDP_OPTS = {
    "gum": GUM,
    "gum_leaf": dict(GUM, fuse_families=False),
    "gum_zero": dict(GUM, shard_state=True),
    "adamw": dict(name="adamw", lr=1e-3),
    "galore_wd": dict(name="galore", lr=1e-2, rank=4, period=3, weight_decay=0.01,
                      fuse_families=True, fused_epilogue=True),
    "gum_bf16": GUM,
    "mamba": GUM,
}


def _held_bytes(params: dict) -> int:
    return sum(p.numel() * p.element_size() for p in params.values())


def fsdp_train(mesh, inputs: dict, case: str, mode: str, *, steps: int = FSDP_STEPS,
               label: str = "", microbatches: int = 1) -> dict:
    """``Trainer(mesh=, shard_params=mode == "split")`` with ``FSDP_OPTS[case]``
    on llama-60m ``SMOKE`` (mamba2-370m for ``mamba``; bf16-stored for
    ``gum_bf16``) from the seed's parameters, or for ``gum`` and ``gum_zero``
    the reference's with its block draws injected; the whole parameters after the
    run, each step's collectives and their findings against the model, and
    the bytes this rank holds beside ``per_shard_bytes``."""
    from repro_torch.analysis.collectives import (
        collect_collectives,
        collective_schedule_findings,
        expected_collective_schedule,
    )
    from repro_torch.sharding import per_shard_bytes

    arch = "mamba2-370m" if case == "mamba" else ARCH
    cfg = get_smoke(arch).replace(param_dtype="bfloat16" if case == "gum_bf16" else "float32")
    opt_cfg = OptimizerConfig(**FSDP_OPTS[case])
    params, reference = None, case in ("gum", "gum_zero")
    if reference:
        params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    label = label or f"fsdp_{case}_{mode}_{mesh.shape['data']}"
    trainer = Trainer(build_model(cfg, device="cpu"), opt_cfg,
                      RunConfig(steps=steps, log_every=0, seed=0, ckpt_every=2,
                                ckpt_dir=os.path.join(inputs["dir"], label)),
                      DataConfig(vocab=cfg.vocab, seq_len=64 if reference else 32,
                                 global_batch=4, seed=0),
                      device="cpu", mesh=mesh, params=params, microbatches=microbatches,
                      optimizer=build_optimizer(opt_cfg, sampler=table_sampler(
                          inputs["samples"]) if reference else None),
                      shard_params=mode == "split")
    trainer.monitor.z = float("inf")
    logs: list = []
    trainer.step_fn = _counted(trainer.step_fn, logs)
    result = trainer.train()
    whole = trainer.whole_params()
    out = {"losses": result.losses, "params": _numpy(whole),
           "resumed_from": result.resumed_from, "counts": [tally(log) for log in logs],
           "held": _held_bytes(trainer.model.params()), "whole": _held_bytes(whole),
           "rule": per_shard_bytes(whole, mesh)}
    if trainer.param_split is not None and logs:
        expected = expected_collective_schedule(
            trainer.optimizer, trainer.param_split.standins(), n_shards=mesh.shape["data"],
            reduce_dtype=torch.float32, shard_state=opt_cfg.shard_state,
            param_split=trainer.param_split, remat=cfg.remat, microbatches=microbatches,
            step=len(logs))
        out["expected"] = expected
        out["findings"] = [f.format() for f in collective_schedule_findings(
            collect_collectives(logs[-1]), expected, reduce_dtype=torch.float32)]
    return out


def fsdp_backward(mesh, inputs: dict) -> dict:
    """One forward and backward of split llama-60m ``SMOKE`` parameters with
    the split's log on: what autograd returned for each leaf, the shapes
    every gather and reduce-scatter saw, and the accumulator's shapes."""
    from repro_torch.launch.steps import split_loss_and_grads
    from repro_torch.sharding import ParamSplit

    cfg = get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    model.init_params(0)
    split = ParamSplit(model, mesh)
    split.split_params()
    split.log = []
    params = model.params()
    tokens = torch.from_numpy(inputs["tokens"][0][:2])
    _, grads = split_loss_and_grads(model, params, {"tokens": tokens}, split)
    return {"returned": {k: None if g is None else tuple(g.shape) for k, g in grads.items()},
            "log": split.log, "layer": sorted(split.layer), "once": list(split.once),
            "acc": {k: tuple(v.shape) for k, v in split.grads.items()},
            "parts": {k: tuple(p.shape) for k, p in params.items()},
            "whole": dict(split.shapes)}


def fsdp_cli_twin(mesh, inputs: dict) -> dict:
    """The ``Trainer`` run that ``python -m repro_torch.launch.train --smoke
    --steps 4 --batch 4 --seq 32 --rank 4 --gamma 1 --period 3 --mesh data=2
    --shard-params`` makes."""
    cfg = get_smoke(ARCH)
    trainer = Trainer(build_model(cfg, device="cpu"),
                      OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=3),
                      RunConfig(steps=4, ckpt_every=1, log_every=10,
                                ckpt_dir=os.path.join(inputs["dir"], "cli_twin")),
                      DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4),
                      device="cpu", mesh=mesh, shard_params=True)
    return {"losses": trainer.train().losses}


def fsdp_family(mesh, inputs: dict, arch: str) -> dict:
    """``make_shardmap_train_step`` (fp32 reduction) of per-leaf GUM on
    ``arch``'s ``SMOKE`` model from seed 0, replicated and on split
    parameters, 2 steps each over one seeded global batch (tokens; images
    beside them for the vlm, frames and targets for audio)."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng(0)
    rows, seq = 4, 16
    if cfg.frontend == "frames":
        batch = {"frames": rng.standard_normal((rows, seq, cfg.d_model), np.float32),
                 "targets": rng.integers(0, cfg.vocab, (rows, seq))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (rows, seq))}
    if cfg.family == "vlm":
        batch["images"] = rng.standard_normal((rows, cfg.n_image_tokens, cfg.d_model),
                                              np.float32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for mode in ("replicated", "split"):
        model = build_model(cfg, device="cpu")
        model.init_params(0)
        if cfg.family == "vlm":  # nonzero gates: tanh(0) = 0 skips the cross blocks
            with torch.no_grad():
                model.blocks.cross.gate_attn.fill_(0.5)
                model.blocks.cross.gate_mlp.fill_(0.5)
        opt = build_optimizer(OptimizerConfig(**dict(GUM, fuse_families=False)))
        step = make_shardmap_train_step(model, opt, mesh, reduce_dtype=torch.float32,
                                        shard_params=mode == "split")
        state = step.place_state(step.init_state(opt))
        params, losses = model.params(), []
        for _ in range(2):
            state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        whole = step.param_split.whole_params() if step.param_split else params
        out[mode] = {"losses": losses, "params": _numpy(whole)}
    return out


def _scenario(mesh, inputs: dict, name: str):
    kind, _, rest = name.partition(":")
    if kind == "fsdp_family":
        return fsdp_family(mesh, inputs, rest)
    if kind == "fsdp":
        case, mode = rest.split(":")
        return fsdp_train(mesh, inputs, case, mode)
    if kind == "fsdp_mb":
        return fsdp_train(mesh, inputs, "gum", rest, microbatches=2,
                          label=f"fsdp_mb_{rest}")
    if kind == "fsdp_resume":
        # 2 steps in one layout, then 2 more in ``rest``'s from the checkpoint
        first, second = rest.split(">")
        label = f"fsdp_resume_{first}_{second}"
        fsdp_train(mesh, inputs, "gum_zero", first, steps=2, label=label)
        return fsdp_train(mesh, inputs, "gum_zero", second, label=label)
    if kind == "fsdp_backward":
        return fsdp_backward(mesh, inputs)
    if kind == "fsdp_cli_twin":
        return fsdp_cli_twin(mesh, inputs)
    if kind == "path":
        opt, dtype, mode = rest.split(":")
        return path_train(mesh, inputs, opt, dtype, mode == "shard")
    if kind == "bf16_resume":
        return bf16_resume(mesh, inputs)
    if kind == "shardmap_bf16":
        return shardmap_bf16(mesh, inputs, rest == "shard")
    if kind == "accum":
        return accum_run(mesh, inputs, int(rest))
    if kind == "train":
        return train(mesh, inputs, f"{name.replace(':', '_')}_{mesh.shape['data']}",
                     shard=rest == "shard")
    if kind == "resume":
        return resume(mesh, inputs)
    if kind == "spectral":
        policy = dict(GUM, rank=8, rank_policy="spectral:0.5", rank_ladder=(2, 4, 8))
        return train(mesh, inputs, f"spectral_{rest}", shard=rest == "shard", opt=policy,
                     reference_draws=False)
    if kind == "nan":
        return train(mesh, inputs, "nan", shard=True, steps=4, resilience="",
                     inject="grad_nan@2")
    if kind == "shardmap":
        case, _, mode = rest.partition(":")
        return shardmap(mesh, inputs, case, mode == "shard")
    raise ValueError(name)


def scenarios(mesh, inputs: dict) -> dict:
    out = {}
    for name in inputs["scenarios"]:
        try:
            out[name] = _scenario(mesh, inputs, name)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out
