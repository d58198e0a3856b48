"""The rank side of ``tests/test_torch_tensor_parallel.py``: scenarios the 4
ranks of one ``repro_torch.launch.mesh.run_local_ranks`` group run on gloo,
over meshes built on the spawn's group: (data=2, model=2), (data=1,
model=4), and (data=1, model=2) on each pair of ranks (0, 1) and (2, 3).
Imports no JAX: the test hands in the reference's initial parameters and block draws.

A scenario ``one:...`` is the one-process twin of a mesh run, run by one
rank alone (the ``i``-th such scenario by rank ``i % 4``), with no mesh, or
for ``one:...:bf16`` on a mesh of that rank alone (a mesh reduces each
bf16 gradient in fp32, as the one-process run does not); every other
scenario runs on every rank.  :func:`scenarios` returns, per name, the
result or the traceback it raised.
"""
from __future__ import annotations

import os
import traceback

import torch

from repro_torch.configs import RunConfig, get_smoke
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.data import DataConfig
from repro_torch.kernels.collective_count import tally
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.train import Trainer
from torch_dist_workers import ARCH, FSDP_OPTS, _counted, _numpy, table_sampler

STEPS = 4  # period 3: refreshes at steps 1 and 4
SEQ = 64
BATCH = 4
TP_OPTS = {k: FSDP_OPTS[k] for k in ("gum", "gum_leaf", "gum_zero", "adamw", "galore_wd")}
CHUNK = 8  # logit_chunk of the chunked-loss case: 63 shifted rows in 8 chunks


def _config(arch: str, variant: str):
    cfg = get_smoke(arch)
    if variant == "bf16":
        cfg = cfg.replace(param_dtype="bfloat16")
    elif variant == "chunk":
        cfg = cfg.replace(logit_chunk=CHUNK)
    elif variant == "remat":
        cfg = cfg.replace(remat=True)
    return cfg


def train(mesh, inputs: dict, label: str, case: str, *, arch: str = ARCH, variant: str = "",
          shard_params: bool = False, steps: int = STEPS) -> dict:
    """A ``Trainer`` run of ``TP_OPTS[case]`` on ``arch``'s ``SMOKE`` (with
    ``variant``: bf16 storage, a chunked loss or remat), on ``mesh`` (None: one
    process); llama-60m from the reference's parameters with its block
    draws, the other archs from seed 0.  Its losses, whole parameters, each
    step's collectives and, on a mesh, their findings against
    ``analysis/collectives.py`` and this rank's parameter bytes."""
    from repro_torch.analysis.collectives import (
        collect_collectives,
        collective_schedule_findings,
        expected_collective_schedule,
    )
    from repro_torch.sharding import per_shard_bytes

    cfg = _config(arch, variant)
    opt_cfg = OptimizerConfig(**TP_OPTS[case])
    reference = arch == ARCH
    params = ({k: torch.from_numpy(v) for k, v in inputs["params"].items()}
              if reference else None)
    sampler = table_sampler(inputs["samples"]) if reference else None
    trainer = Trainer(build_model(cfg, device="cpu"), opt_cfg,
                      RunConfig(steps=steps, log_every=0, seed=0, ckpt_every=2,
                                ckpt_dir=os.path.join(inputs["dir"], label)),
                      DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0),
                      device="cpu", mesh=mesh, params=params, shard_params=shard_params,
                      optimizer=build_optimizer(opt_cfg, sampler=sampler))
    trainer.monitor.z = float("inf")
    logs: list = []
    trainer.step_fn = _counted(trainer.step_fn, logs)
    result = trainer.train()
    whole = trainer.whole_params()
    out = {"losses": result.losses, "params": _numpy(whole),
           "resumed_from": result.resumed_from,
           "counts": [tally(log) for log in logs]}
    split = trainer.param_split
    if mesh is None or split is None:
        return out
    held = sum(p.numel() * p.element_size() for p in trainer.model.params().values())
    out |= {"held": held, "whole": sum(p.numel() * p.element_size() for p in whole.values()),
            "rule": per_shard_bytes(whole, mesh, None if shard_params else ("model",)),
            "findings": [], "schedule": None}
    if logs:
        rows = BATCH // mesh.shape["data"]
        for i, log in enumerate(logs):
            expected = expected_collective_schedule(
                trainer.optimizer, split.standins(), n_shards=mesh.shape["data"],
                reduce_dtype=torch.float32, shard_state=opt_cfg.shard_state,
                param_split=split, remat=cfg.remat, step=i + 1,
                tensor_parallel={"cfg": cfg, "rows": rows, "seq": SEQ})
            out["findings"] += [f"step {i + 1}: {f.format()}" for f in
                                collective_schedule_findings(collect_collectives(log), expected,
                                                             reduce_dtype=torch.float32)]
        out["schedule"] = {k: (v["count"], v.get("axis"), v["payload_bytes"])
                           for k, v in expected.items() if isinstance(v, dict) and v.get("count")}
        out["log"] = [(e["op"], e["tag"], e["axis"], e["dtype"], e["bytes"]) for e in logs[-1]]
    return out


def _meshes(mesh) -> dict:
    """The meshes over the 4-rank group, built alike on every rank."""
    import torch.distributed as dist

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[mesh.rank // 2]
    solos = [dist.new_group([k]) for k in range(4)]
    return {"solo": Mesh((1,), ("data",), group=solos[mesh.rank], backend=mesh.backend),
            "2x2": Mesh((2, 2), ("data", "model"), group=mesh.group, backend=mesh.backend),
            "1x4": Mesh((1, 4), ("data", "model"), group=mesh.group, backend=mesh.backend),
            "1x2": Mesh((1, 2), ("data", "model"), group=pair, backend=mesh.backend)}


def _label(name: str, mesh) -> str:
    """A checkpoint directory of its own for each mesh (the two (1, 2)
    meshes are replicas of one run)."""
    import torch.distributed as dist

    return f"{name.replace(':', '_').replace('>', '_')}_{dist.get_rank() // mesh.group.size()}"


def _scenario(meshes: dict, inputs: dict, name: str):
    kind, *rest = name.split(":")
    if kind == "one":  # one:<case>:<arch>:<variant>, the last two may be empty
        case, arch, variant = (rest + ["", ""])[:3]
        return train(meshes["solo"] if variant == "bf16" else None, inputs,
                     name.replace(":", "_"), case, arch=arch or ARCH, variant=variant)
    if kind == "tp":  # tp:<case>:<shape>[:sp]
        case, shape, *sp = rest
        mesh = meshes[shape]
        return train(mesh, inputs, _label(name, mesh), case, shard_params=bool(sp))
    if kind == "arch":  # arch:<arch>:<shape>
        arch, shape = rest
        mesh = meshes[shape]
        return train(mesh, inputs, _label(name, mesh), "gum", arch=arch)
    if kind == "variant":  # variant:<bf16|chunk|remat>:<shape>
        variant, shape = rest
        mesh = meshes[shape]
        return train(mesh, inputs, _label(name, mesh), "gum", variant=variant)
    if kind == "resume":  # resume:<first>><second>: 2 steps, then 2 more from the checkpoint
        first, second = rest[0].split(">")
        mesh = meshes["2x2"]
        label = _label(name, mesh)
        train(mesh, inputs, label, "gum_zero", shard_params=first == "split", steps=2)
        return train(mesh, inputs, label, "gum_zero", shard_params=second == "split")
    raise ValueError(name)


def scenarios(mesh, inputs: dict) -> dict:
    meshes = _meshes(mesh)
    out, local = {}, 0
    for name in inputs["scenarios"]:
        if name.startswith("one:"):
            mine = local % mesh.group.size() == mesh.rank
            local += 1
            if not mine:
                continue
        try:
            out[name] = _scenario(meshes, inputs, name)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out
