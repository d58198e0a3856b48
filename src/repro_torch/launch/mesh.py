"""Meshes over ``torch.distributed`` (the port of the JAX package's
``launch/mesh.py``), and a launcher of local ranks.

A :class:`Mesh` names its axes and their sizes the way ``jax.sharding.Mesh``
does (``axis_names``, ``shape[axis]``), so the sharding rules of
:mod:`repro_torch.sharding` read either.  A mesh built over an initialised
process group also carries this process's coordinates and one process group
per line of each axis (the ranks that differ in that coordinate alone), and
its collectives run over one axis (``axis=``, the data axis by default),
each recorded by :mod:`repro_torch.kernels.collective_count`.

The backend is always an explicit choice: ``nccl`` for CUDA tensors,
``gloo`` for CPU tensors, and nothing retries with another backend after a
failure.  ``gloo`` also takes CUDA tensors (several ranks on one card, which
``nccl`` refuses).

:func:`run_local_ranks` starts N processes on this machine that join one
process group through a file-store rendezvous, run a function, and hand its
result back; every wait has a time limit, and a rank that fails or hangs
ends all of them::

    results = run_local_ranks("my_module:fn", 2, args=(...), workdir=tmp)
    # in each rank: fn(mesh, *args) -> picklable result
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import math
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Optional, Sequence

import torch

from repro_torch.kernels import collective_count

# The pod meshes of the JAX package (TPU v5e): (data=16, model=16) on one pod,
# (pod=2, data=16, model=16) on two.
PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """Named axes over the ranks of a process group, row-major (the last axis
    varies fastest).  ``group=None`` with no process group gives a mesh of
    shape only (the sharding rules need nothing more).

    Over a group, every rank of it must build the mesh, in the same order
    as any other mesh over that group: the constructor makes the process
    group of every line of every axis larger than 1 that is not the whole
    group (a collective call of every rank, axis by axis, line by line)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 group=None, backend: Optional[str] = None, data_axis: str = "data"):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.group = group
        self.backend = backend
        self.data_axis = data_axis if data_axis in self.shape else self.axis_names[0]
        self.rank: Optional[int] = None
        self._lines: dict = {}
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self._lines = self._make_lines(dist)

    def _make_lines(self, dist) -> dict:
        """``{axis: group}``: this rank's line of each axis (the mesh's own
        group where the axis spans it, no group for an axis of size 1)."""
        size = math.prod(self.shape.values())
        members = dist.get_process_group_ranks(self.group)
        lines = {}
        for i, axis in enumerate(self.axis_names):
            n = self.shape[axis]
            if n == size:
                lines[axis] = self.group
                continue
            if n == 1:
                lines[axis] = None
                continue
            stride = math.prod(self.shape[a] for a in self.axis_names[i + 1:])
            for first in range(size):
                if (first // stride) % n:
                    continue  # not the line's first rank
                ranks = [members[first + j * stride] for j in range(n)]
                g = dist.new_group(ranks)
                if first <= self.rank and (self.rank - first) % stride == 0 \
                        and self.rank < first + n * stride:
                    lines[axis] = g
        return lines

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        where = "" if self.rank is None else f", rank {self.rank} over {self.backend}"
        return f"Mesh({axes}{where})"

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis``."""
        if self.rank is None:
            raise RuntimeError(f"{self!r} has no process group")
        stride = 1
        for a in reversed(self.axis_names):
            if a == axis:
                return (self.rank // stride) % self.shape[a]
            stride *= self.shape[a]
        raise KeyError(axis)

    def _run(self, op: str, tag: str, t: torch.Tensor, axis: Optional[str]):
        """The process group of this rank's line of ``axis`` (default the
        data axis; None where the axis has one rank: the collective moves
        nothing), after recording the collective."""
        if self.rank is None:
            raise RuntimeError(f"{self!r} has no process group: it carries no collectives")
        axis = axis or self.data_axis
        if axis not in self.shape:
            raise KeyError(f"{self!r} has no axis {axis!r}")
        collective_count.record(op, tag, t, axis)
        return self._lines[axis]

    def all_reduce(self, t: torch.Tensor, tag: str, *, axis: Optional[str] = None,
                   op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="max"``: its maximum) over ``axis`` (default the
        data axis), in place; returns ``t``."""
        import torch.distributed as dist

        group = self._run("all_reduce", tag, t, axis)
        if group is not None:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            dist.all_reduce(t, op=red, group=group)
        return t

    def all_gather(self, t: torch.Tensor, tag: str, *, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """The 1-D ``t`` of every rank of ``axis``'s line (default the data
        axis), concatenated in coordinate order (``n * numel``)."""
        import torch.distributed as dist

        group = self._run("all_gather", tag, t, axis)
        x = t.reshape(-1).contiguous()
        if group is None:
            return x.clone()
        out = torch.empty(self.shape[axis or self.data_axis] * x.numel(), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    def reduce_scatter(self, t: torch.Tensor, tag: str, *, axis: Optional[str] = None
                       ) -> torch.Tensor:
        """The 1-D ``t`` summed over ``axis``'s line (default the data axis),
        this rank's ``1/n`` of it (chunk ``coordinate`` of ``n`` equal chunks,
        ``numel / n``)."""
        import torch.distributed as dist

        group = self._run("reduce_scatter", tag, t, axis)
        x = t.reshape(-1).contiguous()
        if group is None:
            return x.clone()
        out = torch.empty(x.numel() // self.shape[axis or self.data_axis], dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
        return out

    def broadcast(self, t: torch.Tensor, tag: str, *, axis: Optional[str] = None
                  ) -> torch.Tensor:
        """``t`` of the first rank (coordinate 0) of ``axis``'s line (default
        the data axis) on every rank of it, in place; returns ``t``."""
        import torch.distributed as dist

        group = self._run("broadcast", tag, t, axis)
        if group is not None:
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    def barrier(self) -> None:
        """Every rank of the mesh."""
        import torch.distributed as dist

        if self.rank is None:
            raise RuntimeError(f"{self!r} has no process group: it carries no collectives")
        dist.barrier(group=self.group)


def default_backend(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: str, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: Optional[str] = None,
                     timeout: float = 600.0) -> None:
    """``torch.distributed.init_process_group`` with an explicit backend and a
    time limit (seconds).  Without ``init_method`` the rendezvous comes from
    the environment a launcher such as ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if init_method is None and "RANK" not in os.environ:
        raise RuntimeError(
            "no process group to join: start the ranks with a launcher, e.g. "
            "torchrun --nproc-per-node N -m repro_torch.launch.train ... --mesh data=N")
    where = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout), **where)


def _world_mesh(shape: Sequence[int], axes: Sequence[str], backend: Optional[str]) -> Mesh:
    import torch.distributed as dist

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, and no process "
                           "group is initialised (init_distributed, or run under torchrun)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, found {world}")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise RuntimeError(f"the process group runs {have!r}, the mesh asks for {backend!r}")
    group = dist.group.WORLD if world == n else dist.new_group(list(range(n)))
    if world > n and dist.get_rank() >= n:
        raise RuntimeError(f"rank {dist.get_rank()} lies outside the {n}-rank mesh")
    return Mesh(shape, axes, group=group, backend=have)


def make_data_mesh(n_shards: int, axis: str = "data", backend: Optional[str] = None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``n_shards`` ranks of the
    initialised process group (whose backend must be ``backend`` when one
    is named)."""
    return _world_mesh((n_shards,), (axis,), backend)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), backend: Optional[str] = None) -> Mesh:
    """A small mesh over the first ``prod(shape)`` ranks, (data=2, model=2)
    by default; raises when the world is smaller.  ``Trainer(mesh=)`` trains
    the dense family on it: data parallelism over ``data`` and tensor
    parallelism over ``model``."""
    return _world_mesh(tuple(shape), tuple(axes), backend)


def make_production_mesh(*, multi_pod: bool = False, backend: Optional[str] = None) -> Mesh:
    """The JAX package's pod mesh, (data=16, model=16) or (pod=2, data=16,
    model=16); raises when the world is smaller (it is 256 or 512 ranks).
    Its one-pod shape is a (data, model) mesh as :func:`make_debug_mesh`'s;
    the two-pod one splits a dim over ``("pod", "data")``, which the port's
    parameter rules do not place yet (ROADMAP queue 1 item 5d)."""
    shape, axes = PRODUCTION_SHAPE[multi_pod]
    return _world_mesh(shape, axes, backend)


def parse_mesh(spec: str) -> list[tuple[str, int]]:
    """``"data=2"`` or ``"data=2,model=1"`` -> ``[("data", 2), ("model", 1)]``."""
    out = []
    for part in spec.split(","):
        axis, _, size = part.partition("=")
        if not axis or not size.strip().isdigit():
            raise ValueError(f"bad mesh spec {spec!r}: expected axis=N[,axis=N]")
        out.append((axis.strip(), int(size)))
    return out


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------


def _tail(path: str, limit: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return ""


def run_local_ranks(target: str, n: int, *, args: tuple = (), workdir: str,
                    backend: str = "gloo", timeout: float = 300.0, threads: int = 1,
                    extra_path: Sequence[str] = (),
                    env: Optional[dict] = None) -> list[Any]:
    """Run ``target`` (``"module:function"``) in ``n`` fresh processes of
    this Python, ranks ``0 .. n-1`` of one ``backend`` process group that
    meet through a file store in ``workdir``; each calls ``fn(mesh, *args)``
    on a data mesh of ``n`` and the rank's return value comes back (a list
    in rank order, through ``torch.save`` files in ``workdir``).  ``fn`` may
    build other meshes over ``mesh.group`` (every rank alike, e.g. (2, 2)
    and (1, 4) over 4 ranks).

    ``timeout`` (seconds) bounds the whole run and the group's own
    collectives; a rank that exits non-zero or outlives it ends every rank
    and raises with the tail of that rank's output.  Each rank runs
    ``threads`` intra-op threads.  ``extra_path`` goes in front of the
    children's ``PYTHONPATH`` (the directory that holds ``target``'s
    module), after the directory that holds ``repro_torch``."""
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "ranks_spec.pkl")
    store = os.path.join(workdir, "ranks_store")
    if os.path.exists(store):
        os.remove(store)
    with open(spec, "wb") as f:
        pickle.dump({"target": target, "args": args, "n": n, "backend": backend,
                     "timeout": timeout, "threads": threads, "store": store}, f)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [src, *extra_path] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, logs = [], []
    try:
        for k in range(n):
            log = os.path.join(workdir, f"rank_{k}.log")
            logs.append(log)
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.mesh", "--worker", spec,
                     "--rank", str(k)], stdout=out, stderr=subprocess.STDOUT, env=child_env))
        deadline = time.monotonic() + timeout
        pending = set(range(n))
        while pending:
            for k in sorted(pending):
                rc = procs[k].poll()
                if rc is None:
                    continue
                pending.discard(k)
                if rc != 0:
                    raise RuntimeError(f"rank {k} of {n} exited with {rc}:\n{_tail(logs[k])}")
            if pending and time.monotonic() > deadline:
                k = min(pending)
                raise TimeoutError(f"rank {k} of {n} ran past {timeout} s:\n{_tail(logs[k])}")
            if pending:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(workdir, f"rank_{k}.pt"), weights_only=False)
            for k in range(n)]


def _worker(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    n = spec["n"]
    init_distributed(spec["backend"], rank=rank, world_size=n,
                     init_method=f"file://{spec['store']}", timeout=spec["timeout"])
    try:
        mesh = make_data_mesh(n, backend=spec["backend"])
        module, _, name = spec["target"].partition(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, *spec["args"])
        out = os.path.join(os.path.dirname(spec_path), f"rank_{rank}.pt")
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.mesh",
                                 description="one rank of run_local_ranks")
    ap.add_argument("--worker", required=True, help="the spec file run_local_ranks wrote")
    ap.add_argument("--rank", type=int, required=True)
    a = ap.parse_args(argv)
    _worker(a.worker, a.rank)


if __name__ == "__main__":
    main()
