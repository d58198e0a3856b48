"""The training loop over the synthetic stream, with periodic checkpoints,
exact resume, the resilience subsystem, telemetry and data parallelism (the
port of the JAX package's ``train/trainer.py``).

* **resume** (``RunConfig.resume``): from the newest *verified* committed
  checkpoint in ``RunConfig.ckpt_dir`` — a newest step that fails
  verification is skipped with a warning — and the data stream skips ahead
  to it, so N steps plus N resumed steps equal 2N steps bitwise;
* **checkpoints**: parameters and optimizer state every
  ``RunConfig.ckpt_every`` steps and once at the end (unless the periodic
  save just committed that step), keeping ``RunConfig.keep_ckpts``;
* **rank policy** (``OptimizerConfig.rank_policy``, factory path only): a
  :class:`~repro_torch.core.rank_policy.RankPolicyController` consulted
  before each step; a rank change migrates the optimizer state and rebuilds
  the step, and the controller's state rides in every checkpoint's extras,
  so resume is exact across the change;
* **health monitor and recovery ladder** (``resilience=``): windowed
  detectors over the step's loss, raw gradient norm and low-rank update
  norm, with the straggler :class:`StepTimeMonitor`, feed the
  :class:`~repro_torch.resilience.RecoveryController`: skip → forced
  off-cycle projector refresh → rollback to an in-memory snapshot ring
  (parameters, optimizer state, rank-policy extras) → restore of the last
  verified checkpoint; every event lands in :class:`TrainResult`;
* **fault injection** (``inject=``): a seeded
  :class:`~repro_torch.resilience.FaultPlan` arms gradient corruption,
  projector sabotage, checkpoint corruption and mid-save kills;
* **telemetry** (``telemetry=``, ``events_out=``): one schema-versioned
  ``events.jsonl`` per run — ``loss`` and ``grad_norm`` every ``every``
  steps, per-family ``rank`` / ``energy`` / ``drift`` / ``bias`` at each
  refresh step (with ``OptimizerConfig.telemetry``), the ``gamma_slots``
  distribution, every event, the ``step`` (tagged refresh / steady),
  ``rank_migration`` and ``ckpt_save`` spans, and the closing counters;
* a **profiler window** (``profile_steps="A:B"``): ``torch.profiler`` over
  steps [A, B), each step marked ``step N``, exported as a Chrome trace
  under ``<ckpt_dir>/profile/``;
* the NaN/Inf guard of the step (``update_applied``);
* a **data mesh** (``mesh=``, :class:`repro_torch.launch.mesh.Mesh`): this
  process is one rank; it trains on its rows ``[k·B/n, (k+1)·B/n)`` of the
  batch the one-process run draws, the gradients and loss are averaged over
  the ranks in fp32 (one all-reduce each a step), and the parameters stay
  replicated, or with ``shard_params`` are split by ``sharding.PARAM_RULES``
  as the reference's pjit step splits them (the numbers are the same).  With
  ``OptimizerConfig(shard_state=True, fuse_families=True)`` the
  family-stacked low-rank state is split over the ranks
  (``combinators.family_sharding``); checkpoints still hold the whole
  state.  Only rank 0 prints, writes the run log and writes checkpoints.
  Every decision (the NaN guard, the health monitor, the recovery ladder,
  the rank policy) reads reduced values, so the ranks decide alike; the
  straggler detector, which reads each rank's own clock, is off.
* the **startup audit**: before the first step of each ``train()`` one
  ``audit`` event, ``audit[gum]: launches/step=...
  proj_state=...B sig=...`` (:func:`repro_torch.analysis.audit_summary`),
  and with telemetry the ``launch_crosscheck`` event (the dispatch counts of
  one traced update against the closed-form launch model); on a mesh, after
  the first applied step, one ``audit`` event of the parameters written in
  place and the rows each rank trained on (RA604 / RA605), with a ``warn``
  event per finding.  The traces run on ``meta`` copies and draw nothing,
  so the run's losses and parameters are bitwise those of a run without
  them; a failure is one ``warn`` event and training goes on.

Every console line is an event on the telemetry bus, which always exists:
with telemetry off it carries only the stdout sink, which renders an event
as the reference does, ``step {step:6d} {detail}`` (bare ``detail`` where
it has no step), with the reference's names, severities and details.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import statistics
import time
from typing import Optional

import torch

from repro_torch.analysis import audit_summary
from repro_torch.analysis.buffers import (
    inplace_findings,
    param_versions,
    param_writes,
    replication_findings,
)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.core import OptimizerConfig, build_optimizer, resolve_rank_policy
from repro_torch.core.api import Transform
from repro_torch.core.rank_policy import RankPolicyController
from repro_torch.core.combinators import (
    param_parts,
    shard_family_state,
    strip_slot_projectors,
)
from repro_torch.data import DataConfig, build_stream
from repro_torch.launch.devices import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import ParamSplit, paths_map, zip_map
from repro_torch.resilience import (
    FaultGate,
    FaultPlan,
    HealthMonitor,
    RecoveryController,
    ResilienceConfig,
    SnapshotRing,
    force_refresh,
    poison_projectors,
)
from repro_torch.telemetry import (
    GammaSlotTracker,
    JsonlSink,
    MemorySink,
    StdoutSink,
    Telemetry,
    TelemetryConfig,
    launch_crosscheck,
    lowrank_family_metrics,
)


class StepTimeMonitor:
    """Flags straggling steps: wall time > mean + z·std over a window."""

    def __init__(self, window: int = 50, z: float = 3.0, min_samples: int = 10):
        self.times = collections.deque(maxlen=window)
        self.z = z
        self.min_samples = min_samples
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= self.min_samples:
            mu = statistics.fmean(self.times)
            sd = statistics.pstdev(self.times) or 1e-9
            if dt > mu + self.z * sd:
                is_straggler = True
                self.flagged.append((step, dt))
        self.times.append(dt)
        return is_straggler


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list[float]            # by step; replayed steps replace rolled-back ones
    skipped_nonfinite: int
    straggler_steps: list[tuple[int, float]]
    resumed_from: Optional[int]
    # Host wall time of each executed step of this run (replays included),
    # ending in a device synchronise (snapshots and checkpoint saves excluded).
    step_seconds: list[float]
    # Resilience accounting (empty when the subsystem is off):
    health_events: list = dataclasses.field(default_factory=list)
    recovery_counts: dict = dataclasses.field(default_factory=dict)
    recovery_trace: list = dataclasses.field(default_factory=list)
    fault_log: list = dataclasses.field(default_factory=list)
    # Path of the run's events.jsonl (None when telemetry is off).
    events_path: Optional[str] = None


# The step's metrics the trainer reads on the host, in one copy.
_SCALARS = ("loss", "grad_norm", "grad_norm_raw", "update_norm", "update_norm_lowrank")


class Trainer:
    def __init__(
        self,
        model: Transformer,
        opt_cfg: OptimizerConfig,
        run_cfg: RunConfig,
        data_cfg: DataConfig,
        *,
        microbatches: int = 1,
        device: Optional[str | torch.device] = None,
        optimizer: Optional[Transform] = None,
        params: Optional[dict[str, torch.Tensor]] = None,
        resilience=None,
        inject=None,
        telemetry=None,
        events_out: Optional[str] = None,
        profile_steps: Optional[str] = None,
        mesh=None,
        shard_params: bool = False,
    ):
        """``device`` defaults to the CUDA device and raises when there is
        none (pass ``device="cpu"`` for the CPU); the model moves there.
        ``microbatches`` splits each batch's rows into that many slices
        whose gradients accumulate in fp32 (:func:`make_train_step`).
        ``optimizer`` overrides the ``opt_cfg`` factory path with any
        :class:`~repro_torch.core.api.Transform` (and keeps its own rank: a
        rank policy runs on the factory path only).  ``params`` (``{path:
        tensor}``, e.g. from :func:`repro_torch.convert.params_from_jax`) is
        the initial state; without it the model is initialised from
        ``run_cfg.seed``.  A resumed run takes its parameters and optimizer
        state from the checkpoint instead.  A model whose matrices are
        stored in bf16 (``ModelConfig.param_dtype="bfloat16"``) trains as
        the reference's does: fp32 optimizer state, each update rounded
        into the bf16 leaf.

        ``resilience`` turns on the health monitor and the recovery ladder:
        True or "" for defaults, a spec string ("ring=3,snapshot_every=5"),
        or a :class:`~repro_torch.resilience.ResilienceConfig`.  ``inject``
        arms fault injection: a :class:`~repro_torch.resilience.FaultPlan`
        or its spec string ("grad_nan@5;refresh_zero@13;kill_save@20#3").

        ``telemetry`` turns on the run log: True or "" for defaults, a spec
        string ("every=10,stdout=0,memory=256"), or a
        :class:`~repro_torch.telemetry.TelemetryConfig`.  The run then
        writes ``events.jsonl`` (at ``events_out``, else the config's
        ``events``, else ``<ckpt_dir>/events.jsonl``); the console is the
        same bus's stdout sink either way.  The per-family subspace metrics
        need ``OptimizerConfig(telemetry=True)`` too.

        ``profile_steps="A:B"`` runs ``torch.profiler`` (the CPU, and the
        card when the device is CUDA) over steps [A, B) and writes a Chrome
        trace under ``<ckpt_dir>/profile/``.

        ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` over a process
        group whose every rank builds the same ``Trainer``) makes this run
        one data-parallel rank over ``mesh.data_axis``; ``data_cfg`` is the
        whole run's.  The gradients are summed over the
        ranks in fp32: on bf16-stored parameters each rank's bf16 gradient
        is cast once to fp32 and the casts are summed, so a mesh of ``n``
        ranks is the one-process run at ``microbatches=n`` (bitwise at
        2 ranks on the CPU); the reference's pjit step leaves that sum to
        XLA in bf16.  Every ``OptimizerConfig`` trains on a mesh, Fira and
        the fused epilogue under ``shard_state`` too.

        A ``model`` axis larger than 1 trains the dense family with tensor
        parallelism (:mod:`repro_torch.models.tensor_parallel`): every leaf
        whose rule names ``model`` stays split over it, the layers compute
        on the parts (Megatron's column- and row-parallel products, the
        vocab-parallel embedding and loss), the gradients are reduced over
        ``data`` as above and gathered whole over ``model``, and each rank
        applies its part of the update.  The ranks of one model line read
        the same rows (their data coordinate's); rank 0 logs and
        checkpoints.  Other families, a q-head count that the axis does not
        divide, a rank policy and another axis larger than 1 raise
        ``NotImplementedError``.

        ``shard_params=True`` (it needs ``mesh``) splits the parameters over
        the data axis by :func:`repro_torch.sharding.param_shardings` (the
        reference's ``PARAM_RULES``): each rank holds its part of every leaf
        whose rule divides (on a model axis, its part over both axes), the
        model's layer loop gathers each layer's parts
        in one all-gather and reduce-scatters its gradient in one fp32
        collective, and each rank applies its part of the update
        (:class:`repro_torch.sharding.ParamSplit`); at 2 ranks the run is
        bitwise the replicated mesh run.  ``model.params()`` then holds this
        rank's parts; :meth:`whole_params` gathers them.  Checkpoints keep
        the whole-array layout, so a replicated run's checkpoint restores
        under ``shard_params`` and the reverse.  A rank policy and the
        projected-space accumulator are not ported under it
        (``NotImplementedError``)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.opt_cfg = opt_cfg
        self.run = run_cfg
        self.mesh = mesh
        self.microbatches = microbatches
        self.shard_state = bool(opt_cfg.shard_state)
        self.is_main = True
        if shard_params and mesh is None:
            raise ValueError("shard_params splits the parameters over a mesh: give mesh=")
        if shard_params and opt_cfg.rank_policy is not None and optimizer is None:
            raise NotImplementedError("a rank policy under shard_params is not ported (ROADMAP "
                                      "queue 1 item 5k): its state migration reads whole "
                                      "parameters")
        tp = 1
        if mesh is not None:
            others = {a: n for a, n in mesh.shape.items()
                      if a not in (mesh.data_axis, "model") and n > 1}
            if others:
                raise NotImplementedError(
                    f"a mesh with {others} beside its data and model axes is not ported "
                    "(the multi-pod mesh, ROADMAP queue 1 item 5d)")
            tp = int(mesh.shape.get("model", 1))
            if tp > 1:
                from repro_torch.models import tensor_parallel

                tensor_parallel.check_family(model.cfg)
                tensor_parallel.check_heads(model.cfg, tp)
                if opt_cfg.rank_policy is not None and optimizer is None:
                    raise NotImplementedError(
                        "a rank policy on a model axis is not ported (ROADMAP queue 1 item "
                        "5k): its state migration reads whole parameters")
            if data_cfg.num_hosts != 1:
                raise ValueError("with a mesh, data_cfg is the whole run's (num_hosts=1); "
                                 "each rank takes its rows of it")
            n, k = mesh.shape[mesh.data_axis], mesh.coordinate(mesh.data_axis)
            data_cfg = dataclasses.replace(data_cfg, num_hosts=n, host_id=k)
            self.is_main = mesh.rank == 0
        if self.shard_state and (mesh is None or not opt_cfg.fuse_families):
            raise ValueError("OptimizerConfig.shard_state needs a mesh and "
                             "fuse_families=True")
        self.data_cfg = data_cfg
        if params is not None:
            self.model.load_params(params)
        else:
            self.model.init_params(run_cfg.seed)
        self.param_split: Optional[ParamSplit] = None
        if shard_params or tp > 1:
            self.param_split = ParamSplit(self.model, mesh, data=shard_params)
            self.param_split.split_params()

        # The bus always exists: with telemetry off it carries only the
        # stdout sink (the console lines); telemetry adds the JSONL sink, so
        # the console and events.jsonl are two sinks of one record stream.
        # Off rank 0 the bus has no sink at all.
        self.tele_cfg = TelemetryConfig.parse(telemetry)
        self.events_path: Optional[str] = None
        sinks = []
        if self.is_main and (self.tele_cfg is None or self.tele_cfg.stdout):
            sinks.append(StdoutSink())
        self.memory_sink: Optional[MemorySink] = None
        if self.tele_cfg is not None and self.is_main:
            path = (events_out or self.tele_cfg.events
                    or os.path.join(run_cfg.ckpt_dir, "events.jsonl"))
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            sinks.append(JsonlSink(path))
            self.events_path = path
            if self.tele_cfg.memory:
                self.memory_sink = MemorySink(self.tele_cfg.memory)
                sinks.append(self.memory_sink)
        self.tele = Telemetry(sinks, run={
            "optimizer": opt_cfg.name, "rank": str(opt_cfg.rank),
            "period": opt_cfg.period, "seed": run_cfg.seed,
            "steps": run_cfg.steps, "telemetry": self.tele_cfg is not None,
        })
        self._profile_window: Optional[tuple[int, int]] = None
        self._profiler = None
        self.trace_path: Optional[str] = None  # the profiler window's Chrome trace
        if profile_steps and self.is_main:
            a, _, b = str(profile_steps).partition(":")
            self._profile_window = (int(a), int(b))

        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep_ckpts,
                                      telemetry=self.tele)
        self.monitor = StepTimeMonitor()

        if resilience is None or resilience is False:
            self.resilience = None
            self.health = None
        else:
            self.resilience = ResilienceConfig.parse(resilience)
            self.health = HealthMonitor(self.resilience, step_monitor=self.monitor)
        self.fault_plan = FaultPlan.parse(inject) if isinstance(inject, str) else inject
        self._fault_gate = self.fault_plan.gate() if self.fault_plan is not None else None
        self.recovery: Optional[RecoveryController] = None  # built per train() run
        self._has_probes: Optional[bool] = None

        # Rank policy: rank is a shape of the optimizer state, so a change is
        # a host-side event between steps (migrate the state, rebuild the
        # step).  Only on the factory path; a hand-passed optimizer owns its
        # rank.
        self.rank_ctrl: Optional[RankPolicyController] = None
        if optimizer is None:
            policy = resolve_rank_policy(opt_cfg)
            if policy is not None:
                self.rank_ctrl = RankPolicyController(
                    policy, lambda m: build_optimizer(opt_cfg, rank_map=m),
                    period=opt_cfg.period, default_rank=opt_cfg.rank,
                    reshard=self._place if self.shard_state else None)
                optimizer = self.rank_ctrl.transform()
        self._set_optimizer(optimizer if optimizer is not None else build_optimizer(opt_cfg))

    def _set_optimizer(self, optimizer: Transform) -> None:
        self.optimizer = optimizer
        self._state_specs = None  # the split of its state, made on first use
        self.step_fn = make_train_step(self.model, optimizer, grad_clip=self.run.grad_clip,
                                       microbatches=self.microbatches,
                                       fault_gate=self._fault_gate,
                                       extra_metrics=self.resilience is not None,
                                       mesh=self.mesh, shard_state=self.shard_state,
                                       param_split=self.param_split)

    def _like(self, device=None) -> dict:
        """The parameters in their whole shapes: the live tensors, or under
        ``shard_params`` stand-ins (``meta`` by default, see
        :meth:`ParamSplit.standins`)."""
        if self.param_split is None:
            return {k: p.detach() for k, p in self.model.params().items()}
        return self.param_split.standins(device or "meta")

    def whole_params(self, device=None) -> dict:
        """Every parameter whole (under ``shard_params`` gathered from the
        ranks' parts, a leaf at a time: every rank calls it), on ``device``
        when given."""
        if self.param_split is None:
            return {k: p.detach() if device is None else p.detach().to(device)
                    for k, p in self.model.params().items()}
        return self.param_split.whole_params(device=device)

    def _init_state(self):
        """The optimizer's initial state as this rank holds it: built from
        the whole shapes, the elementwise stages' state of a split parameter
        in its part's shape (``param_parts``), the family state split under
        ``shard_state``."""
        if self.param_split is None:
            return self._place(self.optimizer.init(self._like()))
        return self._place(self.param_split.init_state(self.optimizer, self.device))

    def _place(self, opt_state):
        """A state in the whole family layout as this rank holds it (its
        share under ``shard_state``, else the state itself)."""
        if not self.shard_state:
            return opt_state
        return shard_family_state(opt_state, self.mesh)

    def _state_split(self) -> tuple:
        """The specs of the state's split leaves in the whole layout (its
        structure, ``Spec()`` where whole): all of them (the family rule
        under ``shard_state``, the elementwise stages' parts under
        ``shard_params``) and the parts' alone, the parts read off the
        shapes of an init on ``meta`` under ``param_parts``."""
        if self._state_specs is None:
            from repro_torch.core.api import tree_map
            from repro_torch.sharding import Spec, family_state_sharding

            like = self._like()
            whole = self.optimizer.init(like)
            specs = parts_only = tree_map(
                lambda x: Spec() if isinstance(x, torch.Tensor) else None, whole)
            if self.shard_state:
                specs = family_state_sharding(whole, self.mesh, self.mesh.data_axis)
            if self.param_split is not None:
                with param_parts({k: (None, self.param_split.rules.get(k))
                                  for k in self.param_split.shapes}):
                    parts = self.optimizer.init(like)
                # each leaf: the axes of its split dims (its parameter's rule,
                # read off the path it lives under), or None
                rules = self.param_split.specs

                def cut(w, part_and_path):
                    part, path = part_and_path
                    if not isinstance(w, torch.Tensor) or w.shape == part.shape:
                        return None
                    rule = next(rules[k] for k in sorted(rules, key=len, reverse=True)
                                if path.endswith(k))
                    return Spec(a if a is not None and w.shape[d] != part.shape[d] else None
                                for d, a in enumerate(rule))

                cuts = zip_map(cut, whole, zip_map(lambda p, path: (p, path), parts,
                                                    paths_map(whole)))

                def with_cuts(tree):
                    return zip_map(lambda c, spec: c or spec, cuts, tree)

                specs, parts_only = with_cuts(specs), with_cuts(parts_only)
            self._state_specs = specs, parts_only
        return self._state_specs

    def _whole(self, opt_state):
        """The whole layout of this rank's state (every rank calls it)."""
        if not self.shard_state and self.param_split is None:
            return opt_state
        from repro_torch.sharding import gather_tree

        return gather_tree(strip_slot_projectors(opt_state), self._state_split()[0],
                           self.mesh, "checkpoint")

    def _profile(self, step: int) -> None:
        """The profiler window: start before step A, stop before step B
        (``profile_steps="A:B"``), writing the Chrome trace."""
        a, b = self._profile_window
        if step == a and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self.tele.event("profile", f"profiler: trace started -> {self._trace_dir()}",
                            step=step)
        elif step == b and self._profiler is not None:
            self._export_profile()
            self.tele.event("profile", "profiler: trace stopped", step=step)
            self._profile_window = None

    def _stop_profile(self) -> None:
        """Close a window still open at the run's end (B past the last step)."""
        if self._profiler is None:
            return
        self._export_profile()
        self.tele.event("profile", "profiler: trace stopped at run end")

    def _trace_dir(self) -> str:
        return os.path.join(self.run.ckpt_dir, "profile")

    def _export_profile(self) -> None:
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self._trace_dir(), exist_ok=True)
        a, b = self._profile_window
        self.trace_path = os.path.join(self._trace_dir(), f"steps_{a}_{b}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)

    def _step_mark(self, step: int):
        """The step's range in the profiler's trace, while its window is open."""
        if self._profiler is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"step {step}")

    def _ckpt_extra(self) -> Optional[dict]:
        if self.rank_ctrl is None:
            return None
        return {"rank_policy": self.rank_ctrl.state_dict()}

    def _save(self, step: int, params: dict, opt_state) -> None:
        """Checkpoint save with the fault plan's kill hook and post-commit
        corruption events attached (no-ops without a plan)."""
        plan = self.fault_plan
        opt_state = self._whole(opt_state)
        # a leaf at a time to the host, where the files are written from
        params = self.whole_params("cpu" if self.param_split is not None else None)
        if not self.is_main:
            self.mesh.barrier()  # rank 0 has committed the step
            return
        observer = plan.save_observer(step) if plan is not None else None
        self.ckpt.save(step, (params, opt_state), extra=self._ckpt_extra(), observer=observer)
        if self.mesh is not None:
            self.mesh.barrier()
        if plan is not None:
            for ev in plan.apply_ckpt_events(self.ckpt.dir, step):
                self.tele.event("fault", f"fault-injection: {ev.kind} on the step-{step} "
                                "checkpoint", step=step, severity="warn", kind=ev.kind)

    def _resume_step(self) -> Optional[int]:
        """The step to resume from (None: start afresh)."""
        if not self.run.resume:
            return None
        latest = self.ckpt.latest_verified_step()
        newest = self.ckpt.latest_step()
        if newest is not None and newest != latest:
            self.tele.event("checkpoint", f"checkpoint: newest committed step {newest} failed "
                            f"verification — resuming from last verified {latest}",
                            severity="warn", action="resume_fallback")
        return latest

    def _load_checkpoint(self, step: int, params: dict):
        """Restore the checkpoint of ``step`` into the live ``params`` (in
        place: the step updates these tensors) and return its optimizer
        state, rebuilding the rank-policy controller (and so the state
        template's shapes) from the saved extras first."""
        if self.rank_ctrl is not None:
            extra = self.ckpt.read_extra(step)
            if "rank_policy" in extra:
                self.rank_ctrl.load_state_dict(extra["rank_policy"])
                self._set_optimizer(self.rank_ctrl.transform())
        like = self._like(self.device)
        template = self.optimizer.init(like)
        shardings = None
        if self.param_split is not None:  # each rank loads its parts of the parameters
            from repro_torch.core.api import tree_map
            from repro_torch.sharding import row_splits

            shardings = (row_splits(self.param_split.specs, self.mesh),
                         tree_map(lambda x: None, template))
        (saved, opt_state), _ = self.ckpt.restore(step, (like, template), shardings=shardings)
        _copy_into(params, saved)
        if self.param_split is not None:  # the elementwise state's parts
            from repro_torch.sharding import split_tree

            opt_state = split_tree(opt_state, self._state_split()[1], self.mesh)
        return self._place(opt_state)

    def _gather_probes(self, opt_state, step: int) -> Optional[dict]:
        """Spectrum probes for the health monitor's captured-energy floor —
        gathered only on refresh-cadence steps and only when the optimizer
        stores probes."""
        if (self.resilience is None or not self.resilience.probe_health
                or self.opt_cfg.period <= 0 or step % self.opt_cfg.period != 0):
            return None
        from repro_torch.core import find_lowrank_states, gather_probes

        if self._has_probes is None:
            self._has_probes = any(st.probes is not None
                                   for st in find_lowrank_states(opt_state))
        return gather_probes(opt_state) if self._has_probes else None

    def train(self, steps: Optional[int] = None) -> TrainResult:
        steps = steps or self.run.steps
        stream = build_stream(self.data_cfg)
        res, plan, health = self.resilience, self.fault_plan, self.health
        ring = SnapshotRing(res.ring) if res is not None else None
        recov = RecoveryController(res) if res is not None else None
        self.recovery = recov
        params = self.model.params()
        detached = {k: p.detach() for k, p in params.items()}
        start_step = resumed_from = self._resume_step()
        if resumed_from is not None:
            opt_state = self._load_checkpoint(resumed_from, params)
            stream.resume(resumed_from)  # exact skip-ahead
        else:
            start_step = 0
            opt_state = self._init_state()
        if self.is_main:
            self._startup_audit(self._like())
        mesh_check = self.mesh is not None

        loss_by_step: dict[int, float] = {}
        seconds, skipped = [], 0
        cuda = self.device.type == "cuda"
        tele, tcfg = self.tele, self.tele_cfg
        gamma_tracker = GammaSlotTracker() if tcfg is not None else None
        step = start_step
        while step < steps:
            if self._profile_window is not None:
                self._profile(step)
            with self._step_mark(step):
                t0 = time.perf_counter()  # the step's time includes a migration
                if self.rank_ctrl is not None:
                    opt_state, changed = self.rank_ctrl.maybe_update(opt_state, detached)
                    if changed:
                        self._set_optimizer(self.rank_ctrl.transform())
                        tele.record_span("rank_migration", time.perf_counter() - t0, step=step)
                        tele.event("rank_policy", f"rank-policy -> {self.rank_ctrl.current_map}",
                                   step=step, map=str(self.rank_ctrl.current_map))
                if plan is not None:
                    for ev in plan.state_events(step):
                        opt_state = poison_projectors(opt_state, ev.kind)
                        tele.event("fault", f"fault-injection: {ev.kind}", step=step,
                                   severity="warn", kind=ev.kind)
                batch = {"tokens": torch.from_numpy(next(stream)).to(self.device)}
                if mesh_check:
                    before = param_versions(params)
                if self._fault_gate is not None:
                    ev = plan.grad_event(step)
                    if ev is not None:
                        tele.event("fault", f"fault-injection: {ev.kind}", step=step,
                                   severity="warn", kind=ev.kind)
                    fault = FaultGate.armed(ev) if ev is not None else FaultGate.disarmed()
                    opt_state, metrics = self.step_fn(params, opt_state, batch, fault)
                else:
                    opt_state, metrics = self.step_fn(params, opt_state, batch)
                if mesh_check and metrics["update_applied"]:
                    mesh_check = False
                    self._mesh_audit(params, before, batch, step)
                names = [n for n in _SCALARS if n in metrics]
                scalars = dict(zip(names, torch.stack(
                    [metrics[n].to(torch.float32) for n in names]).tolist()))
                if cuda:
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                seconds.append(dt)
                loss, applied = scalars["loss"], metrics["update_applied"]
                if applied:
                    loss_by_step[step] = loss
                else:
                    skipped += 1
                refresh_step = self.opt_cfg.period > 0 and step % self.opt_cfg.period == 0
                tele.record_span("step", dt, step=step + 1,
                                 kind="refresh" if refresh_step else "steady")
                if tcfg is not None and (step + 1) % tcfg.every == 0:
                    tele.metric(step + 1, "loss", loss)
                    tele.metric(step + 1, "grad_norm", scalars["grad_norm"])
                if tcfg is not None and refresh_step:
                    self._family_metrics(step + 1, opt_state, gamma_tracker)

                report = None
                if health is not None:
                    report = health.observe(
                        step, loss=loss, applied=applied,
                        grad_norm=scalars.get("grad_norm_raw", scalars["grad_norm"]),
                        # the low-rank leaves' norm: embeddings and norms keep
                        # updating through a dead subspace and would mask it
                        update_norm=scalars.get("update_norm_lowrank"),
                        dt=dt if self.mesh is None else None,
                        probes=self._gather_probes(opt_state, step))
                    for e in report.events:
                        tele.event("health", f"health[{e.severity}] {e.kind}: {e.detail}",
                                   step=step, severity=e.severity, kind=e.kind)
                    action = recov.decide(report)
                    if action.kind == "refresh":
                        opt_state = force_refresh(opt_state, self.opt_cfg.period)
                        recov.record(action, target=step + 1)
                        health.reset()
                        tele.event("recovery", "recovery: forced off-cycle projector refresh",
                                   step=step, severity="warn", action="refresh")
                    elif action.kind in ("rollback", "restore"):
                        target, kind = None, action.kind
                        if action.kind == "rollback":
                            snap = ring.pop_latest()
                            if snap is not None:
                                if (self.rank_ctrl is not None and snap.extra
                                        and "rank_policy" in snap.extra):
                                    self.rank_ctrl.load_state_dict(snap.extra["rank_policy"])
                                    self._set_optimizer(self.rank_ctrl.transform())
                                saved, opt_state = ring.restore(snap, self.device)
                                _copy_into(params, saved)
                                target = snap.step
                        if target is None:
                            # no snapshot (or the restore rung): the last
                            # verified durable checkpoint
                            ck = self.ckpt.latest_verified_step()
                            if ck is not None:
                                opt_state = self._load_checkpoint(ck, params)
                                target, kind = ck, "restore"
                        recov.record(dataclasses.replace(action, kind=kind)
                                     if kind != action.kind else action, target=target)
                        if target is not None:
                            tele.event("recovery", f"recovery: {kind} -> step {target}",
                                       step=step, severity="warn", action=kind, target=target)
                            stream.resume(target)
                            loss_by_step = {k: v for k, v in loss_by_step.items()
                                            if k < target}
                            step = target
                            health.reset()
                            continue
                        tele.event("recovery", f"recovery: {action.kind} requested but "
                                   f"nothing restorable — continuing", step=step,
                                   severity="warn", action=action.kind)
                else:
                    self.monitor.record(step, dt)

                if (res is not None and res.snapshot_every
                        and (step + 1) % res.snapshot_every == 0 and report.status == "ok"):
                    ring.add(step + 1, detached, opt_state, extra=self._ckpt_extra())
                if self.run.ckpt_every and (step + 1) % self.run.ckpt_every == 0:
                    with tele.span("ckpt_save", step=step + 1):
                        self._save(step + 1, params, opt_state)
                if self.run.log_every and (step + 1) % self.run.log_every == 0:
                    tele.event("log", f"loss {loss:.4f}", step=step + 1)
                step += 1
        # The final save, unless the loop's periodic save committed this step
        # (a duplicate would also clobber injected post-commit corruption).
        if not (self.run.ckpt_every and steps % self.run.ckpt_every == 0
                and steps > start_step):
            with tele.span("ckpt_save", step=steps):
                self._save(steps, params, opt_state)
        self._stop_profile()
        if tcfg is not None:
            tele.emit_counters(steps)
        self.opt_state = opt_state
        return TrainResult(
            final_step=steps, losses=[v for _, v in sorted(loss_by_step.items())],
            skipped_nonfinite=skipped, straggler_steps=self.monitor.flagged,
            resumed_from=resumed_from, step_seconds=seconds,
            health_events=[e.to_json() for e in health.events] if health is not None else [],
            recovery_counts=dict(recov.counts) if recov is not None else {},
            recovery_trace=list(recov.trace) if recov is not None else [],
            fault_log=list(plan.log) if plan is not None else [],
            events_path=self.events_path)

    def _startup_audit(self, params: dict) -> None:
        """The ``audit`` event and, with telemetry, the ``launch_crosscheck``
        event of the optimizer about to train (traced on ``meta`` copies of
        ``params``); best-effort, as in the reference."""
        name = self.opt_cfg.name
        try:
            self.tele.event("audit", audit_summary(self.optimizer, params, name=name))
            if self.tele_cfg is not None:
                xc = launch_crosscheck(self.optimizer, params, name=name)
                self.tele.event(
                    "launch_crosscheck",
                    f"audit[{name}]: launch cross-check {'ok' if xc['ok'] else 'MISMATCH'} "
                    f"(traced {sum(xc['traced'].values())}/step)",
                    severity="info" if xc["ok"] else "warn",
                    expected=xc["expected"], traced=xc["traced"], unmodeled=xc["unmodeled"])
        except Exception as e:  # diagnostics only: never blocks training
            self.tele.event("audit", f"audit[{name}]: unavailable ({type(e).__name__}: {e})",
                            severity="warn")

    def _mesh_audit(self, params: dict, before: dict, batch: dict, step: int) -> None:
        """After the first applied step on a mesh: the parameters the step
        wrote in place (RA604's counterpart) and this rank's rows of the
        batch (RA605's)."""
        name, n = self.opt_cfg.name, self.mesh.shape[self.mesh.data_axis]
        writes = param_writes(params, before)
        rows = int(next(iter(batch.values())).shape[0])
        global_batch = self.data_cfg.global_batch
        done = sum(same and w > 0 for same, w in writes.values())
        self.tele.event("audit", f"audit[{name}]: mesh in place {done}/{len(writes)} "
                        f"params, {rows} rows/rank of {global_batch}", step=step + 1)
        for f in (inplace_findings(writes, where=name)
                  + replication_findings([rows], global_batch=global_batch, n_shards=n,
                                         where=name)):
            self.tele.event("audit", "  " + f.format(), step=step + 1, severity="warn")

    def _family_metrics(self, step: int, opt_state, gamma_tracker: GammaSlotTracker) -> None:
        """A refresh step's subspace metrics: rank, captured energy, drift
        and the last sampled bias per shape family, and the gamma slots."""
        for rec in lowrank_family_metrics(opt_state):
            fam = rec["family"]
            self.tele.metric(step, "rank", rec["rank"], family=fam)
            self.tele.metric(step, "energy", rec["energy"], family=fam)
            for k in ("drift", "bias"):
                if k in rec:
                    self.tele.metric(step, k, rec[k], family=fam)
        slots = gamma_tracker.observe(opt_state)
        if slots:
            self.tele.event("gamma_slots", f"gamma-slots: {len(slots)} leaves tracked",
                            step=step, leaves=slots)


def _copy_into(params: dict, src: dict) -> None:
    """Write ``src``'s values into the live parameters (the step updates
    these tensors in place, so they are never rebound)."""
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(src[k])
