"""The training loop over the synthetic stream, with periodic checkpoints
and exact resume (the port of the JAX package's ``train/trainer.py``; its
resilience, telemetry and mesh are not ported).

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
* the NaN/Inf guard of the step (``update_applied``) and a
  :class:`StepTimeMonitor` of straggling steps.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.core import OptimizerConfig, build_optimizer, resolve_rank_policy
from repro_torch.core.api import Transform
from repro_torch.core.rank_policy import RankPolicyController
from repro_torch.data import DataConfig, build_stream
from repro_torch.launch.devices import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import Transformer


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
    losses: list[float]            # the applied steps of this run, in order
    skipped_nonfinite: int
    straggler_steps: list[tuple[int, float]]
    resumed_from: Optional[int]
    # Host wall time of each step of this run, ending in a device
    # synchronise (checkpoint saves excluded).
    step_seconds: list[float]


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
        state from the checkpoint instead.  A model whose parameters are
        stored below fp32 (``ModelConfig.param_dtype``) raises: the
        reference trains such leaves with fp32 optimizer states, which the
        port does not yet."""
        if model.cfg.param_dtype != "float32":
            raise NotImplementedError(
                f"training a model with ModelConfig.param_dtype={model.cfg.param_dtype!r} is "
                "not ported to the PyTorch package yet (serving is)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.opt_cfg = opt_cfg
        self.run = run_cfg
        self.data_cfg = data_cfg
        self.microbatches = microbatches
        if params is not None:
            self.model.load_params(params)
        else:
            self.model.init_params(run_cfg.seed)
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep_ckpts)
        self.monitor = StepTimeMonitor()
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
                    period=opt_cfg.period, default_rank=opt_cfg.rank)
                optimizer = self.rank_ctrl.transform()
        self._set_optimizer(optimizer if optimizer is not None else build_optimizer(opt_cfg))

    def _set_optimizer(self, optimizer: Transform) -> None:
        self.optimizer = optimizer
        self.step_fn = make_train_step(self.model, optimizer, grad_clip=self.run.grad_clip,
                                       microbatches=self.microbatches)

    def _ckpt_extra(self) -> Optional[dict]:
        if self.rank_ctrl is None:
            return None
        return {"rank_policy": self.rank_ctrl.state_dict()}

    def _save(self, step: int, params: dict, opt_state) -> None:
        self.ckpt.save(step, ({k: p.detach() for k, p in params.items()}, opt_state),
                       extra=self._ckpt_extra())

    def _resume_step(self) -> Optional[int]:
        """The step to resume from (None: start afresh)."""
        if not self.run.resume:
            return None
        latest = self.ckpt.latest_verified_step()
        newest = self.ckpt.latest_step()
        if newest is not None and newest != latest:
            print(f"checkpoint: newest committed step {newest} failed verification — "
                  f"resuming from last verified {latest}", flush=True)
        return latest

    def train(self, steps: Optional[int] = None) -> TrainResult:
        steps = steps or self.run.steps
        stream = build_stream(self.data_cfg)
        params = self.model.params()
        detached = {k: p.detach() for k, p in params.items()}
        start_step = resumed_from = self._resume_step()
        if resumed_from is not None and self.rank_ctrl is not None:
            # The controller's state sets the optimizer state's shapes, so it
            # is rebuilt from the saved extras before the restore template.
            extra = self.ckpt.read_extra(resumed_from)
            if "rank_policy" in extra:
                self.rank_ctrl.load_state_dict(extra["rank_policy"])
                self._set_optimizer(self.rank_ctrl.transform())
        opt_state = self.optimizer.init(detached)
        if resumed_from is not None:
            (saved, opt_state), _ = self.ckpt.restore(resumed_from, (detached, opt_state))
            with torch.no_grad():  # in place: the step updates these tensors
                for k, p in params.items():
                    p.copy_(saved[k])
            stream.resume(resumed_from)  # exact skip-ahead
        else:
            start_step = 0

        losses, seconds, skipped = [], [], 0
        cuda = self.device.type == "cuda"
        for step in range(start_step, steps):
            t0 = time.perf_counter()  # the step's time includes a migration
            if self.rank_ctrl is not None:
                opt_state, changed = self.rank_ctrl.maybe_update(opt_state, detached)
                if changed:
                    self._set_optimizer(self.rank_ctrl.transform())
            tokens = torch.from_numpy(next(stream)).to(self.device)
            opt_state, metrics = self.step_fn(params, opt_state, {"tokens": tokens})
            loss = float(metrics["loss"])
            if cuda:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            seconds.append(dt)
            self.monitor.record(step, dt)
            if metrics["update_applied"]:
                losses.append(loss)
            else:
                skipped += 1
            if self.run.ckpt_every and (step + 1) % self.run.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
            if self.run.log_every and (step + 1) % self.run.log_every == 0:
                print(f"[step {step + 1}] loss {loss:.4f}", flush=True)
        # The final save, unless the loop's periodic save committed this step.
        if not (self.run.ckpt_every and steps % self.run.ckpt_every == 0
                and steps > start_step):
            self._save(steps, params, opt_state)
        self.opt_state = opt_state
        return TrainResult(final_step=steps, losses=losses, skipped_nonfinite=skipped,
                           straggler_steps=self.monitor.flagged, resumed_from=resumed_from,
                           step_seconds=seconds)
