"""A minimal training loop over the synthetic stream (the port of the JAX
package's ``train/trainer.py`` without checkpointing, resilience,
telemetry, rank policy or a mesh — later slices).  ``RunConfig``'s
checkpoint fields are accepted and not used yet."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.core.api import Transform
from repro_torch.data import DataConfig, build_stream
from repro_torch.launch.devices import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list[float]
    skipped_nonfinite: int
    # Host wall time of each step, ending in a device synchronise.
    step_seconds: list[float]


class Trainer:
    def __init__(
        self,
        model: Transformer,
        opt_cfg: OptimizerConfig,
        run_cfg: RunConfig,
        data_cfg: DataConfig,
        *,
        device: Optional[str | torch.device] = None,
        optimizer: Optional[Transform] = None,
        params: Optional[dict[str, torch.Tensor]] = None,
    ):
        """``device`` defaults to the CUDA device and raises when there is
        none (pass ``device="cpu"`` for the CPU); the model moves there.
        ``optimizer`` overrides the ``opt_cfg`` factory path with any
        :class:`~repro_torch.core.api.Transform`.  ``params`` (``{path:
        tensor}``, e.g. from :func:`repro_torch.convert.params_from_jax`) is
        the initial state; without it the model is initialised from
        ``run_cfg.seed``."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.opt_cfg = opt_cfg
        self.run = run_cfg
        self.data_cfg = data_cfg
        if params is not None:
            self.model.load_params(params)
        else:
            self.model.init_params(run_cfg.seed)
        self.optimizer = optimizer if optimizer is not None else build_optimizer(opt_cfg)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                        grad_clip=run_cfg.grad_clip)

    def train(self, steps: Optional[int] = None) -> TrainResult:
        steps = steps or self.run.steps
        stream = build_stream(self.data_cfg)
        params = self.model.params()
        opt_state = self.optimizer.init({k: p.detach() for k, p in params.items()})
        losses, seconds, skipped = [], [], 0
        cuda = self.device.type == "cuda"
        for step in range(steps):
            t0 = time.perf_counter()
            tokens = torch.from_numpy(next(stream)).to(self.device)
            opt_state, metrics = self.step_fn(params, opt_state, {"tokens": tokens})
            loss = float(metrics["loss"])
            if cuda:
                torch.cuda.synchronize(self.device)
            seconds.append(time.perf_counter() - t0)
            if metrics["update_applied"]:
                losses.append(loss)
            else:
                skipped += 1
            if self.run.log_every and (step + 1) % self.run.log_every == 0:
                print(f"[step {step + 1}] loss {loss:.4f}", flush=True)
        self.opt_state = opt_state
        return TrainResult(final_step=steps, losses=losses, skipped_nonfinite=skipped,
                           step_seconds=seconds)
