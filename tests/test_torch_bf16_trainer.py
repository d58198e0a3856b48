"""Training on bf16-stored parameters against the JAX package, the larger
cases of ``tests/test_torch_bf16_train.py`` (which states the precision
rule and holds the rest), in a file of their own so that the suite's
workers share them:

(b) the ``Trainer``, 3 GUM steps, at nemotron-4-340b ``SMOKE`` and at
    llama4-maverick-400b ``SMOKE`` (trained on the reference's routing,
    recorded from its own run: a token that one bf16 ulp sends to another
    expert moves the loss by far more than rounding);
(d) resilience and telemetry on a bf16-stored GUM run: the fault, health
    and recovery traces equal the reference's, the run log record for
    record.
"""
import numpy as np
import pytest
import torch

from repro.core import OptimizerConfig as JOptimizerConfig
from repro_torch.core import OptimizerConfig, build_optimizer
from test_torch_bf16_train import SEQ, _init_params, check_trainer_case
from torch_threads import _one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "llama4-maverick-400b-a17b"])
def test_trainer_on_bf16_storage_within_references_own_distance(tmp_path_factory, arch):
    check_trainer_case(tmp_path_factory, arch, "gum", "float32")


# ----------------------------------------------------------------- (d)

BF16_REL = 2.0 ** -8  # one bf16 rounding


def _same_stream_in_bf16(got: list[dict], want: list[dict], yard: list[dict]) -> None:
    """Two run logs (``got`` the port's, ``want`` the reference's bf16-stored
    run) under the precision rule of (b): the records' kinds, names and
    steps equal, every record equal but for its values; each metric's
    values over the run (NaN where both are, at an injected NaN) no
    farther from the reference's than those lie from ``yard``, the
    reference's fp32-stored run of the same recipe and faults, but the
    clipped gradient norm, elementwise within two bf16 roundings.  The "log"
    event's rendered loss and a health event's rendered numbers are the
    metrics' (a health event's value is held by the caller)."""
    import re

    shape = [(r["kind"], r.get("name"), r.get("step")) for r in want]
    assert [(r["kind"], r.get("name"), r.get("step")) for r in got] == shape
    assert [(r["kind"], r.get("name"), r.get("step")) for r in yard] == shape
    number = re.compile(r"[-+]?\d+\.?\d*(e[-+]?\d+)?")
    series: dict = {}
    for g, w, y in zip(got, want, yard):
        if g["kind"] == "metric":
            vals = [r.pop("value") for r in (g, w, y)]
            series.setdefault(g["name"], []).append(vals)
        elif g.get("name") in ("log", "health"):
            for r in (g, w):
                r["detail"] = number.sub("_", r["detail"])
        assert g == w
    for name, vals in series.items():
        g, w, y = np.array(vals, np.float64).T
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w) & ~np.isnan(y)
        if name == "grad_norm":
            # the clipped gradients' norm: each package rounds scale·g to
            # bf16 once (the reference's clip at its gradient's dtype), so
            # each lies within one bf16 rounding of the clip's bound
            assert (np.abs(g - w)[ok] <= 2 * BF16_REL * np.abs(w[ok])).all(), (g, w)
            continue
        gap, own = np.linalg.norm((g - w)[ok]), np.linalg.norm((w - y)[ok])
        assert gap <= own, (name, gap, own)


def test_resilience_and_telemetry_on_bf16_storage(tmp_path):
    """(d): a bf16-stored GUM run with a NaN gradient skipped at step 5, a
    spike rolled back at step 9 to the snapshot of step 8, and telemetry
    on: the fault, health and recovery traces equal the reference's, and
    so does the run log (:func:`_same_stream_in_bf16`)."""
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_smoke as j_get_smoke
    from repro.data import DataConfig as JDataConfig
    from repro.models import build_model as j_build_model
    from repro.train import Trainer as JTrainer
    from test_torch_telemetry import _signature

    opt = dict(name="gum", lr=1e-3, rank=4, gamma=1, period=4, telemetry=True)
    spec = dict(resilience="ring=2,snapshot_every=4", inject="grad_nan@5;grad_spike@9*1e9",
                telemetry="stdout=0")

    def reference(param_dtype):
        jcfg = j_get_smoke("llama-60m").replace(param_dtype=param_dtype)
        jt = JTrainer(j_build_model(jcfg), JOptimizerConfig(kernel_impl="jnp", **opt),
                      JRunConfig(steps=12, ckpt_dir=str(tmp_path / param_dtype), ckpt_every=4,
                                 log_every=4, resume=False, seed=0),
                      JDataConfig(vocab=jcfg.vocab, seq_len=SEQ, global_batch=2, seed=0),
                      **spec)
        jt.monitor.z = float("inf")  # no straggler may drop a snapshot
        return jt.train()

    jr, yard = reference("bfloat16"), reference("float32")
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    from test_torch_trainer import jax_sampler as trainer_sampler

    t = Trainer(build_model(get_smoke("llama-60m").replace(param_dtype="bfloat16"),
                            device="cpu"),
                OptimizerConfig(**opt),
                RunConfig(steps=12, ckpt_dir=str(tmp_path / "port"), ckpt_every=4,
                          log_every=4, resume=False, seed=0),
                DataConfig(vocab=256, seq_len=SEQ, global_batch=2, seed=0),
                device="cpu", optimizer=build_optimizer(OptimizerConfig(**opt),
                                                        sampler=trainer_sampler),
                params=_init_params("llama-60m"), **spec)
    t.monitor.z = float("inf")
    tr = t.train()
    assert tr.fault_log == jr.fault_log == [(5, "grad_nan"), (9, "grad_spike")]
    assert [(r["step"], r["action"]) for r in tr.recovery_trace] == [(5, "skip"),
                                                                        (9, "rollback")]
    for field in ("recovery_trace", "recovery_counts", "skipped_nonfinite", "final_step"):
        assert getattr(tr, field) == getattr(jr, field), field
    assert len(tr.health_events) == len(jr.health_events)
    for got, want in zip(tr.health_events, jr.health_events):
        assert (got["step"], got["kind"], got["severity"]) == \
            (want["step"], want["kind"], want["severity"])
        assert abs(got["value"] - want["value"]) <= BF16_REL * abs(want["value"]), (got, want)
    _same_stream_in_bf16(_signature(tr.events_path, False), _signature(jr.events_path, True),
                         _signature(yard.events_path, True))
    assert {p.dtype for p in t.model.params().values()} == {torch.bfloat16, torch.float32}
