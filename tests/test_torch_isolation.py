"""The port stands alone and never falls back quietly.

* No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX,
  the JAX package ``repro`` or ``ml_dtypes`` (an AST scan of every import).
* The entry points run on CUDA unless told otherwise: without a CUDA device
  and without ``device="cpu"`` they raise.
* A CUDA path asked for on a CPU tensor raises instead of taking the plain
  version.
* The port's launch vocabulary equals the reference's.
* Each kernel module imports on its own, first in a fresh interpreter (no
  import cycle through ``repro_torch.core``).
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.kernels import launch_count as j_launch_count
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.core import OptimizerConfig
from repro_torch.data import DataConfig
from repro_torch.kernels import dispatch, launch_count
from repro_torch.kernels.lowrank_update import lowrank_update_batched
from repro_torch.models import build_model
from repro_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_scan_covers_every_subpackage():
    subpackages = {p.parent.name for p in PORT_FILES if p.name == "__init__.py"}
    assert {"checkpoint", "core", "kernels", "models", "train", "launch",
            "analysis"} <= subpackages
    assert ROOT / "src" / "repro_torch" / "launch" / "roofline.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    # ml_dtypes too: the card's machine has none (bf16 checkpoints and
    # convert.py carry bf16 as its 2-byte words)
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


KERNEL_MODULES = sorted(p.stem for p in (ROOT / "src" / "repro_torch" / "kernels").glob("*.py")
                        if p.stem != "__init__")


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_module_imports_first(module):
    run = subprocess.run([sys.executable, "-c", f"import repro_torch.kernels.{module}"],
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


def test_entry_points_need_a_device_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("llama-60m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, OptimizerConfig(name="gum", rank=4, gamma=1),
                RunConfig(steps=1, ckpt_dir=str(tmp_path)),
                DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=1))


def test_cuda_impl_on_cpu_tensors_raises():
    p, g = torch.zeros(1, 8, 2), torch.zeros(1, 8, 16)
    for call in (lambda: dispatch.lowrank_update(p, g, torch.zeros(1, 2, 16), 0.9, 1.0,
                                                 impl="cuda"),
                 lambda: dispatch.project(p, g, impl="cuda"),
                 lambda: dispatch.back_project(p, torch.zeros(1, 2, 16), impl="cuda"),
                 lambda: dispatch.back_project_epilogue(p, torch.zeros(1, 2, 16), w=g,
                                                        impl="cuda"),
                 lambda: dispatch.newton_schulz(g, impl="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_cuda_tensors_never_resolve_to_the_plain_version():
    """Resolution reads only ``x.device``, so a stand-in with a CUDA device
    shows what every op does with a CUDA tensor."""

    class _OnCuda:
        device = torch.device("cuda")

    assert dispatch.resolve_impl("auto", _OnCuda()) == "cuda"
    assert dispatch.resolve_impl("cuda", _OnCuda()) == "cuda"
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.resolve_impl("torch", _OnCuda())


def test_kernel_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels import build

    with pytest.raises(ValueError, match="CUDA"):
        build.check_operands(torch.device("cpu"), x=torch.zeros(1, 2, 2))
    # the CPU path is the plain version, by the tensors' device alone
    out = lowrank_update_batched(torch.ones(1, 4, 2), torch.ones(1, 4, 3), None, 0.0, 1.0)
    assert torch.equal(out, torch.full((1, 2, 3), 4.0))


def test_dispatch_vocabulary_equals_reference():
    assert launch_count.DISPATCH_OPS == j_launch_count.DISPATCH_OPS
    assert set(dispatch.REGISTRY) <= set(launch_count.DISPATCH_OPS)


def test_unported_knobs_raise(tmp_path):
    OptimizerConfig(shard_state=True)  # ported since: the Trainer's mesh runs it
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import build_optimizer
    from repro_torch.telemetry import MemorySink, Telemetry

    # ported since: audit=True lints the chain; a malformed one (its initial
    # rank off the declared ladder) raises ChainLintError
    from repro_torch.analysis import ChainLintError

    with pytest.raises(ChainLintError, match="RC105"):
        build_optimizer(OptimizerConfig(name="gum", rank=5, rank_ladder=(8, 16)), audit=True)
    build_optimizer(OptimizerConfig(name="gum"), audit=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)})
    # ported since: restore(shardings=) takes the per-leaf rule
    restored, _ = mgr.restore(1, {"a": torch.ones(2)}, shardings={"a": None})
    assert torch.equal(restored["a"], torch.zeros(2))
    # ported since: the telemetry knob (it builds a chain) and the manager's bus
    build_optimizer(OptimizerConfig(name="gum", telemetry=True))
    ring = MemorySink()
    CheckpointManager(str(tmp_path), telemetry=Telemetry([ring])).save(2, {"a": torch.zeros(2)})
    assert [r["data"]["action"] for r in ring.records if r["kind"] == "event"] == ["save"]
    # ported since: the rank policy and its ladder (each builds a chain)
    for knob in (dict(rank_policy="spectral:0.99"), dict(rank_ladder=(64, 128)),
                 dict(rank_policy="spectral:0.99", rank_ladder=(64, 128))):
        build_optimizer(OptimizerConfig(name="gum", **knob))
    # ported since: rank padding (a negative value is refused)
    OptimizerConfig(pad_rank_to=128)
    with pytest.raises(ValueError):
        OptimizerConfig(pad_rank_to=-1)
