"""The model side of the port's roofline (``repro_torch.launch.roofline``)
against the JAX package's ``launch/roofline.py``.

``count_params`` and ``model_flops`` are held to the reference's exactly,
for every registered arch and every shape kind; ``RooflineReport``'s
arithmetic runs on the card's constants, which are the one source of
``chip_smoke.py``'s kernel bounds.  The reference's HLO side
(``shape_bytes``, ``analyze_hlo``, ``roofline_from_text``,
``xla_cost_dict``) parses XLA's HLO text and has no counterpart.
"""
import ast
from pathlib import Path

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch.roofline import count_params as j_count_params
from repro.launch.roofline import model_flops as j_model_flops
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline
from repro_torch.launch.roofline import (
    RooflineReport,
    Shape,
    count_params,
    model_flops,
    roofline_report,
)
from repro_torch.models import build_model
from torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {name: Shape(s.name, s.seq_len, s.global_batch, s.kind)
          for name, s in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for active in (False, True):
        assert count_params(cfg, active_only=active) == j_count_params(jcfg, active_only=active)
    for name, shape in SHAPES.items():
        assert model_flops(cfg, shape) == j_model_flops(jcfg, J_SHAPES[name]), name


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_count_params_matches_the_built_model(arch):
    """The analytic count is within 1% of the parameters the port builds (on
    ``meta``: nothing allocates).  hubert-xlarge is left out: its frame
    front end is not in the formula (4.4% apart)."""
    cfg = get_config(arch)
    n = sum(p.numel() for p in build_model(cfg, device="meta").params().values())
    assert abs(count_params(cfg) / n - 1) < 0.01


def test_model_flops_dense_vs_moe():
    dense = model_flops(get_config("qwen1.5-4b"), SHAPES["train_4k"])
    # ~6 * 4B * 1M tokens ~ 2.4e16 within 2x
    assert 1e16 < dense < 6e16, dense
    moe_active = model_flops(get_config("llama4-maverick-400b-a17b"), SHAPES["train_4k"])
    # active params (~17B) not total (400B): 6*17e9*1e6 ~ 1e17
    assert 4e16 < moe_active < 3e17, moe_active


def test_roofline_report_bottleneck():
    rep = roofline_report(0.0, 0.0)
    assert rep.flops == 0 and rep.useful_flops_frac == 0.0
    # the reference test's tiny 8 x 8 dot: 1024 flops, 3 fp32 8 x 8 buffers
    rep = roofline_report(2 * 8 * 8 * 8, 3 * 8 * 8 * 4, model_flops_per_device=1024.0)
    assert rep.bottleneck == "memory"  # tiny dot is bandwidth-bound
    assert rep.compute_s == 1024 / roofline.PEAK_BF16_FLOPS
    assert rep.memory_s == 768 / roofline.PEAK_BYTES and rep.useful_flops_frac == 1.0
    big = roofline_report(1e15, 1e9, peak_flops=roofline.PEAK_TF32_FLOPS)
    assert big.bottleneck == "compute" and big.compute_s == 1e15 / 495e12
    wire = roofline_report(1.0, 1.0, collective_bytes=1e9, link_bytes_per_s=1e9,
                           per_collective={"all_reduce": 1e9})
    assert wire.bottleneck == "collective" and wire.collective_s == 1.0
    assert isinstance(wire, RooflineReport) and wire.to_dict()["per_collective"] == \
        {"all_reduce": 1e9}


def test_card_constants_are_the_smokes():
    """The H100's peak rates live in the roofline module alone: the values
    every kernel bound of chip_smoke.py was computed with, imported there,
    and no TPU constant carried over."""
    assert (roofline.PEAK_FP32_FLOPS, roofline.PEAK_BYTES, roofline.PEAK_TF32_FLOPS,
            roofline.PEAK_BF16_FLOPS) == (67e12, 3.35e12, 495e12, 989e12)
    assert not hasattr(roofline, "HBM_BW") and not hasattr(roofline, "ICI_BW")
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assigned = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    assert not {n for n in assigned if n.startswith("PEAK_")}
    imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                and node.module == "repro_torch.launch.roofline" for a in node.names}
    assert {"PEAK_FP32_FLOPS", "PEAK_BYTES", "PEAK_TF32_FLOPS", "PEAK_BF16_FLOPS"} <= imported
