"""Roofline terms on the H100 and the analytic model FLOPs (the model side of
the JAX package's ``launch/roofline.py``).

* The card's peak rates (NVIDIA's H100 SXM data sheet, dense), the
  constants every kernel bound of ``chip_smoke.py`` and the tools divide
  by.  They are the rates of an "NVIDIA H100 80GB HBM3" at its 700 W power
  limit, as ``nvidia-smi --query-gpu=name,power.limit`` reports the card;
  a card set below 700 W runs slower under load.
* :func:`count_params` and :func:`model_flops`: the reference's analytic
  parameter count (6·N·D training, 2·N·D inference; MoE counts the active
  experts), pure Python over a model config; :func:`model_flops_per_device`
  divides them over a mesh's D·T devices.
* :class:`RooflineReport` / :func:`roofline_report`: the reference's
  arithmetic (each term a count over a rate, the bottleneck the largest
  term, the model's share of the counted FLOPs) over these rates.

The reference's HLO side — ``parse_hlo``, ``analyze_hlo``,
``roofline_from_text`` and ``xla_cost_dict``, which count FLOPs and bytes
in XLA's optimized HLO text — has no counterpart: the port compiles no
HLO.  Its TPU v5e constants are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# --- NVIDIA H100 80GB HBM3 (SXM), 700 W: peak rates per card ---
# fp32 outside the tensor cores.
PEAK_FP32_FLOPS = 67e12
# HBM3 bandwidth, bytes/s.
PEAK_BYTES = 3.35e12
# TF32 on the tensor cores.  Every kernel computes its fp32-accurate
# products there by 3xTF32, three TF32 products for each fp32 one (the five
# GEMM kernels on one core, csrc/tf32x3_gemm.cuh, flash_attention and
# ssd_scan), so their bound is 3 x flops over this peak.
PEAK_TF32_FLOPS = 495e12
# BF16 and FP16 on the tensor cores, twice TF32's rate.
PEAK_BF16_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class Shape:
    """A workload shape, the fields of the reference's ``ShapeConfig`` that
    :func:`model_flops` reads: ``kind`` is train | prefill | decode."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count from the config (matches init to ~1%)."""
    d, L = cfg.d_model, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    n = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    gated = cfg.act in ("swiglu", "geglu")
    mlp_mult = 3 if gated else 2

    def attn_p():
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    def mlp_p(ff):
        return mlp_mult * d * ff

    if cfg.family in ("dense", "audio", "vlm"):
        per = attn_p() + mlp_p(cfg.d_ff)
        n += L * per
        if cfg.family == "vlm":
            G = L // cfg.cross_attn_every
            n += G * (attn_p() + mlp_p(cfg.d_ff))  # cross blocks
    elif cfg.family == "moe":
        E, k = cfg.n_experts, cfg.top_k
        moe_layers = L // cfg.moe_every
        dense_layers = L - moe_layers
        n += L * attn_p() + dense_layers * mlp_p(cfg.d_ff)
        expert = mlp_mult * d * (cfg.moe_dff or cfg.d_ff)
        n_all = moe_layers * (E * expert + cfg.n_shared_experts * expert + d * E)
        n_act = moe_layers * (k * expert + cfg.n_shared_experts * expert + d * E)
        n += n_act if active_only else n_all
    elif cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * d
        Hs = d_inner // cfg.ssm_headdim
        in_dim = 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + Hs
        per = d * in_dim + d_inner * d
        n += L * per
        if cfg.family == "hybrid":
            n += attn_p() + mlp_p(cfg.d_ff)  # one shared block
    return float(n)


def model_flops(cfg, shape) -> float:
    """6·N·D for training; 2·N·D for a prefill; 2·N per sequence for a
    decode step (one token each)."""
    n = count_params(cfg, active_only=(cfg.family == "moe"))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def model_flops_per_device(cfg, shape, mesh=None) -> float:
    """:func:`model_flops` of the whole step over the devices of ``mesh``
    (anything with ``shape[axis]``; None is one device): D·T on a (data,
    model) mesh, since each data line's ranks take its rows and each model
    line's ranks a 1/T share of every layer's products."""
    n = 1
    for size in (mesh.shape.values() if mesh is not None else ()):
        n *= int(size)
    return model_flops(cfg, shape) / n


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    per_collective: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_flops_frac: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_report(flops: float, hbm_bytes: float, *, collective_bytes: float = 0.0,
                    per_collective: Optional[dict] = None, model_flops_per_device: float = 0.0,
                    peak_flops: float = PEAK_BF16_FLOPS,
                    link_bytes_per_s: Optional[float] = None) -> RooflineReport:
    """The reference's roofline arithmetic on counted FLOPs and bytes:
    compute = flops / ``peak_flops`` (the rate of the products' type),
    memory = bytes / :data:`PEAK_BYTES`, collective = bytes /
    ``link_bytes_per_s`` (0 without a link rate), the bottleneck the
    largest term, and the model's share of the counted FLOPs."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / PEAK_BYTES
    collective_s = collective_bytes / link_bytes_per_s if link_bytes_per_s else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return RooflineReport(
        flops=flops, hbm_bytes=hbm_bytes, collective_bytes=collective_bytes,
        per_collective=dict(per_collective or {}), compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=max(terms, key=terms.get),
        model_flops=model_flops_per_device,
        useful_flops_frac=(model_flops_per_device / flops) if flops else 0.0)
