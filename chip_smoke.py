#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. device   — require CUDA, print the card's name and power limit, turn
                TF32 off for matmuls and convolutions;
  2. build    — compile the seven CUDA kernels from ``src/repro_torch/
                kernels/csrc`` with nvcc for sm_90a, all at once;
  3. kernels  — hold each kernel against its plain PyTorch version at the
                llama-130m shapes of GUM (rank 256, gamma 4; rows 1–5 also at
                rank 128, phase 4f's, reported beside the principal shapes,
                from a generator of their own)
                and of GaLore's family stacks, both projection sides, plus
                one ragged shape; the fused epilogue also on a bf16 W, and
                on a bf16 W at the cut that split parameters give it
                (w_in / w_gate's rows at 2 ranks, tag ``bf16_w_cut``), and
                at the model-axis cut of tensor-parallel GaLore (w_in /
                w_gate's columns over model, tag ``tp_cut``);
                Newton–Schulz's two kernels also at Muon's full-rank shapes;
                flash attention at llama-130m's prefill, a GQA short-query,
                a ragged and a padded-head-dim case, and its 16-bit
                instantiations: bf16 at chatglm3-6b's prefill, fp16 at a
                GQA shape and a ragged bf16 case, each beside SDPA in the
                same dtype; at head dim 192, nemotron-4-340b's prefill in
                bf16 and in fp32, and a ragged fp16 case at head dim 200
                (the 256 tier); bf16 at dbrx-132b's prefill (48 heads over
                8) and llama4-maverick-400b's (40 over 8); bf16 at the last
                families' inputs: zamba2-1.2b's shared block (32 heads of
                64), llama-3.2-vision-11b's self-attention (32 over 8),
                its cross-attention (unmasked over 1601 image tokens) and
                its decode's (one query over them), hubert-xlarge's (16
                heads of 80, unmasked); each 16-bit case
                held to its plain version's fp32 output before that
                version's rounding (TOL_FLASH_16); the SSD scan at
                mamba2-370m's prefill, with a ragged last chunk at the same
                widths, a ragged fp32 case and zamba2-1.2b's prefill (64
                heads, N 64, chunk 64); time kernel, plain version
                and one PyTorch call computing the same function where
                there is one, and compute the bound (over TF32's peak, the
                products counted as the kernels' 3xTF32 executes them,
                since they all run on the tensor cores; their fp32 SIMT
                bound beside; the 16-bit flash attention's over BF16's
                peak, the fastest exact products the card has for it);
  4. slice    — GUM pretraining of llama-130m at full width through the
                port's ``Trainer`` (6 steps, batch 8 x 1024 tokens, period 3,
                the config's remat: each layer recomputed in backward),
                asserting finite losses and the per-step dispatch and kernel
                launch counts; first, the peak memory and time of one
                forward+backward with remat off, "nothing" and "dots";
  4b. galore  — GaLore pretraining of llama-130m the same way, family-stacked
                with the fused back-projection epilogue;
  4c. baselines — the paper's other optimizers the same way: Muon, GoLore
                (family-stacked, fused epilogue), Fira, unbiased GaLore-Adam
                and GUM with SGDM and the rsvd projector; then the projector
                refresh alone for each of the five kinds, with the default
                noise's host draw and copy;
  4d. accumulate — llama-130m GUM (phase 4's settings) with gradient
                accumulation: the gradient of one batch at microbatches 1, 2
                and 4 (within 1e-5 per leaf, losses within 1e-6); 6 steps at
                microbatches 4 through the ``Trainer``; 6 steps of GUM's
                projected-space accumulator (``gum_accum_tools``) at 4
                microbatches with its exact per-step dispatch and launch
                counts and its reconstruction held to P Pᵀ G plus the sampled
                blocks of the full accumulation on a refresh and a steady
                step; the chunked loss (``logit_chunk`` 1024 and 256) against
                the unchunked one, with a lower peak; rows 2–3 at rank 96
                with ``pad_rank_to`` 0 and 128, equal outputs;
  4e. resume  — two uninterrupted 6-step GUM runs equal bitwise, the second
                with its step-6 checkpoint bit-flipped (``ckpt_bitflip@6``)
                and a third ``Trainer`` on its directory falling back to
                step 3 and reaching the same bits; a child process of the
                training CLI (``python -m repro_torch.launch.train``, phase
                4's settings, a checkpoint every step, ``--telemetry
                --profile-steps 4:5``) killed mid-save by ``kill_save@6#2``
                (exit -9, step 5 the newest verified, a ``.tmp`` directory
                left, its run log holding every record up to the kill and
                no counters, its trace rows 1–5 inside ``step 4``) and a
                ``Trainer`` resuming it to 6 (with the telemetry probes)
                equal to them bitwise (losses, parameters, every optimizer
                state leaf but the probes);
                then the checkpoint's save, verify and restore times and size;
  4f. rank policy — phase 4's GUM under the rank-policy engine: (a) a
                controller running ``stepwise:0=256,3=128`` over 6 updates
                of seeded gradients, per leaf and family-stacked, bitwise
                equal to a fresh rank-128 run from the first update after
                the drop; (b) the ``Trainer`` with that policy for 6 steps,
                and 4 steps + a new ``Trainer`` resuming to 6, bitwise equal
                across the rank change, with exact per-step counts at each
                rank, the migration's ms and the state's bytes before and
                after; (c) ``spectral:0.99`` over the ladder (64, 128, 256)
                for 6 steps: one more row-2 launch per leaf on each refresh
                (the spectrum probe), the card's probe of one refresh
                gradient against the CPU's (1e-4), the decided maps, and
                the probe's own cost from one profiled refresh;
  4g. resilience — the health monitor and recovery ladder at llama-130m full
                width (phase 4's data, the straggler detector off): (a) GUM,
                period 8, 14 steps, ``ring=2,snapshot_every=4``,
                ``grad_nan@5;grad_spike@10*1e9``: exactly a skip at 5 and a
                rollback at 10 to the snapshot of step 8, every loss finite,
                phase 4's dispatch and launch counts per applied step; the
                steady median with resilience on beside phase 4's, the
                snapshot's ms (device to host) and the rollback's (host to
                device into the live parameters, bitwise), and the extra
                metrics' device ms in one profiled step; (b) GaLore (phase
                4b's, period 8), 10 steps, ``refresh_zero@6``: a dead
                subspace forces a refresh at step 6 or 7, the next step
                recomputes the projectors, and the last loss is below the
                first;
  4h. telemetry — phase 4's run with ``OptimizerConfig(telemetry=True)``,
                ``Trainer(telemetry="stdout=0", profile_steps="4:6")``: the
                losses bitwise phase 4's; GUM's counts each step plus 7
                row-2 launches (the spectrum probe) on each refresh; the
                run log (loss and grad_norm each step, step spans tagged
                refresh / steady, rank / energy / drift / bias per family on
                the refresh steps, the gamma slots, counters that agree);
                ``python -m repro_torch.telemetry.report`` in a child; the
                profiler's Chrome trace holding rows 1–5's kernels (their
                ``__global__`` names read from csrc/) inside the ``step 4``
                and ``step 5`` annotations; the step times beside phase 4's;
  4i. distributed (after 4k, whose run and 4d's are twins of its last
                three) — two gloo ranks on the one card (NCCL takes one rank
                a device; gloo takes the CUDA tensors itself) train phase
                4's GUM with ``fuse_families`` through ``Trainer(mesh=)``,
                4 x 1024 rows a rank of the 8 x 1024 batch, 4 steps,
                ``shard_state`` off then on: the losses and parameters
                bitwise the one-process run at ``microbatches=2`` (the same
                fp32 sum of the two halves), the first loss within 1e-6 of
                phase 4's (the later ones printed beside it), on == off
                bitwise, each step's collectives (one fp32 gradient and one
                loss all-reduce, plus the update all-gather under
                ``shard_state``) and fused GUM's dispatches and rows 1–5's
                launches on each rank, each rank's family-state bytes
                against ``sharding.family_state_bytes``; in the same
                spawn, 3 steps each of phase 4k's bf16-stored GUM
                (family-stacked) and fused GaLore (bf16 W, weight decay
                0.01) under ``shard_state`` and of phase 4d's
                ``gum_accum_tools`` at 2 ranks x 2 microbatches: 4k's first
                loss within 1e-6, every row-6 launch of the bf16-W
                instantiation, each step's collectives at
                ``analysis.collectives``' bytes (the accumulator's refresh
                broadcast and compact gradient all-reduce), the
                accumulator within 1e-6 of 4d's run at 4 microbatches, the
                ranks equal; in the same spawn, split parameters
                (``Trainer(shard_params=True)``, FSDP by ``PARAM_RULES``):
                phase 4's GUM with ``shard_state`` off and on, 3 steps, and
                4k's fused GaLore (bf16 W, ``shard_state``), 3 steps, each
                bitwise its replicated twin of the spawn over those steps
                (or the first
                differing step reported, within 1e-6), 219061248 parameter
                bytes a rank for GUM (``per_shard_bytes``), every step's
                collectives (a layer's all-gather per layer read, its fp32
                reduce-scatter, the once leaves', the gradient parts'
                all-gather) against ``analysis.collectives``' model, row 6
                on the parts (4 launches a step: the (768, 768) family
                splits rows and columns), the peak by part of the step
                beside the twin's; then one ``make_shardmap_train_step`` step
                over a world-size-1 ``nccl`` group (bf16 gradient
                all-reduce) bitwise the no-mesh step given the same bf16
                cast.  The same spawn then also builds a (data=1,
                model=2) mesh over its two ranks and trains phase 4's GUM
                and phase 4b's fused GaLore (row 6 on the model-axis cuts)
                with tensor parallelism (Megatron-split layers, the
                vocab-parallel embedding and loss) for 3 steps each, each
                rank on all 8 x 1024 rows: the first loss within 1e-6 of
                its phase's, the later ones within ``TP_LOSS_TOL`` (1e-3),
                each parameter leaf after step 3 within 1e-3 (GUM) or 1e-2
                (GaLore) of its phase's own (``TP_TWINS``; the limits'
                basis: ``tools/tp_loss_spread.py``), the ranks' gathered
                parameters equal, 219098112 parameter bytes a rank, every
                collective (op, axis, bytes) against
                ``analysis.collectives``' model, the dispatch and launch
                counts, the peak a rank; then one forward of the trained
                GUM model at attn_impl="pallas" (row 7 on each rank's 6 of
                12 heads, 12 launches a rank) against "xla", the logits
                within 1e-4;
  4j. audit   — the static audit (``repro_torch.analysis``) at llama-130m:
                ``audit_optimizer`` of phase 4's GUM on the model's tree on
                ``meta``, clean; one real steady GUM step whose dispatch
                counts equal ``expected_launches`` and whose rows 1–5 CUDA
                launches equal those counts times each op's kernels per
                call (``ns_steps`` gram and poly_apply per Newton–Schulz,
                from ``chain_info``); a 2-step ``Trainer`` with telemetry:
                one ``audit`` event and a ``launch_crosscheck`` of ok;
                ``audit_sharded`` at ``data=8`` on a fake process group
                (its two steps on the card), per leaf and family-stacked
                with ``shard_state``: clean, wire bytes printed; phase 4's
                model TFLOP/s (``model_flops`` over its steady median);
  4k. bf16    — llama-130m stored in bf16 (``param_dtype``) with bf16
                activations, fp32 optimizer state: GUM 6 steps with phase
                4's dispatch and launch counts and rows 1–5's
                instantiations (``build.VARIANTS``), a second ``Trainer``
                resuming from the step-3 checkpoint bitwise equal to the
                run, its step, tokens/s, refresh, peak and profiled groups
                beside phase 4's; fused GaLore (weight decay 0.01) 4 steps,
                every row-6 launch of its bf16-W instantiation; a 3-step
                bf16-stored GUM run on llama-60m SMOKE on the card and on
                the CPU, each leaf within 2^-8;
  6. serve    — llama-130m: prefill 8 x 1024 at attn_impl="pallas" (12
                flash_attention launches) against "xla", then a
                continuous-batching engine of 8 slots answering 16 requests,
                two of them checked against direct decode;
  7. serve    — mamba2-370m (bf16): prefill 4 x 4096 (48 ssd_scan launches)
                against "xla" in fp32 and in bf16, then an engine of 4 slots
                and 4 requests, one checked against direct decode (cut from
                8 / 16 to keep the run under 1000 s; phase 12 checks a
                reused Mamba slot; prompts of at most 64 tokens, as in
                phases 8 and 12, to make room for phase 4k);
  8. serve    — the dense variants at their published widths, bf16
                activations and fp32 parameters, one at a time on the card,
                depth cut to a quarter to make room for phases 4i and 4j:
                chatglm3-6b (7 of 28 layers), starcoder2-7b (8 of 32) and
                qwen1.5-4b (10 of 40), each a prefill 4 x 2048 through the bf16 instantiation of flash
                attention (one launch a layer) against "xla" in fp32 and in
                bf16 on the same parameters, then an engine: chatglm3-6b's
                of 8 slots answering 9 requests (cut from 16 to make room
                for phase 4h: 252 ticks, not 450), two of them checked
                against direct decode, one in a reused slot; starcoder2-7b's
                and qwen1.5-4b's of 4 slots and 4 requests, one checked
                (``DENSE_VARIANTS``);
  9. serve    — nemotron-4-340b at full width (d 18432, 96 heads over 8,
                head dim 192, d_ff 73728, vocab 256000), depth cut to 2
                layers, parameters stored in bf16 (``param_dtype``) and bf16
                activations: first the same draws stored in fp32, alone on
                the card, prefilled once in fp32 for the reference logits;
                then prefill 1 x 4096 through flash attention's bf16
                head-dim-192 instantiation (one launch a layer) against
                "xla" in fp32 and in bf16, then an engine of 4 slots and 4
                requests, one checked against direct decode;
 10. serve    — dbrx-132b at full width (d 6144, 48 heads over 8, head dim
                128, 16 experts of d_ff 10752, top-4, vocab 100352), depth
                cut to 2 of 40 layers (7.751B parameters stored in fp32,
                31.0 GB), bf16 activations: prefill 4 x 2048 through flash
                attention's bf16 instantiation (one launch a layer)
                against "xla" in fp32 and in bf16, every compared prefill
                on the fp32 "xla" prefill's routing (each route's own
                flips printed), a second prefill bitwise equal, then an
                engine of 4 slots and 4 requests, one checked against
                direct decode, the MoE layer bitwise equal across two
                calls and a 1-slot engine equal to direct decode at batch 1;
 11. serve    — llama4-maverick-400b at full width (d 5120, 40 heads over 8,
                128 experts of d_ff 8192, top-1, a shared expert, dense
                d_ff 16384, vocab 202048), depth cut to 2 of 48 layers (one
                dense block and one MoE block; 18.679B parameters stored in
                bf16, 37.4 GB), as phase 10; its fp32 comparison runs on
                the bf16 parameters, and its bf16 distance is printed
                without a rule (no fp32-stored reference fits);
 12. serve    — zamba2-1.2b (hybrid) at full width (d 2048; one shared
                attention-and-MLP block of 32 heads of 64 after every 6th
                layer), depth cut from 38 to 19 Mamba-2 layers (the shared
                block 4 times) to keep the run under 1000 s, fp32
                parameters, bf16 activations: prefill 4 x 4096 (19 ssd_scan
                and 4 flash_attention launches) against "xla" in fp32 and
                in bf16, then an engine of 8 slots answering 9 requests (cut
                from 16 to make room for phase 4h), one of two checked in
                a reused slot (the card's check that a reused slot starts
                from an empty Mamba state);
 13. serve    — llama-3.2-vision-11b (vlm) at full width (d 4096, 32 heads
                over 8, d_ff 14336, vocab 128256), depth cut to 10 of 40
                layers (two groups of 5 self blocks and a gated
                cross-attention block), fp32 parameters, bf16 activations,
                seeded nonzero gates: prefill 4 x 2048 with images (4, 1601,
                4096) (10 causal and 2 unmasked flash_attention launches)
                against "xla" in fp32 and in bf16, fp32 decode from the
                prefill's cache against the forward, then an engine of 4
                slots and 4 requests whose every tick launches
                flash_attention once a group, one checked against direct
                decode;
 14. serve    — hubert-xlarge (audio, encoder-only) at full width and depth
                (48 layers, d 1280, 16 heads of 80), fp32 parameters, bf16
                activations: a forward of 4 x 4096 frames (48 unmasked
                flash_attention launches at D = 80, the 128 tier) against
                "xla" in fp32 and in bf16; no engine;
  5. agree    — the same trainer at the llama-60m smoke size on the card and
                on the CPU (plain versions) must give the same losses, for
                GUM, GaLore-Muon with the fused epilogue and weight decay,
                family-stacked GUM and phase 4c's optimizers and LISA; and
                the prefill logits of the smoke models (llama-60m,
                mamba2-370m, the three dense variants, nemotron-4-340b and
                its head-dim-192 variant, dbrx-132b, llama4-maverick-400b,
                zamba2-1.2b, llama-3.2-vision-11b with images and
                hubert-xlarge with frames) at attn_impl="pallas", each
                kernel launched as often as the family's layout says; and
                a 3-step GUM trainer on the moe
                SMOKE models (4-D expert leaves through kernel rows 1–5) with
                exact per-step dispatch and launch counts, the card on the
                CPU's routing.

The card's ``nvidia-smi`` name and power limit are printed first and again
third from the end; the line before the last is a JSON object describing
every kernel (launches summed over the full-width paths, each read from
counts set to 0 just before it, error, times, bound; flash attention's
bf16 instantiation beside it under "bf16", with phase 8's launches, its
bf16 head-dim-192 one under "bf16_d192", with phase 9's, and its bf16 one
at dbrx-132b's prefill under "bf16_moe", with phases 10 and 11's; the
last families' inputs under "zamba2" (the SSD scan's), "bf16_zamba2",
"bf16_vision_self", "bf16_vision_cross", "bf16_vision_decode" and
"bf16_hubert", each with the launches of it in phase 12, 13 or 14), and
the last line is
``{"ok": true, "device": {...}}``.
``--kernels-only`` stops after phase 3 (for iterating on a kernel) and
prints neither the kernels line nor the ok line.  Every training phase
writes its checkpoints under its own temporary directory and removes it.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet), one source for the port:
# repro_torch.launch.roofline.  PEAK_FP32_FLOPS is fp32 outside the tensor
# cores, PEAK_BYTES the HBM3 bandwidth.  The bound of a kernel is the larger
# of its flops over the first and its bytes (each input read once, each
# output written once) over the second.
#
# PEAK_TF32_FLOPS: TF32 on the tensor cores (dense).  Every kernel computes
# its fp32-accurate products there by 3xTF32, three TF32 products for each
# fp32 one: the five GEMM kernels on one core (csrc/tf32x3_gemm.cuh),
# flash_attention and ssd_scan.  So their bound is 3 x flops over this peak
# (and their fp32 SIMT bound is printed beside it); ssd_scan's products with
# bf16 x take two (x is exact in TF32, its low part zero: see ssd_flops).
#
# PEAK_BF16_FLOPS: BF16 and FP16 on the tensor cores (dense), twice TF32's
# rate.  The bound of the 16-bit flash attention is the function's, not the
# kernel's choice of instruction: q kᵀ on 16-bit q and k is one exact
# product at this peak (fp32 accumulation).  P·V keeps P in fp32 against
# 16-bit V; the fastest exact route the card has splits P into 16-bit parts
# that hold at least the 22 significand bits of the TF32 high/low split the
# kernel issues (two fp16 parts, 11 + 11 bits; three bf16 parts, 8 + 8 + 8,
# as the "bf16x3" product of Henry, Tang and Heinecke, ARITH 2019), each
# part one product at this peak.  That is quicker than two TF32 products
# (3 / 989 < 2 / 495).
from repro_torch.launch.roofline import (  # noqa: E402  (after the path insert)
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    PEAK_FP32_FLOPS,
    PEAK_TF32_FLOPS,
)

# max|kernel - plain| / max|plain|.  The kernels and the plain versions
# (cuBLAS) both sum in fp32, in another order, so they differ by rounding
# only: 1e-5 for one GEMM (the tensor-core GEMMs' 3xTF32 products add about
# 2^-21 relative each); a 5-step Newton-Schulz compounds ten of them through
# a cubic polynomial, 1e-4.
TOL_GEMM = 1e-5
TOL_NS = 1e-4
# Flash attention: the kernel's online softmax and the plain version's
# one-pass softmax both sum in fp32, in another order, and the kernel forms
# both products by 3xTF32: 1e-5 (the kernel's exp is expf, not the fast
# __expf).  The SSD scan sums ~N + 2·chunk
# products per output (3xTF32 too) through exponentials of cumulative sums
# and carries the state over up to 64 chunks: 1e-4.
TOL_FLASH = 1e-5
TOL_SSD = 1e-4
# Flash attention on bf16 / fp16 q, k, v: fp32 inside as in fp32, then one
# rounding of the output to the element type.  The kernel's output is held
# to the plain version's fp32 output *before* that rounding (the plain
# version on the 16-bit inputs, computed in fp32 and not rounded): one
# rounding apart.  Rounding to nearest moves a value x in [2^e, 2^(e+1)) by
# at most half a step, 2^(e-8) in bf16 (8 significand bits), and the largest
# such move relative to x, at x = 2^e + 2^(e-8), is 2^-8 (1 - 2^-8); with
# the fp32 difference of the two orders of summation (TOL_FLASH, 1e-5,
# below the 2^-16 = 1.5e-5 of slack) the sum stays under 2^-8 of the largest
# output.  fp16 the same with 11 bits: 2^-11 (1 - 2^-11) + 1e-5 is not under
# 2^-11 (its slack is 2^-22), so its bound is 2^-11 + TOL_FLASH.  Two
# *rounded* outputs could differ by a whole step where their fp32 values
# straddle a rounding boundary (2^-7 of an output in the top binade in
# bf16), which a bound of 2^-8 between them did not allow for; against the
# unrounded output no choice of inputs or of generator order can cross it.
# The bound of the 16-bit kernels counts 16-bit products at PEAK_BF16_FLOPS,
# per flop over the two halves (q kᵀ one, P·V one per part of P): bf16
# (1 + 3) / 2, fp16 (1 + 2) / 2.
TOL_FLASH_16 = {"torch.bfloat16": 2.0 ** -8, "torch.float16": 2.0 ** -11 + TOL_FLASH}
FLASH_16_PRODUCTS = {"torch.bfloat16": 2.0, "torch.float16": 1.5}

# kernel -> (source, the TPU kernel it replaces, the shared headers it is
# built on: the 3xTF32 GEMM core and the 3xTF32 helpers)
CSRC = "src/repro_torch/kernels/csrc/"
TC_GEMM = (CSRC + "tf32x3_gemm.cuh", CSRC + "tf32x3.cuh")
KERNEL_META = {
    "flash_attention": (CSRC + "flash_attention.cu", "src/repro/kernels/flash_attention.py:35",
                        (CSRC + "tf32x3.cuh",)),
    "ssd_scan": (CSRC + "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:25", TC_GEMM),
    "lowrank_update": (CSRC + "lowrank_update.cu", "src/repro/kernels/lowrank_update.py:30",
                       TC_GEMM),
    "back_project": (CSRC + "back_project.cu", "src/repro/kernels/lowrank_update.py:105",
                     TC_GEMM),
    "back_project_epilogue": (CSRC + "back_project_epilogue.cu",
                              "src/repro/kernels/fused_step.py:35", TC_GEMM),
    "gram": (CSRC + "gram.cu", "src/repro/kernels/newton_schulz.py:34", TC_GEMM),
    "poly_apply": (CSRC + "poly_apply.cu", "src/repro/kernels/newton_schulz.py:71", TC_GEMM),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers a thread, spill-store bytes) of each __global__
    function in an ``nvcc -Xptxas=-v`` log, names demangled where the
    machine has ``c++filt``."""
    rows = re.findall(r"Function properties for (\w+)\n.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers", log, re.S)
    names = [name for name, _, _ in rows]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt", *names], capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [(name.replace("(anonymous namespace)::", ""), int(regs), int(spills))
            for name, (_, spills, regs) in zip(names, rows)]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn()`` over ``iters`` calls, a
    pair of CUDA events around each, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def bounds_ms(flops: float, nbytes: float, tf32_flops: float | None = None,
              bf16_flops: float = 0.0) -> tuple[float, str, float]:
    """The least time of a kernel's work on the card, what bounds it, and
    its fp32 SIMT bound: max(products' time, bytes / HBM rate), the
    products' time being the TF32 products (``tf32_flops``, by default three
    for each of its ``flops``) over TF32's peak plus the 16-bit ones
    (``bf16_flops``) over BF16's."""
    simt = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    if tf32_flops is None:
        tf32_flops = 3 * flops
    ops = tf32_flops / PEAK_TF32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    by = "operations" if ops >= nbytes / PEAK_BYTES else "bytes"
    return max(ops, nbytes / PEAK_BYTES) * 1e3, by, simt


def rel_err(out, want) -> tuple[float, float]:
    """max|out - want| and that over max|want|; tuples compare member by
    member and give the worst of each."""
    import torch

    if isinstance(out, tuple):
        errs = [rel_err(o, w) for o, w in zip(out, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    check(out.shape == want.shape, f"shape {tuple(out.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    abs_err = float((out - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


# --------------------------------------------------------------------- phase 3


def galore_families(rank: int = 256) -> list[tuple[int, int, int, str]]:
    """(L, m, n, side) of each family stack that llama-130m's family-stacked
    GaLore step hands ``project``: ``core/family_plan.py``'s plan over the
    hidden matrices (parameters on the meta device, nothing allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.core.family_plan import build_family_plan
    from repro_torch.core.lowrank_common import default_lowrank_filter
    from repro_torch.models import build_model

    params = build_model(get_config("llama-130m"), device="meta").params()
    leaves = [p if default_lowrank_filter(k, p) else None for k, p in params.items()]
    return [(f.fs.L, f.fs.m, f.fs.n, f.fs.side)
            for f in build_family_plan(leaves, rank).families]


# Rows 1-5 at rank 128 (phase 4f's rank after its drop), at the principal
# shapes and the low-rank momenta's Newton-Schulz shape, tagged for the
# JSON line; drawn from their own generator after the other cases, which
# keep their inputs.
RANK128_CASES = dict(lu_shapes=[(12, 768, 128, 2048, "left", True, "r128"),
                         (4, 768, 128, 2048, "left", False, "r128_project")],
                     bp_shapes=[(12, 768, 128, 2048, "left", "r128")], epi_shapes=[],
                     ns_shapes=[(12, 128, 2048, "momenta_r128")])


# Rows 1-5 at phase 4l's shapes, mamba2-370m's ssm_in (n = 4384, which the
# 64-wide tiles cover raggedly): the momentum update and its back-projection
# over the 48 layers, the projection of the 4 sampled blocks, Newton-Schulz
# on the low-rank momenta (48, 256, 4384) and on the full-rank slots
# (4, 1024, 4384); reported beside each row's principal shape.
SSM_CASES = dict(lu_shapes=[(48, 1024, 256, 4384, "left", True, "ssm"),
                            (4, 1024, 256, 4384, "left", False, "ssm_project")],
                 bp_shapes=[(48, 1024, 256, 4384, "left", "ssm")], epi_shapes=[],
                 ns_shapes=[(48, 256, 4384, "ssm"), (4, 1024, 4384, "ssm_full")])


EPI_SHAPES = [(24, 768, 256, 2048, "left", True, True),
              (24, 768, 256, 2048, "left", False, False),
              (48, 768, 256, 768, "left", False, False),
              (12, 2048, 256, 768, "right", True, False),
              (12, 2048, 256, 768, "right", False, False),
              (2, 1000, 96, 1376, "left", True, False),
              (2, 1376, 96, 1000, "right", True, False),
              (2, 1000, 97, 1375, "left", True, False),
              (2, 1000, 97, 1375, "right", False, False),
              (4, 768, 4, 2048, "left", False, False),
              (4, 2048, 4, 768, "right", True, False)]


def kernel_cases(torch, gen, lu_shapes=None, bp_shapes=None, epi_shapes=None,
                 ns_shapes=None):
    """(kernel, label, kernel fn, plain fn, library fn, flops, bytes,
    principal) at the shapes GUM's and GaLore's llama-130m steps give each
    kernel; the principal case of each kernel is the one its JSON row
    reports (a string: a tag for a shape reported beside it).  The
    ``*_shapes`` arguments replace the shapes of lowrank_update,
    back_project, back_project_epilogue and gram / poly_apply."""
    from repro_torch.kernels import fused_step as fst
    from repro_torch.kernels import lowrank_update as lu
    from repro_torch.kernels import newton_schulz as nsk
    from repro_torch.kernels import ref

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = []
    beta, coeff = 0.95, 1.5

    # lowrank_update at GUM's per-leaf shapes (rank 256, gamma 4): the momentum
    # update with R of the 12-block leaves (attention 768 x 768 and mlp
    # in/gate 768 x 2048 on the left, w_out 2048 x 768 on the right, native),
    # the projection of the 4 sampled blocks, no R; GaLore's projection of
    # its three family stacks (read from the family plan); the ragged
    # llama-60m shape on both sides, and r and n not multiples of 4 (the
    # 4-byte copies); a left-side projection over m = 2048, the deepest
    # reduction, where one tensor-core accumulator over the whole sum would
    # drift past TOL_GEMM (the kernel's per-slice sums).
    if lu_shapes is None:
        lu_shapes = [(12, 768, 256, 768, "left", True, False),
                     (12, 768, 256, 2048, "left", True, True),
                     (12, 2048, 256, 768, "right", True, False),
                     (4, 768, 256, 768, "left", False, False),
                     (4, 768, 256, 2048, "left", False, False),
                     (4, 2048, 256, 768, "right", False, False),
                     (4, 2048, 256, 768, "left", False, False)]
        lu_shapes += [(L, m, 256, n, side, False, False)
                      for L, m, n, side in galore_families()]
        lu_shapes += [(2, 1000, 96, 1376, "left", True, False),
                      (2, 1376, 96, 1000, "right", True, False),
                      (2, 1000, 97, 1375, "right", True, False)]
    for L, m, r, n, side, with_r, principal in lu_shapes:
        right = side == "right"
        p, g = randn(L, n if right else m, r), randn(L, m, n)
        out_shape = (L, m, r) if right else (L, r, n)
        rs = randn(*out_shape) if with_r else None
        nbytes = 4 * (p.numel() + g.numel() + L * r * (m if right else n) * (2 if with_r else 1))
        a, b = (g, p) if right else (p.mT, g)  # the product is a @ b
        c = coeff if with_r else 1.0
        if with_r:
            lib = (lambda a=a, b=b, rs=rs: torch.baddbmm(rs, a, b, beta=beta, alpha=coeff))
        else:
            lib = (lambda a=a, b=b: torch.bmm(a, b))
        if right:  # G P = (Pᵀ Gᵀ)ᵀ
            plain = (lambda p=p, g=g, rs=rs, c=c: ref.lowrank_update_ref(
                p, g.mT, None if rs is None else rs.mT, beta, c).mT)
        else:
            plain = (lambda p=p, g=g, rs=rs, c=c: ref.lowrank_update_ref(p, g, rs, beta, c))
        bm, bn = lu.lowrank_update_tile(L, m, r, n, side)
        cases.append(("lowrank_update", f"{side} P{tuple(p.shape)} G{tuple(g.shape)} R={with_r} "
                      f"tile {bm}x{bn}",
                      (lambda p=p, g=g, rs=rs, c=c, side=side:
                       lu.lowrank_update_batched(p, g, rs, beta, c, side=side)),
                      plain, lib, 2.0 * L * r * n * m, nbytes, principal))

    # back_project: the 7 leaves' write-back (L=12) and the sampled blocks'
    # P P^T G (L=4), r=256, n in {768, 2048}, w_out (2048 x 768) on the
    # right side, native; the ragged llama-60m shape; r = 97 (4-byte
    # copies) on both sides, and r = 4 (phase 5's rank: K below one 8-deep
    # mma step, most of the one slice zero-filled).  Labels name the block
    # tile the kernel picks.
    if bp_shapes is None:
        bp_shapes = [(12, 768, 256, 768, "left", False), (12, 768, 256, 2048, "left", True),
                     (4, 768, 256, 2048, "left", False), (12, 2048, 256, 768, "right", False),
                     (4, 2048, 256, 768, "right", False), (2, 1000, 96, 1376, "left", False),
                     (2, 1000, 97, 1375, "left", False), (2, 1000, 97, 1375, "right", False),
                     (4, 768, 4, 2048, "left", False), (4, 2048, 4, 768, "right", False)]
    for L, m, r, n, side, principal in bp_shapes:
        p = randn(L, m if side == "left" else n, r)
        s = randn(*((L, r, n) if side == "left" else (L, m, r)))
        a, b = (p, s) if side == "left" else (s, p.mT)  # out = a @ b
        bm, bn = lu.back_project_tile(L, m, r, n, side)
        cases.append(("back_project",
                      f"{side} P{tuple(p.shape)} S{tuple(s.shape)} tile {bm}x{bn}",
                      (lambda p=p, s=s, side=side: lu.back_project_batched(p, s, side=side)),
                      (lambda a=a, b=b: ref.back_project_ref(a, b)),
                      (lambda a=a, b=b: torch.bmm(a, b)),
                      2.0 * L * m * n * r, 4 * (L * m * r + L * r * n + L * m * n),
                      principal))

    # back_project_epilogue: GaLore's write-back per family stack (attn
    # (48, 768, 768), mlp in/gate (24, 768, 2048), w_out (12, 2048, 768) on
    # the right side), with W (weight decay) and without, the ragged shape
    # on both sides, r = 97 and r = 4 as for back_project.  scale = -lr *
    # alpha, decay = -lr * wd.
    scale, decay = -0.0025, -1e-4
    zero = torch.zeros(1, 1, 1, device="cuda")
    if epi_shapes is None:
        epi_shapes = EPI_SHAPES
    for L, m, r, n, side, with_w, principal in epi_shapes:
        p = randn(L, m if side == "left" else n, r)
        s = randn(*((L, r, n) if side == "left" else (L, m, r)))
        w = randn(L, m, n) if with_w else None
        a, b = (p, s) if side == "left" else (s, p.mT)  # out = a @ b
        nbytes = 4 * (L * m * r + L * r * n + L * m * n * (2 if with_w else 1))
        cases.append(("back_project_epilogue",
                      f"{side} P{tuple(p.shape)} S{tuple(s.shape)} W={with_w}",
                      (lambda p=p, s=s, w=w, side=side:
                       fst.back_project_epilogue_batched(p, s, w, scale, decay, side=side)),
                      (lambda a=a, b=b, w=w: ref.back_project_epilogue_ref(a, b, w, scale, decay)),
                      (lambda a=a, b=b, w=w: torch.baddbmm(zero if w is None else w, a, b,
                                                           beta=0.0 if w is None else decay,
                                                           alpha=scale)),
                      2.0 * L * m * n * r, nbytes, principal))
    # ... and at the principal shape on a bf16-stored W (phase 4k's GaLore:
    # the bf16 instantiation reads W as stored; P, S and out fp32), tagged
    # "bf16_w", from a generator of its own (the other cases keep their
    # inputs); the library call widens W first.
    if epi_shapes is EPI_SHAPES:
        L, m, r, n = 24, 768, 256, 2048
        g6 = torch.Generator(device="cuda").manual_seed(6)
        p, s, w = (torch.randn(*shape, generator=g6, device="cuda")
                   for shape in ((L, m, r), (L, r, n), (L, m, n)))
        w = w.to(torch.bfloat16)
        cases.append(("back_project_epilogue", f"left P{tuple(p.shape)} S{tuple(s.shape)} "
                      "W=bf16",
                      (lambda p=p, s=s, w=w:
                       fst.back_project_epilogue_batched(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: ref.back_project_epilogue_ref(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: torch.baddbmm(w.float(), p, s, beta=decay,
                                                           alpha=scale)),
                      2.0 * L * m * n * r, 4 * (L * m * r + L * r * n + L * m * n) + 2 * L * m * n,
                      "bf16_w"))
        # ... and at that family's cut on split parameters (phase 4i's fused
        # GaLore under shard_params at 2 ranks: w_in and w_gate split on
        # their rows, so P's rows and W's part), tagged "bf16_w_cut"
        L, m, r, n = 24, 384, 256, 2048
        p, s, w = (torch.randn(*shape, generator=g6, device="cuda")
                   for shape in ((L, m, r), (L, r, n), (L, m, n)))
        w = w.to(torch.bfloat16)
        cases.append(("back_project_epilogue", f"left P{tuple(p.shape)} S{tuple(s.shape)} "
                      "W=bf16 (split rows)",
                      (lambda p=p, s=s, w=w:
                       fst.back_project_epilogue_batched(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: ref.back_project_epilogue_ref(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: torch.baddbmm(w.float(), p, s, beta=decay,
                                                           alpha=scale)),
                      2.0 * L * m * n * r, 4 * (L * m * r + L * r * n + L * m * n) + 2 * L * m * n,
                      "bf16_w_cut"))
        # ... and at a model-axis cut, as phase 4i's tensor-parallel GaLore
        # on (data=1, model=2) runs it: w_in / w_gate's columns over model,
        # so S's columns and W's columns (the fp32-W instantiation), tagged
        # "tp_cut"
        L, m, r, n = 24, 768, 256, 1024
        p, s, w = (torch.randn(*shape, generator=g6, device="cuda")
                   for shape in ((L, m, r), (L, r, n), (L, m, n)))
        cases.append(("back_project_epilogue", f"left P{tuple(p.shape)} S{tuple(s.shape)} "
                      "W (split columns over model)",
                      (lambda p=p, s=s, w=w:
                       fst.back_project_epilogue_batched(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: ref.back_project_epilogue_ref(p, s, w, scale, decay)),
                      (lambda p=p, s=s, w=w: torch.baddbmm(w, p, s, beta=decay, alpha=scale)),
                      2.0 * L * m * n * r, 4 * (L * m * r + L * r * n + 2 * L * m * n),
                      "tp_cut"))

    # gram / poly_apply: NS on the low-rank momenta (12, 256, n), on the
    # full slots (4, 768, n) and on Muon's full-rank momenta (12, 768, n);
    # X is Frobenius-normalised as in NS.  X Xᵀ is
    # symmetric, so the work it needs is one triangle and the diagonal:
    # s(s+1)/2 dot products of length n per member (the kernel computes the
    # tiles of one triangle and mirrors them).  Labels name the block tile
    # each kernel picks.  The low-rank momenta's (12, 256, 2048) is tagged
    # beside RANK128_CASES' (12, 128, 2048): the principal (4, 768, 2048)
    # does not depend on the rank.
    if ns_shapes is None:
        ns_shapes = [(12, 256, 768, False), (12, 256, 2048, "momenta_r256"),
                     (4, 768, 768, False), (4, 768, 2048, True), (12, 768, 768, False),
                     (12, 768, 2048, False), (2, 1000, 1376, False)]
    for L, s, n, principal in ns_shapes:
        x = randn(L, s, n)
        x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
        bm, bn = nsk.gram_tile(L, s, n)
        cases.append(("gram", f"X{(L, s, n)} tile {bm}x{bn}",
                      (lambda x=x: nsk.gram(x)), (lambda x=x: ref.gram_ref(x)),
                      (lambda x=x: torch.bmm(x, x.mT)),
                      1.0 * L * s * (s + 1) * n, 4 * (L * s * n + L * s * s), principal))
        g = ref.gram_ref(x)
        a2 = -4.7750 * g + 2.0315 * (g @ g)
        bm, bn = nsk.poly_apply_tile(L, s, n)
        cases.append(("poly_apply", f"A2{(L, s, s)} X{(L, s, n)} tile {bm}x{bn}",
                      (lambda a2=a2, x=x: nsk.poly_matmul_axpy(a2, x, 3.4445)),
                      (lambda a2=a2, x=x: ref.poly_matmul_axpy_ref(a2, x, 3.4445)),
                      (lambda a2=a2, x=x: torch.baddbmm(x, a2, x, beta=3.4445)),
                      2.0 * L * s * n * s, 4 * (L * s * s + 2 * L * s * n), principal))
    return cases


def causal_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs attention computes: under causal, query r (the
    (T - S + r)-th position) sees keys 0..T - S + r."""
    if not causal:
        return S * T
    return sum(min(T, T - S + r + 1) for r in range(S))


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int,
              x_bf16: bool) -> tuple[float, float]:
    """The work the SSD function needs, and the TF32 products that work
    takes at fp32 accuracy: C Bᵀ once per batch row and chunk (all heads
    share b and c), the causal triangle of the intra-chunk product, the
    inter-chunk product and the state update per head.  By 3xTF32 each
    product is three TF32 products, but the intra-chunk product and the
    state update have x as one operand, and bf16 x is exact in TF32 (its
    low part is zero): two there."""
    fp32_ops = x_ops = 0.0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        fp32_ops += B * 2.0 * n * n * N + B * H * 2.0 * n * N * P  # C Bᵀ, inter-chunk
        x_ops += B * H * (2.0 * P * n * (n + 1) / 2 + 2.0 * n * N * P)  # intra, state
    return fp32_ops + x_ops, 3 * fp32_ops + (2 if x_bf16 else 3) * x_ops


# A 16-bit case's plain version (by id) -> the same plain version's fp32
# output before its rounding, which the kernel is held to (TOL_FLASH_16).
UNROUNDED: dict = {}


def serving_kernel_cases(torch, gen):
    """Cases of the serving path's two kernels, in kernel_cases' form plus a
    tolerance: flash attention at llama-130m's prefill, a GQA short-query
    case (S < T, head dim 128), a ragged one and one whose head dim 20 the
    kernel pads to its k8 steps, then its 16-bit instantiations (bf16 at
    chatglm3-6b's prefill, fp16 at a GQA shape, a ragged bf16 one; their
    principal is tagged "bf16" and reported beside the fp32 one) and its
    head-dim tiers above 128 (nemotron-4-340b's prefill at D = 192 in bf16,
    tagged "bf16_d192", and in fp32; fp16 at D = 200); the SSD scan at
    mamba2-370m's prefill (bf16 x), the same widths with a ragged last chunk
    (the kernel splits P = 64 over two blocks, and the last chunk of the
    last batch row ends inside its slices), a ragged fp32 one, and
    zamba2-1.2b's prefill (64 heads, N 64, chunk 64; tagged "zamba2").  The
    last families' flash attention inputs are tagged as their phases'
    launches (TAGGED)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = []
    for B, S, T, H, KV, D, principal in [(8, 1024, 1024, 12, 12, 64, True),
                                         (2, 256, 1024, 16, 4, 128, False),
                                         (2, 1000, 1000, 12, 12, 64, False),
                                         (2, 130, 130, 4, 2, 20, False)]:
        q, k, v = randn(B, S, H, D), randn(B, T, KV, D), randn(B, T, KV, D)
        lib = None
        if principal:  # SDPA's is_causal aligns top-left: equal only for S == T
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = (lambda qt=qt, kt=kt, vt=vt:
                   F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        flops = 4.0 * D * causal_pairs(S, T, True) * B * H
        nbytes = 4 * (2 * B * S * H * D + 2 * B * T * KV * D)
        cases.append(("flash_attention", f"q{(B, S, H, D)} kv{(B, T, KV, D)} causal",
                      (lambda q=q, k=k, v=v: flash_attention(q, k, v)),
                      (lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v)),
                      lib, flops, nbytes, principal, TOL_FLASH))

    # The 16-bit instantiations, which the dense variants' bf16 prefill runs:
    # chatglm3-6b's prefill (the JSON row's "bf16" entry), fp16 at
    # starcoder2-7b's heads, and a ragged bf16 one at qwen1.5-4b's; then the
    # head-dim-192 tier at nemotron-4-340b's prefill (phase 9; the JSON row's
    # "bf16_d192" entry), the same in fp32 (phase 9's fp32 comparison
    # prefill runs it), and a ragged fp16 one at D = 200, padded to the 256
    # tier; then the moe family's prefills (phases 10, 11): dbrx-132b's
    # (48 heads over 8, group 6; the JSON row's "bf16_moe" entry) and
    # llama4-maverick-400b's (40 over 8, group 5); then the last families'
    # (phases 12–14): zamba2-1.2b's shared block (32 heads of 64, MHA;
    # "bf16_zamba2"), llama-3.2-vision-11b's self-attention (32 over 8,
    # "bf16_vision_self"), its cross-attention over the 1601 image tokens
    # (unmasked, S != T, "bf16_vision_cross") and its decode's (one query a
    # slot, "bf16_vision_decode"), and hubert-xlarge's (16 heads of 80,
    # padded to 128, unmasked, "bf16_hubert"; its work counted at D = 80).
    # SDPA in the same dtype (in 16 bits it rounds P to it, so its numbers
    # are not the kernel's) with enable_gqa beside each.  A 16-bit case's
    # plain version is timed as called and compared before its output's
    # rounding (TOL_FLASH_16).
    bf16, fp16 = torch.bfloat16, torch.float16
    for B, S, T, H, KV, D, causal, dtype, tag in [
            (4, 2048, 2048, 32, 2, 128, True, bf16, "bf16"),
            (2, 1024, 1024, 36, 4, 128, True, fp16, False),
            (2, 1000, 1000, 20, 20, 128, True, bf16, False),
            (1, 4096, 4096, 96, 8, 192, True, bf16, "bf16_d192"),
            (1, 4096, 4096, 96, 8, 192, True, torch.float32, False),
            (2, 1000, 1000, 16, 4, 200, True, fp16, False),
            (4, 2048, 2048, 48, 8, 128, True, bf16, "bf16_moe"),
            (4, 2048, 2048, 40, 8, 128, True, bf16, False),
            (4, 4096, 4096, 32, 32, 64, True, bf16, "bf16_zamba2"),
            (4, 2048, 2048, 32, 8, 128, True, bf16, "bf16_vision_self"),
            (4, 2048, 1601, 32, 8, 128, False, bf16, "bf16_vision_cross"),
            (4, 1, 1601, 32, 8, 128, False, bf16, "bf16_vision_decode"),
            (4, 4096, 4096, 16, 16, 80, False, bf16, "bf16_hubert")]:
        q, k, v = (randn(*shape).to(dtype) for shape in
                   ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flops = 4.0 * D * causal_pairs(S, T, causal) * B * H
        low = dtype != torch.float32
        cases.append(("flash_attention",
                      f"q{(B, S, H, D)} kv{(B, T, KV, D)} {'causal' if causal else 'full'} "
                      f"{str(dtype)[6:]}",
                      (lambda q=q, k=k, v=v, c=causal: flash_attention(q, k, v, causal=c)),
                      (lambda q=q, k=k, v=v, c=causal: ref.flash_attention_ref(q, k, v,
                                                                               causal=c)),
                      (lambda qt=qt, kt=kt, vt=vt, c=causal, gqa=KV != H:
                       F.scaled_dot_product_attention(qt, kt, vt, is_causal=c, enable_gqa=gqa)),
                      flops, q.element_size() * (2 * B * S * H * D + 2 * B * T * KV * D), tag,
                      *((TOL_FLASH_16[str(dtype)], 0.0, FLASH_16_PRODUCTS[str(dtype)] * flops)
                        if low else (TOL_FLASH,))))
        if low:  # held to the plain version's output before its rounding
            UNROUNDED[id(cases[-1][3])] = (lambda q=q, k=k, v=v, c=causal:
                                           ref.flash_attention_ref(q.float(), k.float(),
                                                                   v.float(), causal=c))

    for B, S, H, P, N, chunk, xdtype, principal in [
            (4, 4096, 32, 64, 128, 128, torch.bfloat16, True),
            (4, 4000, 32, 64, 128, 128, torch.bfloat16, False),
            (2, 4000, 32, 64, 128, 64, torch.float32, False),
            (4, 4096, 64, 64, 64, 64, torch.bfloat16, "zamba2")]:
        x = randn(B, S, H, P).to(xdtype)
        dt = F.softplus(randn(B, S, H) - 1.0)
        a = -torch.exp(torch.linspace(0.0, math.log(16.0), H, device="cuda"))
        b, c = randn(B, S, N), randn(B, S, N)

        def plain(x=x, dt=dt, a=a, b=b, c=c, chunk=chunk):
            G = ref.ssd_chunk_cumsum(dt, a, chunk)
            return ref.ssd_chunked_scan_ref(x, dt, G, b, c, chunk)

        nbytes = (x.element_size() * x.numel() + 4 * (dt.numel() + a.numel() + 2 * b.numel()
                                                      + B * S * H * P + B * H * N * P))
        flops, tf32_flops = ssd_flops(B, S, H, P, N, chunk, xdtype == torch.bfloat16)
        cases.append(("ssd_scan", f"x{(B, S, H, P)} {str(xdtype)[6:]} N={N} chunk={chunk}",
                      (lambda x=x, dt=dt, a=a, b=b, c=c, chunk=chunk:
                       ssd_scan(x, dt, a, b, c, chunk=chunk)),
                      plain, None, flops, nbytes, principal, TOL_SSD, tf32_flops))
    return cases


def phase_kernels(torch):
    from repro_torch.core.lowrank_common import back_project, project
    from repro_torch.core.newton_schulz import newton_schulz_plain
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.fused_step import back_project_epilogue_batched
    from repro_torch.kernels.lowrank_update import back_project_batched

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    cases = [case + (TOL_GEMM,) for case in kernel_cases(torch, gen)]
    cases += serving_kernel_cases(torch, gen)
    gen128 = torch.Generator(device="cuda").manual_seed(128)
    cases += [case + (TOL_GEMM,) for case in kernel_cases(torch, gen128, **RANK128_CASES)]
    gen_ssm = torch.Generator(device="cuda").manual_seed(4384)
    cases += [case + (TOL_GEMM,) for case in kernel_cases(torch, gen_ssm, **SSM_CASES)]
    epi_fns = {}
    for name, label, kfn, pfn, lfn, flops, nbytes, principal, tol, *tf32 in cases:
        out, want = kfn(), UNROUNDED.get(id(pfn), pfn)()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(out, want)
        check(rel <= tol, f"{name} {label}: rel err {rel:.3e} > {tol}")
        check(name != "gram" or bool(torch.equal(out, out.mT)),
              f"gram {label}: the output is not exactly symmetric")
        ms, plain_ms = time_ms(kfn), time_ms(pfn)
        lib_ms = None if lfn is None else time_ms(lfn)
        bound_ms, bound_by, simt_ms = bounds_ms(flops, nbytes, *tf32)
        check(bound_ms <= ms, f"{name} {label}: {ms:.4f} ms beats its bound {bound_ms:.4f} ms")
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f}"
        simt_txt = f" (fp32 SIMT {simt_ms:.4f})" if simt_ms != bound_ms else ""
        print(f"kernel {name:15s} {label:40s} ok  abs {abs_err:.2e} rel {rel:.2e} (tol {tol})  "
              f"ms {ms:.4f}  plain {plain_ms:.4f}  library {lib_txt}  "
              f"bound {bound_ms:.4f}{simt_txt} ({bound_by}, {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), share {bound_ms / ms:.1%}  "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        # True: the row's principal shape; a tag: an instantiation's, beside it
        found = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                     bound_by=bound_by, shape=label)
        if principal is True:
            row.update(found)
        elif principal:
            row[principal] = found | {"max_abs_err": abs_err}
        if name == "back_project_epilogue" and principal in ("bf16_w", "bf16_w_cut"):
            epi_fns[principal] = kfn

    # Row 6's launches on a bf16 W ran its bf16 instantiation (the fifth
    # template argument 1), every other launch the fp32 one; each bf16-W
    # case's own launch (one more) names its instantiation.
    epi = build.VARIANTS["back_project_epilogue"]
    bf16_w = sorted(key for key in epi if key[4] == 1)
    check(len(bf16_w) == 1 and all(len(key) == 5 for key in epi),
          f"back_project_epilogue instantiations {epi}: want one with a bf16 W")
    for tag, fn in epi_fns.items():
        before = dict(build.VARIANTS["back_project_epilogue"])
        fn()
        torch.cuda.synchronize()
        new = [key for key, n in build.VARIANTS["back_project_epilogue"].items()
               if n != before.get(key, 0)]
        check(len(new) == 1 and new[0][4] == 1,
              f"back_project_epilogue {tag}: instantiations {new}, want one with a bf16 W")
        rows["back_project_epilogue"][tag]["variant"] = list(new[0])
        print(f"back_project_epilogue {tag} instantiation {new[0]}", flush=True)
    print(f"back_project_epilogue bf16 W instantiation {bf16_w[0]} ({epi[bf16_w[0]]} "
          f"launches); fp32 W or none {sorted(key for key in epi if key[4] == 0)}", flush=True)

    # Dispatch level: both projection sides and the ragged shape, through the
    # same transposes and lead flattening the optimizer uses.
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for side, (L, m, n), r in [("left", (12, 768, 2048), 256),
                               ("right", (12, 2048, 768), 256),
                               ("left", (1, 1000, 1376), 96),
                               ("right", (1, 1376, 1000), 96)]:
        s_dim = m if side == "left" else n
        p, g = randn(L, s_dim, r), randn(L, m, n)
        st = randn(*((L, r, n) if side == "left" else (L, m, r)))
        got = dispatch.lowrank_update(p, g, st, 0.95, 2.0, side=side, impl="cuda")
        want = 0.95 * st + 2.0 * project(p, g, side)
        _, rel = rel_err(got, want)
        check(rel <= TOL_GEMM, f"dispatch lowrank_update {side} {(L, m, n)}: {rel:.3e}")
        _, rel = rel_err(dispatch.project(p, g, side=side, impl="cuda"), project(p, g, side))
        check(rel <= TOL_GEMM, f"dispatch project {side} {(L, m, n)}: {rel:.3e}")
        _, rel = rel_err(dispatch.back_project(p, st, side=side, impl="cuda"),
                         back_project(p, st, side))
        check(rel <= TOL_GEMM, f"dispatch back_project {side} {(L, m, n)}: {rel:.3e}")
        w = randn(L, m, n)
        _, rel = rel_err(dispatch.back_project_epilogue(p, st, w=w, scale=-0.5, decay=-0.01,
                                                        side=side, impl="cuda"),
                         -0.5 * back_project(p, st, side) - 0.01 * w)
        check(rel <= TOL_GEMM, f"dispatch back_project_epilogue {side} {(L, m, n)}: {rel:.3e}")
        w16 = w.to(torch.bfloat16)  # a bf16-stored W reaches the kernel uncast
        _, rel = rel_err(dispatch.back_project_epilogue(p, st, w=w16, scale=-0.5, decay=-0.01,
                                                        side=side, impl="cuda"),
                         -0.5 * back_project(p, st, side) - 0.01 * w16.float())
        check(rel <= TOL_GEMM, f"dispatch back_project_epilogue bf16 W {side} {(L, m, n)}: "
              f"{rel:.3e}")
        print(f"dispatch {side:5s} {(L, m, n)} r={r}: lowrank_update/project/back_project/"
              f"back_project_epilogue (fp32 and bf16 W) ok", flush=True)

    # The epilogue against the back-projection it replaces, at the mlp
    # family's shape (no W, as GaLore's weight decay 0 gives).
    p, s = randn(24, 768, 256), randn(24, 256, 2048)
    epi_ms = time_ms(lambda: back_project_epilogue_batched(p, s, None, -0.0025, 0.0))
    bp_ms = time_ms(lambda: back_project_batched(p, s))
    print(f"epilogue vs back_project at P(24, 768, 256) S(24, 256, 2048): "
          f"{epi_ms:.4f} ms vs {bp_ms:.4f} ms, ratio {epi_ms / bp_ms:.3f}", flush=True)

    for shape in [(12, 256, 2048), (12, 256, 768), (4, 768, 2048), (4, 2048, 768),
                  (4, 768, 768), (1, 1000, 1376)]:
        x = randn(*shape)
        out = dispatch.newton_schulz(x, impl="cuda")
        want = newton_schulz_plain(x)
        abs_err, rel = rel_err(out, want)
        check(rel <= TOL_NS, f"newton_schulz {shape}: rel err {rel:.3e} > {TOL_NS}")
        ms = time_ms(lambda x=x: dispatch.newton_schulz(x, impl="cuda"), iters=5)
        plain_ms = time_ms(lambda x=x: newton_schulz_plain(x), iters=5)
        print(f"newton_schulz {str(shape):16s} ok  abs {abs_err:.2e} rel {rel:.2e}  "
              f"ms {ms:.3f}  plain {plain_ms:.3f}", flush=True)
    torch.cuda.synchronize()
    build.reset_launches()  # comparison launches do not count
    UNROUNDED.clear()  # its closures hold this phase's inputs on the card
    return rows


# --------------------------------------------------------------------- phase 4


@contextlib.contextmanager
def scratch_dir(label: str):
    """A temporary directory (checkpoints of one phase), removed after."""
    path = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


# Each training phase's refresh-step times (ms), by label, for phases 4f,
# 4h, 4k and 4l, its steady median (ms), for phases 4g, 4h, 4k and 4l, its
# losses, for phase 4h, and for phases 4k and 4l its peak memory (GiB), its
# profiled steady step (print_groups' numbers, with that step's dispatch
# counts and kernel launches) and its launches' instantiations
# (build.VARIANTS).
REFRESH_MS: dict[str, list[float]] = {}
STEADY_MS: dict[str, float] = {}
LOSSES: dict[str, list[float]] = {}
PEAK_GIB: dict[str, float] = {}
STEP_PROFILE: dict[str, dict] = {}
PHASE_VARIANTS: dict[str, dict] = {}


def full_width_data(arch: str = "llama-130m", batch: int = 8, seq: int = 1024):
    """An arch's full config and the synthetic stream of ``batch`` x ``seq``
    tokens a step (llama-130m's 8 x 1024 by default)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig

    cfg = get_config(arch)
    return cfg, DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)


def train_full_width(torch, label: str, opt_cfg, want_dispatch: dict,
                     want_launch: dict, microbatches: int = 1, *, steps: int = 6,
                     model_changes: dict | None = None, ckpt_dir: str | None = None,
                     ckpt_every: int = 0, after_train=None,
                     data: tuple = ("llama-130m", 8, 1024),
                     snapshot: dict | None = None) -> tuple[dict, float]:
    """Pretrain ``data``'s arch (llama-130m by default) at full width and
    depth through the port's ``Trainer`` (``steps`` steps of ``data``'s
    batch x sequence, 8 x 1024 by default, period 3: refreshes at steps 1
    and 4; ``microbatches`` slices of each batch; ``model_changes`` to its
    config, e.g. bf16 storage), assert finite losses and the per-step
    dispatch and kernel launch counts, print the step times and peak memory,
    and profile one steady step.  Checkpoints go to ``ckpt_dir`` (kept) or a
    directory removed after, every ``ckpt_every`` steps (0: the config's);
    ``after_train(trainer, result)`` runs before the profiled steps move the
    parameters.  ``snapshot`` (``{"step": k}``) gets the parameters after
    step ``k`` as host tensors under ``"params"`` (copied to the host at the
    start of step ``k + 1``, a refresh step when ``k`` is 3, so the steady
    steps' times and the peak device memory hold no copy).  Records the launches' integer arguments and instantiations
    under ``label`` (``PHASE_CALLS``, ``PHASE_VARIANTS``).  Returns this
    phase's kernel launches and the peak memory (GiB) of its steps."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    period = opt_cfg.period
    cfg, data = full_width_data(*data)
    cfg = cfg.replace(**(model_changes or {}))
    model = build_model(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    keep = contextlib.nullcontext(ckpt_dir) if ckpt_dir else scratch_dir(label.replace(" ", "_"))
    with keep as ckpt_dir:
        trainer = Trainer(model, opt_cfg,
                          RunConfig(steps=steps, log_every=1, seed=0, ckpt_dir=ckpt_dir,
                                    **({"ckpt_every": ckpt_every} if ckpt_every else {})),
                          data, device="cuda", microbatches=microbatches)
        if snapshot is not None:
            inner, calls = trainer.step_fn, []

            def step_fn(params, *args):
                if len(calls) == snapshot["step"]:
                    snapshot["params"] = {k: p.detach().cpu() for k, p in params.items()}
                calls.append(None)
                return inner(params, *args)

            trainer.step_fn = step_fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        build.reset_launches()
        with launch_count.count_launches() as dispatched:
            result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        PHASE_CALLS[label] = {k: dict(v) for k, v in build.CALLS.items()}
        PHASE_VARIANTS[label] = {k: dict(v) for k, v in build.VARIANTS.items()}
        if after_train is not None:
            after_train(trainer, result)

    losses = result.losses
    print(f"{label} {cfg.name} ({n_params / 1e6:.1f}M params, {cfg.param_dtype} stored, "
          f"{cfg.dtype} activations) {opt_cfg.name} "
          f"r={opt_cfg.rank} period={period} microbatches={microbatches}: losses {losses}",
          flush=True)
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{label}: non-finite or missing losses: {losses}")
    per_step = {k: v / steps for k, v in dispatched.items()}
    check(per_step == want_dispatch,
          f"{label}: dispatch counts per step {per_step} != {want_dispatch}")
    per_step = {k: v / steps for k, v in launches.items() if v}
    check(per_step == want_launch,
          f"{label}: kernel launches per step {per_step} != {want_launch}")
    print(f"{label} dispatch per step {want_dispatch}; kernel launches per step "
          f"{want_launch}", flush=True)

    tokens = data.global_batch * data.seq_len
    steady = [t for i, t in enumerate(result.step_seconds) if i % period]
    refresh = [t for i, t in enumerate(result.step_seconds) if i % period == 0]
    steady_ms = statistics.median(steady) * 1e3
    REFRESH_MS[label] = [round(t * 1e3, 3) for t in refresh]
    STEADY_MS[label] = steady_ms
    LOSSES[label] = losses
    peak = torch.cuda.max_memory_allocated() / 2**30
    PEAK_GIB[label] = peak
    print(f"{label} step ms: all {[round(t * 1e3, 3) for t in result.step_seconds]}; "
          f"steady median {steady_ms:.3f}; refresh steps {[round(t * 1e3, 3) for t in refresh]}; "
          f"tokens/s {tokens / (steady_ms / 1e3):.0f}; max_memory_allocated {peak:.3f} GiB",
          flush=True)

    profile_steady_step(torch, label, trainer, steps)
    return launches, peak


def remat_peaks(torch) -> None:
    """Peak device memory and host time (synchronised) of one forward +
    backward of llama-130m at batch 8 x 1024 with remat off, "nothing"
    (the config's setting, which the trainer runs) and "dots"."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, lm_loss

    cfg = get_config("llama-130m")
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    params = list(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (8, 1024), generator=gen, device="cuda")
    peaks, parts = {}, []
    for label, remat, policy in [("off", False, "nothing"), ("nothing", True, "nothing"),
                                 ("dots", True, "dots")]:
        model.cfg = cfg.replace(remat=remat, remat_policy=policy)

        def fwd_bwd():
            return torch.autograd.grad(lm_loss(model(tokens), tokens), params)

        fwd_bwd()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads = fwd_bwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        del grads
        parts.append(f"{label} {peaks[label]:.3f} GiB, {ms:.3f} ms")
    print(f"slice remat, one forward+backward of llama-130m at batch 8 x 1024 "
          f"(peak memory, time): {'; '.join(parts)}", flush=True)
    check(peaks["nothing"] < peaks["dots"] < peaks["off"],
          f"remat peaks not ordered nothing < dots < off: {peaks}")


def phase_slice(torch) -> dict:
    """GUM, the paper's main path: Appendix C.3's rank 256, gamma 4."""
    from repro_torch.core import OptimizerConfig

    remat_peaks(torch)
    launches, _ = train_full_width(
        torch, "slice", OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4, period=3),
        want_dispatch={"lowrank_update": 7, "project": 7, "back_project": 14,
                       "newton_schulz": 14},
        want_launch={"lowrank_update": 14, "back_project": 14, "gram": 70,
                     "poly_apply": 70}, snapshot=TP_TWINS["slice"])
    # The projector refresh alone is timed once, in phase 4c (its svd kind).
    return launches


def phase_galore(torch) -> dict:
    """GaLore, the paper's baseline, at its published 130M settings (Zhao et
    al. 2024, section 5 / appendix: rank 256, alpha 0.25, lr 1e-2, weight
    decay 0; period cut from 200 to 3), family-stacked (3 launch units for
    the 7 hidden leaves) with the fused back-projection epilogue."""
    from repro_torch.core import OptimizerConfig

    return train_full_width(
        torch, "galore",
        OptimizerConfig(**GALORE_130M),
        want_dispatch={"project": 3, "back_project_epilogue": 3},
        want_launch={"lowrank_update": 3, "back_project_epilogue": 3},
        snapshot=TP_TWINS["galore"])[0]


# Phase 4c: the paper's other optimizers at llama-130m, rank 256, period 3,
# each with its per-step dispatch counts (derived from the code: 7 hidden
# leaves, 3 family stacks) and kernel launches (lowrank_update runs
# lowrank_update and project; each newton_schulz runs 5 gram and 5
# poly_apply).  tests/test_torch_optimizers.py holds the dispatch counts
# against the reference's count_launches at the smoke size, and the
# launches against this mapping.
BASELINES = [
    # Muon (the reference's benchmarks/pretrain_proxy.py: lr 1e-2, beta 0.95;
    # Nesterov and the muon scale on, the defaults) on the 7 hidden matrices.
    ("muon", dict(name="muon", lr=1e-2, beta=0.95),
     {"newton_schulz": 7}, {"gram": 35, "poly_apply": 35}),
    # GoLore: random projectors, SGDM inside, family-stacked with the fused
    # epilogue (weight decay 0: no W operand).
    ("golore", dict(name="golore", lr=1e-2, rank=256, period=3, base="sgdm",
                    fuse_families=True, fused_epilogue=True),
     {"lowrank_update": 3, "back_project_epilogue": 3},
     {"lowrank_update": 3, "back_project_epilogue": 3}),
    # Fira (alpha 0.25): per leaf one projection and two back-projections.
    ("fira", dict(name="fira", lr=1e-2, rank=256, period=3),
     {"project": 7, "back_project": 14}, {"lowrank_update": 7, "back_project": 14}),
    # Unbiased GaLore-Adam at Appendix C.3's GUM settings (rank 256, gamma 4):
    # per leaf Adam's projection, the sampled blocks' P Pᵀ G, the write-back.
    ("unbiased_galore_adam", dict(name="unbiased_galore_adam", lr=1e-2, rank=256, gamma=4,
                                  period=3),
     {"project": 14, "back_project": 14}, {"lowrank_update": 14, "back_project": 14}),
    # GUM with SGDM inside and the randomized range finder (rsvd) refresh.
    ("gum-sgdm-rsvd", dict(name="gum", lr=5e-3, rank=256, gamma=4, period=3, base="sgdm",
                           projector="rsvd"),
     {"lowrank_update": 7, "project": 7, "back_project": 14},
     {"lowrank_update": 14, "back_project": 14}),
]


def accum_counts(microbatches: int, leaves: int, units: int) -> tuple[dict, dict]:
    """Per-step dispatch counts and kernel launches of GUM's projected-space
    accumulation (``gum_accum_tools``; ``make_train_step(lowrank_accum=)``)
    over ``leaves`` hidden leaves run as ``units`` launch units (the leaves,
    or their family stacks under ``fuse_families``), from the code: every
    microbatch projects each leaf once (``project``), the mean is
    reconstructed per leaf (``back_project``), and GUM's update runs per
    unit one momentum update, one projection and one back-projection for
    the sampled blocks' P Pᵀ G, the low branch's write-back and two
    Newton–Schulz (low-rank momentum and full slots); the refresh adds no
    dispatched op.  Launches: ``project`` runs the lowrank_update kernel,
    each Newton–Schulz 5 gram and 5 poly_apply."""
    dispatch = {"lowrank_update": units, "project": microbatches * leaves + units,
                "back_project": leaves + 2 * units, "newton_schulz": 2 * units}
    launch = {"lowrank_update": dispatch["lowrank_update"] + dispatch["project"],
              "back_project": dispatch["back_project"],
              "gram": 5 * dispatch["newton_schulz"], "poly_apply": 5 * dispatch["newton_schulz"]}
    return dispatch, launch


# Phase 4c's steps a baseline: one refresh and two steady steps (cut from 6,
# two periods, to make room for phase 4l; the profiled steady step follows a
# second refresh either way).
BASELINE_STEPS = 3


def phase_baselines(torch) -> dict:
    """Each of :data:`BASELINES` through :func:`train_full_width`
    (BASELINE_STEPS steps), then the projector refresh alone (the 7 hidden
    leaves of llama-130m, rank 256, two timed calls after one warm-up) for
    each kind, and the default noise's host draw and its copy to the card,
    which the random kinds pay once a period."""
    from repro_torch.core import OptimizerConfig
    from repro_torch.core.lowrank_common import compute_projectors, generator_noise

    launches: dict = {}
    for label, kw, want_dispatch, want_launch in BASELINES:
        got, _ = train_full_width(torch, f"baseline {label}", OptimizerConfig(**kw),
                                  want_dispatch, want_launch, steps=BASELINE_STEPS)
        launches = {k: launches.get(k, 0) + got.get(k, 0) for k in set(launches) | set(got)}

    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [torch.randn(*shape, generator=gen, device="cuda") for shape in
              [(12, 768, 768)] * 4 + [(12, 768, 2048)] * 2 + [(12, 2048, 768)]]
    # each kind's draw a leaf: (distribution, its shape after the lead)
    draws = {"subspace": ("normal", lambda m, n: (n, 256)),
             "rsvd": ("normal", lambda m, n: (n, 256)),
             "random": ("normal", lambda m, n: (m, 256)),
             "grass": ("gumbel", lambda m, n: (m,))}
    for kind in ("svd", "subspace", "rsvd", "random", "grass"):
        refresh = host = copy = 0.0
        for i, g in enumerate(leaves):
            side = "left" if g.shape[1] <= g.shape[2] else "right"
            key = (0, 1, i)
            refresh += time_ms(lambda g=g, side=side, key=key: compute_projectors(
                kind, g, 256, side, key=key), iters=2, warmup=1)
            if kind in draws:
                dist, tail = draws[kind]
                shape = (12,) + tail(*sorted(g.shape[1:]))  # (short side, long side)
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    generator_noise(key, dist, shape)
                    walls.append((time.perf_counter() - t0) * 1e3)
                host += statistics.median(walls)
                copy += time_ms(lambda key=key, dist=dist, shape=shape: generator_noise(
                    key, dist, shape).to("cuda"), iters=3, warmup=1)
        p = compute_projectors(kind, leaves[-1], 256, "right", key=(0, 1, 6))
        eye = torch.eye(256, device="cuda").expand(12, 256, 256)
        err = float((p.mT @ p - eye).abs().max())
        check(err <= 1e-4, f"{kind} refresh: |PᵀP - I| {err:.2e} > 1e-4")
        noise_txt = (f"; default noise host draw {host:.3f} ms, draw and copy to the card "
                     f"{copy:.3f} ms" if kind in draws else "")
        print(f"baselines {kind} refresh ms (7 leaves, rank 256, |PᵀP - I| {err:.1e}): "
              f"{refresh:.3f}{noise_txt}", flush=True)
    return launches


# --------------------------------------------------------------------- phases 4d, 4e

GUM_130M = dict(name="gum", lr=5e-3, rank=256, gamma=4, period=3)
GALORE_130M = dict(name="galore", lr=1e-2, rank=256, period=3, weight_decay=0.0,
                   fuse_families=True, fused_epilogue=True)
GUM_DISPATCH = {"lowrank_update": 7, "project": 7, "back_project": 14, "newton_schulz": 14}
GUM_LAUNCH = {"lowrank_update": 14, "back_project": 14, "gram": 70, "poly_apply": 70}


def leaf_rel(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max|got - want| / max|want|, and its path."""
    worst = max((float((got[k].float() - w.float()).abs().max())
                 / max(float(w.abs().max()), 1e-30), k) for k, w in want.items())
    return worst


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def accumulate_gradients(torch, model, batch) -> None:
    """The gradient of one batch at microbatches 1, 2 and 4 (``launch.steps.
    loss_and_grads``, what the step accumulates): each within 1e-5 per leaf
    and its loss within 1e-6 of microbatches 1's; peak memory of each."""
    from repro_torch.launch.steps import loss_and_grads

    params = model.params()
    want, parts = None, []
    for mb in (1, 2, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, params, batch, mb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = peak_gib(torch)
        grads = {k: g.cpu() for k, g in grads.items()}
        if want is None:
            want = (float(loss), grads)
            parts.append(f"1: loss {float(loss):.6f}, {ms:.3f} ms, peak {peak:.3f} GiB")
            continue
        loss_rel = abs(float(loss) - want[0]) / abs(want[0])
        rel, leaf = leaf_rel(grads, want[1])
        parts.append(f"{mb}: loss rel {loss_rel:.2e}, worst leaf {leaf} {rel:.2e}, "
                     f"{ms:.3f} ms, peak {peak:.3f} GiB")
        check(loss_rel <= 1e-6, f"accumulate: loss at microbatches {mb} off by {loss_rel:.2e}")
        check(rel <= 1e-5, f"accumulate: gradient {leaf} at microbatches {mb} off by {rel:.2e}")
    print("accumulate llama-130m gradient of one 8 x 1024 batch by microbatches "
          f"(against 1): {'; '.join(parts)}", flush=True)


def capture_reconstruction(tools, captured: dict):
    """``tools`` whose ``reconstruct`` also copies to the host, on a step run
    with ``captured["on"]`` set, the full-shape gradient it hands the
    update and the projectors and sampled blocks it read."""

    def reconstruct(compact: dict, state, params: dict) -> dict:
        grads = tools.reconstruct(compact, state, params)
        if captured.pop("on", False):
            lr = state.inner["gum"][0]
            captured["got"] = {k: g.cpu() for k, g in grads.items()}
            captured["views"] = {k: (p.cpu(), lr.inner.idx[k]) for k, p in lr.projs.items()
                                 if p is not None}
        return grads

    return tools._replace(reconstruct=reconstruct)


def check_reconstruction(torch, label: str, captured: dict, mean_grads: dict) -> None:
    """The full-shape gradient that the timed step reconstructed (captured
    by :func:`capture_reconstruction`) within 1e-5 per leaf of ``P Pᵀ Ḡ``
    with the sampled blocks of ``Ḡ`` for a low-rank leaf, and of ``Ḡ`` for
    the others; ``Ḡ`` is the full-shape fp32 accumulation of the same
    microbatches at the same parameters (``loss_and_grads``), and P and the
    blocks are those the step read."""
    from repro_torch.core.lowrank_common import family_shape

    worst = (0.0, "")
    for k, got in captured.pop("got").items():
        got, g = got.to("cuda"), mean_grads[k].to("cuda")
        want = g
        if k in captured["views"]:
            proj, idx = captured["views"][k]
            proj = proj.to("cuda")
            side = family_shape(g, GUM_130M["rank"]).side
            want = proj @ (proj.mT @ g) if side == "left" else (g @ proj) @ proj.mT
            want[idx] = g[idx]
        worst = max(worst, (float((got - want).abs().max() / want.abs().max()), k))
    print(f"accumulate {label}: the step's reconstruction vs P Pᵀ Ḡ + sampled blocks "
          f"(Ḡ as is off the low-rank leaves), worst leaf {worst[1]} rel {worst[0]:.2e}",
          flush=True)
    check(worst[0] <= 1e-5, f"accumulate {label}: reconstruction off by {worst[0]:.2e} "
          f"on {worst[1]}")


# The one-process twin of phase 4i's accumulator on a mesh: phase 4d's run's
# losses and parameters after its first ACCUM_MESH_STEPS steps.
ACCUM_MESH_STEPS = 3
ACCUM_TWIN: dict = {}


def projected_accumulation(torch, full_peak: float) -> dict:
    """Six GUM steps at 4 microbatches through ``gum_accum_tools`` and
    ``make_train_step(lowrank_accum=)``: finite losses, the exact per-step
    dispatch and launch counts (:func:`accum_counts`), the step's own
    reconstruction checked on a refresh step (1) and a steady step (2)
    (:func:`check_reconstruction`), step times and the peak memory beside
    the full-shape accumulator's.  Returns the kernel launches of the six
    steps."""
    from repro_torch.core import gum_accum_tools
    from repro_torch.data import build_stream
    from repro_torch.kernels import build, launch_count
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    opt = {k: v for k, v in GUM_130M.items() if k != "name"}
    tools = gum_accum_tools(opt.pop("lr"), **opt)
    captured: dict = {}
    step = make_train_step(model, tools.transform, microbatches=4,
                           lowrank_accum=capture_reconstruction(tools, captured))
    params = model.params()
    state = tools.transform.init({k: p.detach() for k, p in params.items()})
    want_dispatch, want_launch = accum_counts(4, 7, 7)
    stream = build_stream(data)
    batches = [torch.from_numpy(next(stream)).to("cuda") for _ in range(6)]
    losses, seconds, launches = [], [], {}
    peak = 0.0
    for i, tokens in enumerate(batches):
        mean_grads = None
        if i in (0, 1):  # Ḡ at the parameters the step starts from, kept on the host
            _, mean_grads = loss_and_grads(model, params, {"tokens": tokens}, 4)
            mean_grads = {k: g.cpu() for k, g in mean_grads.items()}
            captured["on"] = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        with launch_count.count_launches() as counts:
            state, metrics = step(params, state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        peak = max(peak, peak_gib(torch))
        got = {k: v for k, v in build.LAUNCHES.items() if v}
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        check(counts == want_dispatch,
              f"gum_accum_tools step {i + 1}: dispatch {counts} != {want_dispatch}")
        check(got == want_launch,
              f"gum_accum_tools step {i + 1}: kernel launches {got} != {want_launch}")
        if mean_grads is not None:
            check("got" in captured, f"gum_accum_tools step {i + 1}: the step reconstructed "
                  "no gradient")
            check_reconstruction(torch, f"gum_accum_tools step {i + 1} "
                                 f"({'refresh' if i == 0 else 'steady'})", captured, mean_grads)
        if i + 1 == ACCUM_MESH_STEPS:  # phase 4i's mesh run is held to these
            ACCUM_TWIN.update(losses=list(losses),
                              params={k: p.detach().cpu().clone() for k, p in params.items()})
    check(all(math.isfinite(v) for v in losses), f"gum_accum_tools: losses {losses}")
    print(f"accumulate gum_accum_tools llama-130m microbatches=4: losses {losses}; dispatch "
          f"per step {want_dispatch}; kernel launches per step {want_launch}", flush=True)
    steady = [t for i, t in enumerate(seconds) if i in (2, 4, 5)]
    print(f"accumulate gum_accum_tools step ms: all {[round(t * 1e3, 3) for t in seconds]}; "
          f"steady median (steps 3, 5, 6; steps 1-2 copy their reconstruction to the host) "
          f"{statistics.median(steady) * 1e3:.3f}; peak memory {peak:.3f} GiB "
          f"(the full-shape fp32 accumulator's 6 Trainer steps above: {full_peak:.3f} GiB)",
          flush=True)
    build.reset_launches()
    return launches


def chunked_loss(torch, model, batch) -> None:
    """One forward and backward of llama-130m at ``logit_chunk`` 0, 1024
    and 256 (remat as the config): loss within 1e-6, gradients within 1e-5
    per leaf of the unchunked ones, each peak printed; 1024 is the whole
    shifted sequence in one chunk, whose logits live only inside the loss's
    forward and backward, and every chunked peak must be below the
    unchunked one."""
    from repro_torch.launch.steps import loss_and_grads

    cfg = model.cfg
    params = model.params()
    peaks, parts, want = {}, [], None
    for chunk in (0, 1024, 256):
        model.cfg = cfg.replace(logit_chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks[chunk] = peak_gib(torch)
        grads = {k: g.cpu() for k, g in grads.items()}
        if want is None:
            want = (float(loss), grads)
            parts.append(f"0: {peaks[0]:.3f} GiB, {ms:.3f} ms")
            continue
        loss_rel = abs(float(loss) - want[0]) / abs(want[0])
        rel, leaf = leaf_rel(grads, want[1])
        parts.append(f"{chunk}: {peaks[chunk]:.3f} GiB, {ms:.3f} ms, loss rel {loss_rel:.2e}, "
                     f"worst leaf {leaf} {rel:.2e}")
        check(loss_rel <= 1e-6, f"logit_chunk {chunk}: loss off by {loss_rel:.2e}")
        check(rel <= 1e-5, f"logit_chunk {chunk}: gradient {leaf} off by {rel:.2e}")
        check(peaks[chunk] < peaks[0], f"logit_chunk {chunk}: peak {peaks[chunk]:.3f} GiB is "
              f"not below the unchunked {peaks[0]:.3f} GiB")
    model.cfg = cfg
    print(f"accumulate chunked loss, one forward+backward of llama-130m at 8 x 1024 by "
          f"logit_chunk (peak memory, time): {'; '.join(parts)}", flush=True)


def pad_rank(torch) -> None:
    """Rows 2–3 through the dispatcher at rank 96 (llama-130m's shapes,
    both sides) with ``pad_rank_to`` 0 and 128 (the rank axis padded to 128
    and sliced back): equal outputs, and the time of each."""
    from repro_torch.kernels import build, dispatch

    gen = torch.Generator(device="cuda").manual_seed(3)
    for side, (L, m, n) in (("left", (12, 768, 2048)), ("right", (12, 2048, 768))):
        p = torch.randn(L, m if side == "left" else n, 96, generator=gen, device="cuda")
        g = torch.randn(L, m, n, generator=gen, device="cuda")
        s = torch.randn(*((L, 96, n) if side == "left" else (L, m, 96)), generator=gen,
                        device="cuda")
        parts = []
        for op, fn in (("project", lambda pad: dispatch.project(p, g, side=side,
                                                                pad_rank_to=pad)),
                       ("back_project", lambda pad: dispatch.back_project(
                           p, s, side=side, pad_rank_to=pad))):
            a, b = fn(0), fn(128)
            check(bool(torch.equal(a, b)), f"pad_rank_to {op} {side}: padded output differs "
                  f"by {float((a - b).abs().max()):.2e}")
            ms0, ms128 = time_ms(lambda: fn(0)), time_ms(lambda: fn(128))
            parts.append(f"{op} equal, ms {ms0:.4f} unpadded, {ms128:.4f} padded")
        print(f"accumulate pad_rank_to rank 96 -> 128 {side} {(L, m, n)}: {'; '.join(parts)}",
              flush=True)
    build.reset_launches()  # comparison launches do not count


def phase_accumulate(torch) -> dict:
    """Phase 4d: gradient accumulation at llama-130m (phase 4's GUM).
    Returns the kernel launches of its two training runs."""
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import build_stream
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    batch = {"tokens": torch.from_numpy(build_stream(data).batch_at(0)).to("cuda")}
    accumulate_gradients(torch, model, batch)
    chunked_loss(torch, model, batch)
    del model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, full_peak = train_full_width(torch, "accumulate trainer",
                                           OptimizerConfig(**GUM_130M), GUM_DISPATCH,
                                           GUM_LAUNCH, microbatches=4)
    got = projected_accumulation(torch, full_peak)
    launches = {k: launches.get(k, 0) + got.get(k, 0) for k in set(launches) | set(got)}
    pad_rank(torch)
    return launches


def flat_state(tree) -> list:
    from repro_torch.checkpoint.manager import flatten_with_paths

    return flatten_with_paths(tree)


def bitwise_diff(a, b, drop: str | None = None) -> list[str]:
    """The leaves of two (params, state) trees that are not bitwise equal,
    each with its max abs difference; leaves whose path holds ``drop`` are
    left out of both."""
    import torch

    out = []
    fa, fb = flat_state(a), flat_state(b)
    if drop is not None:
        fa, fb = ([(p, x) for p, x in f if drop not in p] for f in (fa, fb))
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return ["the trees differ in structure"]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                out.append(f"{path} ({float((x.float() - y.float()).abs().max()):.2e})")
        elif x != y:
            out.append(f"{path} ({x} != {y})")
    return out


def phase_resume(torch) -> dict:
    """Phase 4e: exact resume at llama-130m (phase 4's GUM, checkpoints
    every 3 steps; step 4 is a refresh).  Two uninterrupted 6-step runs
    from the same parameters must agree bitwise, the second with its step-6
    checkpoint bit-flipped (``inject="ckpt_bitflip@6"``); a third
    ``Trainer`` on that directory falls back to step 3 and must reach the
    same bits.  Then a child process of the training CLI (``python -m
    repro_torch.launch.train``, phase 4's settings, a checkpoint every step)
    is killed mid-save by ``kill_save@6#2``: it must leave step 5 as the
    newest verified checkpoint and a ``.tmp`` directory, and a ``Trainer``
    resuming it to 6 must equal the uninterrupted runs bitwise (losses,
    parameters, every optimizer-state leaf).  Then the checkpoint alone:
    save, verify and restore times and its bytes on disk.  Returns the
    kernel launches of the trainers in this process."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg, data = full_width_data()
    init = build_model(cfg, device="cuda")
    init.init_params(0)
    params0 = {k: v.detach().clone() for k, v in init.params().items()}
    del init

    def run(ckpt_dir: str, steps: int, keep: bool = False, telemetry: bool = False, **kw):
        trainer = Trainer(build_model(cfg, device="cuda"),
                          OptimizerConfig(**GUM_130M, telemetry=telemetry),
                          RunConfig(steps=steps, ckpt_every=3, log_every=0, seed=0,
                                    ckpt_dir=ckpt_dir),
                          data, device="cuda", params=params0, **kw)
        result = trainer.train()
        if not keep:  # about 1 GB a checkpoint
            shutil.rmtree(ckpt_dir)
        return trainer, result

    def tree(trainer):
        return ({k: p.detach() for k, p in trainer.model.params().items()}, trainer.opt_state)

    def same(label: str, trainer, result, losses, drop: str | None = None) -> None:
        diff = bitwise_diff(tree(a1), tree(trainer), drop)
        check(result.losses == losses and not diff,
              f"resume: {label} differs: losses {result.losses} vs {losses}; "
              f"leaves {diff[:8]}")

    with scratch_dir("resume") as root:
        build.reset_launches()
        a1, ra1 = run(os.path.join(root, "a1"), 6)
        flipped = os.path.join(root, "a2")
        a2, ra2 = run(flipped, 6, keep=True, inject="ckpt_bitflip@6")
        check(ra2.fault_log == [(6, "ckpt_bitflip")], f"resume: fault log {ra2.fault_log}")
        same("the second uninterrupted run", a2, ra2, ra1.losses)
        del a2
        fell, rfell = run(flipped, 6)
        check(rfell.resumed_from == 3,
              f"resume: the bit-flipped directory resumed from {rfell.resumed_from}, not 3")
        same("the run resumed past the bit-flipped checkpoint", fell, rfell, ra1.losses[3:])
        del fell

        killed = os.path.join(root, "cli")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama-130m",
             "--steps", "6", "--batch", "8", "--seq", "1024", "--lr", "5e-3", "--rank", "256",
             "--gamma", "4", "--period", "3", "--inject", "kill_save@6#2", "--ckpt-dir", killed,
             "--telemetry", "--profile-steps", "4:5"],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        cli_s = time.perf_counter() - t0
        check(proc.returncode == -9, f"resume: the CLI child exited {proc.returncode}, not -9 "
              f"(SIGKILL mid-save): {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        mgr = CheckpointManager(killed)
        check(mgr.latest_verified_step() == 5,
              f"resume: newest verified step after the kill {mgr.latest_verified_step()}, not 5")
        check(any(n.endswith(".tmp") for n in os.listdir(killed)),
              f"resume: the killed save left no .tmp directory: {os.listdir(killed)}")
        killed_run_log(killed, proc.stdout)
        # The child's optimizer state holds the telemetry probes: the resumed
        # run builds them too, and is held to the run without them leaf by
        # leaf, the probes left out.
        b2, rb2 = run(killed, 6, telemetry=True)
        check(rb2.resumed_from == 5, f"resume: resumed_from {rb2.resumed_from} != 5")
        same("the run resumed after the CLI's kill", b2, rb2, ra1.losses[5:], drop="/probes/")
        del b2
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        n_leaves = len(flat_state(tree(a1)))
        print(f"resume llama-130m gum: uninterrupted {ra1.losses} and {ra2.losses} (its step-6 "
              f"checkpoint bit-flipped); resumed from {rfell.resumed_from} past it "
              f"{rfell.losses}; the CLI child killed mid-save of step 6 after {cli_s:.1f} s "
              f"(exit {proc.returncode}), resumed from {rb2.resumed_from} {rb2.losses}; all "
              f"equal bitwise: losses, parameters and {n_leaves} (params, state) leaves",
              flush=True)

        mgr = CheckpointManager(os.path.join(root, "timing"))
        t0 = time.perf_counter()
        mgr.save(6, tree(a1))
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ok = mgr.verify_step(6)
        verify_ms = (time.perf_counter() - t0) * 1e3
        check(ok, "resume: the checkpoint does not verify")
        template = (dict(params0), a1.optimizer.init(dict(params0)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, _ = mgr.restore(6, template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(not bitwise_diff(restored, tree(a1)), "resume: the restored tree differs")
        step_dir = mgr._step_dir(6)
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        param_bytes = sum(v.numel() * v.element_size() for v in params0.values())
        print(f"resume checkpoint of llama-130m GUM (params and state, {n_leaves} leaves): "
              f"{nbytes} bytes on disk ({nbytes / 1e9:.3f} GB; parameters {param_bytes} bytes); "
              f"save {save_ms:.1f} ms, verify {verify_ms:.1f} ms, restore to the card "
              f"{restore_ms:.1f} ms (with its verify)", flush=True)
    return launches


def killed_run_log(ckpt_dir: str, stdout: str) -> None:
    """Phase 4e's CLI child ran with ``--telemetry --profile-steps 4:5`` and
    was killed in its last save: its events.jsonl holds every record up to
    the kill (a schema-1 header, the loss of each of the 6 steps, the
    window's start at step 4 and stop at 5) and no closing counters; its
    trace holds rows 1-5 inside the ``step 4`` annotation; the closing
    ``done:`` and ``telemetry:`` lines, printed after ``train()``, are
    absent, since the process died in it."""
    from repro_torch.telemetry import SCHEMA_VERSION
    from repro_torch.telemetry.bus import read_jsonl

    path = os.path.join(ckpt_dir, "events.jsonl")
    recs = read_jsonl(path)
    profile = [(r["step"], r["detail"]) for r in recs if r.get("name") == "profile"]
    check(recs[0]["kind"] == "header" and recs[0]["schema"] == SCHEMA_VERSION
          and [r["step"] for r in recs if r.get("name") == "loss"] == list(range(1, 7))
          and [s for s, _ in profile] == [4, 5]
          and not any(r["kind"] == "counters" for r in recs),
          f"resume: the killed CLI child's run log {path}: {len(recs)} records, profile "
          f"events {profile}")
    check(not re.search(r"^(done|telemetry): ", stdout, re.M),
          f"resume: the killed CLI child printed its closing lines: {stdout[-2000:]}")
    (trace,) = os.listdir(os.path.join(ckpt_dir, "profile"))
    trace_kernels("resume CLI child", os.path.join(ckpt_dir, "profile", trace), ["step 4"])
    print(f"resume CLI child's run log: {len(recs)} records up to the kill, "
          f"{os.path.getsize(path)} bytes, no counters; profile events {profile}", flush=True)


# --------------------------------------------------------------------- phase 4f

# Phase 4's rank 256, then 128 from the first decision (count 3) on; the
# spectral policy's ladder around it.
RANK_HI, RANK_LO = GUM_130M["rank"], GUM_130M["rank"] // 2
POLICY_STEPWISE = f"stepwise:0={RANK_HI},3={RANK_LO}"
POLICY_SPECTRAL = dict(rank_policy="spectral:0.99",
                       rank_ladder=(RANK_HI // 4, RANK_HI // 2, RANK_HI))


def lowrank_bytes(state) -> int:
    from repro_torch.core import find_lowrank_states, state_bytes

    return sum(state_bytes(s) for s in find_lowrank_states(state))


def seeded_grads(torch, params: dict, step: int) -> dict:
    """Step ``step``'s gradient at the model's leaf shapes, on the card:
    the same for every run that asks for that step."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    return {k: 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
            for k, p in params.items()}


def svd_is_deterministic(torch) -> bool:
    """Whether two calls of the card's SVD on one gradient agree bitwise
    (at llama-130m's largest family, w_in's (12, 768, 2048))."""
    from repro_torch.core.lowrank_common import compute_projectors

    g = torch.randn(12, 768, 2048, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    return bool(torch.equal(compute_projectors("svd", g, 256, "left"),
                            compute_projectors("svd", g, 256, "left")))


def migration_contract(torch, params: dict, fuse: bool) -> None:
    """Phase 4f (a): GUM at phase 4's settings under ``stepwise:0=256,3=128``
    driven by a ``RankPolicyController`` over 6 updates of seeded gradients
    (parameters fixed), beside a fresh rank-128 GUM fed the same gradients:
    from the first update after the drop (the refresh at count 4) on, the
    updates must be bitwise equal — or, if the card's SVD is shown not to be
    deterministic, within 1e-6 relative.  Prints the migration's ms and the
    state's bytes before and after."""
    from repro_torch.core import (OptimizerConfig, RankMap, RankPolicyController,
                                  build_optimizer, resolve_rank_policy, state_bytes)

    label = f"rank policy (a) {'family-stacked' if fuse else 'per leaf'}"
    cfg = OptimizerConfig(**GUM_130M, rank_policy=POLICY_STEPWISE, fuse_families=fuse)
    ctrl = RankPolicyController(resolve_rank_policy(cfg),
                                lambda m: build_optimizer(cfg, rank_map=m),
                                period=cfg.period, default_rank=cfg.rank)
    opt = ctrl.transform()
    state = opt.init(params)
    fresh = build_optimizer(cfg, rank_map=RankMap(RANK_LO))
    fresh_state = fresh.init(params)
    worst, unequal = 0.0, []
    for step in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_state, changed = ctrl.maybe_update(state, params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if changed:
            check(step == 3, f"{label}: the map changed before update {step + 1}")
            print(f"{label}: migration {ctrl.history[-1][1]} before update {step + 1} "
                  f"{ms:.3f} ms; LowRankState bytes {lowrank_bytes(state)} -> "
                  f"{lowrank_bytes(new_state)}, whole optimizer state {state_bytes(state)} -> "
                  f"{state_bytes(new_state)}", flush=True)
            opt = ctrl.transform()
        state = new_state
        grads = seeded_grads(torch, params, step)
        upd, state = opt.update(grads, state, params)
        want, fresh_state = fresh.update(grads, fresh_state, params)
        if step >= 3:
            for k, w in want.items():
                if w is not None and not torch.equal(upd[k], w):
                    unequal.append(f"update {step + 1} {k}")
                    worst = max(worst, float((upd[k] - w).abs().max() / w.abs().max()))
        del upd, want, grads
    check(ctrl.current_map == RankMap(RANK_LO), f"{label}: map {ctrl.current_map}")
    if unequal:
        check(not svd_is_deterministic(torch) and worst <= 1e-6,
              f"{label}: updates after the drop differ from a fresh rank-{RANK_LO} run "
              f"(worst rel {worst:.3e}): {unequal[:6]}")
        print(f"{label}: the card's SVD (torch.linalg.svd) is not deterministic; "
              f"updates 4-6 within {worst:.3e} relative (<= 1e-6) of a fresh rank-{RANK_LO} "
              f"run", flush=True)
    else:
        print(f"{label}: updates 4-6 bitwise equal to a fresh rank-{RANK_LO} GUM run",
              flush=True)


def policy_trainer_class(torch):
    """``Trainer`` recording each step's dispatch and kernel launches (and
    the rank the step ran at: its controller's map, or the configured rank
    without a rank policy), and — when ``capture`` names a leaf — that
    leaf's first gradient on the host."""
    from repro_torch.core.api import Transform
    from repro_torch.kernels import build
    from repro_torch.train import Trainer

    class Recording(Trainer):
        def __init__(self, *args, dispatched: dict, capture: str | None = None, **kw):
            self.per_step, self.dispatched = [], dispatched
            self.capture, self.captured = capture, None
            super().__init__(*args, **kw)

        def _set_optimizer(self, optimizer):
            if self.capture is not None:
                update = optimizer.update

                def capturing(grads, state, params):
                    # (the startup audit's trace runs on meta copies)
                    if self.captured is None and grads[self.capture].device.type != "meta":
                        self.captured = grads[self.capture].detach().cpu()
                    return update(grads, state, params)

                optimizer = Transform(optimizer.init, capturing)
            super()._set_optimizer(optimizer)
            step_fn = self.step_fn

            def recorded(params, state, batch):
                d0, l0 = dict(self.dispatched), dict(build.LAUNCHES)
                out = step_fn(params, state, batch)
                self.per_step.append((
                    self.rank_ctrl.current_map if self.rank_ctrl is not None
                    else f"rank {self.opt_cfg.rank}",
                    {k: v - d0.get(k, 0) for k, v in self.dispatched.items()
                     if v != d0.get(k, 0)},
                    {k: v - l0.get(k, 0) for k, v in build.LAUNCHES.items() if v != l0[k]}))
                return out

            self.step_fn = recorded

    return Recording


def timed_decisions(torch, trainer, log: list) -> None:
    """Wrap the trainer's controller so each decision that migrates records
    its ms (synchronised), the state's bytes before and after, and the peak
    memory since the last reset (which it resets: the steps before the
    change and those after each read their own peak)."""
    from repro_torch.core import state_bytes

    ctrl = trainer.rank_ctrl
    maybe_update = ctrl.maybe_update

    def timed(opt_state, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_state, changed = maybe_update(opt_state, params)
        torch.cuda.synchronize()
        if changed:
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "map": ctrl.current_map,
                        "lowrank_bytes": (lowrank_bytes(opt_state), lowrank_bytes(new_state)),
                        "state_bytes": (state_bytes(opt_state), state_bytes(new_state)),
                        "peak_before": peak_gib(torch)})
            torch.cuda.reset_peak_memory_stats()
        return new_state, changed

    ctrl.maybe_update = timed


def check_step_counts(label: str, trainer, probed: int = 0, first: int = 1) -> None:
    """Every step's dispatch and launch counts (the trainer's steps
    ``first``, ``first + 1``, ...): GUM's, plus one projection (row 2) per
    probed leaf on the refresh steps 1 and 4."""
    for step, (rank_map, dispatched, launched) in enumerate(trainer.per_step, start=first):
        want_d, want_l = dict(GUM_DISPATCH), dict(GUM_LAUNCH)
        if step % 3 == 1:
            want_d["project"] += probed
            want_l["lowrank_update"] += probed
        check(dispatched == want_d and launched == want_l,
              f"{label} step {step} at {rank_map}: dispatch {dispatched} != {want_d} or "
              f"launches {launched} != {want_l}")
    ranks = [str(m) for m, _, _ in trainer.per_step]
    print(f"{label}: steps {first}-{first + len(ranks) - 1}, dispatch and launches per step "
          f"equal GUM's at each rank ({ranks})"
          + (f", plus {probed} projections on the refresh steps" if probed else ""),
          flush=True)


def step_summary(label: str, result) -> None:
    ms = [round(t * 1e3, 3) for t in result.step_seconds]
    print(f"{label} step ms: {ms}; steady median at 256 (steps 2, 3) "
          f"{statistics.median(ms[1:3]):.3f}, after the change (steps 5, 6) "
          f"{statistics.median(ms[4:6]):.3f}; refresh steps 1, 4: {ms[0]}, {ms[3]}", flush=True)


def policy_trainer(torch, params0: dict, dispatched: dict) -> None:
    """Phase 4f (b): the ``Trainer`` with ``rank_policy=stepwise:0=256,3=128``
    for 6 steps, then 4 steps and a new ``Trainer`` resuming to 6: bitwise
    equal (losses, parameters, optimizer state, controller state); exact
    per-step counts at each rank; step times, the migration's ms, state
    bytes and the peak memory."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig, RankMap
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    opt_cfg = OptimizerConfig(**GUM_130M, rank_policy=POLICY_STEPWISE)
    Recording = policy_trainer_class(torch)

    def run(ckpt_dir: str, steps: int, log: list | None = None):
        trainer = Recording(build_model(cfg, device="cuda"), opt_cfg,
                            RunConfig(steps=steps, ckpt_every=0, log_every=0, seed=0,
                                      ckpt_dir=ckpt_dir),
                            data, device="cuda", params=params0, dispatched=dispatched)
        if log is not None:
            timed_decisions(torch, trainer, log)
        return trainer, trainer.train()

    def tree(trainer):
        return ({k: p.detach() for k, p in trainer.model.params().items()}, trainer.opt_state)

    with scratch_dir("rank_policy") as root:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        log: list = []
        full, r_full = run(os.path.join(root, "full"), 6, log)
        peak = peak_gib(torch)
        _, r_first = run(os.path.join(root, "split"), 4)
        resumed, r_second = run(os.path.join(root, "split"), 6)
    print(f"rank policy (b) trainer {POLICY_STEPWISE}: losses {r_full.losses}; 4 steps "
          f"{r_first.losses} + resumed from {r_second.resumed_from} {r_second.losses}",
          flush=True)
    check(all(math.isfinite(v) for v in r_full.losses) and len(r_full.losses) == 6,
          f"rank policy (b): losses {r_full.losses}")
    check(full.rank_ctrl.history == [(0, RankMap(RANK_HI)), (3, RankMap(RANK_LO))],
          f"rank policy (b): history {full.rank_ctrl.history}")
    check([m for m, _, _ in full.per_step] == [RankMap(RANK_HI)] * 3 + [RankMap(RANK_LO)] * 3,
          f"rank policy (b): ranks by step {[m for m, _, _ in full.per_step]}")
    check_step_counts("rank policy (b)", full)
    check_step_counts("rank policy (b) resumed", resumed, first=5)
    diff = bitwise_diff(tree(full), tree(resumed))
    check(r_second.resumed_from == 4 and r_first.losses + r_second.losses == r_full.losses
          and not diff and resumed.rank_ctrl.state_dict() == full.rank_ctrl.state_dict(),
          f"rank policy (b): the resumed run differs: resumed_from {r_second.resumed_from}, "
          f"losses {r_first.losses + r_second.losses} vs {r_full.losses}; leaves {diff[:8]}; "
          f"controller {resumed.rank_ctrl.state_dict()} vs {full.rank_ctrl.state_dict()}")
    print(f"rank policy (b): 4 + 2 resumed steps equal 6 bitwise across the rank change "
          f"(losses, parameters, {len(flat_state(tree(full)))} (params, state) leaves, "
          f"controller state)", flush=True)
    check(len(log) == 1, f"rank policy (b): {len(log)} migrations")
    ev = log[0]
    print(f"rank policy (b) migration to {ev['map']}: maybe_update {ev['ms']:.3f} ms; "
          f"LowRankState bytes {ev['lowrank_bytes'][0]} -> {ev['lowrank_bytes'][1]}; whole "
          f"optimizer state bytes {ev['state_bytes'][0]} -> {ev['state_bytes'][1]}; "
          f"max_memory_allocated steps 1-3 {ev['peak_before']:.3f} GiB, steps 4-6 "
          f"{peak:.3f} GiB, each over {held:.3f} GiB allocated before the trainer (this "
          f"phase's copy of the initial parameters and what earlier phases still hold)",
          flush=True)
    step_summary("rank policy (b)", r_full)


def check_probe(torch, trainer, probes_at_decision: dict) -> None:
    """The card's probe of one refresh gradient (step 1's, of the captured
    leaf, made with step 1's projector) against the same probe on the CPU:
    ``sv2`` sum and ``g2`` within 1e-4 relative."""
    from repro_torch.core.combinators import _spectrum_probe
    from repro_torch.core.lowrank_common import family_shape

    k = trainer.capture
    proj, probe = probes_at_decision["proj"], probes_at_decision["probe"]
    g = trainer.captured
    fs = family_shape(g, proj.shape[-1])
    want = _spectrum_probe(proj, g, fs, "auto", 0)
    errs = {}
    for key in ("g2", "sv2"):
        a, b = float(probe[key].sum()), float(want[key].sum())
        errs[key] = abs(a - b) / abs(b)
    check(torch.equal(probe["mn"], want["mn"]) and max(errs.values()) <= 1e-4,
          f"rank policy (c) probe of {k}: card vs cpu {errs}, mn {probe['mn']}")
    print(f"rank policy (c) probe of {k} {tuple(g.shape)} at step 1 (rank {proj.shape[-1]}): "
          f"card vs cpu sv2 sum rel {errs['sv2']:.2e}, g2 rel {errs['g2']:.2e} "
          f"(sv2 sum / g2 = {float(probe['sv2'].sum()) / float(probe['g2']):.4f})", flush=True)


def probe_cost(torch, params: dict) -> None:
    """The spectrum probe alone, as a refresh makes it for llama-130m's 7
    hidden leaves at rank 256: one profiled run, device time by group (the
    projection kernel, the Gram's GEMM, ``eigvalsh``'s cuSOLVER kernels),
    and each part timed alone with CUDA events."""
    from torch.autograd import DeviceType
    from repro_torch.core.combinators import _spectrum_probe
    from repro_torch.core.lowrank_common import (compute_projectors, default_lowrank_filter,
                                                 family_shape)
    from repro_torch.kernels import build, dispatch

    gen = torch.Generator(device="cuda").manual_seed(11)
    leaves = []
    for k, p in params.items():
        if default_lowrank_filter(k, p):
            fs = family_shape(p, RANK_HI)
            g = torch.randn(p.shape, generator=gen, device="cuda")
            leaves.append((fs, g, compute_projectors("svd", g, fs.rank, fs.side)))

    def probe_all():
        return [_spectrum_probe(p, g, fs, "auto", 0) for fs, g, p in leaves]

    probe_all()
    torch.cuda.synchronize()
    before = build.LAUNCHES["lowrank_update"]
    with profiled() as prof:
        t0 = time.perf_counter()
        probe_all()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = build.LAUNCHES["lowrank_update"] - before
    groups = {"lowrank_update (row 2)": 0.0, "gram gemm": 0.0, "eigvalsh": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else ev.self_cuda_time_total
        low = ev.key.lower()
        if re.search(GROUPS["lowrank_update"], ev.key):
            groups["lowrank_update (row 2)"] += us
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["gram gemm"] += us
        elif any(t in low for t in ("syev", "eig", "sytrd", "ormtr", "steqr", "stedc",
                                    "jacobi", "cusolver", "householder")):
            groups["eigvalsh"] += us
        else:
            groups["other"] += us
    parts = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in groups.items())
    check(launches == len(leaves), f"rank policy probe: {launches} row-2 launches")
    s = [dispatch.project(p, g, side=fs.side) for fs, g, p in leaves]
    grams = [x @ x.mT if fs.side == "left" else x.mT @ x for (fs, _, _), x in zip(leaves, s)]
    proj_ms = sum(time_ms(lambda p=p, g=g, fs=fs: dispatch.project(p, g, side=fs.side), 5)
                  for fs, g, p in leaves)
    gram_ms = sum(time_ms(lambda x=x, fs=fs: x @ x.mT if fs.side == "left" else x.mT @ x, 5)
                  for (fs, _, _), x in zip(leaves, s))
    eig_ms = sum(time_ms(lambda a=a: torch.linalg.eigvalsh(a), 5) for a in grams)
    print(f"rank policy probe cost, {len(leaves)} leaves at rank {RANK_HI}, one profiled "
          f"refresh's probes: "
          f"{launches} row-2 launches; device ms by group: {parts}; host wall {wall:.3f} ms; "
          f"alone (events, summed over the leaves): project {proj_ms:.3f}, Gram {gram_ms:.3f}, "
          f"eigvalsh {eig_ms:.3f} ms", flush=True)


def spectral_trainer(torch, params0: dict, dispatched: dict) -> None:
    """Phase 4f (c): ``rank_policy="spectral:0.99", rank_ladder=(64, 128,
    256)`` for 6 steps through the ``Trainer``: exact counts (one more
    projection per probed leaf on the refresh steps), the card's probe of
    one refresh gradient against the CPU's, the map decided for each
    family, the refresh steps against phase 4's."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig, find_lowrank_states, gather_probes
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    opt_cfg = OptimizerConfig(**GUM_130M, **POLICY_SPECTRAL)
    Recording = policy_trainer_class(torch)
    with scratch_dir("spectral") as ckpt_dir:
        trainer = Recording(build_model(cfg, device="cuda"), opt_cfg,
                            RunConfig(steps=6, ckpt_every=0, log_every=0, seed=0,
                                      ckpt_dir=ckpt_dir),
                            data, device="cuda", params=params0, dispatched=dispatched,
                            capture="blocks/attn/wq")
        at_decision: dict = {}
        ctrl = trainer.rank_ctrl
        maybe_update = ctrl.maybe_update

        def snapshot(opt_state, params):
            low = find_lowrank_states(opt_state)[0]
            if low.count == 3:  # the first decision: step 1's projector and probe
                at_decision["proj"] = low.projs[trainer.capture].cpu()
                at_decision["probe"] = {k: v.cpu()
                                        for k, v in low.probes[trainer.capture].items()}
                at_decision["gathered"] = gather_probes(opt_state)
            return maybe_update(opt_state, params)

        ctrl.maybe_update = snapshot
        log: list = []
        timed_decisions(torch, trainer, log)
        result = trainer.train()
    print(f"rank policy (c) trainer {POLICY_SPECTRAL}: losses {result.losses}", flush=True)
    check(all(math.isfinite(v) for v in result.losses) and len(result.losses) == 6,
          f"rank policy (c): losses {result.losses}")
    energies = {f"{m}x{n}": round(float(pr["sv2"].sum() / pr["g2"]), 4)
                for (m, n), pr in at_decision["gathered"].items()}
    print(f"rank policy (c) decisions: {[(s, str(m)) for s, m in ctrl.history]}; captured "
          f"energy at rank {RANK_HI} by family (sum sv2 / g2): {energies}", flush=True)
    for ev in log:
        print(f"rank policy (c) migration to {ev['map']}: maybe_update (with the probes' "
              f"gather) {ev['ms']:.3f} ms; LowRankState bytes {ev['lowrank_bytes'][0]} -> "
              f"{ev['lowrank_bytes'][1]}; whole optimizer state bytes {ev['state_bytes'][0]} "
              f"-> {ev['state_bytes'][1]}", flush=True)
    check_step_counts("rank policy (c)", trainer, probed=7)
    check_probe(torch, trainer, at_decision)
    ms = [round(t * 1e3, 3) for t in result.step_seconds]
    print(f"rank policy (c) step ms: {ms}; refresh steps 1, 4: {ms[0]}, {ms[3]} "
          f"(phase 4's, no probes: {REFRESH_MS.get('slice')}); steady median "
          f"{statistics.median([ms[1], ms[2], ms[4], ms[5]]):.3f}", flush=True)


def phase_rank_policy(torch) -> dict:
    """Phase 4f: the rank-policy engine at llama-130m (phase 4's GUM).
    Returns the kernel launches of its runs ((a)'s updates and the
    trainers of (b) and (c)); the probe-cost timing after is not counted."""
    from repro_torch.kernels import build, launch_count
    from repro_torch.models import build_model

    cfg, _ = full_width_data()
    init = build_model(cfg, device="cuda")
    init.init_params(0)
    params0 = {k: v.detach().clone() for k, v in init.params().items()}
    del init
    build.reset_launches()
    with launch_count.count_launches() as dispatched:
        for fuse in (False, True):
            migration_contract(torch, params0, fuse)
        policy_trainer(torch, params0, dispatched)
        spectral_trainer(torch, params0, dispatched)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    probe_cost(torch, params0)
    return launches


# --------------------------------------------------------------------- phase 4g

# Phase 4's GUM and phase 4b's GaLore at period 8, so that a fault lands
# between two scheduled refreshes.
RESILIENT_GUM = dict(GUM_130M, period=8)
RESILIENT_GALORE = dict(name="galore", lr=1e-2, rank=256, period=8, weight_decay=0.0,
                        fuse_families=True, fused_epilogue=True)
GALORE_DISPATCH = {"project": 3, "back_project_epilogue": 3}
GALORE_LAUNCH = {"lowrank_update": 3, "back_project_epilogue": 3}
# ... on split parameters: the (768, 768) family's members split on rows
# (wq, wk, wv) and on columns (wo), so its epilogue launches once a cut.
SPLIT_GALORE_DISPATCH = {"project": 3, "back_project_epilogue": 4}
SPLIT_GALORE_LAUNCH = {"lowrank_update": 3, "back_project_epilogue": 4}


def logged_steps(trainer, period: int) -> list:
    """Wrap ``trainer.step_fn`` to log each executed step: (whether it
    refreshed the projectors — the low-rank count at entry on a period
    boundary —, whether its update applied, whether a fault was armed)."""
    from repro_torch.core import find_lowrank_states

    log, inner = [], trainer.step_fn

    def step_fn(params, opt_state, batch, *fault):
        refresh = find_lowrank_states(opt_state)[0].count % period == 0
        opt_state, metrics = inner(params, opt_state, batch, *fault)
        log.append((refresh, bool(metrics["update_applied"]), bool(fault and fault[0]["mode"])))
        return opt_state, metrics

    trainer.step_fn = step_fn
    return log


def resilient_run(torch, label: str, opt: dict, steps: int, want_dispatch: dict,
                  want_launch: dict, **kw):
    """Train llama-130m (phase 4's data, parameters from seed 0) for
    ``steps`` with resilience on; assert finite losses, ``final_step`` and
    the dispatch and launch counts of each applied step (a skipped step
    runs no update); return the trainer, its result, the step log and the
    launches."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg, data = full_width_data()
    with scratch_dir(label.replace(" ", "_")) as ckpt_dir:
        trainer = Trainer(build_model(cfg, device="cuda"), OptimizerConfig(**opt),
                          RunConfig(steps=steps, log_every=1, seed=0, ckpt_dir=ckpt_dir),
                          data, device="cuda", **kw)
        # A refresh step (about 4 s against a 0.31 s steady one) is flagged
        # as a straggler once ten steps are timed, and a straggler warning
        # drops that step's snapshot (the reference's rule), which would move
        # the rollback's target: the asserted trace needs the detector off.
        trainer.monitor.z = float("inf")
        log = logged_steps(trainer, opt["period"])
        build.reset_launches()
        with launch_count.count_launches() as dispatched:
            result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    print(f"{label}: losses {result.losses}; fault log {result.fault_log}; recovery trace "
          f"{result.recovery_trace}; counts {result.recovery_counts}; health events "
          f"{[(e['step'], e['kind']) for e in result.health_events]}", flush=True)
    check(result.final_step == steps and all(math.isfinite(v) for v in result.losses),
          f"{label}: final step {result.final_step}, losses {result.losses}")
    applied = sum(a for _, a, _ in log)
    per_step = {k: v / applied for k, v in dispatched.items()}
    check(per_step == want_dispatch,
          f"{label}: dispatch counts per applied step {per_step} != {want_dispatch}")
    per_step = {k: v / applied for k, v in launches.items() if v}
    check(per_step == want_launch,
          f"{label}: kernel launches per applied step {per_step} != {want_launch}")
    print(f"{label}: {len(log)} executed steps, {applied} applied; dispatch per applied step "
          f"{want_dispatch}; kernel launches per applied step {want_launch}", flush=True)
    return trainer, result, log, launches


def snapshot_round_trip(torch, trainer) -> None:
    """The snapshot of the trained GUM state (device to host) and its
    restore into the live parameters (host to device), each timed three
    times, and the round trip held bitwise."""
    from repro_torch.resilience import SnapshotRing
    from repro_torch.train.trainer import _copy_into

    params = trainer.model.params()
    detached = {k: p.detach() for k, p in params.items()}
    want = ({k: v.clone() for k, v in detached.items()}, trainer.opt_state)
    nbytes = sum(x.numel() * x.element_size() for _, x in flat_state(want)
                 if isinstance(x, torch.Tensor))
    ring, add_ms, restore_ms = SnapshotRing(2), [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.add(14, detached, trainer.opt_state)
        add_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved, state = ring.restore(ring.latest(), "cuda")
        _copy_into(params, saved)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        del saved
    diff = bitwise_diff(({k: p.detach() for k, p in params.items()}, state), want)
    check(not diff, f"resilience snapshot: the restored state differs: {diff[:8]}")
    print(f"resilience snapshot of llama-130m GUM (params and state, {nbytes} bytes): "
          f"device to host {[round(t, 1) for t in add_ms]} ms (median "
          f"{statistics.median(add_ms):.1f}), host to device into the live parameters "
          f"{[round(t, 1) for t in restore_ms]} ms (median {statistics.median(restore_ms):.1f}); "
          f"round trip bitwise", flush=True)


def extra_metrics_cost(torch, trainer, done: int) -> None:
    """Device time of the update-norm pass (``extra_metrics``, the
    profiler's range in ``launch/steps.py``) in one profiled steady step,
    beside the step's busy time."""
    from torch.autograd import DeviceType

    from repro_torch.data import build_stream

    stream = build_stream(trainer.data_cfg).resume(done)
    params, state = trainer.model.params(), trainer.opt_state
    state, _ = trainer.step_fn(params, state, {"tokens": torch.from_numpy(next(stream)).cuda()})
    torch.cuda.synchronize()
    with profiled(host=True) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(params, state, {"tokens": torch.from_numpy(next(stream)).cuda()})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    def device_us(ev, key: str) -> float:
        us = getattr(ev, key.replace("cuda", "device"), None)
        return us if us is not None else getattr(ev, key)

    events = prof.key_averages()
    ranges = [ev for ev in events if ev.key == "extra_metrics"]
    check(ranges, "resilience: the profiled step recorded no extra_metrics range")
    dev = sum(device_us(ev, "cuda_time_total") for ev in ranges)
    busy = sum(device_us(ev, "self_cuda_time_total") for ev in events
               if ev.device_type == DeviceType.CUDA)
    check(busy > 0, "resilience: the profiled step recorded no device time")
    got = f"{dev / 1e3:.3f} device ms" if dev > 0 else \
        "no device time attributed to the range (not measured)"
    print(f"resilience extra metrics in one profiled steady step (step {done + 2}): "
          f"{ranges[0].count} update-norm ranges, {got}, of the step's {busy / 1e3:.3f} busy ms "
          f"({step_ms:.3f} wall ms)", flush=True)


def phase_resilience(torch) -> dict:
    """Phase 4g: the resilience loop at llama-130m full width.  (a) GUM,
    period 8, 14 steps, ``ring=2,snapshot_every=4``, ``grad_nan@5`` and
    ``grad_spike@10*1e9``: exactly a skip at 5 and a rollback at 10 to the
    snapshot of step 8; the steady median beside phase 4's, the snapshot's
    and the rollback's ms, the extra metrics' device ms.  (b) GaLore
    (phase 4b's, period 8), 10 steps, ``refresh_zero@6``: the dead subspace
    forces a refresh that the next step runs.  Returns the launches of the
    two runs."""
    from repro_torch.core import find_lowrank_states

    gum_steps, galore_steps = 14, 10
    trainer, result, log, launches = resilient_run(
        torch, "resilience gum", RESILIENT_GUM, gum_steps, GUM_DISPATCH, GUM_LAUNCH,
        resilience="ring=2,snapshot_every=4", inject="grad_nan@5;grad_spike@10*1e9")
    check(result.fault_log == [(5, "grad_nan"), (10, "grad_spike")],
          f"resilience gum: fault log {result.fault_log}")
    want = [{"step": 5, "event": "nonfinite", "action": "skip", "target": None},
            {"step": 10, "event": "grad_spike", "action": "rollback", "target": 8}]
    check(result.recovery_trace == want, f"resilience gum: trace {result.recovery_trace}")
    check(result.recovery_counts == {"skip": 1, "refresh": 0, "rollback": 1, "restore": 0},
          f"resilience gum: counts {result.recovery_counts}")
    check(len(result.losses) == gum_steps - 1, f"resilience gum: {len(result.losses)} losses")
    steady = [t for (refresh, applied, fault), t in zip(log, result.step_seconds)
              if applied and not refresh and not fault]
    refresh = [round(t * 1e3, 3) for (r, _, _), t in zip(log, result.step_seconds) if r]
    steady_ms = statistics.median(steady) * 1e3
    print(f"resilience gum step ms: all {[round(t * 1e3, 3) for t in result.step_seconds]}; "
          f"steady median with resilience on {steady_ms:.3f} ({len(steady)} steps) against "
          f"phase 4's {STEADY_MS['slice']:.3f} ({steady_ms / STEADY_MS['slice'] - 1:+.2%}); "
          f"refresh steps {refresh}", flush=True)
    snapshot_round_trip(torch, trainer)
    extra_metrics_cost(torch, trainer, gum_steps)
    del trainer

    trainer, result, log, got = resilient_run(
        torch, "resilience galore", RESILIENT_GALORE, galore_steps, GALORE_DISPATCH,
        GALORE_LAUNCH, resilience="", inject="refresh_zero@6")
    check(result.fault_log == [(6, "refresh_zero")], f"resilience galore: {result.fault_log}")
    forced = [t for t in result.recovery_trace
              if t["event"] == "dead_subspace" and t["action"] == "refresh"]
    check(len(forced) == 1 and forced[0]["step"] in (6, 7) and
          len(result.recovery_trace) == 1, f"resilience galore: trace {result.recovery_trace}")
    at = forced[0]["step"] + 1  # the executed step after the forced refresh (no replays)
    check(log[at][0], f"resilience galore: step {at} did not recompute the projectors "
          f"(refresh flags {[r for r, _, _ in log]})")
    projs = [p for st in find_lowrank_states(trainer.opt_state) for p in st.projs.values()
             if p is not None]
    check(all(float(p.abs().max()) > 0 for p in projs),
          "resilience galore: a projector is still zero after the forced refresh")
    check(result.losses[-1] < result.losses[0],
          f"resilience galore: last loss {result.losses[-1]} >= first {result.losses[0]}")
    print(f"resilience galore step ms: {[round(t * 1e3, 3) for t in result.step_seconds]}; "
          f"refresh flags {[int(r) for r, _, _ in log]}; the forced refresh ran at step {at}",
          flush=True)
    return {k: launches.get(k, 0) + got.get(k, 0) for k in set(launches) | set(got)}


# --------------------------------------------------------------------- phase 4h

# Rows 1-5 on GUM's path: row 2 (the projection) is lowrank_update.cu's kernel
# without R, so four __global__ functions.
GUM_KERNELS = ("lowrank_update", "back_project", "gram", "poly_apply")
# llama-130m's hidden matrices by (m, n) family: wq, wk, wv, wo; w_gate,
# w_up; w_down.
LLAMA130M_FAMILIES = ("768x768", "768x2048", "2048x768")
LLAMA130M_LEAVES = 7


def csrc_symbols(kernels) -> dict[str, str]:
    """Each kernel's ``__global__`` function name, read from its source."""
    out = {}
    for name in kernels:
        text = (ROOT / KERNEL_META[name][0]).read_text()
        found = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                               r"(\w+)\s*\(", text))
        check(len(found) == 1, f"{KERNEL_META[name][0]}: __global__ functions {found}")
        out[name] = found.pop()
    return out


def trace_kernels(label: str, path: str, marks: list[str]) -> dict:
    """Load a Chrome trace of the trainer's profiler window and count, in
    each ``step N`` annotation of ``marks``, the device kernels of rows 1-5
    (by the ``__global__`` names in csrc/) launched inside it: a kernel
    belongs to the annotation that holds its launch call (its
    ``correlation``), or its own start where the trace has no launch call.
    Fails unless every mark is there and holds every one of the kernels.
    Returns {mark: {kernel: launches}}."""
    symbols = csrc_symbols(GUM_KERNELS)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("step ")}
    check(sorted(spans) == sorted(marks), f"{label}: trace annotations {sorted(spans)} != "
          f"{marks}")
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    counts = {mark: dict.fromkeys(GUM_KERNELS, 0) for mark in marks}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_launch = 0
    for e in kernels:
        corr = e.get("args", {}).get("correlation")
        ts = launched_at.get(corr, e["ts"])
        by_launch += corr in launched_at
        name = next((k for k, sym in symbols.items()
                     if re.search(rf"(^|\W){sym}(\W|$)", e["name"])), None)
        for mark, (a, b) in spans.items():
            if name is not None and a <= ts <= b:
                counts[mark][name] += 1
    for mark in marks:
        missing = [symbols[k] for k, n in counts[mark].items() if not n]
        check(not missing, f"{label}: no {missing} kernel inside the {mark!r} annotation of "
              f"{path} ({len(kernels)} device kernels in the trace)")
    print(f"{label} trace {os.path.getsize(path)} bytes, {len(events)} events, "
          f"{len(kernels)} device kernels ({by_launch} placed by their launch call); rows 1-5 "
          f"inside each annotation by __global__ name {symbols}: {counts} (a step launches "
          f"{GUM_LAUNCH})", flush=True)
    return counts


def check_run_log(label: str, path: str, steps: int, result, trainer) -> list:
    """Phase 4h's events.jsonl: a schema-1 header first and the counters
    last; loss and grad_norm at every step (the result's losses, bitwise);
    ``step`` spans tagged refresh on the refresh steps, steady elsewhere;
    rank, energy, drift and bias once per family on each refresh step
    (drift 1 at the first refresh, against the zero projector, and in
    [0, 1] after; energy and bias in [0, 1]); a ``gamma_slots`` event on
    each refresh step with gamma slots for each low-rank leaf; counters
    that agree with the records.  Returns the records."""
    from repro_torch.telemetry import SCHEMA_VERSION
    from repro_torch.telemetry.bus import read_jsonl

    recs = read_jsonl(path)
    period, gamma = trainer.opt_cfg.period, trainer.opt_cfg.gamma
    refreshes = [s for s in range(1, steps + 1) if (s - 1) % period == 0]
    check(recs[0]["kind"] == "header" and recs[0]["schema"] == SCHEMA_VERSION
          and recs[-1]["kind"] == "counters",
          f"{label}: the log opens with {recs[0]} and ends with {recs[-1]['kind']}")

    def named(kind, name):
        return [r for r in recs if r["kind"] == kind and r["name"] == name]

    losses = named("metric", "loss")
    check([r["step"] for r in losses] == list(range(1, steps + 1))
          and [r["value"] for r in losses] == result.losses,
          f"{label}: loss metrics {[(r['step'], r['value']) for r in losses]} != "
          f"{result.losses}")
    check([r["step"] for r in named("metric", "grad_norm")] == list(range(1, steps + 1)),
          f"{label}: grad_norm metrics at {[r['step'] for r in named('metric', 'grad_norm')]}")
    tags = {r["step"]: r["tags"]["kind"] for r in named("span", "step")}
    want = {s: "refresh" if s in refreshes else "steady" for s in range(1, steps + 1)}
    check(tags == want, f"{label}: step spans {tags} != {want}")
    for metric in ("rank", "energy", "drift", "bias"):
        got = sorted((r["step"], r["tags"]["family"]) for r in named("metric", metric))
        want = sorted((s, f) for s in refreshes for f in LLAMA130M_FAMILIES)
        check(got == want, f"{label}: {metric} metrics at {got} != {want}")
    for r in named("metric", "rank"):
        check(r["value"] == trainer.opt_cfg.rank, f"{label}: {r}")
    for r in named("metric", "energy") + named("metric", "bias"):
        check(0.0 <= r["value"] <= 1.0, f"{label}: {r} outside [0, 1]")
    for r in named("metric", "drift"):
        ok = r["value"] == 1.0 if r["step"] == refreshes[0] else 0.0 <= r["value"] <= 1.0
        check(ok, f"{label}: {r}: the first refresh's drift must read 1, later ones [0, 1]")
    slots = named("event", "gamma_slots")
    check([r["step"] for r in slots] == refreshes
          and all(len(r["data"]["leaves"]) == LLAMA130M_LEAVES
                  and all(len(leaf["slots"]) == gamma for leaf in r["data"]["leaves"])
                  for r in slots),
          f"{label}: gamma_slots events {[(r['step'], r['data']) for r in slots]}")
    counts, spans = recs[-1]["counts"], recs[-1]["spans"]
    events = collections.Counter(f"event.{r['name']}" for r in recs if r["kind"] == "event")
    span_n = collections.Counter(r["name"] for r in recs if r["kind"] == "span")
    check(counts == dict(events) and {k: v["count"] for k, v in spans.items()} == dict(span_n),
          f"{label}: counters {counts} {spans} disagree with the records {dict(events)} "
          f"{dict(span_n)}")
    return recs


def phase_telemetry(torch) -> dict:
    """Phase 4h: telemetry at llama-130m — phase 4's exact run (GUM, lr
    5e-3, rank 256, gamma 4, period 3, 6 steps, batch 8 x 1024, seed 0, its
    checkpoints) with ``OptimizerConfig(telemetry=True)`` and
    ``Trainer(telemetry="stdout=0", profile_steps="4:6")``: the losses
    bitwise phase 4's; each step's dispatch and launch counts GUM's, plus
    one projection (row 2) per leaf on the refresh steps (the spectrum
    probe; the drift and bias products are plain and uncounted); the run log
    as :func:`check_run_log` says; the report CLI in a child process; the
    profiler's Chrome trace holding rows 1-5's kernels inside the ``step 4``
    and ``step 5`` annotations.  Prints the step times beside phase 4's and
    the sizes of the log and the trace.  Returns the kernel launches."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.models import build_model

    steps, label = 6, "telemetry"
    cfg, data = full_width_data()
    with scratch_dir(label) as ckpt_dir:
        build.reset_launches()
        with launch_count.count_launches() as dispatched:
            trainer = policy_trainer_class(torch)(
                build_model(cfg, device="cuda"), OptimizerConfig(**GUM_130M, telemetry=True),
                RunConfig(steps=steps, log_every=1, seed=0, ckpt_dir=ckpt_dir), data,
                device="cuda", telemetry="stdout=0", profile_steps="4:6",
                dispatched=dispatched)
            result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        print(f"{label} llama-130m gum r=256 gamma=4 period=3 with telemetry: losses "
              f"{result.losses}; phase 4's {LOSSES['slice']}", flush=True)
        check(result.losses == LOSSES["slice"],
              f"{label}: losses {result.losses} are not bitwise phase 4's {LOSSES['slice']}")
        check_step_counts(label, trainer, probed=LLAMA130M_LEAVES)

        recs = check_run_log(label, result.events_path, steps, result, trainer)
        fam = {(r["name"], r["step"], r["tags"]["family"]): round(r["value"], 6) for r in recs
               if r["kind"] == "metric" and "tags" in r and r["name"] != "rank"}
        print(f"{label} run log {result.events_path}: {os.path.getsize(result.events_path)} "
              f"bytes, {len(recs)} records; family metrics {fam}", flush=True)
        proc = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.report", ckpt_dir],
                              capture_output=True, text=True, cwd=ROOT, timeout=120,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        print(f"{label} report (python -m repro_torch.telemetry.report, exit "
              f"{proc.returncode}):\n{proc.stdout}{proc.stderr}", flush=True)
        check(proc.returncode == 0, f"{label}: the report CLI exited {proc.returncode}")
        check(trainer.trace_path is not None
              and os.path.dirname(trainer.trace_path) == os.path.join(ckpt_dir, "profile"),
              f"{label}: trace {trainer.trace_path} not under {ckpt_dir}/profile")
        trace_kernels(label, trainer.trace_path, ["step 4", "step 5"])

    ms = [round(t * 1e3, 3) for t in result.step_seconds]
    plain = statistics.median(ms[1:3])
    print(f"{label} step ms: {ms}; steady median unprofiled (steps 2, 3) {plain:.3f}, "
          f"profiled (steps 5, 6) {statistics.median(ms[4:6]):.3f}, phase 4's steady median "
          f"{STEADY_MS['slice']:.3f} ({plain / STEADY_MS['slice'] - 1:+.2%}); refresh steps "
          f"1, 4: {ms[0]}, {ms[3]}, phase 4's {REFRESH_MS['slice']}", flush=True)
    return launches


# --------------------------------------------------------------------- phase 4i

# Fused GUM's dispatches per step (3 family stacks): each family's momentum
# update and NS in the projected space, and its slots' projection,
# back-projection and NS; a split family runs them on its rows, so every
# rank dispatches these each step.  Kernel launches follow
# (lowrank_update runs lowrank_update and project; NS 5 gram + 5 poly_apply).
FUSED_GUM_DISPATCH = {"lowrank_update": 3, "project": 3, "back_project": 6,
                      "newton_schulz": 6}
FUSED_GUM_LAUNCH = {"lowrank_update": 6, "back_project": 6, "gram": 30, "poly_apply": 30}
DIST_STEPS = 4
# The split-parameter runs stop before step 4's refresh (to hold 4i's cost):
# each is held to its twin's losses and parameters after step 3.
SPLIT_STEPS = DIST_STEPS - 1
# shard_state on against off on the card: Newton–Schulz's batched Frobenius
# norm rounds a rank's rows of a stack otherwise than the whole stack (3e-5
# on a norm of ~440 at 24 of 48 rows; tools/ns_norm_stack_invariance.py),
# a relative change of 7e-8 to the normalised momentum; the losses moved by
# 7e-8 at step 3 where it was first read.  The parameters are held after
# step 3 and, looser, after step 4: that step's refresh runs the rank-256
# SVD on a gradient that differs in its last bits, which rotates the
# near-degenerate directions of the subspace (3.6e-4 where first read; the
# same effect puts phase 4's losses 9e-5 from the mesh run's).  The losses
# of steps 1-4 are computed before step 4's update.
SHARD_LOSS_TOL = 1e-6
SHARD_PARAM_TOL = 1e-6
REFRESH_PARAM_TOL = 1e-3


def distributed_rank(mesh, inputs: dict) -> dict:
    """Phase 4i, one of two ranks on the one card: phase 4's GUM with
    ``fuse_families`` through ``Trainer(mesh=...)`` (this rank's 4 x 1024 of
    the 8 x 1024 batch, fp32 gradient all-reduce), ``shard_state`` off then
    on, 4 steps each, then the same two on split parameters
    (``shard_params``) for ``SPLIT_STEPS``.  Returns per run the losses,
    digests of the final parameters and of those after step 3, each step's
    collectives and dispatches, the kernel launches, this rank's
    family-state bytes beside ``family_state_bytes``, the step times and
    the peak by part of the step; for the run with shard_state, the largest
    relative Frobenius distance of a parameter leaf to the run without it,
    after step 3 and after step 4; for a split run, :func:`split_record`'s
    checks and that distance to its twin after step 3."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.launch.steps as steps_mod
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.core.combinators import slot_projector_bytes, strip_slot_projectors
    from repro_torch.kernels import build, launch_count
    from repro_torch.kernels.collective_count import record_collectives, tally
    from repro_torch.models import build_model
    from repro_torch.sharding import family_state_bytes
    from repro_torch.train import Trainer

    out, replicated, finals = {}, None, {}
    for shard, split in ((False, False), (True, False), (False, True), (True, True)):
        label = {(False, False): "replicated", (True, False): "shard",
                 (False, True): "split", (True, True): "split shard"}[shard, split]
        held_before = torch.cuda.memory_allocated()  # what earlier runs left allocated
        cfg, data = full_width_data()
        model = build_model(cfg, device="cuda")
        opt_cfg = OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4, period=3,
                                  fuse_families=True, shard_state=shard)
        trainer = Trainer(model, opt_cfg,
                          RunConfig(steps=SPLIT_STEPS if split else DIST_STEPS, log_every=0,
                                    seed=0, ckpt_dir=os.path.join(inputs["dir"], label)),
                          data, device="cuda", mesh=mesh, shard_params=split)
        trainer.monitor.z = float("inf")
        steps, logs = [], []
        inner = trainer.step_fn

        before_refresh = {}

        # the peak by part of the step: up to the gradient reduction (the
        # forward and backward), from it to the step's end (the reduction
        # and the update), and between steps (the final checkpoint's save)
        parts = {"backward": 0, "update": 0}

        def mark(part):
            parts[part] = max(parts[part], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        def counted(*args, inner=inner, trainer=trainer):
            with record_collectives() as log, launch_count.count_launches() as dispatched:
                result = inner(*args)
            mark("update")
            logs.append(log)
            steps.append({"collectives": tally(log),
                          "dtypes": {f"{e['op']}:{e['tag']}": e["dtype"] for e in log},
                          "bytes": {f"{e['op']}:{e['tag']}": e["bytes"] for e in log},
                          "dispatch": dict(dispatched)})
            if len(steps) == SPLIT_STEPS:  # the last update before step 4's refresh
                before_refresh.update(trainer.whole_params("cpu"))
            torch.cuda.reset_peak_memory_stats()
            return result

        trainer.step_fn = counted
        build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reduce_name = "reduce_split_gradients" if split else "reduce_gradients"
        reduce = getattr(steps_mod, reduce_name)

        def marked(*args, reduce=reduce):
            mark("backward")
            return reduce(*args)

        setattr(steps_mod, reduce_name, marked)
        try:
            result = trainer.train()
        finally:
            setattr(steps_mod, reduce_name, reduce)
        torch.cuda.synchronize()
        parts["save"] = torch.cuda.max_memory_allocated()
        peak = max(parts.values()) / 2**30
        launches = dict(build.LAUNCHES)
        final = trainer.whole_params("cpu")
        param_rel = None
        if replicated is None:
            replicated = (before_refresh, final)
        elif label == "shard":
            param_rel = [_leaf_rel(got, want)
                         for got, want in zip((before_refresh, final), replicated)]
        like = trainer._like()
        total, per_shard = family_state_bytes(trainer.optimizer.init(like), mesh.shape["data"])
        bare = strip_slot_projectors(trainer.opt_state)
        slot_projs = slot_projector_bytes(trainer.opt_state)
        out[label] = {"losses": result.losses, "digest": _digest(final),
                      "digest3": _digest(before_refresh),
                      "steps": steps, "launches": launches,
                      "held": family_state_bytes(bare, 1)[0], "rule": per_shard,
                      "whole": total, "slot_projs": slot_projs,
                      "seconds": [round(t, 4) for t in result.step_seconds],
                      "param_rel": param_rel, "peak_gib": peak,
                      "held_before_gib": held_before / 2**30,
                      "peak_parts": {k: round(v / 2**30, 3) for k, v in parts.items()}}
        finals[label] = before_refresh  # after step 3, the split runs' last
        if split:
            twin = finals["shard" if shard else "replicated"]
            out[label] |= split_record(torch, trainer, mesh, logs, cfg)
            out[label]["twin_rel"] = _leaf_rel(final, twin)
        # the loop's closures hold the trainer and its step, and ``like`` views
        # the parameters: drop them too, or the next run starts with this
        # one's parameters and state allocated
        del trainer, model, bare, final, counted, inner, marked, like
        gc.collect()
        torch.cuda.empty_cache()
    del replicated, finals
    out |= distributed_paths(torch, mesh, inputs)
    out["tp"] = tensor_parallel_rank(torch, mesh, inputs)
    return out


# Phase 4i's tensor-parallel runs on a (data=1, model=2) mesh over the
# spawn's two ranks, each 3 steps (a refresh and two steady steps) held to
# its one-process phase's first 3 (the twin: that phase's parameters after
# step 3): phase 4's GUM (per leaf; rows 1-5) and phase 4b's GaLore
# (family-stacked with the fused epilogue, so row 6 on the model-axis cuts:
# the (768, 768) family's wq / wk / wv on columns and wo on rows, one launch
# a cut, as SPLIT_GALORE_*).  The row-parallel sums round otherwise than one
# GEMM, and the rank-256 SVD of the refresh turns such a difference into a
# rotation of the subspace, so the first loss is held to 1e-6, the later
# ones to TP_LOSS_TOL and each parameter leaf to its run's limit (GUM's
# Newton-Schulz step is blind to a rotation inside the subspace, GaLore's
# Adam moments are not).  The basis (tools/tp_loss_spread.py on an H100,
# PERF.md section 6; seeds 0-2, a rerun bitwise): steps 2-3 read at most
# 8.12e-5 (GUM) and 1.69e-4 (GaLore) from one process, the farthest leaf
# 4.90e-4 and 2.35e-3; with Megatron's f skipping its backward all-reduce
# 3.83e-2 and 5.63e-2, the leaf 0.255 and 0.345.  1e-3 (losses) lies 5.9x
# above the larger reading and 38x below the smaller control, GUM's 1e-3
# (REFRESH_PARAM_TOL) 2x and 255x, GaLore's 1e-2 4.3x and 35x.  Each rank
# holds llama-130m's model-split leaves halved and its 19200 norm parameters
# whole (sharding.per_shard_bytes over the model axis).
TP_STEPS = 3
TP_RUNS = {"tp": ("slice", GUM_130M, GUM_DISPATCH, GUM_LAUNCH, REFRESH_PARAM_TOL),
           "tp galore": ("galore", GALORE_130M, SPLIT_GALORE_DISPATCH, SPLIT_GALORE_LAUNCH,
                         1e-2)}
TP_TWINS: dict = {phase: {"step": TP_STEPS} for phase, *_ in TP_RUNS.values()}
TP_LOSS_TOL = 1e-3
TP_PARAM_BYTES = 219098112
# Row 7 on a rank's heads: its forward at attn_impl="pallas" against "xla"
# on the same parameters, the logits by serve-llama's fp32 rule.
TP_ATTN_TOL = 1e-4


def tensor_parallel_attention(torch, trainer, cfg, data) -> dict:
    """Row 7 on this rank's 6 of llama-130m's 12 heads: one forward and loss
    of the tensor-parallel model (its trained parameters, a seeded batch of
    ``data``'s shape, alike on both ranks) at ``attn_impl="pallas"`` and at
    ``"xla"``.  Returns the relative Frobenius distance of this rank's
    vocab columns of the logits, both losses, and each forward's
    flash_attention launches."""
    from repro_torch.kernels import build
    from repro_torch.models import lm_loss

    model, split = trainer.model, trainer.param_split
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (data.global_batch, data.seq_len), generator=gen,
                           device="cuda")
    logits, out = {}, {"loss": {}, "launches": {}}
    for impl in ("xla", "pallas"):
        build.reset_launches()
        with torch.no_grad(), with_config(model, attn_impl=impl), split.gathered():
            logits[impl] = model(tokens)
            out["loss"][impl] = float(lm_loss(logits[impl], tokens))
        torch.cuda.synchronize()
        out["launches"][impl] = build.LAUNCHES.get("flash_attention", 0)
    out["columns"] = logits["pallas"].shape[-1]
    out["rel"] = float((logits["pallas"] - logits["xla"]).norm() / logits["xla"].norm())
    del logits
    return out


def tensor_parallel_rank(torch, mesh, inputs: dict) -> dict:
    """Phase 4i's tensor-parallel runs, on one of the two ranks: a (data=1,
    model=2) mesh over the spawn's group, each of ``TP_RUNS`` through
    ``Trainer(mesh=)`` on the whole 8 x 1024 batch for ``TP_STEPS`` steps,
    and after GUM's :func:`tensor_parallel_attention`.  Returns per run its
    losses, the gathered parameters' digest (rank 0: the parameters, on the
    host), each step's dispatches, every collective of the last step and the
    findings of every step's against ``analysis.collectives``' model, the
    kernel launches and integer arguments, the parameter bytes this rank
    holds beside ``per_shard_bytes``, the step times and the peak."""
    from repro_torch.analysis.collectives import (
        collect_collectives,
        collective_schedule_findings,
        expected_collective_schedule,
    )
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.kernels.collective_count import record_collectives
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import per_shard_bytes
    from repro_torch.train import Trainer

    tp_mesh = Mesh((1, 2), ("data", "model"), group=mesh.group, backend=mesh.backend)
    cfg, data = full_width_data()
    runs = {}
    for label, (_, opt, *_) in TP_RUNS.items():
        t0 = time.perf_counter()
        held_before = torch.cuda.memory_allocated()
        trainer = Trainer(build_model(cfg, device="cuda"), OptimizerConfig(**opt),
                          RunConfig(steps=TP_STEPS, log_every=0, seed=0,
                                    ckpt_dir=os.path.join(inputs["dir"], label.replace(" ", "_"))),
                          data, device="cuda", mesh=tp_mesh)
        trainer.monitor.z = float("inf")
        steps, logs = [], []
        inner = trainer.step_fn

        def counted(*args, inner=inner, steps=steps, logs=logs):
            with record_collectives() as log, launch_count.count_launches() as dispatched:
                result = inner(*args)
            logs.append(log)
            steps.append(dict(dispatched))
            return result

        trainer.step_fn = counted
        build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(build.LAUNCHES)
        calls = {k: dict(v) for k, v in build.CALLS.items()}
        split = trainer.param_split
        like = split.standins()
        findings = []
        for i, log in enumerate(logs):
            expected = expected_collective_schedule(
                trainer.optimizer, like, n_shards=1, reduce_dtype=torch.float32,
                param_split=split, remat=cfg.remat, step=i + 1,
                tensor_parallel={"cfg": cfg, "rows": data.global_batch, "seq": data.seq_len})
            findings += [f"step {i + 1}: {f.format()}" for f in collective_schedule_findings(
                collect_collectives(log), expected, reduce_dtype=torch.float32)]
        final = trainer.whole_params("cpu")
        out = {"losses": result.losses, "digest": _digest(final), "dispatch": steps,
               "launches": launches, "calls": calls, "findings": findings, "peak_gib": peak,
               "held_before_gib": held_before / 2**30,
               "seconds": [round(t, 4) for t in result.step_seconds],
               "param_bytes": sum(p.numel() * p.element_size()
                                  for p in trainer.model.params().values()),
               "param_rule": per_shard_bytes(like, tp_mesh, ("model",)),
               "schedule": {k: (v["count"], v.get("axis"), v["payload_bytes"])
                            for k, v in expected.items()
                            if isinstance(v, dict) and v.get("count")},
               "log": [(e["op"], e["tag"], e["axis"], e["dtype"], e["bytes"])
                       for e in logs[-1]]}
        if tp_mesh.rank == 0:
            out["params"] = final
        if label == "tp":
            out["attention"] = tensor_parallel_attention(torch, trainer, cfg, data)
        del trainer, inner, counted, like, split, final
        gc.collect()
        torch.cuda.empty_cache()
        out["wall_s"] = time.perf_counter() - t0
        runs[label] = out
    return runs


def check_tensor_parallel(ranks: list) -> dict:
    """Phase 4i's tensor-parallel runs held on the parent against their
    phases' first ``TP_STEPS`` steps (:func:`tensor_parallel_rank`), and
    row 7 on each rank's heads against ``"xla"``; every reading is printed
    before it is held.  Returns both ranks' kernel launches."""
    launches: dict = collections.Counter()
    for label, (phase, _, want_dispatch, want_launch, param_tol) in TP_RUNS.items():
        want = LOSSES[phase][:TP_STEPS]
        twin = TP_TWINS[phase]["params"]
        PHASE_CALLS[label] = {}
        for k, rank in enumerate(ranks):
            run = rank["tp"][label]
            losses = run["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            per_step = {n: v / TP_STEPS for n, v in run["launches"].items() if v}
            ops = collections.defaultdict(list)
            for op, tag, axis, dtype, nbytes in run["log"]:
                ops[f"{op}:{tag}@{axis}"].append((dtype, nbytes))
            calls = {key: (len(v), sorted(set(v))) for key, v in ops.items()}
            print(f"4i rank {k} {label} (data=1, model=2; {TP_STEPS} steps of 8 x 1024 on each "
                  f"rank): losses {losses} (relative to {phase}'s "
                  f"{[float(f'{r:.3g}') for r in rel]}; first within 1e-6, the rest within "
                  f"{TP_LOSS_TOL}); parameters {run['param_bytes']} bytes a rank "
                  f"(per_shard_bytes over model {run['param_rule']}); step s {run['seconds']}; "
                  f"the run {run['wall_s']:.1f} s; peak {run['peak_gib']:.3f} GiB (allocated at "
                  f"its start {run['held_before_gib']:.3f}; {phase}: {PEAK_GIB[phase]:.3f}); "
                  f"step 3's collectives (calls, [(dtype, bytes)]) {calls}; the model's "
                  f"{run['schedule']}; findings {run['findings']}; dispatch {run['dispatch']}; "
                  f"launches per step {per_step}; row 6's (L, m, r, n, right, w_bf16) "
                  f"{sorted(run['calls'].get('back_project_epilogue', {}))}", flush=True)
            check(len(losses) == TP_STEPS and rel[0] <= 1e-6 and max(rel) <= TP_LOSS_TOL,
                  f"4i rank {k} {label}: losses {losses} against {phase}'s {want}: {rel}")
            check(not run["findings"], f"4i rank {k} {label}: collectives against the model: "
                  f"{run['findings']}")
            check(run["param_bytes"] == run["param_rule"] == TP_PARAM_BYTES,
                  f"4i rank {k} {label}: {run['param_bytes']} parameter bytes, per_shard_bytes "
                  f"{run['param_rule']}, want {TP_PARAM_BYTES}")
            for i, st in enumerate(run["dispatch"]):
                check(st == want_dispatch, f"4i rank {k} {label} step {i + 1}: dispatch {st}")
            check(per_step == want_launch, f"4i rank {k} {label}: launches per step {per_step}")
            launches.update(run["launches"])
            for name, got in run["calls"].items():
                mine = PHASE_CALLS[label].setdefault(name, {})
                for key, v in got.items():
                    mine[key] = mine.get(key, 0) + v
        got = ranks[0]["tp"][label]["params"]
        rels = {k: _leaf_rel({k: p}, {k: twin[k]}) for k, p in got.items()}
        worst = max(rels, key=rels.get)
        print(f"4i {label}: digests {[r['tp'][label]['digest'][:16] for r in ranks]}; each "
              f"leaf's relative Frobenius distance to {phase}'s after step {TP_STEPS} (limit "
              f"{param_tol}): { {k: float(f'{v:.3g}') for k, v in rels.items()} }", flush=True)
        check(ranks[0]["tp"][label]["digest"] == ranks[1]["tp"][label]["digest"],
              f"4i {label}: the ranks' gathered parameters differ")
        check(rels[worst] <= param_tol,
              f"4i {label}: parameters after step {TP_STEPS} against {phase}'s: {worst} "
              f"{rels[worst]!r} relative (limit {param_tol})")
    n_layers = full_width_data()[0].n_layers
    for k, rank in enumerate(ranks):
        attn = rank["tp"]["tp"]["attention"]
        print(f"4i rank {k} tp row 7 on its 6 of 12 heads: one forward at attn_impl=pallas "
              f"against xla, its {attn['columns']} vocab columns of the logits "
              f"{attn['rel']:.3e} relative (limit {TP_ATTN_TOL}); losses {attn['loss']}; "
              f"flash_attention launches {attn['launches']}", flush=True)
        check(attn["rel"] <= TP_ATTN_TOL and attn["launches"] == {"xla": 0, "pallas": n_layers},
              f"4i rank {k} tp row 7: pallas vs xla {attn}")
        launches["flash_attention"] += attn["launches"]["pallas"]
    return dict(launches)


# Phase 4i's split parameters (shard_params): llama-130m's parameter bytes a
# rank at data=2 by sharding.per_shard_bytes (every leaf divides but
# final_norm's (768,)), against 438119424 whole.
SPLIT_PARAM_BYTES = 219061248


def split_record(torch, trainer, mesh, logs: list, cfg) -> dict:
    """A split-parameter run's own checks, on its rank: the parameter bytes
    it holds beside ``per_shard_bytes``, and every step's collectives
    against ``analysis.collectives``' model (the counts of each op and tag,
    and a steady step's findings)."""
    from repro_torch.analysis.collectives import (
        collect_collectives,
        collective_schedule_findings,
        expected_collective_schedule,
    )
    from repro_torch.kernels.collective_count import tally
    from repro_torch.sharding import per_shard_bytes

    split = trainer.param_split
    like = split.standins()
    held = sum(p.numel() * p.element_size() for p in trainer.model.params().values())
    findings, model_counts = [], []
    for i, log in enumerate(logs):
        expected = expected_collective_schedule(
            trainer.optimizer, like, n_shards=mesh.shape["data"], reduce_dtype=torch.float32,
            shard_state=trainer.shard_state, param_split=split, remat=cfg.remat, step=i + 1)
        findings += [f"step {i + 1}: {f.format()}" for f in collective_schedule_findings(
            collect_collectives(log), expected, reduce_dtype=torch.float32)]
        model_counts.append(tally(log))
    sched = {k: v for k, v in expected.items() if isinstance(v, dict) and v.get("count")}
    return {"param_bytes": held, "param_rule": per_shard_bytes(like, mesh),
            "param_whole": sum(p.numel() * p.element_size() for p in like.values()),
            "findings": findings, "schedule": {
                k: (v["count"], v.get("dtype"), v["payload_bytes"]) for k, v in sched.items()}}


def split_against_twin(run: dict, twin: dict, twin_digest: str = "digest3") -> tuple[bool, str]:
    """A split run against its replicated twin: whether it holds, and
    "bitwise", or the first step whose loss differs with its relative
    distance and the largest parameter leaf's relative Frobenius distance
    (``run["twin_rel"]``).  The split run's final parameters are held to
    the twin's ``twin_digest`` (its parameters after as many steps).  Short
    of bitwise it holds when every loss is within ``SHARD_LOSS_TOL`` and the
    parameters within ``REFRESH_PARAM_TOL`` (a refresh's SVD turns a
    last-bit difference into a rotation, as ``shard_state``'s does)."""
    want = twin["losses"][:len(run["losses"])]
    if run["losses"] == want and run["digest"] == twin[twin_digest]:
        return True, "bitwise"
    rels = [abs(a - b) / abs(b) for a, b in zip(run["losses"], want)]
    first = next((i for i, r in enumerate(rels) if r), None)
    where = "losses bitwise" if first is None else (
        f"first differing step {first + 1}, loss {rels[first]!r} relative (within "
        f"{SHARD_LOSS_TOL}: {rels[first] <= SHARD_LOSS_TOL})")
    ok = max(rels) <= SHARD_LOSS_TOL and run["twin_rel"] <= REFRESH_PARAM_TOL
    return ok, f"{where}; parameters {run['twin_rel']!r} relative"


def check_split_runs(ranks: list) -> dict:
    """Phase 4i's split-parameter runs (``Trainer(shard_params=True)``), held
    on the parent: (i) phase 4's GUM, ``shard_state`` off, against the
    replicated run of the same spawn; (ii) with ``shard_state``, against the
    run with it; ``SPLIT_STEPS`` steps each, held to the twin's first
    ``SPLIT_STEPS``.  Each: the losses and the gathered parameters bitwise (or
    the first step that differs, reported; :func:`split_against_twin`);
    each rank's parameter bytes those of ``per_shard_bytes``
    (``SPLIT_PARAM_BYTES``); every step's collectives equal to
    ``analysis.collectives``' model (no finding); fused GUM's dispatches and
    rows 1-5's launches as the replicated run's; the per-rank peak printed
    beside the twin's.  Returns their launches."""
    launches: dict = collections.Counter()
    for label, twin_label in (("split", "replicated"), ("split shard", "shard")):
        for k, rank in enumerate(ranks):
            run, twin = rank[label], rank[twin_label]
            ok, verdict = split_against_twin(run, twin)
            check(ok, f"4i rank {k} {label}: against {twin_label}: {verdict}")
            check(run["param_bytes"] == run["param_rule"] == SPLIT_PARAM_BYTES,
                  f"4i rank {k} {label}: {run['param_bytes']} parameter bytes, per_shard_bytes "
                  f"{run['param_rule']}, want {SPLIT_PARAM_BYTES}")
            check(not run["findings"], f"4i rank {k} {label}: collectives against the model: "
                  f"{run['findings']}")
            for i, st in enumerate(run["steps"]):
                check(st["dispatch"] == FUSED_GUM_DISPATCH,
                      f"4i rank {k} {label} step {i + 1}: dispatch {st['dispatch']}")
            per_step = {n: v / SPLIT_STEPS for n, v in run["launches"].items() if v}
            check(per_step == FUSED_GUM_LAUNCH,
                  f"4i rank {k} {label}: launches per step {per_step}")
            launches.update(run["launches"])
            st = run["steps"][1]
            print(f"4i rank {k} {label} (shard_params, {SPLIT_STEPS} steps): against "
                  f"{twin_label}'s first {SPLIT_STEPS}: {verdict}; "
                  f"losses {run['losses']}; parameters {run['param_bytes']} bytes a rank "
                  f"(per_shard_bytes {run['param_rule']}, whole {run['param_whole']}); per "
                  f"step {st['collectives']} bytes {st['bytes']} dtypes {st['dtypes']} (the "
                  f"model's {run['schedule']}); dispatch {st['dispatch']}; step s "
                  f"{run['seconds']}; peak {run['peak_gib']:.3f} GiB {run['peak_parts']} "
                  f"(allocated at its start {run['held_before_gib']:.3f}; {twin_label}: "
                  f"{twin['peak_gib']:.3f} GiB {twin['peak_parts']})", flush=True)
        check(ranks[0][label]["digest"] == ranks[1][label]["digest"],
              f"4i {label}: the ranks' gathered parameters differ")
    return dict(launches)


# Phase 4i's runs of bf16 storage, the fused epilogue under shard_state and
# the projected-space accumulator on a mesh, each 3 steps (period 3: the
# refresh at step 1) from the same seed as its one-process twin: phase 4k's
# bf16-stored GUM (family-stacked, shard_state), phase 4k's fused GaLore
# (bf16 W, weight decay 0.01, shard_state) and phase 4d's projected-space
# accumulator (2 local microbatches a rank).
PATH_STEPS = 3
MESH_GALORE = dict(name="galore", lr=1e-2, rank=256, period=3, weight_decay=0.01,
                   fuse_families=True, fused_epilogue=True)


def _leaf_rel(got: dict, want: dict) -> float:
    """The largest relative Frobenius distance of a leaf of ``got`` to the
    same leaf of ``want``, in fp32."""
    import torch

    return max(float(torch.linalg.vector_norm(p.float() - want[k].float())
                     / torch.linalg.vector_norm(want[k].float())) for k, p in got.items())


def _digest(params: dict) -> str:
    import hashlib

    digest = hashlib.sha256()
    for k, p in params.items():
        digest.update(k.encode())
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def _mesh_trainer_run(torch, mesh, inputs: dict, label: str, opt: dict,
                      shard_params: bool = False, twin: dict | None = None,
                      keep_whole: bool = False) -> dict:
    """A bf16-stored llama-130m ``Trainer(mesh=)`` of ``opt`` under
    ``shard_state`` (and ``shard_params``) for ``PATH_STEPS`` steps: its
    losses, the digest of its (gathered) parameters, each step's
    collectives (with bytes) and dispatches, the kernel launches,
    instantiations and integer arguments, and the update all-gather's
    bytes by ``analysis.collectives``' model (under ``shard_params`` also
    :func:`split_record`'s checks).  ``twin`` (a replicated twin's final
    parameters on the CPU) adds ``twin_rel``, the largest leaf's relative
    distance to them; ``keep_whole`` returns the final parameters on the
    CPU as ``whole``."""
    from repro_torch.analysis.collectives import expected_collective_schedule
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.kernels.collective_count import record_collectives, tally
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg, data = full_width_data()
    model = build_model(cfg.replace(**BF16_STORAGE), device="cuda")
    opt_cfg = OptimizerConfig(**opt, shard_state=True)
    trainer = Trainer(model, opt_cfg,
                      RunConfig(steps=PATH_STEPS, log_every=0, seed=0,
                                ckpt_dir=os.path.join(inputs["dir"], label)),
                      data, device="cuda", mesh=mesh, shard_params=shard_params)
    trainer.monitor.z = float("inf")
    steps, logs, inner = [], [], trainer.step_fn

    def counted(*args):
        with record_collectives() as log, launch_count.count_launches() as dispatched:
            result = inner(*args)
        logs.append(log)
        steps.append({"collectives": tally(log),
                      "bytes": {f"{e['op']}:{e['tag']}": e["bytes"] for e in log},
                      "dtypes": {f"{e['op']}:{e['tag']}": e["dtype"] for e in log},
                      "dispatch": dict(dispatched)})
        return result

    trainer.step_fn = counted
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    result = trainer.train()
    torch.cuda.synchronize()
    like = trainer._like()
    model_gather = expected_collective_schedule(
        trainer.optimizer, like, n_shards=mesh.shape["data"], reduce_dtype=torch.float32,
        shard_state=True)["update_gather"]["payload_bytes"]
    whole = trainer.whole_params("cpu")
    out = {"losses": result.losses, "digest": _digest(whole), "steps": steps,
           "launches": dict(build.LAUNCHES),
           "variants": {k: dict(v) for k, v in build.VARIANTS.items()},
           "calls": {k: dict(v) for k, v in build.CALLS.items()},
           "model_gather": model_gather,
           "dtypes": sorted({str(p.dtype) for p in whole.values()}),
           "seconds": [round(t, 4) for t in result.step_seconds],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if shard_params:
        out |= split_record(torch, trainer, mesh, logs, cfg)
    if twin is not None:
        out["twin_rel"] = _leaf_rel(whole, twin)
    if keep_whole:
        out["whole"] = whole
    del whole
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_accum_run(torch, mesh) -> dict:
    """Phase 4d's ``gum_accum_tools`` on the mesh: this rank's 4 x 1024 rows
    of each of the first ``PATH_STEPS`` batches as 2 microbatches
    (``make_train_step(mesh=, lowrank_accum=)``); its losses, digest, each
    step's collectives with bytes and dispatches, the kernel launches, and
    the compact and full gradient bytes of ``analysis.collectives``' model.
    Rank 0 also returns its parameters."""
    from repro_torch.analysis.collectives import expected_collective_schedule
    from repro_torch.core import gum_accum_tools
    from repro_torch.data import build_stream
    from repro_torch.kernels import build, launch_count
    from repro_torch.kernels.collective_count import record_collectives
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    opt = {k: v for k, v in GUM_130M.items() if k != "name"}
    tools = gum_accum_tools(opt.pop("lr"), **opt)
    step = make_train_step(model, tools.transform, microbatches=2, lowrank_accum=tools,
                           mesh=mesh)
    params = model.params()
    state = tools.transform.init({k: p.detach() for k, p in params.items()})
    n, k = mesh.shape["data"], mesh.coordinate("data")
    stream = build_stream(data)
    per = data.global_batch // n
    losses, steps = [], []
    build.reset_launches()
    for _ in range(PATH_STEPS):
        tokens = torch.from_numpy(next(stream)[k * per:(k + 1) * per]).to("cuda")
        with record_collectives() as log, launch_count.count_launches() as dispatched:
            state, metrics = step(params, state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        steps.append({"collectives": [(f"{e['op']}:{e['tag']}", e["dtype"], e["bytes"])
                                      for e in log], "dispatch": dict(dispatched)})
    torch.cuda.synchronize()
    like = {key: torch.empty_like(p, device="meta") for key, p in params.items()}
    kw = dict(n_shards=n, reduce_dtype=torch.float32)
    model_bytes = {
        "compact": expected_collective_schedule(tools.transform, like, lowrank_accum=True,
                                                **kw)["grad_psum"]["payload_bytes"],
        "full": expected_collective_schedule(tools.transform, like,
                                             **kw)["grad_psum"]["payload_bytes"],
        "refresh": expected_collective_schedule(
            tools.transform, like, lowrank_accum=True, **kw)["refresh_broadcast"]["payload_bytes"]}
    out = {"losses": losses, "digest": _digest(params), "steps": steps,
           "launches": dict(build.LAUNCHES), "model_bytes": model_bytes,
           "params": {key: p.detach().cpu() for key, p in params.items()} if k == 0 else None}
    del step, state, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def distributed_paths(torch, mesh, inputs: dict) -> dict:
    """Phase 4i's new runs on one rank (see :func:`check_distributed_paths`)."""
    from repro_torch.kernels import build

    out = {"bf16 gum": _mesh_trainer_run(torch, mesh, inputs, "bf16_gum",
                                         dict(GUM_130M, fuse_families=True)),
           "bf16 galore": _mesh_trainer_run(torch, mesh, inputs, "bf16_galore", MESH_GALORE,
                                            keep_whole=True)}
    twin = out["bf16 galore"].pop("whole")
    out["split galore"] = _mesh_trainer_run(torch, mesh, inputs, "split_galore", MESH_GALORE,
                                            shard_params=True, twin=twin)
    del twin
    out["accum"] = _mesh_accum_run(torch, mesh)
    build.reset_launches()
    return out


def check_distributed_paths(torch, ranks: list) -> dict:
    """Phase 4i's new runs, held on the parent: (i) phase 4k's bf16-stored
    GUM with ``fuse_families`` and ``shard_state`` through ``Trainer(mesh=)``
    (fp32 reduction): the first loss within 1e-6 relative of phase 4k's
    (before any update; the later distances printed), per step 1 grad + 1
    loss all-reduce + 1 update all-gather, fused GUM's dispatches and rows
    1-5's launches on each rank, the ranks' parameters equal; (ii) phase
    4k's fused GaLore on bf16 storage under ``shard_state``: every row-6
    launch on each rank of its bf16-W instantiation, the update
    all-gather's bytes those of ``analysis.collectives``' model (the
    projector and projected update rows), the ranks' parameters equal;
    (iii) phase 4d's accumulator at 2 ranks x 2 microbatches against phase
    4d's one-process run at 4 microbatches of the same batches
    (``ACCUM_TWIN``): losses within ``SHARD_LOSS_TOL``, each parameter
    leaf's relative Frobenius distance within ``SHARD_PARAM_TOL`` (no
    second refresh in 3 steps), per step the refresh broadcast (steps on a
    boundary), the compact gradient all-reduce and the loss all-reduce,
    their bytes printed beside the full gradient's.  Returns the launches
    of the ranks."""
    launches: dict = collections.Counter()
    PHASE_CALLS["distributed galore"] = {}
    for k, rank in enumerate(ranks):
        for label in ("bf16 gum", "bf16 galore"):
            run = rank[label]
            check(run["dtypes"] == ["torch.bfloat16", "torch.float32"],
                  f"4i rank {k} {label}: parameter dtypes {run['dtypes']}")
            check(len(run["losses"]) == PATH_STEPS
                  and all(math.isfinite(v) for v in run["losses"]),
                  f"4i rank {k} {label}: losses {run['losses']}")
            want_d, want_l = ((FUSED_GUM_DISPATCH, FUSED_GUM_LAUNCH) if label == "bf16 gum"
                              else (GALORE_DISPATCH, GALORE_LAUNCH))
            for i, st in enumerate(run["steps"]):
                check(st["collectives"] == {"all_reduce:grad": 1, "all_reduce:loss": 1,
                                            "all_gather:update": 1},
                      f"4i rank {k} {label} step {i + 1}: collectives {st['collectives']}")
                check(st["dispatch"] == want_d,
                      f"4i rank {k} {label} step {i + 1}: dispatch {st['dispatch']}")
                check(st["bytes"]["all_gather:update"] == run["model_gather"],
                      f"4i rank {k} {label} step {i + 1}: update all-gather "
                      f"{st['bytes']['all_gather:update']} bytes, the model's "
                      f"{run['model_gather']}")
            per_step = {n: v / PATH_STEPS for n, v in run["launches"].items() if v}
            check(per_step == want_l, f"4i rank {k} {label}: launches per step {per_step}")
            launches.update(run["launches"])
            st = run["steps"][1]
            print(f"4i rank {k} {label} (shard_state, bf16 stored): losses {run['losses']}; "
                  f"per step {st['collectives']} dtypes {st['dtypes']} bytes {st['bytes']} "
                  f"(update all-gather: the model's {run['model_gather']}); dispatch "
                  f"{st['dispatch']}; launches per step {per_step}; step s {run['seconds']}",
                  flush=True)
        epi = rank["bf16 galore"]["variants"]["back_project_epilogue"]
        check(epi and all(key[4] == 1 for key in epi),
              f"4i rank {k} bf16 galore: row 6 instantiations {epi}, want the bf16-W one alone")
        print(f"4i rank {k} bf16 galore: row 6's {sum(epi.values())} launches all of its "
              f"bf16-W instantiation {sorted(epi)}", flush=True)
        calls = rank["bf16 galore"]["calls"]
        for name, got in calls.items():
            mine = PHASE_CALLS["distributed galore"].setdefault(name, {})
            for key, v in got.items():
                mine[key] = mine.get(key, 0) + v
    PHASE_CALLS["split galore"] = {}
    for k, rank in enumerate(ranks):
        run, twin = rank["split galore"], rank["bf16 galore"]
        ok, verdict = split_against_twin(run, twin, "digest")
        check(ok, f"4i rank {k} split galore against bf16 galore: {verdict}")
        check(run["param_bytes"] == run["param_rule"],
              f"4i rank {k} split galore: {run['param_bytes']} parameter bytes, "
              f"per_shard_bytes {run['param_rule']}")
        check(not run["findings"], f"4i rank {k} split galore: collectives against the "
              f"model: {run['findings']}")
        for i, st in enumerate(run["steps"]):
            check(st["dispatch"] == SPLIT_GALORE_DISPATCH,
                  f"4i rank {k} split galore step {i + 1}: dispatch {st['dispatch']}")
        per_step = {n: v / PATH_STEPS for n, v in run["launches"].items() if v}
        check(per_step == SPLIT_GALORE_LAUNCH,
              f"4i rank {k} split galore: launches per step {per_step}")
        epi = run["variants"]["back_project_epilogue"]
        check(epi and all(key[4] == 1 for key in epi),
              f"4i rank {k} split galore: row 6 instantiations {epi}, want the bf16-W one")
        cut = sorted(run["calls"]["back_project_epilogue"])
        launches.update(run["launches"])
        for name, got in run["calls"].items():
            mine = PHASE_CALLS["split galore"].setdefault(name, {})
            for key, v in got.items():
                mine[key] = mine.get(key, 0) + v
        print(f"4i rank {k} split galore (shard_params, shard_state, bf16 W): against bf16 "
              f"galore: {verdict}; parameters "
              f"{run['param_bytes']} bytes a rank (per_shard_bytes {run['param_rule']}); "
              f"row 6 on the parts, (L, m, r, n, right, w_bf16): {cut}; per step "
              f"{run['steps'][1]['collectives']} (the model's {run['schedule']}); launches "
              f"per step {per_step}; step s {run['seconds']}; peak {run['peak_gib']:.3f} GiB "
              f"(bf16 galore: {twin['peak_gib']:.3f} GiB)", flush=True)
    for label in ("bf16 gum", "bf16 galore", "split galore"):
        check(ranks[0][label]["digest"] == ranks[1][label]["digest"],
              f"4i {label}: the ranks' parameters differ")
    gum = ranks[0]["bf16 gum"]["losses"]
    want = LOSSES["bf16 gum"][:PATH_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(gum, want)]
    check(rel[0] <= SHARD_LOSS_TOL,
          f"4i bf16 gum: first loss {gum[0]} vs phase 4k's {want[0]} ({rel[0]:.3g} relative)")
    print(f"4i bf16 gum against phase 4k's one-process run: losses relative "
          f"{[float(f'{r:.3g}') for r in rel]} (the first held to {SHARD_LOSS_TOL}); ranks "
          f"equal (digest {ranks[0]['bf16 gum']['digest'][:16]})", flush=True)

    # (iii) the projected-space accumulator
    acc = [rank["accum"] for rank in ranks]
    twin = ACCUM_TWIN
    want_d, want_l = accum_counts(2, 7, 7)
    for k, run in enumerate(acc):
        for i, st in enumerate(run["steps"]):
            tags = [t for t, _, _ in st["collectives"]]
            refresh = i % GUM_130M["period"] == 0
            check(tags == ["broadcast:refresh"] * refresh + ["all_reduce:grad",
                                                             "all_reduce:loss"],
                  f"4i rank {k} accum step {i + 1}: collectives {st['collectives']}")
            grad = st["collectives"][refresh]
            check(grad[1] == "float32" and grad[2] == run["model_bytes"]["compact"],
                  f"4i rank {k} accum step {i + 1}: grad all-reduce {grad}, the model's "
                  f"{run['model_bytes']}")
            if refresh:
                check(st["collectives"][0][2] == run["model_bytes"]["refresh"],
                      f"4i rank {k} accum step {i + 1}: refresh broadcast "
                      f"{st['collectives'][0]}, the model's {run['model_bytes']}")
            check(st["dispatch"] == want_d,
                  f"4i rank {k} accum step {i + 1}: dispatch {st['dispatch']} != {want_d}")
        per_step = {n: v / PATH_STEPS for n, v in run["launches"].items() if v}
        check(per_step == want_l, f"4i rank {k} accum: launches per step {per_step}")
        launches.update(run["launches"])
    check(acc[0]["digest"] == acc[1]["digest"], "4i accum: the ranks' parameters differ")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(acc[0]["losses"], twin["losses"])]
    leaf_rel = {key: float(torch.linalg.vector_norm(p.float() - twin["params"][key].float())
                           / torch.linalg.vector_norm(twin["params"][key].float()))
                for key, p in acc[0]["params"].items()}
    worst = max(leaf_rel.items(), key=lambda kv: kv[1])
    check(max(loss_rel) <= SHARD_LOSS_TOL and worst[1] <= SHARD_PARAM_TOL,
          f"4i accum against phase 4d's one-process run: losses {loss_rel} (limit "
          f"{SHARD_LOSS_TOL}), worst leaf {worst} (limit {SHARD_PARAM_TOL})")
    mb = acc[0]["model_bytes"]
    print(f"4i accum 2 ranks x 2 microbatches against phase 4d's 4 microbatches: losses "
          f"{acc[0]['losses']} vs {twin['losses']} (relative "
          f"{[float(f'{r:.3g}') for r in loss_rel]}); worst parameter leaf {worst[0]} "
          f"{worst[1]!r}; per step {acc[0]['steps'][1]['collectives']} (refresh steps add "
          f"{acc[0]['steps'][0]['collectives'][0]}); the grad all-reduce carries "
          f"{mb['compact']} bytes, the full gradient's would be {mb['full']} "
          f"({mb['compact'] / mb['full']:.4f}); dispatch {acc[0]['steps'][1]['dispatch']}; "
          f"launches per step {per_step}", flush=True)
    return dict(launches)


class LocalMesh:
    """A one-rank data mesh whose all-reduce leaves its operand as it is:
    the step of ``make_train_step(mesh=LocalMesh(), reduce_dtype=bf16)`` is
    the no-mesh step with the gradients cast to bf16 and back."""

    axis_names = ("data",)
    shape = {"data": 1}
    data_axis = "data"

    def coordinate(self, axis: str) -> int:
        return 0

    def all_reduce(self, t, tag: str):
        return t


def nccl_step(torch) -> dict:
    """Phase 4i's NCCL path: a world-size-1 ``nccl`` process group runs one
    ``make_shardmap_train_step`` step (bf16 gradient all-reduce) of fused
    GUM at llama-130m on the 8 x 1024 batch, held bitwise to the no-mesh
    step given the same bf16 cast.  Returns its kernel launches."""
    import torch.distributed as dist

    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.data import build_stream
    from repro_torch.kernels import build
    from repro_torch.kernels.collective_count import record_collectives, tally
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.launch.shardmap_fsdp import make_shardmap_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg, data = full_width_data()
    opt = build_optimizer(OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4, period=3,
                                          fuse_families=True))
    batch = {"tokens": torch.from_numpy(build_stream(data).batch_at(0)).to("cuda")}
    with scratch_dir("nccl") as d:
        init_distributed("nccl", rank=0, world_size=1, init_method=f"file://{d}/store",
                         timeout=300)
        try:
            mesh = Mesh((1,), ("data",), group=dist.group.WORLD, backend="nccl")
            outs = []
            for kind in ("nccl", "plain"):
                model = build_model(cfg, device="cuda")
                model.init_params(0)
                params = model.params()
                state = opt.init({k: p.detach() for k, p in params.items()})
                if kind == "nccl":
                    step = make_shardmap_train_step(model, opt, mesh)
                    build.reset_launches()
                    with record_collectives() as log:
                        state, metrics = step(params, state, batch)
                    torch.cuda.synchronize()
                    launches = dict(build.LAUNCHES)
                else:
                    step = make_train_step(model, opt, mesh=LocalMesh(),
                                           reduce_dtype=torch.bfloat16)
                    state, metrics = step(params, state, batch)
                outs.append((float(metrics["loss"]),
                             {k: p.detach().clone() for k, p in params.items()}))
                del model, params, state
                gc.collect()
        finally:
            dist.destroy_process_group()
    (loss, got), (want_loss, want) = outs
    check(loss == want_loss and all(torch.equal(got[k], want[k]) for k in want),
          f"4i: the nccl step is not the no-mesh step with the bf16 cast "
          f"(loss {loss} vs {want_loss})")
    counts = tally(log)
    check(counts == {"all_reduce:grad": 1, "all_reduce:loss": 1}
          and log[0]["dtype"] == "bfloat16",
          f"4i: the nccl step's collectives {log}")
    print(f"4i nccl world 1: one make_shardmap_train_step step, loss {loss!r} bitwise the "
          f"no-mesh step with the bf16 cast; collectives {counts}, gradient "
          f"{log[0]['dtype']} {log[0]['bytes']} bytes", flush=True)
    del outs, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def one_process_run(torch) -> tuple[list, str]:
    """Phase 4i's one-process twin: the same fused GUM run with no mesh, at
    ``microbatches=2`` (rows 0-3 and 4-7 of each batch, the two ranks'
    rows, summed in fp32 and halved, as the all-reduce does).  Returns the
    losses and the parameters' digest."""
    import hashlib

    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg, data = full_width_data()
    with scratch_dir("distributed_twin") as d:
        trainer = Trainer(build_model(cfg, device="cuda"),
                          OptimizerConfig(name="gum", lr=5e-3, rank=256, gamma=4, period=3,
                                          fuse_families=True),
                          RunConfig(steps=DIST_STEPS, log_every=0, seed=0, ckpt_dir=d),
                          data, device="cuda", microbatches=2)
        result = trainer.train()
    digest = hashlib.sha256()
    for k, p in trainer.model.params().items():
        digest.update(k.encode())
        digest.update(p.detach().cpu().numpy().tobytes())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return result.losses, digest.hexdigest()


def phase_distributed(torch) -> dict:
    """Phase 4i: data parallelism at llama-130m full width.  Two ranks on
    the one card (NCCL refuses two ranks on one device, so the group runs
    ``gloo``, which takes the CUDA tensors itself: no host staging) run
    phase 4's GUM with ``fuse_families`` through ``Trainer(mesh=...)``:
    the global batch 8 x 1024 as 4 x 1024 a rank, fp32 gradient all-reduce,
    4 steps (refreshes at steps 1 and 4), ``shard_state`` off then on.
    Checks: the losses and parameters bitwise those of the one-process run
    at ``microbatches=2`` (:func:`one_process_run`: the same fp32 sum of
    the two halves' gradients), and the first loss (before any update)
    within 1e-6 of phase 4's (one mean of 8 rows against the mean of two
    means); the later losses' distance to phase 4's is printed, not held:
    the refresh's SVD at rank 256 turns the gradient's last-bit rounding
    into a subspace rotation (9e-5 relative at step 4 in the first run);
    the run without shard_state bitwise the twin, the run with it within
    ``SHARD_LOSS_TOL`` (losses) and ``SHARD_PARAM_TOL`` (each parameter
    leaf's relative Frobenius distance) of it; each rank's family-state bytes
    against ``family_state_bytes``; each step's collectives (1 gradient
    and 1 loss all-reduce, plus the update all-gather with shard_state)
    and fused GUM's dispatches; rows 1-5 launched on each rank.  The same
    spawn then runs bf16 storage and the accumulator on the mesh, held by
    :func:`check_distributed_paths` (after phase 4k and phase 4d, whose
    one-process runs are their twins): bf16-stored GUM and fused GaLore
    under ``shard_state`` (row 6 on a bf16 W), and the projected-space
    accumulator.  Then :func:`nccl_step`.  Step times are no yardstick: the
    two ranks share the card.  Returns the launches of both ranks and of
    the NCCL step."""
    from repro_torch.launch.mesh import run_local_ranks

    t0 = time.perf_counter()
    with scratch_dir("distributed") as d:
        ranks = run_local_ranks("chip_smoke:distributed_rank", 2, args=({"dir": d},),
                                workdir=os.path.join(d, "ranks"), backend="gloo",
                                timeout=600, threads=2, extra_path=[str(ROOT)])
    print(f"4i backend gloo (CUDA tensors, no host staging), world size 2, reduce dtype "
          f"float32 (Trainer), {DIST_STEPS} steps, 4 x 1024 rows a rank; ranks ran "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want = LOSSES["slice"][:DIST_STEPS]
    twin, twin_digest = one_process_run(torch)
    print(f"4i one-process run at microbatches=2: losses {twin}", flush=True)
    launches: dict = {}
    for k, rank in enumerate(ranks):
        for label in ("replicated", "shard"):
            run = rank[label]
            losses = run["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            if label == "replicated":
                check(losses == twin and run["digest"] == twin_digest,
                      f"4i rank {k} {label}: losses {losses} are not the one-process "
                      f"run's {twin}")
            check(len(losses) == DIST_STEPS and rel[0] <= 1e-6,
                  f"4i rank {k} {label}: first loss {losses[0]} vs phase 4's {want[0]}")
            for i, st in enumerate(run["steps"]):
                want_c = {"all_reduce:grad": 1, "all_reduce:loss": 1}
                if label == "shard":
                    want_c["all_gather:update"] = 1
                check(st["collectives"] == want_c,
                      f"4i rank {k} {label} step {i + 1}: collectives {st['collectives']}")
                check(st["dispatch"] == FUSED_GUM_DISPATCH,
                      f"4i rank {k} {label} step {i + 1}: dispatch {st['dispatch']}")
            per_step = {n: v / DIST_STEPS for n, v in run["launches"].items() if v}
            check(per_step == FUSED_GUM_LAUNCH,
                  f"4i rank {k} {label}: launches per step {per_step}")
            held, rule = run["held"], run["rule"]
            check(held == (rule if label == "shard" else run["whole"]),
                  f"4i rank {k} {label}: family state {held} bytes, rule {rule}")
            for n, v in run["launches"].items():
                launches[n] = launches.get(n, 0) + v
            st = run["steps"][1]
            print(f"4i rank {k} {label}: losses {losses} (rel to phase 4 "
                  f"{[float(f'{r:.3g}') for r in rel]}); "
                  f"family state {held} bytes (rule {rule}, whole {run['whole']}; slot "
                  f"projectors {run['slot_projs']}); per step {st['collectives']} dtypes "
                  f"{st['dtypes']} bytes {st['bytes']}; dispatch {st['dispatch']}; launches "
                  f"per step {per_step}; step s {run['seconds']}; peak "
                  f"{run['peak_gib']:.3f} GiB {run['peak_parts']} (allocated at its start "
                  f"{run['held_before_gib']:.3f})", flush=True)
        on, off = rank["shard"], rank["replicated"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"]))
        (p3, p4), limits = on["param_rel"], (SHARD_PARAM_TOL, REFRESH_PARAM_TOL)
        check(loss_rel <= SHARD_LOSS_TOL and p3 <= limits[0] and p4 <= limits[1],
              f"4i rank {k}: shard_state on against off: losses {loss_rel:.3g} relative "
              f"(limit {SHARD_LOSS_TOL}), parameters after steps 3 and 4 {p3:.3g}, {p4:.3g} "
              f"(limits {limits})")
        print(f"4i rank {k} shard_state on against off: losses "
              f"{[float(f'{abs(a - b) / abs(b):.3g}') for a, b in zip(on['losses'], off['losses'])]}"
              f" relative (limit {SHARD_LOSS_TOL}); largest parameter leaf's relative "
              f"Frobenius distance after step 3 {p3!r} (limit {limits[0]}), after step 4's "
              f"refresh {p4!r} (limit {limits[1]}); bitwise: {on['digest'] == off['digest']}",
              flush=True)
    check(ranks[0]["shard"]["digest"] == ranks[1]["shard"]["digest"],
          "4i: the ranks' parameters differ")
    print(f"4i ranks equal (parameter digest {ranks[0]['shard']['digest'][:16]})", flush=True)
    for n, v in check_split_runs(ranks).items():
        launches[n] = launches.get(n, 0) + v
    for n, v in check_tensor_parallel(ranks).items():
        launches[n] = launches.get(n, 0) + v
    for n, v in check_distributed_paths(torch, ranks).items():
        launches[n] = launches.get(n, 0) + v
    del ranks
    gc.collect()
    for n, v in nccl_step(torch).items():
        launches[n] = launches.get(n, 0) + v
    print(f"4i seconds {time.perf_counter() - t0:.1f}", flush=True)
    return launches


# --------------------------------------------------------------------- phase 4j

def phase_audit(torch) -> dict:
    """Phase 4j: the static audit (``repro_torch.analysis``) at llama-130m
    full width.  (a) ``audit_optimizer`` of phase 4's GUM on the model's
    parameter tree on ``meta``: clean.  (b) One real steady GUM step (after
    a refresh step) through ``make_train_step``: its dispatch counts equal
    ``expected_launches``, and the CUDA launches of rows 1-5 equal those
    counts times each op's kernels per call.  (c) A 2-step ``Trainer`` run
    with telemetry on: one ``audit`` event and a ``launch_crosscheck`` of
    ok in its run log.  (d) ``audit_sharded`` at ``data=8`` on a fake
    process group (two real steps of rank 0 on the card), phase 4's GUM and
    the family-stacked GUM with ``shard_state``: clean, wire bytes printed.
    Prints phase 4's model TFLOP/s (``model_flops`` over its steady median).
    Returns the kernel launches of (b), (c) and (d)."""
    from repro_torch.analysis import audit_optimizer, audit_sharded, expected_launches
    from repro_torch.analysis.launch_model import chain_ns_steps
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.data import build_stream
    from repro_torch.kernels import build, launch_count
    from repro_torch.kernels.launch_count import format_counts
    from repro_torch.launch.roofline import Shape, model_flops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.telemetry.bus import read_jsonl
    from repro_torch.train import Trainer

    label = "audit"
    t_phase = time.perf_counter()
    cfg, data = full_width_data()
    opt_cfg = OptimizerConfig(**GUM_130M)
    meta = build_model(cfg, device="meta").params()

    t0 = time.perf_counter()
    rep = audit_optimizer(opt_cfg, meta)
    print(f"{label} audit_optimizer llama-130m ({time.perf_counter() - t0:.2f} s):\n"
          f"{rep.format()}", flush=True)
    check(rep.ok, f"{label}: audit_optimizer found errors: {[f.format() for f in rep.errors]}")

    # (b) one real steady step against the closed form
    transform = build_optimizer(opt_cfg)
    expected, unmodeled = expected_launches(transform, meta)
    check(not unmodeled, f"{label}: the launch model cannot account for {unmodeled}")
    ns_steps = chain_ns_steps(transform)
    check(ns_steps == opt_cfg.ns_steps, f"{label}: chain_info ns_steps {ns_steps}")
    want_launch = launch_count.kernel_launches(expected, ns_steps)
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    params = model.params()
    step_fn = make_train_step(model, transform)
    stream = build_stream(data)
    launches = collections.Counter()
    with torch.no_grad():
        opt_state = transform.init({k: p.detach() for k, p in params.items()})
    build.reset_launches()
    opt_state, _ = step_fn(params, opt_state, {"tokens": torch.from_numpy(next(stream)).cuda()})
    torch.cuda.synchronize()
    launches.update(build.LAUNCHES)
    batch = {"tokens": torch.from_numpy(next(stream)).cuda()}
    build.reset_launches()
    with launch_count.count_launches() as dispatched:
        opt_state, metrics = step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    steady = {k: v for k, v in build.LAUNCHES.items() if v}
    launches.update(build.LAUNCHES)
    print(f"{label} steady step: expected_launches {format_counts(expected)}; dispatched "
          f"{format_counts(dispatched)}; CUDA launches {steady}; expected launches "
          f"{want_launch} (ns_steps {ns_steps}); loss {float(metrics['loss']):.6f}", flush=True)
    check(dict(dispatched) == expected,
          f"{label}: dispatch counts {dict(dispatched)} != expected_launches {expected}")
    check(steady == want_launch, f"{label}: CUDA launches {steady} != {want_launch}")
    del model, params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the Trainer's startup events
    with scratch_dir(label) as ckpt_dir:
        build.reset_launches()
        trainer = Trainer(
            build_model(cfg, device="cuda"), OptimizerConfig(**GUM_130M, telemetry=True),
            RunConfig(steps=2, log_every=1, seed=0, ckpt_dir=ckpt_dir), data,
            device="cuda", telemetry="stdout=0")
        result = trainer.train()
        torch.cuda.synchronize()
        launches.update(build.LAUNCHES)
        events = [r for r in read_jsonl(result.events_path) if r["kind"] == "event"
                  and r["name"] in ("audit", "launch_crosscheck")]
    for r in events:
        print(f"{label} trainer event {r['name']}: {r['detail']} "
              f"{ {k: v for k, v in r.get('data', {}).items()} }", flush=True)
    names = [r["name"] for r in events]
    check(names == ["audit", "launch_crosscheck"], f"{label}: startup events {names}")
    xc = events[1]
    check(xc["severity"] == "info" and "cross-check ok" in xc["detail"]
          and xc["data"]["expected"] == xc["data"]["traced"],
          f"{label}: launch_crosscheck {xc}")
    check("unavailable" not in events[0]["detail"], f"{label}: {events[0]['detail']}")
    check(result.losses == LOSSES["slice"][:2],
          f"{label}: losses {result.losses} are not bitwise phase 4's {LOSSES['slice'][:2]}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the sharded audit on a fake process group of 8
    for name, cfg_kw in (("gum", GUM_130M),
                         ("gum fused shard_state", dict(GUM_130M, fuse_families=True,
                                                        shard_state=True))):
        t0 = time.perf_counter()
        build.reset_launches()
        rep = audit_sharded(OptimizerConfig(**cfg_kw), arch="llama-130m",
                            mesh_axes=(("data", 8),), device="cuda")
        torch.cuda.synchronize()
        launches.update(build.LAUNCHES)
        wire = rep.summary["wire"]
        print(f"{label} audit_sharded {name} data=8 ({time.perf_counter() - t0:.2f} s): "
              f"{'clean' if rep.ok else 'ERRORS'}; collectives {rep.summary['collectives']}; "
              f"wire bytes/step {wire['steady_bytes_per_step']} steady, "
              f"{wire['boundary_bytes']} refresh-only; per collective "
              f"{[(c['primitive'], c['tag'], c['dtypes'], c['payload_bytes'], c['wire_bytes']) for c in wire['per_collective']]}; "
              f"opt_state_realloc_bytes {rep.summary['opt_state_realloc_bytes']}; "
              f"buffers {rep.summary['buffers']}; per-shard memory "
              f"{rep.summary['per_shard_memory']}", flush=True)
        check(rep.ok, f"{label}: audit_sharded {name}: {[f.format() for f in rep.errors]}")
        gc.collect()
        torch.cuda.empty_cache()

    flops = model_flops(cfg, Shape("llama-130m", data.seq_len, data.global_batch, "train"))
    print(f"{label} phase 4's model TFLOP/s: {flops / (STEADY_MS['slice'] / 1e3) / 1e12:.3f} "
          f"(model_flops {flops:.4e} per step over the steady median "
          f"{STEADY_MS['slice']:.3f} ms); phase 4j seconds "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return dict(launches)


# Phase 4k's storage: llama-130m's matrices (every leaf of two or more dims)
# stored in bf16, as the reference's ModelConfig.param_dtype casts them, and
# bf16 activations; the optimizer state stays fp32.
BF16_STORAGE = dict(param_dtype="bfloat16", dtype="bfloat16")
# 2^-8: the card against the CPU on bf16-stored parameters, each leaf by its
# relative Frobenius distance.  Both devices round every update into bf16
# (2^-9 relative at most, an ulp apart where their fp32 updates straddle a
# rounding boundary) and their bf16 forwards round at other places; 2^-8 is
# one bf16 rounding of the whole leaf, as TOL_FLASH_16 is of an output.
TOL_BF16_LEAF = 2.0 ** -8


def phase_bf16_train(torch) -> dict:
    """Phase 4k: training on bf16-stored parameters (fp32 optimizer state).
    llama-130m at full width with ``param_dtype="bfloat16"`` and bf16
    activations, phase 4's recipe otherwise: (a) GUM, 6 steps, rows 1–5
    launching 14 / 14 / 70 / 70 a step (phase 4's counts: the optimizer
    casts each gradient to fp32 before any kernel, so rows 1–5 run the
    instantiations phase 4 ran, read from ``build.VARIANTS``), a checkpoint
    at step 3, and a second ``Trainer`` resuming from it (the step-6
    checkpoint removed) that ends bitwise where the first run did; its
    steady step, tokens/s, refresh steps, peak and profiled groups printed
    beside phase 4's; (b) GaLore family-stacked with the fused epilogue, 4
    steps, weight decay 0.01 (the epilogue reads W only with a decay; 0 is
    phase 4b's published setting): row 6 launches 3 times a step, every
    launch of its bf16-W instantiation; (c) a 3-step GUM ``Trainer`` on
    the bf16-stored SMOKE of llama-60m, mamba2-370m and zamba2-1.2b on the
    card and on the CPU (:func:`bf16_agree`).  Returns the launches of (a)
    and (b)."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig
    from repro_torch.core.api import tree_map
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    label = "bf16"
    t_phase = time.perf_counter()
    launches = collections.Counter()
    first: dict = {}

    def keep_final(trainer, result):
        first["tree"] = tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
                                 else x, (dict(trainer.model.params()), trainer.opt_state))
        first["losses"] = result.losses
        first["dtypes"] = sorted({str(p.dtype) for p in trainer.model.params().values()})

    with scratch_dir("bf16_gum") as ckpt_dir:
        got, _ = train_full_width(torch, f"{label} gum", OptimizerConfig(**GUM_130M),
                                  GUM_DISPATCH, GUM_LAUNCH, model_changes=BF16_STORAGE,
                                  ckpt_dir=ckpt_dir, ckpt_every=3, after_train=keep_final)
        launches.update(got)
        check(first["dtypes"] == ["torch.bfloat16", "torch.float32"],
              f"{label}: parameter dtypes {first['dtypes']}")
        rows15 = ("lowrank_update", "back_project", "gram", "poly_apply")
        ran = {k: sorted(PHASE_VARIANTS[f"{label} gum"][k]) for k in rows15}
        want = {k: sorted(PHASE_VARIANTS["slice"][k]) for k in rows15}
        check(ran == want, f"{label}: rows 1-5 instantiations {ran} != phase 4's {want}")
        print(f"{label} gum rows 1-5 instantiations (build.VARIANTS) equal phase 4's fp32 "
              f"run's: {ran}", flush=True)

        # the resume: step 3's checkpoint, step 6's removed
        shutil.rmtree(os.path.join(ckpt_dir, "step_000000006"))
        cfg, data = full_width_data()
        t0 = time.perf_counter()
        resumed = Trainer(build_model(cfg.replace(**BF16_STORAGE), device="cuda"),
                          OptimizerConfig(**GUM_130M),
                          RunConfig(steps=6, ckpt_every=3, log_every=0, seed=0,
                                    ckpt_dir=ckpt_dir), data, device="cuda")
        result = resumed.train()
        torch.cuda.synchronize()
        diff = bitwise_diff(first["tree"], (dict(resumed.model.params()), resumed.opt_state))
        check(result.resumed_from == 3 and result.losses == first["losses"][3:] and not diff,
              f"{label}: resumed from {result.resumed_from}, losses {result.losses} vs "
              f"{first['losses'][3:]}, leaves {diff[:8]}")
        print(f"{label} gum resumed from step 3 to 6 ({time.perf_counter() - t0:.1f} s): "
              f"losses and {len(flat_state(first['tree']))} leaves bitwise the "
              f"uninterrupted run's", flush=True)
        del resumed, first["tree"]
        gc.collect()
        torch.cuda.empty_cache()

    a, b = f"{label} gum", "slice"
    pa, pb = STEP_PROFILE[a], STEP_PROFILE[b]
    port = ", ".join(f"{k} {pa['groups'][k]:.3f} / {pb['groups'][k]:.3f}" for k in KERNEL_META
                     if pa["groups"][k] or pb["groups"][k])
    print(f"{label} gum against phase 4 (bf16-stored / fp32, this process): steady median "
          f"{STEADY_MS[a]:.3f} / {STEADY_MS[b]:.3f} ms; tokens/s "
          f"{8 * 1024 / STEADY_MS[a] * 1e3:.0f} / {8 * 1024 / STEADY_MS[b] * 1e3:.0f}; refresh "
          f"steps {REFRESH_MS[a]} / {REFRESH_MS[b]}; peak {PEAK_GIB[a]:.3f} / {PEAK_GIB[b]:.3f} "
          f"GiB; busy / wall (idle) {pa['busy']:.3f} / {pa['wall']:.3f} "
          f"({1 - pa['busy'] / pa['wall']:.3f}) against {pb['busy']:.3f} / {pb['wall']:.3f} "
          f"({1 - pb['busy'] / pb['wall']:.3f}); cuBLAS {pa['groups']['cuBLAS gemm']:.3f} / "
          f"{pb['groups']['cuBLAS gemm']:.3f}, other {pa['groups']['other']:.3f} / "
          f"{pb['groups']['other']:.3f}; port kernels {port}", flush=True)

    # (b) fused GaLore: every row-6 launch reads the bf16 W stack
    galore = f"{label} galore"
    got, _ = train_full_width(
        torch, galore,
        OptimizerConfig(name="galore", lr=1e-2, rank=256, period=3, weight_decay=0.01,
                        fuse_families=True, fused_epilogue=True),
        GALORE_DISPATCH, GALORE_LAUNCH, steps=4, model_changes=BF16_STORAGE)
    launches.update(got)
    epi = PHASE_VARIANTS[galore]["back_project_epilogue"]
    check(epi and all(key[4] == 1 for key in epi),
          f"{galore}: row 6 instantiations {epi}, want the bf16-W one alone")
    print(f"{galore}: row 6's {sum(epi.values())} launches all of its bf16-W instantiation "
          f"{sorted(epi)}", flush=True)

    # (c) the card against the CPU on bf16-stored SMOKE models
    for arch in BF16_AGREE:
        bf16_agree(torch, label, arch)
    print(f"{label} phase 4k seconds {time.perf_counter() - t_phase:.1f}", flush=True)
    return dict(launches)


# Phase 4l: mamba2-370m trained at full width and depth (48 layers, d 1024,
# ssm_in (1024, 4384), ssm_out (2048, 1024)), stored in bf16 with bf16
# activations, remat on (the config's), 4 x 2048 tokens a step.
SSM_TRAIN = ("mamba2-370m", 4, 2048)


def phase_ssm_train(torch) -> dict:
    """Phase 4l: the first full-width training of an ssm model.  GUM (phase
    4's rank 256, gamma 4, period 3) for 6 steps through the ``Trainer`` on
    SSM_TRAIN, bf16-stored; the SSD runs its plain chunked autograd at
    "xla" (the scan kernel is forward-only, as the reference's), rows 1-5
    on ``ssm_in`` (the left projection, n = 4384: ragged 64-wide tiles) and
    ``ssm_out`` (the right).  Finite losses; the optimizer state all fp32;
    the per-step dispatch counts and one profiled steady step's equal to
    ``expected_launches`` of the model's tree, rows 1-5's CUDA launches to
    those counts times each op's kernels per call (as phase 4j holds
    them); rows 1-5 launched at n = 4384, their instantiations printed from
    ``build.VARIANTS``.  Prints phase 4's metrics for the run and the plain
    SSD's share of the steady step's device time: its forward and forward +
    backward alone at one layer's shapes, each profiled (device time, not
    the host's: the plain SSD is many small ops), times 48 layers (remat
    runs each forward twice).  Returns the phase's kernel launches."""
    from repro_torch.analysis import expected_launches
    from repro_torch.analysis.launch_model import chain_ns_steps
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.core.api import tree_leaves
    from repro_torch.kernels import launch_count, ops
    from repro_torch.models import build_model
    from repro_torch.models.mamba2 import dims

    label = "ssm train"
    t_phase = time.perf_counter()
    cfg, data = full_width_data(*SSM_TRAIN)
    cfg = cfg.replace(**BF16_STORAGE)
    opt_cfg = OptimizerConfig(**GUM_130M)
    transform = build_optimizer(opt_cfg)
    expected, unmodeled = expected_launches(transform, build_model(cfg, device="meta").params())
    check(not unmodeled, f"{label}: the launch model cannot account for {unmodeled}")
    want_launch = launch_count.kernel_launches(expected, chain_ns_steps(transform))
    print(f"{label} on {smi_line()}: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{data.global_batch} x {data.seq_len} tokens a step; expected_launches "
          f"{expected}, rows 1-5 launches {want_launch}", flush=True)
    state_dtypes: set = set()

    def keep_dtypes(trainer, result):
        state_dtypes.update(str(x.dtype) for x in tree_leaves(trainer.opt_state)
                            if isinstance(x, torch.Tensor) and x.is_floating_point())

    launches, _ = train_full_width(torch, label, opt_cfg, expected, want_launch,
                                   model_changes=BF16_STORAGE, after_train=keep_dtypes,
                                   data=SSM_TRAIN)
    check(state_dtypes == {"torch.float32"}, f"{label}: optimizer state dtypes {state_dtypes}")
    prof = STEP_PROFILE[label]
    check(prof["dispatched"] == expected and prof["launches"] == want_launch,
          f"{label}: the steady step dispatched {prof['dispatched']}, launched "
          f"{prof['launches']}; expected {expected}, {want_launch}")
    calls = PHASE_CALLS[label]
    wide = {k: sum(n for key, n in calls[k].items() if 4384 in key) for k in GUM_KERNELS}
    check(all(wide.values()), f"{label}: rows 1-5 launches at n = 4384 {wide}")
    print(f"{label}: optimizer state {sorted(state_dtypes)}; the profiled steady step "
          f"dispatched {prof['dispatched']} and launched {prof['launches']} (equal to "
          f"expected_launches); launches at n = 4384 over the 6 steps {wide}; rows 1-5 "
          f"instantiations (build.VARIANTS) {({k: PHASE_VARIANTS[label][k] for k in GUM_KERNELS})}; "
          f"integer arguments (build.CALLS) {({k: calls[k] for k in GUM_KERNELS})}", flush=True)

    # The plain SSD alone at one layer's shapes, bf16 x as the layer gives it.
    _, H, N, _ = dims(cfg)
    B, S, P = data.global_batch, data.seq_len, cfg.ssm_headdim
    gen = torch.Generator(device="cuda").manual_seed(4)

    def leaf(*shape, scale=1.0, dtype=torch.float32):
        t = scale * torch.randn(*shape, generator=gen, device="cuda")
        return t.to(dtype).requires_grad_()

    x = leaf(B, S, H, P, dtype=torch.bfloat16)
    dt = torch.nn.functional.softplus(leaf(B, S, H) - 4.0).detach().requires_grad_()
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))).bfloat16()
    b, c = leaf(B, S, N, scale=0.1), leaf(B, S, N, scale=0.1)
    skip = torch.ones(H, device="cuda", dtype=torch.bfloat16)

    def ssd():
        return ops.ssd(x, dt, a, b, c, skip, chunk=cfg.ssm_chunk, impl="xla")[0]

    def busy_ms(what: str, grad: bool) -> float:
        """Device ms of one call of the plain SSD (after one warm call)."""
        def call():
            if grad:
                torch.autograd.grad(ssd().float().sum(), (x, dt, b, c))
            else:
                with torch.no_grad():
                    ssd()
            torch.cuda.synchronize()

        call()
        with profiled() as ssd_prof:
            t0 = time.perf_counter()
            call()
            wall = (time.perf_counter() - t0) * 1e3
        return print_groups(f"{label} plain SSD alone, {what}", ssd_prof, wall)["busy"]

    fwd_ms, fb_ms = busy_ms("forward", False), busy_ms("forward + backward", True)
    ssd_ms = cfg.n_layers * (fwd_ms + fb_ms)
    print(f"{label} plain SSD at one layer's shapes x ({B}, {S}, {H}, {P}) bf16, N {N}, chunk "
          f"{cfg.ssm_chunk}: device ms forward {fwd_ms:.3f}, forward + backward {fb_ms:.3f}; "
          f"{cfg.n_layers} layers x (forward + recompute + backward) {ssd_ms:.3f} ms against "
          f"the profiled steady step's busy {prof['busy']:.3f} ms (share "
          f"{ssd_ms / prof['busy']:.3f})", flush=True)
    del x, dt, b, c
    gc.collect()
    torch.cuda.empty_cache()

    groups = prof["groups"]
    port = ", ".join(f"{k} {groups[k]:.3f}" for k in KERNEL_META if groups[k])
    tokens = data.global_batch * data.seq_len
    print(f"{label} {cfg.name} GUM bf16-stored (phase 4's metrics): steady median "
          f"{STEADY_MS[label]:.3f} ms; tokens/s {tokens / STEADY_MS[label] * 1e3:.0f}; refresh "
          f"steps {REFRESH_MS[label]}; peak {PEAK_GIB[label]:.3f} GiB; busy / wall (idle) "
          f"{prof['busy']:.3f} / {prof['wall']:.3f} ({1 - prof['busy'] / prof['wall']:.3f}; "
          f"against the unprofiled steady median {1 - prof['busy'] / STEADY_MS[label]:.3f}); "
          f"cuBLAS {groups['cuBLAS gemm']:.3f}, other {groups['other']:.3f}; port kernels "
          f"{port}; plain SSD share {ssd_ms / prof['busy']:.3f}; phase 4l seconds "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


# Phase 4k (c): the SMOKE models trained on bf16-stored parameters on the
# card and on the CPU, one of each family that trains on bf16 storage since
# its slice (the dense family's, then the ssm and hybrid families').
BF16_AGREE = ("llama-60m", "mamba2-370m", "zamba2-1.2b")


def bf16_agree(torch, label: str, arch: str) -> None:
    """A 3-step GUM ``Trainer`` on ``arch``'s bf16-stored SMOKE
    (batch 2 x 64) on the card and on the CPU from the same parameters:
    finite losses, rows 1-2 launched on the card only, every leaf within
    TOL_BF16_LEAF (relative Frobenius)."""
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    smoke = get_smoke(arch).replace(param_dtype="bfloat16")
    init = build_model(smoke, device="cpu")
    init.init_params(0)
    params = {k: v.detach() for k, v in init.params().items()}
    out = {}
    for device in ("cpu", "cuda"):
        with scratch_dir("bf16_agree") as ckpt_dir:
            before = build.LAUNCHES["lowrank_update"]
            trainer = Trainer(build_model(smoke, device=device),
                              OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2),
                              RunConfig(steps=3, log_every=0, seed=0, ckpt_dir=ckpt_dir),
                              DataConfig(vocab=smoke.vocab, seq_len=64, global_batch=2, seed=0),
                              device=device, params=params)
            losses = trainer.train().losses
            check(all(math.isfinite(v) for v in losses), f"{label} agree {arch} {device}: "
                  f"{losses}")
            check((build.LAUNCHES["lowrank_update"] > before) == (device == "cuda"),
                  f"{label} agree {arch} {device}: lowrank_update launches {before} -> "
                  f"{build.LAUNCHES['lowrank_update']}")
            out[device] = (losses, {k: p.detach().cpu() for k, p in
                                    trainer.model.params().items()})
    dist = {k: float(torch.linalg.vector_norm((p.float() - out["cpu"][1][k].float()))
                     / torch.linalg.vector_norm(out["cpu"][1][k].float()))
            for k, p in out["cuda"][1].items()}
    worst = max(dist, key=dist.get)
    print(f"{label} agree {arch} smoke gum (3 steps, "
          f"{sum(p.dtype == torch.bfloat16 for p in params.values())} of {len(params)} leaves "
          f"bf16): cuda {out['cuda'][0]} cpu {out['cpu'][0]}; worst leaf {worst} "
          f"{dist[worst]:.3e} (tol {TOL_BF16_LEAF:.3e})", flush=True)
    check(dist[worst] <= TOL_BF16_LEAF, f"{label} agree {arch}: {worst} at {dist[worst]:.3e}")


def profile_steady_step(torch, label: str, trainer, done: int) -> None:
    """Device time of one steady step by kernel group (torch.profiler):
    step ``done + 1`` is a refresh step and runs unprofiled, ``done + 2``
    is profiled, its dispatch counts and kernel launches recorded beside.
    Its idle share is 1 − busy / that step's own wall time (host clock,
    ending in a synchronise, profiler on)."""
    from repro_torch.data import build_stream
    from repro_torch.kernels import build, launch_count

    stream = build_stream(trainer.data_cfg).resume(done)
    params, state = trainer.model.params(), trainer.opt_state

    def step(state):
        tokens = torch.from_numpy(next(stream)).to("cuda")
        state, _ = trainer.step_fn(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        return state

    state = step(state)
    before = dict(build.LAUNCHES)
    with profiled() as prof, launch_count.count_launches() as dispatched:
        t0 = time.perf_counter()
        step(state)
        step_ms = (time.perf_counter() - t0) * 1e3
    STEP_PROFILE[label] = print_groups(f"{label} profiled steady step (step {done + 2})", prof,
                                       step_ms)
    STEP_PROFILE[label]["dispatched"] = dict(dispatched)
    STEP_PROFILE[label]["launches"] = {k: v - before.get(k, 0) for k, v in
                                       build.LAUNCHES.items() if v != before.get(k, 0)}


# Idle host time at each end of a profiled window, so that a kernel's device
# timestamps fall inside the profiler's capture window however the device's
# clock stands against the host's: a short window (one decode step) otherwise
# may keep none of its kernels.
PROFILE_PAD_S = 0.05


@contextlib.contextmanager
def profiled(host: bool = False):
    """``torch.profiler.profile`` of the card, and of the host's ops where
    ``host`` is set (phase 4g reads a ``record_function`` range), over the
    block, padded at both ends by PROFILE_PAD_S.  Without the host's ops
    the window records the card's kernels and the runtime's launch calls
    alone: a fraction of the events to parse after it (one
    steady step of phase 4l: 4.7-8.2 s against 31-33 s with them), and
    less of the profiler's own host time in the window's wall time (the
    same step: 1.7 s against 2.5-2.8 s; llama-130m's alike)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        time.sleep(PROFILE_PAD_S)


# Profiler group of each port kernel: its __global__ functions by name.
# ssd_scan launches two (ssd_cb_kernel, then ssd_scan_kernel).
GROUPS = {k: rf"(^|\W){k}_kernel" for k in KERNEL_META} | {"ssd_scan": r"(^|\W)ssd_\w*kernel"}


def print_groups(label: str, prof, wall_ms: float) -> dict:
    """Device time of a profiled window by group — each port kernel, the
    cuBLAS GEMMs, the rest — its busy time and its idle share against the
    window's own host wall time; returns those (ms)."""
    from torch.autograd import DeviceType

    groups = dict.fromkeys(list(KERNEL_META) + ["cuBLAS gemm", "other"], 0.0)
    other = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else ev.self_cuda_time_total
        name = ev.key
        low = name.lower()
        kernel = next((k for k, pattern in GROUPS.items() if re.search(pattern, name)), None)
        if kernel:
            groups[kernel] += us
        elif any(tag in low for tag in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["cuBLAS gemm"] += us
        else:
            groups["other"] += us
            other[name] = other.get(name, 0.0) + us
    busy_ms = sum(groups.values()) / 1e3
    check(busy_ms > 0, f"{label}: the profiled window recorded no device time "
          f"({len(prof.events())} host events)")
    parts = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in groups.items() if v)
    top = "; ".join(f"{v / 1e3:.3f} {k[:60]}" for k, v in
                    sorted(other.items(), key=lambda kv: -kv[1])[:4])
    print(f"{label} device ms by group: {parts}; busy {busy_ms:.3f} of its {wall_ms:.3f} "
          f"wall ms (idle share {1 - busy_ms / wall_ms:.3f}); largest in other: {top}",
          flush=True)
    return {"groups": {k: v / 1e3 for k, v in groups.items()}, "busy": busy_ms,
            "wall": wall_ms}


# --------------------------------------------------------------------- phases 6, 7


@contextlib.contextmanager
def with_config(model, **changes):
    """``model`` with ``changes`` made to its config for the block: the
    attention route or the activation dtype, which the model reads at each
    call.  The parameters stay the one copy on the card (a 7B model's fp32
    parameters take 30 GB; a second model for the plain route would not
    fit beside the first and its fp32 prefill)."""
    cfg = model.cfg
    model.cfg = cfg.replace(**changes)
    try:
        yield model
    finally:
        model.cfg = cfg


def prompt_tokens(torch, vocab: int, batch: int, seq: int):
    """The seeded (batch, seq) prompt tokens of a serving phase's prefill."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randint(0, vocab, (batch, seq), generator=gen, device="cuda")


def cache_leaves(cache, prefix: str = ""):
    """(path, tensor) of a decode cache, flat or nested (the moe family's
    grouped {"dense": {"k", "v"}, "moe": {"k", "v"}})."""
    for key, val in (cache or {}).items():
        if isinstance(val, dict):
            yield from cache_leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def expected_launches(cfg) -> dict:
    """The kernel launches of one prefill at attn_impl="pallas", by the
    family's layout: one SSD scan a Mamba layer (ssm, hybrid), one flash
    attention a self-attention (every layer of the attention families; the
    hybrid's shared block after every ``shared_attn_every``-th layer) and a
    cross-attention (the vlm's, one a group)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssd_scan": L}
    if cfg.family == "hybrid":
        return {"ssd_scan": L, "flash_attention": -(-L // cfg.shared_attn_every)}
    if cfg.family == "vlm":
        return {"flash_attention": L + L // cfg.cross_attn_every}
    return {"flash_attention": L}


def serve_batch(torch, cfg, batch: int, seq: int) -> dict:
    """A serving phase's seeded prefill batch: the prompt tokens, the stub
    image embeddings (B, n_image_tokens, d) x 0.02 for the vlm, or in their
    place the stub frame embeddings (B, S, d) x 0.02 for the audio front
    end (as the reference's smoke test makes them)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.frontend == "frames":
        return {"frames": 0.02 * torch.randn(batch, seq, cfg.d_model, generator=gen,
                                             device="cuda")}
    out = {"tokens": prompt_tokens(torch, cfg.vocab, batch, seq)}
    if cfg.family == "vlm":
        out["images"] = 0.02 * torch.randn(batch, cfg.n_image_tokens, cfg.d_model,
                                           generator=gen, device="cuda")
    return out


def set_vlm_gates(torch, model) -> list[float]:
    """Seeded nonzero gates (|value| in [0.3, 1.1], either sign) in place of
    the init's zeros, with which every cross block would be the identity
    and no check could see a wrong cross-attention."""
    gen = torch.Generator().manual_seed(2)
    cross = model.blocks.cross
    with torch.no_grad():
        for gate in (cross.gate_attn, cross.gate_mlp):
            mag = 0.3 + 0.8 * torch.rand(gate.shape, generator=gen)
            sign = torch.where(torch.rand(gate.shape, generator=gen) < 0.5, -1.0, 1.0)
            gate.copy_(mag * sign)
    return [round(g, 4) for g in torch.cat([cross.gate_attn, cross.gate_mlp]).tolist()]


# The longest engine prompt of every serving phase, cut from 256 tokens: to
# 64 in phases 7, 8 and 12 to make room for phase 4k, to 32 in every phase
# for phase 4l.  An engine ticks until the longest prompt is fed and 32
# tokens are decoded (252 ticks before the cuts), and each checked request's
# direct decode as long again.
SHORT_PROMPT_MAX = 32


def phase_serve(torch, label: str, arch: str, batch: int, seq: int, tol: float,
                direct_batch: int, *, slots: int = 8, requests: int = 16, checked: int = 2,
                changes: dict | None = None, reference=None,
                per_tick: dict | None = None, prompt_max: int = SHORT_PROMPT_MAX) -> dict:
    """Serve ``arch`` (its config with ``changes``: a depth cut, the
    parameter storage) at full width on the card, through the port's entry
    points: ``make_prefill_step`` at ``attn_impl="pallas"`` on ``batch`` x
    ``seq`` seeded prompts (:func:`serve_batch`: tokens, with images for the
    vlm, frames for audio), with exactly :func:`expected_launches` kernel
    launches, flash attention's all of the instantiation for the model's
    activation dtype and head dim; logits,
    and the cache where the family has one, against the same prefill at
    ``attn_impl="xla"`` on the same parameters: rel <= ``tol`` in fp32, and
    in bf16 as :func:`check_low_precision_prefill` says, against
    ``reference`` where one is given), then, where the family decodes and
    ``requests`` is not 0, a ``ServeEngine`` of ``slots`` slots answering
    ``requests`` seeded
    requests (prompts of 16–``prompt_max`` tokens, 32 new tokens each; a
    tick runs until the longest prompt is fed and decoded) with exactly
    ``per_tick`` kernel launches a tick (default none), ``checked`` of which
    — the second in a reused slot where slots are reused — must equal the
    direct greedy decode of that request alone
    (``greedy_decode(batch=direct_batch)``).  Prints the prefill and engine
    times, tokens/s (frames/s) and peak memory, profiles one prefill and
    one decode step, and returns the kernel launches of the prefill and
    engine run; their integer arguments go to ``PHASE_CALLS[label]``.
    A moe model's prefill is recorded, its comparisons replay the fp32
    "xla" prefill's routing (:func:`check_pinned_prefill`), its MoE layer
    and prefill must repeat bitwise, and a 1-slot engine must equal the
    direct decode at batch 1 (:func:`check_moe_repeats`).  A vlm model gets
    nonzero gates (:func:`set_vlm_gates`), and its decode from the
    prefill's cache is held to the forward (:func:`check_vlm_decode`)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import DTYPES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, moe
    from repro_torch.serve.engine import ServeEngine, greedy_decode

    cfg = get_config(arch).replace(**(changes or {}))
    routed, decodes = cfg.family == "moe", cfg.has_decode and requests > 0
    per_prefill = expected_launches(cfg)
    model = build_model(cfg.replace(attn_impl="pallas"), device="cuda")
    model.init_params(0)
    if cfg.family == "vlm":
        print(f"{label} gates (attn, then mlp) set to {set_vlm_gates(torch, model)}",
              flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    inputs = serve_batch(torch, cfg, batch, seq)
    prefill = make_prefill_step(model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, prompt_max + 1, requests if decodes else 0)]
    gc.collect()  # an earlier phase's cycles would otherwise count in this peak
    # The init's fp32 draws (one leaf at a time: 21.5 GB for a maverick expert
    # stack stored in bf16) leave a cached segment; the path's logits, kept
    # across the comparison prefills, would split it and keep check_pinned_
    # prefill's fp32 casts of the same size from it.
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # The path: one prefill, then the engine; counts set to 0 just before.
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with moe.record_routing() as path_routing:  # no MoE call: records nothing
        logits, cache = prefill(inputs)
    torch.cuda.synchronize()
    prefill_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    prefill_variants = {k: dict(build.VARIANTS[k]) for k in per_prefill}
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    check(prefill_launches == per_prefill,
          f"{label}: prefill kernel launches {prefill_launches} != {per_prefill}")
    if "flash_attention" in per_prefill:  # every launch the dtype's, D's instantiation
        code, tier = DTYPES[model.dtype], next(dp for dp in FLASH_TIERS if cfg.hd <= dp)
        check(all(key[:2] == (code, tier) for key in prefill_variants["flash_attention"]),
              f"{label}: flash_attention instantiations {prefill_variants}, "
              f"expected element type {code} ({cfg.dtype}) and head dim {tier}")
    engine = reqs = None
    if decodes:
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, slots=slots, max_seq=1024)
        reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        engine_peak = torch.cuda.max_memory_allocated() / 2**30
        ticks = engine.tick_seconds
        engine_launches = {k: v - prefill_launches.get(k, 0) for k, v in build.LAUNCHES.items()
                           if v != prefill_launches.get(k, 0)}
        want_ticks = {k: n * len(ticks) for k, n in (per_tick or {}).items()}
        check(engine_launches == want_ticks, f"{label}: engine kernel launches "
              f"{engine_launches} over {len(ticks)} ticks != {want_ticks}")
    launches = dict(build.LAUNCHES)
    PHASE_CALLS[label] = {k: dict(v) for k, v in build.CALLS.items()}

    # The prefill against attn_impl="xla" on the card.
    check(bool(torch.isfinite(logits.float()).all()), f"{label}: non-finite prefill logits")
    check(tuple(logits.shape) == (batch, seq, cfg.vocab), f"{label}: logits {tuple(logits.shape)}")
    print(f"{label} {arch} ({cfg.n_layers} layers, {n_params / 1e6:.1f}M params stored in "
          f"{cfg.param_dtype}, {cfg.dtype}) prefill {batch} x {seq}: "
          f"{prefill_launches} launches, instantiations {prefill_variants}", flush=True)
    if routed:
        del cache
        check_pinned_prefill(torch, label, cfg, model, inputs["tokens"], path_routing, tol)
    else:
        with with_config(model, attn_impl="xla"):
            want, want_cache = prefill(inputs)
        _, rel = rel_err(logits.float(), want.float())
        errs = {"logits": rel}
        for key, t in cache_leaves(cache):
            errs[key] = rel_err(t.float(), dict(cache_leaves(want_cache))[key].float())[1]
        print(f"{label} pallas vs xla max rel {errs}", flush=True)
        del cache, want_cache
        if cfg.dtype == "float32":
            check(all(e <= tol for e in errs.values()), f"{label}: pallas vs xla {errs} > {tol}")
        else:
            check_low_precision_prefill(torch, label, cfg, model, inputs, logits, want, tol,
                                        reference)
        del want

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again, _ = prefill(inputs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if routed:
            check(bool(torch.equal(again, logits)), f"{label}: a second prefill's logits "
                  "differ from the first's")
        del again
    ms = statistics.median(walls)
    unit = "frames" if cfg.frontend == "frames" else "tokens"
    print(f"{label} prefill ms {[round(w, 3) for w in walls]}, median {ms:.3f}; "
          f"prefill {unit}/s {batch * seq / (ms / 1e3):.0f}; "
          f"peak memory {prefill_peak:.3f} GiB", flush=True)
    with profiled() as prof:
        t0 = time.perf_counter()
        prefill(inputs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print_groups(f"{label} profiled prefill", prof, wall)
    del logits
    if cfg.family == "vlm":
        check_vlm_decode(torch, label, model, inputs)
    if not decodes:
        print(f"{label}: {cfg.name} " + ("runs no engine here" if cfg.has_decode else
                                         "is encoder-only, so no engine runs"), flush=True)
        build.reset_launches()
        return launches

    # The engine: every request done, `checked` of them equal to direct decode.
    check(len(engine.finished) == requests and all(len(r.output) == 32 for r in reqs),
          f"{label}: engine finished {len(engine.finished)} requests")
    reused = [r for r in reqs if r.reused_slot]
    check(len(reused) >= 1 or requests <= slots, f"{label}: no slot was reused")
    generated = sum(len(r.output) for r in reqs)
    print(f"{label} engine: {requests} requests (prompts {min(map(len, prompts))}–"
          f"{max(map(len, prompts))} tokens, 32 new each) on {slots} slots, "
          f"{len(reused)} in reused slots: {len(ticks)} ticks in {engine_s:.3f} s, median tick "
          f"{statistics.median(ticks) * 1e3:.3f} ms, generated tokens/s "
          f"{generated / engine_s:.1f}, peak memory {engine_peak:.3f} GiB, kernel launches "
          f"{engine_launches}", flush=True)
    # One tick's decode step under the profiler: every row busy, at spread
    # positions.
    step = make_serve_step(model)
    step_tokens = torch.zeros((slots, 1), dtype=torch.int64, device="cuda")
    step_pos = torch.arange(slots, device="cuda") * 64
    step(engine.cache, step_tokens, step_pos)
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        step(engine.cache, step_tokens, step_pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print_groups(f"{label} profiled decode step ({slots} rows)", prof, wall)
    del engine
    for req in ([reqs[0]] + reused[:1])[:checked]:
        direct = greedy_decode(model, req.prompt, 32, 1024, batch=direct_batch,
                               row=req.slot if direct_batch > 1 else 0)
        check(req.output == direct, f"{label}: request {req.uid} (slot {req.slot}, reused "
              f"{req.reused_slot}) {req.output} != direct decode {direct}")
        print(f"{label} request {req.uid} (slot {req.slot}, reused slot {req.reused_slot}, "
              f"prompt {len(req.prompt)}) equals direct decode: {req.output[:8]}...", flush=True)
    if routed:
        check_moe_repeats(torch, label, model, reqs[0].prompt)
    build.reset_launches()
    return launches


def check_vlm_decode(torch, label, model, inputs, prompt: int = 60, steps: int = 4) -> None:
    """The reference's own vlm check, at full width: decode from a prefill's
    cache reproduces the forward.  In fp32 at "pallas" (the kernels; the
    cross blocks at S = 1 over the image K/V the prefill made), row 0 of the
    batch: prefill ``prompt`` tokens with their cache, grow the self KV by
    ``steps`` positions, decode the next ``steps`` tokens, and hold their
    logits to the forward of all ``prompt + steps`` tokens at those
    positions: 1e-4 of the largest (fp32 sums in another order)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    tokens, images = inputs["tokens"][:1, :prompt + steps], inputs["images"][:1]
    with with_config(model, dtype="float32"):
        prefill = make_prefill_step(model)
        full, _ = prefill({"tokens": tokens, "images": images})
        _, cache = prefill({"tokens": tokens[:, :prompt], "images": images})
        for key in ("k", "v"):  # (G, per, B, S, KV, hd): room for `steps` more
            cache["self"][key] = torch.nn.functional.pad(cache["self"][key],
                                                         (0, 0, 0, 0, 0, steps))
        step = make_serve_step(model)
        got = []
        for i in range(prompt, prompt + steps):
            logits, cache = step(cache, tokens[:, i:i + 1], i)
            got.append(logits[:, 0])
    abs_err, rel = rel_err(torch.stack(got, 1), full[:, prompt:])
    print(f"{label} fp32 decode of {steps} tokens from a {prompt}-token prefill's cache vs "
          f"the forward: max abs {abs_err:.3e}, rel {rel:.3e} (tol 1e-4)", flush=True)
    check(rel <= 1e-4, f"{label}: decode from the prefill's cache vs forward {rel:.3e} > 1e-4")


def fro_rel(a, b) -> float:
    """||a - b|| / ||b|| over every element (Frobenius): the difference in
    fp32, the squares summed in fp64, a slice of 2^26 elements at a time
    (an fp64 copy of a whole moe prefill's logits would take 12.3 GiB)."""
    import torch

    a, b = a.flatten(), b.flatten()
    num = den = 0.0
    for i in range(0, a.numel(), 2 ** 26):
        x, y = a[i:i + 2 ** 26].float(), b[i:i + 2 ** 26].float()
        num += float(torch.sum(torch.square((x - y).double())))
        den += float(torch.sum(torch.square(y.double())))
    return math.sqrt(num / den)


def check_low_precision_prefill(torch, label, cfg, model, inputs, logits, want, tol,
                                reference=None) -> None:
    """A bf16 prefill through the kernels against the plain (xla) one.
    Both round every op to bf16 (2^-8 relative) but sum in fp32 in another
    order (the SSD scan; attention, whose plain route also rounds P to bf16
    where the kernel keeps it in fp32, as the reference's two routes do),
    so their roundings part at a few elements per block and the residual
    stream carries the difference through every layer: the largest single
    logit moves by a few percent.  So hold it where bf16 itself sets the
    scale: the same prefill in fp32 through both paths must agree within
    ``tol`` (1e-4), and in bf16 the kernel path must lie no farther from
    the plain bf16 path, in Frobenius norm, than the plain bf16 path lies
    from the fp32 result.  Every prefill runs on ``model``'s parameters and
    the batch ``inputs``.
    The fp32 result is the same prefill in fp32 on them where they are
    stored in fp32; where they are stored in bf16 (``param_dtype``) it is
    ``reference``, the fp32 logits of the same draws stored in fp32: a bf16
    path's rounding includes its weights', and the fp32 prefill on bf16
    weights shares that rounding, which would leave the rule comparing two
    bf16 paths' activation roundings with one of them alone."""
    from repro_torch.launch.steps import make_prefill_step

    fp32 = {}
    prefill = make_prefill_step(model)
    for impl in ("pallas", "xla"):
        with with_config(model, attn_impl=impl, dtype="float32"):
            fp32[impl] = prefill(inputs)[0]
    _, rel32 = rel_err(fp32["pallas"], fp32["xla"])
    if cfg.param_dtype == "float32":
        reference = fp32["xla"]
    else:
        check(reference is not None, f"{label}: bf16-stored parameters need the fp32 "
              "reference of their draws")
        reference = reference.to(logits.device)
        print(f"{label} on its {cfg.param_dtype} parameters: {cfg.dtype} xla vs their fp32 "
              f"prefill {fro_rel(want, fp32['xla']):.3e}, pallas vs it "
              f"{fro_rel(logits, fp32['xla']):.3e}; that fp32 prefill vs the fp32-stored "
              f"reference {fro_rel(fp32['xla'], reference):.3e} (Frobenius rel)", flush=True)
    kernel_vs_plain = fro_rel(logits, want)
    plain_vs_fp32 = fro_rel(want, reference)
    print(f"{label} fp32 prefill at full width: pallas vs xla max rel {rel32:.3e} (tol {tol}); "
          f"{cfg.dtype}: pallas vs xla {kernel_vs_plain:.3e}, xla vs fp32 {plain_vs_fp32:.3e}, "
          f"pallas vs fp32 {fro_rel(logits, reference):.3e} (Frobenius rel)", flush=True)
    check(rel32 <= tol, f"{label}: fp32 pallas vs xla {rel32:.3e} > {tol}")
    check(kernel_vs_plain <= plain_vs_fp32,
          f"{label}: {cfg.dtype} pallas vs xla {kernel_vs_plain:.3e} exceeds the plain "
          f"path's own distance from fp32 {plain_vs_fp32:.3e}")
    del fp32


def check_pinned_prefill(torch, label, cfg, model, tokens, path_routing, tol) -> None:
    """A moe prefill through the kernels against the plain (xla) one, on one
    routing.  A difference of 1e-6 in a hidden state can move a token to
    another expert or out of capacity, which moves its logits (and, through
    capacity, other tokens') by O(1), so every compared prefill replays the
    routing of the fp32 "xla" prefill (``models.moe.replay_routing``; the
    weights still come from each prefill's own probabilities), and each
    route's own, unpinned routing is reported beside it as flips: kept
    (token, expert) pairs per MoE layer that the fp32 "xla" prefill does
    not keep.  Then the rules of the dense phases hold: fp32 "pallas" vs
    "xla" (logits and KV cache) within ``tol``, and, on fp32-stored
    parameters, :func:`check_low_precision_prefill`'s bf16 rule against the
    pinned fp32 "xla" logits.  On bf16-stored parameters no fp32-stored
    reference of the same draws fits beside them on one card (maverick's
    would take 74.7 GB), so the bf16 distance is printed without a rule.
    The fp32 prefills' logits and caches wait on the host, and the
    allocator's cache is emptied before each prefill: an fp32 prefill on
    bf16-stored experts casts one 21.5 GB stack at a time, and a tensor
    held on the card across prefills can land in a freed cast's block and
    keep the rest of that block from the next cast."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe

    make = make_prefill_step(model)
    batch = {"tokens": tokens}

    def prefill(on_host: bool = False):
        torch.cuda.empty_cache()
        logits, cache = make(batch)
        if on_host:
            return logits.cpu(), {k: t.cpu() for k, t in cache_leaves(cache)}
        return logits

    with with_config(model, attn_impl="xla", dtype="float32"), moe.record_routing() as pin:
        ref32, ref_cache = prefill(on_host=True)
    flips = {f"pallas {cfg.dtype} (the path)": moe.flips(pin, path_routing)}
    for impl, dtype in (("pallas", "float32"), ("xla", cfg.dtype)):
        with with_config(model, attn_impl=impl, dtype=dtype), moe.record_routing() as own:
            prefill()
        flips[f"{impl} {dtype}"] = moe.flips(pin, own)
    with with_config(model, dtype="float32"), moe.replay_routing(pin):
        got32, got_cache = prefill(on_host=True)
    errs = {"logits": rel_err(got32, ref32)[1]}
    errs |= {key: rel_err(t, ref_cache[key])[1] for key, t in got_cache.items()}
    del got32, got_cache, ref_cache
    with moe.replay_routing(pin):
        logits = prefill()
    with with_config(model, attn_impl="xla"), moe.replay_routing(pin):
        want = prefill()
    ref32 = ref32.to(logits.device)
    kernel_vs_plain = fro_rel(logits, want)
    plain_vs_fp32 = fro_rel(want, ref32)
    print(f"{label} routing flips per MoE layer against the fp32 xla prefill's: {flips}",
          flush=True)
    print(f"{label} pinned to that routing: fp32 pallas vs xla max rel {errs} (tol {tol}); "
          f"{cfg.dtype}: pallas vs xla {kernel_vs_plain:.3e}, xla vs fp32 {plain_vs_fp32:.3e}, "
          f"pallas vs fp32 {fro_rel(logits, ref32):.3e} (Frobenius rel)", flush=True)
    check(all(e <= tol for e in errs.values()), f"{label}: fp32 pallas vs xla {errs} > {tol}")
    if cfg.param_dtype == "float32":
        check(kernel_vs_plain <= plain_vs_fp32,
              f"{label}: {cfg.dtype} pallas vs xla {kernel_vs_plain:.3e} exceeds the plain "
              f"path's own distance from fp32 {plain_vs_fp32:.3e}")
    else:
        print(f"{label}: parameters stored in {cfg.param_dtype}; no fp32-stored reference "
              f"fits beside them, so the {cfg.dtype} distance has no rule here", flush=True)
    del logits, want, ref32


def check_moe_repeats(torch, label, model, prompt) -> None:
    """The MoE layer of layer 0 (its first MoE layer) gives the same bits
    on two calls at the prefill's shape (4 x 2048 tokens of seeded x in the
    activation dtype); then a 1-slot engine answers one request (``prompt``,
    32 new tokens) equal to the direct greedy decode at batch 1.  The
    4-slot engine above routes each slot alone (``rows_apart``), as the
    reference's engine does, so its requests equal the direct decode too."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine, greedy_decode

    cfg = model.cfg
    p = {k: v.detach()[0] for k, v in model.moe_blocks.moe.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 2048, cfg.d_model, generator=gen, device="cuda").to(model.dtype)
    with torch.no_grad():
        out, aux = moe.apply_moe(p, x, cfg)
        again, again_aux = moe.apply_moe(p, x, cfg)
        torch.cuda.synchronize()
        ms = time_ms(lambda: moe.apply_moe(p, x, cfg), iters=5, warmup=1)
    check(bool(torch.equal(out, again) and torch.equal(aux, again_aux)),
          f"{label}: two calls of the MoE layer differ")
    print(f"{label} MoE layer on x (4, 2048, {cfg.d_model}) {cfg.dtype}: two calls bitwise "
          f"equal; {ms:.3f} ms a call (capacity {moe.capacity(cfg, 4 * 2048)} of "
          f"{4 * 2048} tokens an expert)", flush=True)
    del x, out, again
    engine = ServeEngine(model, slots=1, max_seq=1024)
    req = engine.submit(prompt, max_new_tokens=32)
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    direct = greedy_decode(model, prompt, 32, 1024, batch=1)
    check(req.output == direct, f"{label}: 1-slot engine {req.output} != direct decode "
          f"{direct}")
    print(f"{label} 1-slot engine: prompt {len(prompt)}, 32 new tokens in "
          f"{len(engine.tick_seconds)} ticks, {engine_s:.3f} s, median tick "
          f"{statistics.median(engine.tick_seconds) * 1e3:.3f} ms; equals direct decode at "
          f"batch 1: {req.output[:8]}...", flush=True)


def phase_serve_llama(torch) -> dict:
    """llama-130m (fp32): prefill 8 x 1024 through flash attention.  The
    direct decode is the single-request one (batch 1): fp32 GEMMs of one
    row and of eight round alike to far below the logits' gaps."""
    return phase_serve(torch, "serve-llama", "llama-130m", 8, 1024, 1e-4, direct_batch=1)


def phase_serve_mamba(torch) -> dict:
    """mamba2-370m (bf16 activations, fp32 parameters): prefill 4 x 4096
    through the SSD scan, held to the plain path as
    :func:`check_low_precision_prefill` says (fp32 within 1e-4), then an
    engine of 4 slots and 4 requests, one checked (cut from 8 / 16 to keep
    the run under 1000 s; phase 12's engine checks a reused Mamba slot).
    The direct decode runs the request alone in its slot's row of a 4-row
    cache (the other rows idle, as the engine's): bf16 GEMMs of another
    batch size pick other cuBLAS kernels, which round differently and move
    near-tied bf16 logits.  Then the same draws stored in bf16
    (``param_dtype``): the prefill held by the same rule against the
    fp32-stored model's fp32 logits (:func:`fp32_stored_reference`), an
    engine of 2 slots and 2 requests, one checked."""
    launches = collections.Counter(phase_serve(
        torch, "serve-mamba", "mamba2-370m", 4, 4096, 1e-4, direct_batch=4, slots=4,
        requests=4, checked=1))
    reference = fp32_stored_reference(torch, "serve-mamba-bf16", "mamba2-370m", 4, 4096, {})
    launches.update(phase_serve(
        torch, "serve-mamba-bf16", "mamba2-370m", 4, 4096, 1e-4, direct_batch=2, slots=2,
        requests=2, checked=1, changes={"param_dtype": "bfloat16"}, reference=reference))
    del reference
    torch.cuda.empty_cache()
    return dict(launches)


def fp32_stored_reference(torch, label: str, arch: str, batch: int, seq: int,
                          changes: dict):
    """The fp32 "xla" prefill logits, on the card, of ``arch`` (``changes``
    to its config) stored in fp32 from seed 0's draws, on
    :func:`serve_batch`'s inputs: what a bf16-stored copy of the same draws
    is held to (:func:`check_low_precision_prefill`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(dtype="float32", attn_impl="xla", **changes)
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    with torch.no_grad():
        logits = make_prefill_step(model)(serve_batch(torch, cfg, batch, seq))[0]
    torch.cuda.synchronize()
    print(f"{label} fp32-stored reference prefill {batch} x {seq}: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M fp32 parameters", flush=True)
    del model
    torch.cuda.empty_cache()
    return logits


# The head dims flash attention pads D to (its instantiations).
FLASH_TIERS = (16, 32, 64, 128, 192, 256)
# Phase 8: the dense variants at their published widths (bf16 activations,
# fp32 parameters), (layers, slots, requests, direct decodes checked) of
# each: depth cut to half of 28 / 32 / 40 layers to make room for phase 4i,
# then to a quarter for phase 4j.
DENSE_VARIANTS = {"chatglm3-6b": (7, 8, 9, 2), "starcoder2-7b": (8, 4, 4, 1),
                  "qwen1.5-4b": (10, 4, 4, 1)}


def phase_serve_dense(torch) -> dict:
    """Phase 8: chatglm3-6b, starcoder2-7b and qwen1.5-4b at full width,
    depth cut to 7 / 8 / 10 of their 28 / 32 / 40 layers (fp32
    parameters, bf16 activations), one model on the card at a time:
    prefill 4 x 2048 through
    the bf16 instantiation of flash attention, one launch a layer, against
    "xla" as :func:`check_low_precision_prefill` says, then the engine
    (DENSE_VARIANTS).  The direct decode runs the request in its slot's row
    of a cache as wide as the engine's, for the reason phase 7 gives."""
    print(f"serve-dense on {smi_line()}", flush=True)
    launches: dict = {}
    for arch, (layers, slots, requests, checked) in DENSE_VARIANTS.items():
        got = phase_serve(torch, f"serve-{arch}", arch, 4, 2048, 1e-4,
                          direct_batch=slots, slots=slots, requests=requests, checked=checked,
                          changes={"n_layers": layers})
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    return launches


# Phase 9: nemotron-4-340b at full width, its depth cut from 96 layers to
# NEMOTRON_LAYERS, its parameters stored in bf16 as the reference's
# param_dtype stores them (16.35B parameters, 32.7 GB: in fp32 two layers
# with the embedding and the untied head would take 65.4 GB before any
# activation).  The peak comes at the head of the fp32 "xla" comparison
# prefill: the parameters, three logits held (2.1 + 2.1 + 4.2 GB), the fp32
# cast of lm_head at its use (18.9 GB) and the new logits (4.2 GB), about
# 64 GB of the card's 85.5 GB.
NEMOTRON_LAYERS = 2


def phase_serve_nemotron(torch) -> dict:
    """Phase 9: nemotron-4-340b (d 18432, 96 heads over 8, head dim 192,
    d_ff 73728, vocab 256000) at NEMOTRON_LAYERS layers, bf16 parameters and
    activations: prefill 1 x 4096 (its published sequence length) through
    flash attention's bf16 head-dim-192 instantiation, one launch a layer,
    against "xla" as :func:`check_low_precision_prefill` says (its fp32
    prefill runs the fp32 head-dim-192 tier), then an engine of 4 slots and
    4 requests, one checked against direct decode in its slot's row of a
    4-row cache (phase 7's reason)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = get_config("nemotron-4-340b")
    print(f"serve-nemotron on {smi_line()}: depth cut from {cfg.n_layers} to "
          f"{NEMOTRON_LAYERS} layers, param_dtype bfloat16", flush=True)
    # The fp32 reference first, alone on the card: the same seed's draws
    # stored in fp32 (65.4 GB), prefilled in fp32; its logits wait on the host.
    cfg32 = cfg.replace(n_layers=NEMOTRON_LAYERS, dtype="float32", attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg32, device="cuda")
    model.init_params(0)
    with torch.no_grad():
        reference = make_prefill_step(model)({"tokens": prompt_tokens(torch, cfg.vocab, 1,
                                                                        4096)})[0].cpu()
    print(f"serve-nemotron fp32-stored reference prefill: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M fp32 parameters, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model
    torch.cuda.empty_cache()
    launches = phase_serve(torch, "serve-nemotron", "nemotron-4-340b", 1, 4096, 1e-4,
                           direct_batch=4, slots=4, requests=4, checked=1,
                           changes={"n_layers": NEMOTRON_LAYERS, "param_dtype": "bfloat16"},
                           reference=reference)
    torch.cuda.empty_cache()
    return launches


# Phases 10, 11: the moe family at full width, its depth cut to MOE_LAYERS
# layers.  dbrx-132b (40 layers): 7.751B parameters stored in fp32 (31.0 GB),
# bf16 activations, as phase 8.  llama4-maverick-400b (48 layers; one group
# of a dense block and an MoE block): 18.679B parameters stored in bf16
# (37.4 GB; fp32 would take 74.7 GB before any activation).  Its fp32
# comparison prefill casts each (128, 5120, 8192) expert stack to fp32 at its
# use (21.5 GB), one stack at a time.
MOE_LAYERS = 2


def phase_serve_moe(torch, label: str, arch: str, changes: dict) -> dict:
    """Serve ``arch`` at full width with MOE_LAYERS layers: prefill 4 x 2048
    through flash attention's bf16 instantiation (one launch a layer), held
    to "xla" on the fp32 "xla" prefill's routing (:func:`check_pinned_prefill`),
    a 4-slot engine answering 4 requests, one checked against direct decode
    in its slot's row, the MoE layer and the prefill repeated bitwise, and a
    1-slot engine against direct decode at batch 1."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    print(f"{label} on {smi_line()}: depth cut from {cfg.n_layers} to {MOE_LAYERS} layers, "
          f"{changes}", flush=True)
    launches = phase_serve(torch, label, arch, 4, 2048, 1e-4,
                           direct_batch=4, slots=4, requests=4, checked=1,
                           changes={"n_layers": MOE_LAYERS, **changes})
    torch.cuda.empty_cache()
    return launches


def phase_serve_dbrx(torch) -> dict:
    """Phase 10: dbrx-132b (d 6144, 48 heads over 8, head dim 128, 16
    experts of d_ff 10752, top-4, vocab 100352, untied), fp32 parameters."""
    return phase_serve_moe(torch, "serve-dbrx", "dbrx-132b", {})


def phase_serve_maverick(torch) -> dict:
    """Phase 11: llama4-maverick-400b (d 5120, 40 heads over 8, 128 experts
    of d_ff 8192, top-1, one shared expert, dense d_ff 16384, vocab 202048),
    bf16 parameters."""
    return phase_serve_moe(torch, "serve-maverick", "llama4-maverick-400b-a17b",
                           {"param_dtype": "bfloat16"})


# The integer arguments of each serving phase's kernel launches (prefill and
# engine run), by phase label: build.CALLS, read by the kernels line's tags.
PHASE_CALLS: dict[str, dict] = {}


# Phase 12's depth: zamba2-1.2b's 38 layers cut to 19 to keep the whole run
# under 1000 s.
ZAMBA2_LAYERS = 19
# Its engine's requests on 8 slots, cut from 16 to make room for phase 4h:
# the ninth takes a reused slot (252 ticks, not 450).
ZAMBA2_REQUESTS = 9


def phase_serve_zamba2(torch) -> dict:
    """Phase 12: zamba2-1.2b (hybrid: 38 Mamba-2 layers, d 2048, 64 SSD heads
    of 64, N 64, chunk 64; one shared block of 32 heads of 64 (MHA), d_ff
    8192, run after layers 0, 6, 12, ...), depth cut to ZAMBA2_LAYERS, fp32
    parameters, bf16 activations: prefill 4 x 4096 through the SSD scan (one
    launch a layer) and flash attention's bf16 instantiation at D = 64 (one
    a shared-block application), held to "xla" as
    :func:`check_low_precision_prefill` says, then an engine of 8 slots and
    ZAMBA2_REQUESTS requests (the decode runs no kernel), a reused slot
    checked against direct decode in its slot's row of an 8-row cache.
    Then the same draws stored in bf16: the prefill and its rule against the
    fp32-stored model's fp32 logits (:func:`fp32_stored_reference`), no
    engine."""
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-1.2b")
    apps = -(-ZAMBA2_LAYERS // cfg.shared_attn_every)
    print(f"serve-zamba2 on {smi_line()}: depth cut from {cfg.n_layers} to {ZAMBA2_LAYERS} "
          f"layers, the shared block {apps} times", flush=True)
    launches = collections.Counter(phase_serve(
        torch, "serve-zamba2", "zamba2-1.2b", 4, 4096, 1e-4, direct_batch=8,
        requests=ZAMBA2_REQUESTS, changes={"n_layers": ZAMBA2_LAYERS}))
    torch.cuda.empty_cache()
    # the same draws stored in bf16: the prefill and its rule, no engine
    depth = {"n_layers": ZAMBA2_LAYERS}
    reference = fp32_stored_reference(torch, "serve-zamba2-bf16", "zamba2-1.2b", 4, 4096, depth)
    launches.update(phase_serve(
        torch, "serve-zamba2-bf16", "zamba2-1.2b", 4, 4096, 1e-4, direct_batch=8, requests=0,
        changes={**depth, "param_dtype": "bfloat16"}, reference=reference))
    del reference
    torch.cuda.empty_cache()
    return dict(launches)


# Phase 13: llama-3.2-vision-11b at full width, its depth cut from 40 layers
# (8 groups of 5 self-attention blocks and a cross-attention block) to
# VISION_LAYERS (2 groups: 10 self blocks, 2 cross blocks; 3668.0M fp32
# parameters, 14.7 GB).
VISION_LAYERS = 10


def phase_serve_vision(torch) -> dict:
    """Phase 13: llama-3.2-vision-11b (d 4096, 32 heads over 8, head dim 128,
    d_ff 14336, vocab 128256, a gated cross-attention block after every 5
    self blocks over 1601 image tokens), VISION_LAYERS layers, fp32
    parameters, bf16 activations, seeded nonzero gates: prefill 4 x 2048
    with images (4, 1601, 4096) through flash attention's bf16
    instantiation, causal over the tokens (10 launches) and unmasked over
    the image tokens (2), held to "xla" as
    :func:`check_low_precision_prefill` says; fp32 decode from the prefill's
    cache against the forward; then an engine of 4 slots and 4 requests
    (every tick launches the kernel once a group: one query over the image
    K/V, which the engine, as the reference's, leaves zero), one checked
    against direct decode in its slot's row of a 4-row cache."""
    from repro_torch.configs import get_config

    cfg = get_config("llama-3.2-vision-11b")
    groups = VISION_LAYERS // cfg.cross_attn_every
    print(f"serve-vision on {smi_line()}: depth cut from {cfg.n_layers} to {VISION_LAYERS} "
          f"layers ({groups} groups)", flush=True)
    launches = phase_serve(torch, "serve-vision", "llama-3.2-vision-11b", 4, 2048, 1e-4,
                           direct_batch=4, slots=4, requests=4, checked=1,
                           changes={"n_layers": VISION_LAYERS},
                           per_tick={"flash_attention": groups})
    torch.cuda.empty_cache()
    return launches


def phase_serve_hubert(torch) -> dict:
    """Phase 14: hubert-xlarge (encoder-only, d 1280, 16 heads of 80, d_ff
    5120, LayerNorm, GELU, no RoPE, vocab 504), all 48 layers, fp32
    parameters, bf16 activations: an encoder forward of 4 x 4096 seeded
    frames x 0.02 through ``make_prefill_step``, flash attention's bf16
    instantiation unmasked at D = 80 (padded to 128; 48 launches), held to
    "xla" as :func:`check_low_precision_prefill` says.  No engine."""
    print(f"serve-hubert on {smi_line()}", flush=True)
    launches = phase_serve(torch, "serve-hubert", "hubert-xlarge", 4, 4096, 1e-4,
                           direct_batch=1)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- phase 5


def phase_agree(torch):
    """llama-60m smoke on the card (CUDA kernels) and on the CPU (plain
    versions), same parameters, same sampled blocks and projector draws (the
    default sampler and noise draw on the host): the losses agree, for GUM,
    for GaLore-Muon family-stacked with the fused epilogue and weight decay
    (the kernel's W operand), for family-stacked GUM, and for phase 4c's
    optimizers and LISA.  Tolerance 1e-4 relative: the two devices sum in
    another order, and the difference compounds over 3 optimizer steps.
    With period 2 the losses read only the first period's updates, so the
    sign each device's SVD or QR gives a projector column (which a carried
    momentum would see after the second refresh) does not enter them.
    Each path's kernel must launch on the card and not on the CPU; LISA
    runs AdamW alone, so no kernel may launch for it on either."""
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig
    from repro_torch.data import DataConfig
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg = get_smoke("llama-60m")
    model = build_model(cfg, device="cpu")
    model.init_params(0)
    params = {k: v.detach() for k, v in model.params().items()}
    for label, opt_cfg, kernel in [
            ("gum", OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2),
             "lowrank_update"),
            ("galore_muon fused epilogue wd",
             OptimizerConfig(name="galore_muon", lr=1e-2, rank=4, period=2,
                             weight_decay=0.01, fuse_families=True, fused_epilogue=True),
             "back_project_epilogue"),
            ("gum fused families",
             OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2,
                             fuse_families=True),
             "lowrank_update"),
            ("muon", OptimizerConfig(name="muon", lr=1e-2), "gram"),
            ("golore fused epilogue",
             OptimizerConfig(name="golore", lr=1e-2, rank=4, period=2, base="sgdm",
                             fuse_families=True, fused_epilogue=True),
             "back_project_epilogue"),
            ("fira", OptimizerConfig(name="fira", lr=1e-2, rank=4, period=2), "back_project"),
            ("unbiased_galore_adam",
             OptimizerConfig(name="unbiased_galore_adam", lr=1e-2, rank=4, gamma=1, period=2),
             "back_project"),
            ("lisa", OptimizerConfig(name="lisa", lr=1e-3, gamma=1, period=2), None),
            ("gum sgdm rsvd",
             OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2, base="sgdm",
                             projector="rsvd"),
             "lowrank_update")]:
        losses = {}
        for device in ("cpu", "cuda"):
            before = dict(build.LAUNCHES)
            with scratch_dir("agree") as ckpt_dir:
                trainer = Trainer(build_model(cfg, device=device), opt_cfg,
                                  RunConfig(steps=3, log_every=0, seed=0, ckpt_dir=ckpt_dir),
                                  DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2,
                                             seed=0),
                                  device=device, params=params)
                losses[device] = trainer.train().losses
            if kernel is None:
                check(build.LAUNCHES == before, f"agree {label} on {device}: kernels "
                      f"launched {before} -> {build.LAUNCHES}")
            else:
                check((build.LAUNCHES[kernel] > before[kernel]) == (device == "cuda"),
                      f"agree {label} on {device}: {kernel} launches "
                      f"{before[kernel]} -> {build.LAUNCHES[kernel]}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        print(f"agree llama-60m smoke {label}: cuda {losses['cuda']} cpu {losses['cpu']} "
              f"max rel {worst:.2e}", flush=True)
        check(worst <= 1e-4, f"agree {label}: cuda and cpu losses differ by "
              f"{worst:.2e} > 1e-4")


MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")


def gum_counts(n: int) -> tuple[dict, dict]:
    """GUM's dispatches and kernel launches a step over ``n`` low-rank
    leaves, whatever their lead dims (each leaf is one dispatch, its lead
    flattened into the kernels' batch): per leaf one lowrank_update and one
    project (both kernel row 1-2's lowrank_update), two back_projects and
    two newton_schulz (5 gram and 5 poly_apply launches each)."""
    return ({"lowrank_update": n, "project": n, "back_project": 2 * n, "newton_schulz": 2 * n},
            {"lowrank_update": 2 * n, "back_project": 2 * n, "gram": 10 * n,
             "poly_apply": 10 * n})


def phase_agree_moe(torch):
    """The moe family's SMOKE models (dbrx-132b: 4-D expert leaves (L, E,
    d, f); llama4-maverick-400b: those and the grouped (G, per, d, f) dense
    leaves) through a 3-step GUM ``Trainer`` on the card and on the CPU, as
    :func:`phase_agree`: the same parameters and data, the losses within
    1e-4.  The card's run replays the CPU run's routing (every MoE call of
    the 3 steps; ``models.moe.replay_routing``), so a token near a routing
    tie cannot move the losses by O(1); an unpinned card run is reported
    beside it (flips per MoE call and its losses).  The card's per-step
    dispatch and kernel launch counts are exact: :func:`gum_counts` over the
    leaves ``default_lowrank_filter`` sends to GUM (7 for dbrx, 17 for
    maverick); the CPU dispatches the same and launches nothing."""
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig
    from repro_torch.core.lowrank_common import default_lowrank_filter
    from repro_torch.data import DataConfig
    from repro_torch.kernels import build, launch_count
    from repro_torch.models import build_model, moe
    from repro_torch.train import Trainer

    opt_cfg = OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2)
    steps = 3
    for arch in MOE_ARCHS:
        cfg = get_smoke(arch)
        model = build_model(cfg, device="cpu")
        model.init_params(0)
        params = {k: v.detach() for k, v in model.params().items()}
        n = sum(default_lowrank_filter(k, p) for k, p in params.items())
        want_d, want_l = gum_counts(n)

        def run(device, routing):
            before = dict(build.LAUNCHES)
            with scratch_dir("agree-moe") as ckpt_dir, \
                    launch_count.count_launches() as dispatched, routing as log:
                result = Trainer(build_model(cfg, device=device), opt_cfg,
                                 RunConfig(steps=steps, log_every=0, seed=0, ckpt_dir=ckpt_dir),
                                 DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0),
                                 device=device, params=params).train()
            torch.cuda.synchronize()
            launched = {k: (v - before[k]) / steps for k, v in build.LAUNCHES.items()
                        if v != before[k]}
            return result.losses, {k: v / steps for k, v in dispatched.items()}, launched, log

        cpu, cpu_d, cpu_l, cpu_log = run("cpu", moe.record_routing())
        free, _, _, free_log = run("cuda", moe.record_routing())
        card, card_d, card_l, _ = run("cuda", moe.replay_routing(cpu_log))
        check(cpu_d == want_d and cpu_l == {}, f"agree {arch} gum on the cpu: dispatch "
              f"{cpu_d} != {want_d} or launches {cpu_l}")
        check(card_d == want_d and card_l == want_l, f"agree {arch} gum on the card: dispatch "
              f"{card_d} != {want_d} or launches {card_l} != {want_l}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        free_worst = max(abs(a - b) / abs(b) for a, b in zip(free, cpu))
        print(f"agree {arch} smoke gum ({n} low-rank leaves; dispatch per step {want_d}, "
              f"launches per step {want_l}): cuda {card} cpu {cpu} max rel {worst:.2e} on the "
              f"cpu's routing; unpinned cuda {free} max rel {free_worst:.2e}, flips per MoE "
              f"call {moe.flips(cpu_log, free_log)}", flush=True)
        check(len(card) == steps and worst <= 1e-4, f"agree {arch} gum: cuda and cpu losses "
              f"differ by {worst:.2e} > 1e-4")


def phase_agree_serve(torch):
    """The prefill of llama-60m SMOKE, mamba2-370m SMOKE, the three dense
    variants' SMOKE (fp32; chatglm3-6b's 2-D RoPE, qwen1.5-4b's MHA and qkv
    biases, starcoder2-7b's layernorm, GELU and mlp biases, a ragged
    sequence) and nemotron-4-340b's SMOKE (squared ReLU, untied head) and
    its head-dim-192 variant, the moe family's SMOKE (dbrx-132b,
    llama4-maverick-400b), and the last families' SMOKE: zamba2-1.2b (the
    SSD scan and the shared block's attention), llama-3.2-vision-11b (with
    images and seeded nonzero gates: the cross-attention unmasked over 16
    image tokens) and hubert-xlarge (frames, unmasked), at
    attn_impl="pallas" on the card (the kernels, D = 16 and 192; chunk 16,
    N 16, P 16, a ragged last chunk) and on the CPU (their plain versions),
    same parameters and inputs: logits within 1e-4 relative (fp32 sums in
    another order through two or three layers), each kernel launched as
    often as the family's layout says.  A moe prefill on the card replays
    the CPU's routing (its own flips printed beside)."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, moe

    for arch, changes, seq in [("llama-60m", {}, 64), ("mamba2-370m", {}, 60),
                               ("chatglm3-6b", {}, 64), ("qwen1.5-4b", {}, 64),
                               ("starcoder2-7b", {}, 60), ("nemotron-4-340b", {}, 64),
                               ("nemotron-4-340b", {"head_dim": 192}, 60),
                               *((name, {}, 64) for name in MOE_ARCHS),
                               ("zamba2-1.2b", {}, 60), ("llama-3.2-vision-11b", {}, 64),
                               ("hubert-xlarge", {}, 60)]:
        cfg = get_smoke(arch).replace(attn_impl="pallas", **changes)
        cpu = build_model(cfg, device="cpu")
        cpu.init_params(0)
        if cfg.family == "vlm":
            set_vlm_gates(torch, cpu)
        card = build_model(cfg, device="cuda")
        card.load_params({k: v.detach() for k, v in cpu.params().items()})
        rng = np.random.default_rng(0)
        inputs = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)))}
        if cfg.family == "vlm":
            inputs["images"] = torch.from_numpy(
                0.02 * rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model))).float()
        if cfg.frontend == "frames":
            inputs = {"frames": torch.from_numpy(
                0.02 * rng.standard_normal((2, seq, cfg.d_model))).float()}
        on_card = {k: v.to("cuda") for k, v in inputs.items()}
        build.reset_launches()
        with moe.record_routing() as card_log:
            got, _ = make_prefill_step(card)(on_card)
        torch.cuda.synchronize()
        ran = {k: v for k, v in build.LAUNCHES.items() if v}
        check(ran == expected_launches(cfg),
              f"agree prefill {arch}: kernel launches {ran} != {expected_launches(cfg)}")
        with moe.record_routing() as cpu_log:
            want, _ = make_prefill_step(cpu)(inputs)
        routed = ""
        if cpu_log.calls:
            routed = f" on the cpu's routing (unpinned flips {moe.flips(cpu_log, card_log)})"
            with moe.replay_routing(cpu_log):
                got, _ = make_prefill_step(card)(on_card)
        _, rel = rel_err(got.cpu(), want)
        print(f"agree {arch} smoke{f' {changes}' if changes else ''} prefill at "
              f"attn_impl=pallas: cuda vs cpu max rel {rel:.2e}{routed}", flush=True)
        check(rel <= 1e-4, f"agree prefill {arch}: {rel:.2e} > 1e-4")


# The full-width paths, in order; each returns its kernel launches.
PHASES = {"slice": phase_slice, "galore": phase_galore, "baselines": phase_baselines,
          "accumulate": phase_accumulate, "resume": phase_resume,
          "rank-policy": phase_rank_policy, "resilience": phase_resilience,
          "telemetry": phase_telemetry, "audit": phase_audit,
          "bf16-train": phase_bf16_train, "distributed": phase_distributed,
          "ssm-train": phase_ssm_train,
          "serve-llama": phase_serve_llama, "serve-mamba": phase_serve_mamba,
          "serve-dense": phase_serve_dense, "serve-nemotron": phase_serve_nemotron,
          "serve-dbrx": phase_serve_dbrx, "serve-maverick": phase_serve_maverick,
          "serve-zamba2": phase_serve_zamba2, "serve-vision": phase_serve_vision,
          "serve-hubert": phase_serve_hubert}


def every_launch(key: tuple) -> bool:
    return True


# An instantiation or input reported beside its kernel's row: the serving
# phases (their labels) whose launches of the kernel it counts, and which of
# those launches, a test on each launch's integer arguments (build.CALLS;
# flash_attention's (B, S, T, H, KV, D, causal, element type)).
TAGGED = {("flash_attention", "bf16"): (tuple(f"serve-{a}" for a in DENSE_VARIANTS),
                                        every_launch),
          ("flash_attention", "bf16_d192"): (("serve-nemotron",), every_launch),
          ("flash_attention", "bf16_moe"): (("serve-dbrx", "serve-maverick"), every_launch),
          ("ssd_scan", "zamba2"): (("serve-zamba2",), every_launch),
          ("flash_attention", "bf16_zamba2"): (("serve-zamba2",), every_launch),
          ("flash_attention", "bf16_vision_self"): (("serve-vision",), lambda key: key[6]),
          ("flash_attention", "bf16_vision_cross"): (("serve-vision",),
                                                     lambda key: not key[6] and key[1] > 1),
          ("flash_attention", "bf16_vision_decode"): (("serve-vision",),
                                                      lambda key: not key[6] and key[1] == 1),
          ("flash_attention", "bf16_hubert"): (("serve-hubert",), every_launch),
          # back_project_epilogue's (L, m, r, n, right, w_bf16)
          ("back_project_epilogue", "bf16_w"): (("bf16 galore", "distributed galore"),
                                                lambda key: key[5] == 1),
          # ... on the parts of split parameters (phase 4i's fused GaLore)
          ("back_project_epilogue", "bf16_w_cut"): (("split galore",),
                                                    lambda key: key[5] == 1),
          # ... on the model-axis cuts of phase 4i's tensor-parallel GaLore
          ("back_project_epilogue", "tp_cut"): (("tp galore",), every_launch)}
# Rows 1-5 at phase 4l's shapes (SSM_CASES): its launches on ssm_in (n =
# 4384), over the 48 layers ("ssm") and over the 4 sampled blocks
# ("ssm_project", "ssm_full"); (L, m, r, n, right) and gram / poly_apply's
# (L, s, n).
TAGGED |= {(kernel, tag): (("ssm train",), lambda key, lead=lead: key[0] == lead
                           and 4384 in key[1:])
           for kernel, tag, lead in (("lowrank_update", "ssm", 48),
                                     ("lowrank_update", "ssm_project", 4),
                                     ("back_project", "ssm", 48), ("gram", "ssm", 48),
                                     ("gram", "ssm_full", 4), ("poly_apply", "ssm", 48),
                                     ("poly_apply", "ssm_full", 4))}
# Shapes reported beside a row's principal one: rows 1-5 at rank 128.
RANK_TAGS = ("r128", "r128_project", "momenta_r256", "momenta_r128")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    kernels_only = "--kernels-only" in sys.argv[1:]
    smi = smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{next(iter(libs.values())).parent}", flush=True)
    for name, so in libs.items():
        for entry, regs, spills in ptxas_report((so.parent / f"{name}.log").read_text()):
            print(f"ptxas {name}: {entry}: {regs} registers, {spills} bytes spill stores",
                  flush=True)

    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    print(f"kernels phase: {time.perf_counter() - t0:.1f} s", flush=True)
    if kernels_only:
        print("kernels-only: phase 3 passed; the path did not run, so no result is printed",
              flush=True)
        return
    paths, seconds, held = {}, {}, {}
    for name, fn in PHASES.items():
        # an earlier phase's reference cycles and cached blocks go before this
        # phase allocates: a block held across phases can split a large
        # cached segment and keep a later large allocation (an fp32 cast of
        # a 21.5 GB expert stack) from it
        gc.collect()
        torch.cuda.empty_cache()
        held[name] = round(torch.cuda.memory_allocated() / 2**30, 3)
        t0 = time.perf_counter()
        paths[name] = fn(torch)
        seconds[name] = round(time.perf_counter() - t0, 1)
    launches = {k: sum(path.get(k, 0) for path in paths.values()) for k in rows}
    for fn in (phase_agree, phase_agree_moe, phase_agree_serve):
        t0 = time.perf_counter()
        fn(torch)
        seconds[fn.__name__] = round(time.perf_counter() - t0, 1)
    print(f"seconds by phase: {seconds}", flush=True)
    print(f"GiB allocated on the card at each phase's start: {held}", flush=True)

    kernels = []
    for name, (source, replaces, headers) in KERNEL_META.items():
        row = rows[name]
        check(launches[name] > 0, f"kernel {name} never launched on the path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "headers": list(headers), "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": row["shape"]})
        kernels[-1].update({tag: row[tag] for tag in RANK_TAGS if tag in row})
        for (kname, tag), (labels, counts) in TAGGED.items():
            if kname == name:
                tagged = sum(n for label in labels
                             for key, n in PHASE_CALLS[label][name].items() if counts(key))
                check(tagged > 0, f"kernel {name} ({tag}) never launched on the path")
                kernels[-1][tag] = row[tag] | {"launches": tagged}
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
