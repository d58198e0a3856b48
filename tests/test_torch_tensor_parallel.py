"""Tensor parallelism over a mesh's ``model`` axis: ``Trainer(mesh=)`` on
(data=2, model=2), (data=1, model=2) and (data=1, model=4) meshes of local
gloo ranks (one 4-rank spawn of ``repro_torch.launch.mesh.run_local_ranks``;
the rank side is ``tests/torch_tp_workers.py``), the CLI under ``torchrun``,
and the refusals.

(a) GUM family-stacked, per leaf and under ``shard_state``, AdamW, and
    fused GaLore with weight decay 0.01 on llama-60m ``SMOKE`` at (2, 2) and
    (1, 2), from the reference's initial parameters and block draws, each
    held to the port's one-process run: losses 1e-5 relative, the low-rank
    leaves 1e-5 and AdamW's leaves 1e-4 by relative Frobenius distance
    (GaLore keeps its moments across a refresh, so the SVD's rotation of a
    last-bit difference shows elementwise); every rank holds the same whole
    parameters and its share of the parameter bytes.
(b) The same GUM run against the reference's pjit ``Trainer`` on a
    (data=2, model=2) mesh of 4 host devices (``tests/jax_pjit_reference.py``
    in a JAX process of its own), at those tolerances.
(c) Every dense ``SMOKE`` config at (1, 2) (chatglm3-6b, qwen1.5-4b,
    starcoder2-7b with its biases and layernorm, nemotron-4-340b), and
    chatglm3-6b at (1, 4), where its 2 kv heads do not divide over the axis
    and ``wk`` / ``wv`` are gathered whole in the forward.
(d) bf16 storage (``param_dtype="bfloat16"``) by the precision rule of
    ``tests/test_torch_bf16_train.py``,
    against the run on a mesh of one rank (which, as every mesh step,
    reduces each bf16 gradient in fp32) and the fp32 run of the same draws.
(e) ``logit_chunk > 0``: the chunked vocab-parallel loss; and remat, whose
    recomputation sums each layer's attention over the axis again.
(f) ``shard_params`` at (2, 2): leaves split on two dims, bitwise the (2, 2)
    run without it (GUM, and fused GaLore, whose epilogue launches on
    operands cut on both sides).
(g) Resume across the layouts with and without ``shard_params``, bitwise.
(h) Every step's collectives against ``analysis/collectives.py``'s model:
    no finding, and the counts of a forward and backward of 2 layers.
(i) The CLI under ``torchrun --nproc-per-node 4`` with ``--mesh
    data=2,model=2 --audit``.
(j) The refusals: the other families (items 5m, 5c), q heads that do not
    divide (5n), a rank policy (5k), the projected-space accumulator (5j),
    a dim over two axes (5d), and ``make_shardmap_train_step``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.launch.mesh import Mesh, run_local_ranks
from repro_torch.models import build_model
from torch_threads import _one_thread  # noqa: F401  (autouse)
from torch_tp_workers import BATCH, STEPS, TP_OPTS

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ARCH = "llama-60m"
CASES = list(TP_OPTS)
SHAPES = ["2x2", "1x2"]
VARIANTS = ["chatglm3-6b", "qwen1.5-4b", "starcoder2-7b", "nemotron-4-340b"]
# shard_state splits state over the data axis: its one-process twin is GUM's
TWIN = {c: "gum" if c == "gum_zero" else c for c in CASES}
SCENARIOS = ([f"one:{c}::" for c in CASES if TWIN[c] == c]
             + [f"one:gum:{a}:" for a in VARIANTS]
             + ["one:gum::bf16", "one:gum::chunk", "one:gum::remat"]
             + [f"tp:{c}:{s}" for c in CASES for s in SHAPES]
             + ["tp:gum:2x2:sp", "tp:galore_wd:2x2:sp"]
             + [f"arch:{a}:1x2" for a in VARIANTS] + ["arch:chatglm3-6b:1x4"]
             + ["variant:bf16:1x2", "variant:chunk:1x2", "variant:remat:1x2",
                "resume:split>replicated", "resume:replicated>split"])
SPAWN_TIMEOUT = 240
LR = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_smoke as j_get_smoke
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from test_torch_distributed import jax_sampler

    base = tmp_path_factory.mktemp("tp")
    jcfg = j_get_smoke(ARCH)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(jparams)).items()}
    gamma = TP_OPTS["gum"]["gamma"]
    samples = {((0, count, i), jcfg.n_layers, gamma): jax_sampler((0, count, i), jcfg.n_layers,
                                                                  gamma)
               for count in (1, 4) for i in range(len(params))}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    reference = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "jax_pjit_reference.py"),
         str(base / "pjit.npz"), str(STEPS), "2,2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        inputs = {"dir": str(base / "runs"), "params": params, "samples": samples,
                  "scenarios": SCENARIOS}
        ranks = run_local_ranks("torch_tp_workers:scenarios", 4, args=(inputs,),
                                workdir=str(base / "ranks"), extra_path=[TESTS],
                                timeout=SPAWN_TIMEOUT)
        log, _ = reference.communicate(timeout=SPAWN_TIMEOUT)
        assert reference.returncode == 0, log.decode()[-4000:]
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()
    out = {"ranks": ranks, "pjit": dict(np.load(base / "pjit.npz"))}
    for rank in ranks:  # each one-process twin ran on one rank
        out.update({k: v for k, v in rank.items() if k.startswith("one:")})
    return out


def result(runs, name: str, rank: int = 0) -> dict:
    got = runs[name] if name.startswith("one:") else runs["ranks"][rank][name]
    assert "error" not in got, got.get("error")
    return got


def rel_fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def close(got: dict, want: dict, *, loss_tol=1e-5, lowrank_tol=1e-5, adamw_tol=1e-4,
          noise: tuple = ()) -> None:
    """``got`` against ``want``: losses, then each leaf by relative Frobenius
    distance, the low-rank ones at ``lowrank_tol``; a leaf of ``noise``
    (whose gradient is zero in exact arithmetic) within ``STEPS`` AdamW
    steps of ``LR`` each, elementwise."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_tol, atol=0)
    for k, w in want["params"].items():
        g = got["params"][k]
        if k.rsplit("/", 1)[-1] in noise:
            assert np.abs(g - w).max() <= 2 * STEPS * LR, k
        elif default_lowrank_filter(k, torch.from_numpy(w)):
            assert rel_fro(g, w) <= lowrank_tol, (k, rel_fro(g, w))
        else:
            assert rel_fro(g, w) <= adamw_tol, (k, rel_fro(g, w))


def same(a: dict, b: dict) -> bool:
    return (a["losses"] == b["losses"] and list(a["params"]) == list(b["params"])
            and all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_matches_the_one_process_run(runs, case, shape):
    """(a) against the one-process run; the ranks agree; each holds its
    share of the parameter bytes (the model side split alone)."""
    want = result(runs, f"one:{TWIN[case]}::")
    first = result(runs, f"tp:{case}:{shape}")
    assert len(first["losses"]) == STEPS
    close(first, want, lowrank_tol=1e-4 if case == "adamw" else 1e-5)
    for rank in range(4):  # the two (1, 2) meshes are replicas
        got = result(runs, f"tp:{case}:{shape}", rank)
        assert same(got, first), rank
        assert got["held"] == got["rule"] < got["whole"], (got["held"], got["rule"])


def test_tracks_the_pjit_reference(runs):
    """(b) the reference's pjit ``Trainer`` on (data=2, model=2)."""
    got = result(runs, "tp:gum:2x2")
    ref = runs["pjit"]
    want = {"losses": list(ref["losses"]),
            "params": {k: v for k, v in ref.items() if k != "losses"}}
    close(got, want)


@pytest.mark.parametrize("where", [f"{a}:1x2" for a in VARIANTS] + ["chatglm3-6b:1x4"])
def test_dense_variants(runs, where):
    """(c) each dense ``SMOKE`` config against its one-process run.  The
    gradient of ``bias_k`` is zero in exact arithmetic (a query's scores
    all shift by the same ``q · bias_k``), so AdamW moves it by its
    normalised rounding noise, up to ``LR`` a step, on either side."""
    arch, shape = where.split(":")
    got = result(runs, f"arch:{arch}:{shape}")
    close(got, result(runs, f"one:gum:{arch}:"), noise=("bias_k",))
    for rank in range(1, 4):
        assert same(result(runs, f"arch:{arch}:{shape}", rank), got)
    if shape == "1x4":  # the gathered kv heads: one all-gather of each of wk, wv a layer
        assert got["counts"][1]["all_gather:tp_kv@model"] == 2 * get_smoke(arch).n_layers


def test_bf16_storage(runs):
    """(d) bf16-stored parameters at (1, 2), by the precision rule of
    ``tests/test_torch_bf16_train.py``: the
    losses (as one vector) and every leaf no farther, in relative Frobenius
    distance, from the bf16-stored run on a mesh of one rank than that run
    lies from the fp32 run of the same draws.  A bf16 gradient entry that
    rounds the other way is an ulp of the gradient, and GUM's Newton-Schulz
    step turns it into an O(lr) change of the update, as it turns storage
    rounding into one."""
    got, ref16 = result(runs, "variant:bf16:1x2"), result(runs, "one:gum::bf16")
    ref32 = result(runs, "one:gum::")
    gap = np.asarray(got["losses"]) - np.asarray(ref16["losses"])
    own = np.asarray(ref16["losses"]) - np.asarray(ref32["losses"])
    assert np.linalg.norm(gap) <= np.linalg.norm(own), (gap, own)
    for k, w in ref16["params"].items():
        d, yard = rel_fro(got["params"][k], w), rel_fro(w, ref32["params"][k])
        assert d <= yard, (k, d, yard)


def test_chunked_loss(runs):
    """(e) ``logit_chunk`` = 8: the vocab-parallel loss chunk by chunk."""
    got = result(runs, "variant:chunk:1x2")
    close(got, result(runs, "one:gum::chunk"))
    assert got["counts"][1]["all_reduce:tp_loss@model"] == 3 * 8


def test_remat(runs):
    """(e) remat on: its recomputation of a layer stops at the last tensor
    the backward reads, so it repeats the attention's sum over the axis and
    not the MLP's (the layer's output): 3 sums a layer and the
    embedding's."""
    got = result(runs, "variant:remat:1x2")
    close(got, result(runs, "one:gum::remat"))
    L = get_smoke(ARCH).n_layers
    assert got["counts"][1]["all_reduce:tp_fwd@model"] == 3 * L + 1


@pytest.mark.parametrize("case", ["gum", "galore_wd"])
def test_shard_params_is_bitwise(runs, case):
    """(f) split over both axes: bitwise the (2, 2) run without it, each
    rank holding ``per_shard_bytes`` (the reference's rule on both axes)."""
    for rank in range(4):
        split = result(runs, f"tp:{case}:2x2:sp", rank)
        assert same(split, result(runs, f"tp:{case}:2x2", rank))
        assert split["held"] == split["rule"] < split["whole"] // 2


@pytest.mark.parametrize("path", ["split>replicated", "replicated>split"])
def test_resume_across_layouts(runs, path):
    """(g) 2 steps and a checkpoint in one layout, 2 more in the other:
    bitwise the uninterrupted run."""
    got = result(runs, f"resume:{path}")
    want = result(runs, "tp:gum_zero:2x2")
    assert got["resumed_from"] == 2
    assert got["losses"] == want["losses"][2:]
    assert got["params"].keys() == want["params"].keys()
    assert all(np.array_equal(got["params"][k], want["params"][k]) for k in want["params"])


def test_collectives_are_the_model(runs):
    """(h) every run's every step against the closed-form schedule, and a
    steady step of llama-60m (2 layers, remat off) at (2, 2): 5 forward and
    5 backward activation sums of (2, 64, 64) fp32, 3 loss reductions of
    the 2 x 63 shifted rows, one gather of the model-split gradients."""
    names = [n for n in SCENARIOS if not n.startswith(("one:", "resume:"))]
    for name in names:
        for rank in range(4):
            got = result(runs, name, rank)
            assert got["findings"] == [], (name, rank, got["findings"])
    got = result(runs, "tp:gum:2x2")
    counts = got["counts"][1]
    assert {k: v for k, v in counts.items() if k.endswith("@model")} == {
        "all_reduce:tp_fwd@model": 5, "all_reduce:tp_bwd@model": 5,
        "all_reduce:tp_loss@model": 3, "all_gather:tp_grad@model": 1}
    sizes = {(op, tag): b for op, tag, axis, _, b in got["log"] if axis == "model"}
    rows = BATCH // 2
    assert sizes[("all_reduce", "tp_fwd")] == rows * 64 * 64 * 4
    assert sizes[("all_reduce", "tp_loss")] == rows * 63 * 4
    assert got["schedule"]["tp_grad_gather"][2] == sum(
        v.size * 4 for k, v in got["params"].items() if "norm" not in k) // 2


def test_cli_under_torchrun(tmp_path):
    """(i) ``--mesh data=2,model=2 --audit`` at 4 gloo ranks: the sharded
    audit of the tensor-parallel step is clean, one rank prints the done
    line, and the run log holds every step's loss."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
           "--rank", "4", "--gamma", "1", "--period", "3", "--ckpt-dir", str(tmp_path),
           "--mesh", "data=2,model=2", "--audit", "--telemetry", "every=1,stdout=0"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "audit sharded:gum@data=2,model=2: clean" in out.stdout, out.stdout
    assert len([line for line in out.stdout.splitlines()
                if line.startswith("done: step=3")]) == 1
    with open(tmp_path / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss"]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_what_raises(tmp_path):
    """(j) the refusals, each naming its ROADMAP item."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig, gum_accum_tools
    from repro_torch.data import DataConfig
    from repro_torch.launch.shardmap_fsdp import make_shardmap_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import Spec, row_splits
    from repro_torch.train import Trainer

    tp = Mesh((1, 2), ("data", "model"))
    run = RunConfig(steps=1, log_every=0, ckpt_dir=str(tmp_path))

    def trainer(arch, opt=OptimizerConfig(name="gum", rank=4), cfg=None, **kw):
        cfg = cfg or get_smoke(arch)
        return Trainer(build_model(cfg, device="cpu"), opt, run,
                       DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
                       device="cpu", mesh=tp, **kw)

    for arch in ("mamba2-370m", "zamba2-1.2b", "hubert-xlarge", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError, match="item 5m"):
            trainer(arch)
    with pytest.raises(NotImplementedError, match="item 5c"):
        trainer("dbrx-132b")
    with pytest.raises(NotImplementedError, match="item 5n"):
        trainer(ARCH, cfg=get_smoke(ARCH).replace(n_heads=3, n_kv_heads=3))
    with pytest.raises(NotImplementedError, match="item 5k"):
        trainer(ARCH, opt=OptimizerConfig(name="gum", rank=4, rank_policy="stepwise:0=4"))

    class Split:  # a split over a model axis of 2
        tp = 2

    tools = gum_accum_tools(1e-3, rank=4, gamma=1, period=3)
    with pytest.raises(NotImplementedError, match="item 5j"):
        make_train_step(build_model(get_smoke(ARCH), device="cpu"), tools.transform,
                        microbatches=2, lowrank_accum=tools, mesh=tp, param_split=Split())
    with pytest.raises(NotImplementedError, match="item 5d"):
        row_splits({"w": Spec((("pod", "data"), None))}, Mesh((2, 2), ("pod", "data")))
    with pytest.raises(NotImplementedError, match="data-parallel step"):
        make_shardmap_train_step(build_model(get_smoke(ARCH), device="cpu"),
                                 tools.transform, tp)


def test_model_flops_per_device():
    """The roofline's model FLOPs a device divide the step's over D·T."""
    from repro_torch.launch.roofline import Shape, model_flops, model_flops_per_device

    cfg, shape = get_smoke(ARCH), Shape("t", 64, 8, "train")
    whole = model_flops(cfg, shape)
    assert model_flops_per_device(cfg, shape) == whole
    assert model_flops_per_device(cfg, shape, Mesh((2, 2), ("data", "model"))) == whole / 4
    assert model_flops_per_device(cfg, shape, Mesh((1, 2), ("data", "model"))) == whole / 2
