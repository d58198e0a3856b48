"""Parameter sharding (FSDP by the reference's ``PARAM_RULES``) on the port's
data mesh: ``Trainer(mesh=, shard_params=True)``, run by 2 and 4 local gloo
ranks (``repro_torch.launch.mesh.run_local_ranks``, one spawn per rank
count; the rank side is ``tests/torch_dist_workers.py``), the CLI's
``--shard-params`` under ``torchrun``, and the split helpers alone.

(a) At 2 ranks a split run is bitwise the replicated mesh run (losses and
    the gathered parameters): GUM family-stacked (from the reference's
    initial parameters and draws), per leaf and under ``shard_state``;
    AdamW; fused GaLore with weight decay 0.01 (the cut ``PendingBack``);
    bf16 storage; mamba2-370m ``SMOKE``.  Each rank holds
    ``per_shard_bytes`` of parameters, and every collective of a step
    equals ``analysis/collectives.py``'s model.  The other families
    (zamba2, dbrx, maverick, the vlm with images, hubert with frames) pass
    the same check through ``make_shardmap_train_step``.
(b) At 4 ranks (llama-60m ``SMOKE``'s L = 2 leaves the stacked norms
    whole): ``shard_state`` on against off bitwise, both within 1e-6 of
    the replicated run (gloo's 4-rank sums run in ring order).
(c) The reference's pjit ``Trainer`` on a 2-device data mesh
    (``tests/jax_pjit_reference.py``) at
    ``test_torch_distributed.py::test_mesh_trainer_tracks_reference``'s
    tolerances.
(d) During backward autograd returns no gradient of a split leaf: each
    layer's gradient is reduce-scattered as it is produced, and every
    gather and reduce-scatter sees one layer's slices (or the once leaves).
(e) ``microbatches=2`` within 1e-6 of the replicated run (the parts sum
    each microbatch over the ranks first); resume bitwise, and a
    checkpoint written by either layout restores in the other, bitwise.
(f) ``split_tree`` then ``gather_parts`` give every family's ``SMOKE``
    parameters back bitwise at 2 and 4 ranks, with no process group.
(g) What raises: the projected-space accumulator (item 5j), a mesh axis
    beside data and model (5d), a rank policy (5k), a spec of one dim over
    two axes (5d), and ``shard_params`` without a mesh (``ValueError``); a
    spec over two dims, one per axis, splits.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import Mesh, run_local_ranks
from repro_torch.models import build_model
from repro_torch.sharding import (
    RowSplit,
    Spec,
    gather_parts,
    param_shardings,
    row_splits,
    split_tree,
)
from torch_threads import _one_thread  # noqa: F401  (autouse)
from torch_dist_workers import ARCH, FSDP_OPTS, GUM

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SPLIT_CASES = list(FSDP_OPTS)
FAMILIES = ["zamba2-1.2b", "dbrx-132b", "llama4-maverick-400b-a17b",
            "llama-3.2-vision-11b", "hubert-xlarge"]
SCENARIOS_2 = ([f"fsdp:{c}:{m}" for c in SPLIT_CASES for m in ("replicated", "split")]
               + ["fsdp_mb:replicated", "fsdp_mb:split", "fsdp_backward",
                  "fsdp_resume:split>split", "fsdp_resume:replicated>split",
                  "fsdp_resume:split>replicated", "fsdp_cli_twin"]
               + [f"fsdp_family:{a}" for a in FAMILIES])
SCENARIOS_4 = ["fsdp:gum:replicated", "fsdp:gum:split", "fsdp:gum_zero:split"]
SPAWN_TIMEOUT = 240
STEPS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_smoke as j_get_smoke
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from test_torch_distributed import jax_sampler

    base = tmp_path_factory.mktemp("fsdp")
    jcfg = j_get_smoke(ARCH)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(jparams)).items()}
    samples = {((0, count, i), jcfg.n_layers, GUM["gamma"]):
               jax_sampler((0, count, i), jcfg.n_layers, GUM["gamma"])
               for count in (1, 4) for i in range(len(params))}
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 4, 32))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    reference = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "jax_pjit_reference.py"),
         str(base / "pjit.npz"), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        out = {}
        for n, names in ((2, SCENARIOS_2), (4, SCENARIOS_4)):
            inputs = {"dir": str(base / f"n{n}"), "params": params, "samples": samples,
                      "tokens": tokens, "scenarios": names}
            out[n] = run_local_ranks("torch_dist_workers:scenarios", n, args=(inputs,),
                                     workdir=str(base / f"ranks{n}"), extra_path=[TESTS],
                                     timeout=SPAWN_TIMEOUT)
        log, _ = reference.communicate(timeout=SPAWN_TIMEOUT)
        assert reference.returncode == 0, log.decode()[-4000:]
        out["pjit"] = dict(np.load(base / "pjit.npz"))
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()
    return out


def result(runs, n: int, name: str, rank: int = 0) -> dict:
    got = runs[n][rank][name]
    assert "error" not in got, got.get("error")
    return got


def params_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_is_the_replicated_run(runs, case):
    """(a) bitwise at 2 ranks; every rank holds ``per_shard_bytes``."""
    for rank in (0, 1):
        rep = result(runs, 2, f"fsdp:{case}:replicated", rank)
        got = result(runs, 2, f"fsdp:{case}:split", rank)
        assert len(got["losses"]) == STEPS
        assert got["losses"] == rep["losses"]
        assert params_equal(got["params"], rep["params"])
        assert got["held"] == got["rule"] < got["whole"], (got["held"], got["rule"])
        assert rep["held"] == rep["whole"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_collectives_are_the_model(runs, case):
    """(a) each step's collectives: a steady step's against the closed-form
    schedule with no finding, and every step the same calls."""
    got = result(runs, 2, f"fsdp:{case}:split")
    assert got["findings"] == []
    exp = got["expected"]
    want = {"all_gather:layer": exp["param_gather"]["count"],
            "all_gather:once": exp["param_gather_once"]["count"],
            "reduce_scatter:layer": exp["grad_scatter"]["count"],
            "reduce_scatter:once": exp["grad_scatter_once"]["count"],
            "all_reduce:grad": 1, "all_gather:grad": 1, "all_reduce:loss": 1}
    if FSDP_OPTS[case].get("shard_state"):
        want["all_gather:update"] = 1
    for counts in got["counts"]:
        assert counts == want
    if case != "mamba":  # llama-60m SMOKE: 2 layers; final_norm alone stays whole
        assert exp["param_gather"]["layers"] == 2 and exp["grad_psum"]["operands"] == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_splits(runs, arch):
    """(a) the other families, bitwise their replicated step at 2 ranks."""
    got = result(runs, 2, f"fsdp_family:{arch}")
    assert got["split"]["losses"] == got["replicated"]["losses"]
    assert params_equal(got["split"]["params"], got["replicated"]["params"])


def test_four_ranks(runs):
    """(b) ``shard_state`` on vs off bitwise on split parameters at 4 ranks,
    both within 1e-6 of the replicated run (the low-rank leaves by their
    largest element, AdamW's by Frobenius distance); the stacked norms stay
    whole."""
    from test_torch_distributed import params_close

    off, on = result(runs, 4, "fsdp:gum:split"), result(runs, 4, "fsdp:gum_zero:split")
    rep = result(runs, 4, "fsdp:gum:replicated")
    assert on["losses"] == off["losses"]
    assert params_equal(on["params"], off["params"])
    np.testing.assert_allclose(off["losses"], rep["losses"], rtol=1e-6, atol=0)
    params_close(off["params"], rep["params"], 1e-6, 1e-6)
    assert off["held"] == off["rule"]
    assert off["findings"] == [] and on["findings"] == []
    # (2, d) norms do not divide by 4: the once gather holds the embedding alone
    d = get_smoke(ARCH).d_model
    assert off["expected"]["param_gather_once"]["payload_bytes"] == \
        get_smoke(ARCH).vocab * d // 4 * 4


def test_tracks_the_pjit_reference(runs):
    """(c) the reference's pjit ``Trainer`` on a data mesh of 2 host
    devices, at the replicated mesh test's tolerances."""
    from test_torch_distributed import params_close

    got = result(runs, 2, "fsdp:gum:split")
    ref = runs["pjit"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5, atol=0)
    params_close(got["params"], {k: v for k, v in ref.items() if k != "losses"}, 1e-5, 1e-4)


def test_backward_holds_no_whole_stacked_gradient(runs):
    """(d) autograd hands back no gradient of a split leaf; the layer
    gathers and reduce-scatters see one layer's slices (no stack dim), the
    accumulator holds the parts."""
    got = result(runs, 2, "fsdp_backward")
    whole, parts = got["whole"], got["parts"]
    for k, shape in got["returned"].items():
        if parts[k] != whole[k]:
            assert shape is None, k
        else:
            assert shape == whole[k], k
    assert got["acc"] == {k: parts[k] for k in got["acc"]}
    assert set(got["acc"]) == {k for k in whole if parts[k] != whole[k]}
    layer = got["layer"]
    assert layer and all(k.startswith("blocks/") for k in layer)
    kinds = [(op, kind) for op, kind, _, _ in got["log"]]
    L = get_smoke(ARCH).n_layers
    assert kinds.count(("all_gather", "layer")) == kinds.count(("reduce_scatter", "layer")) == L
    assert kinds.count(("all_gather", "once")) == kinds.count(("reduce_scatter", "once")) == 1
    for op, kind, l, shapes in got["log"]:
        if kind == "layer":
            # one layer's slices: the stack dim is gone, the split dim halved
            assert len(shapes) == len(layer)
            assert all(len(s) == len(whole[k]) - 1 for s, k in zip(shapes, sorted(layer)))
            total = sum(int(np.prod(s)) for s in shapes)
            per_layer = sum(int(np.prod(whole[k][1:])) for k in layer)
            assert total == (per_layer // 2 if op == "all_gather" else per_layer)


def test_microbatches(runs):
    """(e) two microbatches a rank: the parts are summed over the ranks per
    microbatch, then over the microbatches, so within 1e-6, not bitwise."""
    from test_torch_distributed import params_close

    rep, got = result(runs, 2, "fsdp_mb:replicated"), result(runs, 2, "fsdp_mb:split")
    np.testing.assert_allclose(got["losses"], rep["losses"], rtol=1e-6, atol=0)
    # the low-rank leaves by their largest element, AdamW's by Frobenius
    # distance (its first steps divide by |g|), as test_torch_distributed.py
    params_close(got["params"], rep["params"], 1e-6, 1e-6)
    assert got["findings"] == []


@pytest.mark.parametrize("path", ["split>split", "replicated>split", "split>replicated"])
def test_resume_across_layouts(runs, path):
    """(e) 2 steps and a checkpoint in one layout, 2 more in the other (or
    the same): bitwise the uninterrupted run (the checkpoint holds whole
    arrays either way)."""
    got = result(runs, 2, f"fsdp_resume:{path}")
    want = result(runs, 2, "fsdp:gum_zero:split")
    assert got["resumed_from"] == 2
    assert got["losses"] == want["losses"][2:]
    assert params_equal(got["params"], want["params"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["llama-60m", "mamba2-370m"] + FAMILIES)
def test_split_then_gather_every_family(arch, n):
    """(f) each rank's parts by hand-built ``RowSplit``s, then the wholes
    from their concatenation in rank order, bitwise."""
    model = build_model(get_smoke(arch), device="cpu")
    model.init_params(0)
    params = {k: p.detach() for k, p in model.params().items()}
    specs = param_shardings(params, Mesh((n,), ("data",)))
    dims = {k: [d for d, a in enumerate(s) if a is not None] for k, s in specs.items()}
    split = [k for k, d in dims.items() if d]
    assert split

    class Gathered(Mesh):
        """A mesh whose all-gather returns every rank's parts, made here."""

        def __init__(self, k):
            super().__init__((n,), ("data",))
            self.k = k

        def coordinate(self, axis):
            return self.k

        def all_gather(self, t, tag):
            ranks = []
            for r in range(n):
                rules = {k: RowSplit(r, n, dims[k][0]) for k in split}
                ranks.append(torch.cat([rules[k].apply(params[k]).reshape(-1)
                                        for k in split]))
            assert torch.equal(ranks[self.k], t)
            return torch.cat(ranks)

    for k in range(n):
        mesh = Gathered(k)
        parts = split_tree(params, specs, mesh)
        for key in params:
            if key in split:
                assert parts[key].shape[dims[key][0]] * n == params[key].shape[dims[key][0]]
            else:
                assert parts[key] is params[key]
        wholes = gather_parts(mesh, [parts[key] for key in split],
                              [dims[key][0] for key in split], "test")
        for key, w in zip(split, wholes):
            assert w.dtype == params[key].dtype and torch.equal(w, params[key]), key


def test_what_raises(tmp_path):
    """(g) the refusals, each naming its ROADMAP item, and no mesh."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import OptimizerConfig, gum_accum_tools
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import Trainer

    cfg = get_smoke(ARCH)
    run = RunConfig(steps=1, log_every=0, ckpt_dir=str(tmp_path))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def trainer(opt=OptimizerConfig(**GUM), **kw):
        return Trainer(build_model(cfg, device="cpu"), opt, run, data, device="cpu",
                       shard_params=True, **kw)

    with pytest.raises(ValueError, match="give mesh="):
        trainer()
    with pytest.raises(NotImplementedError, match="item 5d"):
        trainer(mesh=Mesh((2, 2, 2), ("pod", "data", "model")))
    with pytest.raises(NotImplementedError, match="item 5k"):
        trainer(opt=OptimizerConfig(**GUM, rank_policy="stepwise:0=4"),
                mesh=Mesh((2,), ("data",)))
    tools = gum_accum_tools(1e-3, rank=4, gamma=1, period=3)
    with pytest.raises(NotImplementedError, match="item 5j"):
        make_train_step(build_model(cfg, device="cpu"), tools.transform, microbatches=2,
                        lowrank_accum=tools, mesh=Mesh((2,), ("data",)),
                        param_split=object())
    class Placed(Mesh):  # a (2, 2) mesh at rank 3 (coordinates 1, 1)
        def coordinate(self, axis):
            return 1

    rule = row_splits({"w": Spec(("data", "model"))}, Placed((2, 2), ("data", "model")))["w"]
    assert [(c.index, c.count, c.dim) for c in rule.cuts] == [(1, 2, 0), (1, 2, 1)]
    w = torch.arange(16.0).reshape(4, 4)
    assert torch.equal(rule.apply(w), w[2:, 2:])
    with pytest.raises(NotImplementedError, match="item 5d"):
        row_splits({"w": Spec((("pod", "data"), None))}, Mesh((2, 2), ("pod", "data")))


def test_cli_under_torchrun(runs, tmp_path):
    """``--shard-params`` at 2 gloo ranks, with ``--audit``: the sharded
    audit of the split step is clean, and the run log's losses are the
    ``Trainer`` run's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", ARCH, "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
           "--rank", "4", "--gamma", "1", "--period", "3", "--ckpt-dir", str(tmp_path),
           "--mesh", "data=2", "--shard-params", "--audit", "--telemetry", "every=1,stdout=0"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "audit sharded:gum@data=2+fsdp: clean" in out.stdout, out.stdout
    assert len([line for line in out.stdout.splitlines()
                if line.startswith("done: step=4")]) == 1
    with open(tmp_path / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e.get("name") == "loss"]
    assert losses == result(runs, 2, "fsdp_cli_twin")["losses"]
