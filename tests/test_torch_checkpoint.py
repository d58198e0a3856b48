"""The port's ``CheckpointManager`` against the JAX package's contract
(``tests/test_checkpoint_data.py``, ``tests/test_resilience.py``): round
trips of real optimizer states (Python-int counters, ``None`` leaves, bool
masks, int64 slot ids, per-leaf and family-stacked projectors), keep-N GC,
``.tmp`` directories never counted, a flipped bit and a truncated file
raising :class:`CheckpointCorruptionError` with the verified fallback, GC
that never deletes the newest verified step, an aborted save leaving
nothing committed, ``extra`` and a leaf without a CRC, the
fused-vs-per-leaf layout error, and checkpoints of either package
restoring in the other to the same bytes.  Corruption is made by the
reference's own ``repro.resilience.inject`` helpers."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.resilience.inject import bitflip_checkpoint, truncate_checkpoint
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import OptimizerConfig, build_optimizer
from torch_threads import _one_thread  # noqa: F401  (autouse)


def _tree(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(16, 16, generator=gen),
            "b": {"c": torch.arange(32, dtype=torch.float32) + seed},
            "count": seed, "none": None, "mask": torch.arange(4) % 2 == seed % 2}


def _same(a, b) -> bool:
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if type(x) is not type(y):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _smoke_params() -> dict:
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.device_get(jparams))


STATES = {
    "gum": dict(name="gum", rank=4, gamma=1, period=2),
    "gum fused": dict(name="gum", rank=4, gamma=1, period=2, fuse_families=True),
    "galore fused epilogue": dict(name="galore", rank=4, period=2, fuse_families=True,
                                  fused_epilogue=True),
    "lisa": dict(name="lisa", gamma=1, period=2),
    "unbiased_galore_adam": dict(name="unbiased_galore_adam", rank=4, gamma=1, period=2),
}


@pytest.mark.parametrize("label", list(STATES))
def test_optimizer_state_round_trip(tmp_path, label):
    """Two steps of each optimizer, then (params, state) through a save
    and a restore into ``opt.init(params)``: every leaf equal, of the same
    type and dtype — counters come back as Python ints, masks as bool."""
    params = _smoke_params()
    opt = build_optimizer(OptimizerConfig(lr=1e-2, **STATES[label]))
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        _, state = opt.update(grads, state, params)
    leaves = [x for _, x in flatten_with_paths(state)]
    assert any(type(x) is int for x in leaves)
    if label == "lisa":
        assert any(isinstance(x, torch.Tensor) and x.dtype == torch.bool for x in leaves)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, (params, state))
    (p2, s2), extra = mgr.restore(2, (params, opt.init(params)))
    assert extra == {}
    assert _same((params, state), (p2, s2))


def test_round_trip_of_a_mixed_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, _tree(1), extra={"note": "x"})
    restored, extra = mgr.restore(7, _tree(0))
    assert _same(restored, _tree(1)) and extra == {"note": "x"}
    manifest = json.load(open(os.path.join(mgr._step_dir(7), "manifest.json")))
    assert [m["path"] for m in manifest["leaves"]] == ["a", "b/c", "count", "mask"]
    assert manifest["leaves"][0]["shards"] == ["arr_00000.shard0.npy"]
    assert {"id", "path", "shape", "dtype", "shards", "crc32"} <= set(manifest["leaves"][0])


def test_keep_n_gc_and_latest_ignores_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    step, restored, _ = mgr.restore_latest(_tree(0))
    assert step == 4 and _same(restored, _tree(4))
    os.makedirs(str(tmp_path / "step_000000005.tmp"))  # a crashed writer
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("fault", ["bitflip", "truncate"])
def test_corruption_raises_and_resume_falls_back(tmp_path, fault):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=5)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    assert mgr.verify_step(2)
    if fault == "bitflip":
        bitflip_checkpoint(d, 2, rng=np.random.default_rng(0), leaves=("a",))
    else:
        truncate_checkpoint(d, 2, rng=np.random.default_rng(1), keep_frac=0.4)
    assert not mgr.verify_step(2)
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(2, _tree(0))
    assert mgr.latest_step() == 2 and mgr.latest_verified_step() == 1
    step, restored, _ = mgr.restore_latest_verified(_tree(0))
    assert step == 1 and _same(restored, _tree(1))


def test_gc_never_deletes_newest_verified(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=0)  # no gc while the stage is set
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    for s in (2, 3, 4):
        bitflip_checkpoint(d, s, rng=np.random.default_rng(s), leaves=("a",))
    mgr.keep = 2
    mgr._gc()
    # steps 1 and 2 were doomed, but 1 is the newest verified: protected
    assert 1 in mgr.all_steps() and 2 not in mgr.all_steps()
    assert mgr.latest_verified_step() == 1
    assert mgr.restore_latest_verified(_tree(0))[0] == 1


def test_observer_abort_leaves_nothing_committed(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=3)
    mgr.save(1, _tree(1))
    calls = []

    def bomb(i, total):
        calls.append((i, total))
        if i >= 1:
            raise RuntimeError("simulated preemption")

    with pytest.raises(RuntimeError):
        mgr.save(2, _tree(2), observer=bomb)
    assert calls == [(0, 4), (1, 4)]
    assert mgr.all_steps() == [1] and mgr.latest_verified_step() == 1
    mgr.save(3, _tree(3))  # the stale tmp dir is cleaned up
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_extra_rides_and_a_leaf_without_crc_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1), extra={"rank_policy": {"map": "x"}})
    assert mgr.read_extra(1) == {"rank_policy": {"map": "x"}}
    mpath = os.path.join(mgr._step_dir(1), "manifest.json")
    man = json.load(open(mpath))
    for meta in man["leaves"]:
        meta.pop("crc32", None)
    json.dump(man, open(mpath, "w"))
    assert mgr.verify_step(1)
    tree, extra = mgr.restore(1, _tree(0))
    assert _same(tree, _tree(1)) and extra["rank_policy"]["map"] == "x"


def test_fused_and_per_leaf_layouts_do_not_cross(tmp_path):
    params = _smoke_params()
    kw = dict(name="gum", lr=1e-2, rank=4, gamma=1, period=2)
    per_leaf = build_optimizer(OptimizerConfig(**kw))
    fused = build_optimizer(OptimizerConfig(fuse_families=True, **kw))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, per_leaf.init(params)))
    with pytest.raises(ValueError, match="fuse_families"):
        mgr.restore(1, (params, fused.init(params)))


def test_shape_mismatch_names_the_leaf_and_the_rank_hint(tmp_path):
    params = _smoke_params()
    mgr = CheckpointManager(str(tmp_path))
    opt = build_optimizer(OptimizerConfig(name="gum", rank=4, gamma=1))
    mgr.save(1, opt.init(params))
    with pytest.raises(ValueError, match="projs/blocks/attn/wk: saved shape.*rank"):
        mgr.restore(1, build_optimizer(OptimizerConfig(name="gum", rank=8, gamma=1))
                    .init(params))


def test_multi_shard_leaves_concatenate_along_axis_0(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(1)
    mgr.save(1, tree)
    d = mgr._step_dir(1)
    mpath = os.path.join(d, "manifest.json")
    man = json.load(open(mpath))
    meta = man["leaves"][0]  # "a" (16, 16) -> two 8-row shards
    arr = np.load(os.path.join(d, meta["shards"][0]))
    for k, part in enumerate((arr[:8], arr[8:])):
        np.save(os.path.join(d, f"arr_00000.shard{k}.npy"), part)
    meta["shards"] = ["arr_00000.shard0.npy", "arr_00000.shard1.npy"]
    meta["crc32"] = [None, None]
    json.dump(man, open(mpath, "w"))
    restored, _ = mgr.restore(1, _tree(0))
    assert _same(restored, tree)


def test_unported_arguments_raise(tmp_path):
    # ported since: the telemetry bus (save and GC become checkpoint events)
    from repro_torch.telemetry import MemorySink, Telemetry

    ring = MemorySink()
    with_bus = CheckpointManager(str(tmp_path / "bus"), keep=1, telemetry=Telemetry([ring]))
    with_bus.save(1, _tree(1))
    with_bus.save(2, _tree(2))
    n = len(flatten_with_paths(_tree(1)))
    assert [(r["detail"].split(" (")[0], r["severity"], r["data"]) for r in ring.records
            if r["kind"] == "event"] == [
        ("checkpoint: saved step 1", "debug", {"action": "save", "leaves": n}),
        ("checkpoint: saved step 2", "debug", {"action": "save", "leaves": n}),
        ("checkpoint: gc step 1", "debug", {"action": "gc", "gc_step": 1})]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    # restore(shardings=): a leaf's rule keeps the whole leaf (None) or a
    # rank's rows of it (RowSplit); the template holds the whole shapes
    from repro_torch.sharding import RowSplit

    rules = {"a": RowSplit(1, 4), "b": {"c": RowSplit(0, 2)}, "count": None, "none": None,
             "mask": None}
    split, _ = mgr.restore(1, _tree(0), shardings=rules)
    whole, _ = mgr.restore(1, _tree(0))
    assert torch.equal(split["a"], whole["a"][4:8]) and split["a"].shape == (4, 16)
    assert torch.equal(split["b"]["c"], whole["b"]["c"][:16])
    assert split["count"] == 1 and torch.equal(split["mask"], whole["mask"])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A params checkpoint written by ``repro.checkpoint`` verifies and
    restores in the port to the same bytes; the port's CRCs agree."""
    jparams = j_build_model(j_get_smoke("llama-60m")).init(jax.random.PRNGKey(3))
    JCheckpointManager(str(tmp_path)).save(5, jparams, extra={"from": "jax"})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_verified_step() == 5
    like = {k: torch.zeros_like(v) for k, v in _smoke_params().items()}
    restored, extra = mgr.restore(5, like)
    assert extra == {"from": "jax"}
    want = params_from_jax(jax.device_get(jparams))
    assert list(restored) == list(want)
    for k in want:
        assert restored[k].numpy().tobytes() == want[k].numpy().tobytes(), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = {k: v + 1.0 for k, v in _smoke_params().items()}
    CheckpointManager(str(tmp_path)).save(4, params)
    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.latest_verified_step() == 4
    jlike = jax.tree_util.tree_map(jnp.zeros_like, params_to_numpy(params))
    restored, _ = jmgr.restore(4, jlike)
    flat = params_from_jax(jax.device_get(restored))
    for k, v in params.items():
        assert flat[k].numpy().tobytes() == v.numpy().tobytes(), k
