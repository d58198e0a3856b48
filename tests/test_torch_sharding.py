"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding``, in process and without ranks: every decision
is a function of paths and shapes, so both packages see the same parameter
and optimizer-state trees — the port's on the meta device, the reference's
through ``jax.eval_shape`` — and the same meshes (``AbstractMesh`` on the
reference's side, a process-free :class:`repro_torch.launch.mesh.Mesh` on
the port's).

Held: ``spec_for_param`` for every arch's ``SMOKE`` parameter paths and for
llama-130m at full width; ``resolve_spec`` / ``validate_spec`` and
``per_shard_bytes`` on data=2, 4, 8, (data=16, model=16) and (pod=2,
data=16, model=16); ``family_state_sharding`` leaf by leaf and
``family_state_bytes`` for the family-stacked GUM state of llama-130m
(rank 256, gamma 4) and llama-60m ``SMOKE``.  The state bytes differ by
exactly two dtypes the packages store differently: the reference's step
counter is an int32 array (4 bytes) where the port keeps a Python int, and
its slot indices are int32 where the port's are int64.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsharding
from repro.checkpoint.manager import _leaf_paths
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as j_build_optimizer
from repro.models import build_model as j_build_model
from repro_torch import sharding
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core import OptimizerConfig, build_optimizer
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from torch_threads import _one_thread  # noqa: F401  (autouse)

MESHES = {"data2": ((2,), ("data",)), "data4": ((4,), ("data",)),
          "data8": ((8,), ("data",)), "pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
GUM = dict(name="gum", rank=256, gamma=4, period=3, fuse_families=True)


def meshes(key: str):
    shape, axes = MESHES[key]
    return Mesh(shape, axes), AbstractMesh(shape, axes)


def port_params(cfg) -> dict:
    return build_model(cfg, device="meta").params()


def ref_params(cfg) -> dict:
    model = j_build_model(cfg)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return tree, dict(zip(_leaf_paths(tree), jax.tree_util.tree_leaves(tree)))


def both(arch: str, smoke: bool):
    get, j_get = (get_smoke, j_get_smoke) if smoke else (get_config, j_get_config)
    ours = port_params(get(arch))
    tree, theirs = ref_params(j_get(arch))
    assert list(ours) == list(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == tuple(theirs[k].shape), k
    return ours, tree, theirs


CASES = [(a, True) for a in ARCHS] + [("llama-130m", False)]


@pytest.mark.parametrize("arch,smoke", CASES, ids=lambda v: str(v))
def test_spec_for_param_matches_reference(arch, smoke):
    ours, _, theirs = both(arch, smoke)
    assert sharding.param_specs(ours) == {k: jsharding.spec_for_param(k, p)
                                          for k, p in theirs.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,smoke", [("llama-60m", True), ("dbrx-132b", True),
                                        ("mamba2-370m", True), ("llama-130m", False)],
                         ids=lambda v: str(v))
def test_resolved_specs_and_shard_bytes_match_reference(arch, smoke, mesh):
    ours, tree, theirs = both(arch, smoke)
    pmesh, jmesh = meshes(mesh)
    for k, p in ours.items():
        logical = sharding.spec_for_param(k, p)
        got = sharding.validate_spec(p.shape, sharding.resolve_spec(logical, pmesh), pmesh)
        want = jsharding.validate_spec(theirs[k].shape,
                                       jsharding.resolve_spec(logical, jmesh), jmesh)
        assert tuple(got) == tuple(want), k
        assert tuple(sharding.resolve_spec(logical, pmesh)) == \
            tuple(jsharding.resolve_spec(logical, jmesh)), k
    assert sharding.param_shardings(ours, pmesh) == {
        k: tuple(s.spec) + (None,) * (theirs[k].ndim - len(s.spec))
        for k, s in zip(theirs, jax.tree_util.tree_leaves(
            jsharding.named_sharding_tree(tree, jmesh)))}
    assert sharding.per_shard_bytes(ours, pmesh) == jsharding.per_shard_bytes(tree, jmesh)


def gum_states(arch: str, smoke: bool, **over):
    get, j_get = (get_smoke, j_get_smoke) if smoke else (get_config, j_get_config)
    cfg = dict(GUM, **over)
    ours = build_optimizer(OptimizerConfig(**cfg)).init(port_params(get(arch)))
    jtree, _ = ref_params(j_get(arch))
    theirs = jax.eval_shape(j_build_optimizer(JOptimizerConfig(**cfg)).init, jtree)
    return ours, theirs


def _byte_gap(ours) -> int:
    """Reference bytes minus the port's for the family-stacked state: +4 for
    each Python-int counter (an int32 array there), -4 per slot index (int32
    there, int64 here)."""
    from repro_torch.core import find_lowrank_states
    from repro_torch.core.combinators import is_family_state

    gap = 0
    for st in find_lowrank_states(ours):
        if not is_family_state(st):
            continue
        for path, x in flatten_with_paths(st):
            if not isinstance(x, torch.Tensor):
                gap += 4
            elif x.dtype == torch.int64:
                gap -= 4 * x.numel()
    return gap


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("arch,smoke,over", [("llama-130m", False, {}),
                                             ("llama-60m", True, dict(rank=4, gamma=1))],
                         ids=lambda v: str(v) if not isinstance(v, dict) else "")
def test_family_state_split_matches_reference(arch, smoke, over, n):
    ours, theirs = gum_states(arch, smoke, **over)
    pmesh, jmesh = Mesh((n,), ("data",)), AbstractMesh((n,), ("data",))
    specs = []
    sharding.zip_map(lambda x, spec: specs.append(spec) if x is not None else None, ours,
                     sharding.family_state_sharding(ours, pmesh))
    ours_flat = dict(flatten_with_paths(ours))
    got = dict(zip(ours_flat, specs))
    want = dict(zip(_leaf_paths(theirs), jax.tree_util.tree_leaves(
        jsharding.family_state_sharding(theirs, jmesh))))
    theirs_flat = dict(zip(_leaf_paths(theirs), jax.tree_util.tree_leaves(theirs)))
    assert sorted(ours_flat) == sorted(theirs_flat)
    split = 0
    for path, x in ours_flat.items():
        if isinstance(x, torch.Tensor):
            assert tuple(x.shape) == tuple(theirs_flat[path].shape), path
            assert tuple(got[path]) == tuple(want[path].spec), path
            split += bool(got[path])
        else:  # a step counter: a Python int here, a replicated scalar there
            assert tuple(want[path].spec) == (), path
    jt, jp = jsharding.family_state_bytes(theirs, n)
    t, p = sharding.family_state_bytes(ours, n)
    gap = _byte_gap(ours)
    assert (t + gap, p + gap) == (jt, jp)
    assert (p < t) == (split > 0)
    assert split > 0 or n == 16  # llama-60m SMOKE's stacks (8, 4, 2) divide no 16
    # opt_state_sharding: the parameter rules on full-shape state leaves, the
    # family rule on the stacked ones (family_axis)
    for family_axis in (None, "data"):
        specs = []
        sharding.zip_map(lambda x, spec: specs.append(spec) if x is not None else None, ours,
                         sharding.opt_state_sharding(ours, pmesh, family_axis=family_axis))
        got = dict(zip(ours_flat, specs))
        want = dict(zip(_leaf_paths(theirs), jax.tree_util.tree_leaves(
            jsharding.opt_state_sharding(theirs, jmesh, family_axis=family_axis))))
        for path, x in ours_flat.items():
            if isinstance(x, torch.Tensor):
                w = tuple(want[path].spec)
                assert tuple(got[path]) == w + (None,) * (len(got[path]) - len(w)), path


def test_meshes_raise_on_a_smaller_world():
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_debug_mesh()
    with sharding.use_mesh(Mesh((2, 16, 16), ("pod", "data", "model"))):
        assert (sharding.logical_axis_size("fsdp"), sharding.logical_axis_size("tp"),
                sharding.logical_axis_size("ep")) == (32, 16, 16)
    assert sharding.logical_axis_size("fsdp") == 1


def test_row_splits_and_shard_are_the_ported_subset():
    mesh = Mesh((2, 1), ("data", "model"))
    specs = {"a": sharding.Spec(("data",)), "b": sharding.Spec(), "c": None}
    with pytest.raises(RuntimeError, match="no process group"):
        sharding.row_splits(specs, mesh)   # a shape-only mesh has no coordinate
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(sharding.RowSplit(1, 2).apply(x), x[2:])
    with sharding.use_mesh(mesh):
        assert sharding.shard(x, "fsdp", None) is x
    with sharding.use_mesh(Mesh((2, 2), ("data", "model"))):
        # the port's tensor-parallel layers place their work themselves
        assert sharding.shard(x, "fsdp", "tp") is x


def test_trainer_refuses_a_model_axis(tmp_path):
    """The Trainer runs data meshes (its parameters replicated, or split
    over the data axis with ``shard_params``) and, for the dense family, a
    model axis (tensor parallelism); a model axis larger than 1 under the
    ssm family raises, naming its ROADMAP item."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer

    cfg = get_smoke("mamba2-370m")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5m"):
        Trainer(build_model(cfg, device="cpu"), OptimizerConfig(name="gum", rank=4),
                RunConfig(steps=1, ckpt_dir=str(tmp_path)),
                DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
                device="cpu", mesh=Mesh((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="shard_state needs a mesh"):
        Trainer(build_model(cfg, device="cpu"),
                OptimizerConfig(name="gum", rank=4, fuse_families=True, shard_state=True),
                RunConfig(steps=1, ckpt_dir=str(tmp_path)),
                DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2), device="cpu")
