"""The fused back-projection epilogue and the family plan against the JAX
package: the plain version against the Pallas kernel in interpret mode, the
dispatcher on both sides and on a ragged shape against the JAX dispatcher
at ``impl="interpret"``, ``PendingBack`` grouping, and the family plan's
geometry against the reference's on the llama-60m smoke and llama-130m
trees.

Inputs are normals made with numpy from a seed; projectors are scaled by
1/sqrt(m), as orthonormal columns are.  Tolerance: max |port − reference| /
max |reference| ≤ 1e-5, one fp32 GEMM summed in another order.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.api import tree_paths as j_tree_paths
from repro.core.family_plan import build_family_plan as j_build_family_plan
from repro.core.family_plan import plan_stats as j_plan_stats
from repro.kernels import dispatch as jdispatch
from repro.kernels.fused_step import back_project_epilogue_batched as j_epilogue_batched
from repro.models import build_model as j_build_model
from repro_torch.core import apply_updates
from repro_torch.core.combinators import PendingBack, materialize_pending
from repro_torch.core.family_plan import (
    build_family_plan,
    plan_stats,
    stack_family,
    unstack_family,
)
from repro_torch.core.lowrank_common import default_lowrank_filter, family_shape
from repro_torch.kernels import dispatch, launch_count, ref
from repro_torch.kernels.fused_step import back_project_epilogue_batched
from torch_threads import _one_thread  # noqa: F401  (autouse)


RTOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _proj(seed, *shape):
    return _rand(seed, *shape) / np.float32(np.sqrt(shape[-2]))


def _close(port: torch.Tensor, want):
    want = np.asarray(want)
    assert port.shape == want.shape
    err = np.abs(port.numpy() - want).max() / np.abs(want).max()
    assert err <= RTOL, f"relative error {err:.2e} > {RTOL}"


@pytest.mark.parametrize("with_w", [False, True], ids=["no-w", "w"])
def test_epilogue_plain_matches_pallas(with_w):
    p, s, w = _proj(0, 2, 64, 16), _rand(1, 2, 16, 128), _rand(2, 2, 64, 128)
    sd = jnp.asarray([[-0.0025, -1e-4]], jnp.float32)
    want = j_epilogue_batched(jnp.asarray(p), jnp.asarray(s),
                              jnp.asarray(w) if with_w else None, sd,
                              block_m=32, block_n=64, interpret=True)
    args = [torch.from_numpy(a) for a in (p, s)] + [torch.from_numpy(w) if with_w else None]
    _close(ref.back_project_epilogue_ref(*args, -0.0025, -1e-4), want)
    _close(back_project_epilogue_batched(*args, -0.0025, -1e-4), want)


# (lead, m, n, r): left, right, and ragged shapes (not multiples of the
# Pallas tiles; the JAX dispatcher pads, the port's kernel masks)
SHAPES = [((2,), 64, 128, 16), ((2,), 128, 64, 16), ((1,), 40, 172, 12),
          ((1,), 172, 40, 12), ((2, 3), 24, 48, 8)]


@pytest.mark.parametrize("with_w", [False, True], ids=["no-w", "w"])
@pytest.mark.parametrize("lead,m,n,r", SHAPES)
def test_dispatch_epilogue_matches_pallas(lead, m, n, r, with_w):
    side = "left" if m <= n else "right"
    p = _proj(10, *lead, m if side == "left" else n, r)
    s = _rand(11, *lead, *((r, n) if side == "left" else (m, r)))
    w = _rand(12, *lead, m, n) if with_w else None
    want = jdispatch.back_project_epilogue(
        jnp.asarray(p), jnp.asarray(s), w=None if w is None else jnp.asarray(w),
        scale=-0.5, decay=-0.01, side=side, impl="interpret")
    with launch_count.count_launches() as counts:
        got = dispatch.back_project_epilogue(
            torch.from_numpy(p), torch.from_numpy(s),
            w=None if w is None else torch.from_numpy(w),
            scale=-0.5, decay=-0.01, side=side)
    assert counts == {"back_project_epilogue": 1}
    _close(got, want)


def test_pending_back_groups_members_into_one_launch():
    """Three members of one stack, scaled and decayed as a chain tail does,
    materialize in one dispatch and equal the per-leaf arithmetic."""
    p, s = torch.from_numpy(_proj(20, 6, 32, 4)), torch.from_numpy(_rand(21, 6, 4, 48))
    w = torch.from_numpy(_rand(22, 6, 32, 48))
    fs = family_shape(w, 4)
    leaves = {f"m{j}": PendingBack(p, s, lambda: w, fs, "auto", member=j, members=3,
                                   member_lead=(2,)).decayed(0.1).scaled(-0.01)
              for j in range(3)}
    with launch_count.count_launches() as counts:
        out = materialize_pending(leaves)
    assert counts == {"back_project_epilogue": 1}
    full = -0.01 * (p @ s) - 0.001 * w
    for j in range(3):
        torch.testing.assert_close(out[f"m{j}"], full[2 * j:2 * j + 2], rtol=1e-6, atol=0)
        torch.testing.assert_close(leaves[f"m{j}"].materialize_update(), out[f"m{j}"])
    # a chain that ends without scale_by_lr: apply_updates materializes
    params = {f"m{j}": w[2 * j:2 * j + 2] for j in range(3)}
    for k, p_new in apply_updates(params, leaves).items():
        torch.testing.assert_close(p_new, params[k] + out[k])


@pytest.mark.parametrize("name,getter", [("llama-60m", j_get_smoke),
                                         ("llama-130m", j_get_config)],
                         ids=["llama-60m-smoke", "llama-130m"])
def test_plan_stats_match_reference(name, getter):
    """The plan over the routed (low-rank) leaves, from the reference's own
    parameter shapes: equal stats, and stacking round-trips."""
    rank = 4 if name == "llama-60m" else 256
    shapes = jax.eval_shape(j_build_model(getter(name)).init, jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_leaves(j_tree_paths(shapes))
    jleaves = jax.tree_util.tree_leaves(shapes)
    routed = [default_lowrank_filter(pa, torch.empty(x.shape, device="meta"))
              for pa, x in zip(paths, jleaves)]
    jmasked = [x if keep else None for x, keep in zip(jleaves, routed)]
    leaves = [torch.empty(x.shape, device="meta") if keep else None
              for x, keep in zip(jleaves, routed)]
    plan = build_family_plan(leaves, rank)
    assert plan_stats(plan) == j_plan_stats(j_build_family_plan(jmasked, rank))

    small = [None if x is None else torch.randn(x.shape[:-2] + (3, 5)) for x in leaves]
    for fam in plan.families:
        stacked = stack_family(fam, small)
        assert stacked.shape == (fam.fs.L, 3, 5)
        for i, part in zip(fam.members, unstack_family(fam, stacked)):
            assert torch.equal(part, small[i])
