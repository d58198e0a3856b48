"""The port's kernel plain versions and dispatch layer against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

Inputs are normals made with numpy from a seed and fed to both packages;
projectors are scaled by 1/sqrt(m), as orthonormal columns are, so every
output is of unit scale.  Tolerance: atol 1e-5 for one fp32 GEMM at these
sizes (the two sides sum in another order); 1e-4 for a 5-step
Newton–Schulz, which compounds ten GEMMs through a cubic polynomial.  The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.lowrank_update import (
    back_project_batched as j_back_project_batched,
    lowrank_update_batched as j_lowrank_update_batched,
    project_batched as j_project_batched,
)
from repro.kernels.newton_schulz import gram as j_gram
from repro.kernels.newton_schulz import poly_matmul_axpy as j_poly_matmul_axpy
from repro.kernels.newton_schulz import newton_schulz_pallas
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.lowrank_update import (
    back_project_batched,
    lowrank_update_batched,
    project_batched,
)
from repro_torch.kernels.newton_schulz import (
    gram,
    newton_schulz_cuda,
    ns_iteration,
    poly_matmul_axpy,
)
from torch_threads import _one_thread  # noqa: F401  (autouse)


ATOL = 1e-5
ATOL_NS = 1e-4


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _proj(seed, *shape):
    """A projector-scaled (..., m, r) operand: entries ~ 1/sqrt(m)."""
    return _rand(seed, *shape) / np.float32(np.sqrt(shape[-2]))


def _close(port: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------- raw kernels (L, ...)


def test_lowrank_update_batched_matches_pallas():
    p, g, r = _proj(0, 2, 64, 16), _rand(1, 2, 64, 128), _rand(2, 2, 16, 128)
    want = j_lowrank_update_batched(jnp.asarray(p), jnp.asarray(g), jnp.asarray(r),
                                    0.9, 1.5, block_m=32, block_n=64, interpret=True)
    got = lowrank_update_batched(torch.from_numpy(p), torch.from_numpy(g),
                                 torch.from_numpy(r), 0.9, 1.5)
    _close(got, want)


def test_project_batched_matches_pallas():
    p, g = _proj(3, 2, 64, 16), _rand(4, 2, 64, 128)
    want = j_project_batched(jnp.asarray(p), jnp.asarray(g), 2.0,
                             block_m=32, block_n=64, interpret=True)
    _close(project_batched(torch.from_numpy(p), torch.from_numpy(g), 2.0), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_lowrank_update_batched_both_sides_match_dispatch(side):
    """The wrapper's own layouts on both sides (the CUDA kernel takes the
    right side natively: p (L, n, r), g (L, m, n), R (L, m, r)), through its
    CPU route, against the JAX package's dispatch in interpret mode."""
    L, m, n, r = 2, 40, 72, 12
    if side == "right":
        m, n = n, m
    p = _proj(20, L, m if side == "left" else n, r)
    g = _rand(21, L, m, n)
    st = _rand(22, L, *((r, n) if side == "left" else (m, r)))
    got = lowrank_update_batched(torch.from_numpy(p), torch.from_numpy(g),
                                 torch.from_numpy(st), 0.9, 1.5, side=side)
    want = jdispatch.lowrank_update(jnp.asarray(p), jnp.asarray(g), jnp.asarray(st), 0.9, 1.5,
                                    side=side, impl="interpret")
    _close(got, want)
    got = project_batched(torch.from_numpy(p), torch.from_numpy(g), 1.0, side=side)
    _close(got, jdispatch.project(jnp.asarray(p), jnp.asarray(g), side=side, impl="interpret"))


def test_back_project_batched_matches_pallas():
    p, s = _proj(5, 2, 64, 16), _rand(6, 2, 16, 128)
    want = j_back_project_batched(jnp.asarray(p), jnp.asarray(s),
                                  block_m=32, block_n=64, interpret=True)
    _close(back_project_batched(torch.from_numpy(p), torch.from_numpy(s)), want)


def test_back_project_batched_right_side_matches_pallas():
    """The right side, S Pᵀ with p (L, n, r), s (L, m, r), against the
    reference's right side as its dispatcher forms it: S swapped, the
    left-side kernel (P Sᵀ, (L, n, m)), the output swapped back.  The port
    returns (L, m, n) contiguous."""
    p, s = _proj(5, 2, 64, 16), _rand(6, 2, 128, 16)
    want = j_back_project_batched(jnp.asarray(p), jnp.swapaxes(jnp.asarray(s), -1, -2),
                                  block_m=32, block_n=64, interpret=True)
    got = back_project_batched(torch.from_numpy(p), torch.from_numpy(s), side="right")
    assert got.shape == (2, 128, 64) and got.is_contiguous()
    _close(got, jnp.swapaxes(want, -1, -2))


def test_gram_and_poly_apply_match_pallas():
    x = _rand(7, 2, 16, 128) / 8
    g_want = j_gram(jnp.asarray(x), block_n=32, interpret=True)
    g_got = gram(torch.from_numpy(x))
    _close(g_got, g_want)
    a2 = (-4.7750 * g_got + 2.0315 * (g_got @ g_got)).numpy()
    y_want = j_poly_matmul_axpy(jnp.asarray(a2), jnp.asarray(x), 3.4445,
                                block_n=32, interpret=True)
    _close(poly_matmul_axpy(torch.from_numpy(a2), torch.from_numpy(x), 3.4445), y_want)


def test_ns_iteration_and_newton_schulz_match_pallas():
    x = _rand(8, 2, 16, 128)
    want = newton_schulz_pallas(jnp.asarray(x), block_n=64, interpret=True)
    _close(newton_schulz_cuda(torch.from_numpy(x)), want, ATOL_NS)
    xn = x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    _close(ns_iteration(torch.from_numpy(xn)),
           ref.ns_iteration_ref(torch.from_numpy(xn), 3.4445, -4.7750, 2.0315))


# ------------------------------------------------------------ dispatch layer

# (lead, m, n, r): left, right, and ragged shapes (llama-60m's d_ff=1376 is
# not a multiple of 128; r=96 is not a multiple of 8)
SHAPES = [((2,), 64, 128, 16), ((2,), 128, 64, 16), ((1,), 40, 172, 12),
          ((1,), 172, 40, 12), ((2, 3), 24, 48, 8)]


@pytest.mark.parametrize("lead,m,n,r", SHAPES)
def test_dispatch_lowrank_ops_match_pallas(lead, m, n, r):
    side = "left" if m <= n else "right"
    s_dim = m if side == "left" else n
    p = _proj(10, *lead, s_dim, r)
    g = _rand(11, *lead, m, n)
    st = _rand(12, *lead, *((r, n) if side == "left" else (m, r)))
    tp, tg, ts = (torch.from_numpy(a) for a in (p, g, st))
    jp, jg, js = (jnp.asarray(a) for a in (p, g, st))
    _close(dispatch.lowrank_update(tp, tg, ts, 0.95, 2.0, side=side),
           jdispatch.lowrank_update(jp, jg, js, 0.95, 2.0, side=side, impl="interpret"))
    _close(dispatch.project(tp, tg, side=side),
           jdispatch.project(jp, jg, side=side, impl="interpret"))
    _close(dispatch.back_project(tp, ts, side=side),
           jdispatch.back_project(jp, js, side=side, impl="interpret"))


@pytest.mark.parametrize("shape", [(2, 16, 128), (2, 128, 16), (1, 40, 172), (24, 24)])
def test_dispatch_newton_schulz_matches_pallas(shape):
    x = _rand(13, *shape)
    _close(dispatch.newton_schulz(torch.from_numpy(x)),
           jdispatch.newton_schulz(jnp.asarray(x), impl="interpret"), ATOL_NS)


@pytest.mark.parametrize("shape", [(64, 64), (128, 64), (64, 128), (2, 160, 96)])
def test_newton_schulz_plain_and_muon_scale_match_reference(shape):
    from repro.core.newton_schulz import muon_scale as j_muon_scale
    from repro.core.newton_schulz import newton_schulz as j_newton_schulz
    from repro_torch.core.newton_schulz import muon_scale, newton_schulz_plain

    x = _rand(17, *shape)
    _close(newton_schulz_plain(torch.from_numpy(x)), j_newton_schulz(jnp.asarray(x)),
           ATOL_NS)
    assert muon_scale(shape) == j_muon_scale(shape)


def test_attention_ref_matches_jax():
    from repro.kernels.ref import attention_ref as j_attention_ref

    q, k, v = _rand(14, 2, 8, 4, 16), _rand(15, 2, 12, 2, 16), _rand(16, 2, 12, 2, 16)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    _close(got, j_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))


def test_resolve_impl_by_device():
    x = torch.zeros(2, 2)
    assert dispatch.resolve_impl("auto", x) == "torch"
    assert dispatch.resolve_impl("torch", x) == "torch"
    with pytest.raises(ValueError):
        dispatch.resolve_impl("cuda", x)
    with pytest.raises(ValueError):
        dispatch.resolve_impl("pallas", x)


def test_registry_names_the_ported_ops():
    assert set(dispatch.REGISTRY) == {"lowrank_update", "project", "back_project",
                                      "back_project_epilogue", "newton_schulz"}
    assert dispatch.get_kernel("back_project").fn is dispatch.back_project
    with pytest.raises(KeyError):
        dispatch.get_kernel("nope")
    with pytest.raises(ValueError):
        dispatch.register(dispatch.KernelEntry("not_an_op", dispatch.project,
                                               ref.project_ref))
