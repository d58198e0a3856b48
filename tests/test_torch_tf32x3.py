"""The numerics of the ``lowrank_update`` kernel's 3xTF32 products, emulated
on the CPU.

The kernel (``src/repro_torch/kernels/csrc/lowrank_update.cu``) splits each
fp32 operand x into hi = x rounded to TF32 (10 mantissa bits; nearest, ties
away from zero: add 0x1000 to the bit pattern and clear the low 13 bits) and
lo = (x - hi) rounded the same way, and sums a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi in fp32, dropping a_lo·b_lo.  Here the same split feeds three fp32
matrix products (products of TF32 values are exact in fp32, as on the
tensor cores).  The kernel is held to max|out − want| / max|want| ≤ 1e-5
on the card; this file shows that the split itself stays inside that
against the fp64 product, and that a single TF32 product does not.
"""
import numpy as np
import pytest

TOL = 1e-5


def round_tf32(x: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b from the split, small terms first, in fp32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def product_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return round_tf32(a) @ round_tf32(b)


def lowrank_update(prod, p, g, r_state, beta, coeff):
    """beta·R + coeff·PᵀG over a batch, with the product ``prod``."""
    out = np.stack([prod(np.ascontiguousarray(pi.T), gi) for pi, gi in zip(p, g)])
    out = np.float32(coeff) * out
    return out if r_state is None else np.float32(beta) * r_state + out


def want_fp64(p, g, r_state, beta, coeff):
    out = coeff * np.einsum("lmr,lmn->lrn", p.astype(np.float64), g.astype(np.float64))
    return out if r_state is None else beta * r_state.astype(np.float64) + out


def rel_err(out, want) -> float:
    return float(np.abs(out - want).max() / np.abs(want).max())


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_round_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit at 1
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -12,
                  np.inf, -np.inf], dtype=np.float32)
    np.testing.assert_array_equal(
        round_tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp, np.inf, -np.inf],
                                dtype=np.float32))
    assert np.isnan(round_tf32(np.array([np.nan], dtype=np.float32)))[0]
    x = _rand(0, 4096)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs((hi.astype(np.float64) + lo) - x).max() <= 2.0 ** -21 * np.abs(x).max()


def test_3xtf32_projection_at_the_principal_shape():
    """One member of GaLore's and GUM's projection at llama-130m: P (768,
    256), G (768, 2048); P scaled as orthonormal columns are."""
    p = _rand(1, 1, 768, 256) / np.float32(np.sqrt(768))
    g = _rand(2, 1, 768, 2048)
    want = want_fp64(p, g, None, 0.0, 1.0)
    assert rel_err(lowrank_update(product_3xtf32, p, g, None, 0.0, 1.0), want) <= TOL


def test_3xtf32_momentum_update_at_the_ragged_shape():
    """With R, at llama-60m's ragged (2, 1000, 96, 1376)."""
    p = _rand(3, 2, 1000, 96) / np.float32(np.sqrt(1000))
    g, r_state = _rand(4, 2, 1000, 1376), _rand(5, 2, 96, 1376)
    want = want_fp64(p, g, r_state, 0.95, 1.5)
    assert rel_err(lowrank_update(product_3xtf32, p, g, r_state, 0.95, 1.5), want) <= TOL


def test_a_single_tf32_product_misses_the_tolerance():
    """The tolerance can fail: one TF32 product (about 2^-11 relative per
    factor) lands far outside 1e-5 at the same shape."""
    p = _rand(1, 1, 768, 256) / np.float32(np.sqrt(768))
    g = _rand(2, 1, 768, 2048)
    want = want_fp64(p, g, None, 0.0, 1.0)
    assert rel_err(lowrank_update(product_1xtf32, p, g, None, 0.0, 1.0), want) > 10 * TOL


@pytest.mark.parametrize("k", [768, 2048])
def test_3xtf32_error_does_not_grow_with_the_reduction(k):
    """The split's error is per product, so it stays at fp32's scale as the
    reduction grows (the kernel sums each 32-deep slice from zero for the
    same reason: the tensor cores truncate when they accumulate)."""
    p = _rand(6, 1, k, 64) / np.float32(np.sqrt(k))
    g = _rand(7, 1, k, 512)
    want = want_fp64(p, g, None, 0.0, 1.0)
    assert rel_err(lowrank_update(product_3xtf32, p, g, None, 0.0, 1.0), want) <= TOL / 4
