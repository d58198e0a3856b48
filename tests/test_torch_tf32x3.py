"""The numerics of the ``lowrank_update`` and ``flash_attention`` kernels'
3xTF32 products, emulated on the CPU.

The kernel (``src/repro_torch/kernels/csrc/lowrank_update.cu``) splits each
fp32 operand x into hi = x rounded to TF32 (10 mantissa bits; nearest, ties
away from zero: add 0x1000 to the bit pattern and clear the low 13 bits) and
lo = (x - hi) rounded the same way, and sums a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi in fp32, dropping a_lo·b_lo.  Here the same split feeds three fp32
matrix products (products of TF32 values are exact in fp32, as on the
tensor cores).  The kernel is held to max|out − want| / max|want| ≤ 1e-5
on the card; this file shows that the split itself stays inside that
against the fp64 product, and that a single TF32 product does not; then
the same for flash attention, at the end of the file.
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


# ---------------------------------------------------------------- flash attention
#
# The flash_attention kernel (csrc/flash_attention.cu) forms both of its
# products by the same split: each 64-row kv tile's scores q kᵀ start from
# zero, the fp32 online softmax (running max m, denominator l) gives the
# tile's probabilities p, p v of the tile starts from zero too, and the
# output is carried as acc = alpha·acc + (p v of the tile) in fp32.


def flash_attention_emulated(prod, q, k, v, block_kv=64):
    """Causal attention of one head, q (S, D), k/v (T, D), the kernel's way."""
    S, D = q.shape
    T = k.shape[0]
    scale = np.float32(D ** -0.5)
    rows = np.arange(S)[:, None] + (T - S)
    m = np.full((S, 1), -1e30, np.float32)
    l = np.zeros((S, 1), np.float32)
    acc = np.zeros((S, D), np.float32)
    for k0 in range(0, T, block_kv):
        kt, vt = k[k0:k0 + block_kv], v[k0:k0 + block_kv]
        s = prod(q, np.ascontiguousarray(kt.T)) * scale
        cols = k0 + np.arange(kt.shape[0])[None, :]
        s = np.where(cols <= rows, s, np.float32(-1e30))
        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = alpha * l + p.sum(axis=1, keepdims=True, dtype=np.float32)
        acc = alpha * acc + prod(p, vt)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


def attention_fp64(q, k, v):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    S, D = q.shape
    s = q @ k.T * D ** -0.5
    s = np.where(np.arange(k.shape[0])[None, :] <= np.arange(S)[:, None] + k.shape[0] - S,
                 s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_3xtf32_flash_attention_stays_within_the_tolerance(q_scale):
    """S = T = 256, D = 64, causal; q scaled by 8 gives scores of tens, so the
    running max moves often and alpha rescales the carried output hard."""
    q = np.float32(q_scale) * _rand(8, 256, 64)
    k, v = _rand(9, 256, 64), _rand(10, 256, 64)
    out = flash_attention_emulated(product_3xtf32, q, k, v)
    assert out.dtype == np.float32
    assert rel_err(out, attention_fp64(q, k, v)) <= TOL


def test_a_single_tf32_flash_attention_misses_the_tolerance():
    q, k, v = _rand(8, 256, 64), _rand(9, 256, 64), _rand(10, 256, 64)
    assert rel_err(flash_attention_emulated(product_1xtf32, q, k, v),
                   attention_fp64(q, k, v)) > 10 * TOL
