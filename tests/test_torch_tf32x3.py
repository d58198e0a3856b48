"""The numerics of the port's 3xTF32 tensor-core kernels (``lowrank_update``,
``back_project``, ``back_project_epilogue``, ``gram``, ``poly_apply``,
``flash_attention``, ``ssd_scan``), emulated on the CPU.

The GEMM core (``src/repro_torch/kernels/csrc/tf32x3_gemm.cuh``) splits each
fp32 operand x into hi = x rounded to TF32 (10 mantissa bits; nearest, ties
away from zero: add 0x1000 to the bit pattern and clear the low 13 bits) and
lo = (x - hi) rounded the same way, and sums a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi in fp32, dropping a_lo·b_lo.  Here the same split feeds three fp32
matrix products (products of TF32 values are exact in fp32, as on the
tensor cores).  The kernel is held to max|out − want| / max|want| ≤ 1e-5
on the card; this file shows that the split itself stays inside that
against the fp64 product, and that a single TF32 product does not; then
the same for the back-projection and its fused epilogue (a reduction over
the rank only), for a Newton–Schulz chain of ``gram`` and ``poly_apply``
products and for flash attention, with ``gram``'s triangle of tiles, and
for a chunked SSD scan with bf16 x (two TF32 products where x is one
operand); and flash attention's 16-bit instantiation (bf16 / fp16 q, k, v,
exact in TF32: one product for q kᵀ, two for p v, the skipped ones zero).
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


# ---------------------------------------------------------------- back-projection
#
# back_project (row 3) and back_project_epilogue (row 6) on the same core:
# out = P S on the left, P (m, r), S (r, n); out = S Pᵀ on the right, P
# (n, r), S (m, r), B read K-major; the epilogue is scale·(the product) +
# decay·W.  The reduction is over the rank r only: 256 at llama-130m (8
# slices), 97 ragged (the last slice 1 deep).  P is scaled as orthonormal
# columns are.


def back_project_emulated(prod, p, s, side, w=None, scale=1.0, decay=0.0):
    a, b = (p, s) if side == "left" else (s, np.ascontiguousarray(p.T))
    out = np.float32(scale) * prod(a, b)
    return out if w is None else out + np.float32(decay) * w


def back_project_fp64(p, s, side, w=None, scale=1.0, decay=0.0):
    p, s = p.astype(np.float64), s.astype(np.float64)
    out = scale * (p @ s if side == "left" else s @ p.T)
    return out if w is None else out + decay * w.astype(np.float64)


def _back_project_case(side, r, with_w):
    m, n = (768, 2048) if side == "left" else (2048, 768)
    p = _rand(13, m if side == "left" else n, r) / np.float32(np.sqrt(m if side == "left" else n))
    s = _rand(14, *((r, n) if side == "left" else (m, r)))
    w = _rand(15, m, n) if with_w else None
    return p, s, w


# (side, r, with W): GUM's write-back on both sides, GaLore's with W, ragged r
BACK_PROJECT_CASES = [("left", 256, False), ("right", 256, False), ("left", 97, False),
                      ("right", 97, False), ("left", 256, True), ("right", 97, True)]


@pytest.mark.parametrize("side,r,with_w", BACK_PROJECT_CASES)
def test_3xtf32_back_project_stays_within_the_tolerance(side, r, with_w):
    """scale and decay of one size, so that W's term counts as much as the
    product's."""
    p, s, w = _back_project_case(side, r, with_w)
    got = back_project_emulated(product_3xtf32, p, s, side, w, -0.5, -0.25)
    assert got.dtype == np.float32
    assert rel_err(got, back_project_fp64(p, s, side, w, -0.5, -0.25)) <= TOL


@pytest.mark.parametrize("side,r,with_w", BACK_PROJECT_CASES)
def test_a_single_tf32_back_project_misses_the_tolerance(side, r, with_w):
    p, s, w = _back_project_case(side, r, with_w)
    got = back_project_emulated(product_1xtf32, p, s, side, w, -0.5, -0.25)
    assert rel_err(got, back_project_fp64(p, s, side, w, -0.5, -0.25)) > 10 * TOL


# ---------------------------------------------------------------- Newton–Schulz
#
# Five quintic steps X' = a·X + A2 X, A2 = b·G + c·G², G = X Xᵀ, as the port
# runs them: G by the gram kernel and A2 X by poly_apply, both 3xTF32, and A2
# a plain fp32 matmul in between.  Newton–Schulz magnifies rounding, so the
# chain is held against fp64 Newton–Schulz from the same fp32 start: within
# 2e-5 (and chip_smoke's TOL_NS = 1e-4), within twice plain fp32's own
# distance, while one TF32 product a GEMM lands past 1e-3.

NS_COEFFS = (3.4445, -4.7750, 2.0315)
TOL_NS = 1e-4


def newton_schulz_emulated(prod, x, steps=5):
    a, b, c = (np.float32(v) for v in NS_COEFFS)
    for _ in range(steps):
        g = prod(x, np.ascontiguousarray(x.T))
        x = a * x + prod(b * g + c * (g @ g), x)
    return x


def newton_schulz_fp64(x, steps=5):
    a, b, c = NS_COEFFS
    x = x.astype(np.float64)
    for _ in range(steps):
        g = x @ x.T
        x = a * x + (b * g + c * (g @ g)) @ x
    return x


def _ns_start(seed, s, n):
    x = _rand(seed, s, n)
    return (x / np.linalg.norm(x.astype(np.float64))).astype(np.float32)


@pytest.mark.parametrize("s,n", [(96, 384), (256, 768)])
def test_3xtf32_newton_schulz_stays_at_fp32s_distance(s, n):
    x = _ns_start(11, s, n)
    want = newton_schulz_fp64(x)
    got = newton_schulz_emulated(product_3xtf32, x)
    assert got.dtype == np.float32
    err = rel_err(got, want)
    assert err <= 2e-5 and err <= TOL_NS
    assert err <= 2 * rel_err(newton_schulz_emulated(np.matmul, x), want)


@pytest.mark.parametrize("s,n", [(96, 384), (256, 768)])
def test_a_single_tf32_newton_schulz_misses_the_tolerance(s, n):
    x = _ns_start(11, s, n)
    assert rel_err(newton_schulz_emulated(product_1xtf32, x), newton_schulz_fp64(x)) > 1e-3


# gram's grid: block b of a member takes the square tile (bi, bj), bi <= bj,
# with b = bj (bj + 1) / 2 + bi, decoded from an fp32 square root as the
# kernel decodes it; it writes its tile and, off the diagonal, the transpose
# to (bj, bi); a diagonal tile writes its upper half and mirrors it.


def triangle_tile(b: int) -> tuple[int, int]:
    bj = int((np.sqrt(np.float32(8 * b + 1), dtype=np.float32) - np.float32(1)) * np.float32(0.5))
    while bj * (bj + 1) // 2 > b:
        bj -= 1
    while (bj + 1) * (bj + 2) // 2 <= b:
        bj += 1
    return b - bj * (bj + 1) // 2, bj


def test_triangle_decode_visits_each_upper_tile_once():
    for t in (1, 2, 12, 24, 64, 200):
        tiles = [triangle_tile(b) for b in range(t * (t + 1) // 2)]
        assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]


def gram_tiles(prod, x, tile, triangle):
    """X Xᵀ tile by tile: every tile of the square, or the triangle's tiles
    written and mirrored as the gram kernel writes them (NaN where nothing
    was written)."""
    s = x.shape[0]
    t = -(-s // tile)
    out = np.full((s, s), np.nan, np.float32)
    pairs = ([triangle_tile(b) for b in range(t * (t + 1) // 2)] if triangle
             else [(i, j) for i in range(t) for j in range(t)])
    for bi, bj in pairs:
        rows, cols = slice(bi * tile, (bi + 1) * tile), slice(bj * tile, (bj + 1) * tile)
        block = prod(x[rows], np.ascontiguousarray(x[cols].T))
        if not triangle:
            out[rows, cols] = block
        elif bi < bj:
            out[rows, cols] = block
            out[cols, rows] = block.T
        else:
            upper = np.triu(block)
            out[rows, cols] = upper + np.triu(block, 1).T
    return out


@pytest.mark.parametrize("s,tile", [(100, 32), (96, 32), (130, 64), (5, 32)])
def test_gram_triangle_is_exactly_symmetric_and_the_squares_upper_half(s, tile):
    """Ragged s leaves a partial last tile on both writes."""
    x = _ns_start(12, s, 384)
    tri = gram_tiles(product_3xtf32, x, tile, triangle=True)
    square = gram_tiles(product_3xtf32, x, tile, triangle=False)
    assert not np.isnan(tri).any()
    np.testing.assert_array_equal(tri, tri.T)
    upper = np.triu_indices(s)
    np.testing.assert_array_equal(tri[upper], square[upper])
    assert rel_err(tri, x.astype(np.float64) @ x.T.astype(np.float64)) <= TOL


# ---------------------------------------------------------------- flash attention
#
# The flash_attention kernel (csrc/flash_attention.cu) forms both of its
# products by the same split: each 64-row kv tile's scores q kᵀ start from
# zero, the fp32 online softmax (running max m, denominator l) gives the
# tile's probabilities p, p v of the tile starts from zero too, and the
# output is carried as acc = alpha·acc + (p v of the tile) in fp32.


def flash_attention_emulated(prod, q, k, v, block_kv=64, prod_pv=None):
    """Causal attention of one head, q (S, D), k/v (T, D), the kernel's way
    (``prod_pv``, default ``prod``, forms p v)."""
    prod_pv = prod_pv or prod
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
        acc = alpha * acc + prod_pv(p, vt)
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


TERMS = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))  # a_lo b_hi, a_hi b_lo, a_hi b_hi


def product_3xtf32_tc(a: np.ndarray, b: np.ndarray, depth: int, terms=TERMS) -> np.ndarray:
    """a @ b as the tensor cores accumulate it: k8 steps of the split
    products ``terms`` (all three by default), each mma adding its exact
    8-term sum to the fp32 accumulator rounded toward zero (the accumulator
    truncates); slices of ``depth`` start from zero and add in fp32 (round
    to nearest)."""
    out = None
    for s0 in range(0, a.shape[1], depth):
        a_parts = dict(zip(("hi", "lo"), (x.astype(np.float64) for x in
                                           split(a[:, s0:s0 + depth]))))
        b_parts = dict(zip(("hi", "lo"), (x.astype(np.float64) for x in
                                           split(b[s0:s0 + depth]))))
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k0 in range(0, a_parts["hi"].shape[1], 8):
            k = slice(k0, k0 + 8)
            for ta, tb in terms:
                exact = acc.astype(np.float64) + a_parts[ta][:, k] @ b_parts[tb][k]
                acc = exact.astype(np.float32)
                away = np.abs(acc.astype(np.float64)) > np.abs(exact)
                acc[away] = np.nextafter(acc[away], np.float32(0))
        out = acc if out is None else out + acc
    return out


def attention_fp32(q, k, v):
    """The plain path's arithmetic: one fp32 softmax over fp32 products."""
    S, D = q.shape
    s = (q @ k.T) * np.float32(D ** -0.5)
    s = np.where(np.arange(k.shape[0])[None, :] <= np.arange(S)[:, None] + k.shape[0] - S,
                 s, np.float32(-np.inf))
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True, dtype=np.float32)) @ v


def test_flash_attention_scores_in_32_deep_slices_keep_fp32s_distance():
    """D = 128, q x 8: with the accumulator's truncation modelled, one
    128-deep score sum leaves the output farther from fp64 than the fp32
    plain path, and the kernel's 32-deep slices (KSL in
    csrc/flash_attention.cu) bring it within it (the median over 8 heads of
    max|out - fp64| / max|fp64|)."""
    errs = {"one sum": [], "slices": [], "plain": []}
    for h in range(8):
        q = np.float32(8.0) * _rand(40 + h, 77, 128)
        k, v = _rand(60 + h, 200, 128), _rand(80 + h, 200, 128)
        want = attention_fp64(q, k, v)
        for name, depth in (("one sum", 128), ("slices", 32)):
            out = flash_attention_emulated(
                lambda a, b, depth=depth: product_3xtf32_tc(a, b, depth), q, k, v, block_kv=32)
            errs[name].append(rel_err(out, want))
        errs["plain"].append(rel_err(attention_fp32(q, k, v), want))
    med = {name: float(np.median(e)) for name, e in errs.items()}
    assert med["slices"] <= med["plain"] < med["one sum"], med


# The 16-bit instantiations (bf16, fp16 q, k, v): every element is exact in
# TF32, so its low part is zero; the kernel forms q kᵀ from the high parts
# alone (one TF32 product) and p v as p_lo·v + p_hi·v (two), and rounds the
# fp32 output to the element type at the store.


def to_16bit(x: np.ndarray, kind: str) -> np.ndarray:
    """fp32 values rounded to bf16 or fp16 (nearest even), kept as fp32."""
    if kind == "fp16":
        return x.astype(np.float16).astype(np.float32)
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["bf16", "fp16"])
def test_16bit_flash_attention_skips_only_zero_products(kind):
    """D = 128, q x 8, the tensor cores' truncating accumulator modelled:
    q, k and v have zero low parts; the skipped products change no bit of
    the output; it stays within 1e-5 of fp64 before the store, and rounded
    to the element type no farther from fp64 than the plain fp32 path
    rounded the same way, plus one rounding (the card's rule)."""
    q = to_16bit(np.float32(8.0) * _rand(70, 77, 128), kind)
    k, v = to_16bit(_rand(71, 200, 128), kind), to_16bit(_rand(72, 200, 128), kind)
    for x in (q, k, v):
        hi, lo = split(x)
        assert not lo.any() and np.array_equal(hi, x)

    def three(a, b):
        return product_3xtf32_tc(a, b, 32)

    out_full = flash_attention_emulated(three, q, k, v, block_kv=32)
    out = flash_attention_emulated(
        lambda a, b: product_3xtf32_tc(a, b, 32, terms=(("hi", "hi"),)), q, k, v, block_kv=32,
        prod_pv=lambda p, b: product_3xtf32_tc(p, b, 32, terms=(("lo", "hi"), ("hi", "hi"))))
    assert np.array_equal(out, out_full)
    want = attention_fp64(q, k, v)
    assert rel_err(out, want) <= TOL
    bits = 8 if kind == "bf16" else 11
    plain = to_16bit(attention_fp32(q, k, v), kind)
    one = 2.0 ** -bits * np.abs(plain).max()
    stored = to_16bit(out, kind)
    assert np.abs(stored - plain).max() <= one
    assert np.abs(stored - want).max() <= np.abs(plain - want).max() + one


# ---------------------------------------------------------------- the SSD scan
#
# The ssd_scan kernel (csrc/ssd_scan.cu) forms C Bᵀ once per chunk on the
# GEMM core, then per head and chunk M = (C Bᵀ) ⊙ L ⊙ dt in fp32 (the
# exponent masked before exp), y = M X + (C ⊙ e^G) S_prev and the state
# increment (B ⊙ w)ᵀ X, w_j = dt_j e^{G_last − G_j}, each product by the
# split over 32-deep slices that sum from zero, fp32 adds carrying the
# slices; the state is carried as S = e^{G_last} S + inc in fp32.  x is
# bf16, exact in TF32, so the products with x drop a·x_lo: two TF32
# products there (a_lo·x + a_hi·x), three elsewhere.  Held against an fp64
# scan of the same inputs: within 1e-4 (chip_smoke's TOL_SSD) and within
# twice plain fp32's own distance, while one TF32 product a product misses.

TOL_SSD = 1e-4


def product_3xtf32_x(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """a @ x where x is exact in TF32 (bf16): a_lo·x + a_hi·x."""
    a_hi, a_lo = split(a)
    assert not (x.view(np.uint32) & 0x1FFF).any()
    return a_lo @ x + a_hi @ x


def sliced(prod, a: np.ndarray, b: np.ndarray, depth: int = 32) -> list[np.ndarray]:
    """The per-slice sums of a @ b, each 32 deep from zero."""
    return [prod(a[:, k:k + depth], b[k:k + depth]) for k in range(0, a.shape[1], depth)]


def carried(parts: list[np.ndarray]) -> np.ndarray:
    out = np.zeros_like(parts[0])
    for part in parts:
        out = out + part
    return out


def ssd_scan_emulated(prod, prod_x, x, dt, G, b, c, chunk):
    """One batch row of the scan, per head and chunk as the kernel orders
    it; ``prod`` forms the products with fp32 operands, ``prod_x`` those
    with x.  x (S, H, P), dt and G (S, H), b and c (S, N)."""
    S, H, P = x.shape
    ys, states = np.zeros((S, H, P), x.dtype), []
    for h in range(H):
        st = np.zeros((b.shape[1], P), x.dtype)
        for c0 in range(0, S, chunk):
            rows = slice(c0, c0 + chunk)
            cc, bb, xx = c[rows], b[rows], np.ascontiguousarray(x[rows, h])
            g, d = G[rows, h], dt[rows, h]
            cb = carried(sliced(prod, cc, np.ascontiguousarray(bb.T)))
            diff = g[:, None] - g[None, :]
            e = np.where(np.tril(np.ones((len(g), len(g)), bool)), diff, np.float32(-np.inf))
            m = cb * np.exp(e) * d[None, :]
            parts = sliced(prod_x, m, xx) + sliced(prod, cc * np.exp(g)[:, None], st)
            ys[rows, h] = carried(parts)
            w = d * np.exp(g[-1] - g)
            inc = carried(sliced(prod_x, np.ascontiguousarray((bb * w[:, None]).T), xx))
            st = np.exp(g[-1]) * st + inc
        states.append(st)
    return ys, np.stack(states)


def ssd_inputs(S=512, H=2, P=64, N=128, chunk=128, seed=20):
    rng = np.random.default_rng(seed)
    bits = rng.standard_normal((S, H, P)).astype(np.float32).view(np.uint32)
    x = ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(np.float32)  # bf16 values
    dt = np.log1p(np.exp(rng.standard_normal((S, H)) - 1.0)).astype(np.float32)
    a = -np.exp(np.linspace(0.0, np.log(16.0), H)).astype(np.float32)
    G = np.cumsum((a[None, :] * dt).reshape(S // chunk, chunk, H), axis=1,
                  dtype=np.float32).reshape(S, H)
    b, c = (rng.standard_normal((S, N)).astype(np.float32) for _ in range(2))
    return x, dt, G, b, c


def ssd_scan_fp64(x, dt, G, b, c, chunk):
    f64 = [t.astype(np.float64) for t in (x, dt, G, b, c)]
    return ssd_scan_emulated(np.matmul, np.matmul, *f64, chunk)


def _ssd_err(got, want) -> float:
    return max(rel_err(g, w) for g, w in zip(got, want))


def test_3xtf32_ssd_scan_stays_at_fp32s_distance():
    """S = 512 (four chunks of 128), H 2, P 64, N 128, bf16 x."""
    inputs = ssd_inputs()
    want = ssd_scan_fp64(*inputs, 128)
    got = ssd_scan_emulated(product_3xtf32, product_3xtf32_x, *inputs, 128)
    assert got[0].dtype == np.float32 and got[1].dtype == np.float32
    err = _ssd_err(got, want)
    assert err <= TOL_SSD
    assert err <= 2 * _ssd_err(ssd_scan_emulated(np.matmul, np.matmul, *inputs, 128), want)


def test_a_single_tf32_ssd_scan_misses_the_tolerance():
    inputs = ssd_inputs()
    got = ssd_scan_emulated(product_1xtf32, product_1xtf32, *inputs, 128)
    assert _ssd_err(got, ssd_scan_fp64(*inputs, 128)) > TOL_SSD
