"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
where ``torch.cuda.is_available()`` is false (CPU runs of the suite).  This
file imports no JAX, so it also runs on the GPU machine, which has none:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: max|kernel − plain| / max|plain| ≤ 1e-5 for one GEMM, 1e-4 for a
5-step Newton–Schulz (both sides sum in fp32, in another order; the GEMM
kernels form their products on the tensor cores by 3xTF32, about 2^-21
relative each, see ``tests/test_torch_tf32x3.py``).

Inputs are seeded: each test draws from a ``torch.Generator`` seeded by the
test's own name, so a failure reproduces.  Which template instantiation a
launch ran (tile, copy width, layout) is read from ``build.VARIANTS``, which
each C entry point fills through its ``variant`` out-argument.
"""
import math
import zlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.newton_schulz import newton_schulz_plain
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels.fused_step import back_project_epilogue_batched
from repro_torch.kernels.lowrank_update import (
    back_project_batched,
    back_project_tile,
    lowrank_update_batched,
    lowrank_update_tile,
    project_batched,
)
from repro_torch.kernels.newton_schulz import gram, gram_tile, poly_apply_tile, poly_matmul_axpy

pytestmark = pytest.mark.cuda

SHAPES = [(12, 768, 256, 2048), (4, 768, 256, 768), (2, 1000, 96, 1376), (3, 5, 3, 7)]


_GEN: dict[str, torch.Generator] = {}


@pytest.fixture
def cuda_device(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = zlib.crc32(request.node.name.encode())
    _GEN["cuda"] = torch.Generator(device="cuda").manual_seed(seed)
    return torch.device("cuda")


def _rel(out, want):
    torch.cuda.synchronize()
    return float((out - want).abs().max() / want.abs().max())


def _randn(*shape):
    return torch.randn(*shape, generator=_GEN["cuda"], device="cuda")


def _variants() -> dict:
    return {k: dict(v) for k, v in build.VARIANTS.items()}


def _variants_since(before: dict) -> dict:
    """{kernel: {template arguments: launches}} since ``before``."""
    out = {}
    for name, counts in build.VARIANTS.items():
        new = {key: n - before[name].get(key, 0) for key, n in counts.items()
               if n != before[name].get(key, 0)}
        if new:
            out[name] = new
    return out


@pytest.mark.parametrize("L,m,r,n", SHAPES)
def test_lowrank_kernels_match_plain(cuda_device, L, m, r, n):
    p, g, rs, s = _randn(L, m, r), _randn(L, m, n), _randn(L, r, n), _randn(L, r, n)
    before = dict(build.LAUNCHES)
    assert _rel(lowrank_update_batched(p, g, rs, 0.95, 1.5),
                ref.lowrank_update_ref(p, g, rs, 0.95, 1.5)) <= 1e-5
    assert _rel(project_batched(p, g, 2.0), ref.project_ref(p, g, 2.0)) <= 1e-5
    assert _rel(back_project_batched(p, s), ref.back_project_ref(p, s)) <= 1e-5
    assert build.LAUNCHES["lowrank_update"] == before["lowrank_update"] + 2
    assert build.LAUNCHES["back_project"] == before["back_project"] + 1


# Branches of the lowrank_update kernel (csrc/lowrank_update.cu), each case
# (L, m, r, n, side) with R and without.  Block tiles: the kernel picks the
# largest of 64x64, 64x32, 32x32 that gives two blocks an SM, else 32x32
# (read back through lowrank_update_tile).  Copies: 16 bytes when r and n
# are multiples of 4, else 4 bytes.  Slices are 32 deep, so K (m on the
# left, n on the right) not a multiple of 32 leaves a ragged last slice.
LOWRANK_BRANCHES = [
    (12, 768, 256, 2048, "left"),   # 64x64, 16-byte copies
    (4, 768, 256, 768, "left"),     # 64x32
    (2, 1000, 96, 1376, "left"),    # 32x32, ragged K = 1000
    (12, 2048, 256, 768, "right"),  # 64x64 on the right side
    (4, 2048, 256, 768, "left"),    # K = 2048: the per-slice sums keep it in 1e-5
    (2, 1000, 97, 1375, "left"),    # 4-byte copies, r odd
    (2, 1000, 97, 1375, "right"),   # 4-byte copies, ragged K = 1375
    (2, 1000, 96, 1375, "left"),    # 4-byte copies, n odd only
    (1, 1000, 96, 1376, "left"),    # L = 1
    (1, 1376, 96, 1000, "right"),   # L = 1, right
    (3, 200, 8, 300, "left"),       # r < 16
    (3, 300, 5, 200, "right"),      # r < 16, not a multiple of 4
    (2, 37, 13, 50, "left"),        # everything ragged and small
]


def test_lowrank_branches_cover_every_tile_and_copy_width(cuda_device):
    tiles = {lowrank_update_tile(*case) for case in LOWRANK_BRANCHES}
    assert tiles == {(64, 64), (64, 32), (32, 32)}


def test_lowrank_branches_cover_both_copy_widths():
    assert {r % 4 == 0 and n % 4 == 0 for _, _, r, n, _ in LOWRANK_BRANCHES} == {True, False}


def _lowrank_plain(p, g, rs, beta, coeff, side):
    if side == "right":  # G P = (Pᵀ Gᵀ)ᵀ
        return ref.lowrank_update_ref(p, g.mT, None if rs is None else rs.mT, beta, coeff).mT
    return ref.lowrank_update_ref(p, g, rs, beta, coeff)


@pytest.mark.parametrize("L,m,r,n,side", LOWRANK_BRANCHES)
def test_lowrank_update_kernel_branches_match_plain(cuda_device, L, m, r, n, side):
    p = _randn(L, n if side == "right" else m, r)
    g = _randn(L, m, n)
    rs = _randn(*((L, m, r) if side == "right" else (L, r, n)))
    bm, bn = lowrank_update_tile(L, m, r, n, side)
    want = (bm, bn, int(side == "right"), int(r % 4 == 0 and n % 4 == 0))
    for with_r in (True, False):
        r_state = rs if with_r else None
        before = _variants()
        got = lowrank_update_batched(p, g, r_state, 0.95, 1.5, side=side)
        assert _variants_since(before) == {"lowrank_update": {want: 1}}
        assert _rel(got, _lowrank_plain(p, g, r_state, 0.95, 1.5, side)) <= 1e-5


@pytest.mark.parametrize("side", ["left", "right"])
def test_dispatch_lowrank_both_sides_match_plain(cuda_device, side):
    """Both sides through the dispatcher, leads and all: G and R go to the
    kernel in their own layout (one launch each, no transposed copies)."""
    from repro_torch.core.lowrank_common import project

    m, n, r = (768, 2048, 256) if side == "left" else (2048, 768, 256)
    p = _randn(3, 4, n if side == "right" else m, r)
    g = _randn(3, 4, m, n)
    st = _randn(3, 4, *((m, r) if side == "right" else (r, n)))
    before = build.LAUNCHES["lowrank_update"]
    got = dispatch.lowrank_update(p, g, st, 0.95, 2.0, side=side, impl="cuda")
    assert _rel(got, 0.95 * st + 2.0 * project(p, g, side)) <= 1e-5
    assert _rel(dispatch.project(p, g, side=side, impl="cuda"), project(p, g, side)) <= 1e-5
    assert build.LAUNCHES["lowrank_update"] == before + 2


# (L, m, r, n, side): llama-130m's mlp family (left) and mlp/w_out stack
# (right), llama-60m's ragged d_ff with r = 96 on both sides, a tiny shape.
EPILOGUE_SHAPES = [(24, 768, 256, 2048, "left"), (12, 2048, 256, 768, "right"),
                   (2, 1000, 96, 1376, "left"), (2, 1376, 96, 1000, "right"),
                   (3, 5, 3, 7, "right")]


@pytest.mark.parametrize("L,m,r,n,side", EPILOGUE_SHAPES)
def test_back_project_epilogue_kernel_matches_plain(cuda_device, L, m, r, n, side):
    p = _randn(L, m if side == "left" else n, r)
    s = _randn(*((L, r, n) if side == "left" else (L, m, r)))
    w = _randn(L, m, n)
    before = build.LAUNCHES["back_project_epilogue"]
    plain = (lambda w: ref.back_project_epilogue_ref(p, s, w, -0.0025, -2.5e-5)
             if side == "left" else
             ref.back_project_epilogue_ref(s, p.mT, w, -0.0025, -2.5e-5))
    for ww in (w, None):
        assert _rel(back_project_epilogue_batched(p, s, ww, -0.0025, -2.5e-5, side=side),
                    plain(ww)) <= 1e-5
    got = dispatch.back_project_epilogue(p, s, w=w, scale=-0.0025, decay=-2.5e-5,
                                         side=side, impl="cuda")
    assert _rel(got, plain(w)) <= 1e-5
    assert build.LAUNCHES["back_project_epilogue"] == before + 3


@pytest.mark.parametrize("L,m,r,n,side", EPILOGUE_SHAPES)
def test_back_project_epilogue_bf16_w_matches_plain(cuda_device, L, m, r, n, side):
    """Row 6 on a bf16-stored W (the bf16 instantiation, read as stored and
    widened in the epilogue) against the plain version on the same W, with
    W and without; the dispatcher hands the bf16 stack through uncast.
    ``build.VARIANTS`` tells the instantiations apart (fifth argument 1 for
    the bf16 W, 0 without W)."""
    p = _randn(L, m if side == "left" else n, r)
    s = _randn(*((L, r, n) if side == "left" else (L, m, r)))
    w = _randn(L, m, n).to(torch.bfloat16)
    a, b = (p, s) if side == "left" else (s, p.mT)
    before = _variants()
    for ww in (w, None):
        got = back_project_epilogue_batched(p, s, ww, -0.0025, -2.5e-5, side=side)
        assert got.dtype == torch.float32 and got.shape == (L, m, n)
        assert _rel(got, ref.back_project_epilogue_ref(a, b, ww, -0.0025, -2.5e-5)) <= 1e-5
    got = dispatch.back_project_epilogue(p, s, w=w, scale=-0.0025, decay=-2.5e-5,
                                         side=side, impl="cuda")
    assert _rel(got, ref.back_project_epilogue_ref(a, b, w, -0.0025, -2.5e-5)) <= 1e-5
    new = _variants_since(before)
    assert list(new) == ["back_project_epilogue"]
    assert sorted((key[4], n) for key, n in new["back_project_epilogue"].items()) == \
        [(0, 1), (1, 2)]


def test_back_project_epilogue_refuses_other_16_bit_operands(cuda_device):
    """Only W may be bf16: a bf16 P or S, or an fp16 W, raises before any
    launch."""
    p, s = _randn(2, 64, 8), _randn(2, 8, 32)
    w = _randn(2, 64, 32).to(torch.bfloat16)
    before = build.LAUNCHES["back_project_epilogue"]
    for args in ((p.to(torch.bfloat16), s, w), (p, s.to(torch.bfloat16), w),
                 (p, s, w.to(torch.float16)), (p.half(), s, None)):
        with pytest.raises(TypeError):
            back_project_epilogue_batched(*args, -1.0, 0.5)
    assert build.LAUNCHES["back_project_epilogue"] == before


# Branches of the back-projection kernels (csrc/back_project.cu and
# csrc/back_project_epilogue.cu on csrc/tf32x3_gemm.cuh), each case (L, m, r,
# n, side): out (L, m, n) = P S on the left, S Pᵀ on the right (B read
# K-major).  Tiles as lowrank_update's rule over (m, n) (back_project_tile);
# copies 16 bytes when r (and n on the left) are multiples of 4, else 4
# bytes.  K = r: 8 slices at 256, a ragged last slice at 96 and 97, one
# mostly zero-filled slice at r < 32, and r = 4, 5 below one 8-deep mma
# step.  n odd takes the scalar stores.
BACK_PROJECT_BRANCHES = [
    (12, 768, 256, 2048, "left"),   # 64x64, 16-byte copies
    (12, 2048, 256, 768, "right"),  # 64x64 on the right: GUM's w_out write-back
    (4, 2048, 256, 768, "right"),   # the sampled blocks' P Pᵀ G on w_out
    (1, 768, 256, 768, "left"),     # 64x32, L = 1
    (1, 768, 96, 768, "right"),     # 64x32 on the right, ragged K
    (2, 1000, 96, 1376, "left"),    # ragged m and n
    (1, 1376, 96, 1000, "right"),   # L = 1, right
    (2, 1000, 96, 1375, "left"),    # 4-byte copies from n odd only
    (2, 1000, 97, 1375, "left"),    # 4-byte copies, r odd
    (2, 1000, 97, 1375, "right"),   # 4-byte copies, both operands K-major
    (1, 300, 8, 200, "left"),       # 32x32, r = 8: one mma step
    (3, 200, 5, 300, "right"),      # 32x32, r = 5, 4-byte copies
    (4, 768, 4, 2048, "left"),      # r = 4, 16-byte copies, zero-filled slice
    (4, 2048, 4, 768, "right"),     # r = 4 on the right
    (2, 37, 13, 50, "left"),        # everything ragged and small
]


def _bp_vec(r, n, side):
    return r % 4 == 0 and (side == "right" or n % 4 == 0)


def test_back_project_branches_cover_ranks_sides_and_copy_widths():
    assert {case[4] for case in BACK_PROJECT_BRANCHES} == {"left", "right"}
    assert {256, 96, 97, 8, 5, 4} <= {case[2] for case in BACK_PROJECT_BRANCHES}
    for side in ("left", "right"):
        assert {_bp_vec(r, n, sd) for _, _, r, n, sd in BACK_PROJECT_BRANCHES
                if sd == side} == {True, False}
    assert 1 in {case[0] for case in BACK_PROJECT_BRANCHES}


def test_back_project_branches_cover_every_tile(cuda_device):
    for side in ("left", "right"):
        tiles = {back_project_tile(*case) for case in BACK_PROJECT_BRANCHES if case[4] == side}
        assert tiles == {(64, 64), (64, 32), (32, 32)}


def _back_project_operands(L, m, r, n, side):
    p = _randn(L, m if side == "left" else n, r)
    s = _randn(*((L, r, n) if side == "left" else (L, m, r)))
    a, b = (p, s) if side == "left" else (s, p.mT)  # the product is a @ b
    return p, s, a, b


@pytest.mark.parametrize("L,m,r,n,side", BACK_PROJECT_BRANCHES)
def test_back_project_kernel_branches_match_plain(cuda_device, L, m, r, n, side):
    """Row 3, and row 6 with W and without, on every branch: one launch
    each, a contiguous (L, m, n) output, within 1e-5 of the plain version."""
    p, s, a, b = _back_project_operands(L, m, r, n, side)
    w = _randn(L, m, n)
    before = dict(build.LAUNCHES)
    got = back_project_batched(p, s, side=side)
    assert got.shape == (L, m, n) and got.is_contiguous()
    assert _rel(got, ref.back_project_ref(a, b)) <= 1e-5
    for ww in (w, None):
        got = back_project_epilogue_batched(p, s, ww, -0.5, -0.25, side=side)
        assert _rel(got, ref.back_project_epilogue_ref(a, b, ww, -0.5, -0.25)) <= 1e-5
    assert {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]} == {
        "back_project": 1, "back_project_epilogue": 2}


@pytest.mark.parametrize("L,m,r,n,side", BACK_PROJECT_BRANCHES)
def test_back_project_kernels_launch_the_tile_their_query_names(cuda_device, L, m, r, n,
                                                                  side):
    """The template arguments of the kernel each launch ran (tile, B's
    layout and copy width, from ``build.VARIANTS``) against
    back_project_tile, the side and the operands' alignment; the epilogue
    picks the same."""
    p, s, _, _ = _back_project_operands(L, m, r, n, side)
    before = _variants()
    back_project_batched(p, s, side=side)
    back_project_epilogue_batched(p, s, None, 1.0, 0.0, side=side)
    bm, bn = back_project_tile(L, m, r, n, side)
    want = (bm, bn, int(side == "right"), int(_bp_vec(r, n, side)))
    # the epilogue's fifth argument: its W is fp32 (or absent), not bf16
    assert _variants_since(before) == {"back_project": {want: 1},
                                       "back_project_epilogue": {want + (0,): 1}}


class _AtenOps(TorchDispatchMode):
    """The names of the aten ops run inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


# Aten ops that allocate or re-view a tensor and launch no device kernel.
_NO_KERNEL_OPS = {"empty", "empty_strided", "view", "_unsafe_view", "_reshape_alias",
                  "reshape", "alias", "as_strided", "t", "transpose", "permute", "detach"}


def test_dispatch_back_project_right_side_is_one_launch_and_contiguous(cuda_device):
    """GUM's w_out write-back through the dispatcher, leads and all: one
    launch, of the back_project kernel reading P K-major, no other device
    kernel (every aten op that ran only allocates or re-views), and a
    contiguous (..., m, n) result."""
    from repro_torch.core.lowrank_common import back_project

    p, s = _randn(3, 4, 768, 256), _randn(3, 4, 2048, 256)
    before, launches = _variants(), dict(build.LAUNCHES)
    with _AtenOps() as aten:
        got = dispatch.back_project(p, s, side="right", impl="cuda")
    assert {k: v - launches[k] for k, v in build.LAUNCHES.items() if v != launches[k]} == {
        "back_project": 1}
    bm, bn = back_project_tile(12, 2048, 256, 768, "right")
    assert _variants_since(before) == {"back_project": {(bm, bn, 1, 1): 1}}
    assert not [n for n in aten.names if n.split(".")[0] not in _NO_KERNEL_OPS], aten.names
    assert got.shape == (3, 4, 2048, 768) and got.is_contiguous()
    assert _rel(got, back_project(p, s, "right")) <= 1e-5


# Branches of the Newton–Schulz kernels (csrc/gram.cu and csrc/poly_apply.cu
# on csrc/tf32x3_gemm.cuh), each case (L, s, n).  gram: square tiles, 64 x 64
# when one triangle of them gives two blocks an SM, else 32 x 32 (gram_tile);
# poly_apply: lowrank_update's rule over the (s, n) output (poly_apply_tile).
# Copies: 16 bytes when n (gram) or s and n (poly_apply) are multiples of 4,
# else 4 bytes.  s not a multiple of the tile leaves a partial last triangle
# tile on both of gram's writes.
NS_BRANCHES = [
    (12, 256, 2048),  # gram 32x32 (64x64 gives 10 x 12 blocks), poly 64x64
    (4, 768, 2048),   # gram 64x64 (78 x 4 blocks), poly 64x64
    (2, 1000, 1376),  # gram 64x64, partial last tile (1000 = 15 x 64 + 40)
    (1, 1024, 1024),  # gram 32x32 at L = 1
    (2, 1000, 1375),  # 4-byte copies at 64x64 (both kernels)
    (2, 257, 1030),   # gram 32x32, poly 64x32, 4-byte copies, 257 = 8 x 32 + 1
    (2, 320, 1024),   # poly 64x32, 16-byte copies
    (1, 256, 512),    # poly 32x32, 16-byte copies
    (3, 5, 9),        # one partial tile, 4-byte copies
]


def test_ns_branches_cover_both_copy_widths():
    assert {n % 4 == 0 for _, _, n in NS_BRANCHES} == {True, False}
    assert {s % 4 == 0 and n % 4 == 0 for _, s, n in NS_BRANCHES} == {True, False}


def test_ns_branches_cover_every_tile(cuda_device):
    assert {gram_tile(*case) for case in NS_BRANCHES} == {(64, 64), (32, 32)}
    assert {poly_apply_tile(*case) for case in NS_BRANCHES} == {(64, 64), (64, 32), (32, 32)}


@pytest.mark.parametrize("L,s,n", NS_BRANCHES)
def test_newton_schulz_kernels_match_plain(cuda_device, L, s, n):
    x = _randn(L, s, n)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    before = dict(build.LAUNCHES)
    g = gram(x)
    assert torch.equal(g, g.mT)  # one triangle, mirrored
    assert _rel(g, ref.gram_ref(x)) <= 1e-5
    a2 = -4.7750 * g + 2.0315 * (g @ g)
    assert _rel(poly_matmul_axpy(a2, x, 3.4445),
                ref.poly_matmul_axpy_ref(a2, x, 3.4445)) <= 1e-5
    assert {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]} == {
        "gram": 1, "poly_apply": 1}
    assert _rel(dispatch.newton_schulz(x, impl="cuda"), newton_schulz_plain(x)) <= 1e-4


@pytest.mark.parametrize("L,s,n", NS_BRANCHES)
def test_ns_kernels_launch_the_tile_their_query_names(cuda_device, L, s, n):
    """The template arguments of the kernel each launch ran (tile and copy
    width, from ``build.VARIANTS``) against gram_tile / poly_apply_tile and
    the operands' alignment."""
    x = _randn(L, s, n)
    a2 = _randn(L, s, s)
    before = _variants()
    gram(x)
    poly_matmul_axpy(a2, x, 1.5)
    bm, bn = poly_apply_tile(L, s, n)
    assert _variants_since(before) == {
        "gram": {(gram_tile(L, s, n)[0], int(n % 4 == 0)): 1},
        "poly_apply": {(bm, bn, int(s % 4 == 0 and n % 4 == 0)): 1}}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    p, g = _randn(2, 8, 4), _randn(2, 8, 16)
    with pytest.raises(TypeError):
        lowrank_update_batched(p.double(), g.double(), None, 0.0, 1.0)
    with pytest.raises(ValueError):
        lowrank_update_batched(p, g.mT.contiguous().mT, None, 0.0, 1.0)
    with pytest.raises(ValueError):
        back_project_batched(p, _randn(2, 5, 16))
    with pytest.raises(ValueError):  # right: s (L, m, r) with r = 4
        back_project_batched(p, _randn(2, 5, 3), side="right")
    with pytest.raises(ValueError):
        back_project_batched(p, _randn(3, 5, 4), side="right")
    with pytest.raises(ValueError):
        back_project_batched(p, _randn(2, 4, 16), side="up")
    with pytest.raises(ValueError):
        dispatch.project(p, g, impl="torch")


def test_kernels_launch_on_the_operands_device(cuda_device):
    """Operands on a device that is not the current one: each kernel launches
    on the operands' device and its stream, and agrees with its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() != dev.index

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    p, g, rs, s = randn(2, 1000, 96), randn(2, 1000, 1376), randn(2, 96, 1376), randn(2, 96, 1376)
    assert _rel(lowrank_update_batched(p, g, rs, 0.95, 1.5),
                ref.lowrank_update_ref(p, g, rs, 0.95, 1.5)) <= 1e-5
    assert _rel(back_project_batched(p, s), ref.back_project_ref(p, s)) <= 1e-5
    x = randn(2, 768, 2048)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    assert _rel(gram(x), ref.gram_ref(x)) <= 1e-5
    out = dispatch.newton_schulz(x, impl="cuda")
    assert out.device == dev
    assert _rel(out, newton_schulz_plain(x)) <= 1e-4
    assert torch.cuda.current_device() != dev.index


# Serving kernels.  Flash attention in fp32: 1e-5 of the largest output
# against fp64 (the online softmax sums in another order); in bf16 and fp16
# see FLASH_LOW_SHAPES; the SSD scan: 1e-4 (sums through exponentials of
# cumulative sums, state carried across chunks).

# (B, S, T, H, KV, D, causal): llama-130m's prefill, GQA short query with
# D = 128, ragged S and T, the smoke model's D = 16, a tiny ragged one; a
# head dim with D % 8 == 4 (zero-padded to the kernel's k8 steps); T not a
# multiple of the kv tile (64 rows, 32 at D = 128) with S < T and S not a
# multiple of 16, at D = 64 and D = 128; the tiers above 128: nemotron-4-340b's
# heads (96 over 8, D = 192) at a shorter sequence, D = 256 with a short
# query, D = 200 (padded to 256) not causal, D = 132 (padded to 192, its last
# 16-byte chunk of a row partly padding) with ragged S and T.
FLASH_SHAPES = [(8, 1024, 1024, 12, 12, 64, True), (2, 256, 1024, 16, 4, 128, True),
                (2, 1000, 1000, 12, 12, 64, True), (2, 64, 64, 4, 4, 16, True),
                (1, 5, 9, 2, 1, 8, True), (2, 100, 300, 8, 2, 32, False),
                (2, 130, 130, 4, 2, 20, True), (2, 77, 200, 6, 3, 64, True),
                (1, 45, 150, 4, 2, 128, True), (1, 300, 300, 96, 8, 192, True),
                (2, 100, 260, 4, 2, 256, True), (1, 77, 200, 6, 3, 200, False),
                (2, 90, 130, 4, 1, 132, True)]


def _attention_fp64(q, k, v, causal):
    """Softmax attention in fp64 (GQA; the S queries the last S of T)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    kd, vd = (x.double().repeat_interleave(H // KV, dim=2).transpose(1, 2) for x in (k, v))
    s = q.double().transpose(1, 2) @ kd.transpose(-1, -2) * D ** -0.5
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (T - S)
        s = s.masked_fill(torch.arange(T, device=q.device)[None, :] > rows, float("-inf"))
    return (torch.softmax(s, dim=-1) @ vd).transpose(1, 2)


def _padded(D: int) -> int:
    """The head dim the kernel pads D to (its instantiation's DP)."""
    return next(dp for dp in (16, 32, 64, 128, 192, 256) if D <= dp)


def _flash_case(B, S, T, H, KV, D, causal, q_scale=1.0):
    """Against fp64, not the fp32 plain path: with scores of tens (q x 8)
    the plain path itself lies up to 6.4e-6 from fp64, so the kernel at
    fp32's distance can read 1.1e-5 from it (PERF.md §7)."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = q_scale * _randn(B, S, H, D), _randn(B, T, KV, D), _randn(B, T, KV, D)
    before = _variants()
    assert _rel(flash_attention(q, k, v, causal=causal),
                _attention_fp64(q, k, v, causal)) <= 1e-5
    # (element type 0 = fp32, padded head dim, 16-byte copies)
    assert _variants_since(before) == {"flash_attention": {(0, _padded(D), 16): 1}}


@pytest.mark.parametrize("B,S,T,H,KV,D,causal", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, B, S, T, H, KV, D, causal):
    _flash_case(B, S, T, H, KV, D, causal)


@pytest.mark.parametrize("B,S,T,H,KV,D,causal", [(2, 1000, 1000, 12, 12, 64, True),
                                                 (2, 77, 200, 6, 3, 128, False),
                                                 (1, 300, 300, 8, 1, 192, True),
                                                 (1, 77, 200, 4, 2, 256, False)])
def test_flash_attention_kernel_with_large_scores(cuda_device, B, S, T, H, KV, D, causal):
    """q scaled by 8: scores of tens, so the running max moves often and
    alpha = exp(m_old - m_new) rescales the carried output hard."""
    _flash_case(B, S, T, H, KV, D, causal, q_scale=8.0)


def test_flash_attention_kernel_with_unaligned_operands(cuda_device):
    """Operands one float past a 16-byte boundary: the 4-byte copies and
    scalar stores."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _shifted(1, 2, 70, 4, 36), _shifted(1, 2, 90, 2, 36), _shifted(1, 2, 90, 2, 36)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = _variants()
    assert _rel(flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)) <= 1e-5
    assert _variants_since(before) == {"flash_attention": {(0, 64, 4): 1}}


def _shifted(offset, *shape, dtype=torch.float32):
    """A contiguous tensor ``offset`` elements past an allocation's start."""
    n = 1
    for s in shape:
        n *= s
    return _randn(n + offset).to(dtype)[offset:].view(*shape)


# 16-bit instantiations (bf16, fp16): fp32 inside (scores, online softmax, P,
# accumulator), one rounding at the store.  The kernel is held to its plain
# version's fp32 output before that version rounds it (flash_attention_ref
# on the inputs' fp32 values: the same fp32 arithmetic in another order):
# one rounding apart, at most half a step, 2^-8 (1 - 2^-8) of the largest
# entry in bf16 and 2^-11 (1 - 2^-11) in fp16, plus the fp32 difference of
# the two orders (1e-5): within 2^-8 in bf16 (its slack 2^-16 covers 1e-5)
# and 2^-11 + 1e-5 in fp16 (chip_smoke.py's TOL_FLASH_16).  The two rounded
# outputs may differ by a whole step where their fp32 values straddle a
# rounding boundary, so they are not compared with each other.  And to the
# fp64 result: no farther than the plain version (rounded to the same
# dtype) plus that one rounding.
# (B, S, T, H, KV, D, causal): the heads of chatglm3-6b (32 over 2 kv
# heads, D = 128), starcoder2-7b (36 over 4) and qwen1.5-4b (20, MHA) at a
# shorter sequence; a short query, not causal; D = 20 (D % 8 == 4: 8-byte
# copies); a tiny ragged one; ragged S and T at D = 64; nemotron-4-340b's
# heads (96 over 8, D = 192); D = 256 with a short query; D = 200 (padded
# to 256) not causal; D = 132 (padded to 192; 8-byte copies); the heads of
# dbrx-132b (48 over 8, group 6) and llama4-maverick-400b (40 over 8, group
# 5) at D = 128; the last families' inputs at a shorter sequence:
# zamba2-1.2b's shared block (32 heads of 64, MHA), llama-3.2-vision-11b's
# self-attention (32 over 8), its cross-attention (not causal, S != T, the
# image tokens ragged against the kv tile) and its decode's (one query over
# the image tokens), hubert-xlarge's (16 heads of 80, padded to 128, not
# causal).
FLASH_LOW_SHAPES = [(2, 256, 256, 32, 2, 128, True), (2, 200, 200, 36, 4, 128, True),
                    (1, 130, 130, 20, 20, 128, True), (2, 100, 300, 8, 2, 32, False),
                    (2, 130, 130, 4, 2, 20, True), (1, 5, 9, 2, 1, 8, True),
                    (2, 77, 200, 6, 3, 64, True), (1, 300, 300, 96, 8, 192, True),
                    (2, 100, 260, 4, 2, 256, True), (1, 77, 200, 6, 3, 200, False),
                    (2, 90, 130, 4, 1, 132, True), (2, 256, 256, 48, 8, 128, True),
                    (2, 200, 200, 40, 8, 128, True), (2, 256, 256, 32, 32, 64, True),
                    (2, 256, 256, 32, 8, 128, True), (2, 256, 201, 32, 8, 128, False),
                    (4, 1, 201, 32, 8, 128, False), (2, 256, 256, 16, 16, 80, False)]
# (dtype, the element-type code the C entry reports, the bound against the
# unrounded plain output relative to its largest entry)
LOW_DTYPES = [(torch.bfloat16, 1, 2.0 ** -8), (torch.float16, 2, 2.0 ** -11 + 1e-5)]


def _flash_low_case(q, k, v, causal, code, bound, cw):
    from repro_torch.kernels.flash_attention import flash_attention

    before = _variants()
    out = flash_attention(q, k, v, causal=causal)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    unrounded = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    exact = _attention_fp64(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype
    one = bound * float(unrounded.abs().max())
    assert float((out.float() - unrounded).abs().max()) <= one
    assert (float((out.double() - exact).abs().max())
            <= float((plain.double() - exact).abs().max()) + one)
    D = q.shape[-1]
    assert _variants_since(before) == {"flash_attention": {(code, _padded(D), cw): 1}}


@pytest.mark.parametrize("dtype,code,bound", LOW_DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("B,S,T,H,KV,D,causal", FLASH_LOW_SHAPES)
def test_flash_attention_16bit_kernel_matches_plain(cuda_device, B, S, T, H, KV, D, causal,
                                                     dtype, code, bound):
    q, k, v = (x.to(dtype) for x in (_randn(B, S, H, D), _randn(B, T, KV, D),
                                     _randn(B, T, KV, D)))
    _flash_low_case(q, k, v, causal, code, bound, 16 if D % 8 == 0 else 8)


@pytest.mark.parametrize("dtype,code,bound", LOW_DTYPES, ids=["bf16", "fp16"])
@pytest.mark.parametrize("offset,cw", [(2, 4), (4, 8)])
def test_flash_attention_16bit_kernel_with_unaligned_operands(cuda_device, dtype, code, bound,
                                                              offset, cw):
    """16-bit operands 4 or 8 bytes past a 16-byte boundary: 4- and 8-byte
    copies."""
    q = _shifted(offset, 2, 70, 4, 64, dtype=dtype)
    k, v = _shifted(offset, 2, 90, 2, 64, dtype=dtype), _shifted(offset, 2, 90, 2, 64,
                                                                 dtype=dtype)
    assert q.data_ptr() % 16 and q.is_contiguous()
    _flash_low_case(q, k, v, True, code, bound, cw)


# (B, S, H, P, N, chunk, bf16 x): mamba2-370m's prefill, the ragged fp32
# case, the smoke sizes with a ragged tail, a chunk longer than S; then the
# edges of the kernel's tiling (blocks of 32 columns of P, or of 64 when
# B * H * ceil(P / 64) > 66; 64-deep slices of the chunk and of N; 16-row
# warp tiles; 16-byte copies where rows allow): P = 24 and 40, not a
# multiple of the 32-column split; N = 20 (a partial slice) and N = 18
# (N % 4 != 0: 4-byte copies of b and c); chunks 40 and 8, not multiples of
# 16; P = 20 in bf16 and P = 17 in fp32, whose rows of x allow no 16-byte
# copy (and odd P no 8-byte store of y); fp32 x at chunk 128; the 64-column
# blocks with P = 40 and 24 (the second warp column partial or empty) and
# with fp32 x at chunk 128; a ragged last chunk in the last batch row in
# most; zamba2-1.2b's widths (64 heads of P = 64, N = 64, chunk 64) at a
# ragged shorter sequence.
SSD_SHAPES = [(4, 4096, 32, 64, 128, 128, True), (2, 4000, 32, 64, 128, 64, False),
              (2, 60, 8, 16, 16, 16, False), (1, 7, 2, 8, 4, 16, True),
              (2, 300, 4, 24, 64, 64, True), (2, 300, 4, 40, 64, 64, False),
              (2, 200, 4, 64, 20, 64, True), (2, 200, 4, 64, 18, 64, False),
              (2, 250, 4, 32, 32, 40, True), (1, 50, 2, 8, 8, 8, False),
              (2, 130, 3, 20, 24, 32, True), (1, 100, 2, 17, 16, 32, False),
              (3, 1000, 4, 64, 128, 128, True), (2, 520, 8, 64, 128, 128, False),
              (1, 200, 68, 40, 64, 64, False), (2, 130, 40, 24, 20, 32, True),
              (1, 300, 70, 64, 128, 128, False), (2, 300, 64, 64, 64, 64, True)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,bf16", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda_device, B, S, H, P, N, chunk, bf16):
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_scan

    x = _randn(B, S, H, P)
    if bf16:
        x = x.to(torch.bfloat16)
    dt = F.softplus(_randn(B, S, H) - 1.0)
    a = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
    b, c = _randn(B, S, N), _randn(B, S, N)
    before = build.LAUNCHES["ssd_scan"]
    y, state = ssd_scan(x, dt, a, b, c, chunk=chunk)
    ch = min(chunk, S)
    want_y, want_state = ref.ssd_chunked_scan_ref(x, dt, ref.ssd_chunk_cumsum(dt, a, ch),
                                                  b, c, ch)
    assert _rel(y, want_y) <= 1e-4
    assert _rel(state, want_state) <= 1e-4
    assert build.LAUNCHES["ssd_scan"] == before + 1


def test_serving_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    q, k = _randn(1, 8, 2, 16), _randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError):  # mixed dtypes
        flash_attention(q.half(), k, k)
    with pytest.raises(NotImplementedError):
        flash_attention(q.bfloat16(), k.half(), k.half())
    with pytest.raises(NotImplementedError):  # float64: not an instantiation
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="4-byte"):  # one bf16 past a 4-byte boundary
        odd = _shifted(1, 1, 8, 2, 16, dtype=torch.bfloat16)
        flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="head dim"):  # above the 256 tier
        big = _randn(1, 8, 2, 260)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="head dim"):  # D % 4 != 0
        odd_d = _randn(1, 8, 2, 198)
        flash_attention(odd_d, odd_d, odd_d)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="is on cpu"):  # k and v left on the CPU
        flash_attention(q, k.cpu(), k.cpu())
    x, dt, a, bc = _randn(1, 16, 2, 8), _randn(1, 16, 2).abs(), -torch.ones(2, device="cuda"), \
        _randn(1, 16, 4)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, a, bc, bc, chunk=8)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, bc, bc, chunk=8)
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_scan(x, dt, a, bc.cpu(), bc.cpu(), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(_randn(1, 300, 2, 8), _randn(1, 300, 2).abs(), a, _randn(1, 300, 4),
                 _randn(1, 300, 4), chunk=256)


def _planted(L, m, n, rank=8, seed=0):
    """(L, m, n) on the CPU: a rank-``rank`` signal above a noise floor, so
    the top-``rank`` subspace is separated by a gap and both devices' SVDs
    find the same one (on a flat spectrum a rounding-level difference
    turns it)."""
    gen = torch.Generator().manual_seed(L * m * n + seed)
    u, v = torch.randn(L, m, rank, generator=gen), torch.randn(L, rank, n, generator=gen)
    s = torch.linspace(6.0, 4.0, rank)
    return (u * s) @ v / (m * n) ** 0.5 + 0.05 * torch.randn(L, m, n, generator=gen)


@pytest.mark.parametrize("kind", ["svd", "subspace", "rsvd", "random", "grass"])
def test_projectors_on_the_card_match_the_cpu(cuda_device, kind):
    """Every projector kind on the card, with the default noise (drawn on
    the host, so both devices see the same numbers): P Pᵀ within 1e-5 of
    the CPU's, PᵀP = I within 1e-5 (Property I), both sides."""
    from repro_torch.core.lowrank_common import compute_projectors

    for shape, side in [((3, 96, 160), "left"), ((3, 160, 96), "right"),
                        ((2, 768, 768), "left")]:
        g = _planted(*shape)
        p = compute_projectors(kind, g.cuda(), 8, side, key=(0, 1, 2))
        q = compute_projectors(kind, g, 8, side, key=(0, 1, 2))
        assert p.device.type == "cuda"
        torch.testing.assert_close((p @ p.mT).cpu(), q @ q.mT, rtol=0, atol=1e-5)
        eye = torch.eye(8, device="cuda").expand(shape[0], 8, 8)
        torch.testing.assert_close(p.mT @ p, eye, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["sgdm", "muon", "golore", "fira", "lisa",
                                  "unbiased_galore_adam"])
def test_optimizer_step_on_the_card_matches_the_cpu(cuda_device, name):
    """Two steps of each optimizer on a three-leaf tree on the card and on
    the CPU (plain versions), same planted gradients: the second step's
    updates within 1e-4.  Not the first: Adam's first step is
    g / (|g| + eps), a sign function, which turns a rounding-level
    difference at an entry near zero into one of 2."""
    from repro_torch.core import OptimizerConfig, build_optimizer

    cpu = {"blocks/w_out": _planted(3, 96, 64), "blocks/wq": _planted(3, 64, 96),
           "embed": _planted(1, 50, 64)[0]}
    grads = [{k: _planted(*((1,) * (3 - v.dim()) + tuple(v.shape)), seed=i + 1).reshape(v.shape)
              for k, v in cpu.items()} for i in range(2)]
    opt = build_optimizer(OptimizerConfig(name=name, lr=1e-2, rank=8, gamma=1, period=2,
                                          base="sgdm"))
    card = {k: v.cuda() for k, v in cpu.items()}
    s_cpu, s_card = opt.init(cpu), opt.init(card)
    for g in grads:
        want, s_cpu = opt.update(g, s_cpu, cpu)
        got, s_card = opt.update({k: v.cuda() for k, v in g.items()}, s_card, card)
    for k in cpu:
        assert got[k].device.type == "cuda"
        assert float((got[k].cpu() - want[k]).norm() / want[k].norm()) <= 1e-4, k


@pytest.mark.parametrize("shape,side", [((12, 768, 2048), "left"), ((4, 2048, 768), "right"),
                                        ((3, 160, 96), "right")])
def test_spectrum_probe_on_the_card_matches_the_cpu(cuda_device, shape, side):
    """The rank policy's spectrum probe on the card (PᵀG by the projection
    kernel, the Gram by cuBLAS, ``eigvalsh`` by cuSOLVER) against the same
    probe on the CPU with the same projector: ``sv2`` sum and ``g2`` within
    1e-4 relative, ``mn`` exact; one projection launch."""
    from repro_torch.core.combinators import _spectrum_probe
    from repro_torch.core.lowrank_common import compute_projectors, family_shape

    g = _planted(*shape)
    fs = family_shape(g, 256)
    p = compute_projectors("svd", g.cuda(), fs.rank, side)
    before = build.LAUNCHES["lowrank_update"]
    got = _spectrum_probe(p, g.cuda(), fs, "auto", 0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lowrank_update"] == before + 1
    want = _spectrum_probe(p.cpu(), g, fs, "auto", 0)
    assert list(got) == ["g2", "mn", "sv2"] and got["sv2"].device.type == "cuda"
    assert torch.equal(got["mn"].cpu(), want["mn"])
    for key in ("g2", "sv2"):
        a, b = float(got[key].sum()), float(want[key].sum())
        assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)


def test_migrate_opt_state_keeps_each_tensor_on_the_card(cuda_device):
    """A rank migration of a GUM state on the card: every truncated or
    padded tensor stays on its device in the template's dtype, carried
    leaves are the same objects, and the Python count is carried."""
    from repro_torch.core import RankMap, build_optimizer, find_lowrank_states
    from repro_torch.core import OptimizerConfig, migrate_opt_state
    from repro_torch.checkpoint.manager import flatten_with_paths

    params = {"blocks/w_out": _planted(3, 96, 64).cuda(),
              "blocks/wq": _planted(3, 64, 96).cuda(), "embed": _planted(1, 50, 64)[0].cuda()}
    cfg = OptimizerConfig(name="gum", lr=1e-2, rank=16, gamma=1, period=2)
    hi, lo = build_optimizer(cfg, rank_map=RankMap(16)), build_optimizer(cfg, rank_map=RankMap(8))
    state = hi.init(params)
    _, state = hi.update({k: torch.randn_like(v) for k, v in params.items()}, state, params)
    mig = migrate_opt_state(state, lo.init(params))
    old, tmpl = dict(flatten_with_paths(state)), dict(flatten_with_paths(lo.init(params)))
    for path, x in flatten_with_paths(mig):
        if not isinstance(x, torch.Tensor):
            assert x == old[path], path
            continue
        assert x.device == old[path].device and x.dtype == tmpl[path].dtype, path
        assert x.shape == tmpl[path].shape, path
        if x.shape == old[path].shape:
            assert x is old[path], path
    assert find_lowrank_states(mig)[0].count == 1


# ------------------------------------------------------------ the MoE layer


def _moe_inputs(arch, dtype, ties):
    """Layer 0's MoE parameters of the SMOKE model (seeded init, on the CPU)
    and x (2, 64, d) in ``dtype``; with ``ties`` router column 1 equals
    column 0, x's tokens come in equal pairs and move along that column, so
    both top-k choices tie and the capacity choice is made by index."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    model.init_params(0)
    p = {k: v.detach()[0].clone() for k, v in model.moe_blocks.moe.named_parameters()}
    x = _randn(2, 64, cfg.d_model).cpu()
    if ties:
        p["router"][:, 1] = p["router"][:, 0]
        x[:, 1::2] = x[:, 0::2]
        col = p["router"][:, 0]
        x = x + 8.0 * col / (col @ col)
    return cfg, p, x.to(dtype)


def _fro(a, b) -> float:
    return float(torch.linalg.vector_norm((a.double() - b.double()).flatten())
                 / torch.linalg.vector_norm(b.double().flatten()))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_layer_matches_cpu_and_repeats_bitwise(cuda_device, arch, dtype, ties):
    """The expert layer on the card against the CPU on the same inputs: in
    fp32 the same routing (ties to the lower index on both) and the output
    within 1e-5 of its largest entry (fp32 GEMMs summed in another order);
    in bf16, routed as the CPU routes, no farther from the CPU's bf16 output
    (Frobenius) than that lies from the CPU's fp32 output on the same
    routing.  Two calls on the card give the same bits (the combine adds
    each token's rows in a fixed order, no atomics)."""
    from repro_torch.models import moe

    cfg, p, x = _moe_inputs(arch, dtype, ties)
    pc = {k: v.cuda() for k, v in p.items()}
    with moe.record_routing() as cpu_log:
        want, want_aux = moe.apply_moe(p, x, cfg)
    with moe.record_routing() as card_log:
        out, aux = moe.apply_moe(pc, x.cuda(), cfg)
    again, again_aux = moe.apply_moe(pc, x.cuda(), cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(aux, again_aux)
    if ties:
        for log in (cpu_log, card_log):
            topi, g_idx, kept = log.calls[0]
            assert (topi[..., 0] == 0).all() and not kept.all()
            assert torch.equal(g_idx[:, 0].cpu(), torch.arange(g_idx.shape[-1]).expand(
                g_idx.shape[0], -1))
    if dtype == torch.float32:
        assert moe.flips(cpu_log, card_log) == [0]
        for a, b in zip(card_log.calls[0], cpu_log.calls[0]):
            assert torch.equal(a.cpu(), b)
        assert _rel(out.cpu(), want) <= 1e-5
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
        return
    with moe.replay_routing(cpu_log):
        pinned, _ = moe.apply_moe(pc, x.cuda(), cfg)
    with moe.replay_routing(cpu_log):
        fp32, _ = moe.apply_moe(p, x.float(), cfg)
    assert pinned.dtype == torch.bfloat16
    assert _fro(pinned.cpu(), want) <= _fro(want, fp32)


def test_snapshot_round_trips_cuda_state_bitwise(cuda_device):
    """A ``SnapshotRing`` snapshot of a GUM state on the card (after one
    refresh step: projectors, momenta, the int step count) comes back to the
    card bitwise, and a restored tree aliases neither the live tensors (the
    step updates those in place) nor the ring's host copy."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.resilience import SnapshotRing

    params = {"blocks/attn/wq": _randn(2, 64, 96), "embed/embedding": _randn(256, 64)}
    opt = build_optimizer(OptimizerConfig(name="gum", rank=8, gamma=1, period=3))
    state = opt.init(params)
    _, state = opt.update({k: _randn(*p.shape) for k, p in params.items()}, state, params)
    want = [(path, x.clone() if torch.is_tensor(x) else x)
            for path, x in flatten_with_paths((params, state))]
    ring = SnapshotRing(2)
    ring.add(1, params, state)
    for x in (params["blocks/attn/wq"], params["embed/embedding"]):
        x.add_(1.0)
    got = ring.restore(ring.latest(), cuda_device)
    flat = flatten_with_paths(got)
    assert [p for p, _ in flat] == [p for p, _ in want]
    for (path, x), (_, y) in zip(flat, want):
        if torch.is_tensor(y):
            assert x.device.type == "cuda" and torch.equal(x, y), path
        else:
            assert x == y, path
    got[0]["blocks/attn/wq"].zero_()
    again = ring.restore(ring.latest(), cuda_device)
    assert torch.equal(again[0]["blocks/attn/wq"], want[0][1])


def test_telemetry_update_is_bitwise_and_probes_match_the_cpu(cuda_device):
    """One GUM update (a refresh) with ``OptimizerConfig(telemetry=True)`` on
    the card: bitwise the update with it off; its family metrics (energy,
    drift, the sampled bias) within 1e-5 of the same update's on the CPU;
    and the spectrum probe's extra row-2 launch per leaf is in
    ``build.VARIANTS``."""
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.telemetry import lowrank_family_metrics

    params = {"blocks/attn/wq": _randn(2, 64, 96), "blocks/mlp/w_down": _randn(2, 160, 64)}
    grads = {k: _randn(*p.shape) for k, p in params.items()}

    def update(telemetry, device):
        opt = build_optimizer(OptimizerConfig(name="gum", rank=8, gamma=1, period=3,
                                              telemetry=telemetry))
        p = {k: v.to(device) for k, v in params.items()}
        before = _variants()
        u, state = opt.update({k: v.to(device) for k, v in grads.items()}, opt.init(p), p)
        torch.cuda.synchronize()
        return u, state, _variants_since(before)

    off, _, ran_off = update(False, "cuda")
    on, state, ran_on = update(True, "cuda")
    for k in off:
        assert torch.equal(off[k], on[k]), k
    extra = {key: n - ran_off["lowrank_update"].get(key, 0)
             for key, n in ran_on["lowrank_update"].items()}
    assert sum(extra.values()) == len(params)  # one probe projection a leaf
    assert {k: v for k, v in ran_on.items() if k != "lowrank_update"} == \
        {k: v for k, v in ran_off.items() if k != "lowrank_update"}
    got = lowrank_family_metrics(state)
    _, cpu_state, _ = update(True, "cpu")
    want = lowrank_family_metrics(cpu_state)
    assert [r["family"] for r in got] == [r["family"] for r in want] == ["64x96", "160x64"]
    for g, w in zip(got, want):
        assert (g["rank"], g["bias_step"]) == (w["rank"], w["bias_step"])
        for k in ("energy", "drift", "bias"):
            assert abs(g[k] - w[k]) <= 1e-5, (g["family"], k, g[k], w[k])


class _LocalMesh:
    """A one-rank data mesh whose all-reduce leaves its operand as it is:
    ``make_train_step(mesh=_LocalMesh(), reduce_dtype=bf16)`` is the no-mesh
    step with the gradients cast to bf16 and back."""

    axis_names = ("data",)
    shape = {"data": 1}
    data_axis = "data"

    def coordinate(self, axis):
        return 0

    def all_reduce(self, t, tag):
        return t


def test_nccl_world_one_step_is_the_bf16_cast_step(cuda_device, tmp_path):
    """One ``make_shardmap_train_step`` step of fused GUM over a world-size-1
    ``nccl`` group (its bf16 gradient all-reduce launches on the card) equals
    the no-mesh step given the same bf16 cast, bitwise."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.kernels.collective_count import record_collectives, tally
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.launch.shardmap_fsdp import make_shardmap_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg = get_smoke("llama-60m")
    opt = build_optimizer(OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=3,
                                          fuse_families=True))
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=_GEN["cuda"], device="cuda")
    init_distributed("nccl", rank=0, world_size=1, init_method=f"file://{tmp_path}/store",
                     timeout=120)
    try:
        mesh = Mesh((1,), ("data",), group=dist.group.WORLD, backend="nccl")
        runs = []
        for step_of in (lambda m: make_shardmap_train_step(m, opt, mesh),
                        lambda m: make_train_step(m, opt, mesh=_LocalMesh(),
                                                  reduce_dtype=torch.bfloat16)):
            model = build_model(cfg, device="cuda")
            model.init_params(0)
            params = model.params()
            state = opt.init({k: p.detach() for k, p in params.items()})
            with record_collectives() as log:
                _, metrics = step_of(model)(params, state, {"tokens": tokens})
            runs.append((float(metrics["loss"]), {k: p.detach().clone()
                                                  for k, p in params.items()}, tally(log)))
    finally:
        dist.destroy_process_group()
    (loss, got, counts), (want_loss, want, _) = runs
    assert counts == {"all_reduce:grad": 1, "all_reduce:loss": 1}
    assert loss == want_loss
    assert all(torch.equal(got[k], want[k]) for k in want)


AUDIT_CASES = {
    "gum": dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3),
    "gum_fused": dict(name="gum", lr=1e-3, rank=4, gamma=1, period=3, fuse_families=True),
    "galore_epilogue": dict(name="galore", lr=1e-2, rank=4, period=3, fuse_families=True,
                            fused_epilogue=True, weight_decay=0.01),
    "galore_muon": dict(name="galore_muon", lr=1e-2, rank=4, period=3),
    "fira": dict(name="fira", lr=1e-2, rank=4, period=3),
    "muon": dict(name="muon", lr=1e-2),
}


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_static_launches_equal_the_cards_launches(cuda_device, case):
    """The static audit against the card (chip_smoke.py phase 4j at the smoke
    size): one steady train step of llama-60m's SMOKE model after a refresh
    step dispatches ``expected_launches`` (held to the JAX package's model
    at the same shapes by tests/test_torch_analysis.py), and the CUDA
    kernels launch those counts times each op's kernels per call
    (``kernel_launches`` at the chain's ``ns_steps``)."""
    from repro_torch.analysis import expected_launches
    from repro_torch.analysis.launch_model import chain_ns_steps
    from repro_torch.configs import get_smoke
    from repro_torch.core import OptimizerConfig, build_optimizer
    from repro_torch.kernels import launch_count
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg = get_smoke("llama-60m")
    opt = build_optimizer(OptimizerConfig(**AUDIT_CASES[case]))
    model = build_model(cfg, device="cuda")
    model.init_params(0)
    params = model.params()
    expected, unmodeled = expected_launches(opt, build_model(cfg, device="meta").params())
    assert not unmodeled
    step = make_train_step(model, opt)
    state = opt.init({k: p.detach() for k, p in params.items()})
    tokens = [torch.randint(0, cfg.vocab, (2, 64), generator=_GEN["cuda"], device="cuda")
              for _ in range(2)]
    state, _ = step(params, state, {"tokens": tokens[0]})
    build.reset_launches()
    with launch_count.count_launches() as dispatched:
        state, metrics = step(params, state, {"tokens": tokens[1]})
    torch.cuda.synchronize()
    assert metrics["update_applied"]
    assert dict(dispatched) == expected
    assert {k: v for k, v in build.LAUNCHES.items() if v} == \
        launch_count.kernel_launches(expected, chain_ns_steps(opt))


def test_sharded_audit_on_the_card_is_clean(cuda_device):
    """``audit_sharded`` at ``data=8`` on a fake process group with the two
    steps of rank 0 on the card, per leaf and with ``shard_state``: clean,
    one bf16 gradient and one loss all-reduce a step (plus the update
    all-gather under ``shard_state``), the parameters written in place."""
    from repro_torch.analysis import audit_sharded
    from repro_torch.core import OptimizerConfig

    for kw in ({}, {"fuse_families": True, "shard_state": True}):
        rep = audit_sharded(OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=3,
                                            **kw), mesh_axes=(("data", 8),), device="cuda")
        assert rep.ok, [f.format() for f in rep.errors]
        want = "3 [all_gather=1, all_reduce=2]" if kw else "2 [all_reduce=2]"
        assert rep.summary["collectives"] == want
        assert rep.summary["buffers"]["params_in_place"] == rep.summary["buffers"]["params"]


def test_bf16_stored_mamba2_training_matches_the_cpu(cuda_device, tmp_path):
    """Two GUM steps of the port's ``Trainer`` on mamba2-370m's SMOKE model
    stored in bf16 (every leaf of two or more dims, the stacked Mamba
    vectors included), on the card and on the CPU from the same parameters:
    finite losses, rows 1-2 launched on the card, the optimizer state fp32,
    and every parameter leaf within 2^-8 of the CPU's in relative Frobenius
    distance (``chip_smoke.py``'s TOL_BF16_LEAF: both devices round each
    update into bf16, an ulp apart where their fp32 updates straddle a
    rounding boundary)."""
    from repro_torch.configs import RunConfig, get_smoke
    from repro_torch.core import OptimizerConfig, find_lowrank_states
    from repro_torch.core.api import tree_leaves
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import Trainer

    cfg = get_smoke("mamba2-370m").replace(param_dtype="bfloat16")
    init = build_model(cfg, device="cpu")
    init.init_params(0)
    params = {k: v.detach() for k, v in init.params().items()}
    assert {str(p.dtype) for p in params.values()} == {"torch.bfloat16", "torch.float32"}
    out = {}
    for device in ("cpu", "cuda"):
        before = build.LAUNCHES["lowrank_update"]
        trainer = Trainer(build_model(cfg, device=device),
                          OptimizerConfig(name="gum", lr=1e-3, rank=4, gamma=1, period=2),
                          RunConfig(steps=2, log_every=0, seed=0, ckpt_dir=str(tmp_path / device)),
                          DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0),
                          device=device, params=params)
        losses = trainer.train().losses
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses), (device, losses)
        assert (build.LAUNCHES["lowrank_update"] > before) == (device == "cuda")
        for low in find_lowrank_states(trainer.opt_state):
            assert all(x.dtype != torch.bfloat16 for x in tree_leaves(low)
                       if isinstance(x, torch.Tensor))
        out[device] = {k: p.detach().cpu() for k, p in trainer.model.params().items()}
    for k, p in out["cuda"].items():
        want = out["cpu"][k]
        assert p.dtype == want.dtype, k
        dist = float(torch.linalg.vector_norm(p.float() - want.float())
                     / torch.linalg.vector_norm(want.float()))
        assert dist <= 2.0 ** -8, (k, dist)


@pytest.mark.parametrize("cut,side", [("row", "left"), ("col", "left"), ("row", "right"),
                                      ("col", "right")])
def test_cut_epilogue_records_its_variant(cuda_device, cut, side):
    """Row 6 on split parameters (``shard_params``): a :class:`PendingBack`
    materialized under ``param_parts`` launches once on its cut operands
    (P's or S's rows, S's columns) with the rank's part of a bf16 W, equals
    the plain version's whole update cut to that part, and records the
    bf16-W instantiation of that launch in ``build.VARIANTS``."""
    from types import SimpleNamespace

    from repro_torch.core.combinators import PendingBack, materialize_pending, param_parts
    from repro_torch.sharding import RowSplit

    L, m, r, n = 4, 256, 32, 384
    p = _randn(L, m if side == "left" else n, r)
    s = _randn(*((L, r, n) if side == "left" else (L, m, r)))
    w = _randn(L, m, n).to(torch.bfloat16)
    rule = RowSplit(1, 2, 1 if cut == "row" else 2)
    part = rule.apply(w)
    leaf = PendingBack(p, s, torch.empty(L, m, n, device="meta"),
                       SimpleNamespace(side=side, lead=(L,)), "cuda", scale=-0.0025,
                       decay=-2.5e-5)
    a, b = (p, s) if side == "left" else (s, p.mT)
    before, launches = _variants(), build.LAUNCHES["back_project_epilogue"]
    with param_parts({"w": (part, rule)}):
        got = materialize_pending({"w": leaf})["w"]
    assert build.LAUNCHES["back_project_epilogue"] == launches + 1
    assert got.shape == part.shape
    assert _rel(got, rule.apply(ref.back_project_epilogue_ref(a, b, w, -0.0025, -2.5e-5))) <= 1e-5
    new = _variants_since(before)
    assert list(new) == ["back_project_epilogue"]
    assert [(key[4], k) for key, k in new["back_project_epilogue"].items()] == [(1, 1)]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_model_axis_cut_epilogue_records_its_variant(cuda_device, side, w_dtype):
    """Row 6 under tensor parallelism with split parameters: a leaf cut over
    both mesh axes (rows over ``data``, columns over ``model``, a
    ``GridSplit``) materializes in one launch on operands cut on both sides,
    equals the plain version's whole update cut to that block, and records
    the instantiation of its W (fifth template argument 1 for bf16, 0 for
    fp32)."""
    from types import SimpleNamespace

    from repro_torch.core.combinators import PendingBack, materialize_pending, param_parts
    from repro_torch.sharding import GridSplit, RowSplit

    L, m, r, n = 4, 256, 32, 384
    p = _randn(L, m if side == "left" else n, r)
    s = _randn(*((L, r, n) if side == "left" else (L, m, r)))
    w = _randn(L, m, n).to(getattr(torch, w_dtype))
    rule = GridSplit((RowSplit(1, 2, 1), RowSplit(0, 2, 2)))
    part = rule.apply(w)
    leaf = PendingBack(p, s, torch.empty(L, m, n, device="meta"),
                       SimpleNamespace(side=side, lead=(L,)), "cuda", scale=-0.0025,
                       decay=-2.5e-5)
    a, b = (p, s) if side == "left" else (s, p.mT)
    before, launches = _variants(), build.LAUNCHES["back_project_epilogue"]
    with param_parts({"w": (part, rule)}):
        got = materialize_pending({"w": leaf})["w"]
    assert build.LAUNCHES["back_project_epilogue"] == launches + 1
    assert got.shape == part.shape == (L, m // 2, n // 2)
    assert _rel(got, rule.apply(ref.back_project_epilogue_ref(a, b, w, -0.0025, -2.5e-5))) <= 1e-5
    new = _variants_since(before)
    assert list(new) == ["back_project_epilogue"]
    bf16 = int(w_dtype == "bfloat16")
    assert [(key[4], k) for key, k in new["back_project_epilogue"].items()] == [(bf16, 1)]
