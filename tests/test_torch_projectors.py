"""The port's projectors against the live JAX reference
(``repro.core.lowrank_common.compute_projectors``): every kind, at lead
shapes (), (3,) and (2, 3), on both sides, with the reference's own random
draws injected through ``noise``, so both packages see the same Ω, Z and
Gumbel numbers.

Each block is a planted rank-4 signal above a noise floor (numpy, seeded),
so its top-4 subspace is separated by a gap.  svd, subspace, rsvd and
random are compared as ``P Pᵀ`` (QR and SVD column signs are free; atol
1e-5), grass exactly (one-hot columns in score order).  Property I,
``PᵀP = I`` within 1e-5, holds for every kind with the port's default
draws — the port of ``tests/test_unbiasedness.py``'s Property I check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lowrank_common import compute_projectors as j_compute_projectors
from repro.core.projectors import make_projector as j_make_projector
from repro.core.projectors import projection_side as j_projection_side
from repro_torch.core import projectors
from repro_torch.core.lowrank_common import compute_projectors
from torch_threads import _one_thread  # noqa: F401  (autouse)


KINDS = ["svd", "subspace", "rsvd", "random", "grass"]
RANK = 4
JKEY = jax.random.PRNGKey(3)


def jax_noise(key, kind, shape):
    """The reference's draw under JKEY (every call of these tests uses one key)."""
    draw = {"normal": jax.random.normal, "gumbel": jax.random.gumbel,
            "uniform": jax.random.uniform}[kind]
    return torch.from_numpy(np.array(draw(JKEY, shape)))


def planted(rng, lead, m, n):
    u = rng.standard_normal(lead + (m, RANK))
    v = rng.standard_normal(lead + (RANK, n))
    g = np.einsum("...mk,k,...kn->...mn", u, np.array([5.3, 5.1, 4.9, 4.7]), v)
    return (g / np.sqrt(m * n) + 0.05 * rng.standard_normal(lead + (m, n))).astype(np.float32)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["lead0", "lead1", "lead2"])
@pytest.mark.parametrize("kind", KINDS)
def test_projectors_match_reference(kind, lead, side):
    m, n = (12, 20) if side == "left" else (20, 12)
    g = planted(np.random.default_rng(0), lead, m, n)
    want = np.asarray(j_compute_projectors(kind, jnp.asarray(g), RANK, JKEY, side))
    got = compute_projectors(kind, torch.from_numpy(g), RANK, side, key=(0, 1, 0),
                             noise=jax_noise).numpy()
    assert got.shape == want.shape == lead + (min(m, n), RANK)
    if kind == "grass":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2),
                                   want @ np.swapaxes(want, -1, -2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,rank", [((8, 12), 3), ((16, 6), 4), ((32, 32), 8)])
def test_property_i_orthonormal_columns(kind, shape, rank):
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    p = projectors.make_projector(kind, g, rank, (0, 1, 0))
    assert p.shape == (shape[0], rank)
    torch.testing.assert_close(p.mT @ p, torch.eye(rank), rtol=0, atol=1e-5)


def test_one_block_functions_match_reference():
    """``make_projector`` and the per-kind functions on one block, and
    ``projection_side``, against the reference's."""
    g = planted(np.random.default_rng(2), (), 12, 20)
    tg = torch.from_numpy(g)
    key = (0, 1, 0)
    ours = {"svd": projectors.svd_projector(tg, RANK),
            "subspace": projectors.subspace_projector(tg, RANK, key, noise=jax_noise),
            "rsvd": projectors.rsvd_projector(tg, RANK, key, noise=jax_noise),
            "random": projectors.random_projector(tuple(g.shape), RANK, key, noise=jax_noise),
            "grass": projectors.grass_projector(tg, RANK, key, noise=jax_noise)}
    for kind, p in ours.items():
        want = np.asarray(j_make_projector(kind, jnp.asarray(g), RANK, JKEY))
        got = projectors.make_projector(kind, tg, RANK, key, noise=jax_noise).numpy()
        np.testing.assert_array_equal(got, p.numpy())
        if kind == "grass":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0, atol=1e-5)
    for shape in [(3, 5), (5, 3), (4, 4)]:
        assert projectors.projection_side(shape) == j_projection_side(shape)
    with pytest.raises(ValueError):
        projectors.make_projector("qr", tg, RANK)


def test_default_noise_is_a_function_of_the_key():
    """The default draws repeat for a key and differ across keys and kinds,
    so a refresh depends on (seed, step, leaf) alone."""
    from repro_torch.core.lowrank_common import generator_noise

    a = generator_noise((0, 1, 2), "normal", (4, 3))
    assert torch.equal(a, generator_noise((0, 1, 2), "normal", (4, 3)))
    assert not torch.equal(a, generator_noise((0, 1, 3), "normal", (4, 3)))
    assert not torch.equal(a, generator_noise((0, 2, 2), "normal", (4, 3)))
    u = generator_noise((0, 1, 2), "uniform", (1000,))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    gum = generator_noise((0, 1, 2), "gumbel", (20000,))
    assert abs(float(gum.mean()) - 0.5772) < 0.05  # Euler–Mascheroni
