"""The port's Mamba-2 SSD ops and block against the JAX package's, on
identical inputs.

* ``ops.ssd`` at impl="pallas" (the SSD scan, kernel row 8; on the CPU its
  wrapper runs the plain version) against ``repro``'s Pallas kernel in
  interpret mode plus the skip, fp32 and bf16 x;
* ``ssd_chunked_ref`` on a ragged length (zero-padded tail) against the
  sequential ``ssd_ref``, both the port's and the reference's;
* ``ssd_decode_ref`` against the reference's;
* one Mamba block's forward (at "xla" and at the kernel impl) and its
  one-token decode against ``repro.models.mamba2``, with the reference's
  own initial parameters.

Tolerance: 1e-4 of each output's largest entry in fp32 (the chunked and the
sequential forms sum in other orders through exponentials of cumulative
sums); bf16 outputs 2^-7 (one bf16 rounding either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import mamba2 as j_mamba2
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2
from torch_threads import _one_thread  # noqa: F401  (autouse)


TOL = 1e-4
TOL_BF16 = 2.0 ** -7


def _close(got: torch.Tensor, want, tol=TOL, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()), err_msg=name)


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, np.log(16.0), H)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 32, 3, 8, 16, 8), (1, 48, 2, 16, 16, 16),
                                             (2, 16, 4, 4, 8, 16)])
def test_ssd_scan_matches_pallas_interpret(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N)
    jy, js = j_ops.ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk, impl="interpret")
    y, state = ops.ssd(*_t(arrs), chunk=chunk, impl="pallas")
    _close(y, jy, name="y")
    _close(state, js, name="state")
    # the "xla" impl is the plain chunked version in both packages
    y, state = ops.ssd(*_t(arrs), chunk=chunk, impl="xla")
    _close(y, jy, name="y xla")
    _close(state, js, name="state xla")


def test_ssd_scan_bf16_x_matches_pallas_interpret():
    x, dt, a, b, c, d = _inputs(2, 32, 3, 8, 16, seed=1)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, js = j_ops.ssd(jx, *(jnp.asarray(t) for t in (dt, a, b, c, d)), chunk=8,
                       impl="interpret")
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    y, state = ops.ssd(tx, *_t((dt, a, b, c, d)), chunk=8, impl="pallas")
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(y, jy, TOL_BF16, "y bf16")
    _close(state, js, name="state")


@pytest.mark.parametrize("S,chunk", [(45, 16), (7, 16), (64, 16)])
def test_ssd_chunked_ref_matches_sequential(S, chunk):
    arrs = _inputs(2, S, 3, 4, 8, seed=2)
    y, state = ref.ssd_chunked_ref(*_t(arrs), chunk=chunk)
    ys, ss = ref.ssd_ref(*_t(arrs))
    jy, js = j_ref.ssd_ref(*(jnp.asarray(a) for a in arrs))
    _close(ys, jy, name="ssd_ref y")
    _close(ss, js, name="ssd_ref state")
    _close(y, jy, name="chunked y")
    _close(state, js, name="chunked state")
    jcy, jcs = j_ref.ssd_chunked_ref(*(jnp.asarray(a) for a in arrs), chunk)
    _close(y, jcy, name="chunked y vs reference chunked")
    _close(state, jcs, name="chunked state vs reference chunked")


def test_ssd_decode_ref_matches_reference():
    rng = np.random.default_rng(3)
    B, H, P, N = 2, 3, 4, 8
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, H))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b, c = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal(H).astype(np.float32)
    arrs = (state, x, dt, a, b, c, d)
    jy, js = j_ref.ssd_decode_ref(*(jnp.asarray(t) for t in arrs))
    y, s = ops.ssd_decode_step(*_t(arrs))
    _close(y, jy, name="y")
    _close(s, js, name="state")


@pytest.fixture(scope="module")
def block():
    jcfg = j_get_smoke("mamba2-370m")
    jp = jax.device_get(j_mamba2.init_mamba_block(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("impl,j_impl", [("xla", "xla"), ("pallas", "interpret")])
def test_mamba_block_forward_matches_reference(block, impl, j_impl):
    jcfg, jp, p = block
    cfg = get_smoke("mamba2-370m")
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = j_mamba2.apply_mamba_block(jp, jnp.asarray(x), jcfg.replace(attn_impl=j_impl))
    got = mamba2.apply_mamba_block(p, torch.from_numpy(x), cfg.replace(attn_impl=impl))
    _close(got, want, name=impl)


def test_mamba_block_decode_matches_reference(block):
    jcfg, jp, p = block
    cfg = get_smoke("mamba2-370m")
    rng = np.random.default_rng(5)
    jcache = j_mamba2.init_mamba_cache(jcfg, 2)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jcache.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, wcache = j_mamba2.decode_mamba_block(jp, jnp.asarray(x), jcache, jcfg)
    got, conv, ssm = mamba2.decode_mamba_block(p, torch.from_numpy(x),
                                               torch.from_numpy(jcache["conv"]),
                                               torch.from_numpy(jcache["ssm"]), cfg)
    _close(got, want, name="out")
    _close(conv, wcache["conv"], name="conv")
    _close(ssm, wcache["ssm"], name="ssm")
