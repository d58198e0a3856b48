"""The port's attention ops against the JAX package's, on identical inputs.

* ``flash_attention`` (kernel row 7; on the CPU its wrapper runs the plain
  version) against ``repro``'s Pallas kernel in interpret mode: causal and
  not, GQA, and a short query (S < T, causal row offset T - S), with block
  sizes that split both axes so the reference skips masked kv blocks; and
  at the head dims the kernel pads to 192 and 256 (nemotron-4-340b's 192,
  256, and a ragged 200), in fp32, bf16 and fp16.
* ``attention_chunked_ref`` and ``decode_attention_ref`` / ``kv_len``
  against their ``repro.kernels.ref`` counterparts, and ``ops.attention`` at
  every impl.
* In bf16 and fp16: the three plain routes (``"xla"``, ``"xla_chunked"``,
  decode), which round P to v's dtype before P·V, against the reference's
  three; the kernel's plain version (``flash_attention_ref``, P in fp32)
  against the Pallas kernel in interpret mode.

Tolerance: 1e-5 of each output's largest entry in fp32 (fp32 sums in another
order; the reference's -1e30 mask and the port's -inf give the same zeros).
In bf16 and fp16 both sides sum in fp32 in another order and round once
(P, then the output), so an element is equal, or, where an fp32 sum lands on
the other side of a rounding boundary, one step apart: at most 5% of the
elements differ, each by at most one step of the dtype at the output's
largest magnitude.  (A route that kept P in fp32 where the reference rounds
it differs in about 40% of the elements.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from torch_threads import _one_thread  # noqa: F401  (autouse)


TOL = 1e-5


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()), err_msg=name)


# (torch dtype, jax dtype, fp32 mantissa bits the dtype drops)
LOW = [(torch.bfloat16, jnp.bfloat16, 16), (torch.float16, jnp.float16, 13)]


def _within_one_step(got: torch.Tensor, want, dropped: int, name=""):
    """At most 5% of ``got``'s elements differ from ``want``, each by at
    most one step of their dtype (which keeps 23 - ``dropped`` mantissa
    bits) at ``want``'s largest magnitude."""
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    step = float(np.spacing(np.abs(want).max())) * 2.0 ** dropped
    assert diff.max() <= step, (name, float(diff.max()), step)
    assert (diff > 0).mean() <= 0.05, (name, int((diff > 0).sum()), diff.size)


def _low(arrays, tdtype, jdtype):
    """fp32 numpy inputs rounded to the low dtype, for each package."""
    return ([torch.from_numpy(a).to(tdtype) for a in arrays],
            [jnp.asarray(a, dtype=jdtype) for a in arrays])


def _qkv(B, S, T, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32))


# (B, S, T, H, KV, D, causal, block_q, block_kv)
FLASH_CASES = [
    (2, 32, 32, 4, 4, 16, True, 8, 8),      # MHA, causal, masked blocks skipped
    (2, 32, 32, 4, 4, 16, False, 16, 8),    # not causal
    (1, 32, 32, 8, 2, 16, True, 8, 16),     # GQA 4:1
    (2, 16, 64, 4, 1, 32, True, 8, 16),     # S < T: row offset 48, MQA
    (1, 24, 40, 6, 3, 64, False, 8, 8),     # S < T, not causal, D = 64
]


@pytest.mark.parametrize("B,S,T,H,KV,D,causal,bq,bkv", FLASH_CASES)
def test_flash_attention_matches_pallas_interpret(B, S, T, H, KV, D, causal, bq, bkv):
    q, k, v = _qkv(B, S, T, H, KV, D)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   block_q=bq, block_kv=bkv, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(flash_attention(tq, tk, tv, causal=causal), want, "flash_attention")
    _close(ops.attention(tq, tk, tv, causal=causal, impl="pallas"), want, "ops pallas")


# Head dims above 128 (B, S, T, H, KV, D, causal, block_q, block_kv):
# nemotron-4-340b's 192 with GQA 2:1, 256 with a short query and MQA, a
# ragged 200 not causal.
WIDE_CASES = [
    (1, 32, 32, 4, 2, 192, True, 8, 16),
    (1, 16, 48, 4, 1, 256, True, 8, 16),
    (1, 24, 40, 6, 3, 200, False, 8, 8),
]


@pytest.mark.parametrize("B,S,T,H,KV,D,causal,bq,bkv", WIDE_CASES)
def test_flash_attention_wide_heads_match_pallas_interpret(B, S, T, H, KV, D, causal, bq, bkv):
    q, k, v = _qkv(B, S, T, H, KV, D, seed=9)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   block_q=bq, block_kv=bkv, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(flash_attention(tq, tk, tv, causal=causal), want, "flash_attention")


@pytest.mark.parametrize("tdtype,jdtype,dropped", LOW, ids=["bf16", "fp16"])
@pytest.mark.parametrize("B,S,T,H,KV,D,causal,bq,bkv", WIDE_CASES)
def test_flash_attention_wide_heads_low_precision_match_pallas_interpret(
        B, S, T, H, KV, D, causal, bq, bkv, tdtype, jdtype, dropped):
    (tq, tk, tv), (jq, jk, jv) = _low(_qkv(B, S, T, H, KV, D, seed=10), tdtype, jdtype)
    want = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_kv=bkv, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdtype and want.dtype == jdtype
    _within_one_step(got, want, dropped, "flash_attention")


@pytest.mark.parametrize("impl", ["xla", "xla_chunked", "pallas"])
def test_ops_attention_impls_match_reference(impl):
    q, k, v = _qkv(2, 16, 1024, 4, 2, 16, seed=1)   # T = 2 kv blocks of 512
    want = j_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla")
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)), impl=impl)
    _close(got, want, impl)


@pytest.mark.parametrize("S,T,causal", [(32, 32, True), (8, 32, True), (16, 32, False)])
def test_attention_chunked_ref_matches_reference(S, T, causal):
    q, k, v = _qkv(2, S, T, 4, 2, 8, seed=2)
    want = j_ref.attention_chunked_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, block_kv=8)
    got = ref.attention_chunked_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, block_kv=8)
    _close(got, want, "attention_chunked_ref")


def test_decode_attention_per_row_positions_match_reference():
    """One query per row over a 24-slot cache; each row at its own position,
    against the reference's scalar-position decode of that row alone."""
    q, k, v = _qkv(3, 1, 24, 4, 2, 16, seed=3)
    pos = np.array([0, 7, 23])
    got = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(pos))
    for b in range(3):
        want = j_ref.decode_attention_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                          jnp.asarray(v[b:b + 1]), jnp.int32(pos[b]))
        _close(got[b:b + 1], want, f"row {b}")
    # a scalar position applies to every row
    want = j_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(9))
    _close(ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), 9), want)


def test_attention_ref_kv_len_matches_reference():
    q, k, v = _qkv(2, 4, 12, 4, 4, 8, seed=4)
    want = j_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, kv_len=10)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, kv_len=10)
    _close(got, want, "kv_len")


def test_flash_attention_is_forward_only_and_checks_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="S <= T"):
        flash_attention(*(torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 2, 8)))
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(*(torch.from_numpy(a) for a in _qkv(1, 8, 8, 3, 2, 8)))
    with pytest.raises(ValueError, match="attn_impl"):
        ops.attention(q.detach(), k, v, impl="interpret")


@pytest.mark.parametrize("tdtype,jdtype,dropped", LOW, ids=["bf16", "fp16"])
@pytest.mark.parametrize("route", ["xla", "xla_chunked", "decode"])
def test_plain_routes_in_low_precision_match_reference(route, tdtype, jdtype, dropped):
    """The reference rounds P to v's dtype on these routes (its einsum of
    ``p.astype(v.dtype)``); so must the port."""
    if route == "decode":
        q, k, v = _qkv(2, 1, 24, 4, 2, 16, seed=5)
        (tq, tk, tv), (jq, jk, jv) = _low((q, k, v), tdtype, jdtype)
        got = ops.decode_attention(tq, tk, tv, 17)
        want = j_ref.decode_attention_ref(jq, jk, jv, jnp.int32(17))
    else:
        q, k, v = _qkv(2, 64, 1024, 4, 2, 16, seed=6)   # T = 2 kv blocks of 512
        (tq, tk, tv), (jq, jk, jv) = _low((q, k, v), tdtype, jdtype)
        got = ops.attention(tq, tk, tv, impl=route)
        want = j_ops.attention(jq, jk, jv, impl=route)
    assert got.dtype == tdtype
    _within_one_step(got, want, dropped, route)


@pytest.mark.parametrize("tdtype,jdtype,dropped", LOW, ids=["bf16", "fp16"])
@pytest.mark.parametrize("B,S,T,H,KV,D,causal,bq,bkv", FLASH_CASES[::2])
def test_flash_attention_low_precision_matches_pallas_interpret(B, S, T, H, KV, D, causal, bq,
                                                                bkv, tdtype, jdtype, dropped):
    """The kernel's plain version keeps P in fp32, as the Pallas kernel does."""
    (tq, tk, tv), (jq, jk, jv) = _low(_qkv(B, S, T, H, KV, D, seed=7), tdtype, jdtype)
    want = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_kv=bkv, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdtype and want.dtype == jdtype
    _within_one_step(got, want, dropped, "flash_attention")


def test_plain_routes_differ_only_in_p_rounding():
    """attention_ref (P rounded to v's dtype) and flash_attention_ref (P in
    fp32) are equal in fp32 and part in bf16."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 64, 4, 2, 16, seed=8))
    assert torch.equal(ref.attention_ref(q, k, v), ref.flash_attention_ref(q, k, v))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    assert not torch.equal(ref.attention_ref(q, k, v), ref.flash_attention_ref(q, k, v))


def test_flash_attention_rejects_mixed_and_unported_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(NotImplementedError, match="one dtype"):
        flash_attention(q.to(torch.bfloat16), k, v)
    with pytest.raises(NotImplementedError, match="one dtype"):
        flash_attention(q.double(), k.double(), v.double())
