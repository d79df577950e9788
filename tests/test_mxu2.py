"""MXU NTT v2 (pre-scaled int8 digit matmuls + fold epilogues): CPU
bit-exactness vs NTTContext and the integer layout invariants.

The power-ring multiply (PowerRing.mxu_ctx) uses these classes; parity
anchor is the
generalized butterfly dataflow of goldilocks/ntt.rs:135-319 scaled to
power-of-two degrees."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as F
from stark_rings_tpu.ops.mxu2 import (
    K_BUCKETS, Mxu2NTT, PrescaledMat, _digitize_signed_host)
from stark_rings_tpu.ops.ntt import NTTContext

N = 1 << 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    a = jax.device_put(rng.integers(0, F.q, (3, N), dtype=np.uint64))
    b = jax.device_put(rng.integers(0, F.q, (3, N), dtype=np.uint64))
    ctx = NTTContext(F, N, negacyclic=True)
    return a, b, np.asarray(ctx.mul(a, b))


def test_digitize_signed_host_exact():
    rng = np.random.default_rng(6)
    for v in [0, 1, F.q - 1, (1 << 64) - 1, 1 << 63,
              *rng.integers(0, 1 << 64, 50, dtype=np.uint64).tolist()]:
        dg = _digitize_signed_host(int(v))
        assert len(dg) == K_BUCKETS
        assert all(-128 <= d <= 127 for d in dg[:-1]) and dg[-1] in (0, 1)
        assert sum(d << (8 * i) for i, d in enumerate(dg)) == int(v)


def test_prescaled_mat_matches_field_matvec():
    rng = np.random.default_rng(7)
    m = rng.integers(0, F.q, (16, 16), dtype=np.uint64)
    x = jax.device_put(rng.integers(0, F.q, (16, 8), dtype=np.uint64))
    pm = PrescaledMat([[int(v) for v in row] for row in m])
    got = np.asarray(pm.apply(x))
    # object-int oracle
    xs = np.asarray(x)
    want = np.empty_like(got)
    for r in range(16):
        for c in range(8):
            want[r, c] = sum(int(m[r, k]) * int(xs[k, c])
                             for k in range(16)) % F.q
    assert (got == want).all()


def test_mxu2_xla_mul_exact(data):
    a, b, want = data
    t = Mxu2NTT(N)
    assert np.array_equal(np.asarray(t.jit_mul()(a, b)), want)
    # staged composition must agree with the one-module jit
    assert np.array_equal(np.asarray(t.staged_mul()(a, b)), want)


def test_mxu2_roundtrip_and_forward_consistency(data):
    a, _, _ = data
    t = Mxu2NTT(N)
    x = t._to_internal(a)
    back = t._from_internal(t.inverse_internal(t.forward_internal(x)))
    assert np.array_equal(np.asarray(back), np.asarray(a))
    # forward is a permutation of NTTContext's leaf evaluations
    # (same multiset of slot values for each batch element)
    ctx = NTTContext(F, N, negacyclic=True)
    fa = np.sort(np.asarray(t.forward(a)), axis=-1)
    fb = np.sort(np.asarray(ctx.forward(a)), axis=-1)
    assert np.array_equal(fa, fb)


@pytest.mark.parametrize("logN", [12, 13])
def test_mxu2_other_degrees(logN):
    """The v2 pipeline generalizes to any power-of-two degree (asymmetric
    N1 x N2 for odd log2 N)."""
    n = 1 << logN
    rng = np.random.default_rng(40 + logN)
    a = jax.device_put(rng.integers(0, F.q, (2, n), dtype=np.uint64))
    b = jax.device_put(rng.integers(0, F.q, (2, n), dtype=np.uint64))
    t = Mxu2NTT(n)
    ctx = NTTContext(F, n, negacyclic=True)
    assert np.array_equal(np.asarray(t.jit_mul()(a, b)),
                          np.asarray(ctx.mul(a, b)))


def test_power_ring_mxu_ctx():
    from stark_rings_tpu.rings.power import get_power_ring

    pr = get_power_ring("goldilocks", 12)
    rng = np.random.default_rng(77)
    a = jax.device_put(rng.integers(0, F.q, (2, 4096), dtype=np.uint64))
    b = jax.device_put(rng.integers(0, F.q, (2, 4096), dtype=np.uint64))
    m = pr.mxu_ctx()
    assert np.array_equal(np.asarray(m.staged_mul()(a, b)),
                          np.asarray(pr.coeff_mul(a, b)))


def test_staged_granularities_match():
    """Every staged_mul granularity is the same function (CPU, deg 2^12)."""
    import jax.numpy as jnp

    tx = Mxu2NTT(1 << 12)
    rng = np.random.default_rng(13)
    a = jnp.asarray(rng.integers(0, F.q, (3, 1 << 12), dtype=np.uint64))
    b = jnp.asarray(rng.integers(0, F.q, (3, 1 << 12), dtype=np.uint64))
    want = np.asarray(tx.jit_mul()(a, b))
    for gran in ("stage", "mixed", "mixed4"):
        got = np.asarray(tx.staged_mul(granularity=gran)(a, b))
        assert np.array_equal(got, want), gran


def test_mxu2_mul_cached_and_square(data):
    """Fixed-operand multiply (cached forward transform) and square must
    equal the full multiply bit-exactly on the XLA base path."""
    a, b, want = data
    t = Mxu2NTT(N)
    fb = t.precompute(b)
    assert np.array_equal(np.asarray(t.mul_cached(a, fb)), want)
    mc = t.jit_mul_cached()
    assert np.array_equal(np.asarray(mc(a, mc.precompute(b))), want)
    ctx = NTTContext(F, N, negacyclic=True)
    sq_want = np.asarray(ctx.mul(a, a))
    assert np.array_equal(np.asarray(t.square(a)), sq_want)
    assert np.array_equal(np.asarray(t.jit_square()(a)), sq_want)
