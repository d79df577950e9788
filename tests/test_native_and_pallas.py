"""Native C++ host oracle tests, and the round-1 int8-limb modular matmul."""

import numpy as np
import pytest

import jax

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.ops.ntt import get_ntt


def test_native_host_oracle_matches_device():
    from stark_rings_tpu.native import HostGoldilocks

    f = get_field("goldilocks")
    N = 512
    h = HostGoldilocks(N)
    rng = np.random.default_rng(70)
    a = rng.integers(0, f.q, size=(2, N), dtype=np.uint64)
    b = rng.integers(0, f.q, size=(2, N), dtype=np.uint64)
    got = h.mul(a, b)
    want = h.mul_schoolbook(a[0], b[0])
    assert (got[0] == want).all()
    ctx = get_ntt("goldilocks", N)
    dev = np.asarray(jax.jit(ctx.mul)(jax.device_put(a), jax.device_put(b)))
    assert (got == dev).all()
    assert (h.forward(a) == np.asarray(ctx.forward(jax.device_put(a)))).all()


def test_native_host_ring_babybear():
    """Generic-prime native oracle (HostRing): canonical-domain NTT for
    the Montgomery-storage BabyBear field — vs the device NTTContext
    (decoded) and the independent C schoolbook."""
    from stark_rings_tpu.native import HostRing

    f = get_field("babybear")
    N = 512
    h = HostRing("babybear", N)
    rng = np.random.default_rng(71)
    a_c = rng.integers(0, f.q, size=(2, N), dtype=np.uint64)
    b_c = rng.integers(0, f.q, size=(2, N), dtype=np.uint64)
    got = h.mul(a_c, b_c)
    # independent O(N^2) C oracle
    assert (got[0] == h.mul_schoolbook(a_c[0], b_c[0])).all()
    # device path (storage domain), compared canonically
    a_s = f.encode(a_c.astype(object))
    b_s = f.encode(b_c.astype(object))
    ctx = get_ntt("babybear", N)
    dev = np.asarray(f.decode(jax.jit(ctx.mul)(
        jax.device_put(a_s), jax.device_put(b_s))), dtype=np.uint64)
    assert (got == dev).all()
    # storage-boundary helper
    assert (h.mul_storage(a_s, b_s) == dev).all()
    # goldilocks through the generic-q path == the specialized kernels
    from stark_rings_tpu.native import HostGoldilocks

    hg = HostGoldilocks(N)
    hq = HostRing("goldilocks", N)
    fg = get_field("goldilocks")
    ag = rng.integers(0, fg.q, size=(2, N), dtype=np.uint64)
    bg = rng.integers(0, fg.q, size=(2, N), dtype=np.uint64)
    assert (hq.mul(ag, bg) == hg.mul(ag, bg)).all()


def test_native_decompose():
    from stark_rings_tpu.native import get_host_lib
    from stark_rings_tpu.spec.decomp import decompose_balanced_fixed, to_signed

    lib = get_host_lib()
    q = 2**64 - 2**32 + 1
    rng = np.random.default_rng(71)
    xs = rng.integers(0, q, size=16, dtype=np.uint64)
    k, b = 9, 256
    digs = np.zeros(16 * k, dtype=np.int64)
    lib.srh_decompose_balanced(xs, digs, 16, b, k)
    for i, x in enumerate(xs):
        want = decompose_balanced_fixed(to_signed(int(x), q), b, k)
        assert list(digs[i * k:(i + 1) * k]) == want


def test_mxu_modmat_and_matmul_ntt():
    """MXU int8-limb modular matmul + the 128x128 matmul-NTT are exact."""
    import random

    from stark_rings_tpu.native import HostGoldilocks
    from stark_rings_tpu.ops.mxu import MatmulNTT, MxuModMat

    f = get_field("goldilocks")
    rng = random.Random(80)
    R, C = 4, 128
    M = [[rng.randrange(f.q) for _ in range(C)] for _ in range(R)]
    mm = MxuModMat(M)
    x_i = [[rng.randrange(f.q) for _ in range(3)] for _ in range(C)]
    x = np.array(x_i, dtype=np.uint64)
    got = np.asarray(mm.apply(jax.device_put(x)))
    for r in range(R):
        for c in range(3):
            want = sum(M[r][j] * x_i[j][c] for j in range(C)) % f.q
            assert int(got[r, c]) == want

    mn = MatmulNTT()
    nprng = np.random.default_rng(81)
    a = nprng.integers(0, f.q, size=(2, mn.N), dtype=np.uint64)
    b = nprng.integers(0, f.q, size=(2, mn.N), dtype=np.uint64)
    back = np.asarray(mn.inverse(mn.forward(jax.device_put(a))))
    assert (back == a).all()
    host = HostGoldilocks(mn.N)
    got2 = np.asarray(mn.mul(jax.device_put(a), jax.device_put(b)))
    assert (got2 == host.mul(a, b)).all()
