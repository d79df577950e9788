"""Sharded four-step NTT tests on a virtual 8-device CPU mesh
(the multi-chip tests the reference lacks — SURVEY.md §4 implication (e))."""

import random

import numpy as np
import pytest

import jax

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.ops.ntt import get_ntt
from stark_rings_tpu.parallel import ShardedNTT, make_mesh


def _negacyclic_mul_ints(a, b, q):
    n = len(a)
    out = [0] * n
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                k = i + j
                if k < n:
                    out[k] = (out[k] + x * y) % q
                else:
                    out[k - n] = (out[k - n] - x * y) % q
    return out


@pytest.mark.parametrize("name,N,Pn", [
    ("goldilocks", 256, 4),
    ("goldilocks", 1024, 8),
    ("babybear", 1024, 8),
])
def test_sharded_mul_matches_oracle(name, N, Pn):
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    fwd, inv, mul = sn.make_fns(mesh)
    rng = random.Random(50)
    a_i = [rng.randrange(f.q) for _ in range(N)]
    b_i = [rng.randrange(f.q) for _ in range(N)]
    a = sn.to_matrix(np.asarray(f.encode(np.array(a_i, dtype=object))))
    b = sn.to_matrix(np.asarray(f.encode(np.array(b_i, dtype=object))))
    got = f.decode(sn.from_matrix(np.asarray(jax.device_get(mul(a, b)))))
    assert [int(v) for v in got] == _negacyclic_mul_ints(a_i, b_i, f.q)


def test_sharded_roundtrip_and_matches_single_chip():
    Pn = 8
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    name, N = "goldilocks", 512
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    fwd, inv, mul = sn.make_fns(mesh)
    rng = random.Random(51)
    a_i = [rng.randrange(f.q) for _ in range(N)]
    a = sn.to_matrix(np.asarray(f.encode(np.array(a_i, dtype=object))))
    back = f.decode(sn.from_matrix(np.asarray(jax.device_get(inv(fwd(a))))))
    assert [int(v) for v in back] == a_i
    # forward evals are a permutation of the single-chip negacyclic evals
    single = get_ntt(name, N, negacyclic=True)
    ev_single = sorted(int(v) for v in f.decode(
        single.forward(f.encode(np.array(a_i, dtype=object)))))
    ev_shard = sorted(int(v) for v in f.decode(
        sn.from_matrix(np.asarray(jax.device_get(fwd(a))))))
    assert ev_single == ev_shard


def test_sharded_batched():
    Pn = 4
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    name, N = "goldilocks", 256
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    _, _, mul = sn.make_fns(mesh, batch_ndim=1)
    rng = random.Random(52)
    B = 3
    a_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    b_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    a = sn.to_matrix(np.asarray(f.encode(np.array(a_i, dtype=object))))
    b = sn.to_matrix(np.asarray(f.encode(np.array(b_i, dtype=object))))
    got = f.decode(sn.from_matrix(np.asarray(jax.device_get(mul(a, b)))))
    for t in range(B):
        assert [int(v) for v in got[t]] == \
            _negacyclic_mul_ints(a_i[t], b_i[t], f.q)


def test_sharded_mul_cached_and_square():
    """Fixed-operand multiply on the mesh (cached row-sharded
    evaluations; 2 collectives per multiply instead of 3) and square,
    incl. the batch-1 challenge broadcast."""
    Pn = 4
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    name, N = "goldilocks", 256
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    pre, mul_cached, square = sn.make_cached_fns(mesh, batch_ndim=1)
    rng = random.Random(53)
    B = 2
    a_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    b_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    a = sn.to_matrix(np.asarray(f.encode(np.array(a_i, dtype=object))))
    b = sn.to_matrix(np.asarray(f.encode(np.array(b_i, dtype=object))))
    fb = pre(b)
    got = f.decode(sn.from_matrix(np.asarray(jax.device_get(
        mul_cached(a, fb)))))
    for t in range(B):
        assert [int(v) for v in got[t]] == \
            _negacyclic_mul_ints(a_i[t], b_i[t], f.q)
    # square
    gots = f.decode(sn.from_matrix(np.asarray(jax.device_get(square(a)))))
    for t in range(B):
        assert [int(v) for v in gots[t]] == \
            _negacyclic_mul_ints(a_i[t], a_i[t], f.q)
    # batch-1 cached operand broadcasts over the live batch
    f1 = pre(b[:1])
    got1 = f.decode(sn.from_matrix(np.asarray(jax.device_get(
        mul_cached(a, f1)))))
    for t in range(B):
        assert [int(v) for v in got1[t]] == \
            _negacyclic_mul_ints(a_i[t], b_i[0], f.q)


@pytest.mark.slow
def test_sharded_deg_2_20_roundtrip():
    """BASELINE config 5 shape: deg-2^20 sharded NTT roundtrip on the
    virtual 8-device mesh."""
    Pn = 8
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    name, N = "goldilocks", 1 << 20
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    fwd, inv, _ = sn.make_fns(mesh)
    rng = np.random.default_rng(53)
    a_np = rng.integers(0, f.q, size=(N,), dtype=np.uint64)
    a = sn.to_matrix(a_np)
    back = np.asarray(jax.device_get(inv(fwd(a))))
    assert (sn.from_matrix(back) == a_np).all()


@pytest.mark.slow
def test_sharded_deg_2_16_mul_vs_native_oracle():
    """Four-step sharded ring-mul at deg 2^16 vs the C++ host oracle."""
    Pn = 8
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    from stark_rings_tpu.native import HostGoldilocks

    name, N = "goldilocks", 1 << 16
    f = get_field(name)
    mesh = make_mesh(Pn)
    sn = ShardedNTT(name, N, Pn)
    _, _, mul = sn.make_fns(mesh)
    rng = np.random.default_rng(54)
    a_np = rng.integers(0, f.q, size=(N,), dtype=np.uint64)
    b_np = rng.integers(0, f.q, size=(N,), dtype=np.uint64)
    got = sn.from_matrix(np.asarray(jax.device_get(
        mul(sn.to_matrix(a_np), sn.to_matrix(b_np)))))
    host = HostGoldilocks(N)
    want = host.mul(a_np[None], b_np[None])[0]
    assert (got == want).all()


def test_sharded_forward_overlap_matches():
    """Batch-pipelined forward (ppermute/async-overlap prototype) equals
    the single-all_to_all path on the CPU mesh."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import numpy as np

    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.parallel import ShardedNTT, make_mesh

    f = get_field("goldilocks")
    N = 1 << 12
    sn = ShardedNTT("goldilocks", N, 8)
    mesh = make_mesh(8)
    fwd, _, mul = sn.make_fns(mesh, batch_ndim=1)
    fwd_o, _, mul_o = sn.make_fns(mesh, batch_ndim=1, overlap=True)
    rng = np.random.default_rng(17)
    a = sn.to_matrix(rng.integers(0, f.q, size=(4, N), dtype=np.uint64))
    b = sn.to_matrix(rng.integers(0, f.q, size=(4, N), dtype=np.uint64))
    assert (np.asarray(jax.device_get(fwd_o(a)))
            == np.asarray(jax.device_get(fwd(a)))).all()
    assert (np.asarray(jax.device_get(mul_o(a, b)))
            == np.asarray(jax.device_get(mul(a, b)))).all()


@pytest.mark.slow
def test_sharded_stark_prime_limbed():
    """The four-step sharded NTT is limb-aware: 252-bit stark-prime
    deg-2^12 multiply over an 8-device mesh equals the single-device
    radix-4 context (multi-chip support for the big prime — beyond the
    reference, which has no distribution at all)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import numpy as np

    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.ops.ntt import NTTContext
    from stark_rings_tpu.parallel import ShardedNTT, make_mesh

    f = get_field("stark_prime")
    N = 1 << 8     # small: limbed CPU-mesh ops are ~100x a u64 field's;
    #                the limb-layout logic is size-independent
    sn = ShardedNTT("stark_prime", N, 8)
    mesh = make_mesh(8)
    _, _, mul = sn.make_fns(mesh, batch_ndim=1)
    rng = np.random.default_rng(19)
    limbs = rng.integers(0, 1 << 32, size=(2, 2, N, 8),
                         dtype=np.uint64).astype(np.uint32)
    limbs[..., 7] &= (1 << 26) - 1
    import jax.numpy as jnp

    a = jnp.asarray(limbs[0])
    b = jnp.asarray(limbs[1])
    got = np.asarray(sn.from_matrix(mul(sn.to_matrix(a), sn.to_matrix(b))))
    want = np.asarray(NTTContext(f, N, negacyclic=True).mul(a, b))
    assert np.array_equal(got, want)


def test_sharded_mxu_local_matches_vpu():
    """The flagship int8 digit-matmul local transforms (local="mxu")
    must produce exactly the same sharded multiply as the radix-4 VPU
    locals — same leaf order, same exchange, different engine."""
    Pn = 8
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    f = get_field("goldilocks")
    N = 1 << 12
    mesh = make_mesh(Pn)
    rng = np.random.default_rng(21)
    a_np = rng.integers(0, f.q, size=(N,), dtype=np.uint64)
    b_np = rng.integers(0, f.q, size=(N,), dtype=np.uint64)
    outs = {}
    for local in ("vpu", "mxu"):
        sn = ShardedNTT("goldilocks", N, Pn, local=local)
        fwd, inv, mul = sn.make_fns(mesh)
        a = sn.to_matrix(a_np)
        b = sn.to_matrix(b_np)
        outs[local] = np.asarray(jax.device_get(mul(a, b)))
        # forward alone must agree too (same leaf-order evaluations)
        outs[local + "_fwd"] = np.asarray(jax.device_get(fwd(a)))
    assert np.array_equal(outs["vpu"], outs["mxu"])
    assert np.array_equal(outs["vpu_fwd"], outs["mxu_fwd"])


def test_sharded_mxu_local_overlap_matches():
    """local="mxu" composed with the batch-pipelined overlap forward."""
    Pn = 8
    if len(jax.devices()) < Pn:
        pytest.skip("not enough devices")
    f = get_field("goldilocks")
    N = 1 << 12
    mesh = make_mesh(Pn)
    rng = np.random.default_rng(23)
    B = 4
    a_np = rng.integers(0, f.q, size=(B, N), dtype=np.uint64)
    sn = ShardedNTT("goldilocks", N, Pn, local="mxu")
    fwd, _, _ = sn.make_fns(mesh, batch_ndim=1)
    fwd_ov, _, _ = sn.make_fns(mesh, batch_ndim=1, overlap=True)
    a = np.stack([sn.to_matrix(v) for v in a_np])
    plain = np.asarray(jax.device_get(fwd(a)))
    ov = np.asarray(jax.device_get(fwd_ov(a)))
    assert np.array_equal(plain, ov)


def test_single_chip_four_step_matches_radix_oracle():
    """ShardedNTT(single_chip=True).make_single_chip_fns: the four-step
    stages as plain jittable functions (no mesh, P=1 exchange skipped)
    — mul bit-equal to the monolithic radix NTTContext, and
    inverse(forward) == identity.  This is the deg-2^20 bench
    alternative path (SHARDCOMPUTE_r05 bonus finding)."""
    import jax
    import numpy as np
    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.ops.ntt import get_ntt
    from stark_rings_tpu.parallel import ShardedNTT

    f = get_field("goldilocks")
    N = 1 << 10
    sn = ShardedNTT("goldilocks", N, 1, single_chip=True)
    fwd, inv, mul = sn.make_single_chip_fns()
    rng = np.random.default_rng(21)
    a = rng.integers(0, f.q, size=(3, N), dtype=np.uint64)
    b = rng.integers(0, f.q, size=(3, N), dtype=np.uint64)
    got = np.asarray(sn.from_matrix(jax.jit(mul)(
        sn.to_matrix(a), sn.to_matrix(b))))
    want = np.asarray(jax.jit(get_ntt("goldilocks", N,
                                      negacyclic=True).mul)(a, b))
    assert np.array_equal(got, want)
    rt = np.asarray(sn.from_matrix(
        jax.jit(lambda x: inv(fwd(x)))(sn.to_matrix(a))))
    assert np.array_equal(rt, a)


def test_make_fns_auto_overlap_default():
    """overlap=None (the new default) pipelines even batches and falls
    back for odd ones — bit-identical to the explicit variants."""
    import jax
    import numpy as np
    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.parallel import ShardedNTT, make_mesh

    Pn = 8
    if len(jax.devices()) < Pn:
        import pytest
        pytest.skip("not enough devices")
    f = get_field("goldilocks")
    N = 1 << 12
    rng = np.random.default_rng(13)
    mesh = make_mesh(Pn)
    sn = ShardedNTT("goldilocks", N, Pn)
    fwd_auto, inv_auto, mul_auto = sn.make_fns(mesh, batch_ndim=1)
    fwd_plain, _, _ = sn.make_fns(mesh, batch_ndim=1, overlap=False)
    for B in (2, 3):
        a = sn.to_matrix(rng.integers(0, f.q, size=(B, N),
                                      dtype=np.uint64))
        assert (np.asarray(fwd_auto(a)) == np.asarray(fwd_plain(a))).all()
        assert (np.asarray(inv_auto(fwd_auto(a))) == np.asarray(a)).all()
