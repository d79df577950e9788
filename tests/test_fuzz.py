"""Deterministic multi-seed fuzz: JAX kernels vs the integer spec across
all four models, batched (one jit call per model per op)."""

import random

import numpy as np
import pytest

import jax

from stark_rings_tpu.rings import get_ring
from stark_rings_tpu.spec import MODELS

BATCH = 16
BATCH_LIMBED = 4   # 8-limb CIOS on CPU is ~100x a u64 mul


def _rand_batch(spec, rng, n):
    out = np.empty((n, spec.D), dtype=object)
    for i in range(n):
        for j in range(spec.D):
            out[i, j] = rng.randrange(spec.q)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_fuzz_crt_roundtrip_and_mul(name):
    ring = get_ring(name)
    spec = ring.spec
    rng = random.Random(hash(name) & 0xFFFF)
    nbatch = BATCH_LIMBED if ring.field.limbed else BATCH
    a_i = _rand_batch(spec, rng, nbatch)
    b_i = _rand_batch(spec, rng, nbatch)
    a = ring.encode_coeffs(a_i)
    b = ring.encode_coeffs(b_i)

    @jax.jit
    def pipeline(a, b):
        na, nb = ring.crt(a), ring.crt(b)
        prod = ring.ntt_mul(na, nb)
        return ring.icrt(prod), ring.icrt(na)

    prod, back = pipeline(a, b)
    got_prod = ring.decode(prod)
    got_back = ring.decode(back)
    for i in range(nbatch):
        ai = [int(v) for v in a_i[i]]
        bi = [int(v) for v in b_i[i]]
        assert [int(v) for v in got_back[i]] == ai, (name, "roundtrip", i)
        assert [int(v) for v in got_prod[i]] == spec.coeff_mul(ai, bi), \
            (name, "mul", i)


@pytest.mark.parametrize("name", list(MODELS))
def test_fuzz_add_sub_rot(name):
    ring = get_ring(name)
    spec = ring.spec
    rng = random.Random((hash(name) >> 4) & 0xFFFF)
    a_i = _rand_batch(spec, rng, 4)
    b_i = _rand_batch(spec, rng, 4)
    a = ring.encode_coeffs(a_i)
    b = ring.encode_coeffs(b_i)

    @jax.jit
    def ops(a, b):
        return ring.add(a, b), ring.sub(a, b), ring.rot(a)

    s, d, r = ops(a, b)
    gs, gd, gr = ring.decode(s), ring.decode(d), ring.decode(r)
    q = spec.q
    for i in range(4):
        ai = [int(v) for v in a_i[i]]
        bi = [int(v) for v in b_i[i]]
        assert [int(v) for v in gs[i]] == [(x + y) % q for x, y in zip(ai, bi)]
        assert [int(v) for v in gd[i]] == [(x - y) % q for x, y in zip(ai, bi)]
        assert [int(v) for v in gr[i]] == spec.rot(ai)


# -- reference-volume consistency (goldilocks/ntt.rs:801-806 runs 10^6
# scalar iterations; here 10^5 ring elements per model (2.4-7.2 x 10^6
# base-field coefficients) go through ONE jitted batched call — the
# batched equivalent volume) -----------------------------------------

VOLUME = 100_000
# the 252-bit prime's CIOS limb arithmetic makes volume graphs compile
# for minutes on CPU; stark runs under -m slow (the default suite still
# covers stark through the 16-element fuzz tests above)
FAST_MODELS = [n for n in MODELS if n != "stark_prime"]


def _rand_canonical_device(ring, n, seed):
    """Canonical storage batch [n, D] generated host-side as raw ints."""
    rng = np.random.default_rng(seed)
    f = ring.field
    if f.limbed:
        # top limb < 2^26 keeps values < 2^251 < q (canonical)
        limbs = rng.integers(0, 1 << 32, size=(n, ring.D, 8),
                             dtype=np.uint64)
        limbs[..., 7] &= (1 << 26) - 1
        return f.from_canon(jax.device_put(limbs.astype(np.uint32)))
    dt = np.uint32 if f.dtype == np.uint32 else np.uint64
    raw = rng.integers(0, f.q, size=(n, ring.D), dtype=dt)
    return f.from_canon(jax.device_put(raw))


@pytest.mark.parametrize("name", FAST_MODELS)
def test_volume_crt_roundtrip(name):
    ring = get_ring(name)
    a = _rand_canonical_device(ring, VOLUME, hash(name) & 0xFFFF)

    @jax.jit
    def rt(x):
        return ring.icrt(ring.crt(x))

    back = rt(a)
    assert (np.asarray(back) == np.asarray(a)).all(), name


@pytest.mark.parametrize("name", FAST_MODELS + [pytest.param(
    "stark_prime", marks=pytest.mark.slow)])
def test_volume_ntt_mul_vs_schoolbook(name):
    """Fast path (crt -> slotwise ext mul -> icrt) vs the in-framework
    schoolbook oracle on a 256-element batch in one call (the reference's
    test_mul_crt consistency category, goldilocks/mod.rs:232-247)."""
    n = 256
    ring = get_ring(name)
    a = _rand_canonical_device(ring, n, (hash(name) >> 3) & 0xFFFF)
    b = _rand_canonical_device(ring, n, (hash(name) >> 7) & 0xFFFF)

    @jax.jit
    def both(x, y):
        fast = ring.icrt(ring.ntt_mul(ring.crt(x), ring.crt(y)))
        slow = ring.coeff_mul(x, y)
        return fast, slow

    fast, slow = both(a, b)
    assert (np.asarray(fast) == np.asarray(slow)).all(), name


@pytest.mark.parametrize("name", FAST_MODELS)
def test_volume_mul_cached_matches_mul(name):
    """Fixed-operand fused multiply (precompute_t/mul_cached_t) and
    square_t == the general multiply over a volume batch, incl. the
    batch-1 challenge broadcast — one jit, device-side equality."""
    import jax.numpy as jnp

    from stark_rings_tpu.ops.model_mul import TModelMul

    n = 2048
    ring = get_ring(name)
    tm = TModelMul(ring)
    a = _rand_canonical_device(ring, n, 0x3A0 + len(name))
    b = _rand_canonical_device(ring, n, 0x3B0 + len(name))

    @jax.jit
    def check(x, y):
        xt, yt = tm.to_t(x), tm.to_t(y)
        full = tm.mul_t(xt, yt)
        cached = tm.mul_cached_t(xt, tm.precompute_t(yt))
        ok = jnp.array_equal(full, cached)
        ch = tm.precompute_t(tm.to_t(y[:1]))
        full1 = tm.mul_t(xt, tm.to_t(jnp.broadcast_to(y[:1], y.shape)))
        ok &= jnp.array_equal(tm.mul_cached_t(xt, ch), full1)
        ok &= jnp.array_equal(tm.square_t(xt), tm.mul_t(xt, xt))
        return ok

    assert bool(check(a, b)), name


@pytest.mark.slow
def test_volume_crt_roundtrip_stark_full():
    ring = get_ring("stark_prime")
    a = _rand_canonical_device(ring, VOLUME, 99)

    @jax.jit
    def rt(x):
        return ring.icrt(ring.crt(x))

    assert (np.asarray(rt(a)) == np.asarray(a)).all()


# -- 10^6-slot extension-field multiply vs an independent polymul oracle
# (babybear/ntt.rs:716-748 runs 10^6 Fq9 muls against generic polynomial
# multiplication mod X^9 - nonresidue; same volume here per model, one
# jitted device call, with the oracle written from the mathematical
# definition — no shared tables with ring.ntt_mul's probed gather/factor
# formulation) -----------------------------------------------------------


EXT_MODELS = [n for n in MODELS if MODELS[n].E > 1]


def _ext_polymul_oracle(ring, a, b):
    """Slot field mul as literal polymul mod (X^E - nr), degree order.

    a, b: storage [..., N, E]; returns the same shape.  Conjugates by the
    model's storage permutation, then c[k] = sum_{i+j=k} a_i b_j
    + nr * sum_{i+j=k+E} a_i b_j, spelled with explicit python loops
    over the (tiny, static) E axis."""
    import jax.numpy as jnp

    f = ring.field
    spec = ring.spec
    E = spec.E
    perm = list(spec.storage_perm)
    inv_perm = [0] * E
    for i, p in enumerate(perm):
        inv_perm[p] = i
    nr = f.encode(np.array(spec.nr % spec.q, dtype=object))
    ad = [a[..., p] for p in perm]
    bd = [b[..., p] for p in perm]
    out = []
    for k in range(E):
        lo = None
        for i in range(k + 1):
            t = f.mul(ad[i], bd[k - i])
            lo = t if lo is None else f.add(lo, t)
        hi = None
        for i in range(k + 1, E):
            t = f.mul(ad[i], bd[k + E - i])
            hi = t if hi is None else f.add(hi, t)
        c = lo if hi is None else f.add(lo, f.mul(nr, hi))
        out.append(c)
    return jnp.stack([out[i] for i in inv_perm], axis=-1)


@pytest.mark.parametrize("name", EXT_MODELS)
def test_volume_ext_mul_vs_polymul_oracle(name):
    ring = get_ring(name)
    n_slots = 1_000_000
    n = max(n_slots // ring.N, 1)
    a = _rand_canonical_device(ring, n, (hash(name) >> 2) & 0xFFFF)
    b = _rand_canonical_device(ring, n, (hash(name) >> 6) & 0xFFFF)

    @jax.jit
    def both(x, y):
        fast = ring.ntt_mul(x, y)
        xs = x.reshape(x.shape[:-1] + (ring.N, ring.E))
        ys = y.reshape(y.shape[:-1] + (ring.N, ring.E))
        slow = _ext_polymul_oracle(ring, xs, ys)
        return (fast.reshape(slow.shape) == slow).all()

    assert bool(both(a, b)), name


@pytest.mark.parametrize("name", ["goldilocks", "frog"])
def test_volume_crt_roundtrip_1e6(name):
    """Full reference volume (goldilocks/ntt.rs:801-806 runs 10^6 ring
    elements through crt o icrt): 10^6 elements in one jitted call,
    device-side boolean reduction (~6 s/model on the CPU backend —
    batching makes the reference's million-iteration loop free)."""
    ring = get_ring(name)
    n = 1_000_000
    a = _rand_canonical_device(ring, n, (hash(name) >> 9) & 0xFFFF)

    @jax.jit
    def ok(x):
        return (ring.icrt(ring.crt(x)) == x).all()

    assert bool(ok(a)), name
