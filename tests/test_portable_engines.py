"""The portable engines: both digit schemes of every digit-plane engine,
the one engine per field behind PowerRing.mxu_ctx, the fixed-operand /
challenge / square / odd-batch multiplies against the native oracles,
the XLA sumcheck prover against a host integer oracle, and the
compile-cache rule."""

import os
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import get_field

SCHEMES = [pytest.param(True, id="u8"), pytest.param(False, id="s8")]


def _rand_ints(q, shape, pr):
    out = np.empty(shape, dtype=object)
    flat = out.reshape(-1)
    for i in range(flat.size):
        flat[i] = pr.randrange(q)
    return out


def _matvec_ints(m, x, q):
    """[R, C] x [C, cols] python-int product mod q."""
    R, C = m.shape
    return np.array([[sum(int(m[r, c]) * int(x[c, j]) for c in range(C)) % q
                      for j in range(x.shape[1])] for r in range(R)],
                    dtype=object)


def _check_prescaled_mat(unsigned):
    from stark_rings_tpu.ops.mxu2 import PrescaledMat

    f = get_field("goldilocks")
    pr = random.Random(1)
    m, x = _rand_ints(f.q, (12, 16), pr), _rand_ints(f.q, (16, 5), pr)
    pm = PrescaledMat(m, unsigned)
    got = np.asarray(pm.apply(jnp.asarray(x.astype(np.uint64))))
    assert (got.astype(object) == _matvec_ints(m, x, f.q)).all()


def _check_mxu_bb(unsigned):
    from stark_rings_tpu.ops.mxu_bb import BBPrescaledMat

    f = get_field("babybear")
    pr = random.Random(2)
    # the map is linear, so it is the same map on Montgomery storage
    m, x = _rand_ints(f.q, (12, 16), pr), _rand_ints(f.q, (16, 5), pr)
    pm = BBPrescaledMat(m, unsigned)
    got = np.asarray(pm.apply(jnp.asarray(x.astype(np.uint32))))
    assert (got.astype(object) == _matvec_ints(m, x, f.q)).all()


def _check_mxu_limb(unsigned):
    from stark_rings_tpu.ops.mxu_limb import LimbPrescaledMat

    f = get_field("stark_prime")
    pr = random.Random(3)
    m, x = _rand_ints(f.q, (3, 4), pr), _rand_ints(f.q, (4, 2), pr)
    lm = LimbPrescaledMat(f, m, unsigned)
    got = f.decode(lm(jnp.asarray(f.encode(x.T))))        # [cols, R]
    assert (np.asarray(got, dtype=object).T
            == _matvec_ints(m, x, f.q)).all()


def _check_mxu_dense(unsigned):
    from stark_rings_tpu.ops.mxu_dense import Mont64PrescaledMat

    f = get_field("frog")
    pr = random.Random(4)
    m, x = _rand_ints(f.q, (9, 6), pr), _rand_ints(f.q, (6, 4), pr)
    mm = Mont64PrescaledMat(f, m, unsigned)
    got = f.decode(mm(jnp.asarray(f.encode(x.T))))        # [cols, R]
    assert (np.asarray(got, dtype=object).T
            == _matvec_ints(m, x, f.q)).all()


def _check_model_mul(unsigned):
    from stark_rings_tpu.ops.dense_linear import probe_dense_matrix
    from stark_rings_tpu.ops.model_mul import TModelMul, _unwrap
    from stark_rings_tpu.ops.mxu_dense import prescaled_dense
    from stark_rings_tpu.rings import get_ring

    ring = get_ring("goldilocks")
    tm = TModelMul(ring)
    mc = probe_dense_matrix(ring.spec.crt, ring.D, ring.D, ring.q)
    mi = probe_dense_matrix(ring.spec.icrt, ring.D, ring.D, ring.q)
    tm._crt = _unwrap(prescaled_dense(ring.field, mc, unsigned))
    tm._icrt = _unwrap(prescaled_dense(ring.field, mi, unsigned))
    pr = random.Random(5)
    a, b = ring.rand_coeff((4,), pr), ring.rand_coeff((4,), pr)
    assert np.array_equal(np.asarray(tm.mul(a, b)),
                          np.asarray(ring.coeff_mul(a, b)))


def _check_mxu_eval(unsigned):
    from stark_rings_tpu.linalg import FieldElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.mle.mxu_eval import (evaluate_goldilocks_mxu,
                                              evaluate_many_goldilocks_mxu)

    f = get_field("goldilocks")
    nv = 9
    rng = np.random.default_rng(6)
    ev = jnp.asarray(rng.integers(0, f.q, (1 << nv,), dtype=np.uint64))
    pts = rng.integers(0, f.q, (3, nv), dtype=np.uint64)
    want = [int(DenseMLE(FieldElems(f), nv, ev).evaluate(
        [jnp.asarray(v) for v in p])) for p in pts]
    got = [int(evaluate_goldilocks_mxu(ev, list(p), unsigned=unsigned))
           for p in pts]
    many = np.asarray(evaluate_many_goldilocks_mxu(ev, pts,
                                                   unsigned=unsigned))
    assert got == want and [int(v) for v in many] == want


ENGINES = {
    "mxu2.PrescaledMat": _check_prescaled_mat,
    "mxu_bb": _check_mxu_bb,
    "mxu_limb": _check_mxu_limb,
    "mxu_dense": _check_mxu_dense,
    "TModelMul": _check_model_mul,
    "mxu_eval": _check_mxu_eval,
}


@pytest.mark.parametrize("unsigned", SCHEMES)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_digit_scheme_exact(engine, unsigned):
    """Both digit schemes (u8 x u8 and s8 x s8 dots) are exact for every
    digit-plane engine, against python-integer or independent oracles."""
    ENGINES[engine](unsigned)


def test_signed_scheme_is_the_default():
    """The default digit scheme is the one XLA:GPU sends to the int8
    tensor cores (s8 x s8 -> s32); every engine follows the one switch."""
    from stark_rings_tpu.ops import mxu2
    from stark_rings_tpu.ops.mxu_bb import MxuBBNTT

    assert mxu2.UNSIGNED_DIGITS is False
    assert mxu2.Mxu2NTT(1 << 8).mat1.big.dtype == np.int8
    assert MxuBBNTT(1 << 8).mat1.big.dtype == np.int8


POWER_ENGINES = {"goldilocks": "Mxu2NTT", "babybear": "MxuBBNTT",
                 "stark_prime": "MxuLimbNTT"}


@pytest.mark.parametrize("field", list(POWER_ENGINES))
def test_mxu_ctx_portable_engine(field):
    """mxu_ctx() is one cached XLA engine per field, the same on every
    platform, and its jit_mul equals coeff_mul."""
    from stark_rings_tpu.rings import get_power_ring

    ring = get_power_ring(field, 6 if field == "stark_prime" else 8)
    eng = ring.mxu_ctx()
    assert type(eng).__name__ == POWER_ENGINES[field]
    assert ring.mxu_ctx() is eng
    pr = random.Random(7)
    a = jnp.asarray(ring.rand_coeff((2,), pr))
    b = jnp.asarray(ring.rand_coeff((2,), pr))
    assert np.array_equal(np.asarray(eng.jit_mul()(a, b)),
                          np.asarray(ring.coeff_mul(a, b)))


def _engine_and_oracle(field, N):
    from stark_rings_tpu.native import HostGoldilocks, HostRing
    from stark_rings_tpu.ops.mxu2 import Mxu2NTT
    from stark_rings_tpu.ops.mxu_bb import MxuBBNTT

    f = get_field(field)
    if field == "goldilocks":
        host = HostGoldilocks(N)
        return Mxu2NTT(N), f, np.uint64, lambda a, b: host.mul(a, b)
    host = HostRing(field, N)
    return (MxuBBNTT(N), f, np.uint32,
            lambda a, b: host.mul_storage(a, b))


def _canon(f, x):
    return np.asarray(f.decode(jnp.asarray(x)), dtype=np.uint64)


@pytest.mark.parametrize("case", ["mul_cached", "challenge", "square",
                                  "odd_batch"])
@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_fixed_operand_paths_vs_native_oracle(field, case):
    """The cached-operand, challenge-broadcast (batch-1 cached operand),
    square and odd-batch multiplies of the portable engines equal the
    native host oracles (HostGoldilocks / HostRing) bit for bit."""
    N = 1 << 10
    eng, f, dt, host_mul = _engine_and_oracle(field, N)
    B = 5 if case == "odd_batch" else 4
    rng = np.random.default_rng(12)
    a = rng.integers(0, f.q, (B, N), dtype=dt)
    b = rng.integers(0, f.q, (B, N), dtype=dt)
    ad, bd = jnp.asarray(a), jnp.asarray(b)
    if case == "mul_cached":
        mc = eng.jit_mul_cached()
        got, want = mc(ad, mc.precompute(bd)), host_mul(a, b)
    elif case == "challenge":
        mc = eng.jit_mul_cached()
        got = mc(ad, mc.precompute(bd[:1]))
        want = host_mul(a, np.broadcast_to(b[:1], a.shape))
    elif case == "square":
        got, want = eng.jit_square()(ad), host_mul(a, a)
    else:
        got, want = eng.jit_mul()(ad, bd), host_mul(a, b)
    assert np.array_equal(_canon(f, got), want)


def _msb_sumcheck_oracle(q, G, H, rs):
    """Product-claim sumcheck, top variable bound first, python ints."""
    msgs = []
    for r in rs:
        h = len(G) // 2
        g0, g1, h0, h1 = G[:h], G[h:], H[:h], H[h:]
        msgs.append([sum(x * y for x, y in zip(g0, h0)) % q,
                     sum(x * y for x, y in zip(g1, h1)) % q,
                     sum((2 * x1 - x0) * (2 * y1 - y0) for x0, x1, y0, y1
                         in zip(g0, g1, h0, h1)) % q])
        G = [(x0 + r * (x1 - x0)) % q for x0, x1 in zip(g0, g1)]
        H = [(y0 + r * (y1 - y0)) % q for y0, y1 in zip(h0, h1)]
    return msgs, G[0], H[0]


@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_xla_sumcheck_prover_vs_msb_oracle(field):
    """The XLA prover (mle/sumcheck.py, order="msb") equals a python-int
    msb-order prover message for message, for each field it serves."""
    from stark_rings_tpu.mle.sumcheck import sumcheck_prove_with_challenges

    f = get_field(field)
    nv = 6
    rng = np.random.default_rng(11)
    # values below q are valid storage in either storage form
    G = jnp.asarray(rng.integers(0, f.q, (1 << nv,), dtype=f.dtype))
    H = jnp.asarray(rng.integers(0, f.q, (1 << nv,), dtype=f.dtype))
    ch = [jnp.asarray(v) for v in
          rng.integers(0, f.q, (nv,), dtype=f.dtype)]
    msgs, gv, hv = jax.jit(lambda g, h: sumcheck_prove_with_challenges(
        f, g, h, ch, order="msb"))(G, H)

    def ints(x):
        return [int(v) for v in np.asarray(f.decode(x)).reshape(-1)]

    want_m, want_g, want_h = _msb_sumcheck_oracle(
        f.q, ints(G), ints(H), ints(jnp.stack(ch)))
    assert np.asarray(f.decode(msgs)).astype(object).tolist() == want_m
    assert ints(gv) == [want_g] and ints(hv) == [want_h]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set (and nothing else is set in
    code); otherwise the cache is <checkout>/.jax_cache."""
    from stark_rings_tpu.utils import compile_cache

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(checkout, ".jax_cache")
    assert compile_cache.compile_cache_dir() == want
    # record the config updates instead of changing the process-wide
    # configuration that other tests share
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    assert compile_cache.enable_compile_cache() == want
    set_dirs = [v for k, v in updates if k == "jax_compilation_cache_dir"]
    assert set_dirs == ([] if env_set else [want])
