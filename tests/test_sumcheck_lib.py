"""Library sumcheck prover arithmetic (mle/sumcheck.py): round messages
satisfy the verifier invariants and the final bound values equal
DenseMLE.evaluate at the challenge point."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as F
from stark_rings_tpu.linalg import FieldElems
from stark_rings_tpu.mle import DenseMLE
from stark_rings_tpu.mle.sumcheck import sumcheck_prove_with_challenges


def _interp_at(f, p0, p1, p2, r):
    inv2 = jnp.asarray(f.const(pow(2, f.q - 2, f.q)))
    one, two = jnp.asarray(f.const(1)), jnp.asarray(f.const(2))
    r = jnp.asarray(r)
    l0 = f.mul(f.mul(f.sub(r, one), f.sub(r, two)), inv2)
    l1 = f.mul(r, f.sub(two, r))
    l2 = f.mul(f.mul(r, f.sub(r, one)), inv2)
    return f.add(f.add(f.mul(p0, l0), f.mul(p1, l1)), f.mul(p2, l2))


def test_sumcheck_prover_verifies():
    nv = 10
    rng = random.Random(5)
    e = FieldElems(F)
    g = DenseMLE.rand(e, nv, rng)
    h = DenseMLE.rand(e, nv, rng)
    G = jnp.asarray(g.evals)
    H = jnp.asarray(h.evals)
    chals = [jnp.asarray(np.uint64(rng.randrange(F.q))) for _ in range(nv)]

    msgs, gv, hv = jax.jit(
        lambda G, H: sumcheck_prove_with_challenges(F, G, H, chals))(G, H)
    msgs = np.asarray(msgs)

    claim = F.sum(F.mul(G, H), axis=0)
    for i in range(nv):
        p0, p1, p2 = (jnp.asarray(msgs[i, j]) for j in range(3))
        assert int(F.decode(F.add(p0, p1))) == int(F.decode(claim)), i
        claim = _interp_at(F, p0, p1, p2, chals[i])

    # final check: claim == g(r) * h(r), and the returned bound values
    # equal DenseMLE.evaluate
    want_g = g.evaluate(list(chals))
    want_h = h.evaluate(list(chals))
    assert int(F.decode(gv)) == int(F.decode(want_g))
    assert int(F.decode(hv)) == int(F.decode(want_h))
    assert int(F.decode(claim)) == int(F.decode(F.mul(gv, hv)))


def test_sumcheck_verifier_rejects_perturbed_message():
    """Red test: corrupting any single round message must break the
    verifier's p0+p1 == claim chain (guards against a prover bug that a
    prover-vs-replica equality test would replicate on both sides)."""
    nv = 6
    rng = random.Random(11)
    e = FieldElems(F)
    g = DenseMLE.rand(e, nv, rng)
    h = DenseMLE.rand(e, nv, rng)
    G, H = jnp.asarray(g.evals), jnp.asarray(h.evals)
    chals = [jnp.asarray(np.uint64(rng.randrange(F.q))) for _ in range(nv)]
    msgs, gv, hv = jax.jit(
        lambda G, H: sumcheck_prove_with_challenges(F, G, H, chals))(G, H)
    msgs = np.asarray(msgs)

    def verify(msgs):
        claim = F.sum(F.mul(G, H), axis=0)
        for i in range(nv):
            p0, p1, p2 = (jnp.asarray(msgs[i, j]) for j in range(3))
            if int(F.decode(F.add(p0, p1))) != int(F.decode(claim)):
                return False
            claim = _interp_at(F, p0, p1, p2, chals[i])
        return int(F.decode(claim)) == int(F.decode(F.mul(gv, hv)))

    assert verify(msgs)
    for i in (0, nv // 2, nv - 1):
        for j in range(3):
            bad = msgs.copy()
            bad[i, j] = (int(bad[i, j]) + 1) % F.q
            assert not verify(bad), (i, j)


def test_sumcheck_msb_order_is_lsb_on_bit_reversed_tables():
    """The two binding orders are the same protocol through one
    permutation: msb-order proving on bit_reverse_table(T) produces
    exactly the lsb-order messages and finals for T (the identity the
    msb-order layout rests on)."""
    from stark_rings_tpu.mle.sumcheck import bit_reverse_table

    nv = 8
    rng = np.random.default_rng(3)
    G = jnp.asarray(rng.integers(0, F.q, size=(1 << nv,), dtype=np.uint64))
    H = jnp.asarray(rng.integers(0, F.q, size=(1 << nv,), dtype=np.uint64))
    chals = [jnp.asarray(np.uint64(int(v)))
             for v in rng.integers(0, F.q, size=(nv,), dtype=np.uint64)]
    m_lsb, g_l, h_l = jax.jit(lambda G, H: sumcheck_prove_with_challenges(
        F, G, H, chals))(G, H)
    m_msb, g_m, h_m = jax.jit(lambda G, H: sumcheck_prove_with_challenges(
        F, bit_reverse_table(G), bit_reverse_table(H), chals,
        order="msb"))(G, H)
    assert np.array_equal(np.asarray(m_lsb), np.asarray(m_msb))
    assert int(g_l) == int(g_m) and int(h_l) == int(h_m)


def test_sumcheck_kary_product_soundness_and_completeness():
    """Degree-k product sumcheck (sumcheck_prove_many_with_challenges):
    for k = 2, 3, 4 the messages satisfy the verifier recurrence
    p(0) + p(1) == running claim (with p interpolated from its k+1
    points at the challenge), and the final claim equals the product of
    the individual MLE evaluations at the challenge point.  k = 2 also
    cross-checks the dedicated 2-ary prover."""
    import jax

    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.linalg import FieldElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.mle.sumcheck import (
        sumcheck_prove_many_with_challenges, sumcheck_prove_with_challenges)

    f = get_field("goldilocks")
    fe = FieldElems(f)
    nv = 5
    rng = random.Random(71)
    q = f.q

    def lagrange_eval(points_y, x):
        """Interpolate p from p(0..k) (ints) and evaluate at x, mod q."""
        k = len(points_y) - 1
        acc = 0
        for i in range(k + 1):
            num, den = 1, 1
            for j in range(k + 1):
                if i == j:
                    continue
                num = num * ((x - j) % q) % q
                den = den * ((i - j) % q) % q
            acc = (acc + points_y[i] * num * pow(den, q - 2, q)) % q
        return acc

    for k in (2, 3, 4):
        tables = [np.asarray(f.encode(np.array(
            [rng.randrange(q) for _ in range(1 << nv)], dtype=object)))
            for _ in range(k)]
        chals = [np.asarray(f.encode(np.array(rng.randrange(q),
                                              dtype=object)))
                 for _ in range(nv)]
        msgs, finals = jax.jit(
            lambda ts, cs: sumcheck_prove_many_with_challenges(f, ts, cs)
        )(tables, chals)
        msgs_i = [[int(v) for v in f.decode(m)] for m in msgs]
        chal_i = [int(f.decode(c)) for c in chals]

        # claim recurrence (exact python-int products — np.prod wraps)
        def prod_mod(ints):
            acc = 1
            for v in ints:
                acc = acc * v % q
            return acc

        claim = sum(prod_mod(int(f.decode(jnp.asarray(T[x])))
                             for T in tables)
                    for x in range(1 << nv)) % q
        for rd in range(nv):
            assert (msgs_i[rd][0] + msgs_i[rd][1]) % q == claim, (k, rd)
            claim = lagrange_eval(msgs_i[rd], chal_i[rd])
        # final check: claim == prod of MLE evals at the challenge point
        evs = []
        for T in tables:
            m = DenseMLE(fe, nv, jnp.asarray(T))
            evs.append(int(f.decode(m.evaluate(
                [jnp.asarray(c) for c in chals]))))
        want = prod_mod(evs)
        assert claim == want, k
        assert want == prod_mod(int(f.decode(v)) for v in finals), k

        if k == 2:
            m2, gv, hv = jax.jit(
                lambda G, H, cs: sumcheck_prove_with_challenges(
                    f, G, H, cs))(tables[0], tables[1], chals)
            assert (np.asarray(m2) == np.asarray(msgs)).all()
