"""MLE-layer tests vs python-int oracles.

Mirrors the reference's MLE tests (dense fix_variables/evaluate semantics
dense.rs:171-199; sparse evaluate/fix sparse.rs:133-207; util bit tests
util.rs:66-101)."""

import random

import numpy as np
import pytest

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.linalg import FieldElems, RingElems, SparseMatrix
from stark_rings_tpu.mle import (
    DenseMLE,
    SparseMLE,
    bit_decompose,
    get_batched_nv,
    get_index,
    identity_permutation_mles,
    merge_polynomials,
    project,
    random_mle_list,
    swap_bits,
)
from stark_rings_tpu.rings import get_ring


def _eval_mle_ints(evals, point, q):
    """Oracle: multilinear interpolation over {0,1}^n, little-endian."""
    cur = list(evals)
    for r in point:
        half = len(cur) // 2
        cur = [(cur[2 * b] + r * (cur[2 * b + 1] - cur[2 * b])) % q
               for b in range(half)]
    return cur[0]


def test_util_bits():
    rng = random.Random(30)
    for _ in range(100):
        t = rng.getrandbits(64)
        assert project(bit_decompose(t, 64)) == t
    # util.rs test_get_index vectors
    assert get_index(0b1010, 4) == (0b0100, 0b0101, True)
    assert get_index(0b1010, 5) == (0b10100, 0b10101, False)
    assert get_index(0b1111, 4) == (0b1110, 0b1111, True)
    assert swap_bits(0b1010, 0, 2, 2) == 0b1010
    assert get_batched_nv(3, 4) == 5
    assert get_batched_nv(3, 5) == 6


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "stark_prime"])
def test_dense_evaluate_fix(name):
    f = get_field(name)
    e = FieldElems(f)
    q = f.q
    rng = random.Random(31)
    nv = 5
    evals = [rng.randrange(q) for _ in range(1 << nv)]
    point = [rng.randrange(q) for _ in range(nv)]
    mle = DenseMLE.from_ints(e, nv, np.array(evals, dtype=object))
    p_enc = [f.encode(np.array(p, dtype=object)) for p in point]
    got = int(f.decode(mle.evaluate(p_enc)))
    assert got == _eval_mle_ints(evals, point, q)
    # partial fix matches oracle table
    part = mle.fix_variables(p_enc[:2])
    assert part.num_vars == nv - 2
    cur = list(evals)
    for r in point[:2]:
        half = len(cur) // 2
        cur = [(cur[2 * b] + r * (cur[2 * b + 1] - cur[2 * b])) % q
               for b in range(half)]
    assert [int(v) for v in f.decode(part.evals)] == cur


def test_dense_fix_last_variables():
    f = get_field("goldilocks")
    e = FieldElems(f)
    q = f.q
    rng = random.Random(32)
    nv = 4
    evals = [rng.randrange(q) for _ in range(1 << nv)]
    point = [rng.randrange(q) for _ in range(2)]
    mle = DenseMLE.from_ints(e, nv, np.array(evals, dtype=object))
    p_enc = [f.encode(np.array(p, dtype=object)) for p in point]
    got = f.decode(mle.fix_last_variables(p_enc).evals)
    # oracle: fix last variable = stride 2^(nv-1) lerp
    cur = list(evals)
    for r in reversed(point):
        half = len(cur) // 2
        cur = [(cur[b] + r * (cur[b + half] - cur[b])) % q
               for b in range(half)]
    assert [int(v) for v in got] == cur


def test_dense_relabel():
    f = get_field("goldilocks")
    e = FieldElems(f)
    q = f.q
    rng = random.Random(33)
    nv = 5
    evals = [rng.randrange(q) for _ in range(1 << nv)]
    mle = DenseMLE.from_ints(e, nv, np.array(evals, dtype=object))
    a, b, k = 0, 3, 2
    out = [0] * (1 << nv)
    for i in range(1 << nv):
        out[swap_bits(i, a, b, k)] = evals[i]
    got = [int(v) for v in f.decode(mle.relabel(a, b, k).evals)]
    assert got == out


def test_dense_arith_and_merge():
    f = get_field("babybear")
    e = FieldElems(f)
    q = f.q
    rng = random.Random(34)
    nv = 3
    a = [rng.randrange(q) for _ in range(1 << nv)]
    b = [rng.randrange(q) for _ in range(1 << nv)]
    r = rng.randrange(q)
    ma = DenseMLE.from_ints(e, nv, np.array(a, dtype=object))
    mb = DenseMLE.from_ints(e, nv, np.array(b, dtype=object))
    rs = f.encode(np.array(r, dtype=object))
    assert [int(v) for v in f.decode(ma.add(mb).evals)] == \
        [(x + y) % q for x, y in zip(a, b)]
    assert [int(v) for v in f.decode(ma.sub(mb).evals)] == \
        [(x - y) % q for x, y in zip(a, b)]
    assert [int(v) for v in f.decode(ma.axpy(rs, mb).evals)] == \
        [(x + r * y) % q for x, y in zip(a, b)]
    merged = merge_polynomials([ma, mb, ma])
    assert merged.num_vars == nv + 2
    got = [int(v) for v in f.decode(merged.evals)]
    assert got == a + b + a + [0] * (1 << nv)


def test_random_mle_list_sum():
    f = get_field("goldilocks")
    e = FieldElems(f)
    rng = random.Random(35)
    mles, total = random_mle_list(e, 3, 2, rng)
    q = f.q
    a = [int(v) for v in f.decode(mles[0].evals)]
    b = [int(v) for v in f.decode(mles[1].evals)]
    assert int(f.decode(total)) == sum(x * y for x, y in zip(a, b)) % q


def test_identity_permutation_mles():
    f = get_field("goldilocks")
    e = FieldElems(f)
    mles = identity_permutation_mles(e, 2, 2)
    assert [int(v) for v in f.decode(mles[0].evals)] == [0, 1, 2, 3]
    assert [int(v) for v in f.decode(mles[1].evals)] == [4, 5, 6, 7]


@pytest.mark.parametrize("name", ["goldilocks", "stark_prime"])
def test_sparse_evaluate_and_fix(name):
    f = get_field(name)
    e = FieldElems(f)
    q = f.q
    rng = random.Random(36)
    nv = 6
    pairs = [(i, rng.randrange(q)) for i in
             rng.sample(range(1 << nv), 10)]
    sm = SparseMLE.from_pairs(e, nv, pairs)
    dense = [0] * (1 << nv)
    for i, v in pairs:
        dense[i] = v
    point = [rng.randrange(q) for _ in range(nv)]
    p_enc = [f.encode(np.array(p, dtype=object)) for p in point]
    got = int(f.decode(sm.evaluate(p_enc)))
    assert got == _eval_mle_ints(dense, point, q)
    # fix 2 then densify == oracle partial table
    part = sm.fix_variables(p_enc[:2]).to_dense()
    cur = list(dense)
    for r in point[:2]:
        half = len(cur) // 2
        cur = [(cur[2 * b] + r * (cur[2 * b + 1] - cur[2 * b])) % q
               for b in range(half)]
    assert [int(v) for v in f.decode(part.evals)] == cur
    # to_dense roundtrip
    assert [int(v) for v in f.decode(sm.to_dense().evals)] == dense


def test_mle_from_matrix_dense_and_sparse():
    f = get_field("goldilocks")
    e = FieldElems(f)
    q = f.q
    rng = random.Random(37)
    entries = [(0, 0, 5), (1, 2, 7), (2, 4, rng.randrange(q))]
    S = SparseMatrix.from_entries(e, 3, 5, entries)
    m_dense = DenseMLE.from_matrix(e, S)
    m_sparse = SparseMLE.from_matrix(e, S).to_dense()
    assert m_dense.num_vars == 2 + 3  # padded 4 rows x 8 cols
    want = [0] * 32
    for r, c, v in entries:
        want[8 * r + c] = v % q
    assert [int(v) for v in f.decode(m_dense.evals)] == want
    assert [int(v) for v in f.decode(m_sparse.evals)] == want


def test_ring_element_mle():
    """MLE over NTT-form ring elements (the reference is generic over
    R: Ring — exercise the ring instantiation)."""
    ring = get_ring("goldilocks")
    e = RingElems(ring)
    spec = ring.spec
    rng = random.Random(38)
    nv = 2
    evals = [[rng.randrange(spec.q) for _ in range(spec.D)]
             for _ in range(1 << nv)]
    point = [[rng.randrange(spec.q) for _ in range(spec.D)]
             for _ in range(nv)]
    mle = DenseMLE.from_ints(e, nv, np.array(evals, dtype=object))
    p_enc = [ring.encode_coeffs(np.array(p, dtype=object)) for p in point]
    got = list(ring.decode(mle.evaluate(p_enc)))
    # oracle in spec ints (NTT-form ring ops are slotwise)
    cur = [list(v) for v in evals]
    for r in point:
        half = len(cur) // 2
        nxt = []
        for b in range(half):
            diff = [(x - y) % spec.q for x, y in zip(cur[2 * b + 1], cur[2 * b])]
            prod = spec.ntt_mul(r, diff)
            nxt.append([(x + y) % spec.q for x, y in zip(cur[2 * b], prod)])
        cur = nxt
    assert got == cur[0]


@pytest.mark.parametrize("name", ["goldilocks", "stark_prime"])
def test_dense_from_evaluations_padded(name):
    """from_evaluations_vec_padded (dense.rs:79-89): short evaluation
    vectors zero-pad to 2^num_vars; evaluation agrees with the explicitly
    padded constructor (works for the limbed 252-bit field too)."""
    f = get_field(name)
    e = FieldElems(f)
    q = f.q
    rng = random.Random(78)
    nv = 4
    short = [rng.randrange(q) for _ in range(11)]
    evals = f.encode(np.array(short, dtype=object))
    import jax.numpy as jnp

    mle = DenseMLE.from_evaluations_padded(e, nv, jnp.asarray(evals))
    assert mle.evals.shape[0] == 1 << nv
    full = DenseMLE.from_ints(e, nv, np.array(short, dtype=object))
    point = [f.encode(np.array(rng.randrange(q), dtype=object))
             for _ in range(nv)]
    assert int(f.decode(mle.evaluate(point))) == \
        int(f.decode(full.evaluate(point)))
    padded = [int(v) for v in f.decode(mle.evals)]
    assert padded == short + [0] * (16 - 11)


def test_dense_from_evaluations_padded_truncates_long_input():
    """Vec::resize semantics (dense.rs:79-89): an input LONGER than
    2^num_vars is truncated, not rejected."""
    import jax.numpy as jnp

    f = get_field("goldilocks")
    e = FieldElems(f)
    rng = random.Random(79)
    nv = 3
    vals = [rng.randrange(f.q) for _ in range(13)]   # > 2^3
    evals = jnp.asarray(f.encode(np.array(vals, dtype=object)))
    mle = DenseMLE.from_evaluations_padded(e, nv, evals)
    assert mle.evals.shape[0] == 8
    assert [int(v) for v in f.decode(mle.evals)] == vals[:8]


def test_dense_index_degenerate_semantics():
    """Index/IndexMut parity (dense.rs:397-418): OOB reads (positions the
    reference's truncation dropped, and indices beyond 2^num_vars) are
    zero; set_index round-trips; beyond-elen writes raise."""
    import pytest

    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.linalg import FieldElems, RingElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.rings import get_ring

    f = get_field("goldilocks")
    e = FieldElems(f)
    m = DenseMLE.from_ints(e, 2, [7, 0, 5])      # padded with a zero
    assert int(f.decode(m.index(0))) == 7
    assert int(f.decode(m.index(3))) == 0        # truncated position
    assert int(f.decode(m.index(100))) == 0      # beyond elen -> zero
    m2 = m.set_index(3, e.encode(np.array(9, dtype=object)))
    assert int(f.decode(m2.index(3))) == 9
    assert int(f.decode(m.index(3))) == 0        # functional: original kept
    with pytest.raises(AssertionError):
        m.set_index(4, e.encode(np.array(1, dtype=object)))

    ring = get_ring("frog")
    er = RingElems(ring)
    rm = DenseMLE.rand(er, 2, random.Random(3))
    assert (np.asarray(er.decode(rm.index(8))) == 0).all()
    v = er.one()
    rm2 = rm.set_index(1, v)
    assert (np.asarray(rm2.index(1)) == np.asarray(v)).all()
