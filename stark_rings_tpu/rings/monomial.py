"""Monomial algebra (reference crates/ring/src/monomial.rs:17-93):
monomials, the psi table, exp/exp_signed, and the psi range check used by
monomial range proofs."""

from __future__ import annotations

import numpy as np

from ..spec.field import sign as spec_sign, to_signed
from .ring import RingModel

__all__ = ["monomial", "unit_monomial", "zero_monomial", "psi", "exp",
           "exp_signed", "psi_range_check", "MonomialError"]


class MonomialError(ValueError):
    """Mirror of MonomialError (monomial.rs:6-12)."""


def monomial(ring: RingModel, i: int, coeff: int = 1, shape=()):
    """coeff * X^i in coefficient form (monomial.rs:17-21)."""
    out = np.zeros(tuple(shape) + (ring.D,), dtype=object)
    out[..., i] = coeff % ring.q
    return ring.encode_coeffs(out)


def unit_monomial(ring: RingModel, i: int, shape=()):
    return monomial(ring, i, 1, shape)


def zero_monomial(ring: RingModel, shape=()):
    return ring.zeros(shape)


def _psi_int_coeffs(ring: RingModel):
    """psi's integer coefficient vector — the ONE definition both
    :func:`psi` and :func:`_ct_psi_table` build from."""
    q, D = ring.q, ring.D
    out = [0] * D
    for i in range(1, D // 2):
        out[i] = (out[i] + i) % q
        out[D - i] = (out[D - i] - i) % q
    return out


def psi(ring: RingModel):
    """psi = sum_{i in [1, d')} i (X^{-i} + X^i), d' = d/2
    (monomial.rs:36-48; X^{-i} contributes -X^{d-i})."""
    return ring.encode_coeffs(np.array(_psi_int_coeffs(ring),
                                       dtype=object))


def exp(ring: RingModel, a: int):
    """exp(a) = X^{center(a)} if sign(a) = +1 else X^{d - center(a)}
    (monomial.rs:55-65).  `a` is a canonical base-field integer."""
    q, D = ring.q, ring.D
    centered = abs(to_signed(a, q))
    if centered >= D and spec_sign(a, q) == 1:
        raise MonomialError(f"exponent {centered} out of monomial range")
    if spec_sign(a, q) == 1:
        return unit_monomial(ring, centered)
    if centered > D:
        raise MonomialError(f"exponent {centered} out of monomial range")
    return unit_monomial(ring, (D - centered) % D)


def exp_signed(ring: RingModel, a: int):
    """exp_signed(a) = sign(a) * X^{center(a)} (monomial.rs:71-76)."""
    q = ring.q
    centered = abs(to_signed(a, q))
    if centered >= ring.D:
        raise MonomialError(f"exponent {centered} out of monomial range")
    return monomial(ring, centered, spec_sign(a, q))


def ct(ring: RingModel, x):
    """Constant term (CoeffRing::ct, poly_ring.rs:19-42)."""
    f = ring.field
    return f.take_coeff(x, np.array(0, dtype=np.int32))


def psi_range_check(ring: RingModel, a: int) -> bool:
    """ct(psi * exp(a)) == a  <=>  a in (-d', d')  (monomial.rs:82-93)."""
    try:
        b = exp(ring, a)
    except MonomialError:
        return False
    prod = ring.coeff_mul(psi(ring), b)
    c = ring.field.decode(ct(ring, prod))
    return int(c) == a % ring.q


def _exp_pos_batched(ring: RingModel, a):
    """Batched exp() exponent: storage [...] -> (pos int32 [...], valid).

    ``pos`` is the monomial exponent exp(a) = X^pos would use; where the
    reference would panic (centered > D, or centered >= D with positive
    sign), ``valid`` is False (``pos`` is then garbage — callers mask)."""
    import jax.numpy as jnp

    f, D = ring.field, ring.D
    vm = f.canon(a)                        # canonical |a|
    vneg = f.canon(f.neg(a))               # canonical q - a
    half = f.canon_const((ring.q - 1) // 2)
    is_pos = f.geq(half, vm)               # sign(a) = +1  (incl. a = 0)
    centered = f.select(is_pos, vm, vneg)  # |center(a)| as canonical
    if f.limbed:
        high_zero = jnp.all(centered[..., 1:] == 0, axis=-1)
        small = centered[..., 0]
    else:
        high_zero = jnp.ones(jnp.shape(centered), dtype=bool)
        small = centered
    sm = jnp.where(high_zero, small, 0).astype(jnp.int32)
    pos = jnp.where(jnp.asarray(is_pos), sm, (D - sm) % D)
    valid = jnp.asarray(high_zero) & jnp.where(
        jnp.asarray(is_pos), sm < D, sm <= D)
    return pos, valid


def exp_batched(ring: RingModel, a):
    """Batched exp(): storage [...] -> (monomials [..., D(,L)], valid [...]).

    Device-side mirror of :func:`exp` over a whole witness tensor: where
    the reference would panic (centered > D, or centered >= D with
    positive sign), ``valid`` is False and the monomial is zero.
    """
    import jax.numpy as jnp

    f, D = ring.field, ring.D
    pos, valid = _exp_pos_batched(ring, a)
    onehot = (jnp.arange(D, dtype=jnp.int32) == pos[..., None])
    onehot = onehot & valid[..., None]
    mono = f.select(onehot, f.ones(onehot.shape), f.zeros(onehot.shape))
    return mono, valid


def _ct_psi_table(ring: RingModel):
    """Canonical storage [D(,L)] table of ct(psi * X^p) for p in [0, D).

    ct(psi * exp(a)) only ever reads the CONSTANT term of the product,
    and exp(a) is a monomial — so the full D^2 schoolbook multiply of
    the naive check collapses to this fixed table, built once per ring
    on the integer-exact spec oracle (spec/models.py coeff_mul)."""
    tbl = getattr(ring, "_ct_psi_cache", None)
    if tbl is None:
        D = ring.D
        psi_ints = _psi_int_coeffs(ring)
        rows = []
        for p in range(D):
            xp = [0] * D
            xp[p] = 1
            rows.append(ring.spec.coeff_mul(psi_ints, xp)[0])
        tbl = np.asarray(ring.field.encode(np.array(rows, dtype=object)))
        ring._ct_psi_cache = tbl
    return tbl


def psi_range_check_batched(ring: RingModel, a):
    """Batched psi range check: storage tensor [...] -> bool [...].

    One traced graph range-checks a whole witness tensor on device
    (monomial.rs:82-93 per element): valid(exp) AND ct(psi * exp(a)) == a.

    ct(psi * X^pos) is a lookup in the precomputed D-entry
    :func:`_ct_psi_table` — no ring multiply per element (the naive
    formulation cost ~D x the Ajtai commit and kept the range check out
    of measured protocol rates).  The lookup is an UNROLLED chain of D
    selects, not ``jnp.take``: D elementwise selects fuse into the
    surrounding elementwise code of the composed step, where a gather
    need not.  Exactly equal to the onehot + ``coeff_mul``
    formulation on every input, valid or not: for valid exponents both
    read ct(psi * X^pos); for invalid ones the result is False either
    way (``valid`` gates, and no garbage table entry can collide with a
    canonical |center| >= D input)."""
    import jax.numpy as jnp

    f, D = ring.field, ring.D
    pos, valid = _exp_pos_batched(ring, a)
    tbl = _ct_psi_table(ring)                    # host numpy [D(, l)]
    pos_m = jnp.remainder(pos, D)
    if f.limbed:
        c = jnp.broadcast_to(jnp.asarray(tbl[0]),
                             pos.shape + (tbl.shape[-1],))
        for p in range(1, D):
            c = jnp.where((pos_m == p)[..., None], jnp.asarray(tbl[p]), c)
    else:
        c = jnp.broadcast_to(jnp.asarray(tbl[0]), pos.shape)
        for p in range(1, D):
            c = jnp.where(pos_m == p, jnp.asarray(tbl[p]), c)
    eq = c == a
    if f.limbed:
        eq = jnp.all(eq, axis=-1)
    return jnp.asarray(valid) & eq
