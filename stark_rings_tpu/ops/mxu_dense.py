"""One factory for constant modular matrices as int8 matmuls, any field.

``prescaled_dense(field, m_ints)`` returns a callable with the
ops/dense_linear.DenseModMat interface (``x [..., C(,L)] -> [..., R(,L)]``,
storage in, storage out, exact) backed by the int8 digit-plane matmul
construction of ops/mxu2.py:

* goldilocks — canonical u64 storage; fold via the 2^64 = 2^32 - 1
  reduction (PrescaledMat, ops/mxu2.py);
* babybear  — Montgomery u32 storage; single-word REDC fold
  (BBPrescaledMat, ops/mxu_bb.py);
* frog      — Montgomery u64 storage; generic 64-bit REDC fold
  (Mont64PrescaledMat, here);
* stark_prime — 8-limb Montgomery; word-REDC fold
  (LimbPrescaledMat, ops/mxu_limb.py).

This is what makes the four reference-model CRT/ICRT maps
(goldilocks/ntt.rs:68-127, babybear/ntt.rs:143-317, frog_ring/ntt.rs:108-191,
stark_prime/ntt.rs:121-346, each composed into one D x D matrix) run as
ONE int8 matmul + per-output fold instead of D*D emulated wide
multiplies.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import Field
from .mxu2 import UNSIGNED_DIGITS, _digitize_signed_host

__all__ = ["prescaled_dense", "Mont64PrescaledMat"]

_M32 = np.uint64(0xFFFFFFFF)

D_BITS = 7
B_BITS = 8
P64 = 10     # 7-bit planes covering 64 bits
K64 = 9      # signed 8-bit buckets covering [0, 2^64)

# unsigned u8 x u8 scheme: 8 planes x 8 buckets, bias-free folds
P64_U8 = 8
K64_U8 = 8


class Mont64PrescaledMat:
    """[R, C] constant matrix over a 64-bit Montgomery field (frog).

    Weights carry an extra 2^64 factor; the fold is one 64-bit REDC:
    packing the 9 biased buckets gives value < 2^91 = hi*2^64 + lo,
    REDC(value) = (value + (lo * q' mod 2^64) * q) / 2^64 < 2q.
    """

    def __init__(self, field: Field, m_ints,
                 unsigned: bool = UNSIGNED_DIGITS):
        self.f = field
        q = field.q
        assert not field.limbed and q.bit_length() <= 64
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.K = K64_U8 if unsigned else K64
        mont = pow(2, 64, q)
        self._qprime64 = np.uint64(pow(-q, -1, 1 << 64))
        self._q = np.uint64(q)
        if unsigned:
            assert P64_U8 * C * 255 * 255 < 2**31
            big = np.zeros((K64_U8 * R, P64_U8 * C), dtype=np.uint8)
            mi = np.array([[int(v) for v in row] for row in m],
                          dtype=object)
            for l in range(P64_U8):
                scale = pow(2, 8 * l, q) * mont % q
                v = (mi * scale) % q
                vv = v.astype(np.uint64)
                for k in range(K64_U8):
                    big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                        (vv >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.uint8)
            self.big = big
            self._bias_red = None
            return
        assert P64 * C * 128 * 127 < 2**31
        big = np.zeros((K64 * R, P64 * C), dtype=np.int8)
        for l in range(P64):
            scale = pow(2, D_BITS * l, q) * mont % q
            for r in range(R):
                for c in range(C):
                    dg = _digitize_signed_host(int(m[r, c]) * scale % q,
                                               k=K64)
                    for k in range(K64):
                        big[k * R + r, l * C + c] = dg[k]
        self.big = big  # numpy: safe to build inside a trace
        bias_val = sum((1 << 26) << (B_BITS * k) for k in range(K64))
        self._bias_red = np.uint64(bias_val * pow(1 << 64, -1, q) % q)

    def planes(self, x):
        """u64 [C, B] -> int8/uint8 [P*C, B]."""
        if self.unsigned:
            return jnp.concatenate(
                [((x >> np.uint64(8 * l)) & np.uint64(0xFF))
                 .astype(jnp.uint8) for l in range(P64_U8)], axis=0)
        outs = [((x >> np.uint64(D_BITS * l)) & np.uint64(0x7F))
                .astype(jnp.int8) for l in range(P64)]
        return jnp.concatenate(outs, axis=0)

    def fold(self, V):
        """int32 [K*R, B] -> storage u64 [R, B] (one 64-bit REDC).

        value = sum_k (V_k + 2^26) 2^(8k) < 2^91, accumulated as four
        base-2^32 words (each sum < 2^36, no overflow), then normalized
        to (hi, lo) u64 halves."""
        R = self.R
        zero = jnp.zeros((R,) + V.shape[1:], dtype=jnp.uint64)
        words = [zero, zero, zero, zero]
        for k in range(self.K):
            b = jax.lax.bitcast_convert_type(V[k * R:(k + 1) * R],
                                             jnp.uint32)
            if not self.unsigned:
                b = b + np.uint32(1 << 26)                 # < 2^27
            b = b.astype(jnp.uint64)
            pos = B_BITS * k
            j, sh = pos >> 5, pos & 31
            contrib = b << np.uint64(sh)                   # < 2^59
            words[j] = words[j] + (contrib & _M32)
            words[j + 1] = words[j + 1] + (contrib >> np.uint64(32))
        digits = []
        carry = zero
        for w in words:
            t = w + carry
            digits.append(t & _M32)
            carry = t >> np.uint64(32)
        lo = digits[0] | (digits[1] << np.uint64(32))
        hi = digits[2] | (digits[3] << np.uint64(32))      # < 2^27
        # REDC: m = lo * q' mod 2^64; t = hi + hi64(m*q) + carry_in,
        # where carry_in = 1 iff lo != 0 (low halves sum to exactly 2^64)
        m = lo * self._qprime64
        mq_hi, _ = _mul64_hi_lo(m, self._q)
        t = hi + mq_hi + (lo != np.uint64(0)).astype(jnp.uint64)
        t = jnp.where(t >= self._q, t - self._q, t)
        if self.unsigned:
            return t
        return self.f.sub(t, jnp.full_like(t, self._bias_red))

    def __call__(self, x, big=None):
        """``big`` passes the digit planes as a traced ARGUMENT:
        MB-scale constants embedded in the HLO slow compilation."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.C).T                    # [C, B]
        w = jnp.asarray(self.big) if big is None else big
        V = jax.lax.dot(w, self.planes(x2),
                        preferred_element_type=jnp.int32)
        y = self.fold(V)                                # [R, B]
        return y.T.reshape(lead + (self.R,))


def _mul64_hi_lo(a, b):
    """u64 x u64 -> (hi, lo) 128-bit product via 32-bit halves."""
    a_lo = a & _M32
    a_hi = a >> np.uint64(32)
    b_lo = b & _M32
    b_hi = b >> np.uint64(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> np.uint64(32)) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << np.uint64(32))
    hi = hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) \
        + (mid >> np.uint64(32))
    return hi, lo


class _Wrap2D:
    """[..., C] <-> [C, B] plumbing around a PrescaledMat-style core."""

    def __init__(self, core):
        self.core = core
        self.R, self.C = core.R, core.C

    def __call__(self, x, big=None):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.C).T
        y = self.core.fold(self.core.dot(x2, big))
        return y.T.reshape(lead + (self.R,))


def prescaled_dense(field: Field, m_ints,
                    unsigned: bool = UNSIGNED_DIGITS):
    """The int8 digit-plane implementation of ``x -> M @ x mod q`` for
    this field (``unsigned`` picks the digit scheme, see
    mxu2.UNSIGNED_DIGITS)."""
    if field.limbed:
        from .mxu_limb import LimbPrescaledMat

        return LimbPrescaledMat(field, m_ints, unsigned)
    if field.name == "goldilocks":
        from .mxu2 import PrescaledMat

        return _Wrap2D(PrescaledMat(m_ints, unsigned))
    if field.name == "babybear":
        from .mxu_bb import BBPrescaledMat

        return _Wrap2D(BBPrescaledMat(m_ints, unsigned))
    if field.name == "frog":
        return Mont64PrescaledMat(field, m_ints, unsigned)
    from .dense_linear import DenseModMat

    return DenseModMat(field, m_ints)
