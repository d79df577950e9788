"""Digit-plane NTT for BabyBear power-of-two rings (BASELINE config 2).

Same pre-scaled-digit-weights construction as ops/mxu2.py, sized for a
31-bit modulus, with the same default scheme (mxu2.UNSIGNED_DIGITS).
Signed: 5 x 7-bit planes x 5 signed buckets = 25 MACs per modular MAC
with a 2^26 bucket bias.  Unsigned (``unsigned=True``): 4 unsigned
8-bit data planes x 4 unsigned weight digits = 16 MACs, bias-free.
Either way the fold is a single Montgomery REDC
because the bucket recombination fits in one u64 word:

* weights are pre-multiplied by ``2^32 mod q`` before digitization, so
  the REDC's ``2^-32`` cancels and the fold output is canonical;
* the packing is < q*2^32, so one REDC + one conditional subtract.

Generalizes the reference's BabyBear butterfly kernels
(/root/reference/crates/ring/src/cyclotomic_ring/models/babybear/ntt.rs:143-236)
to the power-of-two degrees of BASELINE config 2.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import get_field
from .ntt import find_primitive_root
from .mxu2 import UNSIGNED_DIGITS, Mxu2NTT, _digitize_signed_host

__all__ = ["MxuBBNTT", "BBPrescaledMat"]

_bb = get_field("babybear")
_Q = _bb.q                      # 2013265921 = 15 * 2^27 + 1
_QINV32 = pow(-_Q, -1, 1 << 32)  # -q^{-1} mod 2^32 (REDC constant)
_R32 = (1 << 32) % _Q

P_PLANES = 5    # 7-bit unsigned data digits covering 31 bits
D_BITS = 7
K_BUCKETS = 5   # signed 8-bit weight digits covering [0, 2^32)
B_BITS = 8

# unsigned scheme: 4 unsigned 8-bit data planes x 4 unsigned 8-bit
# weight digits = 16 MACs per modular MAC (vs 25 signed), bias-free.
P_PLANES_U8 = 4
D_BITS_U8 = 8
K_BUCKETS_U8 = 4

_BIAS_VAL = sum((1 << 26) << (B_BITS * k) for k in range(K_BUCKETS))
#: (BIAS * 2^-32) mod q — subtracted after the REDC fold
_BIAS_RED = np.uint32(_BIAS_VAL * pow(1 << 32, -1, _Q) % _Q)


class BBPrescaledMat:
    """Constant [R, C] BabyBear matrix with pre-scaled int8 digit planes.

    apply(x): x u32 [C, cols] -> M @ x mod q, u32 [R, cols], exact.
    """

    def __init__(self, m_ints, unsigned: bool = UNSIGNED_DIGITS):
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.K = K_BUCKETS_U8 if unsigned else K_BUCKETS
        if unsigned:
            assert P_PLANES_U8 * C * 255 * 255 < 2**31
            big = np.zeros((K_BUCKETS_U8 * R, P_PLANES_U8 * C),
                           dtype=np.uint8)
            mi = np.array([[int(v) for v in row] for row in m],
                          dtype=np.uint64)
            for l in range(P_PLANES_U8):
                scale = (1 << (D_BITS_U8 * l)) * _R32 % _Q
                v = (mi * scale) % _Q
                for k in range(K_BUCKETS_U8):
                    big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                        (v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.uint8)
            self.big = big
            return
        assert P_PLANES * C * 128 * 127 < 2**31
        big = np.zeros((K_BUCKETS * R, P_PLANES * C), dtype=np.int8)
        for l in range(P_PLANES):
            scale = (1 << (D_BITS * l)) * _R32 % _Q   # 2^(7l) * 2^32
            for r in range(R):
                for c in range(C):
                    dg = _digitize_signed_host(int(m[r, c]) * scale % _Q,
                                               k=K_BUCKETS)
                    for k in range(K_BUCKETS):
                        big[k * R + r, l * C + c] = dg[k]
        self.big = big  # numpy: safe to build inside a trace

    def planes(self, x):
        """u32 [C, cols] -> int8/uint8 [P*C, cols] of 7/8-bit digits."""
        if self.unsigned:
            return jnp.concatenate(
                [((x >> np.uint32(D_BITS_U8 * l))
                  & np.uint32(0xFF)).astype(jnp.uint8)
                 for l in range(P_PLANES_U8)], axis=0)
        outs = []
        for l in range(P_PLANES):
            outs.append(((x >> np.uint32(D_BITS * l))
                         & np.uint32(0x7F)).astype(jnp.int8))
        return jnp.concatenate(outs, axis=0)

    def fold(self, V):
        """int32 [K*R, cols] bucket planes -> canonical u32 [R, cols].

        value' = sum_k (V_k + 2^26) 2^(8k) < 2^59; REDC(value') divides
        by 2^32 (pre-absorbed into the weights) and the constant bias
        image is subtracted mod q."""
        R = self.R
        acc = jnp.zeros((R,) + V.shape[1:], dtype=jnp.uint64)
        for k in range(self.K):
            b = jax.lax.bitcast_convert_type(V[k * R:(k + 1) * R],
                                             jnp.uint32)
            if not self.unsigned:
                b = b + np.uint32(1 << 26)      # wraps to V_k + 2^26
            acc = acc + (b.astype(jnp.uint64) << np.uint64(B_BITS * k))
        # REDC: t = (acc + ((acc mod 2^32) * qinv mod 2^32) * q) >> 32
        m = (acc * np.uint64(_QINV32)) & np.uint64(0xFFFFFFFF)
        t = (acc + m * np.uint64(_Q)) >> np.uint64(32)
        t = jnp.where(t >= np.uint64(_Q), t - np.uint64(_Q), t)
        out = t.astype(jnp.uint32)
        if self.unsigned:
            return out
        # subtract the bias image mod q
        lt = out < _BIAS_RED
        return jnp.where(lt, out + np.uint32(_Q) - _BIAS_RED,
                         out - _BIAS_RED)

    def dot(self, x, big=None):
        w = self.big if big is None else big
        return jax.lax.dot(w, self.planes(x),
                           preferred_element_type=jnp.int32)

    def apply(self, x):
        return self.fold(self.dot(x))


class MxuBBNTT(Mxu2NTT):
    """Negacyclic BabyBear ring multiply for power-of-two N (config 2)."""

    F = _bb

    def __init__(self, N: int = 1 << 12, n1: int | None = None,
                 unsigned: bool = UNSIGNED_DIGITS):
        self.N = N
        self.unsigned = unsigned
        if n1 is None:
            logn = N.bit_length() - 1
            n1 = 1 << (logn // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
        q = _Q
        assert (q - 1) % (2 * N) == 0, "2N must divide q-1"
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        om = pow(psi, 2, q)
        om1 = pow(om, N2, q)
        om2 = pow(om, N1, q)
        psi_i = pow(psi, q - 2, q)
        om_i = pow(om, q - 2, q)
        om1_i = pow(om1, q - 2, q)
        om2_i = pow(om2, q - 2, q)
        n_inv = pow(N, q - 2, q)

        W1 = [[pow(om1, k1 * j, q) * pow(psi, j * N2, q) % q
               for j in range(N1)] for k1 in range(N1)]
        W2 = [[pow(om2, k2 * j, q) for j in range(N2)]
              for k2 in range(N2)]
        W2i = [[pow(om2_i, j * k2, q) for k2 in range(N2)]
               for j in range(N2)]
        W1i = [[pow(om1_i, j * k1, q) * pow(psi_i, j * N2, q)
                * n_inv % q for k1 in range(N1)] for j in range(N1)]
        self.mat1 = BBPrescaledMat(W1, unsigned)
        self.mat2 = BBPrescaledMat(W2, unsigned)
        self.mat2i = BBPrescaledMat(W2i, unsigned)
        self.mat1i = BBPrescaledMat(W1i, unsigned)

        # The pipeline runs on MONTGOMERY STORAGE end-to-end: the digit
        # matrices are exact linear maps (domain-preserving) and the
        # twiddle/pointwise muls go through F.mul (REDC), so the twiddle
        # tables carry the Montgomery factor 2^32.
        tw = np.empty((N1, N2), dtype=np.uint32)
        twi = np.empty((N2, N1), dtype=np.uint32)
        for k1 in range(N1):
            for j in range(N2):
                tw[k1, j] = (pow(psi, j, q) * pow(om, k1 * j, q)
                             % q) * _R32 % q
                twi[j, k1] = (pow(psi_i, j, q) * pow(om_i, k1 * j, q)
                              % q) * _R32 % q
        self.tw = tw
        self.twi = twi
