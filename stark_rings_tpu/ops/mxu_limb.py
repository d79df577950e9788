"""Digit-plane matmul for LIMBED fields (the 252-bit stark prime).

The stark_prime dense CRT (a 16 x 16 constant matrix over the 252-bit
field, /root/reference/crates/ring/src/cyclotomic_ring/models/stark_prime/ntt.rs:121-234
composed into one linear map) does not use ops/dense_linear.py: the
DenseModMat formulation inlines 256 eight-limb CIOS multiplies, a ~10^5
-op graph.  This module applies the same pre-scaled digit-weight
construction as ops/mxu2.py, sized for an 8-limb modulus, with the same
default scheme (mxu2.UNSIGNED_DIGITS):

* data: 36 7-bit planes (signed scheme) or 32 unsigned 8-bit planes
  ALIGNED with the u32 storage limbs (unsigned scheme);
* weights: pre-multiplied by ``2^(bits*l) * 2^256 mod q`` and digitized
  into 33 signed (or 32 unsigned) 8-bit bucket planes, so ONE int8
  matmul ``[K*R, P*C] @ [P*C, B]`` replaces all R*C field multiplies;
* fold: bucket packing into base-2^32 words, then eight word-REDC
  rounds (the pre-absorbed 2^256 cancels) and one conditional
  subtract — ~64 u64 multiplies per OUTPUT instead of ~130 per
  MATRIX ENTRY.

Montgomery storage commutes with Fq-linear maps, so the matrix applies
to storage limbs directly (same argument as ops/dense_linear.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import Field
from .mxu2 import UNSIGNED_DIGITS, _digitize_signed_host

__all__ = ["LimbPrescaledMat", "MxuLimbNTT"]

_M32 = np.uint64(0xFFFFFFFF)

D_BITS = 7
B_BITS = 8


class LimbPrescaledMat:
    """Constant [R, C] matrix over a limbed field, as one int8 matmul.

    ``x``: storage uint32 [..., C, L] -> M @ x mod q, uint32 [..., R, L],
    exact.  Drop-in for ops/dense_linear.DenseModMat on limbed fields.
    """

    def __init__(self, field: Field, m_ints,
                 unsigned: bool = UNSIGNED_DIGITS):
        assert field.limbed
        self.f = field
        q = field.q
        L = field.N_LIMBS
        self.L = L
        self.unsigned = unsigned
        bits = 32 * L
        # q < 2^(32L): storage values have at most qbits = q.bit_length()
        qbits = q.bit_length()
        if unsigned:
            # u8 x u8 scheme: 8-bit digits align with the u32
            # limbs (no straddling) and buckets are nonnegative
            P = -(-qbits // 8)             # unsigned 8-bit data planes
            K = -(-qbits // B_BITS)        # unsigned 8-bit buckets
        else:
            P = -(-qbits // D_BITS)            # 7-bit data planes
            K = (qbits + B_BITS - 1) // B_BITS + 1  # signed 8-bit buckets
        self.P, self.K = P, K
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        Rmont = pow(2, bits, q)            # fold REDC divides by 2^(32L)
        if unsigned:
            assert P * C * 255 * 255 < 2**31, "int32 accumulation overflow"
            big = np.zeros((K * R, P * C), dtype=np.uint8)
            for l in range(P):
                scale = pow(2, 8 * l, q) * Rmont % q
                for r in range(R):
                    for c in range(C):
                        v = int(m[r, c]) * scale % q
                        for k in range(K):
                            big[k * R + r, l * C + c] = (v >> (8 * k)) & 0xFF
            self._bias_red = None
        else:
            assert P * C * 128 * 127 < 2**31, "int32 accumulation overflow"
            big = np.zeros((K * R, P * C), dtype=np.int8)
            for l in range(P):
                scale = pow(2, D_BITS * l, q) * Rmont % q
                for r in range(R):
                    for c in range(C):
                        dg = _digitize_signed_host(int(m[r, c]) * scale % q,
                                                   k=K)
                        for k in range(K):
                            big[k * R + r, l * C + c] = dg[k]
            bias_val = sum((1 << 26) << (B_BITS * k) for k in range(K))
            bias_red = bias_val * pow(1 << bits, -1, q) % q
            self._bias_red = np.array([(bias_red >> (32 * j)) & 0xFFFFFFFF
                                       for j in range(L)], dtype=np.uint32)
        # NB: all tables stay NUMPY — this object is cached on RingModel
        # and may be built inside a jit trace; jnp constants created
        # in-trace would leak tracers (see Field.encode).
        self.big = big
        # constants for the fold
        self._qprime32 = np.uint64(pow(-q, -1, 1 << 32))
        self._q_limbs = [np.uint64((q >> (32 * j)) & 0xFFFFFFFF)
                         for j in range(L)]
        #: words needed to hold sum_k v_k 2^(8k): 8(K-1)+31 bits
        self._n_words = (B_BITS * (K - 1) + 31) // 32 + 2

    # -- device pipeline ---------------------------------------------------
    def planes(self, x2):
        """storage u32 [B, C, L] -> int8/uint8 [P*C, B] digit planes."""
        outs = []
        if self.unsigned:
            # 8-bit digits align with the u32 limbs: no straddling
            for l in range(self.P):
                j, off = l >> 2, (l & 3) * 8
                lo = x2[..., j] >> np.uint32(off)
                outs.append((lo & np.uint32(0xFF)).astype(jnp.uint8))
        else:
            for l in range(self.P):
                pos = D_BITS * l
                j, off = pos >> 5, pos & 31
                lo = x2[..., j] >> np.uint32(off)
                if off > 32 - D_BITS and j + 1 < self.L:
                    lo = lo | (x2[..., j + 1] << np.uint32(32 - off))
                outs.append((lo & np.uint32(0x7F)).astype(jnp.int8))
        # [P, B, C] -> [P, C, B] -> [P*C, B]
        pl = jnp.stack(outs, axis=0)
        return jnp.transpose(pl, (0, 2, 1)).reshape(self.P * self.C, -1)

    def fold(self, V):
        """int32 [K*R, B] bucket planes -> canonical u32 [R, B, L].

        value = sum_k (V_k + 2^26) 2^(8k) (bias makes buckets
        nonnegative); eight REDC rounds divide by 2^256 (pre-absorbed
        into the weights); the constant bias image is subtracted mod q.
        """
        R, K, L = self.R, self.K, self.L
        B = V.shape[-1]
        zero = jnp.zeros((R, B), dtype=jnp.uint64)
        words = [zero] * self._n_words
        for k in range(K):
            b = jax.lax.bitcast_convert_type(V[k * R:(k + 1) * R],
                                             jnp.uint32)
            if not self.unsigned:
                b = b + np.uint32(1 << 26)
            b = b.astype(jnp.uint64)
            pos = B_BITS * k
            j, sh = pos >> 5, pos & 31
            contrib = b << np.uint64(sh)       # < 2^59
            words[j] = words[j] + (contrib & _M32)
            words[j + 1] = words[j + 1] + (contrib >> np.uint64(32))
        # carry-normalize to base-2^32 digits
        digits = []
        carry = zero
        for w in words:
            t = w + carry
            digits.append(t & _M32)
            carry = t >> np.uint64(32)
        digits.append(carry)
        digits.append(zero)
        # L REDC rounds: value /= 2^32 each (exact: digit 0 forced to 0)
        for _ in range(L):
            m = (digits[0] * self._qprime32) & _M32
            carry = zero
            for j in range(L):
                s = digits[j] + m * self._q_limbs[j] + carry
                digits[j] = s & _M32
                carry = s >> np.uint64(32)
            for j in range(L, len(digits)):
                s = digits[j] + carry
                digits[j] = s & _M32
                carry = s >> np.uint64(32)
            digits = digits[1:] + [zero]
        # REDC(T) < q + T/2^256 < 2q: one conditional subtract
        limbs = digits[:L]
        mask = self.f._geq_q(limbs)
        limbs = self.f._sub_q(limbs, mask)
        out = jnp.stack(limbs, axis=-1).astype(jnp.uint32)  # [R, B, L]
        if self.unsigned:
            return out
        return self.f.sub(out, self._bias_red)

    def __call__(self, x, big=None):
        """storage [..., C, L] -> [..., R, L] (DenseModMat interface).

        ``big`` lets callers pass the digit-plane weights as a traced
        argument instead of a closed-over constant (MB-scale literals
        embedded in the HLO slow compilation down)."""
        lead = x.shape[:-2]
        x2 = x.reshape((-1,) + x.shape[-2:])            # [B, C, L]
        w = self.big if big is None else big
        V = jax.lax.dot(w, self.planes(x2),
                        preferred_element_type=jnp.int32)
        y = self.fold(V)                                # [R, B, L]
        return jnp.transpose(y, (1, 0, 2)).reshape(lead + (self.R, self.L))


class MxuLimbNTT:
    """Four-step negacyclic ring multiply for LIMBED power-of-two rings
    (the 252-bit stark prime, 2-adicity 192: any N = N1*N2 works).

    Same twist/scale absorption as ops/mxu2.py's Mxu2NTT — the level
    matrices are LimbPrescaledMat int8 digit matmuls, the rank-1 mid
    twiddle and the pointwise product are 8-limb CIOS multiplies at XLA
    level (vectorized over all slots; the CIOS loop is ~500 tensor ops
    regardless of batch).  Coefficients in, coefficients out, storage
    (Montgomery) form end to end; bit-exact vs ops/ntt.NTTContext.

    Generalizes the reference's stark_prime negacyclic NTT
    (/root/reference/crates/ring/src/cyclotomic_ring/models/stark_prime/ntt.rs:121-234,
    D=16) to large degrees.
    """

    def __init__(self, field: Field, N: int, n1: int | None = None):
        from .ntt import find_primitive_root

        assert field.limbed
        self.f = field
        self.N = N
        q = field.q
        if n1 is None:
            n1 = 1 << ((N.bit_length() - 1) // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
        assert (q - 1) % (2 * N) == 0, "2N must divide q-1"
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        om = pow(psi, 2, q)
        om1, om2 = pow(om, N2, q), pow(om, N1, q)
        psi_i, om_i = pow(psi, q - 2, q), pow(om, q - 2, q)
        om1_i, om2_i = pow(om1, q - 2, q), pow(om2, q - 2, q)
        n_inv = pow(N, q - 2, q)

        W1 = [[pow(om1, k1 * j, q) * pow(psi, j * N2, q) % q
               for j in range(N1)] for k1 in range(N1)]
        W2 = [[pow(om2, k2 * j, q) for j in range(N2)]
              for k2 in range(N2)]
        W2i = [[pow(om2_i, j * k2, q) for k2 in range(N2)]
               for j in range(N2)]
        W1i = [[pow(om1_i, j * k1, q) * pow(psi_i, j * N2, q)
                * n_inv % q for k1 in range(N1)] for j in range(N1)]
        self.mat1 = LimbPrescaledMat(field, W1)
        self.mat2 = LimbPrescaledMat(field, W2)
        self.mat2i = LimbPrescaledMat(field, W2i)
        self.mat1i = LimbPrescaledMat(field, W1i)

        tw = np.empty((N2, N1), dtype=object)   # [n2, k1] broadcast layout
        twi = np.empty((N1, N2), dtype=object)  # [k1, n2]
        for k1 in range(N1):
            for j in range(N2):
                tw[j, k1] = pow(psi, j, q) * pow(om, k1 * j, q) % q
                twi[k1, j] = pow(psi_i, j, q) * pow(om_i, k1 * j, q) % q
        self.tw = field.encode(tw)      # numpy storage [n2, k1, L]
        self.twi = field.encode(twi)    # numpy storage [k1, n2, L]

    # -- layout: internal [B, n2, n1, L] / NTT domain [B, k1, k2, L] ----
    def _to_internal(self, x):
        B = x.shape[0]
        v = x.reshape(B, self.N1, self.N2, self.f.N_LIMBS)
        return jnp.swapaxes(v, 1, 2)

    def _from_internal(self, v):
        B = v.shape[0]
        return jnp.swapaxes(v, 1, 2).reshape(B, self.N, self.f.N_LIMBS)

    # -- traced-constants plumbing (see Mxu2NTT.consts) --------------------
    def consts(self):
        """All weight/twiddle tables as a pytree, to pass as jit
        ARGUMENTS rather than HLO constants."""
        return {"w1": self.mat1.big, "w2": self.mat2.big,
                "w2i": self.mat2i.big, "w1i": self.mat1i.big,
                "tw": self.tw, "twi": self.twi}

    def _c(self, c, key):
        return None if c is None else c[key]

    def forward_internal(self, v, c=None):
        """[B, n2, n1, L] coeffs -> [B, k1, k2, L] evaluations."""
        a = self.mat1(v, self._c(c, "w1"))     # contract n1 -> [B, n2, k1, L]
        tw = self.tw if c is None else c["tw"]
        a = self.f.mul(a, tw)                  # mid twiddle (broadcast)
        a = jnp.swapaxes(a, 1, 2)              # [B, k1, n2, L]
        return self.mat2(a, self._c(c, "w2"))  # contract n2 -> [B, k1, k2, L]

    def inverse_internal(self, y, c=None):
        a = self.mat2i(y, self._c(c, "w2i"))   # [B, k1, n2, L]
        twi = self.twi if c is None else c["twi"]
        a = self.f.mul(a, twi)
        a = jnp.swapaxes(a, 1, 2)              # [B, n2, k1, L]
        return self.mat1i(a, self._c(c, "w1i"))  # [B, n2, n1, L]

    def forward(self, x, c=None):
        return self.forward_internal(self._to_internal(x), c)

    def inverse(self, y, c=None):
        return self._from_internal(self.inverse_internal(y, c))

    def mul(self, a, b, c=None):
        """[B, N, L] x [B, N, L] -> [B, N, L] negacyclic product."""
        fa = self.forward(a, c)
        fb = self.forward(b, c)
        return self.inverse(self.f.mul(fa, fb), c)

    def precompute(self, b, c=None):
        """Cached-operand state (forward evaluations) for mul_cached —
        the fixed-operand protocol pattern (see Mxu2NTT.precompute)."""
        return self.forward(b, c)

    def mul_cached(self, a, fb, c=None):
        """Multiply by a precomputed operand: one forward saved."""
        return self.inverse(self.f.mul(self.forward(a, c), fb), c)

    def square(self, a, c=None):
        fa = self.forward(a, c)
        return self.inverse(self.f.mul(fa, fa), c)

    def jit_mul(self):
        """Jitted multiply with the tables passed as arguments
        (device_put once)."""
        import jax as _jax

        c = _jax.device_put(self.consts())
        fn = _jax.jit(lambda cc, a, b: self.mul(a, b, cc))
        return lambda a, b: fn(c, a, b)
