"""Round-1 int8-limb modular linear algebra for Goldilocks: exact 64-bit
modular matrix multiplication as int8 matmuls.

Accelerators run int8 matmuls far faster than emulated 64-bit modular
multiplies.  This module makes them usable for exact mod-q arithmetic
(ops/mxu2.py supersedes it with pre-scaled weights):

* A constant matrix M (e.g. a 128-point NTT evaluation matrix) and the
  data x are decomposed into **7-bit unsigned digits held in int8**
  (10 digits cover 64 bits; 7 bits keep every value in [0,127] so the
  signed-int8 dot sees only nonnegative numbers).
* y = M @ x becomes a 10x10 grid of int8 matmuls with int32 accumulation,
  exact because 128 * 127^2 * 10 < 2^31.
* Digit-bucket sums (by exponent s = i+j) are carry-packed into base-2^32
  words and folded mod q with the Goldilocks identities
  2^64 = 2^32 - 1, 2^96 = -1, 2^128 = -2^32, 2^192 = 1 — a fixed ~60-op
  elementwise epilogue per output, no generic modmuls.

`MatmulNTT` builds the full degree-16384 (128x128) negacyclic transform
out of two such matmul levels (four-step: twist, column NTTs as ONE
matmul, twiddle, transpose, row NTTs as one matmul), in the same leaf
order as ops/ntt.py — bit-exact and interchangeable with NTTContext.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import GOLDILOCKS
from .ntt import NTTContext, find_primitive_root

__all__ = ["MxuModMat", "MatmulNTT"]

_Q = GOLDILOCKS.q
_DIGITS = 10          # ceil(64 / 7)
_DBITS = 7
_DMASK = np.uint64((1 << _DBITS) - 1)
_NBUCKETS = 2 * _DIGITS - 1


def _digits_host(v: int) -> list:
    return [(v >> (_DBITS * k)) & int(_DMASK) for k in range(_DIGITS)]


def _decompose_device(x):
    """u64 [...,] -> int8 [DIGITS, ...] of 7-bit digits."""
    planes = []
    for k in range(_DIGITS):
        d = (x >> np.uint64(_DBITS * k)) & _DMASK
        planes.append(d.astype(jnp.int8))
    return jnp.stack(planes, axis=0)


def _fold_buckets(V):
    """int32 buckets [NBUCKETS, ...] (nonnegative) -> canonical u64 mod q.

    value = sum_s V_s 2^(7s); packs into base-2^32 words then applies the
    Goldilocks power identities.
    """
    f = GOLDILOCKS
    n_words = (_DBITS * (_NBUCKETS - 1) + 31 + 32) // 32 + 1
    words = [jnp.zeros(V.shape[1:], dtype=jnp.uint64)
             for _ in range(n_words)]
    for s in range(_NBUCKETS):
        v = V[s].astype(jnp.uint64)
        r = _DBITS * s
        j, sh = r >> 5, r & 31
        contrib = v << np.uint64(sh)          # < 2^(31+31), fits u64
        words[j] = words[j] + (contrib & np.uint64(0xFFFFFFFF))
        words[j + 1] = words[j + 1] + (contrib >> np.uint64(32))
    # carry-normalize to digits < 2^32
    digits = []
    carry = jnp.zeros(V.shape[1:], dtype=jnp.uint64)
    for w in words:
        t = w + carry
        digits.append(t & np.uint64(0xFFFFFFFF))
        carry = t >> np.uint64(32)
    digits.append(carry)
    while len(digits) < 7:
        digits.append(jnp.zeros(V.shape[1:], dtype=jnp.uint64))
    d = digits
    A = d[0] | (d[1] << np.uint64(32))
    B = d[2] | (d[3] << np.uint64(32))
    C = d[4] | (d[5] << np.uint64(32))
    D = d[6]  # coefficient of 2^192 == 1 (mod q)
    # A + B*(2^32 - 1) - C*2^32 + D  (mod q)
    b32 = f._reduce128(B >> np.uint64(32), B << np.uint64(32))
    c32 = f._reduce128(C >> np.uint64(32), C << np.uint64(32))
    acc = f.add(f.reduce_u64(A), f.sub(b32, f.reduce_u64(B)))
    acc = f.sub(acc, c32)
    return f.add(acc, f.reduce_u64(D))


class MxuModMat:
    """Exact y = M @ x (mod q) with M a constant [R, C] Goldilocks matrix
    and x batched columns u64 [C, M_cols]."""

    def __init__(self, m_ints):
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        assert C * 127 * 127 * _DIGITS < 2**31, "int32 accumulation bound"
        planes = np.zeros((_DIGITS, R, C), dtype=np.int8)
        for r in range(R):
            for c in range(C):
                dg = _digits_host(int(m[r, c]) % _Q)
                for k in range(_DIGITS):
                    planes[k, r, c] = dg[k]
        self.planes = planes

    def apply(self, x):
        """x: u64 [C, M] -> u64 [R, M]."""
        xd = _decompose_device(x)                       # [K, C, M] int8
        P = jnp.einsum("kij,ljm->klim", self.planes, xd,
                       preferred_element_type=jnp.int32)
        V = []
        for s in range(_NBUCKETS):
            acc = None
            for k in range(_DIGITS):
                l = s - k
                if 0 <= l < _DIGITS:
                    t = P[k, l]
                    acc = t if acc is None else acc + t
            V.append(acc)
        V = jnp.stack(V, axis=0)                        # [S, R, M] int32
        return _fold_buckets(V)


class MatmulNTT:
    """Negacyclic NTT of size N = 128*128 as two MXU matmul levels.

    Same leaf order as NTTContext(N) — outputs/inputs interchangeable.
    """

    N1 = 128

    def __init__(self, N: int = 128 * 128):
        assert N == self.N1 * self.N1, "MatmulNTT currently supports N=16384"
        self.N = N
        self.N2 = N // self.N1
        f = GOLDILOCKS
        self.ctx = NTTContext(f, N, negacyclic=True)  # reference tables
        q = _Q
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        omega = pow(psi, 2, q)                       # order N
        col_ctx = NTTContext(f, self.N1, negacyclic=False)
        row_ctx = NTTContext(f, self.N2, negacyclic=False)
        om1 = pow(omega, self.N2, q)                 # order N1
        k1 = [e // 2 for e in col_ctx.leaf_exps]
        k2 = [e // 2 for e in row_ctx.leaf_exps]
        # column / row NTT matrices in leaf order
        W1 = [[pow(om1, ki * n1, q) for n1 in range(self.N1)] for ki in k1]
        om2 = pow(omega, self.N1, q)                 # order N2
        W2 = [[pow(om2, kj * n2, q) for n2 in range(self.N2)] for kj in k2]
        self.col_mat = MxuModMat(W1)
        self.row_mat = MxuModMat(W2)
        # inverse matrices
        W1i = [[pow(om1, (-k1j * n1) % self.N1, q) * pow(self.N1, q - 2, q)
                % q for k1j in k1] for n1 in range(self.N1)]
        W2i = [[pow(om2, (-k2j * n2) % self.N2, q) * pow(self.N2, q - 2, q)
                % q for k2j in k2] for n2 in range(self.N2)]
        self.col_mat_inv = MxuModMat(W1i)
        self.row_mat_inv = MxuModMat(W2i)
        # twist / twiddle tables (host -> numpy u64)
        tw = np.empty((self.N1, self.N2), dtype=np.uint64)
        tw_inv = np.empty_like(tw)
        psi_inv = pow(psi, q - 2, q)
        om_inv = pow(omega, q - 2, q)
        for n1 in range(self.N1):
            for n2 in range(self.N2):
                tw[n1, n2] = pow(psi, n1 * self.N2 + n2, q)
                tw_inv[n1, n2] = pow(psi_inv, n1 * self.N2 + n2, q)
        self.twist = tw
        self.twist_inv = tw_inv
        t2 = np.empty((self.N1, self.N2), dtype=np.uint64)
        t2i = np.empty_like(t2)
        for i, ki in enumerate(k1):
            for n2 in range(self.N2):
                t2[i, n2] = pow(omega, ki * n2, q)
                t2i[i, n2] = pow(om_inv, ki * n2, q)
        self.twiddle = t2
        self.twiddle_inv = t2i

    # layout helpers: x [B, N] <-> [N1, N2, B]-ish internal
    def forward(self, x):
        """x u64 [B, N] -> leaf-order evals [B, N] (same as ctx.forward)."""
        f = GOLDILOCKS
        B = x.shape[0]
        m = x.reshape(B, self.N1, self.N2)
        m = f.mul(m, self.twist[None])
        cols = jnp.transpose(m, (1, 2, 0)).reshape(self.N1, self.N2 * B)
        a = self.col_mat.apply(cols).reshape(self.N1, self.N2, B)
        a = f.mul(a, self.twiddle[:, :, None])
        # row transform: for each (leaf1, b): vector over n2
        rows = jnp.transpose(a, (1, 0, 2)).reshape(self.N2, self.N1 * B)
        y = self.row_mat.apply(rows).reshape(self.N2, self.N1, B)
        out = jnp.transpose(y, (2, 1, 0)).reshape(B, self.N)
        return out

    def inverse(self, y):
        f = GOLDILOCKS
        B = y.shape[0]
        m = y.reshape(B, self.N1, self.N2)
        rows = jnp.transpose(m, (2, 1, 0)).reshape(self.N2, self.N1 * B)
        a = self.row_mat_inv.apply(rows).reshape(self.N2, self.N1, B)
        a = jnp.transpose(a, (1, 0, 2))              # [N1, N2, B]
        a = f.mul(a, self.twiddle_inv[:, :, None])
        cols = a.reshape(self.N1, self.N2 * B)
        m2 = self.col_mat_inv.apply(cols).reshape(self.N1, self.N2, B)
        m2 = jnp.transpose(m2, (2, 0, 1))            # [B, N1, N2]
        m2 = f.mul(m2, self.twist_inv[None])
        return m2.reshape(B, self.N)

    def mul(self, a, b):
        f = GOLDILOCKS
        return self.inverse(f.mul(self.forward(a), self.forward(b)))
