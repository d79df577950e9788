"""Dense-MLE full evaluation as two exact int8 contractions.

A full evaluation of a 2^nv-entry multilinear table T at a point
(r_0..r_{nv-1}) factors through the table reshaped as a matrix:

    eval = u^T M v,   M = T.reshape(2^(nv-hl), 2^hl)   (row = HIGH bits)
    v[c] = prod_{j<hl}  eq(bit_j(c), r_j)       (low-half eq vector)
    u[r] = prod_{j>=hl} eq(bit_{j-hl}(r), r_j)  (high-half eq vector)

because the little-endian index splits as i = r * 2^hl + c (the same
index convention as the reference's DenseMultilinearExtension,
/root/reference/crates/poly/src/mle/dense.rs:107-113).  Both
contractions run EXACTLY as int8 matmuls with the digit-plane
construction of ops/mxu2.py — but with *runtime* weights: the eq vector
is prescaled by 2^(7l) mod q per data plane and digitized to signed
8-bit planes on device (a few thousand modmuls), so the 2^nv-modmul
lerp chain of the halving loop (DenseMLE.evaluate) becomes one
[K, P*R] @ [P*R, C] int8 matmul plus epilogues.  ``unsigned`` selects
the digit scheme (default mxu2.UNSIGNED_DIGITS); the unsigned scheme
covers contractions up to _U8_MAX_R rows and falls back to the signed
one beyond.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import GOLDILOCKS as _f
from ..ops.mxu2 import (B_BITS, D_BITS, K_BUCKETS, P_PLANES,
                        K_BUCKETS_U8, P_PLANES_U8, UNSIGNED_DIGITS)

__all__ = ["evaluate_goldilocks_mxu", "evaluate_many_goldilocks_mxu",
           "fix_last_variables_mxu"]

_Q = _f.q
_MASK32 = np.uint64(0xFFFFFFFF)

#: longest contraction the unsigned u8 x u8 scheme supports (int32
#: bucket bound P * R * 255^2 < 2^31); longer contractions fall back to
#: the signed 7-bit scheme, which reaches R = 2^13 (tables to 2^26)
_U8_MAX_R = (2**31 - 1) // (P_PLANES_U8 * 255 * 255)


def _bias_bits(R):
    """Bucket bias exponent for contraction length R: the int8 dot's
    buckets satisfy |V_k| <= P * R * 127 * 128, so 2^bits must exceed
    that; the int32 accumulator bound caps R at 2^13 (tables to 2^26)."""
    assert P_PLANES * R * 127 * 128 < 2**31, \
        "contraction too long for int32 bucket accumulation"
    return (P_PLANES * R * 127 * 128).bit_length()


def _eq_vector(pts):
    """[2^h] little-endian eq vector: w[c] = prod_j eq(bit_j(c), r_j)."""
    one = jnp.asarray(np.uint64(1))
    w = jnp.ones((1,), dtype=jnp.uint64)
    for r in pts:                 # each new point becomes the next-higher bit
        r = jnp.asarray(r, dtype=jnp.uint64)
        w = jnp.concatenate([_f.mul(w, _f.sub(one, r)), _f.mul(w, r)])
    return w


def _digitize_signed(x):
    """canonical u64 [n] -> int8 [K, n] with x = sum_k d_k 2^(8k)."""
    outs = []
    carry = jnp.zeros_like(x)
    cur = x
    for _ in range(K_BUCKETS - 1):
        m = (cur & np.uint64(0xFF)) + carry
        ge = m >= np.uint64(128)
        outs.append((m.astype(jnp.int32)
                     - 256 * ge.astype(jnp.int32)).astype(jnp.int8))
        carry = ge.astype(jnp.uint64)
        cur = cur >> np.uint64(8)
    outs.append((cur + carry).astype(jnp.int8))
    return jnp.stack(outs)


def _weights(u):
    """canonical u64 [n] -> prescaled signed planes int8 [K, P*n].

    Column block l holds digitize(u * 2^(7l) mod q) — the runtime
    equivalent of PrescaledMat's host-side weight build (ops/mxu2.py).
    """
    blocks = []
    for l in range(P_PLANES):
        s = _f.mul(u, jnp.asarray(np.uint64(pow(2, D_BITS * l, _Q))))
        blocks.append(_digitize_signed(s))
    return jnp.concatenate(blocks, axis=1)


def _weights_rows(U):
    """canonical u64 [W, n] -> int8 [K*W, P*n] signed digit planes.

    Row block k holds signed digit k of every row's prescaled weights
    (the signed counterpart of _weights_u8_rows)."""
    W, n = U.shape
    blocks = []
    for l in range(P_PLANES):
        s = _f.mul(U, jnp.asarray(np.uint64(pow(2, D_BITS * l, _Q))))
        blocks.append(_digitize_signed(s).reshape(K_BUCKETS * W, n))
    return jnp.concatenate(blocks, axis=1)


def _planes(x):
    """u64 [R, C] -> int8 [P*R, C] of 7-bit digit planes (l-major)."""
    return jnp.concatenate(
        [((x >> np.uint64(D_BITS * l)) & np.uint64(0x7F)).astype(jnp.int8)
         for l in range(P_PLANES)], axis=0)


def _weights_u8(u):
    """canonical u64 [n] -> prescaled unsigned planes uint8 [K8, P8*n].

    Unsigned base-256 digitization is carry-free: just shifts+masks of
    the prescaled values (the runtime analogue of PrescaledMat's
    unsigned scheme)."""
    blocks = []
    for l in range(P_PLANES_U8):
        s = _f.mul(u, jnp.asarray(np.uint64(pow(2, 8 * l, _Q))))
        blocks.append(jnp.stack(
            [((s >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(jnp.uint8)
             for k in range(K_BUCKETS_U8)]))
    return jnp.concatenate(blocks, axis=1)


def _weights_u8_rows(U):
    """canonical u64 [W, n] -> uint8 [K8*W, P8*n] digit planes.

    Row block k holds digit k of every row's prescaled weights, so one
    int8 dot contracts ALL W weight rows against the shared data planes
    (out[k*W + w, c] = bucket k of sum_n U[w, n] * M[n, c])."""
    blocks = []
    for l in range(P_PLANES_U8):
        s = _f.mul(U, jnp.asarray(np.uint64(pow(2, 8 * l, _Q))))
        blocks.append(jnp.concatenate(
            [((s >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(jnp.uint8)
             for k in range(K_BUCKETS_U8)], axis=0))
    return jnp.concatenate(blocks, axis=1)


def _planes_u8(x):
    """u64 [R, C] -> uint8 [P8*R, C] of 8-bit digit planes (l-major)."""
    return jnp.concatenate(
        [((x >> np.uint64(8 * l)) & np.uint64(0xFF)).astype(jnp.uint8)
         for l in range(P_PLANES_U8)], axis=0)


def _fold(V, bias_bits=None):
    """int32 [K, C] buckets -> canonical u64 [C].

    Signed scheme (bias_bits set): value =
    sum_k (V_k + 2^bias_bits) 2^(8k) - BIAS (mod q).  Unsigned scheme
    (bias_bits None, K = V.shape[0]): buckets already nonnegative."""
    K = V.shape[0]
    if bias_bits is None:
        bias = None
        bias_mod = None
        n_words = (B_BITS * (K - 1) + 31) // 32 + 1
    else:
        bias = np.uint64(1 << bias_bits)
        bias_val = sum((1 << bias_bits) << (B_BITS * k)
                       for k in range(K))
        bias_mod = jnp.asarray(np.uint64(bias_val % _Q))
        n_words = (B_BITS * (K - 1) + bias_bits + 1) // 32 + 1
    words = [None] * (n_words + 1)
    for k in range(K):
        if bias is None:
            v = V[k].astype(jnp.uint64)
        else:
            v = (V[k].astype(jnp.int64) + jnp.int64(bias)).astype(jnp.uint64)
        r = B_BITS * k
        j, sh = r >> 5, r & 31
        contrib = v << np.uint64(sh)
        lo = contrib & _MASK32
        hi = contrib >> np.uint64(32)
        words[j] = lo if words[j] is None else words[j] + lo
        words[j + 1] = hi if words[j + 1] is None else words[j + 1] + hi
    zero = jnp.zeros_like(words[0])
    words = [w if w is not None else zero for w in words]
    digits = []
    carry = zero
    for w in words:
        t = w + carry
        digits.append(t & _MASK32)
        carry = t >> np.uint64(32)
    digits.append(carry)
    while len(digits) < 4:
        digits.append(zero)
    A = digits[0] | (digits[1] << np.uint64(32))
    Bw = digits[2] | (digits[3] << np.uint64(32))
    acc = _f._reduce128(Bw, A)
    if bias_mod is None:
        return acc
    return _f.sub(acc, bias_mod)


def fix_last_variables_mxu(evals, pts_high, unsigned=UNSIGNED_DIGITS):
    """Fix the HIGHEST len(pts_high) variables in one int8 contraction.

    ``evals``: canonical u64 [2^nv]; returns the [2^(nv-h)] table of the
    remaining low variables — equals the reference's fix_last_variables
    (multilinear_polynomial.rs:227-286) restricted to the last h
    variables, computed as u^T M instead of h halving passes.
    """
    h = len(pts_high)
    n = evals.shape[0]
    R = 1 << h
    C = n // R
    assert R * C == n
    if R < 8:
        # one or two halving passes beat the matmul AND the tiny-K int8
        # GEMM trips an XLA CPU lowering bug (see evaluate fallback)
        ev = evals
        for r in reversed(list(pts_high)):
            half = ev.shape[0] // 2
            left, right = ev[:half], ev[half:]
            ev = _f.add(left, _f.mul(jnp.asarray(r, dtype=jnp.uint64),
                                     _f.sub(right, left)))
        return ev
    M = evals.reshape(R, C)
    u = _eq_vector(pts_high)
    if unsigned and R <= _U8_MAX_R:
        V = jax.lax.dot(_weights_u8(u), _planes_u8(M),
                        preferred_element_type=jnp.int32)
        return _fold(V)
    V = jax.lax.dot(_weights(u), _planes(M),
                    preferred_element_type=jnp.int32)
    return _fold(V, _bias_bits(R))


def evaluate_many_goldilocks_mxu(evals, pts_batch,
                                 unsigned=UNSIGNED_DIGITS):
    """Evaluate one dense Goldilocks MLE at W points, sharing the table
    read: Y = U M (one contraction for ALL points), then per-point
    row-column products — the batched-opening shape of a sumcheck /
    PCS prover.  ``pts_batch``: [W, nv] canonical u64 array (or list of
    point lists).  Returns canonical u64 [W]; equals
    evaluate_goldilocks_mxu applied per point (tested).
    """
    P = jnp.asarray(pts_batch, dtype=jnp.uint64)
    W, nv = P.shape
    assert evals.shape == (1 << nv,)
    if nv < 4:
        w = jax.vmap(lambda p: _eq_vector(list(p)))(P)       # [W, 2^nv]
        return _f.sum(_f.mul(evals[None, :], w), axis=1)
    hl = nv // 2
    C = 1 << hl
    R = (1 << nv) // C
    M = evals.reshape(R, C)
    U = jax.vmap(lambda p: _eq_vector(list(p)))(P[:, hl:])   # [W, R]
    Vv = jax.vmap(lambda p: _eq_vector(list(p)))(P[:, :hl])  # [W, C]
    if not unsigned:
        # Y[w, c] = sum_r U[w, r] M[r, c] — ONE dot for all W points
        Vb = jax.lax.dot(_weights_rows(U), _planes(M),
                         preferred_element_type=jnp.int32)   # [K*W, C]
        Y = _fold(Vb.reshape(K_BUCKETS, W * C),
                  _bias_bits(R)).reshape(W, C)
        yp = jnp.concatenate(
            [((Y >> np.uint64(D_BITS * l)) & np.uint64(0x7F)).astype(
                jnp.int8) for l in range(P_PLANES)], axis=1)  # [W, P*C]
        wv = _weights_rows(Vv).reshape(K_BUCKETS, W, P_PLANES * C)
        V2 = jnp.einsum("kwp,wp->kw", wv.astype(jnp.int32),
                        yp.astype(jnp.int32))                # exact int32
        return _fold(V2, _bias_bits(C))
    assert R <= _U8_MAX_R and C <= _U8_MAX_R, \
        "the unsigned point-batched evaluation supports tables to 2^24"
    # Y[w, c] = sum_r U[w, r] M[r, c] — ONE dot for all W points
    Vb = jax.lax.dot(_weights_u8_rows(U), _planes_u8(M),
                     preferred_element_type=jnp.int32)       # [K8*W, C]
    Y = _fold(Vb.reshape(K_BUCKETS_U8, W * C)).reshape(W, C)
    # eval[w] = sum_c Y[w, c] Vv[w, c]: digit-expand Y rowwise, contract C
    yp = jnp.concatenate(
        [((Y >> np.uint64(8 * l)) & np.uint64(0xFF)).astype(jnp.uint8)
         for l in range(P_PLANES_U8)], axis=1)               # [W, P8*C]
    wv = _weights_u8_rows(Vv).reshape(
        K_BUCKETS_U8, W, P_PLANES_U8 * C)                    # [K8, W, P8*C]
    V2 = jnp.einsum("kwp,wp->kw", wv.astype(jnp.int32),
                    yp.astype(jnp.int32))                    # exact int32
    return _fold(V2)


def evaluate_goldilocks_mxu(evals, pts, unsigned=UNSIGNED_DIGITS):
    """Full evaluation of a dense Goldilocks MLE at one point.

    ``evals``: canonical u64 [2^nv]; ``pts``: nv scalars (host or
    traced).  Returns the canonical u64 scalar; equals
    DenseMLE.evaluate exactly.
    """
    nv = len(pts)
    assert evals.shape == (1 << nv,)
    if nv < 4:
        # tiny tables: direct eq inner product (the int8 GEMM this size
        # also trips an XLA CPU lowering bug)
        w = _eq_vector(pts)
        return _f.sum(_f.mul(evals, w), axis=0)
    hl = nv // 2
    C = 1 << hl
    R = (1 << nv) // C
    M = evals.reshape(R, C)
    u = _eq_vector(pts[hl:])       # [R] high-half eq
    v = _eq_vector(pts[:hl])       # [C] low-half eq
    # y[c] = sum_r u[r] M[r, c]  — contraction over rows, exact
    if unsigned and R <= _U8_MAX_R:
        Vb = jax.lax.dot(_weights_u8(u), _planes_u8(M),
                         preferred_element_type=jnp.int32)
        y = _fold(Vb)              # [C]
    else:
        Vb = jax.lax.dot(_weights(u), _planes(M),
                         preferred_element_type=jnp.int32)
        y = _fold(Vb, _bias_bits(R))   # [C]
    # eval = sum_c y[c] v[c]
    if unsigned and C <= _U8_MAX_R:
        Vb2 = jax.lax.dot(_weights_u8(v), _planes_u8(y[:, None]),
                          preferred_element_type=jnp.int32)
        return _fold(Vb2)[0]
    Vb2 = jax.lax.dot(_weights(v), _planes(y[:, None]),
                      preferred_element_type=jnp.int32)
    return _fold(Vb2, _bias_bits(C))[0]
