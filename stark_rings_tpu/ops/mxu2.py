"""Digit-plane NTT: deg-2^16 Goldilocks negacyclic transform as TWO
256x256 modular matmul levels with *pre-scaled* int8 digit weights.

Key ideas over ops/mxu.py (the round-1 int8-limb path):

* **Pre-scaled weights kill the bucket blow-up.**  For data digit plane
  ``l``, the weight matrix is pre-multiplied by ``2^(bits*l) mod q`` and
  THEN digitized.  The digit-pair grid of ops/mxu.py (10x10 products, 19
  buckets) collapses into ONE 8-bit matmul

      big[K*R, P*C] @ planes[P*C, cols]  ->  V[K*R, cols]   (int32)

  Two exact digit schemes exist; :data:`UNSIGNED_DIGITS` picks the
  default for every digit-plane engine.  Signed (the default): P=10
  7-bit data planes x K=9 signed weight digits = 90 MACs per 64-bit
  modular MAC, with a 2^26 bucket bias removed in the fold.  Unsigned
  (``unsigned=True``): base-256 digits on both sides, P = K = 8 = 64
  MACs and bias-free folds.
* **XLA-level dots.**  The matmuls are plain ``lax.dot`` calls with
  int32 accumulation, and the epilogues (digit fold, twiddles) are
  fused elementwise XLA ops on u64.
* **Twist/scale absorption.**  The negacyclic twist psi^(n1*N2), the
  1/N scale and psi^-..., are absorbed into the constant level matrices;
  only the rank-1 mid-twiddle psi^n2 * omega^(k1*n2) remains as one
  elementwise modular multiply per level boundary.

Layouts (B = batch):
  coeff domain   u64 [B, N],  N = N1*N2, n = n1*N2 + n2
  internal       u64 [256, B, 256]  (contraction axis leading)
  NTT domain     u64 [k2, B, k1]  — a fixed frequency order; pointwise
  multiplication and `inverse` share it, so ring multiplication is exact
  (generalizes the reference butterfly dataflow,
  /root/reference/crates/ring/src/cyclotomic_ring/models/goldilocks/ntt.rs:135-319).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import GOLDILOCKS
from .ntt import find_primitive_root

__all__ = ["Mxu2NTT", "PrescaledMat"]

_f = GOLDILOCKS
_Q = _f.q
_MASK32 = np.uint64(0xFFFFFFFF)

#: Default digit scheme of every digit-plane engine (this module,
#: ops/mxu_bb.py, ops/mxu_limb.py, ops/mxu_dense.py, mle/mxu_eval.py).
#: Both schemes are exact.  XLA:GPU hands an s8 x s8 -> s32 dot to an
#: int8 tensor-core GEMM (cuBLAS or a Triton GEMM fusion) but lowers a
#: u8 x u8 -> s32 dot to a plain loop emitter that runs two orders of
#: magnitude slower, so the signed scheme is the default.
UNSIGNED_DIGITS = False

P_PLANES = 10   # 7-bit unsigned data digits covering 64 bits
D_BITS = 7
K_BUCKETS = 9   # signed 8-bit weight digits covering [0, q)
B_BITS = 8

# unsigned scheme: 8 unsigned 8-bit data planes x 8 unsigned 8-bit
# weight digits = 64 MACs per 64-bit modular MAC instead of 90, and
# every bucket is NONNEGATIVE so the fold needs no bias handling.
P_PLANES_U8 = 8
D_BITS_U8 = 8
K_BUCKETS_U8 = 8


def _digitize_signed_host(v: int, k: int = K_BUCKETS) -> list:
    """v in [0, 2^64) -> k signed digits d_j in [-128, 127], top in {0,1},
    with v = sum d_j 2^(8j) exactly."""
    out = []
    carry = 0
    for _ in range(k - 1):
        m = (v & 0xFF) + carry
        v >>= 8
        if m >= 128:
            m -= 256
            carry = 1
        else:
            carry = 0
        out.append(m)
    top = v + carry
    assert 0 <= top <= 1, f"digitize overflow: top={top}"
    out.append(top)
    return out


class PrescaledMat:
    """Constant [R, C] Goldilocks matrix with pre-scaled int8 digit planes.

    apply(x): x u64 [C, cols] -> M @ x mod q, u64 [R, cols], exact.

    unsigned=True selects the u8 x u8 scheme: 8 unsigned 8-bit data
    planes, 8 unsigned 8-bit weight digits per plane — 64 MACs per
    modular MAC (vs 90 signed) and bias-free folds.
    """

    def __init__(self, m_ints, unsigned: bool = UNSIGNED_DIGITS):
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.K = K_BUCKETS_U8 if unsigned else K_BUCKETS
        self.P = P_PLANES_U8 if unsigned else P_PLANES
        self.d_bits = D_BITS_U8 if unsigned else D_BITS
        if unsigned:
            # int32 accumulation bound: P*C products of <= 255*255
            assert P_PLANES_U8 * C * 255 * 255 < 2**31
            big = np.zeros((K_BUCKETS_U8 * R, P_PLANES_U8 * C),
                           dtype=np.uint8)
            for l in range(P_PLANES_U8):
                scale = pow(2, D_BITS_U8 * l, _Q)
                v = ((m * scale) % _Q).astype(np.uint64)
                for k in range(K_BUCKETS_U8):
                    big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                        (v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.uint8)
            self.big = big
            return
        # int32 accumulation bound: P*C products of |.| <= 128*127
        assert P_PLANES * C * 128 * 127 < 2**31
        big = np.zeros((K_BUCKETS * R, P_PLANES * C), dtype=np.int8)
        for l in range(P_PLANES):
            scale = pow(2, D_BITS * l, _Q)
            # vectorized _digitize_signed_host over the whole matrix
            # (the scalar loop takes minutes at deg-2^18+ sizes)
            v = ((m * scale) % _Q).astype(np.uint64)
            carry = np.zeros((R, C), dtype=np.int16)
            for k in range(K_BUCKETS - 1):
                byte = ((v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.int16) + carry
                carry = (byte >= 128).astype(np.int16)
                big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                    byte - 256 * carry).astype(np.int8)
            # v < 2^64 so the top digit is exactly the final carry
            big[(K_BUCKETS - 1) * R:, l * C:(l + 1) * C] = \
                carry.astype(np.int8)
        # numpy on purpose: these objects are cached (PowerRing,
        # RingModel) and may be built inside a jit trace; jnp
        # constants created in-trace would leak tracers.
        self.big = big

    # -- device helpers ---------------------------------------------------
    def planes(self, x):
        """u64 [C, cols] -> int8/uint8 [P*C, cols] of 7/8-bit digits."""
        if self.unsigned:
            outs = [((x >> np.uint64(D_BITS_U8 * l))
                     & np.uint64(0xFF)).astype(jnp.uint8)
                    for l in range(P_PLANES_U8)]
            return jnp.concatenate(outs, axis=0)
        outs = []
        for l in range(P_PLANES):
            outs.append(((x >> np.uint64(D_BITS * l))
                         & np.uint64(0x7F)).astype(jnp.int8))
        return jnp.concatenate(outs, axis=0)

    def fold(self, V):
        """int32 [K*R, cols] bucket planes -> canonical u64 [R, cols].

        value = sum_k V_k 2^(8k).  Signed scheme: bias each bucket by
        2^26 (making the packing unsigned) and subtract the constant
        bias afterwards mod q.  Unsigned scheme: buckets are already
        nonnegative — no bias.
        """
        R, K = self.R, self.K
        if self.unsigned:
            bias_mod = None
        else:
            bias_val = sum((1 << 26) << (B_BITS * k) for k in range(K))
            bias_mod = jnp.asarray(np.uint64(bias_val % _Q))
        # base-2^32 words (held in u64; each accumulated word < 2^32*small)
        n_words = (B_BITS * (K - 1) + 31) // 32 + 1
        words = [None] * (n_words + 1)
        for k in range(K):
            if self.unsigned:
                v = V[k * R:(k + 1) * R].astype(jnp.uint64)
            else:
                v = (V[k * R:(k + 1) * R].astype(jnp.int64)
                     + jnp.int64(1 << 26)).astype(jnp.uint64)
            r = B_BITS * k
            j, sh = r >> 5, r & 31
            contrib = v << np.uint64(sh)         # < 2^(31+24) fits u64
            lo = contrib & _MASK32
            hi = contrib >> np.uint64(32)
            words[j] = lo if words[j] is None else words[j] + lo
            words[j + 1] = hi if words[j + 1] is None else words[j + 1] + hi
        zero = jnp.zeros_like(words[0])
        words = [w if w is not None else zero for w in words]
        # carry-normalize to digits < 2^32
        digits = []
        carry = zero
        for w in words:
            t = w + carry
            digits.append(t & _MASK32)
            carry = t >> np.uint64(32)
        digits.append(carry)
        while len(digits) < 4:
            digits.append(zero)
        # value = A + B*2^64 with A = d0|d1<<32 (u64), B = d2|d3<<32
        A = digits[0] | (digits[1] << np.uint64(32))
        Bw = digits[2] | (digits[3] << np.uint64(32))
        acc = _f._reduce128(Bw, A)
        if bias_mod is None:
            return acc
        return _f.sub(acc, bias_mod)

    def dot(self, x, big=None):
        """u64 [C, cols] -> int32 bucket planes [K*R, cols].

        ``big`` lets callers pass the weight matrix as a traced argument
        instead of a closed-over constant (MB-scale literals embedded in
        the HLO slow compilation down)."""
        w = self.big if big is None else big
        return jax.lax.dot(w, self.planes(x),
                           preferred_element_type=jnp.int32)

    def apply(self, x):
        return self.fold(self.dot(x))


class Mxu2NTT:
    """Negacyclic ring multiply for N = N1*N2 (default 256*256 = 2^16)."""

    F = _f  # the field whose modulus the twiddle/pointwise muls use

    def __init__(self, N: int = 1 << 16, n1: int | None = None,
                 unsigned: bool = UNSIGNED_DIGITS):
        self.N = N
        self.unsigned = unsigned
        if n1 is None:
            logn = N.bit_length() - 1
            n1 = 1 << (logn // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
        q = _Q
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        om = pow(psi, 2, q)
        om1 = pow(om, N2, q)          # order N1
        om2 = pow(om, N1, q)          # order N2
        psi_i = pow(psi, q - 2, q)
        om_i = pow(om, q - 2, q)
        om1_i = pow(om1, q - 2, q)
        om2_i = pow(om2, q - 2, q)
        n_inv = pow(N, q - 2, q)

        # W1'[k1, n1] = om1^(k1 n1) * psi^(n1 N2)   (twist absorbed)
        W1 = [[pow(om1, k1 * j, q) * pow(psi, j * N2, q) % q
               for j in range(N1)] for k1 in range(N1)]
        # W2[k2, n2] = om2^(k2 n2)
        W2 = [[pow(om2, k2 * j, q) for j in range(N2)]
              for k2 in range(N2)]
        # inverse: W2i[n2, k2] = om2^(-k2 n2)
        W2i = [[pow(om2_i, j * k2, q) for k2 in range(N2)]
               for j in range(N2)]
        # W1i[n1, k1] = om1^(-k1 n1) * psi^(-n1 N2) / N
        W1i = [[pow(om1_i, j * k1, q) * pow(psi_i, j * N2, q)
                * n_inv % q for k1 in range(N1)] for j in range(N1)]
        self.mat1 = PrescaledMat(W1, unsigned)
        self.mat2 = PrescaledMat(W2, unsigned)
        self.mat2i = PrescaledMat(W2i, unsigned)
        self.mat1i = PrescaledMat(W1i, unsigned)

        # mid twiddle T[k1, n2] = psi^(n2) * om^(k1 n2)
        tw = np.empty((N1, N2), dtype=np.uint64)
        twi = np.empty((N2, N1), dtype=np.uint64)   # [n2, k1] layout
        for k1 in range(N1):
            for j in range(N2):
                tw[k1, j] = pow(psi, j, q) * pow(om, k1 * j, q) % q
                twi[j, k1] = pow(psi_i, j, q) * pow(om_i, k1 * j, q) % q
        self.tw = tw
        self.twi = twi

    # -- layout helpers ---------------------------------------------------
    def _to_internal(self, x):
        """[B, N] -> [n1, B, n2]."""
        B = x.shape[0]
        return jnp.transpose(x.reshape(B, self.N1, self.N2), (1, 0, 2))

    def _from_internal(self, x):
        """[n1, B, n2] -> [B, N]."""
        return jnp.transpose(x, (1, 0, 2)).reshape(-1, self.N)

    # -- levels: one digit dot + fold each ---------------------------------
    def _lvl_end(self, mat, x, big=None):
        """[C, B, t] -> M @ x mod q as u64 [R, B, t]."""
        C, B, t = x.shape
        V = mat.dot(x.reshape(C, B * t), big)
        return mat.fold(V).reshape(mat.R, B, t)

    def _lvl_tw(self, mat, x, tw, big=None):
        """_lvl_end followed by the mid twiddle (tw: storage [R, t],
        broadcast over B)."""
        return self.F.mul(self._lvl_end(mat, x, big), tw[:, None, :])

    def _lvl_tw_t(self, mat, x, tw, big=None):
        """_lvl_tw followed by the mid transpose [R, B, t] -> [t, B, R]."""
        return jnp.transpose(self._lvl_tw(mat, x, tw, big), (2, 1, 0))

    # -- traced-constants plumbing ----------------------------------------
    def consts(self):
        """All MB-scale tables as a pytree, to pass as jit ARGUMENTS."""
        return {"w1": self.mat1.big, "w2": self.mat2.big,
                "w2i": self.mat2i.big, "w1i": self.mat1i.big,
                "tw": self.tw, "twi": self.twi}

    def _c(self, c, key, default):
        return default if c is None else c[key]

    # -- transforms --------------------------------------------------------
    def forward_internal(self, x, c=None):
        """[n1, B, n2] coeffs -> [k2, B, k1] evaluations."""
        a = self._lvl_tw_t(self.mat1, x, self._c(c, "tw", self.tw),
                           self._c(c, "w1", None))    # [n2, B, k1]
        return self._lvl_end(self.mat2, a, self._c(c, "w2", None))

    def inverse_internal(self, y, c=None):
        """[k2, B, k1] -> [n1, B, n2] coefficients."""
        a = self._lvl_tw_t(self.mat2i, y, self._c(c, "twi", self.twi),
                           self._c(c, "w2i", None))   # [k1, B, n2]
        return self._lvl_end(self.mat1i, a, self._c(c, "w1i", None))

    def forward(self, x, c=None):
        return self._from_internal(
            jnp.transpose(self.forward_internal(self._to_internal(x), c),
                          (2, 1, 0)))

    def mul(self, a, b, c=None):
        """Full negacyclic ring multiply [B, N] x [B, N] -> [B, N]."""
        ai = self._to_internal(a)
        bi = self._to_internal(b)
        fa = self.forward_internal(ai, c)
        fb = self.forward_internal(bi, c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fb), c))

    def pointwise(self, fa, fb):
        return self.F.mul(fa, fb)

    def jit_mul(self):
        """Jitted full multiply with every table passed as an argument.

        The tables are device_put ONCE here: consts() is numpy (trace-
        safe), but passing numpy per call would re-upload MBs from the
        host on every dispatch."""
        c = jax.device_put(self.consts())
        fn = jax.jit(lambda cc, a, b: self.mul(a, b, cc))
        return lambda a, b: fn(c, a, b)

    # -- fixed-operand (cached-transform) multiply --------------------------
    def precompute(self, b, c=None):
        """Opaque cached-operand state for :meth:`mul_cached`.

        Protocols multiply many elements by the SAME fixed ring element
        (gadget columns, challenge powers, fixed rotations — the pattern
        behind the reference's `mul_unchecked` loops, ntt_form.rs:159-189).
        Caching the fixed operand's forward transform once turns every
        subsequent multiply into 1 forward + slot product + 1 inverse —
        a third of the transform work removed.  The returned state is
        the internal-layout evaluations; treat it as opaque.  Its batch
        dim must match the live operand's, or be 1 (broadcast)."""
        return self.forward_internal(self._to_internal(b), c)

    def mul_cached(self, a, fb, c=None):
        """[B, N] x precompute(b) -> a*b mod (q, X^N+1).

        fb may come from a batch-1 b (ONE fixed element times a whole
        batch — the challenge-multiply pattern): the internal layout
        [k2, Bb, k1] broadcasts over the batch axis."""
        fa = self.forward_internal(self._to_internal(a), c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fb), c))

    def square(self, a, c=None):
        """a*a with ONE forward transform (fa reused as both operands)."""
        fa = self.forward_internal(self._to_internal(a), c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fa), c))

    def jit_mul_cached(self):
        """Jitted (mul_cached, precompute) pair; tables uploaded once."""
        c = jax.device_put(self.consts())
        pre = jax.jit(lambda cc, b: self.precompute(b, cc))
        fn = jax.jit(lambda cc, a, fb: self.mul_cached(a, fb, cc))

        def mul(a, fb):
            return fn(c, a, fb)

        mul.precompute = lambda b: pre(c, b)  # type: ignore[attr-defined]
        return mul

    def jit_square(self):
        c = jax.device_put(self.consts())
        fn = jax.jit(lambda cc, a: self.square(a, cc))
        return lambda a: fn(c, a)

    def staged_mul(self, granularity: str = "stage"):
        """Python-composed multiply from separately-jitted modules: the
        same function as :meth:`jit_mul`, cut into stages that can be
        timed one by one (the dot / fold split of the transform).

        granularity:
          "stage"     — ~13 small modules per mul (each level's dot+fold,
                        the transposes and the slot product apart)
          "mixed"     — 5 modules per mul: the forward transform as one
                        module (used twice), pointwise, and the inverse
                        split in two
          "mixed4"    — 4 modules per mul: like "mixed" with pointwise
                        fused into the first inverse module
          "transform" — 3 modules per mul: forward (used twice) and the
                        pointwise+inverse tail
        """
        c = jax.device_put(self.consts())  # upload tables once, not per call
        if granularity == "mixed4":
            fwd_m = jax.jit(lambda cc, x: self._fwd_graph(cc, x))
            inv1 = jax.jit(lambda cc, fa, fb: self._lvl_tw_t(
                self.mat2i, self.pointwise(fa, fb), cc["twi"], cc["w2i"]))
            inv2 = jax.jit(lambda cc, a: self._from_internal(
                self._lvl_end(self.mat1i, a, cc["w1i"])))

            def fwd(x):
                return fwd_m(c, x)

            def mul(a, b):
                return inv2(c, inv1(c, fwd(a), fwd(b)))

            mul.forward = fwd  # type: ignore[attr-defined]
            return mul
        if granularity == "mixed":
            fwd_m = jax.jit(lambda cc, x: self._fwd_graph(cc, x))
            pw = jax.jit(self.pointwise)
            inv1 = jax.jit(lambda cc, y: self._lvl_tw_t(
                self.mat2i, y, cc["twi"], cc["w2i"]))
            inv2 = jax.jit(lambda cc, a: self._from_internal(
                self._lvl_end(self.mat1i, a, cc["w1i"])))

            def fwd(x):
                return fwd_m(c, x)

            def mul(a, b):
                return inv2(c, inv1(c, pw(fwd(a), fwd(b))))

            mul.forward = fwd  # type: ignore[attr-defined]
            return mul
        if granularity == "transform":
            fwd_m = jax.jit(lambda cc, x: self._fwd_graph(cc, x))
            tail_m = jax.jit(lambda cc, fa, fb: self._tail_graph(cc, fa, fb))

            def fwd(x):
                return fwd_m(c, x)

            def mul(a, b):
                return tail_m(c, fwd(a), fwd(b))

            mul.forward = fwd  # type: ignore[attr-defined]
            return mul
        ti = jax.jit(self._to_internal)
        fi = jax.jit(self._from_internal)
        l1 = jax.jit(lambda cc, x: self._lvl_tw(
            self.mat1, x, cc["tw"], cc["w1"]))
        tr = jax.jit(lambda a: jnp.transpose(a, (2, 1, 0)))
        l2 = jax.jit(lambda cc, a: self._lvl_end(self.mat2, a, cc["w2"]))
        pw = jax.jit(self.pointwise)
        l2i = jax.jit(lambda cc, y: self._lvl_tw(
            self.mat2i, y, cc["twi"], cc["w2i"]))
        l1i = jax.jit(lambda cc, a: self._lvl_end(self.mat1i, a, cc["w1i"]))

        def fwd(x):
            return l2(c, tr(l1(c, ti(x))))

        def mul(a, b):
            prod = pw(fwd(a), fwd(b))
            return fi(l1i(c, tr(l2i(c, prod))))

        mul.forward = fwd  # type: ignore[attr-defined]
        return mul

    def _fwd_graph(self, c, x):
        return self.forward_internal(self._to_internal(x), c)

    def _tail_graph(self, c, fa, fb):
        prod = self.pointwise(fa, fb)
        return self._from_internal(self.inverse_internal(prod, c))
