"""Vectorized prime-field arithmetic for the four STARK-friendly primes.

This module replaces arkworks' ``MontBackend`` (the L0 layer of the
reference, e.g. crates/ring/src/cyclotomic_ring/models/goldilocks/mod.rs:18-25)
with JAX/XLA-native kernels:

* **goldilocks** ``q = 2^64 - 2^32 + 1`` — canonical ``uint64`` storage with
  the classic Goldilocks 128-bit fast reduction (``2^64 = 2^32 - 1``,
  ``2^96 = -1`` mod q).
* **babybear**  ``q = 15*2^27 + 1``      — Montgomery form, ``R = 2^32``,
  ``uint32`` storage, single-word REDC.
* **frog**      ``q = 15912092521325583641`` (generic 64-bit prime) —
  Montgomery form, ``R = 2^64``, ``uint64`` storage, 2x32-limb REDC.
* **stark_prime** ``q = 2^251 + 17*2^192 + 1`` — Montgomery form,
  ``R = 2^256``, eight 32-bit limbs (trailing axis of size 8), CIOS REDC.

All ops are elementwise over arbitrary leading batch axes and contain no
data-dependent control flow, so they trace/jit/vmap/shard cleanly.  Storage
values are plain unsigned integers in ``[0, q)``; whether they carry a
Montgomery factor is a private detail behind ``encode``/``decode``.

The multi-word helper :func:`_mul64_128` splits 64-bit operands into 32-bit
halves so every hardware multiply is a 32x32->64, which XLA lowers natively
on every backend (no 64x64->128 instruction is assumed).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

__all__ = [
    "Field",
    "GOLDILOCKS",
    "BABYBEAR",
    "FROG",
    "STARK",
    "FIELDS",
    "get_field",
]

_MASK32 = np.uint64(0xFFFFFFFF)


def _u64(x: int) -> np.uint64:
    return np.uint64(x & 0xFFFFFFFFFFFFFFFF)


def _mul64_128(a, b):
    """Full 64x64 -> 128-bit product as a ``(hi, lo)`` pair of uint64."""
    a0 = a & _MASK32
    a1 = a >> np.uint64(32)
    b0 = b & _MASK32
    b1 = b >> np.uint64(32)
    ll = a0 * b0
    mid = a0 * b1 + (ll >> np.uint64(32)) + (a1 * b0 & _MASK32)
    hi = a1 * b1 + (a1 * b0 >> np.uint64(32)) + (mid >> np.uint64(32))
    lo = (mid << np.uint64(32)) | (ll & _MASK32)
    return hi, lo


class Field:
    """One prime field; see module docstring for the per-prime strategies.

    The public contract used by the ring/linalg/MLE layers:

    * ``shape``: storage appends ``limb_shape`` (``()`` or ``(8,)``) to the
      logical element shape; ``coeff_axis`` is the axis of a trailing
      coefficient dimension (-1 scalar fields, -2 limbed).
    * ``add/sub/neg/mul`` are elementwise on storage.
    * ``encode/decode`` convert python-int arrays <-> storage (host side).
    * ``from_uint`` lifts a traced array of small (< 2^32) unsigned ints.
    * ``sum``: modular reduction over an axis (tree of adds).
    """

    def __init__(self, name: str, q: int):
        self.name = name
        self.q = q
        self.bits = q.bit_length()

    # -- shape helpers ----------------------------------------------------
    limb_shape: tuple = ()

    @property
    def limbed(self) -> bool:
        return bool(self.limb_shape)

    @property
    def coeff_axis(self) -> int:
        return -2 if self.limbed else -1

    def take_coeff(self, x, idx):
        """Gather along the coefficient axis (one in from limbs if limbed)."""
        return jnp.take(x, idx, axis=self.coeff_axis)

    # -- host conversions --------------------------------------------------
    def encode(self, ints):
        """python ints / object array -> storage jnp array."""
        raise NotImplementedError

    def decode(self, x):
        """storage -> numpy object array of canonical python ints."""
        raise NotImplementedError

    def const(self, v: int):
        """Encode a single scalar constant."""
        return self.encode(np.array(v % self.q, dtype=object))

    def zeros(self, shape=()):
        return jnp.zeros(tuple(shape) + self.limb_shape, dtype=self.dtype)

    def ones(self, shape=()):
        one = self.const(1)
        return jnp.broadcast_to(one, tuple(shape) + self.limb_shape)

    def rand_ints(self, shape, rng) -> np.ndarray:
        """Host-side exact-uniform canonical ints (tests / sampling)."""
        flat = np.empty(int(np.prod(shape, dtype=np.int64)) if shape else 1,
                        dtype=object)
        for i in range(flat.size):
            flat[i] = rng.randrange(self.q)
        return flat.reshape(shape) if shape else flat[0]

    def rand(self, shape, rng):
        return self.encode(self.rand_ints(shape, rng))

    # -- traced ops --------------------------------------------------------
    def sum(self, x, axis: int):
        """Modular sum over ``axis`` via a halving tree of ``add``s."""
        axis = axis % x.ndim
        if x.shape[axis] == 0:
            return self.zeros(x.shape[:axis] + x.shape[axis + 1:]
                              if not self.limbed else
                              x.shape[:axis] + x.shape[axis + 1:-1])
        rem = None
        while x.shape[axis] > 1:
            n = x.shape[axis]
            if n % 2:
                tail = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
                rem = tail if rem is None else self.add(rem, tail)
                x = jax.lax.slice_in_dim(x, 0, n - 1, axis=axis)
                n -= 1
            x = self.add(jax.lax.slice_in_dim(x, 0, n // 2, axis=axis),
                         jax.lax.slice_in_dim(x, n // 2, n, axis=axis))
        if rem is not None:
            x = self.add(x, rem)
        return jnp.squeeze(x, axis=axis)

    def dot(self, a, b, axis: int):
        """Modular inner product over ``axis``: sum(mul(a, b))."""
        return self.sum(self.mul(a, b), axis)

    def pow_const(self, x, e: int):
        """x**e with a static exponent (square-and-multiply, traced)."""
        if e == 0:
            return jnp.broadcast_to(self.const(1), x.shape)
        acc = None
        base = x
        while e:
            if e & 1:
                acc = base if acc is None else self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc

    def inv(self, x):
        """Elementwise inverse via Fermat (x != 0)."""
        return self.pow_const(x, self.q - 2)

    def square_table(self, g):
        """[bits] table of g^(2^i) (Ring::pow_with_table precompute,
        ring.rs:13-117)."""
        out = [g]
        for _ in range(self.bits - 1):
            out.append(self.mul(out[-1], out[-1]))
        return out

    def pow_with_table(self, table, e: int):
        """g^e from a square table (static exponent)."""
        acc = None
        i = 0
        while e:
            if e & 1:
                acc = table[i] if acc is None else self.mul(acc, table[i])
            e >>= 1
            i += 1
        return acc if acc is not None else self.const(1)

    def from_random_bytes(self, data: bytes):
        """FromRandomBytes semantics (ring.rs:119-135): interpret the
        first serialized-size bytes little-endian; None if >= q."""
        nb = (self.bits + 7) // 8
        if len(data) < nb:
            return None
        v = int.from_bytes(data[:nb], "little")
        return v if v < self.q else None

    def select(self, cond, a, b):
        """where(cond, a, b) with cond broadcast over limbs if needed."""
        if self.limbed:
            cond = jnp.asarray(cond)[..., None]
        return jnp.where(cond, a, b)

    def is_zero(self, x):
        z = x == 0
        return jnp.all(z, axis=-1) if self.limbed else z

    # -- canonical view (traced) ------------------------------------------
    # storage -> canonical unsigned value(s) and back; identity for
    # non-Montgomery fields.  Used by the Zq layer (center/sign) and by
    # balanced decomposition (reference ring.rs:138-190,
    # balanced_decomposition/fq_convertible.rs).
    def canon(self, x):
        return x

    def from_canon(self, u):
        return u

    def canon_const(self, v: int):
        """Raw canonical constant (np scalar/limbs) for comparisons with
        ``canon`` output — NOT in Montgomery form."""
        v %= self.q
        if self.limbed:
            return self._to_limbs_host(v)
        return np.uint64(v) if self.dtype == jnp.uint64 else np.uint32(v)

    # -- lazy / widened accumulation --------------------------------------
    # Modular segment-sums and big reductions widen storage to base-2^32
    # words (uint64), accumulate with plain integer adds (safe for up to
    # 2^32 addends), then fold back mod q:  sum_j d_j 2^(32 j) mod q via a
    # per-field power table.  This is how rayon-reduction loops of the
    # reference (e.g. sparse_matrix.rs:202-217) become device scatter-adds.
    @property
    def n_words(self) -> int:
        if self.limbed:
            return len(self.limb_shape) and self.limb_shape[0]
        return 1 if self.bits <= 32 else 2

    def widen(self, x):
        """storage -> uint64[..., n_words] base-2^32 words."""
        if self.limbed:
            return x.astype(jnp.uint64)
        x64 = x.astype(jnp.uint64)
        if self.n_words == 1:
            return x64[..., None]
        return jnp.stack([x64 & _MASK32, x64 >> np.uint64(32)], axis=-1)

    def _lift32(self, d):
        """uint64 word (< 2^32) -> storage holding that raw integer."""
        if self.limbed:
            out = jnp.zeros(d.shape + self.limb_shape, dtype=self.dtype)
            return out.at[..., 0].set(d.astype(self.dtype))
        return d.astype(self.dtype)

    @property
    def _pow32_table(self):
        """POW32S[j] = 2^(32 j) * S mod q (S = Montgomery factor if any),
        so that mul(lift32(d), POW32S[j]) == raw d*2^(32 j) mod q."""
        tab = getattr(self, "_pow32_cache", None)
        if tab is None:
            S = getattr(self, "R", 1) % self.q
            tab = []
            for j in range(self.n_words + 2):
                v = (1 << (32 * j)) * S % self.q
                if self.limbed:
                    tab.append(self._to_limbs_host(v))
                else:
                    tab.append(np.uint64(v) if self.dtype == jnp.uint64
                               else np.uint32(v))
            self._pow32_cache = tab
        return tab

    def reduce_words(self, words):
        """uint64[..., W] base-2^32 unnormalized words -> storage mod q."""
        W = words.shape[-1]
        digits = []
        carry = jnp.zeros(words.shape[:-1], dtype=jnp.uint64)
        for j in range(W):
            s = words[..., j] + carry
            digits.append(s & _MASK32)
            carry = s >> np.uint64(32)
        for _ in range(2):
            digits.append(carry & _MASK32)
            carry = carry >> np.uint64(32)
        tab = self._pow32_table
        acc = None
        for j, d in enumerate(digits):
            if j < len(tab):
                c = tab[j]
            else:
                S = getattr(self, "R", 1) % self.q
                v = (1 << (32 * j)) * S % self.q
                c = (self._to_limbs_host(v) if self.limbed else
                     (np.uint64(v) if self.dtype == jnp.uint64
                      else np.uint32(v)))
            term = self.mul(self._lift32(d), c)
            acc = term if acc is None else self.add(acc, term)
        return acc

    def segment_sum(self, values, seg_ids, num_segments: int):
        """Modular segment sum over the leading axis.

        values: storage [n, ...]; seg_ids: int[n]; returns [num_segments, ...].
        """
        w = self.widen(values)          # [n, ..., W]
        zero = jnp.zeros((num_segments,) + w.shape[1:], dtype=jnp.uint64)
        acc = zero.at[seg_ids].add(w)
        return self.reduce_words(acc)

    def geq(self, a, b):
        """a >= b on canonical storage (lexicographic for limbed)."""
        if not self.limbed:
            return a >= b
        ge = jnp.ones(jnp.broadcast_shapes(a.shape, b.shape)[:-1], dtype=bool)
        decided = jnp.zeros_like(ge)
        for j in reversed(range(a.shape[-1])):
            gt = a[..., j] > b[..., j]
            lt = a[..., j] < b[..., j]
            ge = jnp.where(~decided & gt, True, jnp.where(~decided & lt, False, ge))
            decided = decided | gt | lt
        return ge


# ---------------------------------------------------------------------------
# Goldilocks: canonical uint64 + fast reduction
# ---------------------------------------------------------------------------


class _Goldilocks(Field):
    dtype = jnp.uint64

    def __init__(self):
        super().__init__("goldilocks", 2**64 - 2**32 + 1)
        self._q = _u64(self.q)

    def encode(self, ints):
        arr = np.asarray(ints, dtype=object)
        flat = arr.reshape(-1) if arr.shape else arr.reshape(1)
        out = np.empty(flat.size, dtype=np.uint64)
        for i, v in enumerate(flat):
            out[i] = _u64(int(v) % self.q)
        return out.reshape(arr.shape) if arr.shape else out[0]

    def decode(self, x):
        host = np.asarray(jax.device_get(x))
        out = np.empty(host.size, dtype=object)
        for i, v in enumerate(host.reshape(-1)):
            out[i] = int(v)
        return out.reshape(host.shape)

    def from_uint(self, x):
        return jnp.asarray(x).astype(jnp.uint64)

    def add(self, a, b):
        q = self._q
        s = a + b
        return jnp.where((s < a) | (s >= q), s - q, s)

    def sub(self, a, b):
        d = a - b
        return jnp.where(a < b, d + self._q, d)

    def neg(self, a):
        return jnp.where(a == 0, a, self._q - a)

    def _reduce128(self, hi, lo):
        """(hi*2^64 + lo) mod q via 2^64 = 2^32 - 1, 2^96 = -1."""
        q = self._q
        hi_hi = hi >> np.uint64(32)
        hi_lo = hi & _MASK32
        t0 = lo - hi_hi
        t0 = jnp.where(lo < hi_hi, t0 - _MASK32, t0)
        t1 = hi_lo * _MASK32
        t2 = t0 + t1
        t2 = jnp.where(t2 < t1, t2 + _MASK32, t2)
        return jnp.where(t2 >= q, t2 - q, t2)

    def mul(self, a, b):
        hi, lo = _mul64_128(a, b)
        return self._reduce128(hi, lo)

    def reduce_u64(self, x):
        """Arbitrary uint64 -> canonical (for lazy accumulations)."""
        q = self._q
        return jnp.where(x >= q, x - q, x)


# ---------------------------------------------------------------------------
# BabyBear: Montgomery R = 2^32, uint32 storage
# ---------------------------------------------------------------------------


class _BabyBear(Field):
    dtype = jnp.uint32

    def __init__(self):
        super().__init__("babybear", 15 * 2**27 + 1)
        q = self.q
        self.R = 1 << 32
        self._qprime = np.uint64((-pow(q, -1, self.R)) % self.R)
        self._q64 = np.uint64(q)
        self._R2 = np.uint32((self.R * self.R) % q)

    def _redc(self, u):
        """REDC of u < 2^32 * q (u is uint64) -> uint32 canonical*R^-1."""
        m = (u & _MASK32) * self._qprime & _MASK32
        t = (u + m * self._q64) >> np.uint64(32)
        t = jnp.where(t >= self._q64, t - self._q64, t)
        return t.astype(jnp.uint32)

    def encode(self, ints):
        arr = np.asarray(ints, dtype=object)
        R, q = self.R, self.q
        flat = arr.reshape(-1) if arr.shape else arr.reshape(1)
        out = np.empty(flat.size, dtype=np.uint32)
        for i, v in enumerate(flat):
            out[i] = np.uint32(int(v) % q * R % q)
        return out.reshape(arr.shape) if arr.shape else out[0]

    def decode(self, x):
        canon = self._redc(jnp.asarray(x).astype(jnp.uint64))
        host = np.asarray(jax.device_get(canon))
        out = np.empty(host.size, dtype=object)
        for i, v in enumerate(host.reshape(-1)):
            out[i] = int(v)
        return out.reshape(host.shape)

    def from_uint(self, x):
        v = jnp.asarray(x).astype(jnp.uint64)
        v = v % self._q64  # small ints: cheap, traced once
        return self._redc(v * np.uint64(int(self._R2)))

    def add(self, a, b):
        q = np.uint32(self.q)
        s = a + b  # q < 2^31: no wrap in uint32
        return jnp.where(s >= q, s - q, s)

    def sub(self, a, b):
        q = np.uint32(self.q)
        d = a - b
        return jnp.where(a < b, d + q, d)

    def neg(self, a):
        return jnp.where(a == 0, a, np.uint32(self.q) - a)

    def mul(self, a, b):
        u = a.astype(jnp.uint64) * b.astype(jnp.uint64)
        return self._redc(u)

    def canon(self, x):
        return self._redc(jnp.asarray(x).astype(jnp.uint64))

    def from_canon(self, u):
        return self._redc(jnp.asarray(u).astype(jnp.uint64)
                          * np.uint64(int(self._R2)))


# ---------------------------------------------------------------------------
# Frog: Montgomery R = 2^64, uint64 storage
# ---------------------------------------------------------------------------


class _Frog(Field):
    dtype = jnp.uint64

    def __init__(self):
        super().__init__("frog", 15912092521325583641)
        q = self.q
        self.R = 1 << 64
        self._qprime = _u64((-pow(q, -1, self.R)) % self.R)
        self._q64 = _u64(q)
        self._R2 = _u64((self.R * self.R) % q)

    def _mont_mul_raw(self, a, b):
        """a*b*R^-1 mod q for a,b uint64 (a*b < R*q always holds: a,b < q)."""
        q = self._q64
        hi, lo = _mul64_128(a, b)
        m = lo * self._qprime  # wrapping low 64
        mq_hi, mq_lo = _mul64_128(m, q)
        carry = (lo != np.uint64(0)).astype(jnp.uint64)
        t = hi + mq_hi
        wrapped = t < hi
        t2 = t + carry
        wrapped = wrapped | (t2 < t)
        del mq_lo  # lo + mq_lo == 0 mod 2^64 by construction
        return jnp.where(wrapped | (t2 >= q), t2 - q, t2)

    def encode(self, ints):
        arr = np.asarray(ints, dtype=object)
        R, q = self.R, self.q
        flat = arr.reshape(-1) if arr.shape else arr.reshape(1)
        out = np.empty(flat.size, dtype=np.uint64)
        for i, v in enumerate(flat):
            out[i] = _u64(int(v) % q * R % q)
        return out.reshape(arr.shape) if arr.shape else out[0]

    def decode(self, x):
        canon = self._mont_mul_raw(jnp.asarray(x), jnp.uint64(1))
        host = np.asarray(jax.device_get(canon))
        out = np.empty(host.size, dtype=object)
        for i, v in enumerate(host.reshape(-1)):
            out[i] = int(v)
        return out.reshape(host.shape)

    def from_uint(self, x):
        v = jnp.asarray(x).astype(jnp.uint64)
        return self._mont_mul_raw(v, self._R2)

    def add(self, a, b):
        q = self._q64
        s = a + b
        return jnp.where((s < a) | (s >= q), s - q, s)

    def sub(self, a, b):
        d = a - b
        return jnp.where(a < b, d + self._q64, d)

    def neg(self, a):
        return jnp.where(a == 0, a, self._q64 - a)

    def mul(self, a, b):
        return self._mont_mul_raw(a, b)

    def canon(self, x):
        return self._mont_mul_raw(x, jnp.uint64(1))

    def from_canon(self, u):
        return self._mont_mul_raw(u, self._R2)


# ---------------------------------------------------------------------------
# Stark prime: Montgomery R = 2^256, 8x uint32 limbs (little-endian)
# ---------------------------------------------------------------------------


class _Stark(Field):
    dtype = jnp.uint32
    N_LIMBS = 8
    limb_shape = (8,)

    def __init__(self):
        super().__init__("stark_prime", 2**251 + 17 * 2**192 + 1)
        q = self.q
        self.R = 1 << 256
        self._qprime32 = np.uint64((-pow(q, -1, 1 << 32)) % (1 << 32))
        self._q_limbs = [np.uint64((q >> (32 * i)) & 0xFFFFFFFF)
                         for i in range(self.N_LIMBS)]
        self._R2_int = (self.R * self.R) % q

    # -- limb packing ------------------------------------------------------
    def _to_limbs_host(self, v: int) -> np.ndarray:
        return np.array([(v >> (32 * i)) & 0xFFFFFFFF
                         for i in range(self.N_LIMBS)], dtype=np.uint32)

    def encode(self, ints):
        arr = np.asarray(ints, dtype=object)
        q, R = self.q, self.R
        flat = arr.reshape(-1) if arr.shape else arr.reshape(1)
        out = np.empty((flat.size, self.N_LIMBS), dtype=np.uint32)
        for i, v in enumerate(flat):
            out[i] = self._to_limbs_host(int(v) % q * R % q)
        return out.reshape(arr.shape + (self.N_LIMBS,))

    def decode(self, x):
        one = jnp.broadcast_to(jnp.asarray(self._one_raw()),
                               jnp.asarray(x).shape)
        canon = self._mont_mul_limbs(jnp.asarray(x), one)
        host = np.asarray(jax.device_get(canon), dtype=np.uint64)
        flat = host.reshape(-1, self.N_LIMBS)
        out = np.empty(flat.shape[0], dtype=object)
        for i in range(flat.shape[0]):
            v = 0
            for j in reversed(range(self.N_LIMBS)):
                v = (v << 32) | int(flat[i, j])
            out[i] = v
        return out.reshape(host.shape[:-1])

    def _one_raw(self):
        one = np.zeros(self.N_LIMBS, dtype=np.uint32)
        one[0] = 1
        return one

    def from_uint(self, x):
        v = jnp.asarray(x).astype(jnp.uint32)
        limbs = jnp.zeros(v.shape + (self.N_LIMBS,), dtype=jnp.uint32)
        limbs = limbs.at[..., 0].set(v)
        r2 = self._to_limbs_host(self._R2_int)
        return self._mont_mul_limbs(limbs, jnp.broadcast_to(jnp.asarray(r2),
                                                            limbs.shape))

    # -- limb arithmetic ---------------------------------------------------
    def _geq_q(self, limbs64):
        """limbs64: list of uint64 (each < 2^32). True where value >= q."""
        ge = None
        decided = None
        for j in reversed(range(self.N_LIMBS)):
            qj = self._q_limbs[j]
            gt = limbs64[j] > qj
            lt = limbs64[j] < qj
            if ge is None:
                ge = gt
                decided = gt | lt
            else:
                ge = ge | (~decided & gt)
                decided = decided | gt | lt
        return ge | ~decided  # equal == q counts as >= q

    def _sub_q(self, limbs64, mask):
        """Conditionally (per-element mask) subtract q, in-place style."""
        out = []
        borrow = jnp.zeros_like(limbs64[0])
        for j in range(self.N_LIMBS):
            qj = jnp.where(mask, self._q_limbs[j], np.uint64(0))
            d = limbs64[j] - qj - borrow
            borrow = (d >> np.uint64(63)) & np.uint64(1)  # wrapped => top bit
            out.append(d & _MASK32)
        return out

    def add(self, a, b):
        a64 = a.astype(jnp.uint64)
        b64 = b.astype(jnp.uint64)
        limbs = []
        carry = jnp.zeros(a.shape[:-1], dtype=jnp.uint64)
        for j in range(self.N_LIMBS):
            s = a64[..., j] + b64[..., j] + carry
            limbs.append(s & _MASK32)
            carry = s >> np.uint64(32)
        # a+b < 2q < 2^253 so carry out of limb 7 is 0
        mask = self._geq_q(limbs)
        limbs = self._sub_q(limbs, mask)
        return jnp.stack(limbs, axis=-1).astype(jnp.uint32)

    def sub(self, a, b):
        a64 = a.astype(jnp.uint64)
        b64 = b.astype(jnp.uint64)
        limbs = []
        borrow = jnp.zeros(a.shape[:-1], dtype=jnp.uint64)
        for j in range(self.N_LIMBS):
            d = a64[..., j] - b64[..., j] - borrow
            borrow = (d >> np.uint64(63)) & np.uint64(1)
            limbs.append(d & _MASK32)
        neg = borrow.astype(bool)
        # if borrowed, add q back
        carry = jnp.zeros_like(borrow)
        out = []
        for j in range(self.N_LIMBS):
            qj = jnp.where(neg, self._q_limbs[j], np.uint64(0))
            s = limbs[j] + qj + carry
            out.append(s & _MASK32)
            carry = s >> np.uint64(32)
        return jnp.stack(out, axis=-1).astype(jnp.uint32)

    def neg(self, a):
        z = self.is_zero(a)
        qa = jnp.broadcast_to(jnp.asarray(self._to_limbs_host(self.q)),
                              a.shape)
        r = self.sub(qa, a)
        return self.select(~z, r, jnp.zeros_like(a))

    def _mont_mul_limbs(self, a, b):
        """CIOS Montgomery multiply on uint32[..., 8] operands."""
        N = self.N_LIMBS
        a64 = a.astype(jnp.uint64)
        b64 = b.astype(jnp.uint64)
        zero = jnp.zeros(jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                         dtype=jnp.uint64)
        t = [zero] * (N + 2)
        for i in range(N):
            ai = a64[..., i]
            carry = zero
            for j in range(N):
                s = t[j] + ai * b64[..., j] + carry
                t[j] = s & _MASK32
                carry = s >> np.uint64(32)
            s = t[N] + carry
            t[N] = s & _MASK32
            t[N + 1] = t[N + 1] + (s >> np.uint64(32))
            m = t[0] * self._qprime32 & _MASK32
            s = t[0] + m * self._q_limbs[0]
            carry = s >> np.uint64(32)
            for j in range(1, N):
                s = t[j] + m * self._q_limbs[j] + carry
                t[j - 1] = s & _MASK32
                carry = s >> np.uint64(32)
            s = t[N] + carry
            t[N - 1] = s & _MASK32
            t[N] = t[N + 1] + (s >> np.uint64(32))
            t[N + 1] = zero
        limbs = t[:N]
        big = (t[N] != 0) | self._geq_q(limbs)
        limbs = self._sub_q(limbs, big)
        return jnp.stack(limbs, axis=-1).astype(jnp.uint32)

    def mul(self, a, b):
        return self._mont_mul_limbs(a, b)

    def canon(self, x):
        one = jnp.broadcast_to(jnp.asarray(self._one_raw()), x.shape)
        return self._mont_mul_limbs(x, one)

    def from_canon(self, u):
        r2 = jnp.broadcast_to(jnp.asarray(self._to_limbs_host(self._R2_int)),
                              u.shape)
        return self._mont_mul_limbs(u, r2)


GOLDILOCKS = _Goldilocks()
BABYBEAR = _BabyBear()
FROG = _Frog()
STARK = _Stark()

FIELDS = {f.name: f for f in (GOLDILOCKS, BABYBEAR, FROG, STARK)}


def get_field(name: str) -> Field:
    return FIELDS[name]
