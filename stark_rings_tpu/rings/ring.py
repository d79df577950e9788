"""Cyclotomic ring models as batched JAX kernels (L2 of the reference).

A :class:`RingModel` binds one spec model (goldilocks / babybear / frog /
stark_prime) to its prime field and exposes the full `Ring`/`PolyRing`
capability surface of the reference as **functional, batched array ops**:

* coefficient form  — storage ``[..., D(, limbs)]``; schoolbook multiply +
  cyclotomic reduction (reference coeff_form.rs:54-67 + per-model
  ``reduce_in_place``).
* NTT/CRT form      — same shape, slot-major layout ``N x E``; slot-wise
  extension-field multiply (reference ntt_form.rs:159-189) via precomputed
  gather/factor tables.
* ``crt``/``icrt``  — chains of 2-term linear stages derived from the
  integer spec (reference goldilocks/ntt.rs:68-127 etc.), fully vectorized.

A "vector of ring elements" is just a leading batch axis; the reference's
``elementwise_crt`` / ``Flatten`` unsafe casts (crt.rs:10-49,
flatten.rs:10-44) are plain reshapes here.
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

from ..fields import FIELDS, Field
from ..ops.stages import derive_linear_table, derive_stage_tables
from ..spec import MODELS, SpecModel

__all__ = ["RingModel", "get_ring", "RINGS"]

_FIELD_FOR_MODEL = {
    "goldilocks": "goldilocks",
    "babybear": "babybear",
    "frog": "frog",
    "stark_prime": "stark_prime",
}


class RingModel:
    """One cyclotomic ring model: Fq[X]/Phi(X) with its CRT machinery."""

    def __init__(self, spec: SpecModel, field: Field):
        self.spec = spec
        self.field = field
        self.name = spec.name
        self.q = spec.q
        self.D = spec.D
        self.N = spec.N
        self.E = spec.E

    # ------------------------------------------------------------------
    # derived tables (built lazily, cached)
    # ------------------------------------------------------------------
    #: class-wide switch: apply CRT/ICRT as one fused D x D matmul
    #: (ops/dense_linear.py) instead of the chained butterfly stages.
    use_dense_crt: bool = True

    @cached_property
    def _stages(self):
        return derive_stage_tables(self.spec, self.field)

    @cached_property
    def _dense_crt(self):
        """(crt, icrt) as single D x D DenseModMat maps, probed from the
        integer spec (the composite of all butterfly layers + slot
        isomorphisms, goldilocks/ntt.rs:68-127 etc.)."""
        from ..ops.dense_linear import probe_dense_matrix
        from ..ops.mxu_dense import prescaled_dense

        mc = probe_dense_matrix(self.spec.crt, self.D, self.D, self.q)
        mi = probe_dense_matrix(self.spec.icrt, self.D, self.D, self.q)
        # int8 digit-plane matmul per field (ops/mxu_dense.py): one int8
        # dot + per-output fold instead of D*D emulated wide multiplies
        # (for the 8-limb stark prime the DenseModMat graph would be 256
        # CIOS muls).
        return (prescaled_dense(self.field, mc),
                prescaled_dense(self.field, mi))

    @cached_property
    def _reduce_table(self):
        spec = self.spec

        def fold(c):
            r = spec.reduce(c)
            c[: len(r)] = r

        return derive_linear_table(fold, 2 * spec.D - 1, spec.D, self.field,
                                   max_terms=3)

    @cached_property
    def _ext_tables(self):
        """Gather/factor tables for slot-wise extension multiplication.

        In degree coordinates c[k] = sum_i a[i] * b[(k-i) % E] * nr^[i>k]
        (X^E = nr); conjugated by the model's storage permutation
        (e.g. babybear's permute_to_fq9_of_fq3, ntt.rs:580-588).
        """
        E, q, nr = self.E, self.q, self.spec.nr
        perm = np.asarray(self.spec.storage_perm, dtype=np.int32)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(E, dtype=np.int32)
        idx = np.zeros((E, E), dtype=np.int32)
        fac = np.zeros((E, E), dtype=object)
        for i in range(E):
            for k in range(E):
                idx[i, k] = (k - i) % E
                fac[i, k] = nr % q if i > k else 1
        return perm, inv_perm, idx, self.field.encode(fac)

    @cached_property
    def _conv_tables(self):
        """Index/mask tables for the schoolbook full product."""
        D = self.D
        L = 2 * D - 1
        idx = np.zeros((D, L), dtype=np.int32)
        mask = np.zeros((D, L), dtype=bool)
        for i in range(D):
            for k in range(L):
                j = k - i
                if 0 <= j < D:
                    idx[i, k] = j
                    mask[i, k] = True
        return idx, mask

    # ------------------------------------------------------------------
    # host conversions
    # ------------------------------------------------------------------
    def encode_coeffs(self, ints):
        """[..., D] python-int array -> storage."""
        arr = np.asarray(ints, dtype=object)
        assert arr.shape[-1] == self.D
        return self.field.encode(arr)

    def decode(self, x):
        return self.field.decode(x)

    def rand_coeff(self, shape, rng):
        return self.field.rand(tuple(shape) + (self.D,), rng)

    def rand_ntt(self, shape, rng):
        return self.field.rand(tuple(shape) + (self.D,), rng)

    def zeros(self, shape=()):
        return self.field.zeros(tuple(shape) + (self.D,))

    def from_coeff_list(self, ints):
        """From<Vec<Fq>> semantics (coeff_form.rs:568-578): pad short
        vectors with zeros, reduce longer ones mod Phi(X).  Host-side
        constructor over python ints; lengths up to 2D-1."""
        vals = [int(v) % self.q for v in ints]
        if len(vals) < self.D:
            vals = vals + [0] * (self.D - len(vals))
        elif len(vals) > self.D:
            assert len(vals) <= 2 * self.D, "coefficient list too long"
            vals = self.spec.reduce(vals)
        return self.encode_coeffs(np.array(vals, dtype=object))

    def rot_iter(self, x, count=None):
        """Cyclotomic::into_rot_iter (traits.rs:58-84): yields x, x*X,
        x*X^2, ... (count defaults to the cyclotomic degree)."""
        n = self.D if count is None else count
        cur = x
        for _ in range(n):
            yield cur
            cur = self.rot(cur)

    def from_scalar_coeff(self, v, shape=()):
        """Coefficient-form constant polynomial (coeff_form.rs:556-561)."""
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0] = v % self.q
        return self.encode_coeffs(out)

    def from_scalar_ntt(self, v, shape=()):
        """NTT-form scalar: broadcast over slots (ntt_form.rs:689-692)."""
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0 :: self.E] = v % self.q
        return self.encode_coeffs(out)

    # ------------------------------------------------------------------
    # traced ring ops (all batched over leading axes)
    # ------------------------------------------------------------------
    def add(self, a, b):
        return self.field.add(a, b)

    def sub(self, a, b):
        return self.field.sub(a, b)

    def neg(self, a):
        return self.field.neg(a)

    def scalar_mul(self, s, a):
        """Multiply every coefficient by a base-field scalar (storage)."""
        return self.field.mul(s, a)

    def mul_consts(self):
        """The fused CRT/ICRT digit tables as a pytree.

        device_put once and pass to ``crt/icrt(x, c=...)`` inside jits,
        rather than embedding MB-scale weight tables as closure
        constants in the HLO."""
        crt, icrt = self._dense_crt
        get = lambda m: np.asarray(getattr(m, "core", m).big)  # noqa: E731
        return {"crt": get(crt), "icrt": get(icrt)}

    def crt(self, x, c=None):
        """coeff -> NTT form (reference crt.rs:55-63); by default the
        whole chain is one fused D x D modular matmul.  ``c``: optional
        ``mul_consts()`` pytree passed as a traced argument."""
        if self.use_dense_crt:
            return self._dense_crt[0](x, None if c is None else c["crt"])
        return self.crt_staged(x)

    def icrt(self, x, c=None):
        """NTT -> coeff form."""
        if self.use_dense_crt:
            return self._dense_crt[1](x, None if c is None else c["icrt"])
        return self.icrt_staged(x)

    def crt_staged(self, x):
        """The round-1 chained butterfly-stage path (kept as oracle)."""
        for st in self._stages[0]:
            x = st(x)
        return x

    def icrt_staged(self, x):
        for st in self._stages[1]:
            x = st(x)
        return x

    def ntt_mul(self, a, b):
        """Slot-wise extension-field multiply of NTT-form elements.

        Mirrors ntt_form.rs:159-189; the reference's zero-short-circuit in
        ``mul`` vs ``mul_unchecked`` is a CPU branch with identical
        semantics, so both map to this one branch-free kernel.
        """
        f = self.field
        if self.E == 1:
            return f.mul(a, b)
        perm, inv_perm, idx, fac = self._ext_tables
        N, E = self.N, self.E
        off = 2 if f.limbed else 1
        limb = f.limb_shape
        a = a.reshape(a.shape[: a.ndim - off] + (N, E) + limb)
        b = b.reshape(b.shape[: b.ndim - off] + (N, E) + limb)
        a_deg = f.take_coeff(a, perm)
        b_deg = f.take_coeff(b, perm)
        # bg[..., n, i, k] = b_deg[..., n, (k-i)%E]
        bg = f.take_coeff(b_deg, idx)
        scaled = f.mul(fac, bg)
        if f.limbed:
            prod = f.mul(a_deg[..., :, None, :], scaled)
            c_deg = f.sum(prod, axis=-3)
        else:
            prod = f.mul(a_deg[..., :, None], scaled)
            c_deg = f.sum(prod, axis=-2)
        c = f.take_coeff(c_deg, inv_perm)
        # batch may have broadcast: derive output shape from c itself
        nb = c.ndim - 2 - (1 if f.limbed else 0)
        return c.reshape(c.shape[:nb] + (self.D,) + limb)

    mul_unchecked = ntt_mul

    def coeff_mul(self, a, b):
        """Schoolbook polynomial multiply + cyclotomic reduction
        (coeff_form.rs:54-67; the in-framework oracle for ntt_mul)."""
        f = self.field
        idx, mask = self._conv_tables
        bg = f.take_coeff(b, idx)            # [..., D, 2D-1(, L)]
        bg = f.select(mask, bg, jnp.zeros_like(bg))
        if f.limbed:
            prod = f.mul(a[..., :, None, :], bg)
            conv = f.sum(prod, axis=-3)
        else:
            prod = f.mul(a[..., :, None], bg)
            conv = f.sum(prod, axis=-2)
        return self._reduce_table(conv)

    def reduce(self, c):
        """Reduce a length-(2D-1) coefficient tensor mod Phi(X)."""
        return self._reduce_table(c)

    def rot(self, a):
        """Multiply by X in coefficient form (Cyclotomic::rot,
        goldilocks/mod.rs:138-149 / frog_ring/mod.rs:125-133)."""
        f = self.field
        D = self.D
        last = f.take_coeff(a, np.arange(D - 1, D, dtype=np.int32))
        rest = f.take_coeff(a, np.arange(0, D - 1, dtype=np.int32))
        head = f.neg(last)
        out = jnp.concatenate([head, rest], axis=f.coeff_axis)
        if self.spec.has_middle_term:
            h = D // 2
            mid = f.take_coeff(out, np.arange(h, h + 1, dtype=np.int32))
            mid = f.add(mid, last)
            pre = f.take_coeff(out, np.arange(0, h, dtype=np.int32))
            post = f.take_coeff(out, np.arange(h + 1, D, dtype=np.int32))
            out = jnp.concatenate([pre, mid, post], axis=f.coeff_axis)
        return out

    def pow_rot(self, a, k: int):
        """a * X^k via coeff_mul with a monomial (rot() iterated)."""
        out = a
        for _ in range(k):
            out = self.rot(out)
        return out

    def ntt_pow(self, a, e: int):
        """Elementwise power in NTT form via slot-wise square & multiply."""
        acc = None
        base = a
        if e == 0:
            return self.from_scalar_ntt(1, a.shape[: a.ndim - (2 if self.field.limbed else 1)])
        while e:
            if e & 1:
                acc = base if acc is None else self.ntt_mul(acc, base)
            e >>= 1
            if e:
                base = self.ntt_mul(base, base)
        return acc

    @cached_property
    def _frob_tables(self):
        """Per-slot Frobenius maps x -> x^(q^i), i=1..E-1, as 1-term stages.

        In the canonical slot field Fq[X]/(X^E - nr) Frobenius is a
        monomial map X^j -> nr^k X^r with j*q^i = E*k + r, i.e. a
        permutation + diagonal scale — derived here by probing the integer
        spec convention (storage_perm conjugation as in SpecModel.ext_mul).
        """
        spec, E, q, nr = self.spec, self.E, self.q, self.spec.nr
        perm = list(spec.storage_perm)
        inv_perm = [0] * E
        for i, p in enumerate(perm):
            inv_perm[p] = i
        tables = []
        for i in range(1, E):
            qi = q ** i

            def frob(c, qi=qi):
                ad = [c[perm[t]] for t in range(E)]
                out = [0] * E
                for j in range(E):
                    m = j * qi
                    r = m % E
                    k = m // E
                    out[r] = (out[r] + ad[j] * pow(nr, k, q)) % q
                c[:] = [out[inv_perm[t]] for t in range(E)]

            tables.append(
                derive_linear_table(frob, E, E, self.field, max_terms=1))
        return tables

    def _slotwise(self, fn, x):
        """Apply an E-coordinate map slot-wise over the D axis."""
        f = self.field
        batch = x.shape[: x.ndim - (2 if f.limbed else 1)]
        xs = x.reshape(batch + (self.N, self.E) + f.limb_shape)
        ys = fn(xs)
        return ys.reshape(batch + (self.D,) + f.limb_shape)

    def ntt_frobenius(self, a, i: int = 1):
        """Slot-wise Frobenius x -> x^(q^i) on NTT-form elements — a free
        (permutation+scale) ring automorphism in the slot field, useful
        for norm maps and conjugate tricks in protocol code."""
        if self.E == 1 or i % self.E == 0:
            return a
        return self._slotwise(self._frob_tables[(i % self.E) - 1], a)

    def ntt_inv(self, a):
        """Slot-wise inverse (slots must be nonzero).

        Uses the norm trick instead of Fermat on q^E: with
        c = prod_{i=1..E-1} a^(q^i) (conjugate product via the Frobenius
        stages), N(a) = a*c lies in Fq, so a^-1 = c * N(a)^-1 — only one
        base-field inversion of a 64-bit (or 252-bit) exponent chain.
        """
        f = self.field
        if self.E == 1:
            return f.inv(a)
        conj = None
        for tab in self._frob_tables:
            fa = self._slotwise(tab, a)
            conj = fa if conj is None else self.ntt_mul(conj, fa)
        norm = self.ntt_mul(a, conj)
        # norm lives in Fq: stored coordinate 0 of each slot
        batch = norm.shape[: norm.ndim - (2 if f.limbed else 1)]
        ns = norm.reshape(batch + (self.N, self.E) + f.limb_shape)
        n0 = f.take_coeff(ns, np.arange(0, 1, dtype=np.int32))
        inv_n0 = f.inv(n0)  # [..., N, 1(, L)] broadcasts over E
        cs = conj.reshape(batch + (self.N, self.E) + f.limb_shape)
        out = f.mul(cs, inv_n0)
        return out.reshape(batch + (self.D,) + f.limb_shape)

    # -- flatten (R10): Vec<Rq> <-> Vec<Fq> are reshapes -----------------
    def flatten(self, x):
        f = self.field
        batch = x.shape[: x.ndim - (2 if f.limbed else 1) - 1]
        n = x.shape[-2 - (1 if f.limbed else 0)]
        return x.reshape(batch + (n * self.D,) + f.limb_shape)

    def promote(self, x):
        f = self.field
        batch = x.shape[: x.ndim - (1 if f.limbed else 0) - 1]
        nd = x.shape[-1 - (1 if f.limbed else 0)]
        assert nd % self.D == 0
        return x.reshape(batch + (nd // self.D, self.D) + f.limb_shape)


RINGS: Dict[str, RingModel] = {}


def get_ring(name: str) -> RingModel:
    if name not in RINGS:
        ring = RingModel(MODELS[name], FIELDS[_FIELD_FOR_MODEL[name]])
        RINGS[name] = ring
    return RINGS[name]
