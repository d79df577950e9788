"""Sparse multilinear extensions (reference mle/sparse.rs:24-394).

The reference stores a BTreeMap<index, R>; the device layout is index/value
arrays with a static nnz (``indices int64 [nnz]``, ``values [nnz]+elem``).
Semantics are "sum of contributions": duplicate indices are allowed and add
up, which matches the map semantics for every operation here (evaluate,
fix_variables, to_dense, arithmetic).

* evaluate: sum_i v_i * eq(bits(idx_i), point) — O(nnz * n) fused ops
  (the reference's windowed eq-table precomputation, sparse.rs:170-207,
  is a CPU cache optimization of this same sum).
* fix_variables(k points): multiply each value by eq(low-k bits, points)
  and shift indices right by k — stays sparse with the same static nnz.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["SparseMLE"]


class SparseMLE:
    def __init__(self, elems, num_vars: int, indices, values):
        self.e = elems
        self.num_vars = int(num_vars)
        self.indices = jnp.asarray(indices, dtype=jnp.int64)
        self.values = values

    @property
    def nnz(self):
        return self.indices.shape[0]

    # -- constructors (sparse.rs:33-131) ---------------------------------
    @classmethod
    def from_pairs(cls, elems, num_vars, pairs):
        """pairs: [(index, python-int element)] (from_evaluations)."""
        n = max(len(pairs), 1)
        idx = np.zeros(n, dtype=np.int64)
        elem_shape = _logical_elem_shape(elems)
        vals = np.zeros((n,) + elem_shape, dtype=object)
        for i, (j, v) in enumerate(pairs):
            idx[i] = j
            vals[i] = v
        return cls(elems, num_vars, idx, jnp.asarray(elems.encode(vals)))

    @classmethod
    def rand_with_config(cls, elems, num_vars, nnz, rng):
        """Rejection-free analogue of rand_with_config (sparse.rs:66-93):
        nnz distinct random indices with random values."""
        idx = rng.sample(range(1 << num_vars), nnz)
        vals = elems.rand((nnz,), rng)
        return cls(elems, num_vars, np.array(sorted(idx), dtype=np.int64),
                   jnp.asarray(vals))

    @classmethod
    def from_matrix(cls, elems, sparse_mat):
        """SparseMatrix -> sparse MLE with power-of-two padding
        (sparse.rs from_matrix)."""
        pr = max(1 << int(np.ceil(np.log2(max(sparse_mat.nrows, 1)))), 1)
        pc = max(1 << int(np.ceil(np.log2(max(sparse_mat.ncols, 1)))), 1)
        nv = int(np.log2(pr)) + int(np.log2(pc))
        ids = sparse_mat.rows.astype(jnp.int64) * pc + \
            sparse_mat.cols.astype(jnp.int64)
        return cls(elems, nv, ids, sparse_mat.data)

    # -- evaluation ------------------------------------------------------
    def _eq_factors(self, points, bit_offset: int):
        """prod_j (bit_j ? p_j : 1 - p_j) for each stored index."""
        e = self.e
        one = e.one()
        acc = None
        for j, p in enumerate(points):
            p = jnp.asarray(p)
            bit = (self.indices >> np.int64(bit_offset + j)) & np.int64(1)
            cond = bit.astype(bool).reshape((self.nnz,) + (1,) * p.ndim)
            w = jnp.where(cond, p[None], jnp.asarray(e.sub(one, p))[None])
            acc = w if acc is None else e.mul(acc, w)
        return acc

    def evaluate(self, points):
        assert len(points) == self.num_vars
        e = self.e
        if self.num_vars == 0:
            return e.f.sum(self.values, 0)
        eq = self._eq_factors(points, 0)
        prod = e.mul(self.values, eq)
        return e.f.sum(prod, 0)

    def fix_variables(self, points):
        """Bind the first k variables (sparse.rs:133-207)."""
        k = len(points)
        assert k <= self.num_vars
        e = self.e
        if k == 0:
            return self
        eq = self._eq_factors(points, 0)
        new_vals = e.mul(self.values, eq)
        new_idx = self.indices >> np.int64(k)
        return SparseMLE(e, self.num_vars - k, new_idx, new_vals)

    def fix_variables_windowed(self, points, window: int | None = None):
        """Windowed fix_variables (reference sparse.rs:170-207,381-394).

        Instead of one eq-factor multiply per (entry, variable), build a
        2^w eq table per window of w variables (by doubling: 2^w storage
        muls shared across all entries) and charge each entry ONE gather
        + multiply per window.  Equal to :meth:`fix_variables`; wins when
        nnz >> 2^w (the reference picks w = log2(nnz))."""
        k = len(points)
        assert k <= self.num_vars
        e = self.e
        if k == 0:
            return self
        if window is None:
            window = max(int(self.nnz).bit_length() - 1, 1)
        vals = self.values
        idx = self.indices
        off = 0
        while off < k:
            w = min(window, k - off)
            # eq table over the next w variables: table[t] =
            # prod_j (bit_j(t) ? p_j : 1 - p_j), built by doubling
            table = e.one()[None]
            for j in range(w):
                p = jnp.asarray(points[off + j])
                lo = e.mul(table, jnp.asarray(e.sub(e.one(), p))[None])
                hi = e.mul(table, p[None])
                table = jnp.concatenate([lo, hi], axis=0)
            low = (idx >> np.int64(off)) & np.int64((1 << w) - 1)
            vals = e.mul(vals, jnp.take(table, low, axis=0))
            off += w
        return SparseMLE(e, self.num_vars - k, idx >> np.int64(k), vals)

    def index(self, i: int):
        """Log-time point lookup (reference's Index impl,
        sparse.rs:348-366): returns the stored element at hypercube index
        ``i`` (zero if absent).  Binary search over a host-side sorted
        copy of the index array (built once, cached)."""
        cache = getattr(self, "_index_cache", None)
        if cache is None:
            host = np.asarray(self.indices)
            order = np.argsort(host, kind="stable")
            cache = (host[order], order)
            self._index_cache = cache
        sorted_idx, order = cache
        lo = int(np.searchsorted(sorted_idx, i, side="left"))
        hi = int(np.searchsorted(sorted_idx, i, side="right"))
        if lo == hi:
            return self.e.zeros(_logical_elem_shape(self.e))
        acc = None
        vals = jnp.asarray(self.values)
        for t in range(lo, hi):       # duplicates sum (map semantics)
            v = vals[int(order[t])]
            acc = v if acc is None else self.e.add(acc, v)
        return acc

    def relabel(self, a: int, b: int, k: int):
        """Swap variable windows [a,a+k) / [b,b+k) (sparse.rs relabel):
        a pure index-bit permutation of the stored indices."""
        if a > b:
            a, b = b, a
        if a == b or k == 0:
            return self
        assert b + k <= self.num_vars and a + k <= b
        idx = self.indices
        mask = np.int64((1 << k) - 1)
        abits = (idx >> np.int64(a)) & mask
        bbits = (idx >> np.int64(b)) & mask
        cleared = idx & ~((mask << np.int64(a)) | (mask << np.int64(b)))
        new_idx = cleared | (abits << np.int64(b)) | (bbits << np.int64(a))
        return SparseMLE(self.e, self.num_vars, new_idx, self.values)

    # -- conversions -----------------------------------------------------
    def to_dense(self):
        from .dense import DenseMLE

        f = self.e.f
        v = f.segment_sum(self.values, self.indices, 1 << self.num_vars)
        return DenseMLE(self.e, self.num_vars, v)

    def decode_dense(self):
        return self.to_dense().decode()

    # -- arithmetic (sparse.rs add/sub/neg/axpy) -------------------------
    def neg(self):
        return SparseMLE(self.e, self.num_vars, self.indices,
                         self.e.neg(self.values))

    def scalar_mul(self, r):
        return SparseMLE(self.e, self.num_vars, self.indices,
                         self.e.mul(self.values, r))

    def add(self, other):
        assert self.num_vars == other.num_vars
        return SparseMLE(
            self.e, self.num_vars,
            jnp.concatenate([self.indices, other.indices]),
            jnp.concatenate([jnp.asarray(self.values),
                             jnp.asarray(other.values)], axis=0))

    def sub(self, other):
        return self.add(other.neg())


def _logical_elem_shape(elems):
    ring = getattr(elems, "ring", None)
    return (ring.D,) if ring is not None else ()

