"""Sparse matrix over ring elements (reference sparse_matrix.rs:18-307).

The reference stores per-row ``Vec<(R, col)>``; the device layout is
**COO with a static nnz**: ``data [nnz]+elem``, ``row/col int32 [nnz]``.
Padding entries carry zero data (and row/col 0), which is harmless for all
ops here because the modular segment-sum adds zeros.

* mat-vec (sparse_matrix.rs:202-217): gather + modular segment-sum.
* sparse·sparse (merge-join in the reference, :219-275): ``mul_sparse``
  keeps an O(nnz) SPARSE result — a host-side equi-join of A's column
  indices with B's row indices (static data, never traced) followed by
  one device gather-multiply + modular segment-sum over the matched term
  pairs.  The dense accumulator is never materialized.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["SparseMatrix"]


class SparseMatrix:
    def __init__(self, elems, nrows, ncols, data, rows, cols):
        self.e = elems
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.data = data
        self.rows = jnp.asarray(rows, dtype=jnp.int32)
        self.cols = jnp.asarray(cols, dtype=jnp.int32)

    @property
    def nnz(self):
        return self.data.shape[0]

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_entries(cls, elems, nrows, ncols, entries):
        """entries: list of (row, col, python-int element)."""
        n = max(len(entries), 1)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        vals = np.zeros((n,) + tuple(
            getattr(elems, "elem_logical_shape", None) or
            _elem_logical(elems)), dtype=object)
        for i, (r, c, v) in enumerate(entries):
            rows[i], cols[i] = r, c
            vals[i] = v
        data = elems.encode(vals)
        return cls(elems, nrows, ncols, data, rows, cols)

    @classmethod
    def identity(cls, elems, n):
        one = elems.one()
        data = jnp.broadcast_to(one, (n,) + one.shape)
        idx = np.arange(n, dtype=np.int32)
        return cls(elems, n, n, data, idx, idx)

    @classmethod
    def rand(cls, elems, nrows, ncols, sparsity, rng):
        """~sparsity fraction of nonzero entries (sparse_matrix.rs rand)."""
        entries = []
        for r in range(nrows):
            for c in range(ncols):
                if rng.random() < sparsity:
                    entries.append((r, c))
        n = max(len(entries), 1)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        data = elems.rand((n,), rng)
        if not entries:
            data = jnp.asarray(data) * 0
        for i, (r, c) in enumerate(entries):
            rows[i], cols[i] = r, c
        if len(entries) < n:
            data = jnp.asarray(data).at[len(entries):].set(0)
        return cls(elems, nrows, ncols, data, rows, cols)

    @classmethod
    def from_dense(cls, elems, mat):
        """Dense Matrix -> COO (host pass over decoded zero pattern)."""
        vals = np.asarray(mat.vals)
        ez = elems.elem_ndim
        nz = ~np.all(vals.reshape(vals.shape[:2] + (-1,)) == 0, axis=-1) \
            if ez else (vals != 0)
        rr, cc = np.nonzero(nz)
        n = max(len(rr), 1)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        rows[: len(rr)] = rr
        cols[: len(cc)] = cc
        data = jnp.zeros((n,) + vals.shape[2:], dtype=mat.vals.dtype)
        if len(rr):
            data = data.at[: len(rr)].set(jnp.asarray(vals)[rr, cc])
        return cls(elems, mat.nrows, mat.ncols, data, rows, cols)

    # -- conversions -----------------------------------------------------
    def to_dense(self):
        from .matrix import Matrix

        f = self.e.f
        flat_ids = self.rows.astype(jnp.int64) * self.ncols + \
            self.cols.astype(jnp.int64)
        dense = f.segment_sum(self.data, flat_ids, self.nrows * self.ncols)
        vals = dense.reshape((self.nrows, self.ncols) + dense.shape[1:])
        return Matrix(self.e, vals)

    def decode_dense(self):
        return self.to_dense().decode()

    # -- structural ------------------------------------------------------
    def hconcat(self, other):
        assert self.nrows == other.nrows
        return SparseMatrix(
            self.e, self.nrows, self.ncols + other.ncols,
            jnp.concatenate([self.data, other.data], axis=0),
            jnp.concatenate([self.rows, other.rows]),
            jnp.concatenate([self.cols, other.cols + self.ncols]))

    def vconcat(self, other):
        assert self.ncols == other.ncols
        return SparseMatrix(
            self.e, self.nrows + other.nrows, self.ncols,
            jnp.concatenate([self.data, other.data], axis=0),
            jnp.concatenate([self.rows, other.rows + self.nrows]),
            jnp.concatenate([self.cols, other.cols]))

    def pad(self, nrows, ncols):
        assert nrows >= self.nrows and ncols >= self.ncols
        return SparseMatrix(self.e, nrows, ncols, self.data, self.rows,
                            self.cols)

    def transpose(self):
        return SparseMatrix(self.e, self.ncols, self.nrows, self.data,
                            self.cols, self.rows)

    def scalar_mul(self, s):
        return SparseMatrix(self.e, self.nrows, self.ncols,
                            self.e.mul(self.data, s), self.rows, self.cols)

    # -- arithmetic ------------------------------------------------------
    def mul_vec(self, v):
        """checked_mul_vec (sparse_matrix.rs:202-217): gather+segment-sum.

        Raises AlgebraError on dimension mismatch."""
        if v.shape[0] != self.ncols:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: ncols={self.ncols}, len(v)={v.shape[0]}")
        f = self.e.f
        vg = jnp.take(jnp.asarray(v), self.cols, axis=0)
        prod = self.e.mul(self.data, vg)
        return f.segment_sum(prod, self.rows, self.nrows)

    def mul_dense(self, mat_vals):
        """sparse [n,k] @ dense [k,m]+e -> dense [n,m]+e."""
        f = self.e.f
        bg = jnp.take(jnp.asarray(mat_vals), self.cols, axis=0)  # [nnz,m]+e
        prod = self.e.mul(self.data[:, None], bg)
        return f.segment_sum(prod, self.rows, self.nrows)

    # -- gadget decomposition (balanced_decomposition/mod.rs:311-352) ----
    def gadget_decompose(self, b: int, k: int):
        """n x m -> n x (k*m): entry (r, c, v) expands to k entries
        (r, c*k + j, digit_j(v)); zeros keep the static nnz*k layout
        (the reference's retain() is a CPU memory optimization)."""
        from ..decomp import decompose, decompose_ring

        f = self.e.f
        ringlike = getattr(self.e, "ring", None) is not None
        dig = (decompose_ring if ringlike else decompose)(
            f, self.data, b, k)                   # [nnz, k, ...]
        data = dig.reshape((self.nnz * k,) + dig.shape[2:])
        rows = jnp.repeat(self.rows, k)
        cols = (self.cols[:, None] * k
                + jnp.arange(k, dtype=jnp.int32)[None, :]).reshape(-1)
        return SparseMatrix(self.e, self.nrows, self.ncols * k, data,
                            rows, cols)

    def gadget_recompose(self, b: int, k: int):
        """n x (k*m) -> n x m: scale entry by b^(c mod k), c //= k
        (duplicates are summed by the segment-sum semantics)."""
        f = self.e.f
        pows_np = np.stack([np.asarray(f.encode(
            np.array(pow(b, j, f.q), dtype=object))) for j in range(k)],
            axis=0)
        j = self.cols % k
        scale = jnp.take(jnp.asarray(pows_np), j, axis=0)   # [nnz(,L)]
        if getattr(self.e, "ring", None) is not None:
            # broadcast the base-field scalar over the D axis
            scale = scale[:, None, :] if f.limbed else scale[:, None]
        data = f.mul(self.data, scale)
        return SparseMatrix(self.e, self.nrows, self.ncols // k, data,
                            self.rows, self.cols // k)

    def mul_sparse(self, other):
        """sparse·sparse with a SPARSE result (sparse_matrix.rs:219-275).

        The reference's column-index merge-join becomes: a host-side
        equi-join of A's column indices with B's row indices (the index
        structure is static data, never traced), then ONE device
        gather-multiply + modular segment-sum over the matched term
        pairs.  Output nnz = number of distinct (row, col) cells touched
        — O(nnz_terms) memory, never the dense n*m accumulator.

        Entries whose accumulated value is zero are kept (static shapes);
        the reference drops them — observably equal through to_dense.
        """
        if self.ncols != other.nrows:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: {self.ncols} vs {other.nrows}")
        ra = np.asarray(self.rows, dtype=np.int64)
        ka = np.asarray(self.cols, dtype=np.int64)
        kb = np.asarray(other.rows, dtype=np.int64)
        cb = np.asarray(other.cols, dtype=np.int64)
        # vectorized equi-join (searchsorted over B's sorted row index):
        # O((nnz_a + nnz_b) log nnz_b + matches) numpy host time, no
        # per-entry Python loops — 10^5-nnz joins build in well under 1 s.
        order = np.argsort(kb, kind="stable")
        kb_sorted = kb[order]
        starts = np.searchsorted(kb_sorted, ka, side="left")
        ends = np.searchsorted(kb_sorted, ka, side="right")
        counts = ends - starts
        total = int(counts.sum())
        f = self.e.f
        if total == 0:   # empty product: one zero padding entry
            data = jnp.zeros((1,) + self.data.shape[1:], self.data.dtype)
            return SparseMatrix(self.e, self.nrows, other.ncols, data,
                                np.zeros(1, np.int32), np.zeros(1, np.int32))
        ia = np.repeat(np.arange(len(ra), dtype=np.int64), counts)
        # intra-group offsets: global arange minus each group's start
        grp_start = np.repeat(np.cumsum(counts) - counts, counts)
        ib = order[np.repeat(starts, counts)
                   + (np.arange(total, dtype=np.int64) - grp_start)]
        keys = ra[ia] * np.int64(other.ncols) + cb[ib]
        uniq, seg = np.unique(keys, return_inverse=True)
        prod = self.e.mul(jnp.take(self.data, ia, axis=0),
                          jnp.take(other.data, ib, axis=0))
        out_data = f.segment_sum(prod, seg.astype(np.int32), len(uniq))
        rows = (uniq // other.ncols).astype(np.int32)
        cols = (uniq % other.ncols).astype(np.int32)
        return SparseMatrix(self.e, self.nrows, other.ncols, out_data,
                            rows, cols)


def _elem_logical(elems):
    """Logical (pre-encode) element shape: ring elements have (D,)."""
    ring = getattr(elems, "ring", None)
    return (ring.D,) if ring is not None else ()
