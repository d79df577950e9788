"""Symmetric matrix in packed lower-triangular form (reference
symmetric_matrix.rs:15-153) plus G^T M G recomposition
(balanced_decomposition/mod.rs:358-386)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["SymmetricMatrix", "recompose_left_right_symmetric_matrix"]


def _tri(i, j):
    a, b = (i, j) if i >= j else (j, i)
    return a * (a + 1) // 2 + b


class SymmetricMatrix:
    """Packed lower-triangular storage: vals [n(n+1)/2]+elem; at(i,j)
    swaps indices (symmetric_matrix.rs at/at_mut)."""

    def __init__(self, elems, n, vals):
        self.e = elems
        self.n = int(n)
        self.vals = vals

    @classmethod
    def zero(cls, elems, n):
        return cls(elems, n, elems.zeros((n * (n + 1) // 2,)))

    @classmethod
    def rand(cls, elems, n, rng):
        return cls(elems, n, elems.rand((n * (n + 1) // 2,), rng))

    @classmethod
    def from_rows(cls, elems, rows):
        """rows[i] has i+1 entries (the reference's Vec<Vec<F>> invariant,
        symmetric_matrix.rs:19)."""
        n = len(rows)
        flat = []
        for i, r in enumerate(rows):
            assert len(r) == i + 1, "row i must have i+1 entries"
            flat.extend(r)
        vals = elems.encode(np.array(flat, dtype=object)) if flat else \
            elems.zeros((0,))
        return cls(elems, n, vals)

    @classmethod
    def from_fn(cls, elems, n, func, vectorized=False):
        """Build entry (i, j) as ``func(i, j)`` over the packed lower
        triangle — the ``from_par_fn`` parallel constructor
        (symmetric_matrix.rs:77-89).  The rayon parallelism becomes a
        batched call: with ``vectorized=True`` func receives the full
        int32 index arrays ``(ii, jj)`` of shape [n(n+1)/2] and must
        return the packed values in one shot (the vectorized form);
        otherwise func(i, j) is called per entry and must return a
        python-int (or per-element) value."""
        ii = np.array([i for i in range(n) for _ in range(i + 1)],
                      dtype=np.int32)
        jj = np.array([j for i in range(n) for j in range(i + 1)],
                      dtype=np.int32)
        if vectorized:
            return cls(elems, n, func(ii, jj))
        flat = np.array([func(int(i), int(j)) for i, j in zip(ii, jj)],
                        dtype=object)
        vals = elems.encode(flat) if len(flat) else elems.zeros((0,))
        return cls(elems, n, vals)

    @classmethod
    def from_dense_vals(cls, elems, dense):
        n = dense.shape[0]
        idx = np.array([i * (i + 1) // 2 + j
                        for i in range(n) for j in range(i + 1)])
        ii = np.array([i for i in range(n) for j in range(i + 1)])
        jj = np.array([j for i in range(n) for j in range(i + 1)])
        return cls(elems, n, jnp.asarray(dense)[ii, jj])

    def size(self):
        return self.n

    def at(self, i, j):
        return self.vals[_tri(i, j)]

    def set_at(self, i, j, v):
        return SymmetricMatrix(self.e, self.n,
                               jnp.asarray(self.vals).at[_tri(i, j)].set(v))

    def diag(self):
        idx = np.array([_tri(i, i) for i in range(self.n)], dtype=np.int32)
        return jnp.take(jnp.asarray(self.vals), idx, axis=0)

    def to_dense(self):
        n = self.n
        idx = np.array([[_tri(i, j) for j in range(n)] for i in range(n)],
                       dtype=np.int32)
        return jnp.take(jnp.asarray(self.vals), idx, axis=0)

    def map_mul(self, s):
        return SymmetricMatrix(self.e, self.n, self.e.mul(self.vals, s))

    def decode(self):
        return self.e.decode(self.vals)


def recompose_left_right_symmetric_matrix(sym: SymmetricMatrix,
                                          powers_of_basis):
    """G^T M G with G = I_n (x) (1, b, ..., b^(d-1))
    (balanced_decomposition/mod.rs:358-386).

    M is (n*d) x (n*d) symmetric; result is n x n symmetric:
    out[i,j] = sum_{k in block i, l in block j} M[k,l] pb[k%d] pb[l%d].
    """
    e = sym.e
    pb = jnp.asarray(powers_of_basis)            # [d]+elem
    d = pb.shape[0]
    nd = sym.size()
    assert nd % d == 0
    n = nd // d
    dense = sym.to_dense()                       # [nd, nd]+elem
    scale = jnp.tile(pb, (n,) + (1,) * (pb.ndim - 1))   # [nd]+elem
    w = e.mul(dense, scale[None, :])             # scale columns
    w = e.mul(w, scale[:, None])                 # scale rows
    w = w.reshape((n, d, n, d) + w.shape[2:])
    s = e.sum(w, axis=3)
    s = e.sum(s, axis=1)
    return SymmetricMatrix.from_dense_vals(e, s)
