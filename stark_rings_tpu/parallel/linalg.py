"""Sharded ring linear algebra: distributed mat-vec over a device mesh.

The dense/sparse matvecs of `stark_rings_tpu.linalg` scale out by sharding
the CONTRACTION (column) axis: each device multiplies its column block
against its slice of the vector and the partial sums meet in one widened
`psum` (exact mod-q: base-2^32 word sums, folded once after the
collective) — the multi-chip version of the reference's rayon row loops
(sparse_matrix.rs:202-217)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..fields import Field
from .collectives import psum_words

__all__ = ["ShardedMatVec", "ShardedSparseMatVec"]


class ShardedMatVec:
    """Builder for column-sharded dense mat-vec kernels.

    A: [n, m] + elem, sharded over axis 1 (columns); v: [m] + elem,
    sharded over axis 0. Result: [n] + elem, replicated."""

    def __init__(self, elems, mesh: Mesh, axis: str = "x"):
        self.e = elems
        self.mesh = mesh
        self.axis = axis

    def specs(self):
        nd = self.e.elem_ndim
        tail = (None,) * nd
        return (P(None, self.axis, *tail), P(self.axis, *tail),
                P(*((None,) + tail)))

    def make_matvec_fn(self):
        e = self.e
        f = e.f
        axis = self.axis

        def local(A_blk, v_blk):
            prod = e.mul(A_blk, v_blk[None])        # [n, m_loc]+elem
            w = f.widen(prod)                       # [n, m_loc, ..., W]
            local_words = jnp.sum(w, axis=1)
            total = psum_words(local_words, axis)
            return f.reduce_words(total)

        a_spec, v_spec, out_spec = self.specs()
        return jax.jit(jax.shard_map(
            local, mesh=self.mesh, in_specs=(a_spec, v_spec),
            out_specs=out_spec, check_vma=False))


class ShardedSparseMatVec:
    """nnz-sharded sparse mat-vec (the reference's linalg workhorse,
    sparse_matrix.rs:202-217, scaled across chips).

    The COO entry axis is sharded: each device gathers v at its column
    indices, multiplies against its data slice, and segment-sums the
    widened words into a full-height [nrows] partial; the partials meet
    in one exact `psum_words`.  Sharding nnz (not rows) keeps load
    balanced under skewed sparsity patterns — the same reason the
    reference parallelizes over rows only because its rows hold the
    nnz.  v is replicated (it is the small operand in the Ajtai/
    constraint-system shapes this serves)."""

    def __init__(self, elems, mesh: Mesh, axis: str = "x"):
        self.e = elems
        self.mesh = mesh
        self.axis = axis

    def shard(self, smat):
        """Pad a SparseMatrix's COO arrays to a multiple of the mesh
        size.  Padding entries carry zero data and row/col 0 — they add
        zero words to row 0, which is exact."""
        Pn = int(self.mesh.shape[self.axis])
        pad = (-smat.nnz) % Pn
        data = np.asarray(smat.data)
        rows = np.asarray(smat.rows)
        cols = np.asarray(smat.cols)
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
            rows = np.concatenate([rows, np.zeros(pad, rows.dtype)])
            cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
        return data, rows, cols

    def make_matvec_fn(self, nrows: int):
        # cached per nrows: each compiled fn re-specializes only on the
        # (padded) nnz via jit's shape polymorphism — without the cache
        # every mul_vec call re-built the shard_map closure and paid a
        # fresh compile
        cache = getattr(self, "_fn_cache", None)
        if cache is None:
            cache = self._fn_cache = {}
        if nrows in cache:
            return cache[nrows]
        e = self.e
        f = e.f
        axis = self.axis
        nd = e.elem_ndim
        tail = (None,) * nd

        def local(data_blk, rows_blk, cols_blk, v):
            vg = jnp.take(v, cols_blk, axis=0)          # [nnz_loc]+elem
            prod = e.mul(data_blk, vg)
            w = f.widen(prod)                           # [nnz_loc, ..., W]
            zero = jnp.zeros((nrows,) + w.shape[1:], dtype=jnp.uint64)
            local_words = zero.at[rows_blk].add(w)
            total = psum_words(local_words, axis)
            return f.reduce_words(total)

        in_specs = (P(axis, *tail), P(axis), P(axis), P(None, *tail))
        fn = jax.jit(jax.shard_map(
            local, mesh=self.mesh, in_specs=in_specs,
            out_specs=P(None, *tail), check_vma=False))
        cache[nrows] = fn
        return fn

    def mul_vec(self, smat, v):
        """One-shot: sharded smat @ v, checked like mul_vec."""
        if v.shape[0] != smat.ncols:
            from ..linalg import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: ncols={smat.ncols}, len(v)={v.shape[0]}")
        data, rows, cols = self.shard(smat)
        return self.make_matvec_fn(smat.nrows)(data, rows, cols, v)
