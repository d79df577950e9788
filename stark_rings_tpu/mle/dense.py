"""Dense multilinear extensions over rings (reference poly crate,
mle/dense.rs:18-418).

Evaluations over {0,1}^n are one tensor ``evals [2^n] + elem`` with the
reference's **little-endian** index convention (variable 0 = least
significant bit; fix_variables pairs adjacent entries, dense.rs:171-199).

Device mapping:
* ``fix_variables``   — reshape-halving lerp per variable (a static chain;
  the reference's skip-if-delta-zero branch is semantically a no-op).
* ``evaluate``        — fix all variables.
* ``relabel``         — bit-window swap == axis transpose of the [2]*n view
  (dense.rs:137-153 / swap_bits in mle/mod.rs).
* trailing-zero truncation (truncate_lnze, OOB-zero Index) is a CPU memory
  optimization; tensors here are always full 2^n — observable semantics
  (values of all evaluations) are identical, which is what the reference's
  PartialEq compares after re-expansion.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["DenseMLE"]


class DenseMLE:
    def __init__(self, elems, num_vars: int, evals):
        self.e = elems
        self.num_vars = int(num_vars)
        assert evals.shape[0] == 1 << self.num_vars
        self.evals = evals

    # -- constructors (dense.rs:35-89,117-135) ---------------------------
    @classmethod
    def from_evaluations(cls, elems, num_vars, evals):
        return cls(elems, num_vars, evals)

    @classmethod
    def from_ints(cls, elems, num_vars, ints):
        arr = np.asarray(ints, dtype=object)
        n = 1 << num_vars
        if arr.shape[0] < n:
            pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], dtype=object)
            arr = np.concatenate([arr, pad], axis=0)
        return cls(elems, num_vars, jnp.asarray(elems.encode(arr)))

    @classmethod
    def from_evaluations_padded(cls, elems, num_vars, evals):
        """from_evaluations_vec_padded (dense.rs:79-89): resize to exactly
        2^num_vars evaluations — zero-pad a short input, truncate a long
        one (``Vec::resize`` semantics)."""
        n = 1 << num_vars
        if evals.shape[0] > n:
            evals = evals[:n]
        elif evals.shape[0] < n:
            pad = elems.zeros((n - evals.shape[0],))
            evals = jnp.concatenate([evals, pad], axis=0)
        return cls(elems, num_vars, evals)

    @classmethod
    def rand(cls, elems, num_vars, rng):
        return cls(elems, num_vars, elems.rand((1 << num_vars,), rng))

    @classmethod
    def from_matrix(cls, elems, sparse_mat):
        """MLE of a SparseMatrix, row-major with power-of-two padding
        (dense.rs:117-135): index = padded_cols*row + col, n_vars = s+s'."""
        pr = 1 << max(int(np.ceil(np.log2(max(sparse_mat.nrows, 1)))), 0)
        pc = 1 << max(int(np.ceil(np.log2(max(sparse_mat.ncols, 1)))), 0)
        pr = max(pr, 1)
        pc = max(pc, 1)
        nv = int(np.log2(pr)) + int(np.log2(pc))
        f = elems.f
        ids = sparse_mat.rows.astype(jnp.int64) * pc + \
            sparse_mat.cols.astype(jnp.int64)
        v = f.segment_sum(sparse_mat.data, ids, pr * pc)
        return cls(elems, nv, v)

    # -- trait surface (mle/mod.rs:23-76) --------------------------------
    def to_evaluations(self):
        return self.evals

    def decode(self):
        return self.e.decode(self.evals)

    # -- point indexing (dense.rs:397-418 degenerate semantics) ----------
    def index(self, i: int):
        """``Index<usize>`` (dense.rs:397-407): an out-of-bounds read —
        which on the reference's lnze-truncated storage includes every
        truncated trailing-zero position AND any index beyond 2^num_vars
        — returns zero.  Storage here is always full 2^num_vars, so the
        truncated positions are real zeros and only the beyond-elen case
        needs the explicit zero element."""
        if 0 <= i < self.evals.shape[0]:
            return self.evals[i]
        return self.e.zeros(())

    def set_index(self, i: int, v):
        """``IndexMut<usize>`` (dense.rs:409-418), functional: a new MLE
        with evaluation ``i`` replaced.  The reference re-expands its
        truncated storage to elen first — a no-op on full storage — and
        panics for i >= elen, mirrored by the assert."""
        assert 0 <= i < (1 << self.num_vars), "index beyond elen"
        evals = jnp.asarray(self.evals)     # constructors may hold numpy
        return DenseMLE(self.e, self.num_vars, evals.at[i].set(v))

    def fix_variables(self, points):
        """Bind the first len(points) variables (dense.rs:171-199).

        points: sequence of elements (each shape elem_shape)."""
        e = self.e
        ev = self.evals
        nv = self.num_vars
        for r in points:
            half = ev.shape[0] // 2
            ev2 = ev.reshape((half, 2) + ev.shape[1:])
            left = ev2[:, 0]
            right = ev2[:, 1]
            ev = e.add(left, e.mul(r, e.sub(right, left)))
            nv -= 1
        return DenseMLE(e, nv, ev)

    def evaluate(self, points):
        assert len(points) == self.num_vars
        return self.fix_variables(points).evals[0]

    def fix_last_variables(self, points):
        """Bind the LAST len(points) variables
        (multilinear_polynomial.rs:227-286): pairs at stride 2^(nv-1)."""
        e = self.e
        ev = self.evals
        nv = self.num_vars
        for r in reversed(list(points)):
            half = ev.shape[0] // 2
            left = ev[:half]
            right = ev[half:]
            ev = e.add(left, e.mul(r, e.sub(right, left)))
            nv -= 1
        return DenseMLE(e, nv, ev)

    def relabel(self, a: int, b: int, k: int):
        """Swap variable windows [a,a+k) and [b,b+k) (dense.rs:137-153)."""
        if a > b:
            a, b = b, a
        if a == b or k == 0:
            return self
        assert b + k <= self.num_vars, "invalid relabel argument"
        assert a + k <= b, "overlapped swap window is not allowed"
        nv = self.num_vars
        ev = self.evals
        elem_nd = ev.ndim - 1
        # view as [2]*nv (axis j = bit nv-1-j, C order) + elem axes
        view = ev.reshape((2,) * nv + ev.shape[1:])
        perm = list(range(nv + elem_nd))
        for t in range(k):
            ax_a = nv - 1 - (a + t)
            ax_b = nv - 1 - (b + t)
            perm[ax_a], perm[ax_b] = perm[ax_b], perm[ax_a]
        view = jnp.transpose(view, perm)
        return DenseMLE(self.e, nv, view.reshape(ev.shape))

    # -- arithmetic (dense.rs:227-395) -----------------------------------
    def add(self, other):
        assert self.num_vars == other.num_vars
        return DenseMLE(self.e, self.num_vars,
                        self.e.add(self.evals, other.evals))

    def sub(self, other):
        assert self.num_vars == other.num_vars
        return DenseMLE(self.e, self.num_vars,
                        self.e.sub(self.evals, other.evals))

    def neg(self):
        return DenseMLE(self.e, self.num_vars, self.e.neg(self.evals))

    def scalar_mul(self, r):
        return DenseMLE(self.e, self.num_vars, self.e.mul(self.evals, r))

    def scalar_add(self, r):
        return DenseMLE(self.e, self.num_vars, self.e.add(self.evals, r))

    def axpy(self, r, other):
        """self + r*other (AddAssign<(R, &Self)>, dense.rs:288-317)."""
        assert self.num_vars == other.num_vars
        return DenseMLE(self.e, self.num_vars,
                        self.e.add(self.evals, self.e.mul(r, other.evals)))
