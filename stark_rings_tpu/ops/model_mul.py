"""Batch-trailing ("transposed") model-CRT multiply.

The default RingModel layout is batch-leading: an element vector is
``[B, D(, L)]``, so every elementwise field op on the NTT form runs with
the tiny D / E / limb axis minor-most, a poor layout for vectorized
elementwise code.  The prescaled digit-plane cores (ops/mxu_dense.py)
are already batch-trailing
internally (``[C, B]`` in, ``[R, B]`` out); the per-call wrappers
transpose to batch-leading and back, and the slot-wise extension
multiply (ring.ntt_mul) then runs lane-starved between them.

:class:`TModelMul` keeps the whole multiply in the ``[D, B(, L)]``
layout: the CRT/ICRT matmuls feed the slot product directly and every
elementwise op has the batch axis minor-most (full lanes).  A chain of
multiplies (the folding-prover shape) pays the two layout transposes
once at entry/exit instead of six per step.

Semantics are identical to
``ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))`` — the reference
pipeline crt -> slotwise ext mul -> icrt
(/root/reference/crates/ring/src/cyclotomic_ring/crt.rs:52-77,
ntt_form.rs:159-189) — and are tested element-exact against it.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["TModelMul"]

_D_BITS = 7


def _unwrap(core):
    """ops/mxu_dense.py wraps some cores in _Wrap2D for the batch-leading
    interface; the batch-trailing path wants the raw core."""
    return getattr(core, "core", core)


class TModelMul:
    """Fused model multiply in the batch-trailing layout.

    ``to_t(x)``: storage ``[B, D(, L)]`` -> ``[D, B(, L)]``; ``mul_t``
    maps two transposed coefficient-form operands to their transposed
    coefficient-form product.  All four reference models supported.
    """

    def __init__(self, ring):
        self.ring = ring
        self.f = ring.field
        crt, icrt = ring._dense_crt
        self._crt = _unwrap(crt)
        self._icrt = _unwrap(icrt)
        if ring.E > 1:
            assert not self.f.limbed, "no limbed extension models exist"
            perm, inv_perm, idx, fac = ring._ext_tables
            self._perm = np.asarray(perm)
            self._inv_perm = np.asarray(inv_perm)
            self._idx_flat = np.asarray(idx).reshape(-1)
            # fac: [E, E] storage constants -> broadcast over (N, B)
            self._fac = jnp.asarray(fac)[None, :, :, None]

    # -- layout ----------------------------------------------------------
    def to_t(self, x):
        """[*batch, D(, L)] -> [D, *batch(, L)] (batch shape preserved)."""
        src = -2 if self.f.limbed else -1
        return jnp.moveaxis(x, src, 0)

    def from_t(self, xt):
        """[D, *batch(, L)] -> [*batch, D(, L)]."""
        dst = -2 if self.f.limbed else -1
        return jnp.moveaxis(xt, 0, dst)

    # -- stages ----------------------------------------------------------
    def _limb_planes(self, core, xt):
        """storage u32 [C, B, L] -> int8/uint8 [P*C, B] digit planes."""
        outs = []
        if getattr(core, "unsigned", False):
            # limb-aligned unsigned 8-bit digits (mxu_limb u8 scheme)
            for l in range(core.P):
                j, off = l >> 2, (l & 3) * 8
                lo = xt[..., j] >> np.uint32(off)
                outs.append((lo & np.uint32(0xFF)).astype(jnp.uint8))
            return jnp.stack(outs, axis=0).reshape(core.P * core.C, -1)
        for l in range(core.P):
            pos = _D_BITS * l
            j, off = pos >> 5, pos & 31
            lo = xt[..., j] >> np.uint32(off)
            if off > 32 - _D_BITS and j + 1 < core.L:
                lo = lo | (xt[..., j + 1] << np.uint32(32 - off))
            outs.append((lo & np.uint32(0x7F)).astype(jnp.int8))
        return jnp.stack(outs, axis=0).reshape(core.P * core.C, -1)

    def consts(self):
        """The digit-plane weight tables as a pytree, to pass as jit
        ARGUMENTS (device_put once per closure) rather than HLO
        constants."""
        return {"crt": np.asarray(self._crt.big),
                "icrt": np.asarray(self._icrt.big)}

    def _apply_t(self, core, xt, big=None):
        """core @ xt in the batch-trailing layout, canonical/storage out.

        All prescaled cores compute on [C, B]-major data internally; this
        skips their batch-leading wrapper transposes entirely.  Batch
        axes beyond the first are flattened for the dot and restored."""
        w = jnp.asarray(core.big) if big is None else big
        if self.f.limbed:
            bshape = xt.shape[1:-1]
            x2 = xt.reshape((core.C, -1) + self.f.limb_shape)
            V = jax.lax.dot(w, self._limb_planes(core, x2),
                            preferred_element_type=jnp.int32)
            y = core.fold(V)                       # [R, B, L]
            return y.reshape((core.R,) + bshape + self.f.limb_shape)
        bshape = xt.shape[1:]
        V = jax.lax.dot(w, core.planes(xt.reshape(core.C, -1)),
                        preferred_element_type=jnp.int32)
        return core.fold(V).reshape((core.R,) + bshape)

    def crt_t(self, xt, c=None):
        """coeff [D, B(, L)] -> NTT form [D, B(, L)]."""
        return self._apply_t(self._crt, xt,
                             None if c is None else c["crt"])

    def icrt_t(self, yt, c=None):
        return self._apply_t(self._icrt, yt,
                             None if c is None else c["icrt"])

    def ntt_mul_t(self, at, bt):
        """Slot-wise extension multiply, batch minor-most.

        Same math as RingModel.ntt_mul (ntt_form.rs:159-189), with every
        elementwise op shaped [N, E(, E), B] so the batch axis is minor-most.
        Operands are ``[D, *batch]`` with equal batch shapes (broadcast
        on the caller side).
        """
        f, ring = self.f, self.ring
        N, E = ring.N, ring.E
        if E == 1:
            return f.mul(at, bt)
        bshape = at.shape[1:]
        a = at.reshape(N, E, -1)
        b = bt.reshape(N, E, -1)
        B = a.shape[-1]
        a_deg = jnp.take(a, self._perm, axis=1)
        b_deg = jnp.take(b, self._perm, axis=1)
        # bg[n, i, k, :] = b_deg[n, (k-i) % E, :]
        bg = jnp.take(b_deg, self._idx_flat, axis=1).reshape(N, E, E, B)
        scaled = f.mul(self._fac, bg)
        prod = f.mul(a_deg[:, :, None, :], scaled)
        c_deg = f.sum(prod, axis=1)                # sum over i
        c = jnp.take(c_deg, self._inv_perm, axis=1)
        return c.reshape((N * E,) + bshape)

    def ntt_mul_bt(self, at, bt):
        """ntt_mul_t with BROADCASTABLE batch shapes, no flattening.

        ``at [D, *ba]``, ``bt [D, *bb]`` with ba/bb broadcast-compatible
        (right-aligned); returns ``[D, *broadcast(ba, bb)]``.  Nothing is
        materialized before the elementwise product, so XLA can fuse the
        broadcasts into the consuming ops (an explicit broadcast_to +
        reshape forces a copy)."""
        f, ring = self.f, self.ring
        N, E = ring.N, ring.E
        if E == 1:
            return f.mul(at, bt)
        a = at.reshape((N, E) + at.shape[1:])
        b = bt.reshape((N, E) + bt.shape[1:])
        a_deg = jnp.take(a, self._perm, axis=1)
        b_deg = jnp.take(b, self._perm, axis=1)
        bg = jnp.take(b_deg, self._idx_flat,
                      axis=1).reshape((N, E, E) + b.shape[2:])
        fac = self._fac.reshape((1, E, E) + (1,) * len(b.shape[2:]))
        scaled = f.mul(fac, bg)
        prod = f.mul(a_deg[:, :, None], scaled)
        c_deg = f.sum(prod, axis=1)                # sum over i
        c = jnp.take(c_deg, self._inv_perm, axis=1)
        return c.reshape((N * E,) + c.shape[2:])

    def matvec_t(self, At, xt, block: int | None = None):
        """NTT-form mat-vec in the transposed layout.

        ``At [D, n, m]`` (matrix of NTT-form ring elements), ``xt
        [D, m]`` or ``[D, W, m]`` (batched vectors) -> ``[D, n]`` /
        ``[D, W, n]``: c[i] = sum_j A[i, j] * x[j]
        (the reference's checked_mul_vec over RqNTT, matrix.rs:148-188).
        The contraction axis is placed MAJOR (cross-lane reductions
        lose ~3x) and the broadcasts stay lazy inside ntt_mul_bt.

        ``block``: contraction-blocked exact accumulation (the
        Matrix.mul_mat pattern) — only [D, block, W, n] of slot products
        is ever live; each block widens to base-2^32 words summed in
        uint64 (exact: words < 2^32, far fewer than 2^32 addends) with
        one fold mod q at the end.  Bounds peak memory for large n*m
        commitments; bit-equal to the unblocked path (tested)."""
        f = self.f
        assert not f.limbed, "use f.mul/f.sum directly for E == 1 limbed"
        D, n, m = At.shape
        Am = jnp.transpose(At, (0, 2, 1))            # [D, m, n]
        if xt.ndim == 2:
            res = self.matvec_t(At, xt[:, None], block=block)
            return res[:, 0]
        xm = xt.transpose(0, 2, 1)                   # [D, m, W]
        if block is None or block >= m:
            prod = self.ntt_mul_bt(Am[:, :, None, :],      # [D, m, 1, n]
                                   xm[:, :, :, None])      # [D, m, W, 1]
            return f.sum(prod, axis=1)               # [D, W, n]
        acc = None
        for s in range(0, m, block):
            prod = self.ntt_mul_bt(Am[:, s:s + block, None, :],
                                   xm[:, s:s + block, :, None])
            w = jnp.sum(f.widen(prod), axis=1)       # [D, W, n, words]
            acc = w if acc is None else acc + w
        return f.reduce_words(acc)

    def mul_t(self, at, bt, c=None):
        """Transposed coeff-form multiply: icrt(crt(a) *slot crt(b))."""
        return self.icrt_t(self.ntt_mul_t(self.crt_t(at, c),
                                          self.crt_t(bt, c)), c)

    def precompute_t(self, bt, c=None):
        """Cached-operand state for mul_cached_t: the NTT form of a
        fixed operand (gadget column / challenge), computed once.  Saves
        one of the multiply's two CRT dots per call."""
        return self.crt_t(bt, c)

    def mul_cached_t(self, at, fbt, c=None):
        """Fixed-operand transposed multiply; fbt broadcasts over at's
        batch (batch-1 challenge pattern, via ntt_mul_bt)."""
        return self.icrt_t(self.ntt_mul_bt(self.crt_t(at, c), fbt), c)

    def square_t(self, at, c=None):
        """a*a with ONE CRT dot."""
        fa = self.crt_t(at, c)
        return self.icrt_t(self.ntt_mul_t(fa, fa), c)

    # -- batch-leading convenience (pays both transposes) -----------------
    def mul(self, a, b, c=None):
        return self.from_t(self.mul_t(self.to_t(a), self.to_t(b), c))
