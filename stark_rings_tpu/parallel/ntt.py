"""Sharded four-step (Bailey) NTT: one all_to_all per transform.

Degree-N (nega)cyclic NTT decomposed as an N1 x N2 matrix
(n = n1*N2 + n2, row-major):

    1. (negacyclic only) twist      x *= psi^n                   local
    2. column NTTs of size N1       (cyclic, leaf order)         local
    3. twiddle  *= omega^(k1 * n2)                               local
    4. transpose [N1, N2/P] -> [N1/P, N2]    = ONE all_to_all    collective
    5. row NTTs of size N2          (cyclic, leaf order)         local

The inverse runs the mirror.  Output lives in a fixed product permutation
(col-leaf x row-leaf) — pointwise ring multiplication is exact in that
order, so no bit-reversal data movement ever happens on device.

This generalizes the reference's butterfly-stage dataflow
(goldilocks/ntt.rs:146-225), which the BASELINE asks to scale to degree
2^20 across devices: the all_to_all is an XLA collective under
``shard_map`` (NCCL between GPUs), everything else is device-local.

Shard layout: data is the [..., N1, N2] matrix view of the coefficient
vector, sharded over the LAST axis (columns, n2) on a 1-D mesh axis; after
``forward`` the result is sharded over the second-to-last axis instead
(rows = col-leaf indices).  ``mul`` composes forward/pointwise/inverse and
returns the original layout.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fields import get_field
from ..ops.ntt import NTTContext, find_primitive_root

__all__ = ["ShardedNTT"]


class ShardedNTT:
    def __init__(self, field_name: str, N: int, n_devices: int,
                 negacyclic: bool = True, axis: str = "x",
                 local: str = "vpu", single_chip: bool = False):
        f = get_field(field_name)
        assert N & (N - 1) == 0
        logN = N.bit_length() - 1
        N1 = 1 << (logN // 2)
        N2 = N // N1
        Pn = n_devices
        assert N1 % Pn == 0 and N2 % Pn == 0, \
            f"P={Pn} must divide N1={N1} and N2={N2}"
        assert (f.q - 1) % (2 * N) == 0
        self.f = f
        self.N, self.N1, self.N2, self.P = N, N1, N2, Pn
        self.axis = axis
        self.negacyclic = negacyclic
        self.col_ctx = NTTContext(f, N1, negacyclic=False)
        self.row_ctx = NTTContext(f, N2, negacyclic=False)
        g = find_primitive_root(f.q)
        self.psi_int = pow(g, (f.q - 1) // (2 * N), f.q)
        self.omega_int = pow(self.psi_int, 2, f.q)
        # col-leaf -> k1 (cyclic leaf exponents are even: k = e/2)
        self.k1_leaf = np.array([e // 2 for e in self.col_ctx.leaf_exps],
                                dtype=np.int64)
        self._consts = None
        # local transform engine: "vpu" = radix-4 butterflies (any
        # field); "mxu" = the flagship int8 digit-matmul construction
        # (ops/mxu2.PrescaledMat) for the local column/row NTTs, in the
        # SAME leaf order, so twiddles/exchange logic are untouched.
        # Goldilocks only (the prescaled weights encode its modulus).
        assert local in ("vpu", "mxu")
        self.local = local
        if local == "mxu":
            assert field_name == "goldilocks", \
                "mxu local transforms are goldilocks-only"
            self._mxu_mats = self._build_mxu_locals()
        # single_chip=True (P must be 1): the four-step runs OUTSIDE any
        # mesh — shard offsets are the constant 0 and the (identity)
        # P=1 exchange is skipped, so _local_forward/_local_inverse are
        # plain jittable functions (PowerRing.fourstep_ctx).
        self.single_chip = bool(single_chip)
        if single_chip:
            assert n_devices == 1, "single_chip needs P == 1"

    def consts(self):
        """Device constant tables (built eagerly, cached)."""
        if self._consts is None:
            with jax.ensure_compile_time_eval():
                f, N = self.f, self.N
                omega_pows = self._pow_table(self.omega_int, N)
                omega_inv_pows = self._pow_table(
                    pow(self.omega_int, f.q - 2, f.q), N)
                tw = itw = None
                if self.negacyclic:
                    psi_pows = self._pow_table(self.psi_int, 2 * N)
                    ipsi_pows = self._pow_table(
                        pow(self.psi_int, f.q - 2, f.q), 2 * N)
                    colt = f.take_coeff(psi_pows, np.arange(self.N1)
                                        * self.N2 % (2 * N))
                    rowt = f.take_coeff(psi_pows, np.arange(self.N2))
                    icolt = f.take_coeff(ipsi_pows, np.arange(self.N1)
                                         * self.N2 % (2 * N))
                    irowt = f.take_coeff(ipsi_pows, np.arange(self.N2))
                    tw = (jax.device_get(colt), jax.device_get(rowt))
                    itw = (jax.device_get(icolt), jax.device_get(irowt))
                self._consts = (jax.device_get(omega_pows),
                                jax.device_get(omega_inv_pows), tw, itw)
        return self._consts

    def _build_mxu_locals(self):
        """Leaf-order cyclic NTT constant matrices for both local sizes.

        W[i, n] = w^(leaf[i]*n), Wi[n, i] = w^(-leaf[i]*n)/size — exact
        drop-ins for NTTContext.forward/inverse on the chosen leaf
        order, lowered to the int8 digit-plane matmul.  Entries come
        from a length-n power table indexed mod n (w has order n) — the
        per-entry pow() loop took minutes at N1 = 1024."""
        from ..ops.mxu2 import PrescaledMat

        q = self.f.q
        mats = {}
        for name, ctx, n in (("col", self.col_ctx, self.N1),
                             ("row", self.row_ctx, self.N2)):
            w = pow(self.omega_int, self.N // n, q)
            wi = pow(w, q - 2, q)
            n_inv = pow(n, q - 2, q)
            leaf = np.array([e // 2 for e in ctx.leaf_exps])
            wpow = np.empty(n, dtype=object)
            wipow = np.empty(n, dtype=object)
            wpow[0] = wipow[0] = 1
            for j in range(1, n):
                wpow[j] = wpow[j - 1] * w % q
                wipow[j] = wipow[j - 1] * wi % q
            idx = leaf[:, None] * np.arange(n)[None, :] % n
            W = np.take(wpow, idx)
            Wi = np.take(wipow, idx).T * n_inv % q
            # device-resident weights, passed to the dot as arguments:
            # MB-scale numpy closures would become HLO literals
            fwd = PrescaledMat(W)
            inv = PrescaledMat(Wi)
            mats[name] = (fwd, jax.device_put(fwd.big),
                          inv, jax.device_put(inv.big))
        return mats

    def _mxu_apply(self, mat, big):
        """NTTContext.forward/inverse-compatible last-axis transform."""
        def fn(xm):
            n = xm.shape[-1]
            lead = xm.shape[:-1]
            y = mat.fold(mat.dot(xm.reshape(-1, n).T, big))
            return y.T.reshape(lead + (mat.R,))
        return fn

    def _local_fns(self):
        """(col_fwd, col_inv, row_fwd, row_inv) per the local engine."""
        if self.local == "mxu":
            cW, cWb, cWi, cWib = self._mxu_mats["col"]
            rW, rWb, rWi, rWib = self._mxu_mats["row"]
            return (self._mxu_apply(cW, cWb), self._mxu_apply(cWi, cWib),
                    self._mxu_apply(rW, rWb), self._mxu_apply(rWi, rWib))
        return (self.col_ctx.forward, self.col_ctx.inverse,
                self.row_ctx.forward, self.row_ctx.inverse)

    def _pow_table(self, base_int: int, n: int):
        f = self.f
        tab = jnp.stack([jnp.asarray(f.const(1)),
                         jnp.asarray(f.const(base_int))], axis=0)
        while tab.shape[0] < n:
            top = f.mul(tab, jnp.asarray(f.const(
                pow(base_int, tab.shape[0], f.q))))
            tab = jnp.concatenate([tab, top], axis=0)
        return tab[:n]

    # -- local helpers (run inside shard_map) -----------------------------
    def _col_ofs(self):
        if self.single_chip:
            return jnp.int64(0)
        C = self.N2 // self.P
        return jax.lax.axis_index(self.axis) * C

    def _apply_on_axis(self, ctx_fn, x, axis_from_end: int):
        """Apply an NTT over an inner axis by moving it last."""
        f = self.f
        nd = 1 if f.limbed else 0
        ax = x.ndim - axis_from_end - nd
        xm = jnp.moveaxis(x, ax, x.ndim - 1 - nd)
        ym = ctx_fn(xm)
        return jnp.moveaxis(ym, x.ndim - 1 - nd, ax)

    def _twiddle(self, rows_k1, cols_global_idx, omega_pows):
        """omega^(k1*n2) gathered from the power table."""
        idx = (rows_k1[:, None] * cols_global_idx[None, :]) % self.N
        return jnp.take(jnp.asarray(omega_pows), idx, axis=0)

    def _local_forward(self, x):
        """x: [..., N1, C(, L)] columns shard -> [..., N1/P, N2(, L)]."""
        f = self.f
        omega_pows, _, tw, _ = self.consts()
        nd = 1 if f.limbed else 0
        C = self.N2 // self.P
        ofs = self._col_ofs()
        cols = ofs + jnp.arange(C, dtype=jnp.int64)
        if self.negacyclic:
            colt, rowt = tw
            rslice = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(rowt), ofs, C, axis=0)
            colt = jnp.asarray(colt)
            tfac = f.mul(_expand_col(colt, nd), _expand_row(rslice, nd))
            x = f.mul(x, tfac)
        # column NTT over axis N1 (second from elem end)
        x = self._apply_on_axis(self._local_fns()[0], x, 2)
        # twiddle omega^(k1_leaf * n2)
        T = self._twiddle(jnp.asarray(self.k1_leaf), cols, omega_pows)
        x = f.mul(x, T)
        if not self.single_chip:   # the P=1 exchange is the identity
            # transpose via all_to_all: [.., N1, C] -> [.., N1/P, N2]
            nd_axis = x.ndim - 2 - nd
            x = jax.lax.all_to_all(x, self.axis, split_axis=nd_axis,
                                   concat_axis=nd_axis + 1, tiled=True)
        # row NTT over the last (N2) axis
        x = self._apply_on_axis(self._local_fns()[2], x, 1)
        return x

    # -- overlapped (software-pipelined) variant ---------------------------
    # The four-step transform's one all_to_all can hide behind compute by
    # splitting the BATCH: while chunk i's transpose is in flight, chunk
    # i+1 runs its column stage (XLA's async collectives + latency-hiding
    # scheduler overlap the transfer).  Semantically identical to
    # _local_forward — validated on the CPU mesh; the overlap itself only
    # materializes on a real interconnect.
    def _pre_transpose(self, x):
        """twist + column NTT + twiddle (everything before the exchange)."""
        f = self.f
        omega_pows, _, tw, _ = self.consts()
        nd = 1 if f.limbed else 0
        C = self.N2 // self.P
        ofs = self._col_ofs()
        cols = ofs + jnp.arange(C, dtype=jnp.int64)
        if self.negacyclic:
            colt, rowt = tw
            rslice = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(rowt), ofs, C, axis=0)
            tfac = f.mul(_expand_col(jnp.asarray(colt), nd),
                         _expand_row(rslice, nd))
            x = f.mul(x, tfac)
        x = self._apply_on_axis(self._local_fns()[0], x, 2)
        T = self._twiddle(jnp.asarray(self.k1_leaf), cols, omega_pows)
        return f.mul(x, T)

    def _exchange_and_rows(self, y):
        nd = 1 if self.f.limbed else 0
        nd_axis = y.ndim - 2 - nd
        y = jax.lax.all_to_all(y, self.axis, split_axis=nd_axis,
                               concat_axis=nd_axis + 1, tiled=True)
        return self._apply_on_axis(self._local_fns()[2], y, 1)

    def _local_forward_overlap(self, x, chunks: int = 2):
        """Batch-pipelined forward: needs a leading batch axis whose size
        is divisible by ``chunks``."""
        nd = 1 if self.f.limbed else 0
        assert x.ndim >= 3 + nd and x.shape[0] % chunks == 0, \
            "overlap variant needs a leading batch axis divisible by chunks"
        parts = jnp.split(x, chunks, axis=0)
        pre = [self._pre_transpose(parts[0])]
        out = []
        for i in range(chunks):
            if i + 1 < chunks:
                # issue chunk i's exchange, then (overlapping) compute
                # chunk i+1's column stage
                pre.append(self._pre_transpose(parts[i + 1]))
            out.append(self._exchange_and_rows(pre[i]))
        return jnp.concatenate(out, axis=0)

    def _local_inverse(self, y):
        """[..., N1/P, N2(, L)] -> [..., N1, C(, L)]."""
        f = self.f
        _, omega_inv_pows, _, itw = self.consts()
        nd = 1 if f.limbed else 0
        C = self.N2 // self.P
        R = self.N1 // self.P
        y = self._apply_on_axis(self._local_fns()[3], y, 1)
        # inverse twiddle for the LOCAL row block of k1 leaves
        row_ofs = jnp.int64(0) if self.single_chip \
            else jax.lax.axis_index(self.axis) * R
        k1_local = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self.k1_leaf), row_ofs, R, axis=0)
        cols_all = jnp.arange(self.N2, dtype=jnp.int64)
        Ti = self._twiddle(k1_local, cols_all, omega_inv_pows)
        y = f.mul(y, Ti)
        if not self.single_chip:   # the P=1 exchange is the identity
            # transpose back: [.., N1/P, N2] -> [.., N1, C]
            nd_axis = y.ndim - 2 - nd
            y = jax.lax.all_to_all(y, self.axis, split_axis=nd_axis + 1,
                                   concat_axis=nd_axis, tiled=True)
        y = self._apply_on_axis(self._local_fns()[1], y, 2)
        if self.negacyclic:
            icolt, irowt = itw
            ofs = self._col_ofs()
            rslice = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(irowt), ofs, C, axis=0)
            tfac = f.mul(_expand_col(jnp.asarray(icolt), nd),
                         _expand_row(rslice, nd))
            y = f.mul(y, tfac)
        return y

    # -- public jitted entry points ---------------------------------------
    def shard_specs(self, batch_ndim: int = 0):
        """(coeff_spec, eval_spec): PartitionSpecs for the matrix layout."""
        nd = 1 if self.f.limbed else 0
        lead = (None,) * batch_ndim
        tail = (None,) * nd
        return (P(*lead, None, self.axis, *tail),
                P(*lead, self.axis, None, *tail))

    def make_fns(self, mesh: Mesh, batch_ndim: int = 0,
                 overlap: bool | None = None):
        """Returns (forward, inverse, mul) jitted over the mesh.

        forward: [..., N1, N2] col-sharded -> [..., N1, N2] row-sharded
        (leaf-order evaluations); mul keeps the coefficient layout.
        ``overlap``: True = batch-pipelined forward (requires a leading
        batch axis, batch_ndim >= 1); None (default) = AUTO — pipeline
        whenever the input has a leading batch axis with even size, fall
        back to the plain forward otherwise.  The two are semantically
        identical (test_sharded_forward_overlap_matches), so auto never
        changes results."""
        self.consts()
        cspec, espec = self.shard_specs(batch_ndim)
        nd = 1 if self.f.limbed else 0
        if overlap:
            assert batch_ndim >= 1, "overlap needs a batch axis"
            local_forward = self._local_forward_overlap
        elif overlap is None and batch_ndim >= 1:
            # auto: per-shape choice at trace time (shapes are static)
            def local_forward(x):
                if x.ndim >= 3 + nd and x.shape[0] % 2 == 0:
                    return self._local_forward_overlap(x)
                return self._local_forward(x)
        else:
            local_forward = self._local_forward
        smap = partial(jax.shard_map, mesh=mesh)

        fwd = jax.jit(smap(local_forward, in_specs=(cspec,),
                           out_specs=espec))
        inv = jax.jit(smap(self._local_inverse, in_specs=(espec,),
                           out_specs=cspec))

        def local_mul(a, b):
            fa = local_forward(a)
            fb = local_forward(b)
            return self._local_inverse(self.f.mul(fa, fb))

        mul = jax.jit(smap(local_mul, in_specs=(cspec, cspec),
                           out_specs=cspec))
        return fwd, inv, mul

    def make_cached_fns(self, mesh: Mesh, batch_ndim: int = 0):
        """(precompute, mul_cached, square) jitted over the mesh.

        The fixed-operand pattern on the mesh pays off twice: a cached
        operand skips its forward transform AND that transform's
        all_to_all exchange — per multiply only the live operand's
        exchange and the inverse's remain (2 collectives instead of 3).
        ``precompute`` is the forward transform (output row-sharded
        evaluations, shard_specs' espec); a batch-1 cached operand
        broadcasts over the live batch inside the slot product."""
        self.consts()
        cspec, espec = self.shard_specs(batch_ndim)
        smap = partial(jax.shard_map, mesh=mesh)

        pre = jax.jit(smap(self._local_forward, in_specs=(cspec,),
                           out_specs=espec))

        def local_mul_cached(a, fb):
            fa = self._local_forward(a)
            return self._local_inverse(self.f.mul(fa, fb))

        mul_cached = jax.jit(smap(local_mul_cached,
                                  in_specs=(cspec, espec),
                                  out_specs=cspec))

        def local_square(a):
            fa = self._local_forward(a)
            return self._local_inverse(self.f.mul(fa, fa))

        square = jax.jit(smap(local_square, in_specs=(cspec,),
                              out_specs=cspec))
        return pre, mul_cached, square

    def make_phase_fns(self, mesh: Mesh, batch_ndim: int = 0):
        """Per-phase jitted functions for scaling diagnosis.

        Returns a dict of separately-jitted shard_map programs covering
        the forward transform's three phases:
          "pre"      — twist + column NTT + twiddle   (local compute)
          "exchange" — the transpose all_to_all        (collective)
          "rows"     — row NTT                         (local compute)
        plus "forward" (all three fused, the production path).  Input and
        intermediate shardings match the production dataflow, so the sum
        of the phase times ~ the fused time up to fusion savings; the
        exchange phase isolates collective cost at each device count.
        """
        self.consts()
        cspec, espec = self.shard_specs(batch_ndim)
        nd = 1 if self.f.limbed else 0
        # the pre-phase output keeps the column sharding
        pre = jax.jit(jax.shard_map(self._pre_transpose, mesh=mesh,
                                    in_specs=(cspec,), out_specs=cspec))

        def exch(y):
            nd_axis = y.ndim - 2 - nd
            return jax.lax.all_to_all(y, self.axis, split_axis=nd_axis,
                                      concat_axis=nd_axis + 1, tiled=True)

        exchange = jax.jit(jax.shard_map(exch, mesh=mesh, in_specs=(cspec,),
                                         out_specs=espec))
        rows = jax.jit(jax.shard_map(
            lambda y: self._apply_on_axis(self._local_fns()[2], y, 1),
            mesh=mesh, in_specs=(espec,), out_specs=espec))
        forward = jax.jit(jax.shard_map(self._local_forward, mesh=mesh,
                                        in_specs=(cspec,), out_specs=espec))
        return {"pre": pre, "exchange": exchange, "rows": rows,
                "forward": forward}

    # -- host-side helpers -------------------------------------------------
    def make_single_chip_fns(self):
        """(forward, inverse, mul) as plain jittable functions — the
        four-step transform on ONE chip (requires single_chip=True).
        Operands in matrix layout [..., N1, N2] (see to_matrix); mul is
        bit-exact vs NTTContext / the host oracle (tested)."""
        assert self.single_chip, "construct with single_chip=True"
        f = self.f

        def mul(a, b):
            return self._local_inverse(
                f.mul(self._local_forward(a), self._local_forward(b)))

        return self._local_forward, self._local_inverse, mul

    def to_matrix(self, coeffs):
        """[..., N(, L)] -> [..., N1, N2(, L)] (row-major n = n1*N2+n2)."""
        nd = 1 if self.f.limbed else 0
        s = coeffs.shape
        return coeffs.reshape(s[: len(s) - 1 - nd] + (self.N1, self.N2)
                              + self.f.limb_shape)

    def from_matrix(self, m):
        nd = 1 if self.f.limbed else 0
        s = m.shape
        return m.reshape(s[: len(s) - 2 - nd] + (self.N,)
                         + self.f.limb_shape)


def _expand_col(colt, nd):
    """[N1(,L)] -> [N1, 1(,L)] for broadcasting over columns."""
    return colt[:, None, :] if nd else colt[:, None]


def _expand_row(rowt, nd):
    """[C(,L)] -> [C(,L)] (broadcasts over rows naturally)."""
    return rowt
