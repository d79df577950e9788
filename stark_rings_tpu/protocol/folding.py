"""One LatticeFold-style folding step as a single jitted module.

Composes, in the batch-trailing layout (ops/model_mul.TModelMul) and
WITHOUT leaving the trace:

    1. challenge fold      s = s0 + r*s1,  c = c0 + r*c1
                           (slot-wise; r's NTT form precomputed once —
                           the mul_cached challenge pattern)
    2. ICRT                folded witness back to coefficient form
    3. gadget decompose    [W, L] elements -> [W, L*k] short digits
                           (balanced_decomposition/mod.rs:163-175)
    4. norm check          traced exact L2 of the digit tensor per
                           witness (decomp.norms.l2_check) — no host
                           round trip
    5. CRT                 digits to NTT form
    6. Ajtai commit        cd = A_g @ digits over the ring
                           (matrix.rs:148-188 / sparse commitment shape)
    7. (optional) psi range check per digit coefficient
                           (monomial.rs:82-93) — complete for
                           power-of-two cyclotomics; a precomputed
                           ct-table lookup per element
                           (rings/monomial._ct_psi_table)

The composed module is the protocol-rate frontier: stage dispatch fusion
is free throughput that per-stage benchmarks leave on the table
(benchmarks/bench_protocol.py measures both)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..decomp import decompose, decomposition_max_length
from ..decomp.norms import l2_check
from ..ops.model_mul import TModelMul

__all__ = ["FoldingStep", "ntt_matvec"]


def ntt_matvec(f, tm, E, At, xt, block: int | None = None):
    """c[i] = sum_j A[i, j] * x[j] over NTT-form ring elements in the
    transposed layout: ``At [D, n, m]``, ``xt [D, W, m]`` -> [D, W, n]
    (matrix.rs:148-188 semantics; limb axis trails when f.limbed).

    ``block``: M-blocked widened-word accumulation (Matrix.mul_mat
    pattern) bounding the live product tensor; bit-equal to the
    unblocked contraction."""
    m = At.shape[2]
    if E > 1:
        return tm.matvec_t(
            At, xt, block=None if (block is None or block >= m) else block)
    # slot field == base field: slotwise mul is a field mul
    if block is None or block >= m:
        prod = f.mul(At[:, None], xt[:, :, None])
        return f.sum(prod, axis=3)
    acc = None
    for s in range(0, m, block):
        prod = f.mul(At[:, None, :, s:s + block],
                     xt[:, :, None, s:s + block])
        w = jnp.sum(f.widen(prod), axis=3)
        acc = w if acc is None else acc + w
    return f.reduce_words(acc)


class FoldingStep:
    """Composed folding step over a reference model ring.

    Parameters
    ----------
    ring : RingModel
    n_rows : commitment rows (Ajtai security parameter)
    wit_len : witness length L (ring elements per witness)
    base, k : gadget decomposition basis / digit count
               (k defaults to decomposition_max_length(q, base))
    l2_bound_sq : witness-norm bound beta^2 for the traced check;
               defaults to the gadget guarantee L*k*D*(base/2)^2
               (digits are balanced, so |d| <= base/2 always holds —
               the default makes the check a live computation that
               passes; a protocol passes its real beta^2)
    psi_check : include the per-coefficient monomial range check
    """

    def __init__(self, ring, n_rows: int, wit_len: int, base: int = 256,
                 k: int | None = None, l2_bound_sq: int | None = None,
                 psi_check: bool = False):
        self.ring = ring
        self.f = ring.field
        self.tm = TModelMul(ring)
        self.n = int(n_rows)
        self.L = int(wit_len)
        self.base = int(base)
        kmax = decomposition_max_length(ring.q, base)
        if k is None:
            k = kmax
        # the step decomposes a FOLDED witness — full field range — so a
        # k below the field's max digit count silently truncates high
        # digits and commits to wrong values (the fixed-k device
        # decompose discards the residual quotient)
        assert k >= kmax, (
            f"k={k} < decomposition_max_length(q, {base})={kmax} would"
            " silently truncate the folded witness's digits")
        self.k = int(k)
        self.M = self.L * self.k
        if l2_bound_sq is None:
            l2_bound_sq = self.M * ring.D * (base // 2) ** 2
        self.l2_bound_sq = int(l2_bound_sq)
        self.psi_check = bool(psi_check)

    # -- host-side setup --------------------------------------------------
    def init_tables(self, rng):
        """Random Ajtai matrix A_g [n, M] of NTT-form ring elements, in
        the transposed layout [D, n, M] — device_put the result once."""
        A = np.asarray(self.ring.rand_ntt((self.n, self.M), rng))
        return {"Agt": np.moveaxis(A, -2 if self.f.limbed else -1, 0),
                "tm": self.tm.consts()}

    def precompute_challenge(self, r):
        """NTT form of the folding challenge (storage [D(,L)] coeff
        form in, transposed NTT [D, 1, 1(, L)] out) — computed once per
        challenge, broadcast over the witness batch in every step."""
        rt = self.tm.to_t(jnp.asarray(r))
        ntt = self.tm.crt_t(rt[:, None])
        return ntt[:, :, None] if not self.f.limbed else ntt[:, :, None, :]

    def rand_witness(self, W: int, rng):
        """NTT-form witness batch [D, W, L(, limbs)] (transposed)."""
        return self.tm.to_t(jnp.asarray(
            np.asarray(self.ring.rand_ntt((W, self.L), rng))))

    #: storage words of the [D, W, n, M] slot-product tensor tolerated
    #: before the commit switches to M-blocked widened accumulation
    #: (256 MB of u64) — the same budget Matrix.mul_mat uses.  Today's
    #: bench shapes (n=8, M=8192, W<=16: 201 MB at W=16) stay
    #: single-block; larger n*M*W commitments block instead of
    #: materializing the full product
    _COMMIT_BUDGET_WORDS = 1 << 25

    def commit(self, c, dt, block: int | None = None):
        """cd = A_g @ digits (NTT form, transposed): [D, W, M] -> [D, W, n].

        Peak memory is bounded: when the [D, W, n, M] slot-product
        tensor would exceed ``_COMMIT_BUDGET_WORDS`` storage words, the
        contraction runs M-blocked with exact widened-word accumulation
        (bit-equal, tested with a forced tiny block)."""
        Agt = jnp.asarray(c["Agt"])
        f = self.f
        D, W = dt.shape[0], dt.shape[1]
        if block is None:
            # one storage word per slot product in the unblocked path
            per = max(1, D * W * self.n)
            block = max(1, self._COMMIT_BUDGET_WORDS // per)
        return ntt_matvec(f, self.tm, self.ring.E, Agt, dt, block)

    # -- the composed step (call under jit) -------------------------------
    def step(self, c, s0t, s1t, c0t, c1t, rt):
        """One folding step; every stage stays inside the calling trace.

        Inputs (transposed layout): witnesses s0t/s1t [D, W, L(,l)],
        commitments c0t/c1t [D, W, n(,l)], challenge rt from
        :meth:`precompute_challenge`.  Returns a dict with the folded
        witness/commitment, the digit tensor and its commitment, and the
        traced check bits."""
        f, tm = self.f, self.tm
        tmc = c.get("tm")
        st = f.add(s0t, tm.ntt_mul_bt(s1t, rt))
        ct = f.add(c0t, tm.ntt_mul_bt(c1t, rt))
        coeff = tm.icrt_t(st, tmc)                       # [D, W, L(,l)]
        dig = decompose(f, coeff, self.base, self.k)
        # digit j of column l -> gadget column l*k + j (mod.rs:163-175)
        if f.limbed:
            D, W = dig.shape[0], dig.shape[1]
            dt = dig.reshape(D, W, self.M, dig.shape[-1])
        else:
            dt = dig.reshape(dig.shape[0], dig.shape[1], self.M)
        ok_l2 = l2_check(f, dt, self.l2_bound_sq, axis=(0, 2))   # [W]
        d_ntt = tm.crt_t(dt, tmc)
        cd = self.commit(c, d_ntt)
        out = {"s": st, "c": ct, "digits": dt, "cd": cd, "ok_l2": ok_l2}
        if self.psi_check:
            from ..rings.monomial import psi_range_check_batched

            # per-coefficient check over the digit tensor (elementwise in
            # any layout); all-reduce per witness along (D, M)
            okp = psi_range_check_batched(self.ring, dt)
            out["ok_psi"] = jnp.all(okp, axis=(0, 2))
        return out

    # -- multi-chip -------------------------------------------------------
    def make_sharded_step_fn(self, mesh: Mesh, axis: str = "x"):
        """Witness-batch-sharded composed step over the mesh.

        Every stage is elementwise over the W axis or a per-witness
        reduction (L2 / psi reduce along (D, M) only), so the shard_map
        needs ZERO collectives — the rayon-over-witnesses analog
        (SURVEY §2.5), scaled across chips.  Tables replicate; witnesses
        and all per-witness outputs shard on ``axis``."""
        lt = (None,) if self.f.limbed else ()
        wspec = P(None, axis, None, *lt)       # [D, W, L/M/n(, l)]
        rspec = P(None, None, None, *lt)       # replicated challenge
        out_specs = {"s": wspec, "c": wspec, "digits": wspec,
                     "cd": wspec, "ok_l2": P(axis)}
        if self.psi_check:
            out_specs["ok_psi"] = P(axis)
        return jax.jit(jax.shard_map(
            self.step, mesh=mesh,
            in_specs=(P(), wspec, wspec, wspec, wspec, rspec),
            out_specs=out_specs))
