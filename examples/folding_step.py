#!/usr/bin/env python
"""End-to-end demo: one LatticeFold-style folding step with a
Fiat-Shamir transcript — the protocol shape the reference's algebra
serves, driven entirely through this framework's surface.

    1. Two Ajtai commitments  c_i = A s_i  over the Goldilocks ring,
       witnesses gadget-decomposed short.
    2. Every witness coefficient is range-checked ON DEVICE in one
       batched call (monomial psi machinery, monomial.rs:82-93).
    3. A SHAKE-256 transcript absorbs the commitments (canonical
       base-field bytes, the OverField Absorb bound) and squeezes the
       folding challenge r.
    4. Fold: s = s_0 + r s_1, c = c_0 + r c_1; verify c == A s by ring
       linearity (the homomorphism folding relies on).

Run:  python examples/folding_step.py
"""

import os
import random
import sys

import numpy as np

import jax

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])

sys.path.insert(0, ".")

from stark_rings_tpu.decomp import gadget_decompose  # noqa: E402
from stark_rings_tpu.linalg import Matrix, RingElems  # noqa: E402
from stark_rings_tpu.rings import get_ring  # noqa: E402
from stark_rings_tpu.rings.absorb import Transcript  # noqa: E402
from stark_rings_tpu.rings.monomial import (  # noqa: E402
    psi_range_check_batched,
)
from stark_rings_tpu.rings.sampling import sample_short  # noqa: E402


def main():
    # frog: power-of-two cyclotomic (X^16 + 1), so the psi range check
    # has its (-d', d') completeness property (monomial.rs:120-134)
    ring = get_ring("frog")
    f = ring.field
    e = RingElems(ring)
    rng = random.Random(7)
    n, m, base, k = 2, 3, 4, 16

    A = Matrix(e, np.asarray(ring.rand_ntt((n, m * k), rng)))

    def commit(s_short_ntt):
        return A.mul_vec(s_short_ntt)

    tr = Transcript(b"folding-demo")
    commits = []
    witnesses = []
    for i in range(2):
        s = sample_short(ring, (m,), rng, bound=1)       # coeff form
        # range-check every coefficient of the gadget digits on device:
        # short witnesses have all digits in (-d', d')
        digits = gadget_decompose(f, s, base, k)         # [m*k, D]
        checks = psi_range_check_batched(ring, digits)
        assert bool(np.asarray(checks).all()), "witness out of range"
        s_ntt = ring.crt(digits)
        c = commit(np.asarray(s_ntt))
        tr.absorb(b"commit", f, c)
        commits.append(c)
        witnesses.append(np.asarray(s_ntt))
        print(f"commitment {i}: range check ok over "
              f"{np.asarray(checks).size} digits")

    # folding challenge from the transcript (NTT-form scalar challenge)
    r_vals = tr.squeeze_field_elements(f, 1)
    r = ring.from_scalar_ntt(int(f.decode(r_vals)[0]))
    print("challenge r =", int(f.decode(r_vals)[0]) % ring.q)

    s_fold = ring.add(witnesses[0], ring.ntt_mul(
        np.broadcast_to(np.asarray(r), witnesses[1].shape), witnesses[1]))
    c_fold = ring.add(commits[0], ring.ntt_mul(
        np.broadcast_to(np.asarray(r), commits[1].shape), commits[1]))

    c_check = commit(s_fold)
    ok = (np.asarray(c_check) == np.asarray(c_fold)).all()
    print("folded opening verifies:", bool(ok))
    assert ok
    # transcript determinism: a verifier replaying the absorbs gets r
    tv = Transcript(b"folding-demo")
    for c in commits:
        tv.absorb(b"commit", f, c)
    assert int(f.decode(tv.squeeze_field_elements(f, 1))[0]) == \
        int(f.decode(r_vals)[0])
    print("verifier transcript replay matches")

    # --- the same step as ONE jit module (protocol.FoldingStep) --------
    # challenge fold + icrt + gadget decompose + traced L2 check + crt +
    # Ajtai digit commitment, composed — the production-rate shape.
    import jax.numpy as jnp

    from stark_rings_tpu.protocol import FoldingStep

    # NOTE: k defaults to decomposition_max_length(q, base) = 32 here —
    # the staged part's k=16 was only sound for its bound-1 SHORT
    # witnesses; the composed step decomposes a full-range folded
    # witness, and a too-small k would silently truncate high digits
    fs = FoldingStep(ring, n_rows=n, wit_len=m, base=base)
    cP = jax.device_put(fs.init_tables(rng))
    rt = fs.precompute_challenge(
        np.asarray(ring.from_scalar_coeff(int(f.decode(r_vals)[0]))))
    W = 2
    s0t = fs.rand_witness(W, rng)
    s1t = fs.rand_witness(W, rng)
    c0t = fs.tm.to_t(jnp.asarray(np.asarray(ring.rand_ntt((W, n), rng))))
    c1t = fs.tm.to_t(jnp.asarray(np.asarray(ring.rand_ntt((W, n), rng))))
    o = jax.jit(fs.step)(cP, s0t, s1t, c0t, c1t, rt)
    assert bool(np.asarray(o["ok_l2"]).all()), "composed L2 check failed"
    # linearity of the composed fold (same check as the staged path)
    want = ring.add(fs.tm.from_t(s0t), ring.ntt_mul(
        fs.tm.from_t(s1t),
        jnp.broadcast_to(jnp.asarray(ring.crt(jnp.asarray(
            ring.from_scalar_coeff(int(f.decode(r_vals)[0])))[None]))[0],
            fs.tm.from_t(s1t).shape)))
    assert (np.asarray(fs.tm.from_t(o["s"])) == np.asarray(want)).all()
    print("composed one-module folding step matches the staged fold; "
          f"digit commitment shape {np.asarray(o['cd']).shape}")


if __name__ == "__main__":
    main()
