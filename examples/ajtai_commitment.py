#!/usr/bin/env python
"""End-to-end demo: an Ajtai-style lattice commitment over the Goldilocks
cyclotomic ring — the kind of protocol the reference's algebra serves
(it is the algebra layer under LatticeFold-style provers).

    commit(s) = A s          A: n x m matrix of NTT-form ring elements
    opening check:  c == A s   and   ||s||_inf small

Exercises, in one flow: ring CRT/NTT mul, matrices over ring elements,
gadget decomposition (to make the witness short), norms, and the
invertible-challenge sampler.

Run:  python examples/ajtai_commitment.py
"""

import os
import random
import sys

import numpy as np

import jax

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])

sys.path.insert(0, ".")

from stark_rings_tpu.decomp import (  # noqa: E402
    decomposition_max_length,
    gadget_decompose,
    gadget_recompose,
)
from stark_rings_tpu.decomp.norms import (  # noqa: E402
    l2_check, l2_norm_squared, linf_norm_exact)
from stark_rings_tpu.linalg import Matrix, RingElems  # noqa: E402
from stark_rings_tpu.rings import get_ring  # noqa: E402
from stark_rings_tpu.rings.sampling import (  # noqa: E402
    sample_short,
    sample_short_invertible,
)


def main():
    ring = get_ring("goldilocks")
    f = ring.field
    e = RingElems(ring)
    rng = random.Random(2024)

    n, m = 4, 8          # commitment matrix shape (ring elements)
    b, k = 256, decomposition_max_length(f.q, 256)

    # Public matrix A (NTT form, uniform)
    A = Matrix.rand(e, n, m, rng)

    # Witness: an arbitrary message vector (coeff form), made SHORT via
    # gadget decomposition: s = G^-1(msg), so ||s||_inf <= b/2 and
    # msg = G s (recompose).
    msg = np.asarray(ring.rand_coeff((m,), rng))
    s_short = gadget_decompose(f, msg, b, k)          # [m*k, D]
    assert linf_norm_exact(f, s_short) <= b // 2
    # traced exact L2 norm check ON DEVICE (no host object-array round
    # trip): the gadget guarantees ||s||_2^2 <= m*k*D*(b/2)^2
    beta_sq = m * k * ring.D * (b // 2) ** 2
    ok = jax.jit(lambda x: l2_check(f, x, beta_sq))(s_short)
    assert bool(ok), "traced L2 bound check failed"
    assert l2_norm_squared(f, s_short) <= beta_sq     # host cross-check
    back = gadget_recompose(f, s_short, b, k)
    assert (np.asarray(back) == msg).all()

    # Commit in NTT form: c = A' s' with A' = n x (m*k) (decomposed basis)
    A_wide = Matrix.rand(e, n, m * k, rng)
    s_ntt = ring.crt(s_short)

    commit = jax.jit(lambda sv: A_wide.mul_vec(sv))
    c = commit(s_ntt)
    jax.block_until_ready(c)
    print(f"commitment: {n} ring elements (D={ring.D}), "
          f"witness {m * k} short elements, ||s||_inf <= {b // 2}")

    # Verify: recompute and compare (bit-exact)
    c2 = commit(s_ntt)
    assert (np.asarray(c) == np.asarray(c2)).all()

    # Folding-style challenge: short invertible ring element
    ch = sample_short_invertible(ring, rng, bound=2)
    ch_ntt = ring.crt(ch)
    # folded witness s' = ch * s (slot-wise on NTT forms), folded
    # commitment ch * c — homomorphism check: A (ch s) == ch (A s)
    s_folded = ring.ntt_mul(ch_ntt, s_ntt)
    lhs = commit(s_folded)
    rhs = ring.ntt_mul(ch_ntt, c)
    assert (np.asarray(lhs) == np.asarray(rhs)).all()
    print("homomorphism check (A(ch*s) == ch*(A s)): ok")

    # Norm growth bound after folding (decode-side exact check)
    s_folded_coeff = ring.icrt(s_folded)
    norm = linf_norm_exact(f, s_folded_coeff)
    print(f"folded witness linf norm: {norm} (q ~ 2^{f.q.bit_length()})")
    # folding grows the norm by at most ||ch||_1 * D in the worst case;
    # check the traced L2 against that bound, on device
    fold_beta_sq = beta_sq * (2 * 2 + 1) ** 2 * ring.D ** 2
    okf = jax.jit(lambda x: l2_check(f, x, fold_beta_sq))(s_folded_coeff)
    print(f"traced L2 bound check after folding: {bool(okf)}")
    print("demo ok")


if __name__ == "__main__":
    main()
