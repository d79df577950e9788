#!/usr/bin/env python
"""End-to-end demo: the multilinear SUMCHECK protocol over a STARK
field, driven entirely through this framework's surface — the proof
workhorse the reference's poly crate exists to serve (its HyperPlonk
helper set, crates/poly/src/polynomials/multilinear_polynomial.rs, is
the building block of exactly this protocol).

Claim: S = sum_{x in {0,1}^n} g(x) * h(x) for multilinear g, h.

Each round the prover sends the degree-2 univariate
    p_i(t) = sum_{x'} g(t, x') h(t, x')
as evaluations at t = 0, 1, 2 (computed VECTORIZED on device from the
halved eval tables — no per-point loops), the Fiat-Shamir transcript
(SHAKE-256, canonical base-field bytes) returns the challenge r_i, and
both sides reduce the claim to p_i(r_i).  The final claim is checked
against DenseMLE.evaluate at the challenge point.

Run:  python examples/sumcheck.py
"""

import os
import random
import sys

import numpy as np

import jax
import jax.numpy as jnp

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])

sys.path.insert(0, ".")

from stark_rings_tpu.fields import get_field  # noqa: E402
from stark_rings_tpu.linalg import FieldElems  # noqa: E402
from stark_rings_tpu.mle import DenseMLE  # noqa: E402
from stark_rings_tpu.rings.absorb import Transcript  # noqa: E402

F = get_field("goldilocks")
N_VARS = 14


def _interp_at(f, p0, p1, p2, r):
    """Evaluate the quadratic through (0,p0),(1,p1),(2,p2) at r."""
    # jnp scalars: numpy-scalar wraparound in f.sub emits RuntimeWarnings
    inv2 = jnp.asarray(f.const(pow(2, f.q - 2, f.q)))
    one, two = jnp.asarray(f.const(1)), jnp.asarray(f.const(2))
    r = jnp.asarray(r)
    l0 = f.mul(f.mul(f.sub(r, one), f.sub(r, two)), inv2)
    l1 = f.mul(r, f.sub(two, r))                       # -r(r-2)
    l2 = f.mul(f.mul(r, f.sub(r, one)), inv2)
    return f.add(f.add(f.mul(p0, l0), f.mul(p1, l1)), f.mul(p2, l2))


def prove(g_evals, h_evals, transcript):
    """Runs the prover; returns (claimed sum, round messages, challenges).

    Round arithmetic comes from the library
    (stark_rings_tpu.mle.sumcheck); this example drives it
    interactively against a real Fiat-Shamir transcript."""
    from stark_rings_tpu.mle.sumcheck import sumcheck_fold, sumcheck_round

    f = F
    S = f.sum(f.mul(g_evals, h_evals), axis=0)
    transcript.absorb(b"sum", f, S)
    G, H = g_evals, h_evals
    msgs, chals = [], []
    for _ in range(N_VARS):
        p0, p1, p2, G0, H0, dG, dH = sumcheck_round(f, G, H)
        for lbl, p in ((b"p0", p0), (b"p1", p1), (b"p2", p2)):
            transcript.absorb(lbl, f, p)
        (r,) = transcript.squeeze_field_elements(f, 1)
        G, H = sumcheck_fold(f, r, G0, H0, dG, dH)
        msgs.append((p0, p1, p2))
        chals.append(r)
    return S, msgs, chals


def verify(S, msgs, g_mle, h_mle, transcript):
    """Replays the transcript; True iff every round + the final MLE
    evaluation check pass."""
    f = F
    transcript.absorb(b"sum", f, S)
    claim = S
    rs = []
    for p0, p1, p2 in msgs:
        if int(f.decode(f.add(p0, p1))) != int(f.decode(claim)):
            return False
        for lbl, p in ((b"p0", p0), (b"p1", p1), (b"p2", p2)):
            transcript.absorb(lbl, f, p)
        (r,) = transcript.squeeze_field_elements(f, 1)
        rs.append(r)
        claim = _interp_at(f, p0, p1, p2, r)
    gv = g_mle.evaluate(rs)
    hv = h_mle.evaluate(rs)
    return int(f.decode(claim)) == int(f.decode(f.mul(gv, hv)))


def main():
    rng = random.Random(7)
    e = FieldElems(F)
    g = DenseMLE.rand(e, N_VARS, rng)
    h = DenseMLE.rand(e, N_VARS, rng)
    g_evals = jnp.asarray(g.evals)
    h_evals = jnp.asarray(h.evals)

    S, msgs, chals = prove(g_evals, h_evals, Transcript(b"sumcheck"))
    ok = verify(S, msgs, g, h, Transcript(b"sumcheck"))
    assert ok, "honest proof rejected"

    # soundness smoke test: tamper with one round message
    bad = [list(m) for m in msgs]
    bad[3][1] = F.add(bad[3][1], F.const(1))
    assert not verify(S, [tuple(m) for m in bad], g, h,
                      Transcript(b"sumcheck")), "tampered proof accepted"

    print(f"sumcheck over {N_VARS} vars on {jax.devices()[0]}: "
          f"S = {int(F.decode(S))}, verified = {ok}, tamper rejected")


if __name__ == "__main__":
    main()
