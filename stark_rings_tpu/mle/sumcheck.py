"""Vectorized multilinear-sumcheck prover arithmetic.

The reference's poly crate exists to serve sumcheck-style provers (its
HyperPlonk helper set,
/root/reference/crates/poly/src/polynomials/multilinear_polynomial.rs);
this module is the batched device side of that protocol for the
product claim S = sum_x g(x) h(x): each round's degree-2 message
(p(0), p(1), p(2)) and table fold are pure batched field ops on the
halved eval tables — no per-point loops.

The Fiat-Shamir transcript stays host-side (rings/absorb.Transcript);
``sumcheck_prove_with_challenges`` runs the WHOLE prover inside one jit
module for pre-supplied challenges — the arithmetic-throughput shape a
pipelined prover hits on device (examples/sumcheck.py drives the same
round function interactively with a real transcript).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["sumcheck_round", "sumcheck_fold",
           "sumcheck_prove_with_challenges", "sumcheck_round_many",
           "sumcheck_fold_many", "sumcheck_prove_many_with_challenges",
           "bit_reverse_table"]


def _halves(T, order):
    """The two cosets of the variable bound this round.

    ``order="lsb"`` binds x_0 (the LSB of the little-endian index —
    the reference's fix_variables convention, dense.rs:171-199);
    ``order="msb"`` binds the TOP variable (contiguous halves, so each
    round reads two contiguous slices).
    Either order is a sound sumcheck for the same claim; the messages
    relate by the bit-reversal identity (see bit_reverse_table)."""
    if order == "lsb":
        return T[0::2], T[1::2]
    assert order == "msb", order
    h = T.shape[0] // 2
    return T[:h], T[h:]


def bit_reverse_table(T):
    """Little-endian bit-reversal permutation of a 2^nv eval table:
    out[rev(i)] = T[i].  msb-order proving on bit_reverse_table(T)
    produces EXACTLY the lsb-order messages/finals for T (each round
    binds the same variable of the same multilinear), so one transpose
    converts between the conventions — tested in test_sumcheck_lib."""
    n = T.shape[0]
    nv = n.bit_length() - 1
    assert 1 << nv == n
    return T.reshape((2,) * nv).transpose(tuple(reversed(range(nv)))
                                          ).reshape(n)


def sumcheck_round(f, G, H, order: str = "lsb"):
    """One round's message for the product claim over tables G, H.

    Binds this round's variable (see :func:`_halves` for the order
    convention): returns (p0, p1, p2, G0, H0, dG, dH) with p(t)
    evaluated at t = 0, 1, 2 and the ingredients the fold needs."""
    G0, G1 = _halves(G, order)
    H0, H1 = _halves(H, order)
    dG, dH = f.sub(G1, G0), f.sub(H1, H0)
    p0 = f.sum(f.mul(G0, H0), axis=0)
    p1 = f.sum(f.mul(G1, H1), axis=0)
    p2 = f.sum(f.mul(f.add(G1, dG), f.add(H1, dH)), axis=0)
    return p0, p1, p2, G0, H0, dG, dH


def sumcheck_fold(f, r, G0, H0, dG, dH):
    """Bind the round variable to the challenge r: the halved tables."""
    r = jnp.asarray(r)
    return f.add(G0, f.mul(r, dG)), f.add(H0, f.mul(r, dH))


def sumcheck_prove_with_challenges(f, G, H, challenges, order: str = "lsb"):
    """Full prover arithmetic for known challenges, one traceable graph.

    Returns (msgs [nv, 3] field storage, g(r), h(r)) — the per-round
    degree-2 messages and the fully-bound table values the verifier's
    final check consumes.  ``order="msb"`` binds top variables first
    (challenge j lands on variable nv-1-j; the final values are the
    same polynomials at the reversed point)."""
    msgs = []
    for r in challenges:
        p0, p1, p2, G0, H0, dG, dH = sumcheck_round(f, G, H, order)
        G, H = sumcheck_fold(f, r, G0, H0, dG, dH)
        msgs.append(jnp.stack([p0, p1, p2]))
    return jnp.stack(msgs), G[0], H[0]


# -- k-ary products (HyperPlonk shape) ------------------------------------
# The reference's random_mle_list(nv, degree) exists "for testing
# sumcheck" over PRODUCTS OF k MLEs (multilinear_polynomial.rs:19-55);
# these are the degree-k rounds such a claim needs: each round message is
# p(0..k), evaluated by stepping every table's odd half by its delta —
# k-1 extra adds and one extra product per evaluation point, all batched.


def sumcheck_round_many(f, tables, reduce=None, order: str = "lsb"):
    """One round for S = sum_x prod_i T_i(x): degree-k message + fold
    ingredients.  Returns (msgs [k+1, ...], t0s, deltas).

    ``reduce`` maps the elementwise product table to the message scalar
    (default: local modular sum).  The sharded prover passes its
    psum-backed exact reduction so the degree-k stepping has exactly
    one implementation."""
    if reduce is None:
        def reduce(x):
            return f.sum(x, axis=0)
    halves = [_halves(T, order) for T in tables]
    deltas = [f.sub(t1, t0) for t0, t1 in halves]

    def prod_sum(vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = f.mul(acc, v)
        return reduce(acc)

    msgs = [prod_sum([t0 for t0, _ in halves]),
            prod_sum([t1 for _, t1 in halves])]
    cur = [t1 for _, t1 in halves]
    for _ in range(2, len(tables) + 1):
        cur = [f.add(c, d) for c, d in zip(cur, deltas)]
        msgs.append(prod_sum(cur))
    return msgs, [t0 for t0, _ in halves], deltas


def sumcheck_fold_many(f, r, t0s, deltas):
    r = jnp.asarray(r)
    return [f.add(t0, f.mul(r, d)) for t0, d in zip(t0s, deltas)]


def sumcheck_prove_many_with_challenges(f, tables, challenges,
                                        order: str = "lsb"):
    """k-ary product prover for known challenges, one traceable graph.

    Returns (msgs [nv, k+1], finals [k]) — per-round degree-k messages
    (p evaluated at 0..k) and each table's fully-bound value; the
    verifier interpolates p from k+1 points and checks
    p(0) + p(1) == previous claim, finishing with prod(finals)."""
    msgs = []
    for r in challenges:
        round_msgs, t0s, deltas = sumcheck_round_many(f, tables,
                                                      order=order)
        tables = sumcheck_fold_many(f, r, t0s, deltas)
        msgs.append(jnp.stack(round_msgs))
    return jnp.stack(msgs), [T[0] for T in tables]
