#!/usr/bin/env python
"""End-to-end multi-level folding tree with a verifier.

2^t short witnesses are committed (Ajtai, matrix.rs:148-188 shape),
then folded pairwise down to ONE witness: each level runs the composed
FoldingStep module (challenge fold + icrt + gadget decompose
mod.rs:163-175 + traced exact L2 + crt + digit commitment + psi range
check monomial.rs:79-93) with a fresh SHAKE-256 transcript challenge,
and the host verifier re-checks every level through independent paths
(linalg oracle commitments, host gadget recompose, homomorphism).

Model: frog — a power-of-two cyclotomic (X^16 + 1), so the psi range
check is complete on the balanced digit window and PASSES at every
level (on goldilocks/babybear negative digits honestly fail it;
FoldingTree auto-disables psi there).

Run:  python examples/folding_tree.py
"""

import os
import random
import sys

import numpy as np

import jax

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402

from stark_rings_tpu.protocol import FoldingTree  # noqa: E402
from stark_rings_tpu.rings import get_ring  # noqa: E402
from stark_rings_tpu.rings.absorb import Transcript  # noqa: E402


def main():
    ring = get_ring("frog")
    rng = random.Random(17)
    t, n, L = 2, 2, 3                       # 4 witnesses, tiny shapes
    W = 1 << t
    ft = FoldingTree(ring, n_rows=n, wit_len=L, base=8)
    assert ft.fs.psi_check, "frog is negacyclic: psi check is live"

    c = jax.device_put(ft.init_tables(rng))
    wt = ft.rand_witnesses(W, rng)
    ct = jax.jit(ft.commit_witnesses)(c, wt)
    print(f"leaves: {W} witnesses of {L} ring elements, "
          f"committed to {n} rows")

    # Fiat-Shamir: absorb the leaf commitments, squeeze one challenge
    # per level (the verifier re-derives the same transcript)
    def challenges():
        tr = Transcript(b"stark-rings-tpu/folding-tree")
        tr.absorb(b"leaf-commitments", ring.field, np.asarray(ct))
        rs = []
        for lvl in range(t):
            tr.absorb_bytes(b"level", bytes([lvl]))
            rs.append(tr.squeeze_ring_element(ring))
        return rs

    rs = challenges()
    rts = ft.precompute_challenges([jnp.asarray(r) for r in rs])

    levels, root_w, root_c = jax.jit(
        lambda c, wt, ct: ft.prove(c, wt, ct, rts))(c, wt, ct)
    print(f"tree: {t} levels, root witness shape "
          f"{np.asarray(root_w).shape}")
    for lvl, out in enumerate(levels):
        print(f"  level {lvl}: {out['s'].shape[1]} folded witnesses, "
              f"ok_l2={np.asarray(out['ok_l2']).tolist()}, "
              f"ok_psi={np.asarray(out['ok_psi']).tolist()}")

    assert ft.verify(c, wt, ct, levels, rts), "verifier rejected"
    print("verifier: ACCEPT (commitment oracle, digit recompose, "
          "homomorphism, L2 + psi at every level)")

    # tamper check: corrupt one digit commitment -> reject
    bad = [dict(o) for o in levels]
    v = np.asarray(bad[1]["cd"]).copy()
    v.reshape(-1)[0] = (int(v.reshape(-1)[0]) + 1) % ring.q
    bad[1]["cd"] = jnp.asarray(v)
    assert not ft.verify(c, wt, ct, bad, rts), "tamper undetected"
    print("verifier: REJECT on a tampered digit commitment")


if __name__ == "__main__":
    main()
