#!/usr/bin/env python
"""Big-ring folding combine with a cached challenge — the fixed-operand
pattern through the public surface (PowerRing.mxu_ctx).

A folding prover repeatedly computes  w' = c * w + v  where c is ONE
challenge ring element fixed for the whole round.  With `precompute`,
c's forward transform is built once; every combine then costs one
forward + slot product + one inverse instead of a full multiply.

Run:  python examples/bigring_fold.py
"""

import os
import sys

import numpy as np

import jax

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])

sys.path.insert(0, ".")

from stark_rings_tpu.ops.ntt import NTTContext  # noqa: E402
from stark_rings_tpu.rings import get_power_ring  # noqa: E402


def main():
    logN, B = 12, 8
    N = 1 << logN
    ring = get_power_ring("goldilocks", logN)
    F = ring.field
    print(f"deg-2^{logN} goldilocks ring, batch {B}, "
          f"platform {jax.devices()[0].platform}")

    tp = ring.mxu_ctx()
    c_tab = jax.device_put(tp.consts())

    rng = np.random.default_rng(0)
    w = jax.device_put(rng.integers(0, F.q, (B, N), dtype=np.uint64))
    v = jax.device_put(rng.integers(0, F.q, (B, N), dtype=np.uint64))
    ch = jax.device_put(rng.integers(0, F.q, (1, N), dtype=np.uint64))

    # challenge transform cached ONCE per folding round
    vc = jax.jit(lambda cc, y: tp.precompute(y, cc))(c_tab, ch)

    @jax.jit
    def combine(cc, w, v, vc):
        return F.add(tp.mul_cached(w, vc, cc), v)

    w1 = combine(c_tab, w, v, vc)

    # check against the independent radix NTT path (general multiply)
    ctx = NTTContext(F, N, negacyclic=True)
    want = F.add(ctx.mul(w, np.broadcast_to(np.asarray(ch), w.shape)), v)
    assert np.array_equal(np.asarray(w1), np.asarray(want)), "mismatch"
    print("combine w' = c*w + v exact vs the radix oracle")

    # squaring (folding cross terms): one forward transform
    sq = jax.jit(lambda cc, x: tp.square(x, cc))(c_tab, w)
    assert np.array_equal(np.asarray(sq), np.asarray(ctx.mul(w, w)))
    print("square exact vs the radix oracle")


if __name__ == "__main__":
    main()
