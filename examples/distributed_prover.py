#!/usr/bin/env python
"""Multi-chip prover arithmetic demo on an 8-device mesh.

The reference is single-process (rayon only); this framework scales the
same algebra across chips.  This demo drives the three distributed
pieces a lattice folding/sumcheck prover needs, all on one mesh:

    1. Witness fold (batch-DP, zero collectives): s = s0 + r*s1 and the
       constraint product u = s *ring* t via ShardedModelMul — each
       device runs the fused CRT multiply on its shard.
    2. Commitment mat-vec (column-sharded, one widened psum):
       c = A s via ShardedMatVec.
    3. Product-claim sumcheck over tables sharded across the mesh
       (ShardedMLE.make_sumcheck_fn: one exact psum per round message,
       replicated tail rounds), challenges squeezed from a SHAKE-256
       transcript seeded by the commitment bytes.  (Challenges are
       squeezed up front so the whole prover runs as ONE jit module —
       the throughput shape; examples/sumcheck.py shows the true
       round-interleaved transcript schedule.)

Run:  python examples/distributed_prover.py        (8 devices)
      SRT_PLATFORM=cpu python examples/distributed_prover.py
                                       (a virtual 8-device CPU mesh)
"""

import os
import pathlib
import random
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

N_DEVICES = 8

if os.environ.get("SRT_PLATFORM"):  # smoke tests force "cpu" in-process
    jax.config.update("jax_platforms", os.environ["SRT_PLATFORM"])
    if os.environ["SRT_PLATFORM"] == "cpu":
        # read when the CPU backend starts, i.e. at the first device query
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{N_DEVICES}").strip()


def main():
    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(
            f"distributed_prover needs {N_DEVICES} devices, JAX found "
            f"{len(jax.devices())}; set SRT_PLATFORM=cpu for a virtual "
            "CPU mesh")

    from stark_rings_tpu.linalg import RingElems
    from stark_rings_tpu.parallel import (
        ShardedMLE, ShardedMatVec, ShardedModelMul, make_mesh)
    from stark_rings_tpu.rings import get_ring
    from stark_rings_tpu.rings.absorb import Transcript

    mesh = make_mesh(N_DEVICES)
    ring = get_ring("goldilocks")
    f = ring.field
    rng = random.Random(2024)

    # -- 1. batch-DP witness fold + constraint product -------------------
    B = 64                       # witness length, sharded 8 ways
    s0 = np.asarray(ring.rand_coeff((B,), rng))
    s1 = np.asarray(ring.rand_coeff((B,), rng))
    t = np.asarray(ring.rand_coeff((B,), rng))
    r = np.asarray(f.rand((), rng))

    smm = ShardedModelMul(ring, mesh)
    mul_fn = smm.make_mul_fn()
    s = np.asarray(jax.jit(
        lambda a, b, r: ring.add(a, ring.scalar_mul(r, b)))(s0, s1, r))
    u = mul_fn(s, t)             # fused CRT multiply, per shard
    print("witness fold + sharded ring product:", u.shape)

    # -- 2. column-sharded Ajtai commitment ------------------------------
    n_rows = 4
    A = np.asarray(ring.rand_coeff((n_rows, B), rng))
    smv = ShardedMatVec(RingElems(ring), mesh)
    c = smv.make_matvec_fn()(np.asarray(ring.crt(A)),
                             np.asarray(ring.crt(s)))
    print("sharded commitment:", np.asarray(c).shape)

    # -- 3. sharded sumcheck with transcript-squeezed challenges ---------
    tr = Transcript(b"distributed-prover-demo")
    tr.absorb(b"commitment", f, np.asarray(c))
    nv = 12
    G = np.asarray(f.rand((1 << nv,), rng))
    H = np.asarray(f.rand((1 << nv,), rng))
    sm = ShardedMLE(f, nv, mesh)
    claimed = np.asarray(sm.make_inner_product_fn()(G, H))
    tr.absorb(b"claim", f, claimed)
    chals = [np.asarray(tr.squeeze_field_elements(f, 1))[0]
             for _ in range(nv)]
    msgs, gv, hv = sm.make_sumcheck_fn()(G, H, *chals)

    # verifier-side check chain: p(0) + p(1) == previous claim; final
    # claim equals g(r) * h(r)
    msgs = np.asarray(msgs)
    cur = claimed
    for i in range(nv):
        p0, p1, p2 = (int(f.decode(msgs[i, j])) for j in range(3))
        assert (p0 + p1) % f.q == int(f.decode(cur)), f"round {i}"
        # evaluate the degree-2 message at the challenge by Lagrange
        ri = int(f.decode(chals[i]))
        half = pow(2, f.q - 2, f.q)
        c2 = (p2 - 2 * p1 + p0) * half % f.q
        c1 = (p1 - p0 - c2) % f.q
        cur = np.asarray(f.encode(np.array(
            (p0 + c1 * ri + c2 * ri * ri) % f.q, dtype=object)))
    final = int(f.decode(np.asarray(jax.jit(f.mul)(gv, hv))))
    assert final == int(f.decode(cur))
    print(f"sharded sumcheck verified: {nv} rounds, claim "
          f"{int(f.decode(claimed))}")


if __name__ == "__main__":
    main()
