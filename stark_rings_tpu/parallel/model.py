"""Data-parallel model-ring operations over a device mesh.

The reference's only parallelism for the model rings is rayon over the
element vector (`cfg_iter!`, SURVEY.md §2.5).  The device equivalent is a
batch axis sharded over the mesh: each device runs the fused
batch-trailing multiply (ops/model_mul.TModelMul — CRT / slot product /
ICRT as local int8 digit matmuls) on its shard, with ZERO collectives in
the steady state.  One wrapper owns the layout so protocol code can
scale witness-sized element vectors across chips without touching
sharding internals.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.model_mul import TModelMul

__all__ = ["ShardedModelMul"]


class ShardedModelMul:
    """Batch-sharded fused multiply for one reference ring model.

    Element vectors are batch-leading storage tensors ``[B, D(, L)]``
    with B sharded over ``axis``; semantics equal
    ``ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))`` elementwise.
    """

    def __init__(self, ring, mesh: Mesh, axis: str = "x"):
        self.ring = ring
        self.mesh = mesh
        self.axis = axis
        self.tm = TModelMul(ring)

    def spec(self):
        tail = (None,) * (2 if self.ring.field.limbed else 1)
        return P(self.axis, *tail)

    def make_mul_fn(self):
        """jitted ``[B, D(, L)] x [B, D(, L)] -> [B, D(, L)]``, B sharded."""
        sp = self.spec()
        tm = self.tm

        def local(a, b):
            return tm.from_t(tm.mul_t(tm.to_t(a), tm.to_t(b)))

        return jax.jit(jax.shard_map(local, mesh=self.mesh,
                                     in_specs=(sp, sp), out_specs=sp))

    def make_ntt_mul_fn(self):
        """Slot-wise NTT-form multiply (the folding-prover hot loop),
        batch sharded, zero collectives."""
        sp = self.spec()
        tm = self.tm

        def local(a, b):
            return tm.from_t(tm.ntt_mul_t(tm.to_t(a), tm.to_t(b)))

        return jax.jit(jax.shard_map(local, mesh=self.mesh,
                                     in_specs=(sp, sp), out_specs=sp))

    def make_challenge_mul_fn(self):
        """w -> c*w for ONE replicated fixed element c ([1, D(, L)]):
        the folding challenge multiply, batch sharded, zero collectives.
        c's CRT runs once per device (a single element — negligible) and
        its slot values broadcast over the local batch; one of the two
        CRT dots per element is saved vs the general multiply."""
        sp = self.spec()
        tail = (None,) * (2 if self.ring.field.limbed else 1)
        cspec = P(None, *tail)
        tm = self.tm

        def local(a, ch):
            fc = tm.precompute_t(tm.to_t(ch))
            return tm.from_t(tm.mul_cached_t(tm.to_t(a), fc))

        return jax.jit(jax.shard_map(local, mesh=self.mesh,
                                     in_specs=(sp, cspec), out_specs=sp))
