"""Exact collectives for widened (base-2^32 word) sums.

``psum_words`` keeps a cross-device reduction of uint64 words exact by
splitting every word into four 16-bit chunks held in uint32, psum-ing
those, and recombining — chunk sums stay below ``P * 2^16 << 2^32`` for
any realistic mesh, and the recombination is exact modulo 2^64, which
suffices because the true total is the value being represented.  The
chunking exists because the accelerator this library was first built
for lowered only 32-bit ``Sum`` all-reduces; it is exact under NCCL as
well, and a plain uint64 ``psum`` could replace it (a simplicity
candidate, ROADMAP.md).

This replaces the reference's rayon in-process reductions
(/root/reference/crates/linear_algebra/src/sparse_matrix.rs:202-217).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["psum_words"]


def psum_words(words, axis_name):
    """Exact cross-device sum of uint64 word arrays.

    ``words``: uint64[...] with true per-device values < 2^64 and a true
    total < 2^64 (the widened-accumulation invariant: words < n * 2^32
    for n local summands).  Returns uint64[...] = sum over ``axis_name``.
    """
    chunks = jnp.stack(
        [((words >> np.uint64(16 * k)) & np.uint64(0xFFFF))
         .astype(jnp.uint32) for k in range(4)])
    tot = jax.lax.psum(chunks, axis_name)          # one u32 all-reduce
    out = tot[0].astype(jnp.uint64)
    for k in range(1, 4):
        out = out + (tot[k].astype(jnp.uint64) << np.uint64(16 * k))
    return out
