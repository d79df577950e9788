"""stark-rings-tpu: a cyclotomic-ring algebra framework for accelerators.

A from-scratch JAX/XLA implementation with the capabilities of
NethermindEth/stark-rings (cyclotomic rings Fp[X]/Phi(X) for STARK-friendly
primes, balanced decomposition, ring linear algebra, multilinear
extensions), redesigned for batched device execution:

* ring elements are tensors; vectors of ring elements are batch axes
* the CRT/NTT butterfly dataflow is data (2-term linear stage tables)
  applied as fused vector ops
* rayon loops of the reference become vmap/batch axes on one chip and
  shard_map + collectives (all_to_all / psum) across chips
* unsafe transmute casts of the reference are free reshapes

Layer map (mirrors SURVEY.md §1):
    fields/    L0  prime-field kernels (replaces arkworks MontBackend)
    rings/     L2  four ring models: goldilocks, babybear, frog, stark_prime
    decomp/    L2  balanced/gadget decomposition
    linalg/    L1  dense/sparse/symmetric matrices over ring elements
    mle/       L3  dense/sparse multilinear extensions + helpers
    ops/       derived kernels: CRT stage tables, large power-of-two NTTs
    parallel/  multi-chip: mesh + four-step sharded NTT
    protocol/  composed folding-step pipelines (one jit module per step)
    spec/      integer-exact oracle (bit-exactness anchor vs the Rust crate)
"""

from . import (decomp, fields, linalg, mle, ops, parallel, protocol,
               rings, spec)
from .decomp import (decompose, gadget_decompose, gadget_recompose,
                     recompose)
from .errors import ConversionError
from .fields import FIELDS, get_field
from .linalg import (AlgebraError, FieldElems, Matrix, RingElems,
                     SparseMatrix, SymmetricMatrix)
from .mle import ArithError, DenseMLE, SparseMLE
from .parallel import ShardedNTT, make_mesh
from .protocol import FoldingStep, FoldingTree
from .rings import RINGS, RingModel, Rq, get_power_ring, get_ring

__version__ = "0.2.0"

# the reference re-exports its whole trait surface at the crate root
# (crates/ring/src/lib.rs:4-12, stark-rings lib.rs) — mirror that:
# the common types are importable from the package top level.
__all__ = [
    "fields", "rings", "decomp", "linalg", "mle", "ops", "parallel",
    "protocol", "spec", "FoldingStep", "FoldingTree",
    "get_field", "get_ring", "get_power_ring", "FIELDS", "RINGS",
    "RingModel", "Rq", "Matrix", "SparseMatrix", "SymmetricMatrix", "FieldElems",
    "RingElems", "DenseMLE", "SparseMLE", "decompose", "recompose",
    "gadget_decompose", "gadget_recompose", "ShardedNTT", "make_mesh",
    "AlgebraError", "ArithError", "ConversionError",
]
