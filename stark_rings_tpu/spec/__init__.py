"""Pure-Python integer "spec" layer.

This subpackage is the bit-exactness anchor of the framework: a direct,
arbitrary-precision-integer implementation of the cyclotomic-ring CRT/ICRT
kernels, balanced decomposition and ring arithmetic with exactly the same
semantics as the Rust reference (NethermindEth/stark-rings).  It is used to

* validate against the reference's golden test vectors,
* derive the constant tables / linear-stage data consumed by the JAX
  runtime (`stark_rings_tpu.ops`), and
* serve as a slow oracle in the test-suite.

Nothing in here runs on the hot path.
"""

from .field import modinv, modpow
from .models import MODELS, SpecModel, get_model

__all__ = ["modinv", "modpow", "MODELS", "SpecModel", "get_model"]
