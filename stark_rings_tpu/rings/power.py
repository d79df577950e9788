"""Large power-of-two negacyclic rings Fq[X]/(X^N + 1) — the scaled-up
generalization the BASELINE configs demand (deg 2^12..2^20), with the same
capability surface as the small reference models (fully-splitting NTT form,
like stark_prime's D=16 model, generalized to any power of two).

Duck-compatible with :class:`RingModel` where it matters (field, D,
crt/icrt/ntt_mul/coeff_mul/from_scalar/rand), so linalg matrices and MLEs
of big ring elements work unchanged via the RingElems adapter."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..fields import get_field
from ..ops.ntt import NTTContext

__all__ = ["PowerRing", "get_power_ring"]


class PowerRing:
    """Fully-splitting negacyclic ring: NTT form = leaf-order evaluations,
    slot field = Fq (E=1, N slots = D)."""

    def __init__(self, field_name: str, logN: int):
        self.field = get_field(field_name)
        self.name = f"{field_name}_pow2_{logN}"
        self.q = self.field.q
        self.D = 1 << logN
        self.N = self.D
        self.E = 1
        self.ctx = NTTContext(self.field, self.D, negacyclic=True)

    # -- conversions ------------------------------------------------------
    def encode_coeffs(self, ints):
        arr = np.asarray(ints, dtype=object)
        assert arr.shape[-1] == self.D
        return self.field.encode(arr)

    def decode(self, x):
        return self.field.decode(x)

    def rand_coeff(self, shape, rng):
        return self.field.rand(tuple(shape) + (self.D,), rng)

    rand_ntt = rand_coeff

    def zeros(self, shape=()):
        return self.field.zeros(tuple(shape) + (self.D,))

    def from_scalar_coeff(self, v, shape=()):
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0] = v % self.q
        return self.encode_coeffs(out)

    def from_scalar_ntt(self, v, shape=()):
        out = np.empty(tuple(shape) + (self.D,), dtype=object)
        out[...] = v % self.q
        return self.encode_coeffs(out)

    # -- ring ops ---------------------------------------------------------
    def add(self, a, b):
        return self.field.add(a, b)

    def sub(self, a, b):
        return self.field.sub(a, b)

    def neg(self, a):
        return self.field.neg(a)

    def crt(self, x):
        return self.ctx.forward(x)

    def icrt(self, x):
        return self.ctx.inverse(x)

    def ntt_mul(self, a, b):
        return self.field.mul(a, b)

    mul_unchecked = ntt_mul

    def coeff_mul(self, a, b):
        return self.ctx.mul(a, b)

    def coeff_square(self, a):
        """a*a with one forward transform (see mxu_ctx().square for the
        production-rate variant)."""
        return self.ctx.square(a)

    def precompute(self, b):
        """Cached-operand state (leaf-order evaluations) for
        coeff_mul_cached — the fixed-operand protocol pattern.  States
        are engine-specific: this one pairs with coeff_mul_cached only;
        the production-rate pair is mxu_ctx().precompute/mul_cached."""
        return self.ctx.forward(b)

    def coeff_mul_cached(self, a, fb):
        """Multiply by a precomputed operand (one forward saved); fb
        from a batch-1 b broadcasts over a's batch."""
        return self.ctx.inverse(self.field.mul(self.ctx.forward(a), fb))

    def mxu_ctx(self):
        """The int8 digit-plane multiplier for this degree, one engine
        per field on every platform: ``Mxu2NTT`` (goldilocks),
        ``MxuBBNTT`` (babybear), ``MxuLimbNTT`` (stark_prime).  Built
        lazily once — the pre-scaled weight digitization is a host-side
        one-time cost.  ``mxu_ctx().jit_mul()`` is the production
        multiply; bit-exact vs ``coeff_mul`` (leaf orders differ only
        internally — coefficients in, coefficients out; operands in
        field STORAGE form)."""
        ctx = getattr(self, "_mxu_ctx", None)
        if ctx is not None:
            return ctx
        if self.field.name == "babybear":
            from ..ops.mxu_bb import MxuBBNTT

            ctx = MxuBBNTT(self.D)
        elif self.field.limbed:
            # 252-bit prime: LimbPrescaledMat levels + word-REDC folds
            from ..ops.mxu_limb import MxuLimbNTT

            ctx = MxuLimbNTT(self.field, self.D)
        else:
            assert self.field.name == "goldilocks", \
                "digit weights exist for goldilocks/babybear/stark_prime"
            from ..ops.mxu2 import Mxu2NTT

            ctx = Mxu2NTT(self.D)
        self._mxu_ctx = ctx
        return ctx

    def fourstep_ctx(self):
        """Single-chip four-step multiplier on flat [.., N] tensors.

        An alternative exact path to :meth:`mxu_ctx` at large degrees:
        its radix stages avoid the digit engine's int32 bucket tensor
        (4x the canonical bytes) but do ~log N emulated 64-bit modular
        multiplies per slot instead of int8 dots; which one is faster
        at a given degree is a measurement.  Returns (forward,
        inverse, mul) on flat [.., N] tensors; ``mul`` is bit-equal to
        :meth:`coeff_mul` (tested).  forward/inverse are a SELF-
        CONSISTENT evaluation pair whose slot ORDER differs from this
        ring's ``crt`` leaf order — never mix the two NTT domains
        (pointwise-combine only values from the same engine).  The
        field needs a (q-1) % 2N == 0 root chain (goldilocks/babybear/
        stark_prime up to their 2-adicity)."""
        cache = getattr(self, "_fourstep", None)
        if cache is None:
            from ..parallel.ntt import ShardedNTT

            sn = ShardedNTT(self.field.name, self.D, 1, single_chip=True)
            fwd_m, inv_m, mul_m = sn.make_single_chip_fns()

            def forward(x):
                return sn.from_matrix(fwd_m(sn.to_matrix(x)))

            def inverse(x):
                return sn.from_matrix(inv_m(sn.to_matrix(x)))

            def mul(a, b):
                return sn.from_matrix(mul_m(sn.to_matrix(a),
                                            sn.to_matrix(b)))

            cache = self._fourstep = (forward, inverse, mul)
        return cache

    def ntt_pow(self, a, e: int):
        """Slotwise pow on the NTT form (square-and-multiply), matching
        RingModel.ntt_pow so Rq.__pow__ works over power rings too."""
        assert e >= 0, "negative exponents: invert first"
        if e == 0:
            return self.from_scalar_ntt(1, a.shape[:-1] if not
                                        self.field.limbed else
                                        a.shape[:-2])
        acc = None
        base = a
        while e:
            if e & 1:
                acc = base if acc is None else self.field.mul(acc, base)
            e >>= 1
            if e:
                base = self.field.mul(base, base)
        return acc

    def ntt_inv(self, a):
        return self.field.inv(a)

    def rot(self, a):
        """Multiply by X: negacyclic shift."""
        f = self.field
        D = self.D
        last = f.take_coeff(a, np.arange(D - 1, D, dtype=np.int32))
        rest = f.take_coeff(a, np.arange(0, D - 1, dtype=np.int32))
        return jnp.concatenate([f.neg(last), rest], axis=f.coeff_axis)

    def flatten(self, x):
        f = self.field
        batch = x.shape[: x.ndim - (2 if f.limbed else 1) - 1]
        n = x.shape[-2 - (1 if f.limbed else 0)]
        return x.reshape(batch + (n * self.D,) + f.limb_shape)

    def promote(self, x):
        f = self.field
        batch = x.shape[: x.ndim - (1 if f.limbed else 0) - 1]
        nd = x.shape[-1 - (1 if f.limbed else 0)]
        assert nd % self.D == 0
        return x.reshape(batch + (nd // self.D, self.D) + f.limb_shape)


_POWER = {}


def get_power_ring(field_name: str, logN: int) -> PowerRing:
    key = (field_name, logN)
    if key not in _POWER:
        _POWER[key] = PowerRing(field_name, logN)
    return _POWER[key]
