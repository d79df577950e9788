"""Absorb / transcript surface (reference OverField bound,
crates/ring/src/poly_ring.rs:19-30: every base ring's base prime field
is `Absorb`-able into a sponge).

The reference delegates to arkworks' `Absorb` (CPU-side sponge input);
the equivalent here is an explicit, sanctioned API:

* :func:`to_absorb` — the canonical base-prime-field representation of
  any storage tensor (ring elements flatten to their D base-field
  coefficients first), as little-endian canonical bytes.  This is the
  byte stream arkworks' `to_sponge_bytes` produces for field elements.
* :class:`Transcript` — a SHAKE-256 Fiat-Shamir transcript over that
  representation: absorb tensors / labels, squeeze uniform field
  elements by rejection sampling (`Ring::FromRandomBytes` semantics,
  ring.rs:119-135) or raw bytes.

Transcripts are sequential, host-side objects (as in every arkworks
prover); the *data* they absorb comes straight off device tensors.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from ..fields import Field
from ..utils.serialize import elem_nbytes, elements_to_bytes

__all__ = ["to_absorb", "Transcript"]


def to_absorb(f: Field, x) -> bytes:
    """Canonical LE bytes of every base-prime-field value in ``x``.

    ``x`` is storage of shape [...] (+limbs); ring elements absorb as
    their D coefficients in order (Flatten is a reshape — flatten.rs)."""
    return elements_to_bytes(f, x)


class Transcript:
    """SHAKE-256 duplex-style Fiat-Shamir transcript."""

    def __init__(self, domain: bytes = b"stark-rings-tpu"):
        self._state = hashlib.shake_256()
        self._absorb_framed(b"domain", domain)
        self._counter = 0

    def _absorb_framed(self, label: bytes, data: bytes):
        self._state.update(struct.pack("<Q", len(label)) + label)
        self._state.update(struct.pack("<Q", len(data)) + data)

    def absorb_bytes(self, label: bytes, data: bytes):
        self._absorb_framed(label, data)

    def absorb(self, label: bytes, f: Field, x):
        """Absorb a storage tensor's canonical representation."""
        self._absorb_framed(label, to_absorb(f, x))

    def squeeze_bytes(self, n: int) -> bytes:
        self._counter += 1
        h = self._state.copy()
        h.update(struct.pack("<Q", self._counter))
        return h.digest(n)

    def squeeze_field_elements(self, f: Field, n: int):
        """n uniform canonical field elements via rejection sampling on
        the squeezed stream (FromRandomBytes semantics)."""
        nb = elem_nbytes(f)
        out = []
        chunk = max(2 * n, 4)
        while len(out) < n:
            data = self.squeeze_bytes(chunk * nb)
            for i in range(chunk):
                if len(out) >= n:
                    break
                v = int.from_bytes(data[i * nb:(i + 1) * nb], "little")
                if v < f.q:
                    out.append(v)
        return f.encode(np.array(out, dtype=object))

    def squeeze_ring_element(self, ring, form: str = "coeff"):
        """One uniform ring element (coeff or ntt form storage)."""
        vals = self.squeeze_field_elements(ring.field, ring.D)
        return vals.reshape((ring.D,) + ring.field.limb_shape)
