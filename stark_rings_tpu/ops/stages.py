"""Linear-stage tables: the CRT/ICRT butterfly dataflow as data.

Every stage of the reference's CRT kernels (butterfly layers, slot
isomorphisms, homogenize/dehomogenize — e.g. goldilocks/ntt.rs:135-437) is a
linear map over Fq^D in which each output coefficient depends on **at most
two** inputs:

    y[i] = A[i] * x[p[i]]  +  B[i] * x[s[i]]

We derive ``(p, A, s, B)`` for each stage by probing the integer-exact spec
(`stark_rings_tpu.spec`) with basis vectors, then apply stages on device as
two gathers + two modular muls + one add — fully vectorized over the
coefficient axis and any batch axes.  This keeps the whole CRT a fixed
chain of elementwise ops with no scalar loops.

The same representation also covers the ``reduce_in_place`` fold (which has
up to three terms — handled by the generalized T-term table).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np

from ..fields import Field
from ..spec import SpecModel

__all__ = ["StageTable", "derive_stage_tables", "derive_linear_table"]


@dataclass
class StageTable:
    """T-term sparse linear map y[i] = sum_t coeff[t][i] * x[idx[t][i]]."""

    idx: List[np.ndarray]      # each int32[D_out]
    coeff: List                # each storage[D_out(, limbs)]
    field: Field

    def __call__(self, x):
        f = self.field
        acc = None
        for p, a in zip(self.idx, self.coeff):
            term = f.mul(a, f.take_coeff(x, p))
            acc = term if acc is None else f.add(acc, term)
        return acc


def _probe_matrix(fn: Callable[[List[int]], None], d_in: int, d_out: int,
                  q: int) -> List[dict]:
    """Probe an in-place linear spec function with basis vectors.

    Returns per-row dicts {col: coeff} of the d_out x d_in matrix.
    """
    rows: List[dict] = [dict() for _ in range(d_out)]
    for j in range(d_in):
        c = [0] * d_in
        c[j] = 1
        fn(c)
        assert len(c) >= d_out
        for i in range(d_out):
            if c[i] % q:
                rows[i][j] = c[i] % q
    return rows


def _rows_to_table(rows: Sequence[dict], field: Field,
                   max_terms: int) -> StageTable:
    T = max((len(r) for r in rows), default=1)
    assert T <= max_terms, f"stage has {T}-term rows, expected <= {max_terms}"
    T = max(T, 1)
    d_out = len(rows)
    idx = [np.zeros(d_out, dtype=np.int32) for _ in range(T)]
    coeff_ints = [np.zeros(d_out, dtype=object) for _ in range(T)]
    for i, r in enumerate(rows):
        for t, (j, a) in enumerate(sorted(r.items())):
            idx[t][i] = j
            coeff_ints[t][i] = a
    coeff = [field.encode(c) for c in coeff_ints]
    return StageTable(idx=idx, coeff=coeff, field=field)


def derive_linear_table(fn: Callable[[List[int]], None], d_in: int,
                        d_out: int, field: Field,
                        max_terms: int = 3) -> StageTable:
    """Derive a StageTable for any linear in-place spec function."""
    rows = _probe_matrix(fn, d_in, d_out, field.q)
    return _rows_to_table(rows, field, max_terms)


def derive_stage_tables(model: SpecModel, field: Field):
    """(crt_stages, icrt_stages) as lists of StageTable for a spec model."""
    assert field.q == model.q
    crt = [derive_linear_table(s, model.D, model.D, field, max_terms=2)
           for s in model.crt_stages]
    icrt = [derive_linear_table(s, model.D, model.D, field, max_terms=2)
            for s in model.icrt_stages]
    return crt, icrt
