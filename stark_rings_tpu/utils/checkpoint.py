"""Checkpoint/resume helpers.

The reference has no checkpointing (SURVEY.md §5) — its capability is
"everything is CanonicalSerialize".  Long-running benchmark/prover
loops want more: whole-pytree snapshots of ring tensors.  Storage is the
raw canonical uint arrays (portable: independent of Montgomery factors,
which are re-derived from the field name on load)."""

from __future__ import annotations

import json
import pathlib

import numpy as np

import jax

from ..fields import get_field

__all__ = ["save_tensors", "load_tensors"]


def save_tensors(path, field_name: str, **tensors):
    """Save named storage tensors (canonical values) to one .npz."""
    f = get_field(field_name)
    out = {}
    for k, v in tensors.items():
        arr = np.asarray(jax.device_get(f.canon(v)))
        out[k] = arr
    path = pathlib.Path(path)
    np.savez(path, __field__=np.array(field_name), **out)
    return path


def load_tensors(path):
    """Load -> (field_name, dict of storage tensors (device-ready))."""
    data = np.load(path, allow_pickle=False)
    field_name = str(data["__field__"])
    f = get_field(field_name)
    out = {}
    for k in data.files:
        if k == "__field__":
            continue
        out[k] = f.from_canon(data[k])
    return field_name, out
