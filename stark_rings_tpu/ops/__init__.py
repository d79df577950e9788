"""Derived kernel tables and generic ops: CRT stage tables, large-degree
NTTs, the int8 digit-plane engines, and the batch-trailing model
multiply."""

from .model_mul import TModelMul
from .ntt import NTTContext, find_primitive_root, get_ntt
from .stages import StageTable, derive_linear_table, derive_stage_tables

__all__ = ["StageTable", "derive_linear_table", "derive_stage_tables",
           "NTTContext", "get_ntt", "find_primitive_root", "TModelMul"]
