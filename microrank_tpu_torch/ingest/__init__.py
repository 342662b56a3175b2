"""Span admission on the interned table (counterpart of
``microrank_tpu/ingest``; only ``admit_table`` is ported)."""

from .table_admission import admit_table

__all__ = ["admit_table"]
