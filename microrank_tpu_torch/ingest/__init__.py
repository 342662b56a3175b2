"""Span admission on the interned table and its dead-letter store
(counterpart of ``microrank_tpu/ingest``: ``admit_table`` and the
quarantine store are ported)."""

from .quarantine import (
    QUARANTINE_NAME,
    REASONS,
    QuarantineStore,
    configure_quarantine,
    get_quarantine,
)
from .table_admission import admit_table

__all__ = [
    "QUARANTINE_NAME",
    "REASONS",
    "QuarantineStore",
    "admit_table",
    "configure_quarantine",
    "get_quarantine",
]
