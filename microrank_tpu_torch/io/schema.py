"""The input span-data contract (counterpart of
``microrank_tpu/io/schema.py``): the ClickHouse export's column names,
their canonical renames, and the columns a span record must carry. The
C++ loader applies the same rename while it reads a CSV; serve's inline
records (``serve.protocol.spans_to_table``) go through it here."""

from __future__ import annotations

from typing import Dict, List

# ClickHouse export column -> canonical column (reference
# online_rca.py:222-232).
CLICKHOUSE_RENAME: Dict[str, str] = {
    "TraceId": "traceID",
    "SpanId": "spanID",
    "ServiceName": "serviceName",
    "SpanName": "operationName",
    "PodName": "podName",
    "Duration": "duration",
    "TraceStart": "startTime",
    "TraceEnd": "endTime",
}

# Canonical columns a span record needs after the rename.
REQUIRED_COLUMNS: List[str] = [
    "traceID",
    "spanID",
    "ParentSpanId",
    "operationName",
    "serviceName",
    "podName",
    "duration",   # microseconds
    "startTime",  # trace-level start
    "endTime",    # trace-level end
]

# Services whose operation names lose their last '/'-segment (the
# loader's default, reference preprocess_data.py:27-31).
DEFAULT_STRIP_LAST_SEGMENT_SERVICES = frozenset({"ts-ui-dashboard"})


def validate_columns(columns) -> None:
    missing = [c for c in REQUIRED_COLUMNS if c not in set(columns)]
    if missing:
        raise ValueError(
            f"span DataFrame is missing required columns {missing}; "
            f"expected the contract {REQUIRED_COLUMNS} "
            "(ClickHouse export names are renamed as the loader renames them)"
        )
