"""Wire protocol of the online RCA service (counterpart of
``microrank_tpu/serve/protocol.py``).

One request is one detection window, in one of two forms:

* inline spans: ``{"spans": [{span record}, ...]}``, canonical column
  names or the ClickHouse export's (renamed as the loader renames them);
* a staged dataset: ``{"dataset": "name", "start": ..., "end": ...}``,
  a dump the server loaded at startup (``--dataset NAME=CSV``), cut to
  the requested time range.

Either form may carry ``tenant`` (the fair-dequeue key, default
"default"), ``request_id`` (echoed; generated when absent),
``deadline_ms`` (past it a queued request expires with 504) and
``explain: true`` (the response's ``explain`` field carries the
window's explain bundle, from one explained program after the batch).
The response is the window's ``WindowResult`` as JSON, with
``degraded: true`` when the answer came from the numpy_ref oracle.

Tracing: a W3C ``traceparent`` header joins the request's spans to the
caller's trace; the response carries a ``Server-Timing`` header of the
request's stage timings.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..pipeline.results import WindowResult

_req_counter = itertools.count(1)

# A timestamp that does not parse, as the C++ loader marks it.
NAT_US = int(np.iinfo(np.int64).min)


class ProtocolError(ValueError):
    """Malformed request: HTTP 400."""

    status = 400


class AdmissionError(ProtocolError):
    """The request parsed, but span admission rejected every row: HTTP
    422 with the per-reason counts. A request with some clean rows never
    raises: it ranks on the clean subset."""

    status = 422

    def __init__(self, rejected: dict):
        self.rejected = dict(rejected)
        detail = ", ".join(f"{k}={v}" for k, v in sorted(self.rejected.items()))
        super().__init__(
            f"no span rows survived admission ({detail}); see the "
            "dead-letter store (quarantine.jsonl) for the rows"
        )


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_ms`` elapsed before its window staged:
    the service expires it (504) instead of ranking for nobody."""

    status = 504


@dataclass
class RankRequest:
    request_id: str
    tenant: str = "default"
    spans: Optional[List[dict]] = None
    dataset: Optional[str] = None
    start: Optional[str] = None
    end: Optional[str] = None
    # Rank provenance: build and return an explain bundle.
    explain: bool = False
    # Milliseconds from admission after which the request expires (504)
    # at the next scheduling point.
    deadline_ms: Optional[float] = None
    # The caller's W3C trace context: (trace_id, parent_span_id) or None.
    traceparent: Optional[Tuple[str, str]] = None


_TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """A W3C ``traceparent`` header (version-traceid-spanid-flags) as
    (trace_id, parent_span_id); malformed or all-zero ids give None (the
    spec says ignore, never reject)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if not m:
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """Native tracer ids as a ``traceparent`` header value: a trace id
    that is not 32 hex digits is hashed (md5, the same on every host),
    a span id keeps its hex digits, zero-padded."""
    import hashlib

    t = str(trace_id).lower()
    if not re.fullmatch(r"[0-9a-f]{32}", t):
        t = hashlib.md5(str(trace_id).encode()).hexdigest()
    s = re.sub(r"[^0-9a-f]", "", str(span_id).lower())[-16:].rjust(16, "0")
    if s == "0" * 16:
        s = "0" * 15 + "1"
    return f"00-{t}-{s}-01"


def parse_rank_request(body: bytes, traceparent: Optional[str] = None) -> RankRequest:
    """Parse and validate one POST /rank body (and the caller's
    ``traceparent`` header)."""
    try:
        data = json.loads(body or b"")
    except json.JSONDecodeError as e:
        raise ProtocolError(f"request body is not JSON: {e}") from None
    if not isinstance(data, dict):
        raise ProtocolError("request body must be a JSON object")
    spans = data.get("spans")
    dataset = data.get("dataset")
    if (spans is None) == (dataset is None):
        raise ProtocolError(
            'provide exactly one of "spans" (inline span records) or '
            '"dataset" (a pre-staged dump name)'
        )
    if spans is not None:
        if not isinstance(spans, list) or not spans:
            raise ProtocolError('"spans" must be a non-empty list')
        if not all(isinstance(s, dict) for s in spans):
            raise ProtocolError('"spans" entries must be objects')
    tenant = str(data.get("tenant") or "default")
    request_id = str(data.get("request_id") or f"req-{next(_req_counter)}")
    deadline_ms = data.get("deadline_ms")
    if deadline_ms is not None:
        try:
            deadline_ms = float(deadline_ms)
        except (TypeError, ValueError):
            raise ProtocolError(f'"deadline_ms" must be a number, got {deadline_ms!r}') from None
        if deadline_ms <= 0:
            raise ProtocolError('"deadline_ms" must be > 0')
    return RankRequest(
        request_id=request_id,
        tenant=tenant,
        spans=spans,
        dataset=dataset,
        start=data.get("start"),
        end=data.get("end"),
        explain=bool(data.get("explain", False)),
        deadline_ms=deadline_ms,
        traceparent=parse_traceparent(traceparent),
    )


# ------------------------------------------------------------- records

_DIGITS = frozenset("0123456789")
_DIGIT_POS = (0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18)


def _days_from_civil(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def parse_datetime_us(value) -> int:
    """One timestamp as epoch microseconds, by the C++ loader's rule
    ("YYYY-MM-DD HH:MM:SS[.frac]", 'T' or any separator, up to six
    fraction digits, a suffix ignored); a JSON number is epoch
    nanoseconds, as pandas reads one. ``NAT_US`` when it does not
    parse."""
    if isinstance(value, bool) or value is None:
        return NAT_US
    if isinstance(value, (int, np.integer)):
        return int(value) // 1000
    if isinstance(value, (float, np.floating)):
        return int(value) // 1000 if math.isfinite(value) else NAT_US
    s = str(value)
    if len(s) < 19 or any(s[i] not in _DIGITS for i in _DIGIT_POS):
        return NAT_US
    y, mo, d = int(s[0:4]), int(s[5:7]), int(s[8:10])
    h, mi, se = int(s[11:13]), int(s[14:16]), int(s[17:19])
    us = (_days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + se) * 1_000_000
    if len(s) > 20 and s[19] == ".":
        frac = ""
        for c in s[20:26]:
            if c not in _DIGITS:
                break
            frac += c
        us += int(frac.ljust(6, "0")) if frac else 0
    return us


def _parse_int(value) -> int:
    """A duration as the C++ loader reads its field: the leading signed
    digits of the text (0 when there are none)."""
    if isinstance(value, bool) or value is None:
        return 0
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        return int(value) if math.isfinite(value) else 0
    m = re.match(r"\s*([+-]?\d+)", str(value))
    return int(m.group(1)) if m else 0


def _text(value) -> str:
    """A name field's text (None and NaN are empty, as an empty CSV
    field)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def timestamp_str(us: int) -> str:
    """Epoch microseconds as pandas prints a Timestamp
    ("YYYY-MM-DD HH:MM:SS[.ffffff]"), the form JAX's serve answers
    with."""
    s = str(np.datetime64(int(us), "us")).replace("T", " ")
    return s[:-7] if s.endswith(".000000") else s


def spans_to_table(spans: List[dict]):
    """Inline span records -> the window's ``SpanTable``, as
    ``native.load_span_table`` would read the same rows from a CSV: the
    ClickHouse names renamed, the canonical columns required (a missing
    one is a ``ProtocolError``), names interned with the loader's rules
    (traces in first appearance, ops in name order, the loader's default
    strip rule), a span's parent the last row carrying its
    ``ParentSpanId`` as span id, rows then sorted by start (stable).

    A timestamp that does not parse does not abort the request: its row
    keeps ``NAT_US`` and admission (``admit_table(...,
    reject_unparsed=True)``) sends it to the dead-letter store."""
    from ..io.schema import (
        CLICKHOUSE_RENAME,
        DEFAULT_STRIP_LAST_SEGMENT_SERVICES,
        validate_columns,
    )
    from ..native import SpanTable, sort_table_by_time

    strip = DEFAULT_STRIP_LAST_SEGMENT_SERVICES
    rows = [{CLICKHOUSE_RENAME.get(k, k): v for k, v in rec.items()} for rec in spans]
    columns = dict.fromkeys(k for rec in rows for k in rec)
    try:
        validate_columns(columns)
    except ValueError as e:
        raise ProtocolError(str(e)) from None

    def col(name):
        return [_text(rec.get(name)) for rec in rows]

    svc, op, pod = col("serviceName"), col("operationName"), col("podName")
    op_eff = [o.rsplit("/", 1)[0] if sv in strip and "/" in o else o
              for sv, o in zip(svc, op)]

    def intern(names, by_name):
        index, codes = {}, []
        for name in names:
            codes.append(index.setdefault(name, len(index)))
        vocab = list(index)
        codes = np.asarray(codes, dtype=np.int32)
        if by_name and len(vocab) > 1:
            perm = sorted(range(len(vocab)), key=vocab.__getitem__)
            inv = np.empty(len(vocab), dtype=np.int32)
            inv[np.asarray(perm)] = np.arange(len(vocab), dtype=np.int32)
            codes, vocab = inv[codes], [vocab[i] for i in perm]
        return codes, vocab

    trace_id, trace_names = intern(col("traceID"), False)
    svc_op, svc_names = intern([f"{a}_{b}" for a, b in zip(svc, op_eff)], True)
    pod_op, pod_names = intern([f"{a}_{b}" for a, b in zip(pod, op_eff)], True)
    span_row = {sp: i for i, sp in enumerate(col("spanID"))}
    parent_row = np.asarray([span_row.get(pa, -1) if pa else -1 for pa in col("ParentSpanId")],
                            dtype=np.int64)
    table = SpanTable(
        trace_id=trace_id,
        svc_op=svc_op,
        pod_op=pod_op,
        duration_us=np.asarray([_parse_int(rec.get("duration")) for rec in rows], np.int64),
        start_us=np.asarray([parse_datetime_us(rec.get("startTime")) for rec in rows], np.int64),
        end_us=np.asarray([parse_datetime_us(rec.get("endTime")) for rec in rows], np.int64),
        parent_row=parent_row,
        trace_names=trace_names,
        svc_op_names=svc_names,
        pod_op_names=pod_names,
    )
    return sort_table_by_time(table)


def response_body(result: WindowResult) -> bytes:
    """One answered request -> the JSON response payload."""
    d = dataclasses.asdict(result)
    d["ranking"] = [[n, float(s)] for n, s in result.ranking]
    return json.dumps(d).encode()


def server_timing_header(timings: dict) -> Optional[str]:
    """A request's ``*_ms`` stage timings as a ``Server-Timing`` header
    value (``name;dur=millis``)."""
    parts = [
        f"{key[:-3]};dur={float(val):.3f}"
        for key, val in timings.items()
        if key.endswith("_ms")
    ]
    return ", ".join(parts) or None


def error_body(message: str, **extra) -> bytes:
    return json.dumps({"error": message, **extra}).encode()
