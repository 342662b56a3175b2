"""Segment codec: window records <-> dictionary-compressed ``.npz``
(counterpart of ``microrank_tpu/warehouse/segment.py``, the same file
layout: ``w<i>_``-prefixed members, one JSON ``meta`` member, no pickle).

One segment holds one or more window records. Each stores:

* the admitted span table, columnar, in JAX's frame codec
  (``col_<name>`` members, ``dict_<name>`` dictionaries, the
  ``columns`` / ``rows`` meta keys and its ``dict`` / ``int`` /
  ``datetime`` encodings). The port's table has no span ids: it writes
  ``traceID``, ``svc_op`` and ``pod_op`` as dictionary codes into the
  table's own name lists (traces in first appearance, ops in name
  order), ``duration``, ``startTime`` and ``endTime`` delta-encoded
  (``datetime64[us]``) and ``parent_row`` (the parent's row, -1 none).
  The reader takes JAX's frames too (``traceID``, ``spanID`` /
  ``ParentSpanId`` with their shared ``iddict``, ``serviceName``,
  ``operationName``, ``podName``, ...), interned with the loader's
  rules;
* for ranked windows, the packed rank blob (``rank_backends.blob``:
  the port's leaves at 256-byte offsets, JAX's at word offsets, the
  layout records either), its layout, the op names and the kernel:
  replay is a blob load, not a parse and a build;
* the detection context: the op vocab snapshot and the SLO baseline's
  mean and std (float32, bit-faithful), and the admission counters.

Writes go through tmp, fsync and rename: a torn segment never carries
a final name.
"""

from __future__ import annotations

import io
import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SEGMENT_SCHEMA = 1

# np.savez member names of one window record (prefixed ``w<i>_``).
_BLOB_KEY = "blob"
_OPS_KEY = "ops"
_VOCAB_KEY = "vocab"
_SLO_MEAN_KEY = "slo_mean"
_SLO_STD_KEY = "slo_std"
_IDDICT_KEY = "iddict"

# Columns sharing one id dictionary in JAX's frames (parents reference
# span ids).
_SHARED_ID_COLS = ("spanID", "ParentSpanId")


# ------------------------------------------------------------- table codec


def _delta(vals: np.ndarray) -> Tuple[np.ndarray, int]:
    vals = np.asarray(vals, dtype=np.int64)
    base = int(vals.min()) if vals.size else 0
    return vals - base, base


def encode_table(table) -> Tuple[Dict[str, np.ndarray], dict]:
    """Columnar-encode one window's ``SpanTable``; returns ``(arrays,
    frame_meta)`` with JAX's member names and meta keys (see the module
    doc). No string is touched: the codes are the table's own."""
    arrays: Dict[str, np.ndarray] = {}
    cols: List[dict] = []
    for name, codes, names in (("traceID", table.trace_id, table.trace_names),
                               ("svc_op", table.svc_op, table.svc_op_names),
                               ("pod_op", table.pod_op, table.pod_op_names)):
        arrays[f"dict_{name}"] = np.asarray(list(names), dtype=str)
        arrays[f"col_{name}"] = np.asarray(codes, dtype=np.int32)
        cols.append({"name": name, "dtype": "object", "enc": "dict"})
    for name, vals, dtype, enc in (("duration", table.duration_us, "int64", "int"),
                                   ("startTime", table.start_us, "datetime64[us]", "datetime"),
                                   ("endTime", table.end_us, "datetime64[us]", "datetime"),
                                   ("parent_row", table.parent_row, "int64", "int")):
        arrays[f"col_{name}"], base = _delta(vals)
        cols.append({"name": name, "dtype": dtype, "enc": enc, "base": base})
    return arrays, {"columns": cols, "rows": int(table.n_spans)}


def _lut(arrays, key) -> np.ndarray:
    """Dictionary -> object lookup table, code -1 (null) at the end."""
    uniq = arrays[key]
    lut = np.empty(len(uniq) + 1, dtype=object)
    if len(uniq):
        lut[:-1] = [str(u) for u in uniq]
    lut[-1] = None
    return lut


def _us(raw: np.ndarray, meta: dict) -> np.ndarray:
    """A ``datetime`` (or ``int``) column as epoch microseconds."""
    vals = raw.astype(np.int64) + int(meta.get("base", 0))
    dtype = str(meta.get("dtype", "int64"))
    if dtype.startswith("datetime64"):
        return vals.view(dtype).astype("datetime64[us]").astype(np.int64)
    return vals


def _intern(values: np.ndarray, by_name: bool) -> Tuple[np.ndarray, List[str]]:
    """Codes and names of a string column: names in first appearance,
    or in name order with ``by_name`` (the loader's rules)."""
    uniq, first, inv = np.unique(values.astype(str), return_index=True, return_inverse=True)
    if by_name:
        return inv.astype(np.int32), [str(u) for u in uniq]
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    return rank[inv], [str(uniq[i]) for i in order]


def decode_table(arrays: Dict[str, np.ndarray], frame_meta: dict):
    """Inverse of :func:`encode_table` (exact), and the reader of JAX's
    frames: the same ``SpanTable`` the loader would make of the rows."""
    from ..native import SpanTable

    metas = {m["name"]: m for m in frame_meta["columns"]}
    if "svc_op" in metas:
        def names(c):
            return [str(x) for x in arrays[f"dict_{c}"]]

        ints = {c: _us(arrays[f"col_{c}"], metas[c])
                for c in ("duration", "startTime", "endTime", "parent_row")}
        start = ints["startTime"]
        return SpanTable(
            trace_id=arrays["col_traceID"].astype(np.int32),
            svc_op=arrays["col_svc_op"].astype(np.int32),
            pod_op=arrays["col_pod_op"].astype(np.int32),
            duration_us=ints["duration"], start_us=start, end_us=ints["endTime"],
            parent_row=ints["parent_row"], trace_names=names("traceID"),
            svc_op_names=names("svc_op"), pod_op_names=names("pod_op"),
            time_sorted=bool(np.all(start[1:] >= start[:-1])),
        )
    return _decode_jax_frame(arrays, metas, int(frame_meta.get("rows", 0)))


def _decode_jax_frame(arrays, metas, n_rows: int):
    """A JAX frame record -> ``SpanTable``: svc_op ``service_operation``
    and pod_op ``pod_operation`` (the last path segment stripped for the
    loader's strip services), a span's parent the last row carrying its
    ``ParentSpanId`` as span id, rows kept in the record's order."""
    from ..io.schema import DEFAULT_STRIP_LAST_SEGMENT_SERVICES
    from ..native import SpanTable

    luts: Dict[str, np.ndarray] = {}

    def text(c):
        m = metas[c]
        key = _IDDICT_KEY if m["enc"] == "dict_shared" else f"dict_{c}"
        if key not in luts:
            luts[key] = _lut(arrays, key)
        return luts[key][arrays[f"col_{c}"]]

    svc, op, pod = text("serviceName"), text("operationName"), text("podName")
    strip = DEFAULT_STRIP_LAST_SEGMENT_SERVICES
    op_eff = np.asarray([o.rsplit("/", 1)[0] if s in strip and "/" in o else o
                         for s, o in zip(svc, op)], dtype=object)
    trace_id, trace_names = _intern(text("traceID"), False)
    svc_op, svc_names = _intern(np.char.add(np.char.add(svc.astype(str), "_"),
                                            op_eff.astype(str)), True)
    pod_op, pod_names = _intern(np.char.add(np.char.add(pod.astype(str), "_"),
                                            op_eff.astype(str)), True)
    span_codes = arrays["col_spanID"]
    parent_codes = arrays["col_ParentSpanId"]
    last_row = np.full(len(arrays[_IDDICT_KEY]) + 1, -1, dtype=np.int64)
    last_row[span_codes] = np.arange(span_codes.size, dtype=np.int64)
    last_row[-1] = -1
    parent_row = last_row[parent_codes]
    start = _us(arrays["col_startTime"], metas["startTime"])
    return SpanTable(
        trace_id=trace_id, svc_op=svc_op, pod_op=pod_op,
        duration_us=_us(arrays["col_duration"], metas["duration"]),
        start_us=start, end_us=_us(arrays["col_endTime"], metas["endTime"]),
        parent_row=parent_row, trace_names=trace_names, svc_op_names=svc_names,
        pod_op_names=pod_names, time_sorted=bool(np.all(start[1:] >= start[:-1])),
    )


# -------------------------------------------------------------- blob codec


def unpack_graph_blob_host(blob: np.ndarray, layout):
    """Host mirror of ``rank_backends.blob.unpack_graph_blob``: the
    WindowGraph of a stored blob as numpy views (4-byte dtypes) and byte
    slices (sub-word dtypes) at the layout's word offsets (the port's
    256-byte ones or JAX's): bit-exact, so the same programs give the
    live scores again. Leaves the port's graph does not have (JAX's
    ``cov_i8``) are not read."""
    from ..graph.structures import PartitionGraph, WindowGraph

    u8 = np.ascontiguousarray(blob, dtype=np.uint32).view(np.uint8)
    parts = []
    for entries in layout[:2]:
        leaves = {}
        for f, dtype_str, shape, off, n_words in entries:
            n = int(math.prod(shape)) if shape else 1
            b = u8[off * 4:(off + n_words) * 4]
            if dtype_str in ("float32", "int32"):
                leaf = b.view(dtype_str)[:n].reshape(shape)
            elif dtype_str == "bool":
                leaf = (b[:n] != 0).reshape(shape)
            elif dtype_str == "int8":
                leaf = b[:n].view(np.int8).reshape(shape)
            elif dtype_str == "uint8":
                leaf = b[:n].reshape(shape)
            else:
                raise TypeError(f"warehouse blob: unsupported leaf dtype {dtype_str!r}")
            leaves[f] = leaf
        # A JAX blob may carry leaves no port kernel reads (``cov_i8``).
        parts.append(PartitionGraph(**{f: v for f, v in leaves.items()
                                       if f in PartitionGraph._fields}))
    return WindowGraph(normal=parts[0], abnormal=parts[1])


def layout_to_json(layout) -> list:
    return [[[f, d, list(s), int(o), int(n)] for f, d, s, o, n in part] for part in layout]


def layout_from_json(data) -> tuple:
    return tuple(tuple((str(f), str(d), tuple(int(x) for x in s), int(o), int(n))
                       for f, d, s, o, n in part) for part in data)


# ---------------------------------------------------------- window records


@dataclass
class StoredWindow:
    """One window read back from a segment: its meta and its arrays
    (prefix stripped); the table and the graph are built on demand."""

    meta: dict
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    segment: str = ""

    @property
    def start_us(self) -> int:
        return int(self.meta["start_us"])

    @property
    def end_us(self) -> int:
        return int(self.meta["end_us"])

    @property
    def outcome(self) -> str:
        return str(self.meta.get("outcome", ""))

    @property
    def ranking(self) -> list:
        return [(str(n), float(s)) for n, s in self.meta.get("ranking") or []]

    @property
    def kernel(self) -> Optional[str]:
        return self.meta.get("kernel")

    @property
    def op_names(self) -> Optional[List[str]]:
        ops = self.arrays.get(_OPS_KEY)
        return None if ops is None else [str(o) for o in ops]

    @property
    def vocab_names(self) -> Optional[List[str]]:
        v = self.arrays.get(_VOCAB_KEY)
        return None if v is None else [str(n) for n in v]

    def slo_baseline(self):
        """The stored SLO snapshot (float32, bit-faithful), or None for a
        window before detection armed."""
        mean = self.arrays.get(_SLO_MEAN_KEY)
        if mean is None:
            return None
        from ..graph.structures import SloBaseline

        return SloBaseline(mean_ms=np.asarray(mean, np.float32),
                           std_ms=np.asarray(self.arrays[_SLO_STD_KEY], np.float32))

    def table(self):
        """The admitted span table, or None when spans were not stored."""
        fm = self.meta.get("frame")
        return None if fm is None else decode_table(self.arrays, fm)

    def graph(self):
        """The rank-ready host WindowGraph of the stored blob, or None
        (no blob: not ranked, or blobs off)."""
        blob = self.arrays.get(_BLOB_KEY)
        if blob is None or self.meta.get("layout") is None:
            return None
        return unpack_graph_blob_host(blob, layout_from_json(self.meta["layout"]))


def encode_window(rec: dict) -> Tuple[Dict[str, np.ndarray], dict]:
    """One hot-tier record (``store.TraceWarehouse.observe``) -> (arrays,
    per-window meta)."""
    arrays: Dict[str, np.ndarray] = {}
    meta = dict(rec["meta"])
    meta["schema"] = SEGMENT_SCHEMA
    table = rec.get("table")
    if table is not None:
        t_arrays, t_meta = encode_table(table)
        arrays.update(t_arrays)
        meta["frame"] = t_meta
    graph_pack = rec.get("graph_pack")
    if graph_pack is not None:
        blob, layout, op_names = graph_pack
        arrays[_BLOB_KEY] = np.asarray(blob, np.uint32)
        arrays[_OPS_KEY] = np.asarray(list(op_names), dtype=str)
        meta["layout"] = layout_to_json(layout)
    snapshot = rec.get("snapshot")
    if snapshot is not None:
        vocab, slo = snapshot
        names = vocab.names if hasattr(vocab, "names") else list(vocab)
        arrays[_VOCAB_KEY] = np.asarray(list(names), dtype=str)
        arrays[_SLO_MEAN_KEY] = np.asarray(slo.mean_ms, np.float32)
        arrays[_SLO_STD_KEY] = np.asarray(slo.std_ms, np.float32)
    return arrays, meta


# ------------------------------------------------------------ segment file


def write_segment(path, windows: List[Tuple[Dict[str, np.ndarray], dict]]) -> int:
    """Write one segment (encoded windows) atomically: tmp, fsync,
    rename, then a directory fsync. Returns the bytes written."""
    from ..utils.atomic import _fsync_dir

    path = Path(path)
    arrays: Dict[str, np.ndarray] = {}
    metas = []
    for i, (w_arrays, w_meta) in enumerate(windows):
        for k, v in w_arrays.items():
            arrays[f"w{i}_{k}"] = v
        metas.append(w_meta)
    doc = {"schema": SEGMENT_SCHEMA, "windows": metas}
    arrays["meta"] = np.frombuffer(json.dumps(doc).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    data = buf.getvalue()
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return len(data)


def read_segment_meta(path) -> dict:
    """The segment's JSON meta (its windows) without the column arrays.
    Raises on a torn or unreadable file."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["meta"]).decode("utf-8"))


def load_segment(path) -> List[StoredWindow]:
    """Every window record of one segment."""
    path = Path(path)
    out: List[StoredWindow] = []
    with np.load(path, allow_pickle=False) as z:
        doc = json.loads(bytes(z["meta"]).decode("utf-8"))
        for i, meta in enumerate(doc["windows"]):
            prefix = f"w{i}_"
            arrays = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
            out.append(StoredWindow(meta=meta, arrays=arrays, segment=path.name))
    return out
