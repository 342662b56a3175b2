"""Native (C++) span loader, window detector and graph builder, bound
with ctypes (counterpart of ``microrank_tpu/native/__init__.py``).

The three C++ sources are verbatim copies of the JAX package's. The
library ``libmrspan.so`` builds with ``g++`` at first use into
``microrank_tpu_torch/_build/`` and exposes:

* ``load_span_table(path)`` — mmap CSV ingest to a ``SpanTable`` of
  interned numpy arrays;
* ``detect_window_native(...)`` — the fused one-scan window detector;
* ``build_window_padded(...)`` — both partitions' COO graphs, built in
  fused counting sorts and exported into padded numpy buffers, with the
  coverage / call-edge bitmaps (``mr_export_bitmaps``), the kind views
  or the partition-centric views when the auxiliary-view mode asks for
  them.

The auxiliary-view modes ``"none"`` (the pallas, coo and dense
kernels), ``"packed"``, ``"kind"``, ``"pcsr"``, ``"csr"`` (the CSR
views of the csr kernel, ``mr_export_csr``), ``"all"`` (bitmaps, CSR
and partition-centric views) and ``"auto"`` are supported; ``"auto_all"``
is the mesh's mode and raises ``NotImplementedError`` until the mesh is
ported (ROADMAP.md's port queue, item 12).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import zipfile
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output

_SRCS = [
    Path(__file__).parent / "span_loader.cpp",
    Path(__file__).parent / "graph_builder.cpp",
    Path(__file__).parent / "detector.cpp",
]
LIB_PATH = BUILD_DIR / "libmrspan.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


class SpanTable(NamedTuple):
    """One CSV dump, fully interned.

    Times are epoch microseconds (trace-level start/end, as in the CSV
    contract); ``parent_row`` is the row index of each span's parent
    (-1 when absent).
    """

    trace_id: np.ndarray     # int32[S]
    svc_op: np.ndarray       # int32[S] service-level op (detector vocab)
    pod_op: np.ndarray       # int32[S] instance-level op (PageRank vocab)
    duration_us: np.ndarray  # int64[S]
    start_us: np.ndarray     # int64[S]
    end_us: np.ndarray       # int64[S]
    parent_row: np.ndarray   # int64[S]
    trace_names: List[str]
    svc_op_names: List[str]
    pod_op_names: List[str]
    # Rows sorted by start_us ascending (sort_table_by_time), so a
    # window's rows are one searchsorted range.
    time_sorted: bool = False

    @property
    def n_spans(self) -> int:
        return int(self.trace_id.shape[0])


class _MrSpanTable(ctypes.Structure):
    _fields_ = [
        ("n_spans", ctypes.c_int64),
        ("trace_id", ctypes.POINTER(ctypes.c_int32)),
        ("svc_op", ctypes.POINTER(ctypes.c_int32)),
        ("pod_op", ctypes.POINTER(ctypes.c_int32)),
        ("duration_us", ctypes.POINTER(ctypes.c_int64)),
        ("start_us", ctypes.POINTER(ctypes.c_int64)),
        ("end_us", ctypes.POINTER(ctypes.c_int64)),
        ("parent_row", ctypes.POINTER(ctypes.c_int64)),
        ("trace_blob", ctypes.c_char_p),
        ("trace_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_traces", ctypes.c_int64),
        ("svc_blob", ctypes.c_char_p),
        ("svc_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_svc_ops", ctypes.c_int64),
        ("pod_blob", ctypes.c_char_p),
        ("pod_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_pod_ops", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def build_command(out: Path) -> List[str]:
    """The g++ command that builds the library into ``out``."""
    return [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        *[str(s) for s in _SRCS], "-o", str(out),
    ]


def build_library() -> str:
    """Compile ``libmrspan.so`` from the package's sources if it is
    missing or older than them; returns the compiler's output."""
    if not is_stale(LIB_PATH, _SRCS):
        return ""
    tmp = tmp_output(LIB_PATH)
    return run_build(build_command(tmp), tmp, LIB_PATH)


def _load_library() -> ctypes.CDLL:
    global _lib
    # The window loop's stage worker may be the first caller while the
    # main thread also gets here: one thread builds and binds.
    with _lib_lock:
        if _lib is None:
            build_library()
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the library's C signatures."""
    lib.mr_load_csv.restype = ctypes.POINTER(_MrSpanTable)
    lib.mr_load_csv.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.mr_free_table.restype = None
    lib.mr_free_table.argtypes = [ctypes.POINTER(_MrSpanTable)]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mr_build_window2.restype = ctypes.c_void_p
    lib.mr_build_window2.argtypes = [
        i32p,            # pod_op
        i32p,            # trace_id
        i64p,            # parent_row
        ctypes.c_int64,  # n_rows
        u8p,             # row_mask (nullable)
        u8p,             # normal_flag
        u8p,             # abnormal_flag
        ctypes.c_int64,  # n_total_traces
        ctypes.c_int64,  # vocab_size
        ctypes.c_int32,  # collapse_mode (0 off / 1 auto / 2 on)
        ctypes.c_int64,  # parent_base (slice offset for parent_row)
    ]
    lib.mr_window_sizes.restype = None
    lib.mr_window_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.mr_export_partition.restype = None
    lib.mr_export_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        i32p, i32p, f32p, f32p,          # inc_op, inc_trace, sr, rs
        i32p, i32p, f32p,                # ss_child, ss_parent, ss_val
        i32p, i32p, i32p,                # kind, tracelen, local_uniques
        i32p, u8p,                       # cov_unique, op_present
    ]
    lib.mr_export_bitmaps.restype = None
    lib.mr_export_bitmaps.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        u8p, ctypes.c_int64,             # cov_bits, t8
        u8p, ctypes.c_int64,             # ss_bits, v8
        f32p, f32p, f32p,                # inv_len, inv_cov, inv_out
    ]
    lib.mr_export_csr.restype = None
    lib.mr_export_csr.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # vocab, v_pad, t_pad
        i32p, f32p,                      # tr_om, sr_om
        i32p, i32p, i32p,                # indptr_op, indptr_trace, ss_indptr
    ]
    lib.mr_collapse_window.restype = ctypes.c_int32
    lib.mr_collapse_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p
    ]
    lib.mr_export_columns.restype = ctypes.c_int64
    lib.mr_export_columns.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32p]
    lib.mr_free_built.restype = None
    lib.mr_free_built.argtypes = [ctypes.c_void_p]
    lib.mr_detect_window.restype = ctypes.c_int
    lib.mr_detect_window.argtypes = [
        ctypes.c_int64,   # n_spans
        i32p,             # trace_id
        i32p,             # svc_op
        i64p,             # duration_us
        i64p,             # start_us
        i64p,             # end_us
        ctypes.c_int64,   # w0_us
        ctypes.c_int64,   # w1_us
        i32p,             # remap
        ctypes.c_int64,   # n_svc_vocab
        f32p,             # thresh_ms
        ctypes.c_int64,   # n_slo_vocab
        ctypes.c_float,   # slack_ms
        ctypes.c_int64,   # n_traces_total
        u8p,              # mask out
        i32p,             # nrm out
        i32p,             # abn out
        i64p,             # counts out
    ]
    return lib


def _decode_vocab(blob: bytes, offsets, n: int) -> List[str]:
    offs = np.ctypeslib.as_array(offsets, shape=(n + 1,))
    return [
        blob[offs[i]: offs[i + 1]].decode("utf-8", "replace")
        for i in range(n)
    ]


def sort_table_by_time(table: SpanTable) -> SpanTable:
    """Reorder rows by ascending start_us (stable) and remap parent_row.
    Every consumer is row-order independent, so sorting changes no
    result; it makes window row ranges contiguous."""
    if table.time_sorted:
        return table
    start = table.start_us
    n = int(start.shape[0])
    if n == 0 or bool(np.all(start[1:] >= start[:-1])):
        return table._replace(time_sorted=True)
    order = np.argsort(start, kind="stable")
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    old_parent = table.parent_row[order]
    parent = np.where(
        old_parent >= 0, inv[np.clip(old_parent, 0, None)], -1
    )
    return table._replace(
        trace_id=np.ascontiguousarray(table.trace_id[order]),
        svc_op=np.ascontiguousarray(table.svc_op[order]),
        pod_op=np.ascontiguousarray(table.pod_op[order]),
        duration_us=np.ascontiguousarray(table.duration_us[order]),
        start_us=np.ascontiguousarray(start[order]),
        end_us=np.ascontiguousarray(table.end_us[order]),
        parent_row=np.ascontiguousarray(parent),
        time_sorted=True,
    )


def _sort_vocab(codes: np.ndarray, names: List[str]):
    """Remap one interned column onto the name-sorted vocab: the pod-op
    vocab index is the ranking's tie key, so it must order by name."""
    if len(names) <= 1:
        return codes, list(names)
    perm = sorted(range(len(names)), key=names.__getitem__)
    inv = np.empty(len(names), dtype=codes.dtype)
    inv[np.asarray(perm, dtype=np.int64)] = np.arange(
        len(names), dtype=codes.dtype
    )
    return inv[codes], [names[i] for i in perm]


# Sidecar cache of the interned arrays next to the CSV. Its own name
# (".mrt-torch-") keeps it apart from the JAX package's sidecars.
_SIDECAR_VERSION = 3


def _sidecar_path(path: Path, strip_services) -> Path:
    tag = hashlib.sha1(
        ",".join(sorted(strip_services)).encode()
    ).hexdigest()[:8]
    return path.with_suffix(path.suffix + f".mrt-torch-{tag}.npz")


def _load_sidecar(path: Path, side: Path) -> Optional[SpanTable]:
    try:
        st = path.stat()
        with np.load(side, allow_pickle=False) as z:
            if int(z["version"][0]) != _SIDECAR_VERSION:
                return None
            src = z["source_stat"]
            if int(src[0]) != st.st_mtime_ns or int(src[1]) != st.st_size:
                return None
            return SpanTable(
                trace_id=z["trace_id"],
                svc_op=z["svc_op"],
                pod_op=z["pod_op"],
                duration_us=z["duration_us"],
                start_us=z["start_us"],
                end_us=z["end_us"],
                parent_row=z["parent_row"],
                trace_names=[str(s) for s in z["trace_names"]],
                svc_op_names=[str(s) for s in z["svc_op_names"]],
                pod_op_names=[str(s) for s in z["pod_op_names"]],
                time_sorted=True,
            )
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def _save_sidecar(side: Path, source: Path, table: SpanTable) -> None:
    try:
        st = source.stat()
        tmp = side.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(
            tmp,
            version=np.array([_SIDECAR_VERSION]),
            source_stat=np.array([st.st_mtime_ns, st.st_size], dtype=np.int64),
            trace_id=table.trace_id,
            svc_op=table.svc_op,
            pod_op=table.pod_op,
            duration_us=table.duration_us,
            start_us=table.start_us,
            end_us=table.end_us,
            parent_row=table.parent_row,
            trace_names=np.array(table.trace_names, dtype=np.str_),
            svc_op_names=np.array(table.svc_op_names, dtype=np.str_),
            pod_op_names=np.array(table.pod_op_names, dtype=np.str_),
        )
        os.replace(tmp, side)
    except OSError:  # the cache is best-effort (read-only dirs, full disk)
        pass


def load_span_table(
    path, strip_services=("ts-ui-dashboard",), cache: bool = True
) -> SpanTable:
    """Load one traces.csv (raw ClickHouse export or canonical schema).

    With ``cache``, the interned arrays persist to an ``.npz`` sidecar
    next to the CSV and are reused while fresher than the CSV.
    """
    path = Path(path)
    side = _sidecar_path(path, strip_services)
    if cache:
        cached = _load_sidecar(path, side)
        if cached is not None:
            return cached
    lib = _load_library()
    res = lib.mr_load_csv(
        str(path).encode(), ",".join(strip_services).encode()
    )
    try:
        t = res.contents
        if t.error:
            raise ValueError(
                f"native loader failed for {path}: {t.error.decode()}"
            )
        n = int(t.n_spans)

        def arr(ptr, dtype):
            if n == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)

        svc_op, svc_names = _sort_vocab(
            arr(t.svc_op, np.int32),
            _decode_vocab(t.svc_blob, t.svc_offsets, int(t.n_svc_ops)),
        )
        pod_op, pod_names = _sort_vocab(
            arr(t.pod_op, np.int32),
            _decode_vocab(t.pod_blob, t.pod_offsets, int(t.n_pod_ops)),
        )
        table = sort_table_by_time(
            SpanTable(
                trace_id=arr(t.trace_id, np.int32),
                svc_op=svc_op,
                pod_op=pod_op,
                duration_us=arr(t.duration_us, np.int64),
                start_us=arr(t.start_us, np.int64),
                end_us=arr(t.end_us, np.int64),
                parent_row=arr(t.parent_row, np.int64),
                trace_names=_decode_vocab(
                    t.trace_blob, t.trace_offsets, int(t.n_traces)
                ),
                svc_op_names=svc_names,
                pod_op_names=pod_names,
            )
        )
        if cache:
            _save_sidecar(side, path, table)
        return table
    finally:
        lib.mr_free_table(res)


class PaddedPartition(NamedTuple):
    """One partition graph exported into buffers padded by the caller's
    policy. C++ fills the true-length prefix of each array; the padding
    keeps the allocation fill (zeros, or ones for kind/tracelen).
    ``local_uniques`` (global trace code per local trace) is exact-length.
    """

    inc_op: np.ndarray       # int32[e_pad]
    inc_trace: np.ndarray    # int32[e_pad]
    sr_val: np.ndarray       # float32[e_pad]
    rs_val: np.ndarray       # float32[e_pad]
    ss_child: np.ndarray     # int32[c_pad]
    ss_parent: np.ndarray    # int32[c_pad]
    ss_val: np.ndarray       # float32[c_pad]
    kind: np.ndarray         # int32[t_pad], padded with 1
    tracelen: np.ndarray     # int32[t_pad], padded with 1
    local_uniques: np.ndarray  # int32[n_traces]
    cov_unique: np.ndarray   # int32[v_pad]
    op_present: np.ndarray   # bool[v_pad]
    # Auxiliary views, filled per the resolved aux mode; unbuilt views
    # are [0]-shaped ([v_pad, 0] for bitmaps).
    inc_trace_opmajor: np.ndarray  # int32[e_pad] (csr)
    sr_val_opmajor: np.ndarray     # float32[e_pad] (csr)
    inc_indptr_op: np.ndarray      # int32[v_pad+1] (csr)
    inc_indptr_trace: np.ndarray   # int32[t_pad+1] (csr)
    ss_indptr: np.ndarray          # int32[v_pad+1] (csr, kind)
    cov_bits: np.ndarray           # uint8[v_pad, t_pad/8] (packed, kind)
    ss_bits: np.ndarray            # uint8[v_pad, v_pad/8] (packed, kind)
    inv_tracelen: np.ndarray       # float32[t_pad]
    inv_cov_dup: np.ndarray        # float32[v_pad]
    inv_outdeg: np.ndarray         # float32[v_pad]
    n_ops: int
    n_traces: int
    n_inc: int
    n_ss: int
    # -1 = per-trace layout; >= 0 = kind-collapsed into this many columns
    # while n_traces still counts true traces.
    n_cols: int = -1
    # Partition-centric views (kernel="pcsr"; graph.build.pcsr_auxiliary
    # over the exported trace-major entries).
    pc_trace: np.ndarray = np.zeros((1, 0), np.int32)
    pc_sr_val: np.ndarray = np.zeros((1, 0), np.float32)
    pc_blk_indptr: np.ndarray = np.zeros((1, 0), np.int32)
    pc_ell_op: np.ndarray = np.zeros((1, 0), np.int32)
    pc_ell_rs: np.ndarray = np.zeros((1, 0), np.float32)


def build_window_padded(
    pod_op: np.ndarray,
    trace_id: np.ndarray,
    parent_row: np.ndarray,
    row_mask: Optional[np.ndarray],
    normal_flag: np.ndarray,
    abnormal_flag: np.ndarray,
    vocab_size: int,
    v_pad: int,
    pad,
    mode: str = "none",
    collapse: str = "off",
    dense_budget_bytes: Optional[int] = None,
    parent_base: int = 0,
    kind_dedup_threshold: Optional[float] = None,
    retain_columns: bool = False,
) -> Tuple[PaddedPartition, PaddedPartition]:
    """Build both partitions' COO graphs in C++, exported directly into
    padded numpy buffers.

    ``normal_flag``/``abnormal_flag`` are bool arrays over the table's
    global trace codes; ``row_mask`` (bool over rows, or None) is the
    detection window; ``pad`` maps a true length to its padded length.
    ``mode`` is an aux mode: resolved ("none" | "packed" | "kind" |
    "pcsr" | "csr" | "all"), or, with ``collapse`` enabled, "auto",
    resolved here against
    the collapsed shapes and the measured dedup factor
    (``dense_budget_bytes`` and ``kind_dedup_threshold``; None takes
    graph.build's defaults).
    ``collapse`` ("off" | "auto" | "on") kind-collapses the trace axes
    inside the C++ build. ``parent_base`` is subtracted from each
    parent_row entry (callers pass a table slice plus its offset).
    ``retain_columns``: also return, per partition, the local trace
    index of each coverage column (``mr_export_columns``), as a third
    element ``(columns_normal, columns_abnormal)``.
    """
    if mode == "auto_all":
        raise NotImplementedError(
            "aux mode 'auto_all' is the mesh's (both view families for the "
            "per-shard kernel choice), which is not ported: ROADMAP.md's port "
            "queue, item 12"
        )
    if mode not in ("none", "packed", "kind", "pcsr", "csr", "all", "auto"):
        raise ValueError(f"unknown aux mode {mode!r}")
    if mode == "auto" and collapse == "off":
        raise ValueError(
            "aux mode 'auto' is resolved here only under collapse; "
            "resolve_aux it at the call site otherwise"
        )
    lib = _load_library()
    pod_op = np.ascontiguousarray(pod_op, dtype=np.int32)
    trace_id = np.ascontiguousarray(trace_id, dtype=np.int32)
    parent_row = np.ascontiguousarray(parent_row, dtype=np.int64)
    nf = np.ascontiguousarray(normal_flag, dtype=np.uint8)
    af = np.ascontiguousarray(abnormal_flag, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    if row_mask is None:
        mask_ptr = ctypes.cast(None, u8p)
    else:
        row_mask = np.ascontiguousarray(row_mask, dtype=np.uint8)
        mask_ptr = row_mask.ctypes.data_as(u8p)
    handle = lib.mr_build_window2(
        pod_op.ctypes.data_as(i32p),
        trace_id.ctypes.data_as(i32p),
        parent_row.ctypes.data_as(i64p),
        ctypes.c_int64(len(pod_op)),
        mask_ptr,
        nf.ctypes.data_as(u8p),
        af.ctypes.data_as(u8p),
        ctypes.c_int64(len(nf)),
        ctypes.c_int64(vocab_size),
        # The collapse happens inside the build, before the incidence
        # emit; mr_collapse_window below reports the true counts.
        ctypes.c_int32({"off": 0, "auto": 1, "on": 2}[collapse]),
        ctypes.c_int64(int(parent_base)),
    )
    if not handle:
        raise NativeUnavailable("mr_build_window2 allocation failed")
    try:
        true_traces = None
        if collapse != "off":
            true_out = np.zeros(2, dtype=np.int64)
            rc = int(
                lib.mr_collapse_window(
                    handle,
                    ctypes.c_int32(1 if collapse == "auto" else 0),
                    true_out.ctypes.data_as(i64p),
                )
            )
            if rc < 0:
                raise NativeUnavailable(
                    "mr_collapse_window allocation failed"
                )
            if rc == 1:
                true_traces = (int(true_out[0]), int(true_out[1]))
        sizes = np.zeros(8, dtype=np.int64)
        lib.mr_window_sizes(handle, sizes.ctypes.data_as(i64p))
        if mode == "auto":
            from ..graph.build import DEFAULT_KIND_DEDUP_THRESHOLD, resolve_aux

            t_pads = (pad(int(sizes[2])), pad(int(sizes[6])))
            # The collapse already ran, so the dedup factor (true traces
            # / kind columns) is known here.
            dedup = None
            if true_traces is not None:
                cols = int(sizes[2]) + int(sizes[6])
                dedup = float(sum(true_traces)) / float(max(cols, 1))
            mode = resolve_aux(
                mode, v_pad, t_pads,
                *(() if dense_budget_bytes is None else (dense_budget_bytes,)),
                dedup=dedup,
                kind_dedup_threshold=(
                    DEFAULT_KIND_DEDUP_THRESHOLD
                    if kind_dedup_threshold is None
                    else kind_dedup_threshold
                ),
            )
        want_bits = mode in ("packed", "kind", "all")
        want_csr = mode in ("csr", "all")
        want_pc = mode in ("pcsr", "all")
        out, columns = [], []
        for idx in range(2):
            n_inc, n_ss, n_tr, n_ops = (int(x) for x in sizes[4 * idx: 4 * idx + 4])
            true_tr = true_traces[idx] if true_traces is not None else n_tr
            e_pad, c_pad, t_pad = pad(n_inc), pad(n_ss), pad(n_tr)
            t8 = (t_pad + 7) // 8
            v8 = (v_pad + 7) // 8
            p = PaddedPartition(
                inc_op=np.zeros(e_pad, np.int32),
                inc_trace=np.zeros(e_pad, np.int32),
                sr_val=np.zeros(e_pad, np.float32),
                rs_val=np.zeros(e_pad, np.float32),
                ss_child=np.zeros(c_pad, np.int32),
                ss_parent=np.zeros(c_pad, np.int32),
                ss_val=np.zeros(c_pad, np.float32),
                kind=np.ones(t_pad, np.int32),
                tracelen=np.ones(t_pad, np.int32),
                local_uniques=np.zeros(true_tr, np.int32),
                cov_unique=np.zeros(v_pad, np.int32),
                op_present=np.zeros(v_pad, np.bool_),
                inc_trace_opmajor=np.zeros(e_pad if want_csr else 0, np.int32),
                sr_val_opmajor=np.zeros(e_pad if want_csr else 0, np.float32),
                inc_indptr_op=np.zeros(v_pad + 1 if want_csr else 0, np.int32),
                inc_indptr_trace=np.zeros(t_pad + 1 if want_csr else 0, np.int32),
                ss_indptr=np.zeros(v_pad + 1 if want_csr else 0, np.int32),
                cov_bits=np.zeros((v_pad, t8 if want_bits else 0), np.uint8),
                ss_bits=np.zeros((v_pad, v8 if want_bits else 0), np.uint8),
                inv_tracelen=np.zeros(t_pad, np.float32),
                inv_cov_dup=np.zeros(v_pad, np.float32),
                inv_outdeg=np.zeros(v_pad, np.float32),
                n_ops=n_ops,
                n_traces=true_tr,
                n_inc=n_inc,
                n_ss=n_ss,
                n_cols=(n_tr if true_traces is not None else -1),
            )
            lib.mr_export_partition(
                handle, ctypes.c_int32(idx),
                p.inc_op.ctypes.data_as(i32p),
                p.inc_trace.ctypes.data_as(i32p),
                p.sr_val.ctypes.data_as(f32p),
                p.rs_val.ctypes.data_as(f32p),
                p.ss_child.ctypes.data_as(i32p),
                p.ss_parent.ctypes.data_as(i32p),
                p.ss_val.ctypes.data_as(f32p),
                p.kind.ctypes.data_as(i32p),
                p.tracelen.ctypes.data_as(i32p),
                p.local_uniques.ctypes.data_as(i32p),
                p.cov_unique.ctypes.data_as(i32p),
                p.op_present.ctypes.data_as(u8p),
            )
            if want_bits:
                lib.mr_export_bitmaps(
                    handle, ctypes.c_int32(idx),
                    p.cov_bits.ctypes.data_as(u8p), ctypes.c_int64(t8),
                    p.ss_bits.ctypes.data_as(u8p), ctypes.c_int64(v8),
                    p.inv_tracelen.ctypes.data_as(f32p),
                    p.inv_cov_dup.ctypes.data_as(f32p),
                    p.inv_outdeg.ctypes.data_as(f32p),
                )
            else:
                p.inv_tracelen[p.inc_trace[:n_inc]] = p.sr_val[:n_inc]
                p.inv_cov_dup[p.inc_op[:n_inc]] = p.rs_val[:n_inc]
                p.inv_outdeg[p.ss_parent[:n_ss]] = p.ss_val[:n_ss]
            if want_csr:
                # The op-major copies by a stable counting scatter of the
                # trace-major entries (an op's traces stay ascending), and
                # the three row-offset arrays.
                lib.mr_export_csr(
                    handle, ctypes.c_int32(idx),
                    ctypes.c_int64(vocab_size),
                    ctypes.c_int64(v_pad), ctypes.c_int64(t_pad),
                    p.inc_trace_opmajor.ctypes.data_as(i32p),
                    p.sr_val_opmajor.ctypes.data_as(f32p),
                    p.inc_indptr_op.ctypes.data_as(i32p),
                    p.inc_indptr_trace.ctypes.data_as(i32p),
                    p.ss_indptr.ctypes.data_as(i32p),
                )
            if want_pc:
                # Binned from the exported entries, which the C++ counting
                # sort leaves in (trace, op) order.
                from ..graph.build import pcsr_auxiliary

                pc_trace, pc_sr, pc_blk, pc_eop, pc_ers = pcsr_auxiliary(
                    p.inc_op, p.inc_trace, p.sr_val, p.rs_val,
                    n_inc, v_pad, t_pad,
                )
                p = p._replace(
                    pc_trace=pc_trace, pc_sr_val=pc_sr,
                    pc_blk_indptr=pc_blk, pc_ell_op=pc_eop, pc_ell_rs=pc_ers,
                )
            if mode == "kind":
                from ..graph.build import kind_aux

                p = p._replace(ss_indptr=kind_aux(p.ss_child, n_ss, v_pad))
            if retain_columns:
                cols = np.zeros(n_tr, np.int32)
                n = int(lib.mr_export_columns(handle, ctypes.c_int32(idx),
                                              cols.ctypes.data_as(i32p)))
                if n != n_tr:
                    raise NativeUnavailable(f"mr_export_columns wrote {n} of {n_tr} columns")
                columns.append(cols)
            out.append(p)
        if retain_columns:
            return out[0], out[1], tuple(columns)
        return out[0], out[1]
    finally:
        lib.mr_free_built(handle)


def detect_window_native(
    table: SpanTable,
    w0_us: int,
    w1_us: int,
    remap: np.ndarray,
    thresh_ms: np.ndarray,
    slack_ms: float,
):
    """Fused one-scan window detection (detector.cpp): window mask +
    per-trace expected/real + normal/abnormal partition.

    ``remap`` maps table svc-op ids into the SLO vocab (int32, -1 for
    unseen); ``thresh_ms`` is the float32 mu + k*sigma array over that
    vocab. Returns (mask bool[S], nrm int32[], abn int32[],
    n_window_spans, n_traces_seen).
    """
    lib = _load_library()
    n_spans = table.n_spans
    n_total = len(table.trace_names)
    mask = np.empty(n_spans, dtype=np.uint8)
    nrm = np.empty(n_total, dtype=np.int32)
    abn = np.empty(n_total, dtype=np.int32)
    counts = np.zeros(4, dtype=np.int64)
    remap = np.ascontiguousarray(remap, dtype=np.int32)
    thresh_ms = np.ascontiguousarray(thresh_ms, dtype=np.float32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.mr_detect_window(
        ctypes.c_int64(n_spans),
        table.trace_id.ctypes.data_as(i32p),
        table.svc_op.ctypes.data_as(i32p),
        table.duration_us.ctypes.data_as(i64p),
        table.start_us.ctypes.data_as(i64p),
        table.end_us.ctypes.data_as(i64p),
        ctypes.c_int64(int(w0_us)),
        ctypes.c_int64(int(w1_us)),
        remap.ctypes.data_as(i32p),
        ctypes.c_int64(len(remap)),
        thresh_ms.ctypes.data_as(f32p),
        ctypes.c_int64(len(thresh_ms)),
        ctypes.c_float(float(slack_ms)),
        ctypes.c_int64(n_total),
        mask.ctypes.data_as(u8p),
        nrm.ctypes.data_as(i32p),
        abn.ctypes.data_as(i32p),
        counts.ctypes.data_as(i64p),
    )
    if rc != 0:
        raise NativeUnavailable(f"mr_detect_window failed (rc={rc})")
    n_nrm, n_abn, n_window, n_seen = (int(c) for c in counts)
    return (
        mask.view(np.bool_),
        nrm[:n_nrm].copy(),
        abn[:n_abn].copy(),
        n_window,
        n_seen,
    )


__all__ = [
    "SpanTable",
    "PaddedPartition",
    "NativeUnavailable",
    "load_span_table",
    "build_window_padded",
    "detect_window_native",
    "build_library",
]
