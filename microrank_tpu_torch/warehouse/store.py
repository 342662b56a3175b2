"""TraceWarehouse: hot buffer -> warm segments -> cold compaction
(counterpart of ``microrank_tpu/warehouse/store.py``).

Seal protocol (the exactly-once contract):

1. every hot window is written to its own ``seg-<start_us>-<end_us>.npz``
   (tmp, fsync, rename; the name is a pure function of the window's
   bounds, so a re-seal after a crash overwrites the orphan instead of
   duplicating it);
2. the ``warehouse_seal`` chaos seam fires: ``kill`` exits the process
   here, a raising kind propagates ``InjectedFault`` to the engine,
   which then skips the checkpoint (the previous one stands, the source
   replays the same windows, step 1 makes the re-seal idempotent);
3. the manifest is sealed (version, sha256, atomic): only now do the
   segments exist for readers;
4. the hot buffer clears; compaction folds the oldest warm segments
   into a cold multi-window segment (warm files are deleted only after
   the manifest listing the cold one is sealed) and retention drops the
   oldest cold segments past the cap.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..chaos.faults import maybe_inject
from .manifest import (
    MANIFEST_NAME,
    WAREHOUSE_DIR,
    WarehouseError,
    load_manifest,
    rescan_segments,
    seal_manifest,
)
from .segment import StoredWindow, encode_window, load_segment, write_segment


def resolve_warehouse_dir(path, cfg=None) -> Path:
    """The warehouse directory of an explicit config, a run output dir,
    or the warehouse dir itself (the CLI takes either)."""
    if cfg is not None and getattr(cfg, "dir", None):
        return Path(cfg.dir)
    p = Path(path)
    if (p / MANIFEST_NAME).exists() or p.name == WAREHOUSE_DIR:
        return p
    sub = p / WAREHOUSE_DIR
    if cfg is not None or (sub / MANIFEST_NAME).exists() or sub.is_dir():
        return sub
    return p


_STAMP = re.compile(r"^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2}(\.\d{1,9})?)?)?$")


def stamp_to_us(text: str) -> int:
    """``YYYY-MM-DD[ HH:MM[:SS[.f]]]`` (a space or ``T`` between; naive,
    read as UTC) -> epoch microseconds. Anything else raises ValueError."""
    text = str(text).strip()
    if not _STAMP.match(text):
        raise ValueError(f"not a timestamp: {text!r}")
    return int(np.datetime64(text.replace(" ", "T"), "us").astype(np.int64))


def _to_us(val) -> int:
    """A window bound -> epoch microseconds (an int, or the stamp string
    a WindowResult carries: ``stream.window.stamp``, exact to the µs)."""
    if isinstance(val, (int, np.integer)):
        return int(val)
    return stamp_to_us(val)


def _jsonable_truth(truth):
    if truth is None:
        return None
    if isinstance(truth, (set, frozenset, tuple)):
        return sorted(str(t) for t in truth)
    if isinstance(truth, dict):
        return {str(k): _jsonable_truth(v) for k, v in truth.items()}
    if isinstance(truth, list):
        return [str(t) for t in truth]
    return str(truth)


class TraceWarehouse:
    """One run's tiered segment store at ``<out_dir>/warehouse`` (or
    ``WarehouseConfig.dir``). ``journal``: where the seal and rejection
    events go (the engine's run journal)."""

    def __init__(self, base_dir, cfg, truth=None, journal=None):
        self.cfg = cfg
        self.journal = journal
        self.dir = resolve_warehouse_dir(base_dir, cfg)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.truth = _jsonable_truth(truth)
        self._hot: List[dict] = []
        self._segments: List[dict] = []
        self._counters: Dict[str, int] = {"windows": 0, "spans": 0, "ingest_rejected": 0}
        self.sealed_through_us = 0
        try:
            payload = load_manifest(self.dir)
        except WarehouseError as exc:
            # Rejected whole: rebuilt from the segment files and re-sealed.
            self._emit("warehouse_manifest_rejected", error=str(exc))
            self._segments = rescan_segments(self.dir)
            self._recount()
            self._seal()
            return
        if payload is not None:
            self._segments = list(payload.get("segments", []))
            self.sealed_through_us = int(payload.get("sealed_through_us", 0))
            self._counters.update(payload.get("counters", {}))
            if self.truth is None:
                self.truth = payload.get("truth")

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            try:
                self.journal.emit(event, **fields)
            except Exception:  # noqa: BLE001 - obs must never fail a seal
                pass

    # ------------------------------------------------------------- ingest
    def observe(self, result, outcome: str, table=None, graph=None, op_names=None,
                kernel=None, snapshot=None) -> None:
        """Buffer one sealed window (hot tier). The engine calls this at
        finalize, before the baseline absorbs the window, so the stored
        snapshot is the window's detection context."""
        spans = 0 if table is None else int(table.n_spans)
        start_us, end_us = _to_us(result.start), _to_us(result.end)
        if end_us <= self.sealed_through_us:
            # Sealed already (windows seal in end order): a resumed run
            # replaying the windows past its checkpoint seals each once.
            return
        meta = {
            "start": str(result.start),
            "end": str(result.end),
            "start_us": int(start_us),
            "end_us": int(end_us),
            "outcome": outcome,
            "anomaly": bool(result.anomaly),
            "skipped_reason": result.skipped_reason,
            "n_traces": int(result.n_traces),
            "n_abnormal": int(result.n_abnormal),
            "ranking": ([[str(n), float(s)] for n, s in result.ranking]
                        if result.ranking else None),
            "kernel": kernel or result.kernel,
            "kind_dedup": result.kind_dedup,
            "ingest_rejected": int(getattr(result, "ingest_rejected", 0)),
            "degraded_input": bool(getattr(result, "degraded_input", False)),
            "spans": spans,
            "baseline_ready": snapshot is not None,
        }
        rec: dict = {"meta": meta}
        if table is not None and self.cfg.store_spans:
            rec["table"] = table
        if graph is not None and op_names is not None and self.cfg.store_blobs:
            from ..rank_backends.blob import pack_graph_blob

            blob, layout = pack_graph_blob(graph)
            rec["graph_pack"] = (blob.numpy().view(np.uint32), layout, list(op_names))
        if snapshot is not None:
            rec["snapshot"] = snapshot
        self._hot.append(rec)

    # --------------------------------------------------------------- seal
    def flush(self) -> int:
        """Seal every hot window into warm segments and the manifest.

        Raises ``InjectedFault`` when the ``warehouse_seal`` seam fires a
        raising kind: after the segment files are on disk and before the
        manifest (and the engine's checkpoint)."""
        import time

        if not self._hot:
            return 0
        t0 = time.perf_counter()
        rows: List[dict] = []
        for rec in self._hot:
            meta = rec["meta"]
            name = f"seg-{meta['start_us']}-{meta['end_us']}.npz"
            nbytes = write_segment(self.dir / name, [encode_window(rec)])
            rows.append({
                "file": name, "tier": "warm", "start_us": meta["start_us"],
                "end_us": meta["end_us"], "windows": 1, "spans": meta["spans"],
                "bytes": int(nbytes), "outcomes": {meta["outcome"]: 1},
            })
        maybe_inject("warehouse_seal")  # kill exits here; a raising kind unwinds
        for row in rows:
            self._adopt_row(row)
            self._counters["windows"] += 1
            self._counters["spans"] += row["spans"]
        self._counters["ingest_rejected"] += sum(r["meta"]["ingest_rejected"] for r in self._hot)
        self.sealed_through_us = max([self.sealed_through_us] + [r["end_us"] for r in rows])
        self._seal()
        self._hot = []
        self._record_seal("warm", len(rows), sum(r["spans"] for r in rows),
                          sum(r["bytes"] for r in rows))
        self._compact()
        self._retain()
        from ..obs.metrics import stage_seconds

        stage_seconds().observe(time.perf_counter() - t0, stage="warehouse_seal")
        return len(rows)

    def _adopt_row(self, row: dict) -> None:
        """Insert or replace by file name: a re-seal after a crash
        replaces its manifest row instead of appending a duplicate."""
        for i, existing in enumerate(self._segments):
            if existing["file"] == row["file"]:
                self._counters["windows"] -= existing["windows"]
                self._counters["spans"] -= existing["spans"]
                self._segments[i] = row
                return
        self._segments.append(row)
        self._segments.sort(key=lambda r: (r["start_us"], r["end_us"], r["file"]))

    def _seal(self) -> None:
        seal_manifest(self.dir, self.manifest_payload())

    def manifest_payload(self) -> dict:
        return {"segments": self._segments, "sealed_through_us": self.sealed_through_us,
                "counters": dict(self._counters), "truth": self.truth}

    def _recount(self) -> None:
        self._counters["windows"] = sum(r["windows"] for r in self._segments)
        self._counters["spans"] = sum(r["spans"] for r in self._segments)
        if self._segments:
            self.sealed_through_us = max(r["end_us"] for r in self._segments)

    # ---------------------------------------------------- compact / retain
    def _compact(self) -> None:
        """Fold the oldest ``compact_after`` warm segments into one cold
        segment; the warm files go only after the manifest naming the
        cold one is sealed (the rescan ignores warm files a cold range
        covers, so a crash in between cannot count twice)."""
        n = int(getattr(self.cfg, "compact_after", 0) or 0)
        if n <= 0:
            return
        while True:
            warm = [r for r in self._segments if r["tier"] == "warm"]
            if len(warm) < n:
                return
            batch = warm[:n]
            windows = []
            for row in batch:
                for w in load_segment(self.dir / row["file"]):
                    windows.append((w.arrays, w.meta))
            start = min(r["start_us"] for r in batch)
            end = max(r["end_us"] for r in batch)
            name = f"cold-{start}-{end}.npz"
            nbytes = write_segment(self.dir / name, windows)
            cold_row = {
                "file": name, "tier": "cold", "start_us": start, "end_us": end,
                "windows": sum(r["windows"] for r in batch),
                "spans": sum(r["spans"] for r in batch), "bytes": int(nbytes),
                "outcomes": _merge_outcomes(r["outcomes"] for r in batch),
            }
            drop = {r["file"] for r in batch}
            self._segments = [r for r in self._segments if r["file"] not in drop]
            self._segments.append(cold_row)
            self._segments.sort(key=lambda r: (r["start_us"], r["end_us"], r["file"]))
            self._seal()
            for fname in drop:
                try:
                    (self.dir / fname).unlink()
                except OSError:
                    pass
            self._record_seal("cold", cold_row["windows"], cold_row["spans"], nbytes)

    def _retain(self) -> None:
        cap = int(getattr(self.cfg, "retention_segments", 0) or 0)
        if cap <= 0 or len(self._segments) <= cap:
            return
        dropped = []
        while len(self._segments) > cap:
            cold = [r for r in self._segments if r["tier"] == "cold"]
            if not cold:
                break
            victim = cold[0]
            self._segments.remove(victim)
            self._counters["windows"] -= victim["windows"]
            self._counters["spans"] -= victim["spans"]
            dropped.append(victim["file"])
        if not dropped:
            return
        self._seal()
        for fname in dropped:
            try:
                (self.dir / fname).unlink()
            except OSError:
                pass

    # --------------------------------------------------- checkpoint seam
    def cursor_state(self) -> dict:
        """Embedded in the engine's checkpoint payload."""
        return {"sealed_through_us": int(self.sealed_through_us)}

    def restore_cursor(self, state) -> None:
        if isinstance(state, dict):
            self.sealed_through_us = max(self.sealed_through_us,
                                         int(state.get("sealed_through_us", 0)))

    def reset_hot(self) -> None:
        self._hot = []

    # -------------------------------------------------------------- query
    def query(self, t0_us: Optional[int] = None,
              t1_us: Optional[int] = None) -> List[StoredWindow]:
        """Stored windows overlapping ``[t0_us, t1_us]`` (None: open), in
        time order; only manifest-listed segments (the commit record)."""
        out: List[StoredWindow] = []
        for row in self._segments:
            if t1_us is not None and row["start_us"] > t1_us:
                continue
            if t0_us is not None and row["end_us"] < t0_us:
                continue
            for w in load_segment(self.dir / row["file"]):
                if t1_us is not None and w.start_us > t1_us:
                    continue
                if t0_us is not None and w.end_us < t0_us:
                    continue
                out.append(w)
        out.sort(key=lambda w: (w.start_us, w.end_us))
        return out

    def summary(self) -> dict:
        by_tier: Dict[str, int] = {}
        for r in self._segments:
            by_tier[r["tier"]] = by_tier.get(r["tier"], 0) + 1
        return {"segments": len(self._segments), "by_tier": by_tier,
                "windows": self._counters["windows"], "spans": self._counters["spans"],
                "bytes": sum(r["bytes"] for r in self._segments)}

    # ------------------------------------------------------------- obs
    def _record_seal(self, tier, windows, spans, nbytes) -> None:
        from ..obs.metrics import record_warehouse_seal

        record_warehouse_seal(tier, windows, spans, nbytes)
        self._emit("warehouse_seal", tier=tier, windows=int(windows), spans=int(spans),
                   bytes=int(nbytes), segments=len(self._segments))


def _merge_outcomes(dicts) -> dict:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in (d or {}).items():
            out[k] = out.get(k, 0) + int(v)
    return out


def load_warehouse_table(path, t0_us=None, t1_us=None):
    """One span table of a warehouse's stored tables (``ReplaySource``'s
    warehouse mode): every stored window's table in time order,
    concatenated under one vocabulary (parents re-based by row offset).
    Sliding windows store a span once per window it landed in, as JAX's
    frames do."""
    from ..native import SpanTable

    whdir = resolve_warehouse_dir(path)
    payload = load_manifest(whdir)
    rows = payload.get("segments", []) if payload is not None else rescan_segments(whdir)
    if not rows:
        raise WarehouseError(f"no warehouse segments under {whdir}")
    tables = []
    for row in sorted(rows, key=lambda r: (r["start_us"], r["end_us"])):
        if t1_us is not None and row["start_us"] > t1_us:
            continue
        if t0_us is not None and row["end_us"] < t0_us:
            continue
        for w in load_segment(whdir / row["file"]):
            t = w.table()
            if t is not None and t.n_spans:
                tables.append(t)
    if not tables:
        raise WarehouseError(f"warehouse under {whdir} stored no span tables "
                             "(store_spans off?)")
    if len(tables) == 1:
        return tables[0]

    def merged(field_codes, field_names):
        index: Dict[str, int] = {}
        out = []
        for t in tables:
            names = getattr(t, field_names)
            m = np.asarray([index.setdefault(n, len(index)) for n in names], dtype=np.int32)
            out.append(m[getattr(t, field_codes)] if len(names) else
                       np.zeros(0, np.int32))
        return np.concatenate(out), list(index)

    trace_id, trace_names = merged("trace_id", "trace_names")
    svc_op, svc_names = merged("svc_op", "svc_op_names")
    pod_op, pod_names = merged("pod_op", "pod_op_names")
    offsets = np.cumsum([0] + [t.n_spans for t in tables[:-1]])
    parent = np.concatenate([np.where(t.parent_row >= 0, t.parent_row + o, -1)
                             for t, o in zip(tables, offsets)]).astype(np.int64)
    start = np.concatenate([t.start_us for t in tables]).astype(np.int64)
    return SpanTable(
        trace_id=trace_id, svc_op=svc_op, pod_op=pod_op,
        duration_us=np.concatenate([t.duration_us for t in tables]).astype(np.int64),
        start_us=start, end_us=np.concatenate([t.end_us for t in tables]).astype(np.int64),
        parent_row=parent, trace_names=trace_names, svc_op_names=svc_names,
        pod_op_names=pod_names, time_sorted=bool(np.all(start[1:] >= start[:-1])),
    )
