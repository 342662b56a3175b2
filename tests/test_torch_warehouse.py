"""The trace warehouse (``microrank_tpu_torch.warehouse``) against the
JAX package's (``microrank_tpu.warehouse``), on the CPU:

* the segment codec: a window's ``SpanTable`` round trip is exact, and
  the port reads the segments JAX's ``TraceWarehouse`` wrote: every
  window's table holds JAX's frame row for row (names, times,
  durations, parents: exact), with the traces, ops, durations and
  parents of the table the port sealed for that window (the times
  differ where JAX's admission normalizes clock skew), and the port's
  host unpack of JAX's rank blobs equals JAX's leaf for leaf;
* the manifest: rejected whole when tampered, rebuilt from the segment
  files; a re-seal of the same window is idempotent;
* a stream run seals every window (8 windows, 12 ops, 50 traces, cold
  compaction after 4 warm segments), with the truth and the detection
  context, as JAX's run does; retention drops the oldest cold segments;
* a ``cli stream --warehouse`` subprocess killed at the
  ``warehouse_seal`` seam (after the segment files, before the
  manifest) and resumed ends with the manifest of a run never killed;
* ``ReplaySource``'s warehouse mode, and ``parse_time_range`` equal to
  JAX's on every form it accepts, the others refused.

JAX's engine reads the port generator's timeline as ``datetime64[ns]``
frames (its window code assumes them).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu_torch.config import (
    DispatchConfig,
    MicroRankConfig,
    RuntimeConfig,
    StreamConfig,
    WarehouseConfig,
)
from microrank_tpu_torch.graph.structures import PartitionGraph
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.stream import StreamEngine, SyntheticSource
from microrank_tpu_torch.testing import SyntheticConfig
from microrank_tpu_torch.warehouse import (
    TraceWarehouse,
    WarehouseError,
    decode_table,
    encode_table,
    load_manifest,
    load_segment,
    load_warehouse_table,
    parse_time_range,
    rescan_segments,
)

ROOT = Path(__file__).resolve().parents[1]
SYNTH = dict(n_operations=12, n_traces=50, seed=11)
FAULTED = [4, 5]
N_WINDOWS = 8


def _ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


def port_run(out_dir, **wh):
    wh.setdefault("compact_after", 4)
    cfg = MicroRankConfig(stream=StreamConfig(allowed_lateness_seconds=5.0),
                          runtime=RuntimeConfig(device="cpu"),
                          dispatch=DispatchConfig(warmup_manifest=False),
                          warehouse=WarehouseConfig(enabled=True, **wh))
    src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH))
    return StreamEngine(cfg, src, out_dir=out_dir).run(), cfg


def jax_run(out_dir):
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.config import WarehouseConfig as JaxWarehouse
    from microrank_tpu.stream import StreamEngine as JaxEngine
    from microrank_tpu.stream.sources import ReplaySource as JaxReplay
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    tl = generate_timeline(JaxSynth(**SYNTH), N_WINDOWS, FAULTED)
    cfg = JaxConfig(stream=JaxStream(allowed_lateness_seconds=5.0),
                    dispatch=JaxDispatch(warmup_manifest=False),
                    warehouse=JaxWarehouse(enabled=True, compact_after=4))
    src = JaxReplay(_ns(tl.timeline), chunk_spans=4000)
    src.fault_pod_ops = list(tl.fault_pod_ops)
    return JaxEngine(cfg, src, out_dir=out_dir, normal_df=_ns(tl.normal)).run()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One port and one JAX stream run over the same timeline, each with
    its warehouse (in registries of their own)."""
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set

    base = tmp_path_factory.mktemp("wh")
    old, jold = get_registry(), jax_get()
    set_registry(MetricsRegistry())
    jax_set(JaxRegistry())
    try:
        port, cfg = port_run(base / "port")
        jax = jax_run(base / "jax")
    finally:
        set_registry(old)
        jax_set(jold)
    return {"base": base, "port": port, "jax": jax, "cfg": cfg}


def _tables_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f
        else:
            assert list(x) == list(y) if isinstance(x, list) else x == y, f


def _frame_equal(table, frame):
    """The port's table of a JAX frame, row for row: the names the
    loader makes, the times in microseconds, each parent the row holding
    its ``ParentSpanId``."""
    def names(codes, vocab):
        return [vocab[c] for c in codes]

    op = frame["operationName"].astype(str)
    assert names(table.trace_id, table.trace_names) == list(frame["traceID"].astype(str))
    assert names(table.svc_op, table.svc_op_names) == list(
        frame["serviceName"].astype(str) + "_" + op)
    assert names(table.pod_op, table.pod_op_names) == list(frame["podName"].astype(str) + "_" + op)
    assert table.duration_us.tolist() == frame["duration"].astype("int64").tolist()
    for col, vals in (("startTime", table.start_us), ("endTime", table.end_us)):
        assert vals.tolist() == frame[col].astype("datetime64[us]").astype("int64").tolist()
    row_of = {sid: i for i, sid in enumerate(frame["spanID"].astype(str))}
    want = [row_of.get(p, -1) for p in frame["ParentSpanId"].astype(str)]
    assert table.parent_row.tolist() == want


# ------------------------------------------------------------- codec


def test_table_codec_round_trip_is_exact():
    """A window table and a loader table round-trip exactly (the
    codes, names, times, parents and the sorted flag)."""
    from microrank_tpu_torch.stream import StreamWindower

    src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH), chunk_spans=700)
    w = StreamWindower(width_us=300_000_000, slide_us=150_000_000)
    windows = [x for b in src for x in w.add(b)] + w.flush()
    tables = [x.table for x in windows if x.table is not None] + [src.table]
    for t in tables:
        arrays, meta = encode_table(t)
        assert set(meta) == {"columns", "rows"} and meta["rows"] == t.n_spans
        assert {c["enc"] for c in meta["columns"]} == {"dict", "int", "datetime"}
        _tables_equal(decode_table(arrays, meta), t)


def test_port_reads_jax_segments(runs):
    """Every window JAX sealed: its table, decoded by the port, equals
    the table the port sealed for that window; its rank blob, unpacked
    by the port at JAX's word offsets, equals JAX's own unpack; its
    detection context is JAX's record."""
    from microrank_tpu.warehouse import TraceWarehouse as JaxWarehouse

    base = runs["base"]
    ours = {w.start_us: w for w in TraceWarehouse(base / "port", runs["cfg"].warehouse).query()}
    theirs = JaxWarehouse(base / "jax", runs["cfg"].warehouse).query()
    assert len(theirs) == len(ours) == N_WINDOWS
    segs = sorted((base / "jax" / "warehouse").glob("*.npz"))
    mine = [w for s in segs for w in load_segment(s)]
    assert [w.start_us for w in mine] == [w.start_us for w in theirs]
    ranked = 0
    for jw, pw in zip(theirs, mine):
        assert pw.meta == jw.meta and pw.outcome == jw.outcome
        _frame_equal(pw.table(), jw.frame())
        ot, pt = ours[pw.start_us].table(), pw.table()
        for f in ("trace_names", "svc_op_names", "pod_op_names"):
            assert getattr(pt, f) == getattr(ot, f), f
        for f in ("trace_id", "svc_op", "pod_op", "duration_us", "parent_row"):
            assert np.array_equal(getattr(pt, f), getattr(ot, f)), f
        assert pw.vocab_names == jw.vocab_names
        if jw.outcome == "ranked":
            ranked += 1
            jg, pg = jw.graph(), pw.graph()
            for part in ("normal", "abnormal"):
                for f in PartitionGraph._fields:
                    if f not in getattr(jg, part)._fields:
                        continue
                    a = np.asarray(getattr(getattr(jg, part), f))
                    b = np.asarray(getattr(getattr(pg, part), f))
                    assert a.dtype == b.dtype and np.array_equal(a, b), (part, f)
            np.testing.assert_array_equal(pw.slo_baseline().mean_ms, jw.slo_baseline().mean_ms)
    assert ranked == 2


# ---------------------------------------------------------- manifest


def test_manifest_rejected_whole_and_rebuilt(runs, tmp_path):
    import shutil

    whdir = tmp_path / "warehouse"
    shutil.copytree(runs["base"] / "port" / "warehouse", whdir)
    sealed = load_manifest(whdir)
    doc = json.loads((whdir / "manifest.json").read_text())
    doc["payload"]["counters"]["spans"] += 1
    (whdir / "manifest.json").write_text(json.dumps(doc))
    with pytest.raises(WarehouseError, match="checksum"):
        load_manifest(whdir)
    store = TraceWarehouse(whdir, WarehouseConfig(enabled=True))   # re-scans, re-seals
    rebuilt = load_manifest(whdir)
    assert rebuilt["counters"]["windows"] == sealed["counters"]["windows"] == N_WINDOWS
    assert rebuilt["counters"]["spans"] == sealed["counters"]["spans"]
    assert [r["file"] for r in rebuilt["segments"]] == [r["file"] for r in sealed["segments"]]
    assert rescan_segments(whdir) == [{**r, "bytes": r["bytes"]} for r in rescan_segments(whdir)]
    assert store.summary()["windows"] == N_WINDOWS


def test_reseal_same_window_is_idempotent(tmp_path):
    from microrank_tpu_torch.pipeline.results import WindowResult

    store = TraceWarehouse(tmp_path, WarehouseConfig(enabled=True))
    res = WindowResult(start="2025-03-01 00:00:00", end="2025-03-01 00:05:00", anomaly=False)
    src = SyntheticSource(2, [], SyntheticConfig(**SYNTH))
    for _ in range(2):
        store.observe(res, "clean", table=src.normal)
        store.flush()
        store.sealed_through_us = 0     # as a crashed run's store before its seal
    s = store.summary()
    assert (s["windows"], s["segments"], s["spans"]) == (1, 1, src.normal.n_spans)


# ---------------------------------------------------------- the stream


def test_stream_seals_tiered_segments_as_jax(runs):
    base = runs["base"]
    ours, theirs = load_manifest(base / "port" / "warehouse"), load_manifest(
        base / "jax" / "warehouse")
    assert ours["counters"] == theirs["counters"]
    assert ours["counters"]["windows"] == N_WINDOWS
    assert [(r["file"], r["tier"], r["windows"], r["spans"], r["outcomes"])
            for r in ours["segments"]] == [
        (r["file"], r["tier"], r["windows"], r["spans"], r["outcomes"])
        for r in theirs["segments"]]
    assert {r["tier"] for r in ours["segments"]} == {"cold"}   # 8 windows, 4 a segment
    assert ours["truth"] == theirs["truth"] and ours["truth"]
    store = TraceWarehouse(base / "port", runs["cfg"].warehouse)
    ranked = [w for w in store.query() if w.outcome == "ranked"]
    assert len(ranked) == 2
    assert all(w.vocab_names and w.slo_baseline() is not None and w.graph() is not None
               for w in ranked)


def test_retention_drops_the_oldest_cold_segments(tmp_path):
    port_run(tmp_path, compact_after=2, retention_segments=2)
    payload = load_manifest(tmp_path / "warehouse")
    assert len(payload["segments"]) == 2
    assert [r["tier"] for r in payload["segments"]] == ["cold", "cold"]
    assert payload["counters"]["windows"] == 4
    assert sorted(p.name for p in (tmp_path / "warehouse").glob("*.npz")) == sorted(
        r["file"] for r in payload["segments"])


def test_seal_crash_and_resume_seal_each_window_once(tmp_path):
    """Killed at ``warehouse_seal`` (segment files on disk, the manifest
    not yet sealed), then resumed without the plan: the manifest and its
    segment files equal a run never killed, and replay matches."""
    src = SyntheticSource(6, [3], SyntheticConfig(**SYNTH))
    normal_csv, input_csv = src.timeline.write_csvs(tmp_path / "data")
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [{"seam": "warehouse_seal", "kind": "kill",
                                            "after": 2, "count": 1}]}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "MICRORANK_JIT_CACHE": str(tmp_path / "jit")}

    def run(out, *extra):
        return subprocess.run(
            [sys.executable, "-m", "microrank_tpu_torch.cli", "stream", "--device", "cpu",
             "--source", "replay", "--input", str(input_csv), "--normal", str(normal_csv),
             "--lateness-seconds", "5", "--warehouse", "-o", str(out), *extra],
            env=env, capture_output=True, text=True, timeout=300)

    ref = run(tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    out = tmp_path / "out"
    crashed = run(out, "--chaos", str(plan))
    assert crashed.returncode == 137, crashed.stderr[-2000:]
    whdir = out / "warehouse"
    sealed = load_manifest(whdir) or {"segments": []}
    assert len(list(whdir.glob("seg-*.npz"))) > len(sealed["segments"])   # an orphan
    resumed = run(out, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    got, want = load_manifest(whdir), load_manifest(tmp_path / "ref" / "warehouse")
    assert got["counters"] == want["counters"]
    assert [(r["file"], r["spans"], r["outcomes"]) for r in got["segments"]] == [
        (r["file"], r["spans"], r["outcomes"]) for r in want["segments"]]
    assert sorted(p.name for p in whdir.glob("*.npz")) == sorted(
        p.name for p in (tmp_path / "ref" / "warehouse").glob("*.npz"))
    from microrank_tpu_torch.warehouse import replay_range

    report = replay_range(out, config=MicroRankConfig(runtime=RuntimeConfig(device="cpu")))
    assert report["verdict"] == "match" and report["ranked"] >= 1


# ------------------------------------------------------- replay source


def test_replay_source_warehouse_mode(runs):
    from microrank_tpu_torch.stream import ReplaySource

    out = runs["base"] / "port"
    table = load_warehouse_table(out)
    payload = load_manifest(out / "warehouse")
    assert table.n_spans == payload["counters"]["spans"]
    src = ReplaySource(out, chunk_spans=100_000)
    assert sum(len(b) for b in src) == table.n_spans
    assert np.all(np.diff(src.table.start_us) >= 0)


# --------------------------------------------------------- time ranges

RANGES = ["all", "", "*", "12..34", "..34", "12..", "7", "-5..5", "2025-03-01",
          "2025-03-01 00:00:00..", "2025-03-01T12:30..2025-03-02T00:00:01.250",
          "..2025-03-01 00:00:00.000001", "1740787200000000..2025-03-02"]


@pytest.mark.parametrize("spec", RANGES)
def test_parse_time_range_equals_jax(spec):
    from microrank_tpu.warehouse import parse_time_range as jax_parse

    assert parse_time_range(spec) == jax_parse(spec)


@pytest.mark.parametrize("spec", ["yesterday", "2025/03/01", "12..34..56x", "1e6",
                                  "2025-03-01 00:00:00+02:00", "..tomorrow"])
def test_parse_time_range_refuses_other_forms(spec):
    with pytest.raises(ValueError, match="accepted forms"):
        parse_time_range(spec)
