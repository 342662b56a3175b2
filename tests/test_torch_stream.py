"""The stream lane's host parts held to the JAX package's classes on the
same inputs (the cases of JAX's ``tests/test_stream.py``):

* the windower (``stream.window.StreamWindower`` over span-table
  batches): tumbling close order, out-of-order spans within the
  lateness, late drops and their counter, empty windows through gaps,
  sliding overlap; a closed window's table (ops in name order, traces in
  first appearance, parents re-based) bitwise what the C++ loader reads
  from the window's rows;
* the online baseline and P^2: seed, decayed updates and freeze, the
  percentile statistic, ``snapshot`` bitwise JAX's on the same samples;
* the incident lifecycle: fingerprints, open / update / resolve /
  cooldown, Jaccard dedup, score drift, event sequences equal to JAX's;
  the webhook counts a local failure (a closed port on 127.0.0.1, never
  a network) without raising;
* the build pool, the replay source's chunks and pacing, the tail
  source's appended rows, and ``spans_table`` bitwise the loader's
  table of the same CSV.

JAX's frames carry ``datetime64[ns]`` timestamps (its window code
assumes nanoseconds).
"""

from __future__ import annotations

import threading

import numpy as np
import pandas as pd
import pytest

from microrank_tpu_torch.native import SpanTable, load_span_table
from microrank_tpu_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.stream import (
    BuildWorkerPool,
    FileTailSource,
    IncidentTracker,
    OnlineBaseline,
    P2Quantile,
    ReplaySource,
    SpanBatch,
    StreamWindower,
    WebhookIncidentSink,
    ranking_fingerprint,
)
from microrank_tpu_torch.stream.window import window_table
from microrank_tpu_torch.testing import SyntheticConfig, generate_case, generate_timeline
from microrank_tpu_torch.testing.synthetic import spans_table

T0_US = int(pd.Timestamp("2025-03-01 00:00:00").value // 1000)


@pytest.fixture
def registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


def _table(*offsets_s, tag="s"):
    """A span table whose rows start ``offsets_s`` seconds after T0."""
    n = len(offsets_s)
    start = np.asarray([T0_US + int(o * 1e6) for o in offsets_s], np.int64)
    return SpanTable(
        trace_id=np.arange(n, dtype=np.int32), svc_op=np.zeros(n, np.int32),
        pod_op=np.zeros(n, np.int32), duration_us=np.asarray(offsets_s, np.int64),
        start_us=start, end_us=start, parent_row=np.full(n, -1, np.int64),
        trace_names=[f"{tag}{i}" for i in range(n)], svc_op_names=["svcA_opA"],
        pod_op_names=["svcA-0_opA"],
    )


def _frame(*offsets_s, tag="s"):
    return pd.DataFrame({
        "traceID": [f"{tag}{i}" for i in range(len(offsets_s))],
        "startTime": pd.to_datetime([T0_US * 1000 + int(o * 1e9) for o in offsets_s]).astype(
            "datetime64[ns]"),
        "off": list(offsets_s),
    })


def _offs(closed):
    # The windower tests' tables carry each row's offset as its duration.
    return [] if closed.table is None else sorted(closed.table.duration_us.tolist())


def _jax_offs(closed):
    return [] if closed.frame is None else sorted(closed.frame["off"].tolist())


class _Rows:
    """Source batches numbered as one stream."""

    def __init__(self):
        self.at = 0

    def __call__(self, table):
        batch = SpanBatch(table, self.at)
        self.at += table.n_spans
        return batch


WINDOWER_CASES = {
    "tumbling": (dict(width_us=60_000_000), [(10, 70), (130,)]),
    "out_of_order": (dict(width_us=60_000_000, lateness_us=30_000_000),
                     [(10, 80), (50,), (200,)]),
    "late": (dict(width_us=60_000_000), [(10,), (130,), (30,)]),
    "gaps": (dict(width_us=60_000_000), [(10,), (400,)]),
    "sliding": (dict(width_us=120_000_000, slide_us=60_000_000), [(70,), (75, 130), (250,)]),
}


@pytest.mark.parametrize("case", list(WINDOWER_CASES))
def test_windower_matches_jax(registry, case):
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set
    from microrank_tpu.stream import StreamWindower as JaxWindower

    kw, batches = WINDOWER_CASES[case]
    old = jax_get()
    jax_set(JaxRegistry())
    try:
        w, j = StreamWindower(**kw), JaxWindower(**kw)
        rows = _Rows()
        for k, offs in enumerate(batches):
            got = w.add(rows(_table(*offs, tag=f"b{k}-")))
            want = j.add(_frame(*offs, tag=f"b{k}-"))
            assert [(c.start_us, c.end_us, c.start, c.end, _offs(c)) for c in got] == [
                (c.start_us, c.end_us, c.start, c.end, _jax_offs(c)) for c in want]
        got, want = w.flush(), j.flush()
        assert [(c.start_us, _offs(c)) for c in got] == [(c.start_us, _jax_offs(c)) for c in want]
        assert w.dropped_late == j.dropped_late
    finally:
        jax_set(old)
    if case == "late":
        assert w.dropped_late == 1
        assert registry.get("microrank_stream_late_spans_total").value() == 1


def test_a_closed_window_is_the_loaders_table_of_its_rows(tmp_path):
    """A timeline cut into batches, windowed, and each window's table
    against the C++ loader's table of the same rows (written as their
    own CSV): every column bitwise, op names in the same order, each
    row's trace the same."""
    from microrank_tpu_torch.testing.synthetic import write_spans_csv

    tl = generate_timeline(SyntheticConfig(n_operations=12, n_traces=60, n_pods=2, seed=3), 3,
                           [1])
    table = spans_table(tl.windows, tl.n_operations)
    w = StreamWindower(width_us=int(tl.window_minutes * 60e6))
    closed = []
    for lo in range(0, table.n_spans, 700):
        hi = min(lo + 700, table.n_spans)
        closed += w.add(SpanBatch(table._replace(**{
            f: getattr(table, f)[lo:hi] for f in ("trace_id", "svc_op", "pod_op", "duration_us",
                                                  "start_us", "end_us", "parent_row")}), lo))
    closed += w.flush()
    assert [c.n_spans for c in closed if c.n_spans] == [
        int(x["trace"].shape[0]) for x in tl.windows]
    for k, (c, spans) in enumerate(zip([c for c in closed if c.n_spans], tl.windows)):
        path = tmp_path / f"w{k}.csv"
        write_spans_csv(spans, path, tl.n_operations)
        want = load_span_table(path, cache=False)
        for f in SpanTable._fields:
            a, b = getattr(c.table, f), getattr(want, f)
            if f in ("trace_id", "trace_names", "time_sorted"):
                continue
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f
        # Traces: the same trace on every row (the window numbers them
        # in its rows' order, the loader in its file's).
        assert [c.table.trace_names[i] for i in c.table.trace_id] == [
            want.trace_names[i] for i in want.trace_id]


def test_spans_table_is_the_loaders_table(tmp_path):
    tl = generate_timeline(SyntheticConfig(n_operations=24, n_traces=120, n_kinds=16, n_pods=2,
                                           seed=5), 3, [1])
    normal, abnormal = tl.write_csvs(tmp_path)
    for path, spans in ((normal, tl.normal), (abnormal, tl.windows)):
        a, b = load_span_table(path, cache=False), spans_table(spans, tl.n_operations)
        for f in SpanTable._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x.dtype == y.dtype and np.array_equal(x, y)) if isinstance(x, np.ndarray) \
                else x == y, f


def test_window_table_rebases_parents_and_drops_outside_ones():
    t = _table(1, 2, 3, 4)
    t = t._replace(parent_row=np.asarray([-1, 100, 101, 9], np.int64))
    out = window_table([(SpanBatch(t, 100), np.asarray([1, 2, 3]))])
    # Row 101 (parent 100: not in the window) is a root; 102's parent
    # 101 is the window's row 0; 103's parent 9 is outside the source.
    assert out.parent_row.tolist() == [-1, 0, -1]
    assert out.trace_names == ["s1", "s2", "s3"]


# ----------------------------------------------------------- baseline


def test_p2_quantile_is_jaxs():
    from microrank_tpu.stream import P2Quantile as JaxP2

    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=1.0, sigma=0.6, size=3000)
    for q in (0.5, 0.9, 0.99):
        a, b = P2Quantile(q), JaxP2(q)
        for x in xs[:1000]:
            a.update(x)
            b.update(x)
        for lo in range(1000, len(xs), 400):
            a.update_batch(xs[lo: lo + 400])
            b.update_batch(xs[lo: lo + 400])
        assert a.value() == b.value() and a.heights == b.heights and a.n == b.n
        np.testing.assert_array_equal(a.pos, b.pos)


def _op_table(dur_ms, n=20, names=("svcA_opA",)):
    t = _table(*([0] * n))
    return t._replace(duration_us=np.full(n, int(dur_ms * 1000), np.int64),
                      svc_op=np.arange(n, dtype=np.int32) % len(names),
                      svc_op_names=list(names))


def _op_frame(dur_ms, n=20, names=("svcA_opA",)):
    svc = [names[i % len(names)].split("_")[0] for i in range(n)]
    ops = [names[i % len(names)].split("_", 1)[1] for i in range(n)]
    return pd.DataFrame({
        "traceID": [f"s{i}" for i in range(n)], "serviceName": svc, "operationName": ops,
        "duration": [int(dur_ms * 1000)] * n,
        "startTime": pd.to_datetime([T0_US * 1000] * n).astype("datetime64[ns]"),
        "endTime": pd.to_datetime([T0_US * 1000] * n).astype("datetime64[ns]"),
    })


def _assert_snapshots_equal(a, b):
    (va, ba), (vb, bb) = a.snapshot(), b.snapshot()
    assert va.names == vb.names
    assert ba.mean_ms.tobytes() == bb.mean_ms.tobytes()
    assert ba.std_ms.tobytes() == bb.std_ms.tobytes()


@pytest.mark.parametrize("stat", ["mean", "p90"])
def test_online_baseline_matches_jax(stat):
    """Seed, decayed updates, a freeze and a thaw on the same samples:
    snapshots bitwise JAX's."""
    from microrank_tpu.stream import OnlineBaseline as JaxBaseline

    rng = np.random.default_rng(4)
    names = ("svcB_opB", "svcA_opA", "svcA_opC")
    ob, jb = OnlineBaseline(decay=0.3, slo_stat=stat), JaxBaseline(decay=0.3, slo_stat=stat)
    seed_t, seed_f = _op_table(1.0, n=300, names=names), _op_frame(1.0, n=300, names=names)
    dur = rng.lognormal(2.0, 0.5, 300) * 1000
    seed_t = seed_t._replace(duration_us=dur.astype(np.int64))
    seed_f["duration"] = dur.astype(np.int64)
    ob.seed(seed_t)
    jb.seed(seed_f)
    _assert_snapshots_equal(ob, jb)
    for k, ms in enumerate((100.0, 900.0, 300.0)):
        if k == 1:
            ob.freeze()
            jb.freeze()
        assert ob.update(_op_table(ms, names=names)) == jb.update(_op_frame(ms, names=names))
        if k == 1:
            ob.thaw()
            jb.thaw()
        _assert_snapshots_equal(ob, jb)
    assert ob.n_frozen_skips == jb.n_frozen_skips == 1 and ob.ready


def test_online_baseline_seed_is_the_batch_slo():
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table

    case = generate_case(SyntheticConfig(n_operations=16, n_traces=120, seed=4))
    table = spans_table(case.normal, case.n_operations)
    ob = OnlineBaseline(decay=0.2)
    ob.seed(table)
    vocab, base = ob.snapshot()
    bvocab, bbase = compute_slo_from_table(table)
    assert vocab.names == bvocab.names
    np.testing.assert_allclose(base.mean_ms, bbase.mean_ms, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(base.std_ms, bbase.std_ms, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------- incidents


def test_ranking_fingerprint_expands_exact_ties():
    ranking = [("a", 1.0), ("b", 0.9), ("c", 0.5), ("d", 0.5), ("e", 0.5), ("f", 0.4)]
    assert ranking_fingerprint(ranking, 3) == frozenset("abcde")
    assert ranking_fingerprint(ranking, 6) == frozenset("abcdef")
    assert ranking_fingerprint([], 5) == frozenset()


INCIDENT_SCRIPTS = {
    "lifecycle": (dict(top_k=3, resolve_after=2, cooldown_windows=2), [
        ("r", [("a", 1.0), ("b", 0.8), ("c", 0.6)]), ("r", [("a", 1.0), ("b", 0.8), ("c", 0.6)]),
        ("h", None), ("h", None), ("r", [("a", 1.0), ("b", 0.8), ("c", 0.6)]),
        ("h", None), ("h", None), ("r", [("a", 1.0), ("b", 0.8), ("c", 0.6)]),
    ]),
    "jaccard": (dict(top_k=5, resolve_after=2, jaccard=0.5), [
        ("r", [("a", 1.0), ("b", 0.9), ("c", 0.8), ("d", 0.7), ("e", 0.6)]),
        ("r", [("a", 1.0), ("b", 0.9), ("c", 0.8), ("d", 0.7), ("x", 0.6)]),
        ("r", [("p", 1.0), ("q", 0.9), ("r", 0.8), ("s", 0.7), ("t", 0.6)]),
    ]),
    "drift": (dict(top_k=3, resolve_after=2, score_drift=0.25), [
        ("r", [("a", 1.0), ("b", 0.8), ("c", 0.6)]), ("r", [("a", 1.0), ("b", 0.81), ("c", 0.6)]),
        ("r", [("b", 1.0), ("a", 0.4), ("c", 0.35)]),
    ]),
}


@pytest.mark.parametrize("script", list(INCIDENT_SCRIPTS))
def test_incident_tracker_matches_jax(registry, script):
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set
    from microrank_tpu.stream import IncidentTracker as JaxTracker

    kw, steps = INCIDENT_SCRIPTS[script]
    events = {"t": [], "j": []}

    def sink(key):
        class Sink:
            def emit(self, e):
                events[key].append(e)
        return Sink()

    old = jax_get()
    jax_set(JaxRegistry())
    try:
        t, j = IncidentTracker(sinks=[sink("t")], **kw), JaxTracker(sinks=[sink("j")], **kw)
        for k, (kind, ranking) in enumerate(steps):
            if kind == "r":
                a, b = t.observe_ranked(f"w{k}", ranking), j.observe_ranked(f"w{k}", ranking)
                assert (a is None) == (b is None)
                if a is not None:
                    assert (a.incident_id, a.windows, a.drift_events) == (
                        b.incident_id, b.windows, b.drift_events)
            else:
                assert [i.incident_id for i in t.observe_healthy(f"w{k}")] == [
                    i.incident_id for i in j.observe_healthy(f"w{k}")]
        assert (t.opened, t.resolved, t.suppressed) == (j.opened, j.resolved, j.suppressed)
    finally:
        jax_set(old)
    assert events["t"] == events["j"]
    if script == "lifecycle":
        assert [e["event"] for e in events["t"]] == [
            "incident_open", "incident_update", "incident_resolve", "incident_open"]
        assert registry.get("microrank_stream_incidents_total").value(transition="open") == 2


def test_webhook_sink_counts_failures_without_raising(registry):
    sink = WebhookIncidentSink("http://127.0.0.1:9/nope", timeout=0.2, max_attempts=1)
    sink.emit({"event": "incident_open", "top": []})
    assert sink.failures == 1 and sink.dropped == 1
    assert registry.get("microrank_webhook_dropped_total").value() == 1


# -------------------------------------------------- pool and sources


def test_build_pool_runs_off_caller_thread(registry):
    pool = BuildWorkerPool(workers=2)
    try:
        ident = pool.submit(lambda: threading.get_ident()).result(timeout=30)
        assert ident != threading.get_ident() and ident in pool.build_threads
        boom = pool.submit(lambda: 1 / 0)
        assert isinstance(boom.exception(timeout=30), ZeroDivisionError)
        assert pool.inflight == 0 and pool.builds == 2
        assert registry.get("microrank_build_pool_builds_total").value() == 2
    finally:
        pool.shutdown()


def test_replay_source_chunks_in_event_order_and_paces():
    sleeps = []
    src = ReplaySource(_table(30, 10, 20, 40), chunk_spans=2, pace_seconds=0.5,
                       sleep=sleeps.append)
    chunks = list(src)
    assert [c.table.duration_us.tolist() for c in chunks] == [[10, 20], [30, 40]]
    assert [c.first_row for c in chunks] == [0, 2]
    assert sleeps == [0.5]
    rated = ReplaySource(_table(30, 10, 20, 40), chunk_spans=2, rate=10.0, sleep=sleeps.append)
    list(rated)
    assert rated.sleeps == [1.0]  # 20 s of event time to the next chunk, at 10x


def test_file_tail_source_yields_only_new_rows(tmp_path, registry):
    from microrank_tpu_torch.testing.synthetic import write_spans_csv

    case = generate_case(SyntheticConfig(n_operations=10, n_traces=40, seed=2))
    full = tmp_path / "full.csv"
    write_spans_csv(case.normal, full, case.n_operations)
    lines = full.read_bytes().splitlines(keepends=True)
    csv = tmp_path / "grow.csv"
    half = (len(lines) - 1) // 2
    csv.write_bytes(b"".join(lines[: 1 + half]))
    src = FileTailSource(csv, poll_seconds=0, max_polls=3, sleep=lambda s: None)
    it = iter(src)
    first = next(it)
    with open(csv, "ab") as f:
        f.write(b"".join(lines[1 + half:]))
    second = next(it)
    assert len(first) == half and len(second) == len(lines) - 1 - half
    assert second.first_row == half
    assert registry.get("microrank_follow_polls_total").value() >= 2
