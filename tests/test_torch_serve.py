"""The online RCA service (``microrank_tpu_torch.serve``, ``cli serve``)
on the CPU, mirroring the JAX package's serve tests (tests/test_serve.py,
and the serve tests of test_chaos.py, test_explain.py and test_spans.py)
on JAX's fixture: ``generate_case(24 ops, 120 traces, seed 7)``, whose
spans the port's generator reproduces; the inline payload is JAX's own
(its frame's records with string times).

Tolerances:

* a served ranking is tie-aware top-5 equal to JAX's serve answer on the
  same payload (rtol 1e-5);
* it is bitwise the port's own ``TableRCA`` answer for the same rows
  (its detection, build and one-window program), batched or not;
* a degraded answer is bitwise the port's ``NumpyRefBackend`` on the
  window (which tests/test_torch_numpy_ref.py holds to JAX's);
* a ``cli run`` line of ``windows.jsonl`` has JAX's 22 keys, and JAX's
  values (rankings tie-aware at rtol 1e-5, the timings keys apart).

Warmup raises on a failed dispatch (JAX's degrades): a test shows it
with an injected failure.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig, ServeConfig
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, read_journal, set_registry
from microrank_tpu_torch.obs.spans import get_tracer
from microrank_tpu_torch.pipeline.results import WindowResult
from microrank_tpu_torch.serve import (
    AdmissionController,
    DeadlineExceeded,
    ProtocolError,
    RankRequest,
    ServeHandle,
    ServeService,
    ShutdownError,
    parse_rank_request,
    spans_to_table,
)
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.testing.synthetic import spans_table
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

ROOT = Path(__file__).resolve().parents[1]
SYNTH = dict(n_operations=24, n_traces=120, seed=7)
RTOL = 1e-5


@pytest.fixture
def registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


@pytest.fixture(autouse=True)
def manifest_dir(tmp_path, monkeypatch):
    """Each test its own warmup-manifest directory."""
    monkeypatch.setenv("MICRORANK_JIT_CACHE", str(tmp_path / "jit"))


@pytest.fixture(scope="module")
def case():
    return generate_case(SyntheticConfig(**SYNTH))


@pytest.fixture(scope="module")
def tables(case):
    """(normal, abnormal) as the loader reads the case's CSVs."""
    return (spans_table(case.normal, case.n_operations),
            spans_table(case.abnormal, case.n_operations))


@pytest.fixture(scope="module")
def jax_case():
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing import generate_case as jax_generate

    return jax_generate(JaxSynth(**SYNTH))


def _records(frame):
    df = frame.copy()
    df["startTime"] = df["startTime"].astype(str)
    df["endTime"] = df["endTime"].astype(str)
    return df.to_dict("records")


@pytest.fixture(scope="module")
def spans_payload(jax_case):
    return {"spans": _records(jax_case.abnormal)}


@pytest.fixture(scope="module")
def jax_answer(jax_case, spans_payload):
    """JAX's serve answer to the inline payload."""
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import ServeConfig as JaxServe
    from microrank_tpu.serve import RankRequest as JaxRequest
    from microrank_tpu.serve import ServeService as JaxService

    svc = JaxService(JaxConfig(serve=JaxServe(warmup=False, max_wait_ms=0.0)))
    svc.fit_baseline(jax_case.normal)
    svc.start()
    try:
        return svc.submit(JaxRequest(request_id="jax", spans=spans_payload["spans"])).result(120)
    finally:
        svc.shutdown()


def _config(**serve_kw):
    serve_kw.setdefault("warmup", False)
    serve_kw.setdefault("max_wait_ms", 2000.0)
    return MicroRankConfig(serve=ServeConfig(**serve_kw), runtime=RuntimeConfig(device="cpu"))


def _service(tables, tmp_path=None, **serve_kw):
    svc = ServeService(_config(**serve_kw), out_dir=tmp_path)
    svc.fit_baseline(tables[0])
    return svc


def _post(port, payload, timeout=120, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rank", data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def _table_rca_answer(tables, cfg=None):
    """The port's TableRCA ranking of the abnormal table's rows as one
    window: admission, the C++ detector, the build, one program."""
    from microrank_tpu_torch.ingest import admit_table
    from microrank_tpu_torch.pipeline import TableRCA

    cfg = cfg or _config()
    rca = TableRCA(cfg, device="cpu")
    rca.fit_baseline(tables[0])
    table, _ = admit_table(tables[1], cfg.ingest)
    mask, nrm, abn, _, rng = rca._detect_window(table, int(table.start_us.min()),
                                                int(table.end_us.max()))
    graph, names, kernel = rca.prepare_rank(table, mask, nrm, abn, row_range=rng)
    names, scores, conv = rca.finalize_rank(rca.launch_rank(graph, names, kernel))
    return list(zip(names, scores)), conv["iterations"], kernel


def _agree(a, b):
    na, sa = zip(*a)
    nb, sb = zip(*b)
    return tie_aware_topk_agreement(list(na), list(sa), list(nb), list(sb),
                                    min(5, len(na)), rtol=RTOL)


# ---------------------------------------------------------------- protocol

BAD_BODIES = [b"{nope", b"[1]", b"{}", b'{"spans": [{}], "dataset": "d"}', b'{"spans": []}',
              b'{"spans": [1]}', b'{"dataset": "d", "deadline_ms": "x"}',
              b'{"dataset": "d", "deadline_ms": 0}']


def test_parse_rank_request_validates():
    with pytest.raises(ProtocolError, match="not JSON"):
        parse_rank_request(b"{nope")
    with pytest.raises(ProtocolError, match="JSON object"):
        parse_rank_request(b"[1]")
    with pytest.raises(ProtocolError, match="exactly one"):
        parse_rank_request(b"{}")
    with pytest.raises(ProtocolError, match="exactly one"):
        parse_rank_request(b'{"spans": [{}], "dataset": "d"}')
    with pytest.raises(ProtocolError, match="non-empty"):
        parse_rank_request(b'{"spans": []}')
    r = parse_rank_request(b'{"dataset": "d", "tenant": "t1"}')
    assert r.dataset == "d" and r.tenant == "t1" and r.request_id
    r2 = parse_rank_request(b'{"spans": [{"a": 1}], "request_id": "abc"}')
    assert r2.request_id == "abc" and r2.tenant == "default"


@pytest.mark.parametrize("body", BAD_BODIES)
def test_protocol_messages_are_jax(body):
    from microrank_tpu.serve import ProtocolError as JaxProtocolError
    from microrank_tpu.serve import parse_rank_request as jax_parse

    with pytest.raises(JaxProtocolError) as theirs:
        jax_parse(body)
    with pytest.raises(ProtocolError) as ours:
        parse_rank_request(body)
    assert str(ours.value) == str(theirs.value)


def test_traceparent_and_server_timing_are_jax():
    from microrank_tpu.serve import protocol as jp
    from microrank_tpu_torch.serve import protocol as tp

    for value in ("00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01", "nope", None,
                  "00-" + "0" * 32 + "-b7ad6b7169203331-01"):
        assert tp.parse_traceparent(value) == jp.parse_traceparent(value)
    for ids in (("win-2024", "s0000002a"), ("0af7651916cd43dd8448eb211c80319c", "s0")):
        assert tp.format_traceparent(*ids) == jp.format_traceparent(*ids)
    timings = {"queue_ms": 1.5, "parse_ms": 0.25, "build": 3.0, "rank_ms": 2.0}
    assert tp.server_timing_header(timings) == jp.server_timing_header(timings)
    assert tp.error_body("x", a=1) == jp.error_body("x", a=1)


def test_spans_to_table_is_the_loader_table(case, tables, spans_payload, tmp_path):
    """Inline records give the table the loader reads from the same CSV
    (names, codes, parents, times), and a missing column is a 400."""
    from microrank_tpu_torch.native import load_span_table

    _, abnormal_csv = case.write_csvs(tmp_path)
    loaded = load_span_table(abnormal_csv, cache=False)
    table = spans_to_table(spans_payload["spans"])
    assert table.n_spans == len(spans_payload["spans"])
    for f in table._fields:
        a, b = getattr(table, f), getattr(loaded, f)
        assert (np.array_equal(a, b) and a.dtype == b.dtype) if hasattr(a, "dtype") else a == b, f
    with pytest.raises(ProtocolError, match="missing required columns"):
        spans_to_table([{"traceID": "t1"}])
    # ClickHouse export names rename as the loader renames them.
    raw = [{"TraceId": r["traceID"], "SpanId": r["spanID"], "ParentSpanId": r["ParentSpanId"],
            "SpanName": r["operationName"], "ServiceName": r["serviceName"],
            "PodName": r["podName"], "Duration": r["duration"], "TraceStart": r["startTime"],
            "TraceEnd": r["endTime"]} for r in spans_payload["spans"]]
    assert (spans_to_table(raw).pod_op == table.pod_op).all()


def test_unparseable_timestamp_is_quarantined_not_fatal(tables, spans_payload, registry,
                                                       tmp_path):
    """A row whose time does not parse goes to the dead-letter store
    (bad_timestamp) and the rest ranks; nothing clean answers 422."""
    svc = _service(tables, tmp_path=tmp_path, max_wait_ms=0.0, build_workers=0)
    svc.start()
    try:
        spans = [dict(r) for r in spans_payload["spans"]]
        spans[0]["startTime"] = "not a time"
        result = svc.submit(RankRequest(request_id="bad-ts", spans=spans)).result(60)
        assert result.ranking and result.degraded_input and result.ingest_rejected >= 1
        lines = (tmp_path / "quarantine.jsonl").read_text().splitlines()
        assert {json.loads(x)["reason"] for x in lines} == {"bad_timestamp"}
        junk = [dict(r, startTime="x") for r in spans_payload["spans"][:5]]
        with pytest.raises(ProtocolError, match="no span rows survived admission") as e:
            svc.submit(RankRequest(request_id="all-bad", spans=junk)).result(60)
        assert e.value.status == 422
    finally:
        svc.shutdown()


# --------------------------------------------------------------- admission


def test_admission_controller_bounds_depth(registry):
    adm = AdmissionController(max_depth=2)
    assert adm.try_admit() and adm.try_admit()
    assert not adm.try_admit()
    assert adm.depth == 2
    adm.release()
    assert adm.try_admit()
    adm.close()
    adm.release()
    assert not adm.try_admit()  # closed admits nothing
    # Retry-After: the floor until a window was measured, then depth x cost.
    adm2 = AdmissionController(max_depth=8, retry_after_seconds=1.0)
    assert adm2.retry_after() == 1.0
    for _ in range(4):
        adm2.try_admit()
    adm2.observe_window_cost(2.0)
    assert adm2.retry_after() == 8.0


# ------------------------------------------------------------ fair dequeue


def test_scheduler_pops_round_robin_across_tenants(tables, registry):
    svc = _service(tables)
    sched = svc.scheduler  # not started: drive _pop_fair
    for tenant, rid in [("a", "a1"), ("a", "a2"), ("a", "a3"), ("b", "b1"), ("b", "b2")]:
        sched.submit(RankRequest(request_id=rid, tenant=tenant))
    order = []
    while (entry := sched._pop_fair(timeout=0)) is not None:
        order.append(entry[0].request_id)
    assert order == ["a1", "b1", "a2", "b2", "a3"]


# ------------------------------------------------- batching + degradation


def test_concurrent_requests_coalesce_into_one_dispatch(tables, spans_payload, jax_answer,
                                                        registry, tmp_path):
    """Four concurrent requests (inline and staged) -> one stacked
    program; each answer bitwise TableRCA's for the rows and tie-aware
    JAX's serve answer."""
    # The reference first: while the service lives its scheduler thread
    # owns the card, and a rank program from this thread would fail the
    # owner check (utils.guards).
    want, iters, kernel = _table_rca_answer(tables)
    svc = _service(tables, tmp_path=tmp_path, max_batch_windows=4)
    svc.add_dataset("case7", tables[1])
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        payloads = [{**spans_payload, "tenant": "t0"}, {"dataset": "case7", "tenant": "t1"},
                    {**spans_payload, "tenant": "t2"}, {"dataset": "case7", "tenant": "t3"}]
        with ThreadPoolExecutor(4) as ex:
            results = list(ex.map(lambda p: _post(port, p), payloads))
        for status, body, _ in results:
            assert status == 200
            assert body["anomaly"] is True and body["degraded"] is False
            assert body["batch_windows"] == 4 and body["route"] == "vmapped"
            got = [(n, s) for n, s in body["ranking"]]
            assert got == want  # bitwise TableRCA's
            assert body["rank_iterations"] == iters and body["kernel"] == kernel
            ok, why = _agree(jax_answer.ranking, got)
            assert ok, why
            assert set(body) == set(dataclasses.asdict(jax_answer))
        assert svc.scheduler.batcher.dispatches == 1
        assert registry.get("microrank_serve_last_batch_windows").value() > 1
        _, prom = _get(port, "/metrics")
        assert b"microrank_serve_batch_windows_bucket" in prom
        _, health = _get(port, "/healthz")
        assert json.loads(health)["status"] == "ok"
        _, snap = _get(port, "/metrics.json")
        assert "microrank_serve_requests_total" in json.loads(snap)["metrics"]
    finally:
        handle.stop()
    events = read_journal(tmp_path / "journal.jsonl")
    batches = [e for e in events if e["event"] == "serve_batch"]
    assert len(batches) == 1 and batches[0]["occupancy"] == 4
    assert len([e for e in events if e["event"] == "window"]) == 4


def test_admission_control_answers_429_with_retry_after(tables, spans_payload, registry):
    svc = _service(tables, max_batch_windows=8, max_wait_ms=4000.0, max_queue_depth=2,
                   retry_after_seconds=2.0)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        with ThreadPoolExecutor(2) as ex:
            parked = [ex.submit(_post, port, {**spans_payload, "tenant": t}) for t in "ab"]
            deadline = time.monotonic() + 10
            while svc.admission.depth < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            status, body, headers = _post(port, {**spans_payload, "tenant": "c"})
            assert status == 429
            assert "queue is full" in body["error"]
            assert headers.get("Retry-After") == "2"
            for f in parked:  # the admitted requests are not dropped
                s, b, _ = f.result()
                assert s == 200 and b["ranking"]
        assert registry.get("microrank_serve_requests_total").value(outcome="rejected") >= 1
    finally:
        handle.stop()


def test_injected_dispatch_failure_degrades_to_numpy(tables, spans_payload, jax_answer,
                                                     registry, tmp_path, caplog):
    """Both attempts fail (injected): every member is ranked on
    numpy_ref, answered degraded, counted, logged at ERROR and dumped by
    the flight recorder; the next request is not degraded."""
    from microrank_tpu_torch.rank_backends import NumpyRefBackend

    svc = _service(tables, tmp_path=tmp_path, max_batch_windows=2,
                   inject_dispatch_failures=2)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        with caplog.at_level(logging.ERROR, logger="microrank_tpu_torch.serve"):
            with ThreadPoolExecutor(2) as ex:
                results = list(ex.map(lambda t: _post(port, {**spans_payload, "tenant": t}),
                                      "ab"))
        table = spans_to_table(spans_payload["spans"])
        from microrank_tpu_torch.graph.table_ops import detect_window_partition

        _, nrm, abn, _ = detect_window_partition(
            table, int(table.start_us.min()), int(table.end_us.max()), svc.slo_vocab,
            svc.baseline, svc.config.detector)
        names, scores = NumpyRefBackend(svc.config).rank_window(table, nrm, abn)
        for status, body, _ in results:
            assert status == 200
            assert body["degraded"] is True and body["kernel"] == "numpy_ref"
            assert body["ranking"] == [[n, s] for n, s in zip(names, scores)]  # bitwise
            ok, why = _agree(jax_answer.ranking, [tuple(x) for x in body["ranking"]])
            assert ok, why
        assert registry.get("microrank_serve_degraded_total").value() == 2
        assert any("degrading 2 windows to numpy_ref" in r.getMessage()
                   for r in caplog.records if r.levelno == logging.ERROR)
        status, body, _ = _post(port, spans_payload)
        assert status == 200 and body["degraded"] is False
    finally:
        handle.stop()
    reasons = [d.name.rsplit("-", 1)[-1] for d in sorted((tmp_path / "flight").iterdir())]
    assert reasons[0] == "degraded"


def test_failed_dispatch_without_fallback_answers_500(tables, spans_payload, registry):
    svc = _service(tables, fallback=False, inject_dispatch_failures=2, max_batch_windows=1)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        status, body, _ = _post(port, spans_payload)
        assert status == 500 and "injected" in body["error"]
    finally:
        handle.stop()


def test_failed_dispatch_on_the_card_answers_500_not_numpy(registry, tmp_path, caplog):
    """On a CUDA router a batch whose dispatch fails twice fails (500),
    ``fallback`` on or not: the service never answers from the host in
    place of its kernels. The flight recorder still dumps ``degraded``
    and the log has an ERROR line; nothing is counted degraded."""
    import torch

    from microrank_tpu_torch.obs.flight import FlightRecorder
    from microrank_tpu_torch.serve.batcher import MicroBatcher, PendingWindow

    class CardRouter:  # the batcher reads the device; injection fails first
        device = torch.device("cuda")

    cfg = _config(inject_dispatch_failures=2)
    assert cfg.serve.fallback
    batcher = MicroBatcher(cfg, router=CardRouter(),
                           flight=FlightRecorder(tmp_path, cfg.obs))
    assert not batcher.fallback()
    pw = PendingWindow(request=RankRequest(request_id="card", spans=[{}]),
                       result=WindowResult(start="s", end="e", anomaly=True), table=None,
                       normal_ids=[], abnormal_ids=[], graph=None, op_names=[], kernel="kind",
                       future=Future(), enqueued=time.monotonic())
    with caplog.at_level(logging.ERROR, logger="microrank_tpu_torch.serve"):
        batcher.dispatch([pw])
    with pytest.raises(RuntimeError, match="injected"):
        pw.future.result(timeout=0)
    assert not pw.result.degraded and pw.result.kernel != "numpy_ref"
    assert registry.get("microrank_serve_degraded_total").value() == 0
    assert any("failing 1 requests on cuda" in r.getMessage() for r in caplog.records
               if r.levelno == logging.ERROR)
    assert [d.name.rsplit("-", 1)[-1] for d in (tmp_path / "flight").iterdir()] == ["degraded"]


def test_failed_explain_answers_500(tables, spans_payload, registry, monkeypatch, caplog):
    """An ``explain: true`` request whose explained program fails is
    answered 500 with the error (and an ERROR line), not with its
    ranking and no bundle; a request that did not ask still ranks."""
    from microrank_tpu_torch.rank_backends import blob

    staged = blob.stage_rank_window

    def broken(*a, explain=None, **k):
        if explain is not None:
            raise RuntimeError("injected explain failure")
        return staged(*a, explain=explain, **k)

    monkeypatch.setattr(blob, "stage_rank_window", broken)
    svc = _service(tables, max_wait_ms=50.0)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        with caplog.at_level(logging.ERROR, logger="microrank_tpu_torch.serve"):
            status, body, _ = _post(port, {**spans_payload, "explain": True,
                                           "request_id": "r-exp"})
        assert status == 500 and "injected explain failure" in body["error"], body
        assert body["request_id"] == "r-exp"
        assert any("explain dispatch failed for r-exp" in r.getMessage()
                   for r in caplog.records if r.levelno == logging.ERROR)
        assert registry.get("microrank_explain_bundles_total").value(trigger="request") == 0
        assert registry.get("microrank_serve_requests_total").value(outcome="failed") == 1
        status, body, _ = _post(port, spans_payload)
        assert status == 200 and body["ranking"] and body.get("explain") is None
    finally:
        handle.stop()


# ------------------------------------------------------- clean / invalid


def test_clean_window_and_bad_requests(tables, jax_case, registry):
    svc = _service(tables, max_wait_ms=50.0)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        status, body, _ = _post(port, {"spans": _records(jax_case.normal)})
        assert status == 200
        assert body["anomaly"] is False and body["ranking"] == []
        status, body, _ = _post(port, {"dataset": "nope"})
        assert status == 400 and "unknown dataset" in body["error"]
        status, body, _ = _post(port, {"tenant": "x"})
        assert status == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        handle.stop()


def test_dataset_window_cut(tables, registry):
    """A staged dataset's [start, end] cut ranks the same rows as the
    whole dump when the range covers it, and an empty range is a 400."""
    svc = _service(tables, max_wait_ms=0.0, build_workers=0)
    svc.add_dataset("case", tables[1])
    svc.start()
    try:
        whole = svc.submit(RankRequest(request_id="w", dataset="case")).result(60)
        cut = svc.submit(RankRequest(request_id="c", dataset="case", start=whole.start,
                                     end=whole.end)).result(60)
        assert cut.ranking == whole.ranking and cut.n_traces == whole.n_traces
        with pytest.raises(ProtocolError, match="has no spans"):
            svc.submit(RankRequest(request_id="e", dataset="case", start="2001-01-01 00:00:00",
                                   end="2001-01-01 00:01:00")).result(60)
    finally:
        svc.shutdown()


# ------------------------------------------------------------------ drain


def test_drain_completes_parked_requests(tables, spans_payload, registry):
    """Drain: requests parked in a bucket (max_wait not reached) are
    flushed and answered before the scheduler thread exits."""
    svc = _service(tables, max_batch_windows=8, max_wait_ms=60_000.0)
    svc.start()
    futs = [svc.submit(RankRequest(request_id=f"r{i}", tenant=f"t{i}",
                                   spans=spans_payload["spans"])) for i in range(2)]
    deadline = time.monotonic() + 30
    while svc.scheduler.batcher.pending() < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert svc.scheduler.batcher.pending() == 2
    assert svc.scheduler.batcher.dispatches == 0
    svc.shutdown(drain=True)
    for f in futs:
        result = f.result(timeout=60)
        assert result.ranking and result.batch_windows == 2
    assert not svc.scheduler.is_alive()


def test_shutdown_without_drain_fails_queued_fast(tables, registry):
    svc = _service(tables)
    svc.start()
    svc.scheduler.stop(drain=False, timeout=30)
    fut = svc.scheduler.submit(RankRequest(request_id="late", tenant="t", spans=[{"a": 1}]))
    with pytest.raises(ShutdownError):
        fut.result(timeout=10)


def test_deadline_expires_queued_request(tables, registry, tmp_path):
    """A request whose deadline elapsed in the queue expires before its
    build (504, outcome expired, journal event); a parked window past
    its deadline expires at dispatch."""
    from microrank_tpu_torch.serve.batcher import PendingWindow

    svc = ServeService(_config(build_workers=0), out_dir=tmp_path)
    svc.fit_baseline(tables[0])
    outcomes = []
    svc._on_done = lambda pw, err: outcomes.append(type(err).__name__ if err else None)
    req = RankRequest(request_id="r-exp", dataset="case", deadline_ms=50.0)
    fut = Future()
    svc.scheduler._process((req, fut, time.monotonic() - 1.0, svc._on_done, None))
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)
    assert outcomes == ["DeadlineExceeded"]
    expired = [e for e in read_journal(tmp_path / "journal.jsonl")
               if e["event"] == "request_deadline_expired"]
    assert len(expired) == 1 and expired[0]["stage"] == "queue"
    pw = PendingWindow(
        request=RankRequest(request_id="r-exp2", dataset="case", deadline_ms=50.0),
        result=WindowResult(start="", end="", anomaly=True), table=None, normal_ids=[],
        abnormal_ids=[], graph=None, op_names=[], kernel="kind", future=Future(),
        enqueued=time.monotonic() - 1.0)
    svc.scheduler.batcher.dispatch([pw])
    with pytest.raises(DeadlineExceeded):
        pw.future.result(timeout=5)
    assert pw.result.skipped_reason == "deadline_expired"
    assert svc.scheduler.batcher.dispatches == 0


# ------------------------------------------ explain, traceparent, spans


def test_serve_explain_traceparent_server_timing(tables, spans_payload, registry, tmp_path):
    """explain:true returns the bundle (one explained program; on the
    card K15 once, counted by chip_smoke) held to the float64 oracle;
    traceparent joins the caller's trace; every 200 carries
    Server-Timing. A request that did not ask pays nothing."""
    from microrank_tpu_torch.explain import get_explain_store

    svc = _service(tables, tmp_path=tmp_path)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    trace_id, parent = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    try:
        status, body, headers = _post(
            port, {**spans_payload, "explain": True, "request_id": "r-exp"},
            headers={"traceparent": f"00-{trace_id}-{parent}-01"})
        assert status == 200 and body["anomaly"] is True
        exp = body["explain"]
        assert exp["trigger"] == "request" and exp["window"]["request_id"] == "r-exp"
        assert exp["suspects"][0]["op"] == body["ranking"][0][0]
        assert set(exp["suspects"][0]["counters"]) == {"ef", "nf", "ep", "np"}
        assert exp["suspects"][0]["top_traces"]["abnormal"]
        timing = headers.get("Server-Timing", "")
        for stage in ("queue", "parse", "admit", "detect", "build", "rank"):
            assert f"{stage};dur=" in timing, timing
        ring = [s for s in get_tracer().snapshot() if s.trace_id == trace_id]
        assert {"request", "explain"} <= {s.name for s in ring}
        assert {s.parent_id for s in ring if s.name == "request"} == {parent}
        assert registry.get("microrank_explain_bundles_total").value(trigger="request") == 1
        assert get_explain_store().get(str(body["start"])) is not None
        dispatches = svc.scheduler.batcher.dispatches
        status2, body2, headers2 = _post(port, spans_payload)
        assert status2 == 200 and body2.get("explain") is None
        assert "Server-Timing" in headers2
        assert svc.scheduler.batcher.dispatches == dispatches + 1
        assert registry.get("microrank_explain_bundles_total").value(trigger="request") == 1
    finally:
        handle.stop()
    _bundle_matches_oracle(tables, spans_payload, svc, exp)


def _bundle_matches_oracle(tables, spans_payload, svc, exp):
    """The bundle's suspects against the float64 oracle over the same
    window's uncollapsed build (tie-aware, rtol 1e-3, as the explain
    phase holds it)."""
    from microrank_tpu_torch.explain.oracle import explain_window_oracle
    from microrank_tpu_torch.graph.table_ops import (
        build_window_graph_from_table,
        detect_window_partition,
    )

    table = spans_to_table(spans_payload["spans"])
    mask, nrm, abn, _ = detect_window_partition(
        table, int(table.start_us.min()), int(table.end_us.max()), svc.slo_vocab,
        svc.baseline, svc.config.detector)
    g, names, cn, ca = build_window_graph_from_table(table, mask, nrm, abn, aux="none")
    oracle = explain_window_oracle(g, names, [table.trace_names[c] for c in cn],
                                   [table.trace_names[c] for c in ca],
                                   aggregate_kinds=exp.get("collapsed", False))
    got = [(s["op"], s["score"]) for s in exp["suspects"]][:5]
    want = [(s["op"], s["score"]) for s in oracle["suspects"]][:5]
    ok, why = tie_aware_topk_agreement([n for n, _ in want], [s for _, s in want],
                                       [n for n, _ in got], [s for _, s in got],
                                       min(5, len(got)), rtol=1e-3)
    assert ok, why


def test_scheduler_and_pool_propagate_request_trace(tables, registry):
    svc = _service(tables, build_workers=2, max_wait_ms=0.0)
    svc.add_dataset("case", tables[1])
    svc.start()
    try:
        result = svc.submit(RankRequest(request_id="req-traced", dataset="case")).result(120)
        assert result.ranking
    finally:
        svc.shutdown()
    spans = [s for s in get_tracer().snapshot() if s.trace_id == "req-traced"]
    names = {s.name for s in spans}
    assert {"parse", "admit", "detect", "build", "request", "device_dispatch"} <= names
    assert "serve-build" in next(s for s in spans if s.name == "build").thread
    root = next(s for s in spans if s.name == "request")
    assert next(s for s in spans if s.name == "parse").parent_id == root.span_id


# ------------------------------------------------- build pool + warmup


def test_builds_run_off_scheduler_thread(tables, spans_payload, registry):
    svc = _service(tables, max_wait_ms=50.0)
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        status, body, _ = _post(port, spans_payload)
        assert status == 200 and body["ranking"]
        assert svc.build_pool is not None and svc.build_pool.builds >= 1
        assert svc.scheduler.ident not in svc.build_pool.build_threads
    finally:
        handle.stop()


def test_serial_builds_without_pool_still_serve(tables, spans_payload, registry):
    svc = _service(tables, max_wait_ms=50.0, build_workers=0)
    assert svc.build_pool is None
    svc.start()
    handle = ServeHandle(svc)
    port = handle.start()
    try:
        status, body, _ = _post(port, spans_payload)
        assert status == 200 and body["ranking"]
    finally:
        handle.stop()


def test_warmup_occupancies_configurable(tables, registry, tmp_path):
    svc = _service(tables, warmup=True, warmup_occupancies=(1,), max_batch_windows=4)
    svc.start()
    try:
        # One warmup dispatch (occupancy 1), through the router directly.
        assert svc.router.dispatches == 1
        assert svc.scheduler.batcher.dispatches == 0
        assert svc.warmup_seconds is not None
        assert registry.get("microrank_compile_cache_events_total").value(event="hit") == 1
    finally:
        svc.shutdown()


def test_warmup_occupancies_validated_against_max_batch(tables, registry):
    svc = _service(tables, warmup=True, warmup_occupancies=(1, 9), max_batch_windows=4)
    with pytest.raises(ValueError, match="warmup_occupancies"):
        svc.start()
    svc.shutdown()


def test_warmup_raises_on_failed_dispatch(tables, registry, monkeypatch):
    """A warmup dispatch that fails raises out of start() (the service
    never answers from the CPU oracle instead of its kernels); nothing
    degrades and the scheduler never starts."""
    svc = _service(tables, warmup=True, warmup_occupancies=(1,))

    def broken(*a, **k):
        raise RuntimeError("injected warmup dispatch failure")

    monkeypatch.setattr(svc.router, "rank_batch", broken)
    with pytest.raises(RuntimeError, match="injected warmup dispatch failure"):
        svc.start()
    assert not svc.scheduler.is_alive()
    assert registry.get("microrank_serve_degraded_total").value() == 0
    svc.shutdown()


# ------------------------------------------------------------- CLI smoke


def test_serve_cli_sigterm_drains(case, tmp_path):
    """``cli serve --device cpu``: one request over HTTP, SIGTERM, a
    clean drain (exit 0) with the journal, the metrics snapshot and a
    ``sigterm`` flight dump; --mesh and --backfill refuse."""
    from microrank_tpu_torch import cli

    normal_csv, abnormal_csv = case.write_csvs(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = tmp_path / "serve_out"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "MICRORANK_JIT_CACHE": str(tmp_path / "jit")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "microrank_tpu_torch.cli", "serve", "--device", "cpu",
         "--normal", str(normal_csv), "--dataset", f"case={abnormal_csv}",
         "--port", str(port), "-o", str(out_dir), "--no-warmup", "--max-wait-ms", "50"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline, up = time.monotonic() + 120, False
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                up = _get(port, "/healthz")[0] == 200
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.25)
        assert up, "server never came up"
        status, body, _ = _post(port, {"dataset": "case"}, timeout=120)
        assert status == 200 and body["ranking"]
        assert b"microrank_serve_requests_total" in _get(port, "/metrics")[1]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        assert "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    events = read_journal(out_dir / "journal.jsonl")
    assert events[0]["event"] == "run_start" and events[-1]["event"] == "run_end"
    assert any(e["event"] == "serve_batch" for e in events)
    assert (out_dir / "metrics.json").exists()
    assert [d.name.rsplit("-", 1)[-1] for d in (out_dir / "flight").iterdir()] == ["sigterm"]
    with pytest.raises(NotImplementedError, match="item 12"):
        cli.main(["serve", "--device", "cpu", "--normal", str(normal_csv), "--mesh", "x"])


def test_backfill_codeployed_with_serve(tables, spans_payload, registry, tmp_path):
    """A warehouse replayed on the device scheduler's backfill lane while
    the service answers: serve's answers are its solo answers, the
    replay report matches the stored verdicts, both lanes charged."""
    import threading

    from microrank_tpu_torch.config import (
        DispatchConfig,
        SchedConfig,
        StreamConfig,
        WarehouseConfig,
    )
    from microrank_tpu_torch.sched import DeviceScheduler, ParkedWindowStore
    from microrank_tpu_torch.stream import StreamEngine, SyntheticSource
    from microrank_tpu_torch.warehouse import replay_range

    wh_cfg = MicroRankConfig(stream=StreamConfig(allowed_lateness_seconds=0.0),
                             runtime=RuntimeConfig(device="cpu"),
                             dispatch=DispatchConfig(warmup_manifest=False),
                             warehouse=WarehouseConfig(enabled=True))
    src = SyntheticSource(6, [2, 3], SyntheticConfig(n_operations=16, n_traces=80, seed=3))
    StreamEngine(wh_cfg, src, out_dir=tmp_path / "run").run()
    solo_svc = _service(tables, max_wait_ms=0.0)
    solo_svc.start()
    try:
        solo = solo_svc.submit(RankRequest(request_id="solo", **spans_payload)).result(120)
    finally:
        solo_svc.shutdown(drain=True)

    cfg = _config(max_wait_ms=0.0).replace(sched=SchedConfig(backfill_tenant="bf"))
    store = ParkedWindowStore(cfg.sched, serve_cfg=cfg.serve)
    sched = DeviceScheduler(store)
    sched.start()
    report = {}
    try:
        svc = ServeService(cfg, sched=sched)
        svc.fit_baseline(tables[0])
        svc.start()
        t = threading.Thread(target=lambda: report.update(replay_range(
            tmp_path / "run", config=cfg, sched=sched)), name="co-backfill")
        t.start()
        answers = [svc.submit(RankRequest(request_id=f"co{i}", tenant=f"t{i}",
                                          **spans_payload)).result(120) for i in range(3)]
        t.join(120)
        assert not t.is_alive()
        svc.shutdown(drain=True)
    finally:
        sched.stop(drain=True, timeout=60)
    assert all(a.ranking == solo.ranking and a.rank_iterations == solo.rank_iterations
               for a in answers)
    assert report["verdict"] == "match" and report["ranked"] == report["matched"] == 2
    shares = store.tenant_shares()
    assert shares.get("bf", 0) >= 1 and shares.get("t0") == 1
    assert sched.errors == 0


# ------------------------------------------------- windows.jsonl contract


def test_cli_run_windows_jsonl_is_jax(case, tmp_path):
    """A ``cli run`` line of windows.jsonl: JAX's 22 keys, JAX's values
    (timings apart: their keys are each lane's own stages)."""
    from microrank_tpu.cli.main import main as jax_main
    from microrank_tpu_torch import cli

    normal_csv, abnormal_csv = case.write_csvs(tmp_path / "data")
    assert jax_main(["run", "--normal", str(normal_csv), "--abnormal", str(abnormal_csv),
                     "-o", str(tmp_path / "jax")]) == 0
    assert cli.main(["run", "--device", "cpu", "--normal", str(normal_csv), "--abnormal",
                     str(abnormal_csv), "-o", str(tmp_path / "port")]) == 0
    jl = [json.loads(x) for x in (tmp_path / "jax" / "windows.jsonl").read_text().splitlines()]
    pl = [json.loads(x) for x in (tmp_path / "port" / "windows.jsonl").read_text().splitlines()]
    assert len(jl) == len(pl) and any(r["ranking"] for r in pl)
    assert list(pl[0]) == [f.name for f in dataclasses.fields(WindowResult)]
    assert len(pl[0]) == 22
    for a, b in zip(jl, pl):
        assert list(a) == list(b)
        for key in a:
            if key == "ranking":
                if a[key]:
                    ok, why = _agree([tuple(x) for x in a[key]], [tuple(x) for x in b[key]])
                    assert ok, why
            elif key == "rank_residual":
                assert (a[key] is None) == (b[key] is None)
                if a[key] is not None:
                    assert b[key] == pytest.approx(a[key], rel=1e-3, abs=1e-6)
            elif key != "timings":
                assert a[key] == b[key], key
