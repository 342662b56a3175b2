"""The port's window loop (``TableRCA.run``) against the JAX package's on
the same timeline CSVs: the pipelined modes (sync, async stream, bulk),
the resume cursor, ``end_us`` / ``complete_only``, the run journal and
the CLI flags. The timeline comes from the port's generator, held first
to JAX's. Admission is off in both packages and JAX's tuned policy is
off (as in tests/test_torch_pipeline.py). The port's variants must agree
with each other bitwise (the same kernels in the same order); each
agrees with JAX's same variant tie-aware at rtol 1e-5 (kind, f32).
"""

import csv
import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import read_journal as jax_read_journal
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu.pipeline.checkpoint import WindowCursor as JaxCursor
from microrank_tpu.testing import SyntheticConfig as JaxSynthetic
from microrank_tpu.testing.synthetic import generate_timeline as jax_timeline
from microrank_tpu.testing.synthetic import (
    generate_timeline_with_spans as jax_timeline_with_spans,
)
from microrank_tpu_torch import cli, native
from microrank_tpu_torch.config import IngestConfig, MicroRankConfig, RuntimeConfig
from microrank_tpu_torch.obs import JOURNAL_NAME, read_journal
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.pipeline.checkpoint import WindowCursor
from microrank_tpu_torch.rank_backends.torch_cuda import (
    fetch_rank_outputs,
    pack_rank_outputs,
    unpack_rank_outputs,
)
from microrank_tpu_torch.testing import (
    SyntheticConfig,
    generate_timeline,
    generate_timeline_with_spans,
)
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

TIMELINE = dict(n_operations=24, n_traces=120, n_kinds=24, child_keep_prob=0.6, seed=9)
N_WINDOWS, FAULTED = 5, [0, 1, 3]

# The loop's modes, as tests/test_pipeline.py drives JAX's.
VARIANTS = {
    "sync_depth1": dict(pipeline_depth=1, async_dispatch=False),
    "sync": dict(async_dispatch=False),
    "stream": dict(fetch_mode="stream"),
    "bulk": dict(fetch_mode="bulk"),
    "bulk_chunk1": dict(fetch_mode="bulk", bulk_fetch_windows=1),
    "bulk_sync": dict(fetch_mode="bulk", async_dispatch=False),
}
SINK_KEYS = ("start", "anomaly", "skipped_reason", "ranking")


def port_config(**runtime):
    return MicroRankConfig(
        runtime=RuntimeConfig(**runtime), ingest=IngestConfig(enabled=False)
    )


def jax_config(**runtime):
    cfg = JaxConfig()
    return cfg.replace(
        runtime=dataclasses.replace(cfg.runtime, tuned_policy="off", **runtime),
        ingest=JaxIngest(enabled=False),
    )


@pytest.fixture(scope="module")
def timeline(tmp_path_factory):
    tl = generate_timeline(SyntheticConfig(**TIMELINE), N_WINDOWS, FAULTED)
    normal, abnormal = tl.write_csvs(tmp_path_factory.mktemp("timeline"))
    return tl, normal, abnormal


@pytest.fixture(scope="module")
def tables(timeline):
    _, normal, abnormal = timeline
    return (
        (load_span_table_nocache(normal), load_span_table_nocache(abnormal)),
        (jax_load(normal, cache=False), jax_load(abnormal, cache=False)),
    )


def load_span_table_nocache(path):
    return native.load_span_table(path, cache=False)


def port_rca(tables, **runtime):
    rca = TableRCA(port_config(**runtime), device="cpu")
    rca.fit_baseline(tables[0][0])
    return rca


def jax_rca(tables, **runtime):
    rca = JaxTableRCA(jax_config(**runtime))
    rca.fit_baseline(tables[1][0])
    return rca


def sink_records(out_dir):
    import json

    lines = (Path(out_dir) / "windows.jsonl").read_text().splitlines()
    return [{k: json.loads(ln).get(k) for k in SINK_KEYS} for ln in lines]


@pytest.fixture(scope="module")
def variant_runs(tables, tmp_path_factory):
    """Every variant through both packages, with a sink each. Each run
    records into a fresh metrics registry of its package, so that the
    journal's ``run_end.telemetry`` holds that run's metrics only and
    not those an earlier test file left in the process-wide registry
    (the JAX package's dispatch tests add route and overlap keys)."""
    from microrank_tpu.obs import registry as jax_registry
    from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry

    old_t, old_j = get_registry(), jax_registry.get_registry()
    out = {}
    try:
        for name, kw in VARIANTS.items():
            root = tmp_path_factory.mktemp(f"run_{name}")
            set_registry(MetricsRegistry())
            jax_registry.set_registry(jax_registry.MetricsRegistry())
            port = port_rca(tables, **kw).run(tables[0][1], out_dir=root / "torch")
            jax = jax_rca(tables, **kw).run(tables[1][1], out_dir=root / "jax")
            out[name] = (port, jax, root)
    finally:
        set_registry(old_t)
        jax_registry.set_registry(old_j)
    return out


def assert_same_windows(jres, tres, rtol=1e-5):
    assert [(r.start, r.end, r.anomaly, r.skipped_reason) for r in jres] == [
        (r.start, r.end, r.anomaly, r.skipped_reason) for r in tres
    ]
    for j, t in zip(jres, tres):
        assert j.rank_iterations == t.rank_iterations
        assert j.kernel == t.kernel
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=rtol,
        )
        assert ok, f"{t.start}: {why}"


def test_timeline_generator_matches_jax_generator(tmp_path):
    # The same config and seed: the port's CSVs through the port's
    # loader give the same SpanTables as JAX's frames through JAX's.
    cases = (
        (generate_timeline, jax_timeline, (N_WINDOWS, FAULTED)),
        (generate_timeline_with_spans, jax_timeline_with_spans, (1500, 3, [1])),
    )
    for port_gen, jax_gen, args in cases:
        t = port_gen(SyntheticConfig(**TIMELINE), *args)
        j = jax_gen(JaxSynthetic(**TIMELINE), *args)
        assert t.window_faulted == j.window_faulted
        assert (t.fault_pod_op, t.fault_pod_ops) == (j.fault_pod_op, j.fault_pod_ops)
        assert t.window_minutes == j.window_minutes
        assert str(t.start) == str(j.start.to_datetime64().astype("datetime64[us]"))
        assert t.n_timeline_spans == len(j.timeline)
        tnormal, tabnormal = t.write_csvs(tmp_path / "t")
        for frame, tpath in ((j.normal, tnormal), (j.timeline, tabnormal)):
            jpath = tmp_path / f"j_{tpath.name}"
            frame.to_csv(jpath, index=False)
            a, b = jax_load(jpath, cache=False), load_span_table_nocache(tpath)
            for f in a._fields:
                va, vb = getattr(a, f), getattr(b, f)
                if isinstance(va, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=f)
                else:
                    assert va == vb, f


def test_timeline_ranks_the_fault(variant_runs, timeline):
    tl = timeline[0]
    port, _, _ = variant_runs["stream"]
    ranked = [r for r in port if r.ranking]
    assert len(ranked) >= 2 and len(port) >= 3
    assert {r.kernel for r in ranked} == {"kind"}
    assert all(r.ranking[0][0] == tl.fault_pod_op for r in ranked)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_is_bitwise_the_sync_run(variant_runs, variant):
    ref, _, ref_root = variant_runs["sync_depth1"]
    port, _, root = variant_runs[variant]
    assert [(r.start, r.ranking, r.rank_iterations, r.rank_residual) for r in port] == [
        (r.start, r.ranking, r.rank_iterations, r.rank_residual) for r in ref
    ]
    recs = sink_records(root / "torch")
    assert recs == sink_records(ref_root / "torch")
    assert any(rec["ranking"] for rec in recs)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(variant_runs, variant):
    port, jax, root = variant_runs[variant]
    assert_same_windows(jax, port)
    jrecs, trecs = sink_records(root / "jax"), sink_records(root / "torch")
    assert [{k: r[k] for k in SINK_KEYS[:3]} for r in jrecs] == [
        {k: r[k] for k in SINK_KEYS[:3]} for r in trecs
    ]
    assert [bool(r["ranking"]) for r in jrecs] == [bool(r["ranking"]) for r in trecs]
    # Same queue depths at dispatch and the same timing keys.
    assert [r.queue_depth for r in jax] == [r.queue_depth for r in port]
    assert [sorted(r.timings) for r in jax] == [sorted(r.timings) for r in port]
    # A clean, unbounded run clears the cursor in both packages.
    assert not (root / "torch" / "cursor.json").exists()
    assert not (root / "jax" / "cursor.json").exists()


@pytest.mark.parametrize("fetch", [
    dict(fetch_mode="stream"), dict(fetch_mode="bulk", bulk_fetch_windows=2),
])
def test_resume_matches_jax(tables, tmp_path, fetch):
    port, jax = port_rca(tables, **fetch), jax_rca(tables, **fetch)
    first = port.run(tables[0][1], out_dir=tmp_path / "clean")
    assert WindowCursor(tmp_path / "clean" / "cursor.json").load() is None
    assert len(first) >= 3
    # A prior run stopped after its first window: the cursor it saved.
    skip_us = int(port.config.window.skip_minutes * 60e6) if first[0].ranking else 0
    resume_at = str(np.datetime64(first[0].end, "us") + np.timedelta64(skip_us, "us"))
    for name in ("torch", "jax"):
        WindowCursor(tmp_path / name / "cursor.json").save(resume_at)
    tres = port.run(tables[0][1], out_dir=tmp_path / "torch", resume=True)
    jres = jax.run(tables[1][1], out_dir=tmp_path / "jax", resume=True)
    assert [r.start for r in tres] == [r.start for r in first[1:]]
    assert [r.ranking for r in tres] == [r.ranking for r in first[1:]]
    assert_same_windows(jres, tres)
    assert WindowCursor(tmp_path / "torch" / "cursor.json").load() is None
    assert JaxCursor(tmp_path / "jax" / "cursor.json").load() is None


@pytest.mark.parametrize("bound", ["end_us", "complete_only", "both"])
def test_bounded_run_leaves_the_cursor_where_jax_does(tables, tmp_path, bound):
    start = int(tables[0][1].start_us.min())
    kw = {}
    if bound in ("end_us", "both"):
        kw["end_us"] = start + int(12.5 * 60e6)  # ends inside a window
    if bound in ("complete_only", "both"):
        kw["complete_only"] = True
    tres = port_rca(tables).run(tables[0][1], out_dir=tmp_path / "torch", **kw)
    jres = jax_rca(tables).run(tables[1][1], out_dir=tmp_path / "jax", **kw)
    assert tres
    assert_same_windows(jres, tres)
    saved = WindowCursor(tmp_path / "torch" / "cursor.json").load()
    assert saved is not None
    assert saved == JaxCursor(tmp_path / "jax" / "cursor.json").load()


def test_journal_matches_jax(variant_runs):
    _, _, root = variant_runs["stream"]
    tj = read_journal(root / "torch" / JOURNAL_NAME)
    jj = jax_read_journal(root / "jax" / JOURNAL_NAME)
    assert [e["event"] for e in tj] == [e["event"] for e in jj]
    assert tj[0]["event"] == "run_start" and tj[-1]["event"] == "run_end"
    volatile = {"ts", "host", "telemetry"}
    for t, j in zip(tj, jj):
        assert set(t) == set(j), t["event"]
        if t["event"] == "run_end":
            # Every telemetry key but the JAX jit cache's (not ported).
            assert set(j["telemetry"]) - set(t["telemetry"]) == {"jit_retraces"}
        same = set(t) - volatile
        if t["event"] == "window":
            assert sorted(t["timings"]) == sorted(j["timings"])
            same -= {"timings", "rank_residual", "kind_dedup"}
        assert {k: t[k] for k in same} == {k: j[k] for k in same}, t["event"]
    assert sum(e["event"] == "window" for e in tj) == len(variant_runs["stream"][0])


def test_unported_batching_raises(tables):
    # Stacked dispatch is ported (tests/test_torch_batched.py): its knob
    # defaults to one window a program, as JAX's. Every kernel now runs
    # a group as one program (item 7's follow-ups are done): a pcsr group
    # ranks, bitwise the per-window pcsr run; what still raises is an
    # unknown fetch mode.
    assert RuntimeConfig().dispatch_batch_windows == 1
    assert RuntimeConfig(dispatch_batch_windows=2).dispatch_batch_windows == 2
    one = port_rca(tables, kernel="pcsr").run(tables[0][1])
    assert any(r.ranking for r in one)
    for runs in (port_rca(tables, kernel="pcsr", dispatch_batch_windows=2).run(tables[0][1]),
                 port_rca(tables, kernel="pcsr").run(tables[0][1], batch_windows=True)):
        assert [(r.start, r.kernel, r.ranking) for r in runs] == [
            (r.start, r.kernel, r.ranking) for r in one]
    with pytest.raises(ValueError, match="fetch_mode"):
        RuntimeConfig(fetch_mode="lazy")
    defaults = RuntimeConfig()
    assert (defaults.pipeline_depth, defaults.async_dispatch, defaults.fetch_mode,
            defaults.bulk_fetch_windows, defaults.telemetry) == (2, True, "stream", 32, True)


@pytest.mark.parametrize("variant", ["stream", "bulk", "sync"])
def test_worker_exception_reraises_and_pools_stop(tables, variant):
    rca = port_rca(tables, **VARIANTS[variant])
    launches = []
    real = rca.launch_rank

    def failing(*args):
        launches.append(threading.current_thread().name)
        if len(launches) == 2:
            raise RuntimeError("injected stage failure")
        return real(*args)

    rca.launch_rank = failing
    with pytest.raises(RuntimeError, match="injected stage failure"):
        rca.run(tables[0][1])
    worker = variant != "sync"
    assert all(n.startswith("mr-stage") == worker for n in launches)
    alive = [t.name for t in threading.enumerate() if t.name.startswith(("mr-stage", "mr-fetch"))]
    assert not alive


def test_pack_and_unpack_on_cpu_equal_the_outputs():
    import torch

    outs = (
        torch.tensor([3, 0, 7], dtype=torch.int32),
        torch.tensor([2.5, -1.0, float("-inf")]),
        torch.tensor(2, dtype=torch.int32),
        torch.arange(10, dtype=torch.float32).reshape(2, 5),
        torch.tensor(4, dtype=torch.int32),
    )
    packed = pack_rank_outputs(outs)
    assert packed.ready is None and packed.host.device.type == "cpu"
    for got in (unpack_rank_outputs(packed), fetch_rank_outputs(outs)):
        np.testing.assert_array_equal(got[0], outs[0].numpy())
        np.testing.assert_array_equal(got[1], outs[1].numpy())
        assert got[2] == 2 and got[4] == 4
        np.testing.assert_array_equal(got[3], outs[3].numpy())


def test_two_threads_build_and_load_the_native_library_once(tmp_path, monkeypatch, timeline):
    # A cold build directory: the library path points into tmp_path and
    # nothing is loaded. The "compiler" copies the library this process
    # already built, slowly, so both threads are inside the load at once.
    import shutil
    import time

    native._load_library()
    built = native.LIB_PATH
    cold = tmp_path / "_build" / "libmrspan.so"
    builds = []

    def slow_build(cmd, tmp, out, timeout=600):
        builds.append(threading.current_thread().name)
        time.sleep(0.3)
        out.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(built, out)
        return ""

    monkeypatch.setattr(native, "LIB_PATH", cold)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "run_build", slow_build)
    barrier = threading.Barrier(2)
    tables, errors = [], []

    def load():
        try:
            barrier.wait(timeout=10)
            tables.append(native.load_span_table(timeline[1], cache=False))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(tables) == 2
    assert len(builds) == 1 and cold.exists()
    np.testing.assert_array_equal(tables[0].trace_id, tables[1].trace_id)


def read_result_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cli_loop_flags_give_the_default_result(timeline, tmp_path):
    _, normal, abnormal = timeline
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal), "--device", "cpu"]
    runs = {
        "default": [],
        "sync": ["--pipeline-depth", "1", "--sync-dispatch"],
        "bulk": ["--fetch-mode", "bulk", "--bulk-fetch-windows", "2"],
    }
    for name, flags in runs.items():
        assert cli.main(base + ["-o", str(tmp_path / name)] + flags) == 0
    # --resume with a cursor saved after the first window re-emits the
    # rest of the run; the first window's rows are already in the CSV.
    ref = read_result_csv(tmp_path / "default" / "result.csv")
    assert ref
    for name in ("sync", "bulk"):
        assert read_result_csv(tmp_path / name / "result.csv") == ref
    resumed = tmp_path / "resumed"
    first = ref[0]["window_start"]
    rest = [r for r in ref if r["window_start"] != first]
    assert rest
    WindowCursor(resumed / "cursor.json").save(rest[0]["window_start"])
    with open(resumed / "result.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(ref[0]))
        writer.writeheader()
        writer.writerows(r for r in ref if r["window_start"] == first)
    assert cli.main(base + ["-o", str(resumed), "--fetch-mode", "bulk", "--resume"]) == 0
    assert read_result_csv(resumed / "result.csv") == ref


def test_slo_checkpoint_round_trips_through_jax(tables, tmp_path):
    # The port's npz is JAX's format: each package loads the other's.
    from microrank_tpu.pipeline.checkpoint import load_slo as jax_load_slo
    from microrank_tpu.pipeline.checkpoint import save_slo as jax_save_slo
    from microrank_tpu_torch.pipeline.checkpoint import load_slo, save_slo

    rca = port_rca(tables)
    save_slo(tmp_path / "port.npz", rca.slo_vocab, rca.baseline)
    jvocab, jbase = jax_load_slo(tmp_path / "port.npz")
    assert jvocab.names == rca.slo_vocab.names
    np.testing.assert_array_equal(jbase.mean_ms, rca.baseline.mean_ms)
    jax_save_slo(tmp_path / "jax.npz", jvocab, jbase)
    vocab, base = load_slo(tmp_path / "jax.npz")
    assert vocab.names == rca.slo_vocab.names
    np.testing.assert_array_equal(base.std_ms, rca.baseline.std_ms)
    assert base.mean_ms.dtype == np.float32


def test_journal_reads_back_through_jax(tmp_path):
    # The port's journal is JAX's format: JAX's reader parses it to the
    # same events, in the order written, and a missing file reads empty.
    from microrank_tpu_torch.obs import RunJournal

    path = tmp_path / JOURNAL_NAME
    assert read_journal(path) == []
    journal = RunJournal(path)
    for i in range(12):
        journal.emit("tick", i=i)
    journal.run_end(windows=0, ranked=0)
    events = read_journal(path)
    assert [e["i"] for e in events if e["event"] == "tick"] == list(range(12))
    assert events[-1]["event"] == "run_end" and "host" in events[-1]
    assert jax_read_journal(path) == events
