"""The port's metrics registry, its lanes' metrics, ``cli stats`` and the
metrics endpoint, held to the JAX package's on the CPU.

* the registry: the cases of tests/test_obs.py (exact concurrent
  counts, gauges, cumulative histogram buckets, Prometheus text and
  escaping, the JSON round trip, idempotent registration, diff and
  merge laws), and the same exposition text as the JAX registry for the
  same samples;
* a table run on the same CSV pair in both packages, each into a fresh
  registry: every series the port records holds the JAX run's samples
  (counters and gauges equal; histograms equal in count per label set
  and in buckets, except the wall-clock ``microrank_stage_seconds``
  buckets). The staging counters are compared on the packed run, where
  both ship the same fields, with both packages' ``blob_staging=False``
  ("tree": one transfer per leaf); the port's kind window ships the
  coverage bitmap where JAX ships its int8 unpacking, and the port's
  graph has one leaf fewer per partition (no ``cov_i8``). The host
  gauges read the load average at different instants and are compared
  by presence;
* the default staging, blob in both packages: path "blob", one transfer
  a ranked window in both, and (packed) the same staged and pad bytes,
  audited on the host graph and not on the port's aligned blob;
* ``metrics.json`` samples every series JAX's samples but
  ``microrank_jit_retraces_total`` (the spans recorded counted alike);
* ``run_end.telemetry``: JAX's keys and values except ``jit_retraces``
  (the JAX jit cache, which the port has none of);
* ``cli stats`` (prom, json, ``--diff``, ``--merge``, ``--journal``):
  the port's and JAX's output are equal on the same ``metrics.json``,
  the port's and the JAX package's snapshots alike;
* the HTTP endpoint: ``/metrics``, ``/metrics.json``, ``/healthz``, and
  501 on ``/profilez``, ``/explainz`` serving the explain store.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import registry as jax_registry
from microrank_tpu.obs.journal import read_journal as jax_read_journal
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.obs import (
    MetricsRegistry,
    diff_registries,
    get_registry,
    merge_registries,
    read_journal,
    registry_from_json,
    set_registry,
)
from microrank_tpu_torch.obs import registry as port_registry
from microrank_tpu_torch.obs.metrics import ensure_catalog, snapshot_to_result_fields
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.testing import SyntheticConfig, generate_case

# The series the port records, by name (obs/metrics.py's catalog).
WALL_CLOCK = {"microrank_stage_seconds"}
HOST = {"microrank_host_norm_load", "microrank_host_steal_ratio"}
STAGING = {
    "microrank_staged_bytes_total",
    "microrank_staged_pad_bytes_total",
    "microrank_staging_transfers_total",
}


@pytest.fixture
def registries(monkeypatch):
    """A fresh process registry in each package; the old ones restored.
    JAX's retrace counter compares each jitted program's cache size with
    the last one it observed in the process, so its observations start
    afresh too: a program an earlier test in the same worker compiled
    then counts as this run's trace, whatever order the tests ran in."""
    from microrank_tpu.obs import metrics as jax_metrics

    monkeypatch.setattr(jax_metrics, "_jit_cache_sizes", {})
    old_t, old_j = get_registry(), jax_registry.get_registry()
    t, j = MetricsRegistry(), jax_registry.MetricsRegistry()
    set_registry(t)
    jax_registry.set_registry(j)
    yield t, j
    set_registry(old_t)
    jax_registry.set_registry(old_j)


# ---------------------------------------------------------------- registry


def test_counter_concurrent_increments_are_exact(registries):
    c = registries[0].counter("t_total", "test", labelnames=("k",))
    n_threads, per_thread = 8, 2000

    def work():
        for _ in range(per_thread):
            c.inc(k="a")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value(k="a") == n_threads * per_thread


def test_gauge_set_inc_dec(registries):
    g = registries[0].gauge("t_gauge", "test")
    g.set(5)
    g.inc(2)
    g.dec()
    assert g.value() == 6


def test_histogram_buckets_cumulative_and_sum(registries):
    h = registries[0].histogram("t_hist", "test", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 0.7, 3.0, 7.0, 100.0):
        h.observe(v)
    s = h.snapshot()
    assert s["counts"] == [2, 1, 1, 1]  # (..1], (1..5], (5..10], (10..inf)
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(111.2)


def fill(reg):
    """The same samples in either package's registry."""
    reg.counter("t_reqs_total", "requests", labelnames=("path",)).inc(3, path='a"b\\c')
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(2.0)
    reg.gauge("t_g", "g", labelnames=("host",)).set(3.5, host="h0")


def test_prometheus_exposition_format(registries):
    reg, jreg = registries
    fill(reg)
    text = reg.to_prometheus()
    lines = text.splitlines()
    assert "# TYPE t_reqs_total counter" in lines
    assert "# TYPE t_lat_seconds histogram" in lines
    # Label escaping: quote and backslash escaped in the value.
    assert 't_reqs_total{path="a\\"b\\\\c"} 3' in lines
    bucket_lines = [ln for ln in lines if ln.startswith("t_lat_seconds_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in bucket_lines]
    assert counts == sorted(counts)
    assert bucket_lines[-1].startswith('t_lat_seconds_bucket{le="+Inf"}')
    assert counts[-1] == 2
    assert "t_lat_seconds_count 2" in lines
    for ln in lines:
        if ln.startswith("#") or not ln:
            continue
        assert re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$", ln), ln
    # The JAX registry writes the same text for the same samples.
    fill(jreg)
    assert jreg.to_prometheus() == text


def test_registry_json_roundtrip_across_packages(registries):
    reg, jreg = registries
    fill(reg)
    snap = json.loads(json.dumps(reg.to_json()))
    assert registry_from_json(snap).to_prometheus() == reg.to_prometheus()
    # Either package rebuilds the other's snapshot to the same text.
    assert jax_registry.registry_from_json(snap).to_prometheus() == reg.to_prometheus()
    fill(jreg)
    jsnap = json.loads(json.dumps(jreg.to_json()))
    assert registry_from_json(jsnap).to_prometheus() == jreg.to_prometheus()
    assert {k: v for k, v in snap.items() if k != "ts"} == {
        k: v for k, v in jsnap.items() if k != "ts"
    }


def test_registry_idempotent_and_conflicting_registration(registries):
    reg = registries[0]
    a = reg.counter("t_same", "x", labelnames=("l",))
    b = reg.counter("t_same", "x", labelnames=("l",))
    assert a is b
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_same", "x")


def test_diff_and_merge_laws_match_jax():
    def pair(mod):
        before, after = mod.MetricsRegistry(), mod.MetricsRegistry()
        before.counter("c_total", "x", ("k",)).inc(3, k="a")
        after.counter("c_total", "x", ("k",)).inc(5, k="a")
        after.counter("c_total", "x", ("k",)).inc(2, k="b")
        before.gauge("g", "x").set(7)
        after.gauge("g", "x").set(4)
        before.histogram("h", "x", buckets=(1, 10)).observe(0.5)
        ha = after.histogram("h", "x", buckets=(1, 10))
        ha.observe(0.5)
        ha.observe(5.0)
        before.counter("reset_total", "x").inc(9)
        after.counter("reset_total", "x").inc(2)
        return before, after

    before, after = pair(port_registry)
    delta = diff_registries(before, after)
    assert delta.get("c_total").value(k="a") == 2
    assert delta.get("c_total").value(k="b") == 2
    assert delta.get("g").value() == 4  # gauges keep the after reading
    snap = delta.get("h").snapshot()
    assert snap["count"] == 1 and snap["counts"] == [0, 1, 0]
    assert delta.get("reset_total").value() == 0
    merged = merge_registries([("h0", before), ("h1", after)])
    assert merged.get("c_total").value(k="a") == 8
    assert merged.get("g").value(host="h0") == 7 and merged.get("g").value(host="h1") == 4
    jb, ja = pair(jax_registry)
    assert delta.to_prometheus() == jax_registry.diff_registries(jb, ja).to_prometheus()
    assert merged.to_prometheus() == jax_registry.merge_registries(
        [("h0", jb), ("h1", ja)]
    ).to_prometheus()


# ------------------------------------------------------------- lane parity


@pytest.fixture(scope="module")
def csv_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_case")
    case = generate_case(SyntheticConfig(
        n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5
    ))
    normal, abnormal = case.write_csvs(d)
    return case, normal, abnormal


def run_both(csv_pair, tmp_path, registries, collapse, blob=False):
    """One table run per package into its fresh registry, both staging
    by blob or both leaf by leaf; returns both registries' snapshots and
    journals."""
    reg, jreg = registries
    _, normal, abnormal = csv_pair
    jcfg = JaxConfig(
        runtime=JaxRuntime(collapse_kinds=collapse, blob_staging=blob),
        ingest=JaxIngest(),
    )
    j = JaxTableRCA(jcfg)
    j.fit_baseline(jax_load(normal, cache=False))
    jres = j.run(jax_load(abnormal, cache=False), out_dir=tmp_path / "jax")
    t = TableRCA(
        MicroRankConfig(runtime=RuntimeConfig(collapse_kinds=collapse, blob_staging=blob)),
        device="cpu",
    )
    t.fit_baseline(load_span_table(normal, cache=False))
    tres = t.run(load_span_table(abnormal, cache=False), out_dir=tmp_path / "port")
    assert [r.kernel for r in tres] == [r.kernel for r in jres]
    assert (t.policy_resolution.outcome, j.policy_resolution.outcome) == ("default", "default")
    return (
        reg.to_json()["metrics"], jreg.to_json()["metrics"],
        read_journal(tmp_path / "port" / "journal.jsonl"),
        jax_read_journal(tmp_path / "jax" / "journal.jsonl"),
        tres,
    )


def by_labels(samples):
    return {tuple(sorted(s["labels"].items())): s for s in samples}


@pytest.mark.parametrize("collapse,kernel", [("auto", "kind"), ("off", "packed_bf16")])
def test_table_run_records_jax_series(csv_pair, tmp_path, registries, collapse, kernel):
    ours, theirs, journal, jjournal, tres = run_both(csv_pair, tmp_path, registries, collapse)
    assert {r.kernel for r in tres if r.ranking} == {kernel}
    sampled = {name for name, m in ours.items() if m["samples"]}
    # What the run records: the lane's series, and nothing JAX does not.
    assert sampled >= {
        "microrank_stage_seconds", "microrank_windows_total",
        "microrank_rank_iterations", "microrank_rank_final_residual",
        "microrank_pipeline_inflight", "microrank_kind_dedup_ratio",
        "microrank_policy_events_total", "microrank_ingest_admitted_total",
        *STAGING, *HOST,
    }
    # Every series JAX's run samples but its jit cache's, the spans
    # recorded and the dead-letter store's counter included.
    assert {name for name, m in theirs.items() if m["samples"]} - sampled == {
        "microrank_jit_retraces_total"}
    assert "microrank_spans_recorded_total" in sampled
    for name in sampled - HOST - (STAGING if kernel == "kind" else set()):
        a, b = ours[name], theirs[name]
        assert (a["type"], a["help"], a["labelnames"]) == (b["type"], b["help"], b["labelnames"])
        sa, sb = by_labels(a["samples"]), by_labels(b["samples"])
        if name == "microrank_staging_transfers_total":
            # One leaf fewer per partition: the port has no cov_i8.
            n_ranked = sum(1 for r in tres if r.ranking)
            assert list(sa) == list(sb)
            for k in sa:
                assert sa[k]["value"] == sb[k]["value"] - 2 * n_ranked
            continue
        assert set(sa) == set(sb), name
        if a["type"] == "histogram":
            assert a["bucket_bounds"] == b["bucket_bounds"]
            for k in sa:
                assert sa[k]["count"] == sb[k]["count"], (name, k)
                if name not in WALL_CLOCK:
                    assert sa[k]["buckets"] == sb[k]["buckets"], (name, k)
        else:
            for k in sa:
                assert sa[k]["value"] == pytest.approx(sb[k]["value"], rel=1e-12), (name, k)
    # run_end.telemetry: JAX's keys and values but the jit cache's.
    tel, jtel = journal[-1]["telemetry"], jjournal[-1]["telemetry"]
    assert journal[-1]["event"] == jjournal[-1]["event"] == "run_end"
    assert set(jtel) - set(tel) == {"jit_retraces"} and set(tel) <= set(jtel)
    if kernel != "kind":
        assert tel == {k: v for k, v in jtel.items() if k != "jit_retraces"}
    assert tel == snapshot_to_result_fields()


@pytest.mark.parametrize("collapse,kernel", [("auto", "kind"), ("off", "packed_bf16")])
def test_default_blob_staging_records_jax_series(csv_pair, tmp_path, registries, collapse,
                                                 kernel):
    assert RuntimeConfig().blob_staging and JaxRuntime().blob_staging
    ours, theirs, _, _, tres = run_both(csv_pair, tmp_path, registries, collapse, blob=True)
    assert {r.kernel for r in tres if r.ranking} == {kernel}
    n_ranked = sum(1 for r in tres if r.ranking)
    compared = STAGING if kernel != "kind" else {"microrank_staging_transfers_total"}
    for name in STAGING:
        assert {s["labels"]["path"] for s in ours[name]["samples"]} == {"blob"}, name
    transfers = by_labels(ours["microrank_staging_transfers_total"]["samples"])
    assert [s["value"] for s in transfers.values()] == [n_ranked]
    for name in compared:
        sa = by_labels(ours[name]["samples"])
        assert sa and sa == by_labels(theirs[name]["samples"]), name


def test_catalog_is_jax_metrics_subset(registries):
    from microrank_tpu.obs.metrics import ensure_catalog as jax_catalog
    from microrank_tpu.obs.metrics import kind_dedup_gauge

    reg, jreg = registries
    ensure_catalog()
    jax_catalog()
    kind_dedup_gauge()  # recorded by JAX's lane, not in its catalog
    ours, theirs = reg.to_json()["metrics"], jreg.to_json()["metrics"]
    assert set(ours) < set(theirs)
    for name, m in ours.items():
        t = theirs[name]
        assert (m["type"], m["help"], m["labelnames"]) == (t["type"], t["help"], t["labelnames"])
        assert m.get("bucket_bounds") == t.get("bucket_bounds")


# --------------------------------------------------------------- cli stats


def stats_out(main, argv, capsys):
    rc = main(["stats", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def two_snapshots(tmp_path, csv_pair, registries):
    """metrics.json of a port CLI run, of a JAX run, and of a second
    port run (after)."""
    from microrank_tpu.cli.main import main as jax_main

    _, normal, abnormal = csv_pair
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    assert cli.main(base + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main(base + ["-o", str(tmp_path / "jax"), "--engine", "native"]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "port2"), "--device", "cpu"]) == 0
    return tmp_path / "port", tmp_path / "jax", tmp_path / "port2"


def test_cli_stats_matches_jax_stats(two_snapshots, capsys):
    from microrank_tpu.cli.main import main as jax_main

    port, jax_dir, port2 = two_snapshots
    for target in (port, jax_dir):
        for argv in ([str(target), "--journal"], [str(target), "--format", "json"]):
            rc, out, err = stats_out(cli.main, argv, capsys)
            jrc, jout, jerr = stats_out(jax_main, argv, capsys)
            assert rc == jrc == 0
            assert out == jout and err == jerr
    text = stats_out(cli.main, [str(port)], capsys)[1]
    assert "# TYPE microrank_rank_iterations histogram" in text
    assert re.search(r'microrank_rank_iterations_count\{kernel="\w+"\} \d+', text)
    assert "microrank_staged_bytes_total" in text
    for argv in (["--diff", str(port), str(port2)],
                 ["--diff", str(port), str(port2), "--format", "json"],
                 ["--merge", str(port), str(jax_dir)],
                 ["--merge", "--diff", str(port), str(port2), "--format", "json"]):
        rc, out, _ = stats_out(cli.main, argv, capsys)
        jrc, jout, _ = stats_out(jax_main, argv, capsys)
        assert rc == jrc == 0
        if "--format" in argv:  # snapshot times differ: compare all but ts
            a, b = json.loads(out), json.loads(jout)
            assert a["metrics"] == b["metrics"]
        else:
            assert out == jout
    # Two port runs of the same case: windows and iterations diff to the
    # second run's own counts.
    rc, out, _ = stats_out(cli.main, ["--diff", str(port), str(port2)], capsys)
    assert 'microrank_windows_total{outcome="ranked"} 1' in out
    # Wrong arity is a usage error in both.
    assert stats_out(cli.main, ["--diff", str(port)], capsys)[0] == 2
    assert stats_out(cli.main, [str(port / "missing")], capsys)[0] == 2


def test_cli_run_result_csv_matches_jax_cli(two_snapshots):
    # The port's `cli run` and JAX's `cli run --engine native` on the same
    # CSV pair: result.csv's windows and rows, the rankings tie-aware
    # equal with confidences within rtol 1e-5, the same top-1.
    import csv

    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    port, jax_dir, _ = two_snapshots
    windows = []
    for d in (port, jax_dir):
        with open(d / "result.csv") as f:
            rows = list(csv.DictReader(f))
        by_window = {}
        for r in rows:
            by_window.setdefault((r["level"], r["window_start"]), []).append(r)
        windows.append(by_window)
    assert windows[0] and list(windows[0]) == list(windows[1])
    for key, ours in windows[0].items():
        theirs = windows[1][key]
        assert [r["rank"] for r in ours] == [r["rank"] for r in theirs]
        assert ours[0]["result"] == theirs[0]["result"]
        ok, why = tie_aware_topk_agreement(
            [r["result"] for r in theirs], [float(r["confidence"]) for r in theirs],
            [r["result"] for r in ours], [float(r["confidence"]) for r in ours],
            k=len(ours), rtol=1e-5,
        )
        assert ok, why


def test_cli_run_writes_snapshot_only_with_telemetry(tmp_path, csv_pair, registries):
    _, normal, abnormal = csv_pair
    out = tmp_path / "out"
    assert cli.main(["run", "--normal", str(normal), "--abnormal", str(abnormal),
                     "-o", str(out), "--device", "cpu"]) == 0
    snap = json.loads((out / "metrics.json").read_text())
    assert (out / "metrics.prom").read_text() == registry_from_json(snap).to_prometheus()
    windows = snap["metrics"]["microrank_windows_total"]["samples"]
    ranked = [json.loads(ln) for ln in (out / "windows.jsonl").read_text().splitlines()]
    assert sum(s["value"] for s in windows if s["labels"]["outcome"] == "ranked") == sum(
        1 for r in ranked if r["ranking"]
    )


# -------------------------------------------------------------- endpoint


def test_metrics_http_server(registries):
    from microrank_tpu_torch.obs.server import start_metrics_server

    reg = registries[0]
    reg.counter("t_live_total", "x").inc(4)
    server = start_metrics_server(0, reg)
    try:
        base = f"http://127.0.0.1:{server.port}"
        body = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert "t_live_total 4" in body
        jbody = json.loads(urllib.request.urlopen(f"{base}/metrics.json", timeout=10).read())
        assert jbody["metrics"]["t_live_total"]["samples"][0]["value"] == 4
        assert urllib.request.urlopen(f"{base}/healthz", timeout=10).read() == b"ok\n"
        for route, item in (("/profilez", "item 11"),):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}{route}", timeout=10)
            assert err.value.code == 501
            detail = json.loads(err.value.read())
            assert detail["route"] == route and item in detail["reason"]
        # /explainz serves the explain store (tests/test_torch_explain.py).
        listing = json.loads(urllib.request.urlopen(f"{base}/explainz", timeout=10).read())
        assert set(listing) == {"windows", "latest"}
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert err.value.code == 404
    finally:
        server.close()


def test_cli_metrics_port_serves_the_catalog(tmp_path, csv_pair, registries, monkeypatch):
    # --metrics-port starts the endpoint with the catalog registered and
    # stops it when the run returns.
    from microrank_tpu_torch.obs import server as server_mod

    started = []
    real = server_mod.start_metrics_server

    def spy(port, registry=None):
        s = real(port, registry)
        started.append(s)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/metrics", timeout=10
        ).read().decode()
        assert "# TYPE microrank_windows_total counter" in body
        return s

    monkeypatch.setattr(server_mod, "start_metrics_server", spy)
    _, normal, abnormal = csv_pair
    assert cli.main(["run", "--normal", str(normal), "--abnormal", str(abnormal),
                     "-o", str(tmp_path / "out"), "--device", "cpu",
                     "--metrics-port", "0"]) == 0
    assert len(started) == 1 and not started[0]._thread.is_alive()


def test_sentinel_mirrors_into_host_gauges(registries):
    from microrank_tpu_torch.obs.host import ContentionSentinel

    reg = registries[0]
    sample = ContentionSentinel().sample()
    assert reg.get("microrank_host_norm_load").value() == pytest.approx(
        sample["norm_load"], abs=1e-4
    )
    assert reg.get("microrank_host_steal_ratio") is not None
