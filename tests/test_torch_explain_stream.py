"""``run_stream`` with rank provenance (``ExplainConfig.enabled``,
``cli stream --explain``) against JAX's ``StreamEngine`` on the same
timeline (8 windows, the fault in window 3, synth 24 ops / 200 traces /
16 kinds, seed 5, lateness 5 s; JAX's frames cast to ``datetime64[ns]``
as tests/test_torch_stream_engine.py casts them):

* one incident opens in both, and each writes one bundle under
  ``explain/<start>/``: its suspects' ops tie-aware equal with scores,
  counters and mass within rtol 1e-5, and each suspect's top traces the
  same trace ids (tie-aware at the cut) within rtol 1e-5;
* the flight dump of the incident holds the bundle, its manifest links
  it; the journal's ``explain`` record names the ranked window's top-1
  and ef; the store ``/explainz`` serves holds it; the webhook's
  ``incident_open`` payload carries the suspects and the bundle's path;
  ``microrank_explain_bundles_total{trigger="incident"}`` is 1;
* explain off writes no ``explain/`` and no journal record, while the
  flight dump is still written, as in JAX;
* ``cli explain`` on the run dir, the bundle dir, the flight dump,
  ``--format json --json``, ``--window`` hit and miss (exit 2), and a
  missing target (exit 2).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from microrank_tpu_torch import cli
from microrank_tpu_torch.config import ExplainConfig, MicroRankConfig, RuntimeConfig, StreamConfig
from microrank_tpu_torch.explain import get_explain_store
from microrank_tpu_torch.explain.bundle import BUNDLE_JSON, ExplainBundle
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, read_journal, set_registry
from microrank_tpu_torch.stream import SyntheticSource, run_stream
from microrank_tpu_torch.testing import SyntheticConfig
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

SYNTH = dict(n_operations=24, n_traces=200, n_kinds=16, seed=5)
N_WINDOWS, FAULTED = 8, (3,)
RTOL = 1e-5


class _CaptureHook(BaseHTTPRequestHandler):
    bodies = None

    def do_POST(self):  # noqa: N802 (stdlib API name)
        n = int(self.headers.get("Content-Length") or 0)
        type(self).bodies.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def hook():
    bodies = []
    _CaptureHook.bodies = bodies
    server = HTTPServer(("127.0.0.1", 0), _CaptureHook)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}/hook", bodies
    server.shutdown()
    server.server_close()


@pytest.fixture
def registries():
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set

    old, jold = get_registry(), jax_get()
    reg, jreg = MetricsRegistry(), JaxRegistry()
    set_registry(reg)
    jax_set(jreg)
    yield reg, jreg
    set_registry(old)
    jax_set(jold)


def ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


def jax_run(out_dir, explain=True, webhook=None):
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import ExplainConfig as JaxExplain
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.stream import StreamEngine
    from microrank_tpu.stream.sources import ReplaySource
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    tl = generate_timeline(JaxSynth(**SYNTH), N_WINDOWS, list(FAULTED))
    hooks = {} if webhook is None else dict(webhook_url=webhook, webhook_timeout_seconds=10.0)
    cfg = JaxConfig().replace(
        stream=JaxStream(allowed_lateness_seconds=5.0, checkpoint=False, **hooks),
        dispatch=JaxDispatch(warmup_manifest=False),
        explain=JaxExplain(enabled=explain),
    )
    engine = StreamEngine(cfg, ReplaySource(ns(tl.timeline), chunk_spans=4000),
                          out_dir=out_dir, normal_df=ns(tl.normal))
    return engine.run()


def port_run(out_dir, explain=True, webhook=None):
    hooks = {} if webhook is None else dict(webhook_url=webhook, webhook_timeout_seconds=10.0)
    cfg = MicroRankConfig().replace(
        stream=StreamConfig(allowed_lateness_seconds=5.0, **hooks),
        runtime=dataclasses.replace(RuntimeConfig(device="cpu")),
        explain=ExplainConfig(enabled=explain),
    )
    src = SyntheticSource(N_WINDOWS, list(FAULTED), SyntheticConfig(**SYNTH), chunk_spans=4000)
    return run_stream(cfg, src, out_dir=out_dir, device="cpu"), src


def only_bundle(out_dir):
    dirs = list((out_dir / "explain").iterdir())
    assert len(dirs) == 1, dirs
    return dirs[0], ExplainBundle.load(dirs[0] / BUNDLE_JSON)


def incident_dumps(out_dir):
    return [d for d in (out_dir / "flight").iterdir() if d.name.endswith("-incident")]


def assert_traces_agree(ours, theirs, where):
    """Two suspects' top traces of one partition: the same ids where the
    contributions are not tied at the cut, each within rtol 1e-5."""
    a = {e["trace"]: e["contribution"] for e in theirs}
    b = {e["trace"]: e["contribution"] for e in ours}
    assert len(a) == len(b), where
    cut = min(a.values(), default=0.0)
    for trace, val in b.items():
        if trace in a:
            assert val == pytest.approx(a[trace], rel=RTOL), (where, trace)
        else:
            assert val == pytest.approx(cut, rel=RTOL), (where, trace)
    for trace, val in a.items():
        if trace not in b:
            assert val == pytest.approx(cut, rel=RTOL), (where, trace)


def test_stream_explain_matches_jax(tmp_path, registries, hook):
    from microrank_tpu.explain import get_explain_store as jax_store

    url, bodies = hook
    reg, jreg = registries
    j = jax_run(tmp_path / "jax")
    t, src = port_run(tmp_path / "port", webhook=url)
    assert t.incidents_opened == j.incidents_opened == 1
    jdir, jb = only_bundle(tmp_path / "jax")
    tdir, tb = only_bundle(tmp_path / "port")
    assert tdir.name == jdir.name
    assert tb.data["trigger"] == "incident" and tb.window == jb.window
    assert (tb.data["method"], tb.data["kernel"], tb.data["iterations"]) == (
        jb.data["method"], jb.data["kernel"], jb.data["iterations"])
    ours, theirs = tb.suspects, jb.suspects
    ok, why = tie_aware_topk_agreement([s["op"] for s in theirs], [s["score"] for s in theirs],
                                       [s["op"] for s in ours], [s["score"] for s in ours],
                                       k=len(theirs), rtol=RTOL)
    assert ok, why
    assert src.fault_pod_op in [s["op"] for s in ours[:5]]
    by_op = {s["op"]: s for s in theirs}
    for s in ours:
        o = by_op[s["op"]]
        for key in ("counters", "mass"):
            for name, val in s[key].items():
                assert val == pytest.approx(o[key][name], rel=RTOL), (s["op"], key, name)
        assert set(s["terms"]) == set(o["terms"]) and len(s["terms"]) == 13
        for p in ("normal", "abnormal"):
            assert_traces_agree(s["top_traces"][p], o["top_traces"][p], (s["op"], p))
    out = tmp_path / "port"
    # The flight dump holds the bundle, linked from its manifest.
    dumps = incident_dumps(out)
    assert len(dumps) == 1 and len(incident_dumps(tmp_path / "jax")) == 1
    assert ExplainBundle.load(dumps[0] / BUNDLE_JSON).data == tb.data
    manifest = json.loads((dumps[0] / "manifest.json").read_text())
    assert manifest["explain_bundle"] == BUNDLE_JSON and manifest["reason"] == "incident"
    for name in ("trace.json", "spans.csv", "events.jsonl", "metrics.json", "metrics.prom"):
        assert (dumps[0] / name).exists(), name
    assert set(manifest) == set(json.loads(
        (incident_dumps(tmp_path / "jax")[0] / "manifest.json").read_text()))
    # The journal's record: the ranked window's top-1 and ef.
    events = read_journal(out / "journal.jsonl")
    exp = [e for e in events if e["event"] == "explain"]
    ranked = [e for e in events if e["event"] == "window" and e.get("outcome") == "ranked"]
    assert len(exp) == 1
    assert exp[0]["top1"] == ranked[0]["top1"] == tb.top1()
    assert exp[0]["ef_top1"] == pytest.approx(tb.suspects[0]["counters"]["ef"])
    assert exp[0]["bundle"] == str(tdir / BUNDLE_JSON)
    jexp = [e for e in read_journal(tmp_path / "jax" / "journal.jsonl") if e["event"] == "explain"]
    assert set(exp[0]) - {"host"} == set(jexp[0]) - {"host"}
    # The store /explainz serves.
    stored = get_explain_store().get(str(ranked[0]["start"]))
    assert stored is not None and stored["suspects"] == tb.data["suspects"]
    assert jax_store().get(str(ranked[0]["start"])) is not None
    # The webhook's open payload: the suspects with scores and the path.
    opens = [b for b in bodies if b["event"] == "incident_open"]
    assert len(opens) == 1
    assert opens[0]["suspects"][0][0] == tb.suspects[0]["op"]
    assert opens[0]["explain_bundle"] == str(tdir / BUNDLE_JSON)
    incidents = [json.loads(x) for x in (out / "incidents.jsonl").read_text().splitlines()]
    assert [e["explain_bundle"] for e in incidents if e["event"] == "incident_open"] == [
        str(tdir / BUNDLE_JSON)]
    assert reg.get("microrank_explain_bundles_total").value(trigger="incident") == 1
    assert reg.get("microrank_flight_dumps_total").value(reason="incident") == 1
    assert jreg.get("microrank_explain_bundles_total").value(trigger="incident") == 1


def test_stream_explain_off_writes_no_bundle(tmp_path, registries):
    j = jax_run(tmp_path / "jax", explain=False)
    t, _ = port_run(tmp_path / "port", explain=False)
    for who, s in (("jax", j), ("port", t)):
        out = tmp_path / who
        assert s.incidents_opened == 1
        assert not (out / "explain").exists()
        assert not [e for e in read_journal(out / "journal.jsonl") if e["event"] == "explain"]
        dumps = incident_dumps(out)
        assert len(dumps) == 1 and not (dumps[0] / BUNDLE_JSON).exists()
        assert "explain_bundle" not in json.loads((dumps[0] / "manifest.json").read_text())


def test_flight_dumps_are_rate_limited(tmp_path, registries):
    """A second incident inside ``flight_min_interval_seconds`` is not
    dumped, and counted as suppressed."""
    from microrank_tpu_torch.config import ObsConfig
    from microrank_tpu_torch.obs.flight import FlightRecorder

    reg, _ = registries
    rec = FlightRecorder(tmp_path, ObsConfig())
    assert rec.dump("incident") is not None
    assert rec.dump("incident") is None
    assert reg.get("microrank_flight_dumps_total").value(reason="suppressed") == 1
    assert FlightRecorder(tmp_path, ObsConfig(flight=False)).dump("incident") is None
    rows = (next((tmp_path / "flight").iterdir()) / "spans.csv").read_text().splitlines()
    assert rows[0].split(",") == ["traceID", "spanID", "ParentSpanId", "operationName",
                                  "serviceName", "podName", "duration", "startTime", "endTime"]


def test_cli_explain_renders_run_artifacts(tmp_path, registries, capsys):
    out = tmp_path / "run"
    assert cli.main(["stream", "--device", "cpu", "--windows", "6", "--fault-windows", "2",
                     "--operations", "24", "--traces", "200", "--kinds", "16", "--seed", "5",
                     "--lateness-seconds", "5", "--explain", "--explain-top-traces", "4",
                     "-o", str(out)]) == 0
    capsys.readouterr()
    bundle_dir, bundle = only_bundle(out)
    top1 = bundle.top1()
    assert all(len(s["top_traces"]["abnormal"]) <= 4 for s in bundle.suspects)
    assert cli.main(["explain", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "Rank provenance" in printed and top1 in printed
    sidecar = tmp_path / "picked.json"
    assert cli.main(["explain", str(bundle_dir), "--format", "json", "--json",
                     str(sidecar)]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["suspects"][0]["op"] == top1
    assert json.loads(sidecar.read_text()) == data
    assert cli.main(["explain", str(incident_dumps(out)[0])]) == 0
    assert top1 in capsys.readouterr().out
    assert cli.main(["explain", str(out / "journal.jsonl")]) == 0
    assert top1 in capsys.readouterr().out
    start = data["window"]["start"]
    assert cli.main(["explain", str(out), "--window", start]) == 0
    capsys.readouterr()
    assert cli.main(["explain", str(out), "--window", "nope"]) == 2
    assert cli.main(["explain", str(tmp_path / "missing")]) == 2
    # Explain off: nothing to render.
    off = tmp_path / "off"
    assert cli.main(["stream", "--device", "cpu", "--windows", "6", "--fault-windows", "2",
                     "--operations", "24", "--traces", "200", "--kinds", "16", "--seed", "5",
                     "-o", str(off)]) == 0
    assert cli.main(["explain", str(off)]) == 2


def test_cli_explain_matches_jax_cli_on_a_bundle(tmp_path, registries, capsys):
    """JAX's ``cli explain`` and the port's print the same table of the
    port's bundle."""
    from microrank_tpu.cli.main import main as jax_main

    t, _ = port_run(tmp_path / "port")
    bundle_dir, _ = only_bundle(tmp_path / "port")
    capsys.readouterr()
    assert cli.main(["explain", str(bundle_dir)]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["explain", str(bundle_dir)]) == 0
    assert capsys.readouterr().out == ours
    np.testing.assert_equal(t.incidents_opened, 1)
