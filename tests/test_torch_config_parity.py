"""The port's config surface held to the JAX package's (the faults F1-F4
of ROADMAP.md, repaired):

* F1, the shared config flags: the same argv parsed by both CLIs'
  ``_add_config_flags`` gives equal configs on every field the port has
  (``--coalesce-windows``, ``--compile-cache-dir``, ``--chaos-seed``,
  ``--inject-stage``, ``--inject-stage-sleep-ms``,
  ``--max-spans-per-trace``, ``--no-ingest-guard``,
  ``--min-admission-ratio``, the pandas lane's three at JAX's defaults);
  the flags whose lanes are not ported refuse, each naming its item;
* F2, config dicts: ``from_dict(to_dict())`` round-trips (tuples kept),
  a JAX ``to_dict`` loads (a JAX config with non-default port fields
  gives the same fields), a JAX field the port lacks refuses at any
  value but JAX's default, naming its item, and ``--config-json``
  gives JAX's config;
* F3, the stream's admission ratio: a window below a configured ratio is
  refused whole as JAX's engine refuses it (the same windows
  ``low_admission`` at a ratio between the windows' admitted shares,
  none at a low one), on a timeline whose long traces the span budget
  cuts;
* F4, the journal's rotation: the same events through both
  ``RunJournal(max_bytes=)`` give the same parts (names and events) and
  the same ``read_journal``; ``cli stats --journal`` reports the parts
  as JAX's; ``cli stream --journal-max-bytes`` reaches the config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import pytest

from microrank_tpu_torch import cli
from microrank_tpu_torch.config import (
    ChaosConfig,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
    SchedConfig,
    ServeConfig,
    SpectrumConfig,
    StreamConfig,
)


def jax_config(argv):
    from microrank_tpu.cli.main import _add_config_flags, _config_from_args

    p = argparse.ArgumentParser()
    _add_config_flags(p)
    return _config_from_args(p.parse_args(argv))


def port_config(argv, cmd="run"):
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction)).choices[cmd]
    base = ["--normal", "n.csv", "--abnormal", "a.csv"] if cmd == "run" else []
    return cli._config_from_args(sub.parse_args(base + argv))


def port_fields(cfg, like=None):
    """Every field the port's config has and ``like``'s (the JAX config's)
    has too, from ``cfg`` (the backend named as the port names it)."""
    like = like or cfg
    out = {}
    for section in dataclasses.fields(MicroRankConfig):
        ours = getattr(MicroRankConfig(), section.name)
        theirs = getattr(like, section.name, None)
        for f in dataclasses.fields(ours):
            if theirs is None or not hasattr(theirs, f.name):
                continue
            value = getattr(getattr(cfg, section.name), f.name)
            if (section.name, f.name) == ("runtime", "backend") and value == "jax":
                value = "torch"
            out[(section.name, f.name)] = value
    return out


@pytest.mark.parametrize("argv", [
    [],
    ["--coalesce-windows", "3"],
    ["--compile-cache-dir", "cache/jit"],
    ["--chaos-seed", "7"],
    ["--inject-stage", "detect", "--inject-stage-sleep-ms", "2.5"],
    ["--max-spans-per-trace", "100"],
    ["--no-ingest-guard"],
    ["--min-admission-ratio", "0.8"],
    ["--orphan-policy", "stitch", "--max-skew-seconds", "300", "--max-ops-per-window", "20000"],
    ["--spectrum-method", "ochiai", "--top-max", "7", "--quarantine-dir", "q",
     "--span-ring", "64", "--explain", "--no-span-trace"],
])
def test_shared_flags_give_jaxs_config(argv):
    theirs = jax_config(argv)
    ours = port_config(argv)
    assert port_fields(ours, theirs) == port_fields(theirs)
    assert len(port_fields(ours, theirs)) > 100


@pytest.mark.parametrize("argv,item", [
    (["--orphan-policy", "drop"], "item 9"),
    (["--max-skew-seconds", "10"], "item 9"),
    (["--max-ops-per-window", "5"], "item 9"),
    (["--profile-every-n", "3"], "item 11"),
    (["--sharded-threshold-mb", "64"], "item 12"),
    (["--sanitizers"], "analysis/"),
])
def test_flags_whose_lanes_are_not_ported_refuse_naming_their_item(argv, item):
    jax_config(argv)  # JAX's CLI takes them
    for cmd in ("run", "stream"):
        with pytest.raises(NotImplementedError, match=item):
            port_config(argv, cmd)


def nondefault_port_config():
    return MicroRankConfig(
        spectrum=SpectrumConfig(method="ochiai", top_max=9),
        pagerank=PageRankConfig(tol=1e-4, iterations=40),
        runtime=RuntimeConfig(kernel="csr", device="cpu", compile_cache_dir="c"),
        serve=ServeConfig(warmup_occupancies=(1, 2, 4)),
        sched=SchedConfig(tenant_weights=(("a", 2.0), ("b", 0.5)), tenant_rates=(("a", 1.0),)),
        chaos=ChaosConfig(enabled=True, seed=3,
                          faults=({"seam": "dispatch", "kind": "error", "count": 2},)),
        stream=StreamConfig(slide_minutes=2.5),
    )


def test_config_dict_round_trips():
    for cfg in (MicroRankConfig(), nondefault_port_config()):
        assert MicroRankConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
        assert MicroRankConfig.from_dict(cfg.to_dict()) == cfg


def jax_nondefault():
    import microrank_tpu.config as J

    return J.MicroRankConfig(
        spectrum=J.SpectrumConfig(method="ochiai", top_max=9),
        pagerank=J.PageRankConfig(tol=1e-4, iterations=40),
        runtime=J.RuntimeConfig(kernel="csr", compile_cache_dir="c"),
        serve=J.ServeConfig(warmup_occupancies=(1, 2, 4)),
        sched=J.SchedConfig(tenant_weights=(("a", 2.0), ("b", 0.5)),
                            tenant_rates=(("a", 1.0),)),
        chaos=J.ChaosConfig(enabled=True, seed=3,
                            faults=({"seam": "dispatch", "kind": "error", "count": 2},)),
        ingest=J.IngestConfig(min_admission_ratio=0.7, max_spans_per_trace=99),
        obs=J.ObsConfig(journal_max_bytes=4096, inject_stage="detect"),
        dispatch=J.DispatchConfig(coalesce_windows=3, donate_staging=False),
    )


def test_a_jax_config_dict_loads():
    import microrank_tpu.config as J

    assert MicroRankConfig.from_dict(
        json.loads(json.dumps(J.MicroRankConfig().to_dict()))) == MicroRankConfig()
    theirs = jax_nondefault()
    ours = MicroRankConfig.from_dict(json.loads(json.dumps(theirs.to_dict())))
    assert port_fields(ours, theirs) == port_fields(theirs)
    assert ours.ingest.min_admission_ratio == 0.7 and ours.obs.journal_max_bytes == 4096
    assert ours.runtime.backend == "torch"


@pytest.mark.parametrize("section,field,value,item", [
    ("fleet", "partitions", 2, "item 11"),
    ("watchdog", "stage_budgets", [["build", 100.0]], "item 11"),
    ("runtime", "mesh_shape", [2], "item 12"),
    ("dispatch", "sharded_bytes_threshold", 1 << 20, "item 12"),
    ("pagerank", "sparse_allreduce", True, "item 12"),
    ("runtime", "delta_build", True, "item 11"),
    ("ingest", "orphan_policy", "drop", "item 9"),
    ("ingest", "max_ops_per_window", 10, "item 9"),
    ("obs", "profile_every_n", 5, "item 11"),
    ("runtime", "sanitizers", True, "analysis/"),
])
def test_a_jax_field_the_port_lacks_refuses_naming_its_item(section, field, value, item):
    import microrank_tpu.config as J

    d = json.loads(json.dumps(J.MicroRankConfig().to_dict()))
    d[section][field] = value
    with pytest.raises(NotImplementedError, match=item):
        MicroRankConfig.from_dict(d)


def test_cli_config_json_gives_jaxs_config(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(jax_nondefault().to_dict()))
    argv = ["--config-json", str(path)]
    theirs, ours = jax_config(argv), port_config(argv)
    assert port_fields(ours, theirs) == port_fields(theirs)
    assert ours == MicroRankConfig.from_dict(json.loads(path.read_text()))
    assert port_config(argv, "stream").spectrum.method == "ochiai"


# ------------------------------------------------------------------ F3


SYNTH = dict(n_operations=24, n_traces=200, n_kinds=16, seed=5)
SPAN_BUDGET = 12  # spans a trace: the longer traces' tails are cut


def ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


def jax_stream(out_dir, ratio):
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import IngestConfig as JaxIngest
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.stream import StreamEngine
    from microrank_tpu.stream.sources import ReplaySource
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    tl = generate_timeline(JaxSynth(**SYNTH), 6, [3])
    cfg = JaxConfig().replace(
        stream=JaxStream(allowed_lateness_seconds=0.0, checkpoint=False),
        ingest=JaxIngest(max_spans_per_trace=SPAN_BUDGET, min_admission_ratio=ratio),
        dispatch=JaxDispatch(warmup_manifest=False),
    )
    engine = StreamEngine(cfg, ReplaySource(ns(tl.timeline), chunk_spans=4000),
                          out_dir=out_dir, normal_df=ns(tl.normal))
    return engine.run()


def port_stream(out_dir, ratio):
    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.stream import SyntheticSource, run_stream
    from microrank_tpu_torch.testing import SyntheticConfig

    cfg = MicroRankConfig().replace(
        stream=StreamConfig(allowed_lateness_seconds=0.0),
        ingest=IngestConfig(max_spans_per_trace=SPAN_BUDGET, min_admission_ratio=ratio),
        runtime=RuntimeConfig(device="cpu"),
    )
    src = SyntheticSource(6, [3], SyntheticConfig(**SYNTH), chunk_spans=4000)
    return run_stream(cfg, src, out_dir=out_dir, device="cpu")


def windows_of(summary):
    return [(r.start, r.skipped_reason, r.anomaly, bool(r.ranking), r.ingest_rejected)
            for r in summary.results]


def test_a_window_below_the_configured_ratio_is_refused_as_jax_refuses_it(tmp_path):
    low = windows_of(port_stream(tmp_path / "port_low", 0.05))
    assert low == windows_of(jax_stream(tmp_path / "jax_low", 0.05))
    assert all(w[4] for w in low), "the span budget cut no window: the test needs rejected rows"
    # A ratio past some windows' admitted share and below others' (the
    # budget admits 0.717 to 0.742 of each window's spans here).
    ratio = 0.73
    ours = windows_of(port_stream(tmp_path / "port", ratio))
    theirs = windows_of(jax_stream(tmp_path / "jax", ratio))
    assert ours == theirs
    refused = [w for w in ours if w[1] == "low_admission"]
    assert refused and len(refused) < len(ours)
    assert not [w for w in low if w[1] == "low_admission"]


# ------------------------------------------------------------------ F4


def journal_events(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_a_rotated_journal_reads_back_in_order_as_jaxs(tmp_path, monkeypatch):
    # One clock for both writers, so that their lines are the same bytes.
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.25)
    from microrank_tpu.obs.journal import RunJournal as JaxJournal
    from microrank_tpu.obs.journal import journal_parts as jax_parts
    from microrank_tpu.obs.journal import read_journal as jax_read

    from microrank_tpu_torch.obs import RunJournal, journal_parts, read_journal

    paths = {}
    for name, cls in (("port", RunJournal), ("jax", JaxJournal)):
        paths[name] = tmp_path / name / "journal.jsonl"
        j = cls(paths[name], sentinel=object(), max_bytes=400)
        for i in range(40):
            j.emit("window", start=f"w{i}", outcome="ranked" if i % 3 else "clean", i=i)
    ours, theirs = journal_parts(paths["port"]), jax_parts(paths["jax"])
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) > 3
    for a, b in zip([*ours, paths["port"]], [*theirs, paths["jax"]]):
        ea = [json.loads(x) for x in a.read_text().splitlines()]
        eb = [json.loads(x) for x in b.read_text().splitlines()]
        assert journal_events(ea) == journal_events(eb)
        assert a.stat().st_size <= 400
    events = read_journal(paths["port"])
    assert journal_events(events) == journal_events(jax_read(paths["jax"]))
    assert [e["i"] for e in events if e["event"] == "window"] == list(range(40))
    # A journal reopened on the same path continues the parts' numbering.
    RunJournal(paths["port"], sentinel=object(), max_bytes=400).emit("window", i=40)
    assert len(journal_parts(paths["port"])) >= len(ours)


def test_cli_stats_reports_the_parts_as_jax_does(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.25)
    from microrank_tpu.cli.main import main as jax_main

    from microrank_tpu_torch.obs import MetricsRegistry, RunJournal

    run = tmp_path / "run"
    j = RunJournal(run / "journal.jsonl", sentinel=object(), max_bytes=300)
    for i in range(30):
        j.emit("window", start=f"w{i}", outcome="ranked" if i % 2 else "clean")
    (run / "metrics.json").write_text(json.dumps(MetricsRegistry().to_json()))
    outs = []
    for main in (cli.main, jax_main):
        assert main(["stats", str(run), "--journal"]) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    assert "parts" in outs[0].err and "30 windows (15 ranked)" in outs[0].err


def test_cli_stream_journal_max_bytes_reaches_the_config(monkeypatch, tmp_path):
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, *a, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr("microrank_tpu_torch.stream.StreamEngine", fake_engine)
    with pytest.raises(Stop):
        cli.main(["stream", "-o", str(tmp_path), "--device", "cpu", "--windows", "2",
                  "--journal-max-bytes", "2048", "--min-admission-ratio", "0.6"])
    assert seen["cfg"].obs.journal_max_bytes == 2048
    assert seen["cfg"].ingest.min_admission_ratio == 0.6
    assert np.isclose(seen["cfg"].ingest.min_admission_ratio, 0.6)
