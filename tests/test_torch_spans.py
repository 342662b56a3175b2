"""The span tracer (``obs/spans.py``) and the table lane's spans held to
the JAX package on the CPU:

* the tracer alone, driven by the same calls in both packages (nested
  spans, an explicit ``ctx``, an anonymous root, ``attach`` on another
  thread, ``record_span``, a ring of 16 that drops): the same span
  names, trace ids, span ids and parent links, the same ``dropped``;
  a disabled tracer records nothing and the process tracer starts
  disabled;
* ``TableRCA.run`` on the same CSV pair in each loop mode (sync, the
  default, bulk, micro-batched groups, ``batch_windows``): the ring's
  spans equal JAX's (times apart), each window's stages in a
  ``win-<start>`` trace, and ``microrank_spans_recorded_total`` the
  spans recorded; ``ObsConfig(spans=False)`` records none and
  ``span_ring`` bounds the ring, as in JAX;
* ``cli run --no-span-trace`` / ``--span-ring``: the parser's flags are
  JAX's and the written ``metrics.json`` counts JAX's spans.
"""

import argparse
import json
import threading

import pytest

from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import ObsConfig as JaxObs
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.ingest import quarantine as jax_quarantine
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import registry as jax_registry
from microrank_tpu.obs import spans as jax_spans
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import MicroRankConfig, ObsConfig, RuntimeConfig
from microrank_tpu_torch.ingest import quarantine as port_quarantine
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.obs import spans as port_spans
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline


@pytest.fixture(scope="module")
def timeline(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    tl = generate_timeline(SyntheticConfig(
        n_operations=24, n_traces=120, n_kinds=24, child_keep_prob=0.6, seed=9,
    ), n_windows=14, faulted=[1, 2, 4, 5, 7, 8, 10, 11, 13])
    return tl.write_csvs(d)


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """Each package's process dead-letter store and span tracer, as they
    were before the test (runs and CLIs install their own)."""
    for mod in (jax_quarantine, port_quarantine):
        monkeypatch.setattr(mod, "_store", mod._store)
    for mod in (jax_spans, port_spans):
        monkeypatch.setattr(mod, "_tracer", mod._tracer)


@pytest.fixture
def registries():
    old_t, old_j = get_registry(), jax_registry.get_registry()
    t, j = MetricsRegistry(), jax_registry.MetricsRegistry()
    set_registry(t)
    jax_registry.set_registry(j)
    yield t, j
    set_registry(old_t)
    jax_registry.set_registry(old_j)


def shape(spans):
    return [(s.trace_id, s.span_id, s.parent_id, s.name, s.service) for s in spans]


def spans_total(reg):
    m = reg.get("microrank_spans_recorded_total")
    return 0 if m is None else sum(s["value"] for s in m.samples())


def drive(mod, capacity):
    """The same calls on a fresh tracer of ``mod``; returns the tracer."""
    tracer = mod.SpanTracer(capacity=capacity, enabled=True)
    root = tracer.new_trace("win-a")
    with tracer.span("detect", ctx=root):
        with tracer.span("inner", attr=1) as inner:
            assert tracer.current_context() == inner
    with tracer.span("orphan"):
        pass
    with tracer.span("outer") as outer:
        captured = tracer.current_context()
        assert captured == outer

        def worker():
            with tracer.attach(captured), tracer.span("on_worker", service="stream"):
                pass

        t = threading.Thread(target=worker, name="mr-worker")
        t.start()
        t.join()
    tracer.record_span("root", root, start_us=5, dur_us=-3, parent_id=None)
    for i in range(20):
        with tracer.span(f"s{i}", ctx=root):
            pass
    return tracer


@pytest.mark.parametrize("capacity", [8192, 16])
def test_tracer_calls_give_jax_spans(capacity, registries):
    ours, theirs = drive(port_spans, capacity), drive(jax_spans, capacity)
    assert shape(ours.snapshot()) == shape(theirs.snapshot())
    assert [s.thread for s in ours.snapshot()] == [s.thread for s in theirs.snapshot()]
    assert [s.attrs for s in ours.snapshot()] == [s.attrs for s in theirs.snapshot()]
    assert (len(ours), ours.dropped, ours.recorded) == (len(theirs), theirs.dropped,
                                                       theirs.recorded)
    assert len(ours) == min(capacity, ours.recorded)
    reg, jreg = registries
    assert spans_total(reg) == spans_total(jreg) == ours.recorded


def test_a_disabled_tracer_records_nothing(registries):
    port_spans.set_tracer(None)
    assert not port_spans.get_tracer().enabled  # the process tracer starts off
    tracer = port_spans.SpanTracer(enabled=False)
    with tracer.span("x") as ctx:
        assert ctx is None
    tracer.record_span("root", tracer.new_trace("t"), 0, 1)
    assert len(tracer) == 0 and tracer.recorded == 0 and spans_total(registries[0]) == 0
    port_spans.configure_tracer(ObsConfig(span_ring=3))
    assert port_spans.get_tracer().capacity == 16  # at least 16, as JAX's


MODES = {
    "sync": dict(pipeline_depth=1, async_dispatch=False),
    "default": {},
    "bulk": dict(fetch_mode="bulk"),
    "chunked": dict(fetch_mode="bulk", dispatch_batch_windows=2),
    "batch": {},
}


def run_both(timeline, tmp_path, mode, obs=None):
    normal, abnormal = timeline
    rings = {}
    for pkg, rca_cls, cfg_cls, runtime_cls, obs_cls, load, mod in (
        ("port", TableRCA, MicroRankConfig, RuntimeConfig, ObsConfig, load_span_table,
         port_spans),
        ("jax", JaxTableRCA, JaxConfig, JaxRuntime, JaxObs, jax_load, jax_spans),
    ):
        cfg = cfg_cls(runtime=runtime_cls(**MODES[mode]), obs=obs_cls(**(obs or {})))
        rca = rca_cls(cfg, **({"device": "cpu"} if pkg == "port" else {}))
        rca.fit_baseline(load(normal, cache=False))
        results = rca.run(load(abnormal, cache=False), out_dir=tmp_path / pkg,
                          batch_windows=mode == "batch")
        rings[pkg] = (mod.get_tracer(), results)
    return rings


@pytest.mark.parametrize("mode", list(MODES))
def test_table_run_ring_is_jax_s(timeline, tmp_path, registries, mode):
    rings = run_both(timeline, tmp_path, mode)
    (ours, results), (theirs, _) = rings["port"], rings["jax"]
    spans = ours.snapshot()
    assert shape(spans) == shape(theirs.snapshot())
    assert spans and ours.dropped == 0
    names = {s.name for s in spans}
    assert "detect" in names and ("rank_batched" in names if mode == "batch"
                                  else "rank_dispatch" in names)
    windows = {f"win-{r.start}" for r in results}
    for s in spans:
        if s.name in ("build", "rank_batched"):
            assert s.trace_id.startswith("trace-") and s.parent_id is None
        else:
            assert s.trace_id in windows and s.parent_id is not None
    reg, jreg = registries
    assert spans_total(reg) == spans_total(jreg) == len(spans)


def test_spans_off_and_a_small_ring_as_jax(timeline, tmp_path, registries):
    reg, jreg = registries
    rings = run_both(timeline, tmp_path / "off", "default", dict(spans=False))
    assert len(rings["port"][0]) == len(rings["jax"][0]) == 0
    assert spans_total(reg) == spans_total(jreg) == 0
    rings = run_both(timeline, tmp_path / "small", "sync", dict(span_ring=16))
    (ours, _), (theirs, _) = rings["port"], rings["jax"]
    assert shape(ours.snapshot()) == shape(theirs.snapshot())
    assert len(ours) == 16 and ours.dropped == theirs.dropped > 0


def test_cli_span_flags_are_jax_s(timeline, tmp_path, registries):
    from microrank_tpu.cli.main import _add_config_flags
    from microrank_tpu.cli.main import main as jax_main

    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    jax_run = argparse.ArgumentParser()
    _add_config_flags(jax_run)
    for flag in ("--no-span-trace", "--span-ring", "--quarantine-dir"):
        a, b = (next(x for x in p._actions if flag in x.option_strings)
                for p in (sub.choices["run"], jax_run))
        assert (a.dest, a.default, getattr(a.type, "__name__", None), a.help, type(a)) == (
            b.dest, b.default, getattr(b.type, "__name__", None), b.help, type(b))
    normal, abnormal = timeline
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    totals = {}
    for flags in ([], ["--no-span-trace"], ["--span-ring", "20"]):
        for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                 ("jax", jax_main, ["--engine", "native"])):
            out = tmp_path / f"{pkg}{len(flags)}"
            set_registry(MetricsRegistry())
            jax_registry.set_registry(jax_registry.MetricsRegistry())
            assert main(base + ["-o", str(out)] + flags + extra) == 0
            snap = json.loads((out / "metrics.json").read_text())["metrics"]
            totals[pkg, len(flags)] = sum(
                s["value"] for s in snap["microrank_spans_recorded_total"]["samples"])
    assert totals[("port", 0)] == totals[("jax", 0)] > 0
    assert totals[("port", 1)] == totals[("jax", 1)] == 0
    assert totals[("port", 2)] == totals[("jax", 2)] == totals[("port", 0)]
