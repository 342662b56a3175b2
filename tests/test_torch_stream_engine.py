"""``run_stream`` against JAX's ``StreamEngine`` on the same timelines
(the port's generator gives JAX's spans; JAX's frames carry
``datetime64[ns]`` timestamps, which its window code assumes), in the
default mode (tumbling windows, coalescing), ``warm_start`` and
``fused_pair`` (sliding windows, a convergence tol), sliding cold,
and with ``device_checks``:

* the summary counts (windows, ranked, clean, empty, skipped, warmup,
  dispatches, incidents opened and resolved);
* the incident event sequence (``incidents.jsonl``: event, id, windows);
* every ranked window's ranking, tie-aware identical with scores within
  rtol 1e-5, its ``n_iters`` and its route;
* the warm start's steps against cold, JAX's window by window where
  JAX's own warm run takes more;
* a ``cli stream`` smoke on the CPU, and the flags whose lanes are not
  ported refusing with the item that brings them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from microrank_tpu_torch import cli
from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig, StreamConfig
from microrank_tpu_torch.stream import SyntheticSource, run_stream
from microrank_tpu_torch.testing import SyntheticConfig
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

SYNTH = dict(n_operations=24, n_traces=200, n_kinds=16, seed=5)
MODES = {
    "default": (dict(), dict(), dict()),
    "warm_start": (dict(slide_minutes=2.5), dict(warm_start=True), dict(tol=1e-4, iterations=50)),
    "fused_pair": (dict(slide_minutes=2.5), dict(fused_pair=True), dict(tol=1e-4, iterations=50)),
    "cold_sliding": (dict(slide_minutes=2.5), dict(), dict(tol=1e-4, iterations=50)),
    "device_checks": (dict(), dict(device_checks=True), dict()),
}


def ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


def jax_run(mode, out_dir, n_windows=8, faulted=(3, 4, 5), pipeline=None, synth=SYNTH):
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import RuntimeConfig as JaxRuntime
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.stream import StreamEngine
    from microrank_tpu.stream.sources import ReplaySource
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    sc, rt, pr = MODES[mode]
    tl = generate_timeline(JaxSynth(**synth), n_windows, list(faulted))
    cfg = JaxConfig().replace(
        stream=JaxStream(allowed_lateness_seconds=0.0, checkpoint=False,
                         **dict(sc, **(pipeline or {}))),
        runtime=dataclasses.replace(JaxRuntime(), **rt),
        pagerank=JaxPageRank(**pr),
        dispatch=JaxDispatch(warmup_manifest=False),
    )
    engine = StreamEngine(cfg, ReplaySource(ns(tl.timeline), chunk_spans=4000),
                          out_dir=out_dir, normal_df=ns(tl.normal))
    return engine.run()


def port_run(mode, out_dir, n_windows=8, faulted=(3, 4, 5), pipeline=None, synth=SYNTH):
    sc, rt, pr = MODES[mode]
    cfg = MicroRankConfig().replace(
        stream=StreamConfig(allowed_lateness_seconds=0.0, **dict(sc, **(pipeline or {}))),
        runtime=dataclasses.replace(RuntimeConfig(device="cpu"), **rt),
        pagerank=PageRankConfig(**pr),
    )
    src = SyntheticSource(n_windows, list(faulted), SyntheticConfig(**synth), chunk_spans=4000)
    return run_stream(cfg, src, out_dir=out_dir, device="cpu"), src


COUNTS = ("windows", "ranked", "clean", "empty", "skipped", "warmup", "dispatches",
          "incidents_opened", "incidents_resolved", "late_spans", "spans")


def incident_events(out_dir):
    lines = (out_dir / "incidents.jsonl").read_text().splitlines()
    return [(e["event"], e["incident_id"], e["windows"], e["top"][0][0])
            for e in map(json.loads, lines)]


@pytest.mark.parametrize("mode", list(MODES))
def test_run_stream_matches_jax(tmp_path, mode):
    j = jax_run(mode, tmp_path / "jax")
    t, src = port_run(mode, tmp_path / "port")
    assert {k: getattr(t, k) for k in COUNTS} == {k: getattr(j, k) for k in COUNTS}
    assert incident_events(tmp_path / "port") == incident_events(tmp_path / "jax")
    assert t.incidents_opened == 1 and t.incidents_resolved == 1
    assert len(t.results) == len(j.results)
    ranked = 0
    for a, b in zip(j.results, t.results):
        assert (a.start, a.end, a.anomaly, a.skipped_reason, a.n_normal, a.n_abnormal) == (
            b.start, b.end, b.anomaly, b.skipped_reason, b.n_normal, b.n_abnormal)
        assert bool(a.ranking) == bool(b.ranking)
        if not a.ranking:
            continue
        ranked += 1
        names_a, scores_a = zip(*a.ranking)
        names_b, scores_b = zip(*b.ranking)
        ok, why = tie_aware_topk_agreement(list(names_a), list(scores_a), list(names_b),
                                           list(scores_b), k=len(names_a), rtol=1e-5)
        assert ok, (a.start, why)
        np.testing.assert_allclose(scores_b, scores_a, rtol=1e-5)
        assert b.rank_iterations == a.rank_iterations
        assert b.route == (a.route if mode != "device_checks" else None)
        assert b.kernel == a.kernel
        assert b.ranking[0][0] == src.fault_pod_op
    assert ranked == t.ranked
    if mode == "default":
        assert t.dispatches < t.ranked   # coalescing
    if mode in ("warm_start", "fused_pair"):
        routes = [r.route for r in t.results if r.ranking]
        assert routes[0].endswith("_cold") and all(not r.endswith("_cold") for r in routes[1:])


def test_warm_start_takes_jaxs_steps_even_where_they_exceed_cold(tmp_path):
    """The warm start's step counts are JAX's window by window, warm and
    cold, also where JAX's own warm run takes more steps than its cold
    run: its map joins a kind column by the kind's earliest trace, which
    a slide drops, so rv starts cold beside a warm sv. On this timeline
    (seed 2) JAX takes more steps warm than cold at three windows and
    over the incident (99 against 96 on an x86 host), the behaviour that
    chip_smoke's stream line records at config 5 and does not gate."""
    synth = dict(SYNTH, seed=2)
    iters = {}
    for who, run in (("jax", jax_run), ("port", port_run)):
        for mode in ("warm_start", "cold_sliding"):
            out = run(mode, tmp_path / f"{who}-{mode}", synth=synth)
            s = out if who == "jax" else out[0]
            iters[who, mode] = [r.rank_iterations for r in s.results if r.ranking]
    assert iters["port", "warm_start"] == iters["jax", "warm_start"]
    assert iters["port", "cold_sliding"] == iters["jax", "cold_sliding"]
    warm, cold = iters["jax", "warm_start"], iters["jax", "cold_sliding"]
    assert len(warm) == len(cold) > 1
    assert sum(warm) > sum(cold) and any(w > c for w, c in zip(warm, cold)), (warm, cold)


def test_cli_stream_smoke(tmp_path, capsys):
    out = tmp_path / "out"
    rc = cli.main(["stream", "--device", "cpu", "--windows", "6", "--fault-windows", "2,3",
                   "--operations", "24", "--traces", "200", "--kinds", "16", "--seed", "5",
                   "--slide-minutes", "2.5", "--warm-start", "-o", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "window " in printed and "[incident] incident_open" in printed
    for name in ("incidents.jsonl", "journal.jsonl", "metrics.json", "windows.jsonl"):
        assert (out / name).exists(), name
    journal = [json.loads(x) for x in (out / "journal.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in journal]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end" and "window" in kinds
    metrics = json.loads((out / "metrics.json").read_text())
    assert "microrank_stream_windows_total" in json.dumps(metrics)


@pytest.mark.parametrize("flags,item", [
    (["--resume"], "item 11"), (["--mesh", "2x4"], "item 12"), (["--fleet", "2"], "item 11"),
    (["--delta-build"], "delta"), (["--warehouse"], "item 11"),
    (["--fault-kind", "error"], "item 11"), (["--drift", "0.1"], "item 11"),
])
def test_cli_stream_refuses_what_is_not_ported(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["stream", "--device", "cpu", "-o", str(tmp_path / "o"), *flags])
