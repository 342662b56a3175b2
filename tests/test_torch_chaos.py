"""The crash-only machinery (``microrank_tpu_torch.chaos``) against the
JAX package's (``microrank_tpu.chaos``), on the CPU:

* the checkpoint envelope in both directions (each package's
  ``load_checkpoint`` reads the other's file; a torn or tampered one is
  rejected whole by both), and a crash between tmp and rename;
* the fault plan's counting and determinism, the retry attempt sequence
  (delays from one seeded ``random.Random``) and its metrics, and the
  breaker's open, half-open and close, each equal to JAX's;
* the windower and source cursors across a checkpoint;
* the engine: a stop-and-resume run and a subprocess killed at the
  ``checkpoint`` seam, whose incidents (one open, one resolve) and
  window verdicts equal JAX's resumed engine (JAX's frames cast to
  ``datetime64[ns]``, which its window code assumes; rankings within
  rtol 1e-5, tie-aware); a corrupt checkpoint rejected whole; a plan of
  dispatch, build, fetch, source and webhook faults that drops no window
  and changes no bit, its retries counted as JAX counts them; an
  exhausted window skipped and counted, never ranked elsewhere;
* serve: a ``serve_dispatch`` fault retried under ``DISPATCH_POLICY``,
  and on a CUDA router (mocked) an exhausted batch answering 500.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import subprocess
import sys
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu_torch.chaos import (
    DISPATCH_POLICY,
    BreakerOpen,
    CheckpointError,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RetryPolicy,
    configure_chaos,
    get_breaker,
    load_checkpoint,
    maybe_inject,
    reset_breakers,
    retry_call,
    save_checkpoint,
)
from microrank_tpu_torch.config import (
    ChaosConfig,
    DispatchConfig,
    MicroRankConfig,
    RuntimeConfig,
    ServeConfig,
    StreamConfig,
)
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.stream import StreamEngine, SyntheticSource
from microrank_tpu_torch.testing import SyntheticConfig
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

ROOT = Path(__file__).resolve().parents[1]
SYNTH = dict(n_operations=16, n_traces=100, n_kinds=12, seed=5)
FAULTED = (3, 4)
N_WINDOWS = 8
RTOL = 1e-5


@pytest.fixture(autouse=True)
def registry():
    """A fresh registry, no fault plan and closed breakers per test, in
    both packages (their chaos state is process-wide)."""
    from microrank_tpu.chaos import configure_chaos as jax_configure
    from microrank_tpu.chaos import reset_breakers as jax_reset
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set

    old, jold = get_registry(), jax_get()
    reg = MetricsRegistry()
    set_registry(reg)
    jax_set(JaxRegistry())
    for configure, reset, cfg in ((configure_chaos, reset_breakers, MicroRankConfig()),
                                  (jax_configure, jax_reset, JaxConfig())):
        configure(cfg)
        reset()
    yield reg
    configure_chaos(MicroRankConfig())
    jax_configure(JaxConfig())
    reset_breakers()
    jax_reset()
    set_registry(old)
    jax_set(jold)


def _jax_registry():
    from microrank_tpu.obs import get_registry as jax_get

    return jax_get()


# ------------------------------------------------------- checkpoint IO


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_envelope_reads_in_both_directions(tmp_path, writer):
    """A checkpoint either package writes, the other's ``load_checkpoint``
    returns whole; torn, bit-flipped or version-skewed it is rejected by
    both."""
    from microrank_tpu.chaos import CheckpointError as JaxCheckpointError
    from microrank_tpu.chaos import load_checkpoint as jax_load
    from microrank_tpu.chaos import save_checkpoint as jax_save

    payload = {"baseline": {"ops": {"a": {"m1": 1.5}}}, "tracker": {"open": []},
               "windower": {"next": 3}, "source": {"type": "replay", "row": 42},
               "summary": {"windows": 3}}
    path = tmp_path / "state.ckpt"
    (save_checkpoint if writer == "port" else jax_save)(path, payload)
    assert load_checkpoint(path) == jax_load(path) == payload
    doc = json.loads(path.read_text())
    assert set(doc) == {"version", "ts", "sha256", "payload"} and doc["version"] == 1
    for tamper in (lambda d: d["payload"]["source"].update(row=43),
                   lambda d: d.update(version=2)):
        bad = json.loads(path.read_text())
        tamper(bad)
        (tmp_path / "bad.ckpt").write_text(json.dumps(bad))
        with pytest.raises(CheckpointError):
            load_checkpoint(tmp_path / "bad.ckpt")
        with pytest.raises(JaxCheckpointError):
            jax_load(tmp_path / "bad.ckpt")
    (tmp_path / "torn.ckpt").write_text(path.read_text()[:40])
    with pytest.raises(CheckpointError, match="torn"):
        load_checkpoint(tmp_path / "torn.ckpt")


def test_checkpoint_write_crash_between_tmp_and_rename(tmp_path):
    path = tmp_path / "state.ckpt"
    save_checkpoint(path, {"gen": 1})
    configure_chaos(MicroRankConfig(chaos=ChaosConfig(
        enabled=True, faults=({"seam": "checkpoint", "kind": "crash"},))))
    with pytest.raises(InjectedFault):
        save_checkpoint(path, {"gen": 2})
    assert load_checkpoint(path) == {"gen": 1}          # the old one stands
    assert list(tmp_path.glob("state.ckpt.tmp.*"))      # the torn tmp is left
    save_checkpoint(path, {"gen": 3})                   # count spent
    assert load_checkpoint(path) == {"gen": 3}


# --------------------------------------------------------- fault plan

PLAN = [
    {"seam": "dispatch", "kind": "fail", "after": 1, "count": 2},
    {"seam": "webhook", "kind": "hang", "value": 5.0, "every": 2, "count": -1},
    {"seam": "build", "kind": "fail", "prob": 0.5, "count": -1},
    {"seam": "fetch", "kind": "nan", "after": 2, "every": 3, "count": 2},
]


def test_fault_plan_counting_and_determinism_equal_jax():
    """One plan and seed in both packages: the same events fire, the
    probabilistic spec drawing the same ``random.Random(seed)`` stream."""
    from microrank_tpu.chaos import FaultPlan as JaxPlan
    from microrank_tpu.chaos import FaultSpec as JaxSpec

    seams = ["dispatch", "webhook", "build", "fetch"] * 12
    rng = random.Random(0)
    rng.shuffle(seams)
    plans = [FaultPlan([FaultSpec.from_dict(s) for s in PLAN], seed=7),
             FaultPlan([FaultSpec.from_dict(s) for s in PLAN], seed=7),
             JaxPlan([JaxSpec.from_dict(s) for s in PLAN], seed=7)]
    fired = [[p.fire(seam) for seam in seams] for p in plans]
    assert fired[0] == fired[1] == fired[2]
    assert plans[0].injected == plans[2].injected and len(plans[0].injected) > 6


def test_maybe_inject_kinds_and_metrics_equal_jax():
    from microrank_tpu.chaos import InjectedFault as JaxInjected
    from microrank_tpu.chaos import configure_chaos as jax_configure
    from microrank_tpu.chaos import maybe_inject as jax_inject
    from microrank_tpu.config import ChaosConfig as JaxChaos
    from microrank_tpu.config import MicroRankConfig as JaxConfig

    faults = ({"seam": "s1", "kind": "fail", "count": 1},
              {"seam": "s2", "kind": "stall", "value": 80.0, "count": 1},
              {"seam": "s3", "kind": "nan", "count": 1})
    configure_chaos(MicroRankConfig(chaos=ChaosConfig(enabled=True, faults=faults)))
    jax_configure(JaxConfig(chaos=JaxChaos(enabled=True, faults=faults)))
    for inject, fault in ((maybe_inject, InjectedFault), (jax_inject, JaxInjected)):
        with pytest.raises(fault):
            inject("s1")
        assert inject("s1") is None                    # count spent
        slept = []
        assert inject("s2", sleep=slept.append)["kind"] == "stall" and slept == [0.08]
        assert inject("s3")["kind"] == "nan"
    ours = get_registry().get("microrank_fault_injections_total").samples()
    theirs = _jax_registry().get("microrank_fault_injections_total").samples()
    assert sorted(map(json.dumps, ours)) == sorted(map(json.dumps, theirs))


def test_source_data_plan_refused_at_load_naming_item_9(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [{"seam": "source_data", "kind": "dup_span"}]}))
    with pytest.raises(NotImplementedError, match="item 9"):
        configure_chaos(MicroRankConfig(chaos=ChaosConfig(enabled=True,
                                                          plan_path=str(plan))))


# -------------------------------------------------------- retry policy


def _flaky(fails):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise RuntimeError(f"transient {calls['n']}")
        return calls["n"]
    return fn


def _value(reg, name, fails):
    metric = reg.get(name)
    return 0.0 if metric is None else metric.value(seam=f"seam_{fails}")


@pytest.mark.parametrize("policy_name", ["DISPATCH_POLICY", "STREAM_DISPATCH_POLICY",
                                         "BUILD_POLICY", "WEBHOOK_POLICY"])
@pytest.mark.parametrize("fails", [0, 1, 2, 5])
def test_retry_attempt_sequence_equals_jax(policy_name, fails):
    """Each policy, JAX's constants: the same outcome, the same jittered
    delays from the same seeded stream, the same retry and exhausted
    counts."""
    import microrank_tpu.chaos.retry as jax_retry
    import microrank_tpu_torch.chaos.retry as port_retry

    runs = []
    for mod, reg in ((port_retry, get_registry), (jax_retry, _jax_registry)):
        policy = getattr(mod, policy_name)
        sleeps = []
        try:
            out = mod.retry_call(f"seam_{fails}", _flaky(fails), policy=policy,
                                 sleep=sleeps.append, rng=random.Random(11))
        except RuntimeError as e:
            out = str(e)
        runs.append((out, sleeps, _value(reg(), "microrank_retry_attempts_total", fails),
                     _value(reg(), "microrank_retry_exhausted_total", fails),
                     dataclasses.asdict(policy)))
    assert runs[0] == runs[1]
    assert len(runs[0][1]) == min(fails, runs[0][4]["max_attempts"] - 1)


def test_circuit_breaker_open_half_open_close_equals_jax():
    """Threshold 3, reset 10 s on a fake clock: the same allow /
    state / gauge sequence through closed -> open -> half-open -> open
    -> half-open -> closed in both packages."""
    from microrank_tpu.chaos import BreakerOpen as JaxBreakerOpen
    from microrank_tpu.chaos import RetryPolicy as JaxPolicy
    from microrank_tpu.chaos import get_breaker as jax_breaker
    from microrank_tpu.chaos import retry_call as jax_retry_call

    traces = []
    for breaker_of, policy_cls, call, opened, reg in (
            (get_breaker, RetryPolicy, retry_call, BreakerOpen, get_registry),
            (jax_breaker, JaxPolicy, jax_retry_call, JaxBreakerOpen, _jax_registry)):
        now = {"t": 0.0}
        policy = policy_cls(max_attempts=1, breaker_threshold=3, breaker_reset_s=10.0)
        br = breaker_of("br_seam", policy)
        br.clock = lambda: now["t"]
        trace = []

        def step(fn, now=now, br=br, call=call, opened=opened, policy=policy, trace=trace,
                 reg=reg):
            try:
                call("br_seam", fn, policy=policy, sleep=lambda s: None)
                trace.append(("ok", br.state))
            except opened:
                trace.append(("fast_fail", br.state))
            except RuntimeError:
                trace.append(("fail", br.state))
            trace.append(reg().get("microrank_breaker_state").value(seam="br_seam"))

        boom = _flaky(10 ** 6)
        for _ in range(4):
            step(boom)                    # 3 failures open it; the 4th fails fast
        now["t"] = 5.0
        step(boom)                        # still open
        now["t"] = 10.5
        step(boom)                        # the half-open probe fails: open again
        now["t"] = 21.0
        step(lambda: "fine")              # the probe succeeds: closed
        step(lambda: "fine")
        traces.append(trace)
    assert traces[0] == traces[1]
    assert ("fast_fail", "open") in traces[0] and traces[0][-2] == ("ok", "closed")


# ------------------------------------------------------- source cursors


def test_replay_source_cursor_restore():
    from microrank_tpu_torch.stream import ReplaySource

    src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH), chunk_spans=300)
    whole = [b.first_row for b in src]
    it = iter(src)
    next(it), next(it)
    state = src.checkpoint_state()
    assert state == {"type": "replay", "row": 600}
    twin = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH), chunk_spans=300)
    twin.restore_state(state)
    rest = [b.first_row for b in twin]
    assert rest[0] == 600 and rest == list(range(600, src.table.n_spans, 300))
    assert len(whole) == 2 + len(rest)
    with pytest.raises(ValueError, match="replay cursor"):
        ReplaySource(src.table).restore_state({"type": "tail"})


def test_file_tail_source_cursor_restore(tmp_path):
    """The tail's byte cursor and row ids survive a checkpoint; a rotated
    file (another header) re-reads from scratch."""
    from microrank_tpu_torch.stream import FileTailSource

    src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH))
    _, abnormal = src.timeline.write_csvs(tmp_path / "data")
    path = tmp_path / "tail.csv"
    lines = abnormal.read_text().splitlines(keepends=True)
    path.write_text("".join(lines[:60]))
    tail = FileTailSource(path, poll_seconds=0.0, max_polls=1, sleep=lambda s: None)
    first = list(tail)
    assert sum(len(b) for b in first) == 59
    state = json.loads(json.dumps(tail.checkpoint_state()))
    assert state["rows"] == 59 and state["offset"] == len("".join(lines[:60]).encode())
    with open(path, "a") as f:
        f.write("".join(lines[60:90]))
    twin = FileTailSource(path, poll_seconds=0.0, max_polls=1, sleep=lambda s: None)
    twin.restore_state(state)
    rest = list(twin)
    assert [b.first_row for b in rest] == [59] and len(rest[0]) == 30
    rotated = tmp_path / "rot.csv"   # its columns in another order: another header

    def swap(line):
        a, b, rest = line.split(",", 2)
        return ",".join((b, a, rest))

    rotated.write_text("".join(swap(x) for x in lines[:10]))
    tail2 = FileTailSource(rotated, poll_seconds=0.0, max_polls=1, sleep=lambda s: None)
    tail2.restore_state(state)
    assert sum(len(b) for b in tail2) == 9           # the whole file again


def test_windower_state_round_trip_keeps_buffers_and_cursor():
    """A windower checkpointed mid-stream (open buffers, sliding
    windows) and restored closes every later window exactly as the one
    that never stopped: the same tables, parents and vocabularies."""
    from microrank_tpu_torch.stream import StreamWindower

    src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH), chunk_spans=700)
    batches = list(src)
    geom = dict(width_us=300_000_000, slide_us=150_000_000, lateness_us=20_000_000)
    ref = StreamWindower(**geom)
    want = [w for b in batches for w in ref.add(b)] + ref.flush()
    cut = 3
    a = StreamWindower(**geom)
    got = [w for b in batches[:cut] for w in a.add(b)]
    assert a._buffers, "no open buffer at the cut"
    b = StreamWindower(**geom)
    b.restore(json.loads(json.dumps(a.to_state())))
    got += [w for batch in batches[cut:] for w in b.add(batch)] + b.flush()
    assert [(w.start_us, w.end_us) for w in got] == [(w.start_us, w.end_us) for w in want]
    for g, w in zip(got, want):
        assert (g.table is None) == (w.table is None)
        if g.table is None:
            continue
        for f in g.table._fields:
            x, y = getattr(g.table, f), getattr(w.table, f)
            assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), f
    with pytest.raises(ValueError, match="geometry"):
        StreamWindower(width_us=60_000_000).restore(a.to_state())


# ------------------------------------------------------------- engine


def _port_cfg(*faults, warehouse=False, **stream_kw):
    from microrank_tpu_torch.config import WarehouseConfig

    stream_kw.setdefault("allowed_lateness_seconds", 0.0)
    return MicroRankConfig(
        stream=StreamConfig(**stream_kw),
        runtime=RuntimeConfig(device="cpu"),
        dispatch=DispatchConfig(warmup_manifest=False),
        chaos=ChaosConfig(enabled=bool(faults), seed=3, faults=tuple(faults)),
        warehouse=WarehouseConfig(enabled=warehouse),
    )


def _port_source(chunk=300):
    return SyntheticSource(N_WINDOWS, list(FAULTED), SyntheticConfig(**SYNTH),
                           chunk_spans=chunk)


def _jax_engine(out_dir, resume=False, chunk=300, **stream_kw):
    """JAX's engine over the port generator's timeline (``datetime64[ns]``
    frames through its ReplaySource), checkpointing into ``out_dir``."""
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.stream import StreamEngine as JaxEngine
    from microrank_tpu.stream.sources import ReplaySource as JaxReplay
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    stream_kw.setdefault("allowed_lateness_seconds", 0.0)
    tl = generate_timeline(JaxSynth(**SYNTH), N_WINDOWS, list(FAULTED))
    cfg = JaxConfig().replace(stream=JaxStream(**stream_kw),
                              dispatch=JaxDispatch(warmup_manifest=False))
    return JaxEngine(cfg, JaxReplay(_ns(tl.timeline), chunk_spans=chunk), out_dir=out_dir,
                     normal_df=_ns(tl.normal), resume=resume)


def _ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


def _incidents(out_dir):
    return [(e["event"], e["incident_id"], e["windows"], e["top"][0][0])
            for e in map(json.loads, (Path(out_dir) / "incidents.jsonl").read_text().splitlines())]


def _verdicts(out_dir):
    """windows.jsonl: (start, outcome fields, ranking) of every window."""
    rows = [json.loads(x) for x in (Path(out_dir) / "windows.jsonl").read_text().splitlines()]
    return [(r["start"], r["anomaly"], r["skipped_reason"], r["ranking"]) for r in rows]


def _same_verdicts(port, jax):
    assert [v[:3] for v in port] == [v[:3] for v in jax]
    for (start, *_, a), (_, *_, b) in zip(port, jax):
        assert bool(a) == bool(b), start
        if not a:
            continue
        ok, why = tie_aware_topk_agreement([n for n, _ in b], [s for _, s in b],
                                           [n for n, _ in a], [s for _, s in a], len(b),
                                           rtol=RTOL)
        assert ok, (start, why)
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=RTOL)


def test_engine_stop_and_resume_equals_jax(tmp_path):
    """Stopped with the incident open (max_windows) and resumed by a
    fresh engine: one open, one resolve, no window twice, no cold
    start; the incidents and every window's verdict equal JAX's engine
    stopped and resumed the same way."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    s1 = StreamEngine(_port_cfg(max_windows=5), _port_source(), out_dir=port).run()
    j1 = _jax_engine(jax, max_windows=5).run()
    assert s1.windows == j1.windows == 5 and s1.incidents_opened == 1
    assert s1.incidents_resolved == 0
    ckpt = load_checkpoint(port / "state.ckpt")
    assert ckpt["tracker"]["open"] and ckpt["source"]["row"] > 0
    eng = StreamEngine(_port_cfg(), _port_source(), out_dir=port, resume=True)
    assert eng.resumed
    s2 = eng.run()
    j2 = _jax_engine(jax, resume=True).run()
    assert (s2.windows, s2.ranked, s2.warmup, s2.incidents_opened, s2.incidents_resolved) == (
        j2.windows, j2.ranked, j2.warmup, j2.incidents_opened, j2.incidents_resolved) == (
        N_WINDOWS, 2, 0, 1, 1)
    assert _incidents(port) == _incidents(jax)
    assert [e[0] for e in _incidents(port)] == ["incident_open", "incident_update",
                                                "incident_resolve"]
    _same_verdicts(_verdicts(port), _verdicts(jax))
    from microrank_tpu_torch.obs.journal import read_journal

    events = read_journal(port / "journal.jsonl")
    starts = [e["start"] for e in events if e["event"] == "window"]
    assert len(starts) == len(set(starts)) == N_WINDOWS
    assert [e["resumed"] for e in events if e["event"] == "run_start"] == [False, True]


def test_stream_killed_at_checkpoint_seam_resumes_as_jax(tmp_path):
    """``cli stream`` killed (os._exit) at its fourth checkpoint, the
    faulted group's (the incident opened, its lines written, the
    checkpoint not), then ``--resume``d without the plan: the
    result logs are cut back to the checkpoint, so the incidents (one
    open, one resolve) and the window verdicts equal JAX's resumed
    engine; every window's ranking is the uninterrupted run's, bit for
    bit."""
    plan = tmp_path / "kill.json"
    plan.write_text(json.dumps({"faults": [{"seam": "checkpoint", "kind": "kill",
                                            "after": 3, "count": 1}]}))
    argv = [sys.executable, "-m", "microrank_tpu_torch.cli", "stream", "--device", "cpu",
            "--windows", str(N_WINDOWS), "--fault-windows", ",".join(map(str, FAULTED)),
            "--operations", "16", "--traces", "100", "--kinds", "12", "--seed", "5",
            "--lateness-seconds", "0", "--chunk-spans", "300"]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "MICRORANK_JIT_CACHE": str(tmp_path / "jit")}
    out = tmp_path / "port"

    def run(*extra, out=out):
        return subprocess.run(argv + ["-o", str(out), *extra], env=env, capture_output=True,
                              text=True, timeout=300)

    killed = run("--chaos", str(plan))
    assert killed.returncode == 137, killed.stderr[-2000:]
    assert _incidents(out)[0][0] == "incident_open"     # opened before the kill
    resumed = run("--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    ref = run(out=tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    jax = tmp_path / "jax"
    _jax_engine(jax, max_windows=4).run()
    _jax_engine(jax, resume=True).run()
    assert [e[0] for e in _incidents(out)] == ["incident_open", "incident_update",
                                               "incident_resolve"]
    assert _incidents(out) == _incidents(jax) == _incidents(tmp_path / "ref")
    assert _verdicts(out) == _verdicts(tmp_path / "ref")     # bitwise
    assert (out / "result.csv").read_text() == (tmp_path / "ref" / "result.csv").read_text()
    _same_verdicts(_verdicts(out), _verdicts(jax))


def test_engine_rejects_corrupt_checkpoint_and_cold_starts(tmp_path, registry):
    (tmp_path / "state.ckpt").write_text("{ torn garbage")
    eng = StreamEngine(_port_cfg(), _port_source(), out_dir=tmp_path, resume=True)
    assert not eng.resumed
    assert registry.get("microrank_checkpoint_events_total").value(event="rejected") == 1
    s = eng.run()
    assert s.windows == N_WINDOWS and s.incidents_opened == 1


def test_rejection_is_whole_after_a_partial_restore(tmp_path, registry):
    """A checkpoint whose baseline and tracker restore but whose windower
    geometry differs is rejected whole: the baseline, tracker, windower
    and source cursor all start cold, not half restored."""
    StreamEngine(_port_cfg(max_windows=5), _port_source(), out_dir=tmp_path).run()
    eng = StreamEngine(_port_cfg(slide_minutes=2.5), _port_source(), out_dir=tmp_path,
                       resume=True)
    assert not eng.resumed
    assert eng.tracker.opened == 0 and not eng.tracker.has_open
    assert eng.windower._next == 0 and eng.summary.windows == 0
    assert eng.source._replay._skip_rows == 0
    fresh = StreamEngine(_port_cfg(slide_minutes=2.5), _port_source(), out_dir=tmp_path / "f")
    assert eng.baseline.to_state() == fresh.baseline.to_state()


# Two dispatch failures then a poisoned fetch at the next dispatch: three
# failed attempts in one dispatch would exhaust STREAM_DISPATCH_POLICY.
FAULTS = ({"seam": "dispatch", "kind": "fail", "count": 2},
          {"seam": "build", "kind": "fail", "count": 1},
          {"seam": "fetch", "kind": "nan", "after": 1, "count": 1},
          {"seam": "source_stall", "kind": "stall", "value": 1.0, "count": 1},
          {"seam": "webhook", "kind": "hang", "value": 1.0, "count": 1})


def test_engine_fault_plan_drops_no_window_and_changes_no_bit(tmp_path, registry):
    """Dispatch, build, fetch, source and webhook faults: no window is
    dropped, every ranking is the uninjected run's bit for bit, and the
    retries and injections are counted as JAX's engine counts them
    under the same plan."""
    from microrank_tpu.config import ChaosConfig as JaxChaos
    from microrank_tpu.obs.journal import read_journal as jax_read

    hook = dict(webhook_url="http://127.0.0.1:9/unroutable", webhook_timeout_seconds=0.2,
                pipeline_windows=1)
    clean = StreamEngine(_port_cfg(**hook), _port_source(), out_dir=tmp_path / "clean").run()
    s = StreamEngine(_port_cfg(*FAULTS, **hook), _port_source(), out_dir=tmp_path / "f").run()
    assert (s.windows, s.ranked, s.skipped) == (N_WINDOWS, 2, 0)
    assert [r.ranking for r in s.results] == [r.ranking for r in clean.results]
    jeng = _jax_engine(tmp_path / "jax", **hook)
    jeng.config = jeng.config.replace(chaos=JaxChaos(enabled=True, seed=3, faults=FAULTS))
    j = jeng.run()
    assert (j.windows, j.ranked, j.skipped) == (s.windows, s.ranked, s.skipped)

    def counts(reg):
        # The webhook queue's re-sends follow the wall clock: not compared.
        return {name: sorted((tuple(sorted(x["labels"].items())), x["value"])
                             for x in reg.get(name).samples()
                             if x["labels"].get("seam") != "webhook" or "kind" in x["labels"])
                for name in ("microrank_fault_injections_total",
                             "microrank_retry_attempts_total")}

    assert counts(registry) == counts(_jax_registry())
    assert registry.get("microrank_retry_attempts_total").value(seam="stream_dispatch") == 3
    assert registry.get("microrank_retry_attempts_total").value(seam="build") == 1
    from microrank_tpu_torch.obs.journal import read_journal

    seams = {e["seam"] for e in read_journal(tmp_path / "f" / "journal.jsonl")
             if e["event"] == "fault_injected"}
    assert seams == {e["seam"] for e in jax_read(tmp_path / "jax" / "journal.jsonl")
                     if e["event"] == "fault_injected"} == {
        "dispatch", "build", "fetch", "source_stall", "webhook"}


def test_exhausted_window_is_skipped_and_counted_not_ranked_elsewhere(tmp_path, registry,
                                                                      caplog):
    """Three failed attempts (STREAM_DISPATCH_POLICY's) of one window:
    the window is skipped (``rank_failed``), counted and logged at ERROR;
    nothing ranks it on another path, and the next window ranks."""
    cfg = _port_cfg({"seam": "dispatch", "kind": "fail", "count": 3}, pipeline_windows=1)
    cfg = cfg.replace(dispatch=DispatchConfig(warmup_manifest=False, coalesce_windows=1))
    with caplog.at_level(logging.ERROR, logger="microrank_tpu_torch.stream"):
        s = StreamEngine(cfg, _port_source(), out_dir=tmp_path).run()
    failed = [r for r in s.results if (r.skipped_reason or "").startswith("rank_failed")]
    assert len(failed) == 1 and failed[0].ranking == [] and failed[0].kernel is None
    assert s.skipped == 1 and s.ranked == 1
    assert registry.get("microrank_retry_exhausted_total").value(seam="stream_dispatch") == 1
    assert any("rank failed" in r.getMessage() for r in caplog.records)


# --------------------------------------------------------------- serve


def _serve_fixture():
    from microrank_tpu_torch.testing import generate_case
    from microrank_tpu_torch.testing.synthetic import spans_table

    case = generate_case(SyntheticConfig(n_operations=16, n_traces=80, seed=7))
    return (spans_table(case.normal, case.n_operations),
            spans_table(case.abnormal, case.n_operations))


def test_serve_dispatch_fault_retried_under_dispatch_policy(registry):
    """One injected ``serve_dispatch`` fault: the batch's second attempt
    (DISPATCH_POLICY) answers, undegraded, the same ranking as a clean
    service."""
    from microrank_tpu_torch.serve import RankRequest, ServeService

    normal, abnormal = _serve_fixture()

    def answer(faults):
        cfg = MicroRankConfig(serve=ServeConfig(warmup=False, max_wait_ms=0.0),
                              runtime=RuntimeConfig(device="cpu"),
                              chaos=ChaosConfig(enabled=bool(faults), faults=faults))
        svc = ServeService(cfg)
        svc.fit_baseline(normal)
        svc.add_dataset("d", abnormal)
        svc.start()
        try:
            return svc.submit(RankRequest(request_id="r", dataset="d")).result(120)
        finally:
            svc.shutdown()

    clean = answer(())
    got = answer(({"seam": "serve_dispatch", "kind": "fail", "count": 1},))
    assert got.ranking == clean.ranking and not got.degraded
    assert registry.get("microrank_retry_attempts_total").value(seam="serve_dispatch") == 1
    assert registry.get("microrank_fault_injections_total").value(
        seam="serve_dispatch", kind="fail") == 1
    assert DISPATCH_POLICY.max_attempts == 2


def test_serve_exhausted_batch_on_the_card_answers_500(registry, tmp_path):
    """Two ``serve_dispatch`` faults exhaust DISPATCH_POLICY: on a CUDA
    router (mocked) the batch fails (500), nothing is ranked on the host
    and nothing is counted degraded."""
    import torch

    from microrank_tpu_torch.obs.flight import FlightRecorder
    from microrank_tpu_torch.pipeline.results import WindowResult
    from microrank_tpu_torch.serve import RankRequest
    from microrank_tpu_torch.serve.batcher import MicroBatcher, PendingWindow

    class CardRouter:  # the batcher reads the device; the seam fails first
        device = torch.device("cuda")

    cfg = MicroRankConfig(serve=ServeConfig(warmup=False), runtime=RuntimeConfig(device="cpu"),
                          chaos=ChaosConfig(enabled=True, faults=(
                              {"seam": "serve_dispatch", "kind": "fail", "count": 2},)))
    configure_chaos(cfg)
    batcher = MicroBatcher(cfg, router=CardRouter(), flight=FlightRecorder(tmp_path, cfg.obs))
    pw = PendingWindow(request=RankRequest(request_id="card", spans=[{}]),
                       result=WindowResult(start="s", end="e", anomaly=True), table=None,
                       normal_ids=[], abnormal_ids=[], graph=None, op_names=[], kernel="kind",
                       future=Future(), enqueued=time.monotonic())
    batcher.dispatch([pw])
    with pytest.raises(InjectedFault):
        pw.future.result(timeout=0)
    assert not pw.result.degraded and pw.result.kernel != "numpy_ref"
    assert registry.get("microrank_serve_degraded_total").value() == 0
    assert registry.get("microrank_retry_exhausted_total").value(seam="serve_dispatch") == 1
