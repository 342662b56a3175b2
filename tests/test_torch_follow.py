"""Follow mode (``pipeline/follow.py``) held to the JAX package's: the
counterparts of tests/test_follow.py's loop cases and tests/test_obs.py's
follow counters, each run by both packages over their own copy of the
same growing CSV (the port's timeline generator, held to JAX's in
tests/test_torch_run_loop.py), with admission on and the same windows:

* incremental ranking: each poll yields the windows that closed since
  the last, exactly once, the same windows as JAX's ``follow_table``
  with rankings tie-aware equal to JAX's (rtol 1e-5, kind f32) and
  bitwise the port's own batch run over the whole file;
* a restarted follower resumes from the cursor (``run_follow``);
* ``TailTracker``'s rules and byte cursor, output for output with JAX's;
* ``follow_table`` and the CLI's ``--follow`` need an output directory;
* parse failures count toward ``idle_exit``; a rotation is counted and
  re-read; the follow counters equal JAX's;
* ``run --follow`` end to end through both CLIs.
"""

import json
import os

import pytest

from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import WindowConfig as JaxWindow
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import registry as jax_registry
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu.pipeline import follow as jax_follow
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import MicroRankConfig, WindowConfig
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.pipeline import follow
from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline
from microrank_tpu_torch.testing.synthetic import write_spans_csv
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

TIMELINE = dict(n_operations=30, n_kinds=24, n_traces=90, child_keep_prob=0.6, seed=13)


@pytest.fixture(scope="module")
def timeline(tmp_path_factory):
    tl = generate_timeline(SyntheticConfig(**TIMELINE), 4, [0, 1, 2, 3])
    d = tmp_path_factory.mktemp("follow_tl")
    write_spans_csv(tl.normal, d / "normal.csv", tl.n_operations)
    return tl, d / "normal.csv"


@pytest.fixture
def registries():
    old_t, old_j = get_registry(), jax_registry.get_registry()
    t, j = MetricsRegistry(), jax_registry.MetricsRegistry()
    set_registry(t)
    jax_registry.set_registry(j)
    yield t, j
    set_registry(old_t)
    jax_registry.set_registry(old_j)


def write_windows(tl, path, ws, append=False):
    write_spans_csv([tl.windows[w] for w in ws], path, tl.n_operations, append=append)


def rcas(tl, normal):
    """A fitted follower of each package (windows of the timeline's
    length, no skip)."""
    win = dict(detect_minutes=tl.window_minutes, skip_minutes=0.0)
    t = TableRCA(MicroRankConfig(window=WindowConfig(**win)), device="cpu")
    t.fit_baseline(load_span_table(normal, cache=False))
    j = JaxTableRCA(JaxConfig(window=JaxWindow(**win)))
    j.fit_baseline(jax_load(normal, cache=False))
    return t, j


def assert_same_poll(ours, theirs):
    """One poll's window results: same windows, rankings tie-aware equal
    at the f32 kind tolerance with the same top-1."""
    assert [(r.start, bool(r.ranking)) for r in ours] == [
        (r.start, bool(r.ranking)) for r in theirs
    ]
    for t, j in zip(ours, theirs):
        if t.ranking:
            assert t.ranking[0][0] == j.ranking[0][0]
            ok, why = tie_aware_topk_agreement(
                [n for n, _ in j.ranking], [s for _, s in j.ranking],
                [n for n, _ in t.ranking], [s for _, s in t.ranking],
                k=len(j.ranking), rtol=1e-5,
            )
            assert ok, why


def test_follow_ranks_windows_incrementally(timeline, tmp_path):
    tl, normal = timeline
    rca, jrca = rcas(tl, normal)
    csvs = {p: tmp_path / f"{p}.csv" for p in ("port", "jax")}
    # Windows 0-2: only 0 and 1 have closed (the horizon, the newest span
    # start, lies inside window 2).
    for p in csvs.values():
        write_windows(tl, p, [0, 1, 2])
    polls = follow.follow_table(rca, csvs["port"], tmp_path / "out", poll_seconds=0.0,
                                idle_exit=1, sleep=lambda s: None)
    jpolls = jax_follow.follow_table(jrca, csvs["jax"], tmp_path / "jout", poll_seconds=0.0,
                                     idle_exit=1, sleep=lambda s: None)
    first, jfirst = next(polls), next(jpolls)
    assert sum(1 for r in first if r.ranking) == 2
    assert_same_poll(first, jfirst)
    # Window 3 arrives (appended): window 2 closes, and only it ranks.
    for p in csvs.values():
        write_windows(tl, p, [3], append=True)
    second, jsecond = next(polls), next(jpolls)
    starts2 = [r.start for r in second if r.ranking]
    assert len(starts2) == 1 and starts2[0] not in [r.start for r in first]
    assert_same_poll(second, jsecond)
    with pytest.raises(StopIteration):
        next(polls)
    with pytest.raises(StopIteration):
        next(jpolls)
    # The sink saw every ranked window once, in window order, the fault
    # first; the rankings are bitwise the port's batch run over the file.
    lines = [json.loads(ln) for ln in (tmp_path / "out" / "windows.jsonl").read_text().splitlines()]
    ranked = [ln for ln in lines if ln["ranking"]]
    assert [ln["start"] for ln in ranked] == [r.start for r in first + second if r.ranking]
    assert all(ln["ranking"][0][0] == tl.fault_pod_op for ln in ranked)
    batch, _ = rcas(tl, normal)
    whole = batch.run(load_span_table(csvs["port"], cache=False),
                      end_us=horizon_us(csvs["port"]), complete_only=True)
    assert [(r.start, r.ranking) for r in whole if r.ranking] == [
        (r.start, r.ranking) for r in first + second if r.ranking
    ]


def horizon_us(path):
    return int(load_span_table(path, cache=False).start_us.max())


def test_follow_restart_resumes_from_cursor(timeline, tmp_path):
    tl, normal = timeline
    csvs = {p: tmp_path / f"{p}.csv" for p in ("port", "jax")}
    for p in csvs.values():
        write_windows(tl, p, [0, 1, 2])
    rca, jrca = rcas(tl, normal)
    assert follow.run_follow(rca, csvs["port"], tmp_path / "out", poll_seconds=0.0,
                             max_polls=1) == 2
    assert jax_follow.run_follow(jrca, csvs["jax"], tmp_path / "jout", poll_seconds=0.0,
                                 max_polls=1) == 2
    # "Crash"; the file grows; a fresh process follows the same out dir.
    for p in csvs.values():
        write_windows(tl, p, [3], append=True)
    rca2, jrca2 = rcas(tl, normal)
    got = []
    assert follow.run_follow(rca2, csvs["port"], tmp_path / "out", poll_seconds=0.0,
                             max_polls=1, on_results=got.append) == 1
    jgot = []
    assert jax_follow.run_follow(jrca2, csvs["jax"], tmp_path / "jout", poll_seconds=0.0,
                                 max_polls=1, on_results=jgot.append) == 1
    assert_same_poll(got[0], jgot[0])
    ranked = [json.loads(ln)["start"] for ln in
              (tmp_path / "out" / "windows.jsonl").read_text().splitlines()
              if json.loads(ln)["ranking"]]
    assert len(ranked) == 3 and ranked == sorted(ranked)


def test_tail_tracker_incremental_read(tmp_path, registries):
    header = b"a,b\n"

    def append(data):
        def step(p):
            with open(p, "ab") as f:
                f.write(data)
        return step

    steps = [
        lambda p: p.write_bytes(header + b"1,2\n3,4\n"),
        append(b"5,6\n7,8\n9,"),                      # a torn third row
        append(b""),                                    # nothing new
        append(b"10\n"),                                # the torn row completes
        lambda p: p.write_bytes(header + b"x,y\n"),     # rotation: smaller file
    ]
    outs = []
    for mod, name in ((follow, "port"), (jax_follow, "jax")):
        path = tmp_path / f"{name}.csv"
        tr = mod.TailTracker()
        trace = []
        for step in steps:
            step(path)
            size = os.path.getsize(path)
            status = tr.observe_size(size)
            got = tr.read_appended(path, size)
            trace.append((status, tr.rotated, got))
            if got is not None:
                tr.parsed(size, offset=got[1])
        outs.append(trace)
    assert outs[0] == outs[1]
    port = outs[0]
    assert port[0][2] == (header + b"1,2\n3,4\n", len(header) + 8)
    assert port[1][2][0] == header + b"5,6\n7,8\n"
    assert port[2][0] == "idle" and port[2][2] is None
    assert port[3][2][0] == header + b"9,10\n"
    assert port[4][:2] == ("grew", True) and port[4][2][0] == header + b"x,y\n"
    rot = registries[0].get("microrank_follow_rotations_total").value()
    assert rot == registries[1].get("microrank_follow_rotations_total").value() == 1


def test_follow_requires_out_dir(timeline, tmp_path):
    tl, normal = timeline
    csv = tmp_path / "stream.csv"
    write_windows(tl, csv, [0])
    rca, _ = rcas(tl, normal)
    with pytest.raises(ValueError, match="out_dir"):
        next(follow.follow_table(rca, csv, None, poll_seconds=0.0))


def test_follow_cli_requires_output(timeline, tmp_path):
    tl, normal = timeline
    csv = tmp_path / "stream.csv"
    write_windows(tl, csv, [0, 1])
    assert cli.main(["run", "--normal", str(normal), "--abnormal", str(csv), "-o", "",
                     "--follow", "--poll-seconds", "0", "--follow-idle-exit", "1",
                     "--device", "cpu"]) == 2


def test_follow_parse_failures_count_toward_idle_exit(timeline, tmp_path, registries):
    tl, normal = timeline
    rca, jrca = rcas(tl, normal)
    for mod, r, name in ((follow, rca, "port"), (jax_follow, jrca, "jax")):
        csv = tmp_path / f"{name}.csv"
        csv.write_text("totally,not\na traces file\n")
        sizes = iter([10, 20, 30, 40, 50])

        def grow(_, csv=csv, sizes=sizes):
            # Grow the (still unparseable) file every poll, so that only
            # the parse-failure path can count toward idle_exit.
            csv.write_text("garbage," * next(sizes) + "\n")

        polls = mod.follow_table(r, csv, tmp_path / f"{name}_out", poll_seconds=0.0,
                                 idle_exit=3, sleep=grow)
        with pytest.raises(StopIteration):
            next(polls)
    ours = registries[0].get("microrank_follow_parse_failures_total").value()
    assert ours >= 3
    assert ours == registries[1].get("microrank_follow_parse_failures_total").value()
    assert registries[0].get("microrank_follow_polls_total").value() == (
        registries[1].get("microrank_follow_polls_total").value()
    )


def test_follow_detects_rotation(timeline, tmp_path, registries):
    tl, normal = timeline
    rca, jrca = rcas(tl, normal)
    results = []
    for mod, r, name in ((follow, rca, "port"), (jax_follow, jrca, "jax")):
        csv = tmp_path / f"{name}.csv"
        write_windows(tl, csv, [0, 1, 2])
        polls = mod.follow_table(r, csv, tmp_path / f"{name}_out", poll_seconds=0.0,
                                 idle_exit=2, sleep=lambda s: None)
        first = next(polls)
        assert sum(1 for x in first if x.ranking) == 2  # windows 0 and 1 closed
        # Rotate: the collector replaced the file with a shorter one.
        write_windows(tl, csv, [0])
        second = next(polls)
        assert sum(1 for x in second if x.ranking) == 0  # the cursor is past it
        with pytest.raises(StopIteration):
            next(polls)
        results.append((first, second))
    assert_same_poll(results[0][0], results[1][0])
    for reg in registries:
        assert reg.get("microrank_follow_rotations_total").value() == 1


def test_follow_cli_flag_matches_jax(timeline, tmp_path):
    from microrank_tpu.cli.main import main as jax_main

    tl, normal = timeline
    runs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_main, ["--engine", "native"])):
        csv = tmp_path / f"{name}.csv"
        write_windows(tl, csv, [0, 1, 2, 3])
        out = tmp_path / f"{name}_out"
        assert main(["run", "--normal", str(normal), "--abnormal", str(csv), "-o", str(out),
                     "--follow", "--poll-seconds", "0", "--follow-idle-exit", "1",
                     "--follow-grace-seconds", "0"] + extra) == 0
        runs[name] = [json.loads(ln) for ln in (out / "windows.jsonl").read_text().splitlines()]
        assert (out / "cursor.json").exists() and (out / "metrics.json").exists()
    assert [(r["start"], bool(r["ranking"])) for r in runs["port"]] == [
        (r["start"], bool(r["ranking"])) for r in runs["jax"]
    ]
    assert any(r["ranking"] for r in runs["port"])
    for t, j in zip(runs["port"], runs["jax"]):
        if t["ranking"]:
            assert t["ranking"][0][0] == j["ranking"][0][0] == tl.fault_pod_op
