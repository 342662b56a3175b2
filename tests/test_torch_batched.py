"""Stacked windows (K18): ``parallel.stack_window_graphs``, the stacked
rank program and the window loop's micro-batched and two-phase lanes,
held to the JAX package on the CPU (where every kernel wrapper runs its
plain version, which repeats the kernel's order).

* the stack: the port's ``stack_window_graphs`` against JAX's on three
  windows of different trace counts, for the kind, packed, auto and
  pcsr builds: every field of equal dtype and equal values;
* the stacked program against JAX's ``rank_windows_batched_traced`` on
  the same stack, for kind (f32, bf16), pallas, packed and packed_bf16:
  identical ``n_valid`` and ``n_iters``, tie-aware top-k, scores rtol
  1e-5 (bf16 5e-3), residuals rtol 1e-4 / atol 1e-6;
* the stacked program against the port's per-window program on each
  window: bitwise (the only ops that could round otherwise are the two
  preference sums and the rescale's sum, taken over the padded axis:
  on these windows they do not);
* ``tol`` with windows that stop at different steps, a window with an
  empty normal partition, and the kernels that do not run stacked
  (packed_blocked, pcsr, int8), which raise;
* ``TableRCA.run`` with ``dispatch_batch_windows`` 2 and 4 (stream and
  bulk, async and sync) and ``batch_windows=True`` against JAX's same
  run (rankings, timings keys, journal keys) and against the port's
  per-window run (rankings, bitwise); ``cli run
  --dispatch-batch-windows`` against JAX's CLI.
"""

import dataclasses
import json

import numpy as np
import pytest

from conftest import partition_case
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.graph import build_window_graph
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import read_journal as jax_read_journal
from microrank_tpu.parallel import sharded_rank as jax_sharded
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu.testing import SyntheticConfig as JaxSynthetic
from microrank_tpu.testing import generate_case as jax_generate_case
from microrank_tpu_torch import cli, native
from microrank_tpu_torch.config import (
    IngestConfig,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.obs import JOURNAL_NAME, read_journal
from microrank_tpu_torch.parallel import (
    rank_windows_batched,
    rank_windows_batched_traced,
    stack_window_graphs,
)
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
)
from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

# Three windows of different trace counts (and so of different padded
# trace axes in the packed builds).
WINDOWS = ((80, 3), (120, 7), (200, 5))
# (kernel, kind_precision, build aux, collapse)
ROUTES = [
    ("kind", "f32", "kind", "on"),
    ("kind", "bf16", "kind", "on"),
    ("pallas", "f32", "auto", "off"),
    ("packed", "f32", "packed", "off"),
    ("packed_bf16", "f32", "packed", "off"),
]
ROUTE_IDS = [f"{k}-{p}" for k, p, _, _ in ROUTES]
BUILDS = [("kind", "on"), ("packed", "off"), ("auto", "on"), ("pcsr", "off")]


@pytest.fixture(scope="module")
def cases():
    return [
        jax_generate_case(JaxSynthetic(n_operations=24, n_traces=n, seed=s))
        for n, s in WINDOWS
    ]


def window_graphs(cases, aux, collapse, empty_normal=()):
    """Each case's window graph from the JAX package's build; windows in
    ``empty_normal`` with no normal trace."""
    out = []
    for i, case in enumerate(cases):
        nrm, abn = partition_case(case)
        if i in empty_normal:
            nrm = []
        graph, _, _, _ = build_window_graph(
            case.abnormal, nrm, abn, aux=aux, collapse=collapse
        )
        out.append(graph)
    return out


def rtol_of(kernel, precision):
    return 5e-3 if "bf16" in (kernel[-4:], precision) else 1e-5


def jax_batched(graphs, kernel, **pr):
    out = jax_sharded.rank_windows_batched_traced(
        jax_sharded.stack_window_graphs(graphs), JaxPageRank(**pr), JaxSpectrum(), kernel
    )
    return [np.asarray(a) for a in out]


def port_batched(graphs, kernel, **pr):
    return fetch_rank_outputs(rank_windows_batched_traced(
        stack_window_graphs(graphs), PageRankConfig(**pr), SpectrumConfig(), kernel,
        device="cpu",
    ))


def port_window(graph, kernel, **pr):
    dgraph = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    return fetch_rank_outputs(
        rank_window_traced_core(dgraph, PageRankConfig(**pr), SpectrumConfig(), kernel)
    )


def assert_rows_match(j, t, b, rtol):
    """Window b of two stacked programs' outputs."""
    n = int(t[2][b])
    assert (int(j[2][b]), int(j[4][b])) == (n, int(t[4][b]))
    ok, why = tie_aware_topk_agreement(
        list(j[0][b][:n]), list(j[1][b][:n]), list(t[0][b][:n]), list(t[1][b][:n]),
        k=n, rtol=rtol,
    )
    assert ok, f"window {b}: {why}"
    np.testing.assert_allclose(t[1][b][:n], j[1][b][:n], rtol=rtol)
    np.testing.assert_allclose(t[3][b], j[3][b], rtol=1e-4, atol=1e-6)


def assert_row_is_window(t, b, w):
    """Window b of a stacked program's outputs, bitwise the per-window
    program's ``w`` (top-k, scores, n_valid, residuals, n_iters)."""
    n = w[2]
    assert (int(t[2][b]), int(t[4][b])) == (n, w[4])
    np.testing.assert_array_equal(t[0][b][:n], w[0][:n])
    np.testing.assert_array_equal(t[1][b][:n], w[1][:n])
    np.testing.assert_array_equal(t[3][b], w[3])


@pytest.mark.parametrize("aux,collapse", BUILDS, ids=[a for a, _ in BUILDS])
def test_stack_matches_jax_field_by_field(cases, aux, collapse):
    graphs = window_graphs(cases, aux, collapse)
    if collapse == "off":  # padded trace axes of their own
        assert len({g.abnormal.kind.shape[0] for g in graphs}) > 1
    ours, theirs = stack_window_graphs(graphs), jax_sharded.stack_window_graphs(graphs)
    for part in ("normal", "abnormal"):
        for f in ours.normal._fields:
            a, b = getattr(getattr(ours, part), f), np.asarray(getattr(getattr(theirs, part), f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{f}")
        assert getattr(ours, part).n_traces.shape == (len(graphs),)


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_stacked_program_matches_jax_and_each_window(cases, kernel, precision, aux, collapse):
    graphs = window_graphs(cases, aux, collapse)
    j = jax_batched(graphs, kernel, kind_precision=precision)
    t = port_batched(graphs, kernel, kind_precision=precision)
    assert t[0].shape[0] == t[4].shape[0] == len(graphs)
    assert t[3].shape == (len(graphs), 2, PageRankConfig().iterations)
    for b, graph in enumerate(graphs):
        assert_rows_match(j, t, b, rtol_of(kernel, precision))
        assert_row_is_window(t, b, port_window(graph, kernel, kind_precision=precision))
    # rank_windows_batched is the traced program's first three outputs.
    short = rank_windows_batched(
        stack_window_graphs(graphs), PageRankConfig(kind_precision=precision),
        SpectrumConfig(), kernel, device="cpu",
    )
    assert len(short) == 3
    np.testing.assert_array_equal(short[0].numpy(), t[0])


def test_auto_resolves_the_stack_as_jax_does(cases):
    graphs = window_graphs(cases, "auto", "on")
    from microrank_tpu.rank_backends.jax_tpu import choose_kernel as jax_choose
    from microrank_tpu_torch.rank_backends.torch_cuda import choose_kernel

    stacked = stack_window_graphs(graphs)
    want = jax_choose(jax_sharded.stack_window_graphs(graphs))
    assert choose_kernel(stacked) == want
    t = port_batched(graphs, "auto")
    j = jax_batched(graphs, want)
    for b in range(len(graphs)):
        assert_rows_match(j, t, b, rtol_of(want, "f32"))


@pytest.mark.parametrize("kernel,aux,collapse", [
    ("kind", "kind", "on"), ("pallas", "auto", "off"), ("packed", "packed", "off"),
])
def test_tol_freezes_each_window_on_its_own_step(cases, kernel, aux, collapse):
    graphs = window_graphs(cases, aux, collapse)
    pr = dict(tol=2e-5, iterations=60)
    j = jax_batched(graphs, kernel, **pr)
    t = port_batched(graphs, kernel, **pr)
    n_iters = [int(n) for n in t[4]]
    assert len(set(n_iters)) > 1 and max(n_iters) < 60, n_iters
    for b, graph in enumerate(graphs):
        assert_rows_match(j, t, b, 1e-5)
        assert not t[3][b][:, n_iters[b]:].any()
        assert_row_is_window(t, b, port_window(graph, kernel, **pr))


@pytest.mark.parametrize("kernel,aux,collapse", [("kind", "kind", "on"), ("pallas", "auto", "off")])
def test_a_window_with_an_empty_normal_partition(cases, kernel, aux, collapse):
    graphs = window_graphs(cases, aux, collapse, empty_normal=(1,))
    t = port_batched(graphs, kernel)
    j = jax_batched(graphs, kernel)
    for b, graph in enumerate(graphs):
        w = port_window(graph, kernel)
        n = w[2]
        assert (int(t[2][b]), int(t[4][b])) == (n, w[4]) == (int(j[2][b]), int(j[4][b]))
        np.testing.assert_array_equal(t[0][b][:n], w[0][:n])
        np.testing.assert_array_equal(t[1][b][:n], w[1][:n])  # NaN where it is NaN
        np.testing.assert_array_equal(t[3][b], w[3])
        np.testing.assert_allclose(t[3][b], j[3][b], rtol=1e-4, atol=1e-6)
    assert np.isnan(t[3][1][0]).all()  # the empty partition's 0 / 0
    for b in (0, 2):
        assert_rows_match(j, t, b, 1e-5)


@pytest.mark.parametrize("kernel,aux,collapse,precision", [
    ("packed_blocked", "packed", "off", "f32"),
    ("pcsr", "pcsr", "off", "f32"),
    ("kind", "kind", "on", "int8"),
])
def test_kernels_that_do_not_run_stacked_raise(cases, kernel, aux, collapse, precision):
    stacked = stack_window_graphs(window_graphs(cases, aux, collapse))
    with pytest.raises(NotImplementedError, match="item 7"):
        rank_windows_batched_traced(
            stacked, PageRankConfig(kind_precision=precision), SpectrumConfig(), kernel,
            device="cpu",
        )


# ------------------------------------------------------------ the loop

TIMELINE = dict(n_operations=24, n_traces=120, n_kinds=24, child_keep_prob=0.6, seed=9)
# Six ranked windows, as the replay's six: at K = 4 a group of four and
# a final group of two.
N_WINDOWS, FAULTED = 10, [0, 1, 2, 4, 5, 6, 8, 9]
LOOP_VARIANTS = {
    "k2_stream": dict(dispatch_batch_windows=2),
    "k4_stream": dict(dispatch_batch_windows=4),
    "k2_bulk": dict(dispatch_batch_windows=2, fetch_mode="bulk", bulk_fetch_windows=3),
    "k4_bulk": dict(dispatch_batch_windows=4, fetch_mode="bulk"),
    "k2_sync": dict(dispatch_batch_windows=2, async_dispatch=False),
    "k4_bulk_sync": dict(dispatch_batch_windows=4, fetch_mode="bulk", async_dispatch=False),
}
SINK_KEYS = ("start", "anomaly", "skipped_reason", "ranking")


def port_config(**runtime):
    return MicroRankConfig(runtime=RuntimeConfig(**runtime), ingest=IngestConfig(enabled=False))


def jax_config(**runtime):
    from microrank_tpu.config import IngestConfig as JaxIngest

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
        (native.load_span_table(normal, cache=False), native.load_span_table(abnormal, cache=False)),
        (jax_load(normal, cache=False), jax_load(abnormal, cache=False)),
    )


def run_both(tables, root, batch_windows=False, **runtime):
    port = TableRCA(port_config(**runtime), device="cpu")
    port.fit_baseline(tables[0][0])
    jax_rca = JaxTableRCA(jax_config(**runtime))
    jax_rca.fit_baseline(tables[1][0])
    t = port.run(tables[0][1], out_dir=root / "torch", batch_windows=batch_windows)
    j = jax_rca.run(tables[1][1], out_dir=root / "jax", batch_windows=batch_windows)
    return t, j


def sink_records(out_dir):
    lines = (out_dir / "windows.jsonl").read_text().splitlines()
    return [{k: json.loads(ln).get(k) for k in SINK_KEYS} for ln in lines]


@pytest.fixture(scope="module")
def per_window_run(tables):
    rca = TableRCA(port_config(pipeline_depth=1, async_dispatch=False), device="cpu")
    rca.fit_baseline(tables[0][0])
    return rca.run(tables[0][1])


def assert_matches_jax(t, j, rtol=1e-5):
    assert [(r.start, r.anomaly, r.skipped_reason, r.kernel) for r in t] == [
        (r.start, r.anomaly, r.skipped_reason, r.kernel) for r in j
    ]
    for a, b in zip(t, j):
        assert a.rank_iterations == b.rank_iterations
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in b.ranking], [s for _, s in b.ranking],
            [n for n, _ in a.ranking], [s for _, s in a.ranking],
            k=len(b.ranking), rtol=rtol,
        )
        assert ok, f"{a.start}: {why}"
    assert [sorted(r.timings) for r in t] == [sorted(r.timings) for r in j]


def assert_journals_match(root):
    tj = read_journal(root / "torch" / JOURNAL_NAME)
    jj = jax_read_journal(root / "jax" / JOURNAL_NAME)
    assert [e["event"] for e in tj] == [e["event"] for e in jj]
    for a, b in zip(tj, jj):
        assert set(a) == set(b), a["event"]
        if a["event"] == "window":
            assert sorted(a["timings"]) == sorted(b["timings"])
    assert tj[0]["batch_windows"] == jj[0]["batch_windows"]


@pytest.mark.parametrize("variant", list(LOOP_VARIANTS))
def test_micro_batched_run_matches_jax_and_the_per_window_run(
    tables, per_window_run, tmp_path, variant
):
    t, j = run_both(tables, tmp_path, **LOOP_VARIANTS[variant])
    ranked = [r for r in t if r.ranking]
    assert len(ranked) == 6
    assert_matches_jax(t, j)
    assert [r.ranking for r in t] == [r.ranking for r in per_window_run]
    k = LOOP_VARIANTS[variant]["dispatch_batch_windows"]
    assert [r.timings["chunk_windows"] for r in ranked] == [
        min(k, 6 - k * (i // k)) for i in range(6)
    ]
    assert [r.queue_depth for r in t] == [r.queue_depth for r in j]
    assert [
        {k_: r[k_] for k_ in SINK_KEYS[:3]} for r in sink_records(tmp_path / "torch")
    ] == [{k_: r[k_] for k_ in SINK_KEYS[:3]} for r in sink_records(tmp_path / "jax")]
    assert_journals_match(tmp_path)
    assert not (tmp_path / "torch" / "cursor.json").exists()


@pytest.mark.parametrize("fetch", ["stream", "bulk"])
def test_batch_windows_run_matches_jax_and_the_per_window_run(
    tables, per_window_run, tmp_path, fetch
):
    # dispatch_batch_windows is ignored under batch_windows, as in JAX.
    t, j = run_both(tables, tmp_path, batch_windows=True, fetch_mode=fetch,
                    dispatch_batch_windows=3)
    assert_matches_jax(t, j)
    assert [r.ranking for r in t] == [r.ranking for r in per_window_run]
    ranked = [r for r in t if r.ranking]
    assert len(ranked) == 6
    assert all({"build", "rank_batched"} <= set(r.timings) for r in ranked)
    # Every window reaches the sink, in order, at the end of the run.
    recs = sink_records(tmp_path / "torch")
    assert [r["start"] for r in recs] == [r.start for r in t]
    assert_journals_match(tmp_path)
    assert not (tmp_path / "torch" / "cursor.json").exists()


def test_resumed_micro_batched_run_is_the_tail(tables, per_window_run, tmp_path):
    from microrank_tpu_torch.pipeline.checkpoint import WindowCursor

    ranked = [r for r in per_window_run if r.ranking]
    WindowCursor(tmp_path / "cursor.json").save(ranked[2].start)
    rca = TableRCA(port_config(dispatch_batch_windows=4), device="cpu")
    rca.fit_baseline(tables[0][0])
    tail = rca.run(tables[0][1], out_dir=tmp_path, resume=True)
    assert [r.start for r in tail] == [r.start for r in per_window_run[
        [r.start for r in per_window_run].index(ranked[2].start):]]
    assert [r.ranking for r in tail if r.ranking] == [r.ranking for r in ranked[2:]]


def test_cli_dispatch_batch_windows_flag_matches_jax(timeline, tmp_path, monkeypatch):
    import argparse
    import importlib

    from test_torch_cli_flags import assert_same_results, read_results

    # JAX builds its parser inside main(): record the flag's declaration
    # and stop at the handler.
    jax_cli = importlib.import_module("microrank_tpu.cli.main")
    declared = {}
    real_add = argparse._ActionsContainer.add_argument

    def add_argument(self, *names, **kw):
        action = real_add(self, *names, **kw)
        if "--dispatch-batch-windows" in names:
            declared["jax"] = action
        return action

    class Stop(Exception):
        pass

    def stop(args):
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse._ActionsContainer, "add_argument", add_argument)
        m.setattr(jax_cli, "cmd_run", stop)
        with pytest.raises(Stop):
            jax_cli.main(["run", "--normal", "n", "--abnormal", "a"])
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    ours = next(a for a in sub.choices["run"]._actions
                if "--dispatch-batch-windows" in a.option_strings)
    theirs = declared["jax"]
    assert (ours.option_strings, ours.dest, ours.default, ours.help) == (
        theirs.option_strings, theirs.dest, theirs.default, theirs.help
    )
    assert ours.type.__name__ == theirs.type.__name__ == "_positive_int"
    args = cli.build_parser().parse_args(
        ["run", "--normal", "n", "--abnormal", "a", "--dispatch-batch-windows", "3"]
    )
    assert cli._config_from_args(args).runtime.dispatch_batch_windows == 3
    assert RuntimeConfig().dispatch_batch_windows == JaxConfig().runtime.dispatch_batch_windows == 1

    _, normal, abnormal = timeline
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal), "--no-tuned-policy"]
    flags = ["--dispatch-batch-windows", "2"]
    assert cli.main(base + flags + ["--device", "cpu", "-o", str(tmp_path / "port")]) == 0
    assert jax_cli.main(base + flags + ["--engine", "native", "-o", str(tmp_path / "jax")]) == 0
    assert cli.main(base + ["--device", "cpu", "-o", str(tmp_path / "one")]) == 0
    assert_same_results(tmp_path / "port", tmp_path / "jax")
    rows = read_results(tmp_path / "port")[0]
    assert rows and rows == read_results(tmp_path / "one")[0]


def test_a_mixed_kernel_group_re_resolves_on_the_stack(tables, per_window_run):
    # Every second window claims packed_bf16 although its graph carries
    # the kind views: the group re-resolves on the stacked views (at the
    # dense budget shared by its windows), as JAX's _launch_chunk does,
    # and ranks with kind, bitwise the per-window run.
    rca = TableRCA(port_config(dispatch_batch_windows=2), device="cpu")
    rca.fit_baseline(tables[0][0])
    real = rca.prepare_rank
    calls, launched = [], []

    def prepare(*args):
        graph, names, kernel = real(*args)
        calls.append(kernel)
        return graph, names, "packed_bf16" if len(calls) % 2 == 0 else kernel

    def launch(graph, kernel, _real=rca.launch_program):
        launched.append(kernel)
        return _real(graph, kernel)

    rca.prepare_rank, rca.launch_program = prepare, launch
    res = rca.run(tables[0][1])
    assert set(calls) == {"kind"} and launched == ["kind"] * 3
    assert [r.ranking for r in res] == [r.ranking for r in per_window_run]
