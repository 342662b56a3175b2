"""The csr, coo and dense kernel families (K10-K12) on ``cli run``'s
path, held to the JAX package on the CPU (where every wrapper runs its
plain version, which repeats its kernel's order of sums):

* the native build's CSR views (aux "csr" and "all") bitwise JAX's
  native build on the same table; "auto_all" (the mesh's) still raises;
* each route through the port against JAX's
  ``rank_window_traced_core(..., kernel)`` on the same graph
  (``graph_from_numpy``), collapsed and not: tie-aware top-k, ``n_valid``
  and ``n_iters`` equal, scores rtol 1e-5 (dense_bf16 5e-3), residuals
  rtol 1e-4 / atol 1e-6. For csr, JAX's compensated prefix sums leave
  its residuals up to 5.1e-6 from JAX's own coo residuals on these
  windows (its scores within 6e-7), while the port's csr is bitwise its
  coo: the port's csr residuals are held to JAX's coo residuals at rtol
  1e-4 / atol 1e-6, and to JAX's csr residuals at atol 1e-5;
* csr and coo bitwise the pallas route, products and rankings: every
  CSR row holds the pallas row's entries in its order;
* ``choose_kernel`` falls back to csr / coo where JAX's does; the host
  counts of csr equal the ones its layouts read on the device;
* stacked groups: bitwise each window's own program on every new route,
  and against JAX's ``rank_windows_batched_traced``;
* the lane (``run_rca_native``, and ``dispatch_batch_windows``) with
  ``kernel`` csr, coo, dense, dense_bf16 against JAX's lane; a tuned
  policy naming each kernel applies as in JAX; ``cli run --kernel``
  takes JAX's eleven choices.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import partition_case
from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.graph import build_window_graph
from microrank_tpu.graph import table_ops as jax_table_ops
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.parallel import sharded_rank as jax_sharded
from microrank_tpu.pipeline import run_rca_native as jax_run
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import (
    KERNELS,
    DetectorConfig,
    IngestConfig,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.graph import table_ops
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.parallel import rank_windows_batched_traced, stack_window_graphs
from microrank_tpu_torch.pipeline import run_rca_native
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    choose_kernel,
    csr_layouts,
    device_subset,
    fetch_rank_outputs,
    host_counts,
    host_subset,
    rank_window_traced_core,
    spmv_layouts,
    window_spmv_group,
)
from microrank_tpu_torch.scenarios import policy
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

FAMILIES = ("csr", "coo", "dense", "dense_bf16")
AUX = {"csr": "csr", "coo": "none", "dense": "none", "dense_bf16": "none"}
SYNTH = dict(n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5)


def rtol_of(kernel):
    return 5e-3 if kernel == "dense_bf16" else 1e-5


def jax_outputs(graph, kernel, pr=None):
    out = jax_tpu.rank_window_traced_device(
        jax.tree.map(jnp.asarray, graph), JaxPageRank(**(pr or {})), JaxSpectrum(), None, kernel)
    return [np.asarray(a) for a in out]


def port_outputs(graph, kernel, pr=None):
    dg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    return fetch_rank_outputs(
        rank_window_traced_core(dg, PageRankConfig(**(pr or {})), SpectrumConfig(), kernel))


def assert_ranking_parity(j, t, rtol):
    n = t[2]
    assert int(j[2]) == n and int(j[4]) == t[4]
    ok, why = tie_aware_topk_agreement(list(j[0][:n]), list(j[1][:n]), list(t[0][:n]),
                                       list(t[1][:n]), k=n, rtol=rtol)
    assert ok, why
    np.testing.assert_allclose(t[1][:n], j[1][:n], rtol=rtol)


def assert_trace_parity(j, t, kernel):
    """n_iters equal and the residual trace JAX's: csr at atol 1e-5 (JAX's
    compensated prefix sums, above), every other family at 1e-6; nothing
    written past the stop."""
    assert int(j[4]) == t[4]
    np.testing.assert_allclose(t[3], j[3], rtol=1e-4, atol=1e-5 if kernel == "csr" else 1e-6)
    assert np.all(t[3][:, t[4]:] == 0)


def bitwise(a, b):
    """Fetched outputs equal bit for bit (a scalar by value: one window's
    comes out an int, a group's as an element of its int32 array)."""
    return len(a) == len(b) and all(
        int(x) == int(y) if np.ndim(x) == 0 else
        (np.shape(x) == np.shape(y) and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for x, y in zip(a, b))


@pytest.fixture(scope="module")
def synth_csvs(tmp_path_factory):
    case = generate_case(SyntheticConfig(**SYNTH))
    return (case, *case.write_csvs(tmp_path_factory.mktemp("families")))


def window_of(synth_csvs):
    _, normal, abnormal = synth_csvs
    tab = load_span_table(abnormal, cache=False)
    tv, tb = table_ops.compute_slo_from_table(load_span_table(normal, cache=False))
    w0 = int(tab.start_us.min())
    mask, nrm, abn, _, rng = table_ops.detect_window_partition(
        tab, w0, w0 + 300_000_000, tv, tb, DetectorConfig(), with_range=True)
    return tab, jax_load(abnormal, cache=False), mask, nrm, abn, rng


@pytest.mark.parametrize("aux", ["csr", "all"])
@pytest.mark.parametrize("collapse", ["off", "on"])
def test_native_csr_views_are_jaxs(synth_csvs, aux, collapse):
    tab, jtab, mask, nrm, abn, rng = window_of(synth_csvs)
    tg = table_ops.build_window_graph_from_table(tab, mask, nrm, abn, aux=aux,
                                                 collapse=collapse, row_range=rng)[0]
    jg = jax_table_ops.build_window_graph_from_table(jtab, mask, nrm, abn, aux=aux,
                                                     collapse=collapse, row_range=rng)[0]
    for jp, tp in ((jg.normal, tg.normal), (jg.abnormal, tg.abnormal)):
        for f in tp._fields:
            a, b = np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert a.tobytes() == b.tobytes(), f
        assert tp.inc_indptr_op.shape[0] == tp.cov_unique.shape[0] + 1
        assert tp.inc_indptr_trace.shape[0] == tp.kind.shape[0] + 1
        assert (tp.pc_trace.shape[-1] > 0) == (tp.cov_bits.shape[1] > 0) == (aux == "all")


def test_the_mesh_aux_mode_still_raises(synth_csvs):
    tab, *_ = window_of(synth_csvs)
    for collapse in ("off", "auto"):
        with pytest.raises(NotImplementedError, match="item 12"):
            table_ops.build_window_graph_from_table(tab, None, [0], [1], aux="auto_all",
                                                    collapse=collapse)


@pytest.mark.parametrize("kernel", FAMILIES)
@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_route_matches_jax(request, case_name, collapse, kernel):
    case = request.getfixturevalue(case_name)
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=AUX[kernel],
                                            collapse=collapse)
    t = port_outputs(graph, kernel)
    j = jax_outputs(graph, kernel)
    assert_ranking_parity(j, t, rtol_of(kernel))
    if kernel == "csr":
        # JAX's csr residuals carry its prefix sums' rounding; its coo's
        # are the same function summed per row, as the port's csr is.
        np.testing.assert_allclose(t[3], jax_outputs(graph, "coo")[3], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(t[3], j[3], rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(t[3], j[3], rtol=1e-4, atol=1e-6)
    assert np.all(t[3][:, t[4]:] == 0)
    assert names[t[0][0]] == case.fault_pod_op


@pytest.mark.parametrize("kernel", FAMILIES)
def test_route_with_tol_matches_jax(small_case, kernel):
    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, aux=AUX[kernel])
    pr = dict(tol=1e-4, iterations=60)
    t, j = port_outputs(graph, kernel, pr), jax_outputs(graph, kernel, pr)
    assert 0 < t[4] < 60
    assert_ranking_parity(j, t, rtol_of(kernel))
    assert_trace_parity(j, t, kernel)


@pytest.mark.parametrize("kernel", FAMILIES)
def test_route_with_tol_near_its_stop_matches_jax(pod_case, kernel):
    """A second window, under a tol its residuals cross late (2e-6 at
    step 16, 1e-6 above the float32 floor): the step where the
    iteration stops, and the trace up to it, are JAX's. csr's are JAX's
    coo's: JAX's csr trace carries its prefix sums' rounding (up to
    5.1e-6, a bump above this tol at step 15), so JAX's csr stops at 18
    here where its coo, and the port's csr and coo, stop at 16
    (ROADMAP.md, Faults). dense_bf16's residuals floor at 5.4e-4 (bf16
    operands): its tol is 1e-3, crossed at step 9."""
    nrm, abn = partition_case(pod_case)
    graph, _, _, _ = build_window_graph(pod_case.abnormal, nrm, abn, aux=AUX[kernel])
    pr = dict(tol=1e-3 if kernel == "dense_bf16" else 2e-6, iterations=60)
    t = port_outputs(graph, kernel, pr)
    j = jax_outputs(graph, "coo" if kernel == "csr" else kernel, pr)
    assert 8 <= t[4] < 60
    assert_ranking_parity(j, t, rtol_of(kernel))
    assert_trace_parity(j, t, kernel)
    if kernel == "csr":
        j_csr = jax_outputs(graph, "csr", pr)
        np.testing.assert_allclose(t[3][:, :t[4]], j_csr[3][:, :t[4]], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_csr_and_coo_are_bitwise_pallas(request, case_name, collapse):
    case = request.getfixturevalue(case_name)
    nrm, abn = partition_case(case)
    graph, _, _, _ = build_window_graph(case.abnormal, nrm, abn, aux="csr", collapse=collapse)
    pallas = port_outputs(graph, "pallas")
    for kernel in ("csr", "coo"):
        assert bitwise(port_outputs(graph, kernel), pallas), kernel
    # Every CSR row holds the pallas row's entries, in its order.
    tg = graph_from_numpy(graph, "cpu")
    for g in (tg.normal, tg.abnormal):
        for c, p in zip(csr_layouts(g), spmv_layouts(g)):
            assert c.n_rows == p.n_rows
            np.testing.assert_array_equal(c.indptr.numpy(), p.indptr.numpy())
            live = int(c.indptr[-1])
            np.testing.assert_array_equal(c.cols[:live].numpy(), p.cols[:live].numpy())
            assert c.vals[:live].numpy().tobytes() == p.vals[:live].numpy().tobytes()


def test_csr_host_counts_are_the_device_layouts(small_case):
    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, aux="csr")
    host = host_subset(graph, "csr")
    counts = host_counts(host, "csr")
    dg = graph_from_numpy(host, "cpu")
    synced = window_spmv_group(dg, csr_layouts)
    trusted = window_spmv_group(dg, csr_layouts, counts)
    assert (counts.n_items, counts.max_chunks) == (synced.items.shape[0], synced.max_chunks)
    assert np.array_equal(synced.items.numpy(), trusted.items.numpy())
    # A column outside its x raises on the host, as the device check does.
    bad = host._replace(normal=host.normal._replace(
        inc_trace_opmajor=np.where(np.arange(host.normal.inc_trace_opmajor.size) == 0,
                                   10_000, host.normal.inc_trace_opmajor).astype(np.int32)))
    with pytest.raises(IndexError, match="outside"):
        host_counts(bad, "csr")
    with pytest.raises(IndexError, match="outside"):
        window_spmv_group(graph_from_numpy(bad, "cpu"), csr_layouts)


def test_csr_without_its_views_raises_as_jax(small_case):
    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn)
    with pytest.raises(ValueError, match="CSR views"):
        jax_outputs(graph, "csr")
    with pytest.raises(ValueError, match="CSR views"):
        port_outputs(graph, "csr")
    with pytest.raises(ValueError, match="CSR views"):
        host_counts(graph, "csr")


def test_choose_kernel_falls_back_like_jax(small_case):
    nrm, abn = partition_case(small_case)
    for aux, want in (("csr", "csr"), ("none", "coo"), ("all", "packed_bf16")):
        graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, aux=aux)
        assert jax_tpu.choose_kernel(graph, None, True) == want
        assert choose_kernel(graph, None, True) == want
        assert choose_kernel(graph_from_numpy(graph, "cpu"), None, True) == want
    # A group whose windows were built with different views: coo.
    a, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, aux="csr")
    b, _, _, _ = build_window_graph(small_case.abnormal, nrm[:-5], abn, aux="none")
    stacked = stack_window_graphs([a, b])
    assert jax_tpu.choose_kernel(jax_sharded.stack_window_graphs([a, b])) == "coo"
    assert choose_kernel(stacked) == "coo"


def three_windows(case, kernel, collapse="off"):
    nrm, abn = partition_case(case)
    graphs = []
    for drop in (0, 11, 29):
        g, _, _, _ = build_window_graph(case.abnormal, nrm[drop:], abn, aux=AUX[kernel],
                                        collapse=collapse)
        graphs.append(g)
    return graphs


@pytest.mark.parametrize("kernel", FAMILIES)
@pytest.mark.parametrize("collapse", ["off", "on"])
def test_stacked_group_is_bitwise_each_windows_own(small_case, kernel, collapse):
    graphs = three_windows(small_case, kernel, collapse)
    assert len({g.normal.kind.shape[0] for g in graphs}) > 1 or collapse == "on"
    stacked = stack_window_graphs([host_subset(g, kernel) for g in graphs])
    got = rank_windows_batched_traced(stacked, kernel=kernel, device="cpu")
    got = fetch_rank_outputs(got)
    for b, g in enumerate(graphs):
        own = port_outputs(g, kernel)
        assert bitwise([x[b] for x in got], own), b
    j = jax_sharded.rank_windows_batched_traced(
        jax.tree.map(jnp.asarray, jax_sharded.stack_window_graphs(graphs)),
        JaxPageRank(), JaxSpectrum(), kernel)
    j = [np.asarray(a) for a in j]
    for b in range(3):
        jb, tb = [x[b] for x in j], [x[b] for x in got]
        assert_ranking_parity(jb, tb, rtol_of(kernel))


def lane_configs(kernel, collapse, **runtime):
    return (
        JaxConfig(runtime=JaxRuntime(kernel=kernel, collapse_kinds=collapse,
                                     tuned_policy="off", **runtime),
                  ingest=JaxIngest(enabled=False)),
        MicroRankConfig(runtime=RuntimeConfig(kernel=kernel, collapse_kinds=collapse,
                                              tuned_policy="off", **runtime),
                        ingest=IngestConfig(enabled=False)),
    )


def assert_same_lane(jres, tres, kernel):
    assert [r.kernel for r in jres] == [r.kernel for r in tres]
    assert any(r.ranking for r in tres)
    for j, t in zip(jres, tres):
        assert (j.start, j.anomaly, j.n_normal, j.n_abnormal, j.rank_iterations) == (
            t.start, t.anomaly, t.n_normal, t.n_abnormal, t.rank_iterations)
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=rtol_of(kernel))
        assert ok, f"{t.start}: {why}"


@pytest.mark.parametrize("kernel", FAMILIES)
@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_lane_matches_jax(synth_csvs, kernel, collapse):
    case, normal, abnormal = synth_csvs
    jcfg, tcfg = lane_configs(kernel, collapse)
    tres = run_rca_native(normal, abnormal, tcfg, device="cpu")
    assert {r.kernel for r in tres if r.ranking} == {kernel}
    assert_same_lane(jax_run(normal, abnormal, jcfg), tres, kernel)
    assert next(r for r in tres if r.ranking).ranking[0][0] == case.fault_pod_op
    # Groups of two windows (one stacked program each) rank bitwise the
    # per-window run.
    _, grouped = lane_configs(kernel, collapse, dispatch_batch_windows=2)
    gres = run_rca_native(normal, abnormal, grouped, device="cpu")
    assert [(r.ranking, r.rank_iterations) for r in gres] == [
        (r.ranking, r.rank_iterations) for r in tres]


def test_tuned_policy_names_each_family(tmp_path, monkeypatch):
    import json

    from microrank_tpu.scenarios import policy as jax_policy

    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(tmp_path))
    counts = (4000, 30, None)  # the table lane's profile: spans, ops, dedup unknown
    key = policy.profile_from_counts(*counts).key()

    def write(kernel):
        (tmp_path / policy.POLICY_NAME).write_text(json.dumps({
            "version": policy.POLICY_VERSION, "profile_schema": policy.PROFILE_SCHEMA,
            "profiles": {key: {"method": "ochiai", "kernel": kernel}},
        }))

    for kernel in FAMILIES:
        write(kernel)
        jcfg, jres = jax_policy.apply_tuned_policy(JaxConfig(), lane="table", counts=counts)
        cfg, res = policy.apply_tuned_policy(MicroRankConfig(), lane="table", counts=counts)
        assert res.outcome == jres.outcome == "applied"
        assert cfg.runtime.kernel == jcfg.runtime.kernel == kernel
        assert cfg.spectrum.method == jcfg.spectrum.method == "ochiai"
    write("bogus")
    with pytest.raises(ValueError, match="unknown"):
        policy.apply_tuned_policy(MicroRankConfig(), lane="table", counts=counts)


@pytest.fixture
def jax_parse(monkeypatch):
    import importlib

    jax_cli = importlib.import_module("microrank_tpu.cli.main")
    seen = {}

    class Stop(Exception):
        pass

    def grab(args):
        seen["args"] = args
        raise Stop

    monkeypatch.setattr(jax_cli, "cmd_run", grab)

    def parse(argv):
        with pytest.raises(Stop):
            jax_cli.main(argv)
        return seen["args"]

    return parse


def test_cli_kernel_and_device_checks_parse_as_jax(jax_parse):
    base = ["run", "--normal", "n.csv", "--abnormal", "a.csv"]
    port_run = next(a for a in cli.build_parser()._actions
                    if isinstance(a, argparse._SubParsersAction)).choices["run"]
    kernel_action = next(a for a in port_run._actions if a.dest == "kernel")
    assert list(kernel_action.choices) == list(KERNELS) and len(KERNELS) == 11
    for kernel in KERNELS:
        for extra in ([], ["--device-checks"]):
            argv = base + ["--kernel", kernel, *extra]
            ours, theirs = cli.build_parser().parse_args(argv), jax_parse(argv)
            assert (ours.kernel, ours.device_checks) == (theirs.kernel, theirs.device_checks)
            cfg = cli._config_from_args(ours)
            assert (cfg.runtime.kernel, cfg.runtime.device_checks) == (kernel, bool(extra))
    for parse in (cli.build_parser().parse_args, jax_parse):
        with pytest.raises(SystemExit) as err:
            parse(base + ["--kernel", "sparse"])
        assert err.value.code == 2
    assert RuntimeConfig().device_checks is JaxRuntime().device_checks is False
    with pytest.raises(ValueError, match="unknown kernel"):
        RuntimeConfig(kernel="sparse")
