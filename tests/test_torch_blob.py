"""Blob staging (``rank_backends.blob``), the port's default staging,
held to the JAX package on the CPU:

* the round trip: ``pack_graph_blob`` then ``unpack_graph_blob`` give
  back every leaf's bytes, shape and dtype, on ``host_subset`` graphs of
  every route, at ``pad_policy="exact"`` (odd byte counts), with the
  stripped 0-width fields and the 0-d extents, and on a stacked group;
  every leaf at a 256-byte offset of the buffer;
* JAX's own blob: the port's decode of JAX's ``pack_graph_blob`` buffer,
  read with JAX's layout, is bitwise JAX's jitted ``unpack_graph_blob``
  (tests/test_blob.py's cases);
* the host counts: ``ss_host_counts`` equals the counts ``spmv_group``
  reads back from the device, the layouts built with them are bitwise
  those built without, and a column (or row) out of range still raises;
  ``host_counts`` on pcsr and pallas (windows and stacked groups) equals
  what their layouts read back (the work list's counts, pcsr's live
  forward and ELL entries), the groups built with them are bitwise those
  built without, and each bad view, row or column raises the same error
  from the host;
* ``TableRCA.run`` with blob staging ranks bitwise as with
  ``blob_staging=False`` on every route and in the chunked and batch
  modes, one blob transfer a program in the metrics; the port's default
  run agrees with JAX's default (blob) run tie-aware (f32 rtol 1e-5,
  int8 top-5 at 5e-2), indices and n_valid identical;
* ``cli run --no-blob-staging``: the same ``result.csv`` as JAX's CLI
  with the same flag and as the port's run without it.
"""

import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import partition_case
from microrank_tpu.cli.main import main as jax_main
from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.graph import build_window_graph
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu.rank_backends import blob as jax_blob
from microrank_tpu.rank_backends.jax_tpu import device_subset as jax_device_subset
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import (
    IngestConfig,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.graph.structures import PartitionGraph
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.obs.metrics import staged_bytes, staging_transfers
from microrank_tpu_torch.ops import spmv
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.rank_backends import blob
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    PcsrCounts,
    device_subset,
    fetch_rank_outputs,
    host_counts,
    host_subset,
    rank_window_traced_core,
    ss_host_counts,
)
from microrank_tpu_torch.testing import SyntheticConfig, generate_timeline
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

# (kernel, build aux, collapse): every route the port has.
ROUTES = [
    ("kind", "kind", "on"),
    ("packed", "packed", "off"),
    ("packed_bf16", "packed", "off"),
    ("packed_blocked", "packed", "off"),
    ("pcsr", "pcsr", "off"),
    ("pallas", "auto", "off"),
]
ROUTE_IDS = [k for k, _, _ in ROUTES]
PATTERN_ROUTES = [r for r in ROUTES if r[0] not in ("pcsr", "pallas")]
TIMELINE = dict(n_operations=24, n_traces=120, n_kinds=24, child_keep_prob=0.6, seed=9)
N_WINDOWS, FAULTED = 5, [0, 1, 3]


def jax_graph(case, aux, collapse, **kw):
    nrm, abn = partition_case(case)
    graph, _, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse, **kw)
    return graph


def leaf_bytes(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(np.atleast_1d(a)).view(np.uint8)


def assert_leaves_equal(host, decoded, fields=PartitionGraph._fields):
    for name in ("normal", "abnormal"):
        src, dst = getattr(host, name), getattr(decoded, name)
        for f in fields:
            a, b = np.asarray(getattr(src, f)), getattr(dst, f)
            assert tuple(b.shape) == a.shape, f"{name}.{f} shape"
            assert b.dtype == torch.from_numpy(np.zeros(1, a.dtype)).dtype, f"{name}.{f} dtype"
            np.testing.assert_array_equal(leaf_bytes(a), leaf_bytes(b), err_msg=f"{name}.{f}")


def assert_aligned(buf, layout, graph):
    """Every leaf a view of the one buffer, at a 256-byte offset."""
    for entries, part in zip(layout, (graph.normal, graph.abnormal)):
        for f, _, _, off, _ in entries:
            assert (off * 4) % blob.ALIGN_BYTES == 0, f
            leaf = getattr(part, f)
            assert leaf.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr(), f
            assert leaf.storage_offset() * leaf.element_size() == off * 4, f


@pytest.mark.parametrize("pad_policy", ["pow2q", "exact"])
@pytest.mark.parametrize("kernel,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_roundtrip_is_bitwise_and_aligned(small_case, kernel, aux, collapse, pad_policy):
    host = host_subset(jax_graph(small_case, aux, collapse, pad_policy=pad_policy), kernel)
    buf, layout = blob.pack_graph_blob(host)
    assert buf.dtype == torch.uint8 and buf.dim() == 1 and not buf.is_pinned()
    out = blob.unpack_graph_blob(buf, layout)
    assert_leaves_equal(host, out)
    assert_aligned(buf, layout, out)
    # The stripped fields come back 0-width, the extents 0-d.
    stripped = [f for f in PartitionGraph._fields if getattr(host.normal, f).size == 0]
    if kernel != "pallas":
        assert stripped
    for f in stripped:
        assert getattr(out.normal, f).shape == getattr(host.normal, f).shape
    for f in ("n_ops", "n_traces", "n_inc", "n_ss", "n_cols"):
        assert getattr(out.abnormal, f).shape == ()
        assert int(getattr(out.abnormal, f)) == int(getattr(host.abnormal, f))
    # Every byte outside the leaves is zero.
    outside = np.ones(buf.numel(), bool)
    for entries in layout:
        for f, dtype, shape, off, _ in entries:
            outside[off * 4: off * 4 + int(np.prod(shape)) * np.dtype(dtype).itemsize] = False
    assert not buf.numpy()[outside].any()


@pytest.mark.parametrize("kernel,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_stacked_group_roundtrip(small_case, pod_case, kernel, aux, collapse):
    graphs = [host_subset(jax_graph(c, aux, collapse), kernel) for c in (small_case, pod_case)]
    stacked = stack_window_graphs(graphs)
    buf, layout = blob.pack_graph_blob(stacked)
    out = blob.unpack_graph_blob(buf, layout)
    assert_leaves_equal(stacked, out)
    assert_aligned(buf, layout, out)
    assert out.normal.n_ops.shape == (2,)


@pytest.mark.parametrize("stripped,pad_policy", [(False, "pow2q"), (True, "pow2q"),
                                                 (False, "exact")])
def test_jax_blob_decodes_bitwise(small_case, stripped, pad_policy):
    graph = jax_graph(small_case, "auto", "auto", pad_policy=pad_policy)
    if stripped:
        graph = jax_device_subset(graph, "packed")
    jblob, layout = jax_blob.pack_graph_blob(graph)
    ref = jax.jit(jax_blob.unpack_graph_blob, static_argnums=1)(jblob, layout)
    ours = blob.unpack_leaves(torch.from_numpy(jblob.view(np.uint8)), layout)
    for leaves, part in zip(ours, (ref.normal, ref.abnormal)):
        assert list(leaves) == list(part._fields)
        for f, a in zip(part._fields, part):
            a = np.asarray(a)
            assert tuple(leaves[f].shape) == a.shape and str(leaves[f].dtype) == f"torch.{a.dtype}"
            np.testing.assert_array_equal(leaf_bytes(a), leaf_bytes(leaves[f]), err_msg=f)
    # JAX's layout carries a field the port's graph has not (cov_i8).
    with pytest.raises(TypeError):
        blob.unpack_graph_blob(torch.from_numpy(jblob.view(np.uint8)), layout)


def test_decode_refuses_what_it_cannot_view():
    with pytest.raises(TypeError, match="uint8"):
        blob.unpack_leaves(torch.zeros(4, dtype=torch.int32), ((),))
    layout = ((("x", "float64", (1,), 0, 2),),)
    with pytest.raises(TypeError, match="float64"):
        blob.unpack_leaves(torch.zeros(8, dtype=torch.uint8), layout)
    layout = ((("x", "int32", (3,), 0, 2),),)
    with pytest.raises(ValueError, match="2 words"):
        blob.unpack_leaves(torch.zeros(16, dtype=torch.uint8), layout)


# ------------------------------------------------------------ host counts


def counted_group(host, kernel, counts=None):
    return device_subset(graph_from_numpy(host, "cpu"), kernel, counts=counts).spmv_group


@pytest.mark.parametrize("stacked", [False, True], ids=["window", "stacked"])
@pytest.mark.parametrize("kernel,aux,collapse", PATTERN_ROUTES,
                         ids=[k for k, _, _ in PATTERN_ROUTES])
def test_host_counts_equal_the_device_counts(small_case, pod_case, kernel, aux, collapse,
                                             stacked):
    graphs = [host_subset(jax_graph(c, aux, collapse), kernel) for c in (small_case, pod_case)]
    host = stack_window_graphs(graphs) if stacked else graphs[0]
    counts = ss_host_counts(host, kernel)
    ref = counted_group(host, kernel)
    assert counts == (ref.items.shape[0], ref.max_chunks,
                      int((ref.bucket < ref.items.shape[0] * spmv.WARP).sum()))
    got = counted_group(host, kernel, counts)
    for f in ("items", "cols", "vals", "bucket", "chunk_slot", "row_chunks"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.max_chunks, got.n_rows, got.windows) == (ref.max_chunks, ref.n_rows, ref.windows)


SIX_SPMV_ROUTES = [r for r in ROUTES if r[0] in ("pcsr", "pallas")]


def group_counts(group):
    """(n_items, max_chunks, live entries) of a built work list."""
    return (group.items.shape[0], group.max_chunks,
            int((group.bucket < group.items.shape[0] * spmv.WARP).sum()))


def assert_groups_equal(got, ref):
    for f in ("items", "cols", "vals", "bucket", "chunk_slot", "row_chunks"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.max_chunks, got.n_rows, got.n_x, got.windows) == (
        ref.max_chunks, ref.n_rows, ref.n_x, ref.windows)


@pytest.mark.parametrize("stacked", [False, True], ids=["window", "stacked"])
@pytest.mark.parametrize("kernel,aux,collapse", SIX_SPMV_ROUTES,
                         ids=[k for k, _, _ in SIX_SPMV_ROUTES])
def test_pcsr_and_pallas_host_counts_equal_the_device_counts(small_case, pod_case, kernel,
                                                             aux, collapse, stacked):
    graphs = [host_subset(jax_graph(c, aux, collapse), kernel) for c in (small_case, pod_case)]
    host = stack_window_graphs(graphs) if stacked else graphs[0]
    counts = host_counts(host, kernel)
    ref = device_subset(graph_from_numpy(host, "cpu"), kernel).spmv_group
    got = device_subset(graph_from_numpy(host, "cpu"), kernel, counts=counts).spmv_group
    if kernel == "pallas":
        assert counts == group_counts(ref)
        assert_groups_equal(got, ref)
        return
    assert isinstance(counts, PcsrCounts) and counts.rows == group_counts(ref.rows)
    assert_groups_equal(got.rows, ref.rows)
    dev = graph_from_numpy(host, "cpu")
    for i, g in enumerate((dev.normal, dev.abnormal)):
        assert counts.n_sr[i] == int((g.pc_sr_val != 0).sum())
        assert counts.n_ell[i] == int(ref.ell[i].lens.sum())
    for a, b in zip(got.ell, ref.ell):
        assert a.mode == b.mode and a.slot == b.slot
        for x, y in zip((a.ops, a.vals, a.lens), (b.ops, b.vals, b.lens)):
            assert torch.equal(x, y)


def bad_views(graph, kernel):
    """(name, bad graph, error, match) of each check the host must make."""
    g = graph.normal
    out = []
    if kernel == "pcsr":
        out.append(("n_inc", g._replace(n_inc=np.int32(int(g.n_inc) + 1)),
                    ValueError, "nonzero entries"))
        rs, ops = g.pc_ell_rs.copy(), g.pc_ell_op.copy()
        n_live = (rs != 0).sum(1)
        row = int(np.flatnonzero((n_live >= 1) & (n_live < rs.shape[1]))[0])
        # The row's first entry moved past its last: live after padding.
        rs[row, n_live[row]], rs[row, 0] = rs[row, 0], 0.0
        out.append(("gap", g._replace(pc_ell_rs=rs), ValueError, "after padding"))
        ops[np.nonzero(g.pc_ell_rs)[0][0], 0] = g.cov_unique.shape[0] + 3
        out.append(("op", g._replace(pc_ell_op=ops), ValueError, "ops outside"))
        trace = g.pc_trace.copy()
        trace[np.nonzero(g.pc_sr_val)[0][0], np.nonzero(g.pc_sr_val)[1][0]] = -7
        out.append(("column", g._replace(pc_trace=trace), IndexError, "1 column"))
    else:
        parent = g.ss_parent.copy()
        parent[0] = g.cov_unique.shape[0] + 9
        out.append(("column", g._replace(ss_parent=parent), IndexError, "1 column"))
        op = g.inc_op.copy()
        op[0] = -2
        out.append(("row", g._replace(inc_op=op), ValueError, "out of range"))
    return [(name, graph._replace(normal=bad), err, match) for name, bad, err, match in out]


@pytest.mark.parametrize("kernel,aux,collapse", SIX_SPMV_ROUTES,
                         ids=[k for k, _, _ in SIX_SPMV_ROUTES])
def test_bad_pcsr_and_pallas_views_still_raise(small_case, kernel, aux, collapse):
    host = host_subset(jax_graph(small_case, aux, collapse), kernel)
    for name, bad, err, match in bad_views(host, kernel):
        with pytest.raises(err, match=match):
            host_counts(bad, kernel)
        with pytest.raises(err, match=match):
            blob.stage_rank_window(bad, PageRankConfig(), SpectrumConfig(), kernel, "cpu", True)
        if name != "column" or kernel == "pallas":  # the device-side check, as before
            with pytest.raises(err, match=match):
                device_subset(graph_from_numpy(bad, "cpu"), kernel)
        stacked = stack_window_graphs([bad, host])
        with pytest.raises(err, match=match):
            host_counts(stacked, kernel)
    indptr = host.normal.pc_blk_indptr.copy() if kernel == "pcsr" else None
    if indptr is not None:
        indptr[0, 1], indptr[0, 2] = indptr[0, 2] + 1, indptr[0, 1]
        bad = host._replace(normal=host.normal._replace(pc_blk_indptr=indptr))
        with pytest.raises(ValueError, match="not sorted"):
            host_counts(bad, kernel)


def test_host_counts_only_for_the_pattern_routes(small_case):
    assert ss_host_counts(jax_graph(small_case, "pcsr", "off"), "pcsr") is None
    assert ss_host_counts(jax_graph(small_case, "auto", "off"), "pallas") is None


@pytest.mark.parametrize("kernel,aux,collapse", PATTERN_ROUTES,
                         ids=[k for k, _, _ in PATTERN_ROUTES])
def test_a_bad_column_still_raises(small_case, kernel, aux, collapse):
    host = host_subset(jax_graph(small_case, aux, collapse), kernel)
    v = host.normal.cov_unique.shape[0]
    parent = host.normal.ss_parent.copy()
    parent[0] = v + 5
    bad = host._replace(normal=host.normal._replace(ss_parent=parent))
    # The same IndexError as the device-side check, now from the host.
    with pytest.raises(IndexError, match="1 column"):
        ss_host_counts(bad, kernel)
    with pytest.raises(IndexError, match="1 column"):
        counted_group(bad, kernel)
    with pytest.raises(IndexError, match="1 column"):
        blob.stage_rank_window(bad, PageRankConfig(), SpectrumConfig(), kernel, "cpu", True)
    if kernel != "kind":
        child = host.normal.ss_child.copy()
        child[0] = -1
        bad = host._replace(normal=host.normal._replace(ss_child=child))
        with pytest.raises(ValueError, match="out of range"):
            ss_host_counts(bad, kernel)


def test_row_layout_checked_is_the_same_layout():
    gen = np.random.default_rng(4)
    rows = torch.from_numpy(gen.integers(0, 40, 300, dtype=np.int32))
    cols = torch.from_numpy(gen.integers(0, 60, 300, dtype=np.int32))
    vals = torch.from_numpy(gen.random(300, dtype=np.float32))
    for n_live in (None, torch.tensor(250, dtype=torch.int32)):
        a = spmv.row_layout(rows, cols, vals, 40, n_live)
        b = spmv.row_layout(rows, cols, vals, 40, n_live, checked=True)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)
        assert int(a.indptr[-1]) == (300 if n_live is None else 250)
    with pytest.raises(ValueError, match="out of range"):
        spmv.row_layout(torch.tensor([-1, 0], dtype=torch.int32), cols[:2], vals[:2], 40)


def test_stage_rank_window_matches_the_tree_path_and_refuses_unported(small_case):
    host = host_subset(jax_graph(small_case, "kind", "on"), "kind")
    cfg = PageRankConfig()
    outs, staged = blob.stage_rank_window(host, cfg, SpectrumConfig(), "kind", "cpu", True,
                                          conv_trace=True)
    assert staged is None and len(outs) == 5
    ref = rank_window_traced_core(
        device_subset(graph_from_numpy(host, "cpu"), "kind"), cfg, SpectrumConfig(), "kind"
    )
    for a, b in zip(fetch_rank_outputs(outs), fetch_rank_outputs(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    short, _ = blob.stage_rank_window(host, cfg, SpectrumConfig(), "kind", "cpu", False)
    assert len(short) == 3
    # The checked program (K14): the same outputs and a check word of 0.
    checked, _ = blob.stage_rank_window(host, cfg, SpectrumConfig(), "kind", "cpu", True,
                                        checked=True, conv_trace=True)
    assert len(checked) == 6 and int(checked[-1]) == 0
    for a, b in zip(fetch_rank_outputs(checked[:5]), fetch_rank_outputs(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # The explained program (K15): the same five outputs, then the
    # attribution's five (tests/test_torch_explain.py holds them to JAX).
    from microrank_tpu_torch.config import ExplainConfig

    explained, _ = blob.stage_rank_window(host, cfg, SpectrumConfig(), "kind", "cpu", True,
                                          explain=ExplainConfig(enabled=True))
    assert len(explained) == 10
    for a, b in zip(fetch_rank_outputs(explained)[:5], fetch_rank_outputs(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- the window loop


@pytest.fixture(scope="module")
def timeline(tmp_path_factory):
    tl = generate_timeline(SyntheticConfig(**TIMELINE), N_WINDOWS, FAULTED)
    normal, abnormal = tl.write_csvs(tmp_path_factory.mktemp("blob_timeline"))
    return tl, normal, abnormal


@pytest.fixture(scope="module")
def tables(timeline):
    _, normal, abnormal = timeline
    return (
        (load_span_table(normal, cache=False), load_span_table(abnormal, cache=False)),
        (jax_load(normal, cache=False), jax_load(abnormal, cache=False)),
    )


@pytest.fixture
def registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


def port_run(tables, precision="f32", batch_windows=False, **runtime):
    rca = TableRCA(MicroRankConfig(
        pagerank=PageRankConfig(kind_precision=precision),
        runtime=RuntimeConfig(**runtime), ingest=IngestConfig(enabled=False),
    ), device="cpu")
    rca.fit_baseline(tables[0][0])
    return rca.run(tables[0][1], batch_windows=batch_windows)


def rankings(results):
    return [(r.start, r.kernel, r.ranking, r.rank_iterations) for r in results]


# route -> runtime (and kind precision); mode -> (runtime, batch_windows).
RUN_ROUTES = {
    "kind": dict(kernel="kind", collapse_kinds="on"),
    "kind_int8": dict(kernel="kind", collapse_kinds="on"),
    "packed": dict(kernel="packed", collapse_kinds="off"),
    "packed_bf16": dict(kernel="packed_bf16", collapse_kinds="off"),
    "packed_blocked": dict(kernel="packed_blocked", collapse_kinds="off"),
    "pcsr": dict(kernel="pcsr", collapse_kinds="off"),
    "pallas": dict(kernel="pallas", collapse_kinds="off"),
    "auto": {},
}
MODES = {
    "window": ({}, False),
    "chunked": (dict(dispatch_batch_windows=2, fetch_mode="bulk"), False),
    "batch": ({}, True),
}
RUN_CASES = [(r, "window") for r in RUN_ROUTES] + [
    (r, m) for r in ("auto", "packed_blocked", "pcsr", "kind_int8") for m in ("chunked", "batch")
]


@pytest.mark.parametrize("route,mode", RUN_CASES, ids=[f"{r}-{m}" for r, m in RUN_CASES])
def test_run_blob_is_bitwise_the_tree_path(tables, registry, route, mode):
    runtime, batch = MODES[mode]
    precision = "int8" if route == "kind_int8" else "f32"
    kw = dict(precision=precision, batch_windows=batch, **RUN_ROUTES[route], **runtime)
    got = port_run(tables, **kw)
    ranked = [r for r in got if r.ranking]
    assert len(ranked) == len(FAULTED)
    programs = 1 if batch else -(-len(ranked) // runtime.get("dispatch_batch_windows", 1))
    transfers = staging_transfers()
    assert transfers.value(path="blob") == programs
    assert transfers.value(path="tree") == 0
    blob_bytes = staged_bytes().value(path="blob")
    ref = port_run(tables, blob_staging=False, **kw)
    assert rankings(got) == rankings(ref)
    assert transfers.value(path="tree") == programs * 2 * len(PartitionGraph._fields)
    # The same host graphs audited either way: equal staged bytes.
    assert staged_bytes().value(path="tree") == blob_bytes > 0


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_default_run_agrees_with_jax_default(tables, precision):
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        pagerank=JaxPageRank(kind_precision=precision),
        runtime=dataclasses.replace(jcfg.runtime, tuned_policy="off"),
        ingest=JaxIngest(enabled=False),
    )
    assert jcfg.runtime.blob_staging and RuntimeConfig().blob_staging
    j = JaxTableRCA(jcfg)
    j.fit_baseline(tables[1][0])
    theirs = j.run(tables[1][1])
    ours = port_run(tables, precision=precision)
    assert [(r.start, r.kernel, r.n_abnormal) for r in ours] == [
        (r.start, r.kernel, r.n_abnormal) for r in theirs
    ]
    int8 = precision == "int8"
    for a, b in zip(ours, theirs):
        assert len(a.ranking) == len(b.ranking)  # n_valid
        if not a.ranking:
            continue
        assert a.ranking[0][0] == b.ranking[0][0]
        assert a.rank_iterations == b.rank_iterations
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in b.ranking], [s for _, s in b.ranking],
            [n for n, _ in a.ranking], [s for _, s in a.ranking],
            k=5 if int8 else len(a.ranking), rtol=5e-2 if int8 else 1e-5, exempt_last=int8,
        )
        assert ok, why


def read_result_csv(out):
    with open(out / "result.csv") as f:
        return list(csv.DictReader(f))


def test_cli_no_blob_staging(timeline, tmp_path):
    _, normal, abnormal = timeline
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    args = cli.build_parser().parse_args(base + ["--no-blob-staging"])
    assert not cli._config_from_args(args).runtime.blob_staging
    assert cli._config_from_args(cli.build_parser().parse_args(base)).runtime.blob_staging
    outs = {}
    for tag, main, flags in (("tree", cli.main, ["--device", "cpu", "--no-blob-staging"]),
                             ("blob", cli.main, ["--device", "cpu"]),
                             ("jax", jax_main, ["--engine", "native", "--no-blob-staging"])):
        outs[tag] = tmp_path / tag
        assert main(base + ["-o", str(outs[tag])] + flags) == 0
    tree, ours, theirs = (read_result_csv(outs[k]) for k in ("tree", "blob", "jax"))
    assert tree and tree == ours
    assert [(r["window_start"], r["rank"], r["result"]) for r in tree][:1] == [
        (r["window_start"], r["rank"], r["result"]) for r in theirs
    ][:1]
    assert len(tree) == len(theirs)
    for a, b in zip(tree, theirs):
        assert (a["window_start"], a["rank"]) == (b["window_start"], b["rank"])
        assert float(a["confidence"]) == pytest.approx(float(b["confidence"]), rel=1e-5)
