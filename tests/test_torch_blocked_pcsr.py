"""kernel="auto" past the dense budget: ``packed_blocked`` (K4 in f32)
and ``pcsr`` (K1's work items over the op side, the trace side read
from the partition-centric views' ELL slab), held to the JAX package on the CPU, where each wrapper runs its
plain version.

* the build: the native pcsr views array-identical to JAX's, collapse
  off and on; the budget policy (``resolve_aux``, ``choose_kernel``) the
  same at budgets that select packed / packed_blocked / pcsr;
* the lane: ``run_rca_native`` with forced and auto-resolved
  packed_blocked (rtol 1e-4, as JAX's own blocked-vs-packed test) and
  pcsr (rtol 1e-5) against JAX's table lane, tie-aware, with the same
  kernels, n_valid and n_iters;
* the kernels: pcsr's work list and ELL slabs hold the pallas work
  list's rows, and its products are bitwise the pallas path's, and so is
  its ranking; the
  banded plain K4 gives the unbanded one's bits;
* the references: the port's float64 sparse oracle against JAX's (rtol
  1e-12), the giant-window generator deterministic from its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import partition_case
from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.graph import build_window_graph
from microrank_tpu.graph import build as jax_build
from microrank_tpu.native import build_window_padded as jax_build_padded
from microrank_tpu.pipeline.table_runner import run_rca_native as jax_run
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu.rank_backends.sparse_oracle import rank_window_sparse as jax_oracle
from microrank_tpu_torch import native
from microrank_tpu_torch.config import DetectorConfig, IngestConfig, MicroRankConfig
from microrank_tpu_torch.config import PageRankConfig, RuntimeConfig, SpectrumConfig
from microrank_tpu_torch.graph import build, table_ops
from microrank_tpu_torch.graph.structures import pad_to
from microrank_tpu_torch.ops import pattern
from microrank_tpu_torch.ops.spmv import CHUNK, coo_spmv_group, pcsr_spmv_group
from microrank_tpu_torch.pipeline import TableRCA, run_rca_native
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.sparse_oracle import rank_window_sparse
from microrank_tpu_torch.rank_backends.torch_cuda import (
    choose_kernel,
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
    spmv_layouts,
)
from microrank_tpu_torch.testing import SyntheticConfig, generate_case, giant_window
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

# More traces than one column tile (512), so that packed_blocked's
# blocks and bands split the trace axis.
SYNTH = dict(n_operations=30, n_traces=1500, n_kinds=24, child_keep_prob=0.6, seed=5)
RTOL = {"packed_blocked": 1e-4, "pcsr": 1e-5}


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    case = generate_case(SyntheticConfig(**SYNTH))
    normal, abnormal = case.write_csvs(tmp_path_factory.mktemp("blocked_pcsr"))
    return case, normal, abnormal


@pytest.fixture(scope="module")
def window(csvs):
    """The first window's table slice, partition and shapes, as the lane
    builds it (detection in the port, which tests/test_torch_pipeline.py
    holds to JAX's)."""
    _, normal, abnormal = csvs
    tab = native.load_span_table(abnormal, cache=False)
    vocab, base = table_ops.compute_slo_from_table(native.load_span_table(normal, cache=False))
    w0 = int(tab.start_us.min())
    mask, nrm, abn, _, (lo, hi) = table_ops.detect_window_partition(
        tab, w0, w0 + 300_000_000, vocab, base, DetectorConfig(), with_range=True
    )
    assert len(nrm) and len(abn)
    return tab, mask, nrm, abn, lo, hi


def padded_both(window, mode, collapse, budget=None):
    tab, mask, nrm, abn, lo, hi = window
    n_total = len(tab.trace_names)
    nf = np.zeros(n_total, np.uint8)
    af = np.zeros(n_total, np.uint8)
    nf[nrm] = 1
    af[abn] = 1
    vocab = len(tab.pod_op_names)
    v_pad = pad_to(vocab, "pow2q", 8)
    args = (
        tab.pod_op[lo:hi], tab.trace_id[lo:hi], tab.parent_row[lo:hi], mask,
        nf, af, vocab, v_pad, lambda n: pad_to(n, "pow2q", 8), mode,
    )
    kw = dict(collapse=collapse, dense_budget_bytes=budget, parent_base=lo)
    return native.build_window_padded(*args, **kw), jax_build_padded(*args, **kw)


@pytest.mark.parametrize("mode,collapse,budget", [
    ("pcsr", "off", None),
    ("pcsr", "on", None),
    ("auto", "auto", 64),
])
def test_native_pcsr_views_match_jax(window, mode, collapse, budget):
    ours, theirs = padded_both(window, mode, collapse, budget)
    for t, j in zip(ours, theirs):
        for f in t._fields:
            a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert t.pc_trace.shape[-1] > 0 and t.cov_bits.shape[-1] == 0
        assert (t.n_cols >= 0) == (collapse != "off")


def test_pcsr_auxiliary_matches_jax(small_case):
    graph, _ = jax_graph(small_case, "none", "off")
    for g in (graph.normal, graph.abnormal):
        args = (g.inc_op, g.inc_trace, g.sr_val, g.rs_val, int(g.n_inc),
                g.cov_unique.shape[0], g.kind.shape[0])
        for a, b in zip(build.pcsr_auxiliary(*args), jax_build.pcsr_auxiliary(*args)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (build.PCSR_PART_TRACES, build.PCSR_BLOCK) == (
        jax_build.PCSR_PART_TRACES, jax_build.PCSR_BLOCK
    )
    for t in (1, 4096, 4097, 10**6):
        assert build.pcsr_partitions(t) == jax_build.pcsr_partitions(t)


def jax_graph(case, aux, collapse, **kw):
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse, **kw)
    return graph, names


def test_budget_policy_matches_jax(small_case):
    # budget = unpacked - 1 keeps the bitmaps (JAX's
    # test_auto_policy_blocked_past_budget); a budget under 4x the
    # bitmap bytes builds the pcsr views instead.
    graph, _ = jax_graph(small_case, "packed", "off")
    v_pad = graph.normal.cov_unique.shape[0]
    t_pads = (graph.normal.kind.shape[0], graph.abnormal.kind.shape[0])
    unpacked = build.packed_unpacked_bytes(v_pad, t_pads)
    bits = build.packed_bits_bytes(v_pad, t_pads)
    assert unpacked == jax_build.packed_unpacked_bytes(v_pad, t_pads)
    assert bits == jax_build.packed_bits_bytes(v_pad, t_pads)
    cases = [(unpacked, "packed", "packed"), (unpacked - 1, "packed", "packed_blocked"),
             (4 * bits - 4, "pcsr", "pcsr")]
    for budget, aux, kernel in cases:
        assert build.resolve_aux("auto", v_pad, t_pads, budget) == aux
        assert jax_build.resolve_aux("auto", v_pad, t_pads, budget) == aux
        g, _ = jax_graph(small_case, "auto", "off", dense_budget_bytes=budget)
        for prefer_bf16 in (False, True):
            want = jax_tpu.choose_kernel(g, budget, prefer_bf16)
            assert choose_kernel(g, budget, prefer_bf16) == want
            assert choose_kernel(graph_from_numpy(g, "cpu"), budget, prefer_bf16) == want
        assert want == (kernel if kernel != "packed" else "packed_bf16")


def lane_configs(kernel, collapse, budget=2 << 30, block_bytes=128 << 20):
    jcfg = JaxConfig(
        pagerank=JaxPageRank(packed_block_bytes=block_bytes),
        runtime=JaxRuntime(kernel=kernel, collapse_kinds=collapse,
                           dense_budget_bytes=budget, tuned_policy="off"),
        ingest=JaxIngest(enabled=False),
    )
    tcfg = MicroRankConfig(
        pagerank=PageRankConfig(packed_block_bytes=block_bytes),
        runtime=RuntimeConfig(kernel=kernel, collapse_kinds=collapse, dense_budget_bytes=budget),
        ingest=IngestConfig(enabled=False),
    )
    return jcfg, tcfg


def assert_same_lane(jres, tres, kernel):
    assert len(jres) == len(tres)
    ranked = [t for t in tres if t.ranking]
    assert ranked and {t.kernel for t in ranked} == {kernel}
    for j, t in zip(jres, tres):
        assert (j.start, j.anomaly, j.n_normal, j.n_abnormal, j.kernel, j.rank_iterations) == (
            t.start, t.anomaly, t.n_normal, t.n_abnormal, t.kernel, t.rank_iterations
        )
        assert len(j.ranking) == len(t.ranking)
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=RTOL[kernel],
        )
        assert ok, f"{t.start}: {why}"
        if t.ranking:
            assert j.ranking[0][0] == t.ranking[0][0]


# (kernel, collapse, dense budget, packed_block_bytes): forced, then
# auto-resolved at lowered budgets; the small block bytes make JAX scan
# column blocks and the port's plain version unpack bands.
LANES = [
    ("packed_blocked", "off", 2 << 30, 32 * 1024),
    ("packed_blocked", "on", 2 << 30, 128 << 20),
    ("pcsr", "off", 2 << 30, 128 << 20),
    ("pcsr", "on", 2 << 30, 128 << 20),
    ("auto", "off", 64 * 1024, 32 * 1024),
    ("auto", "off", 4096, 128 << 20),
]


@pytest.mark.parametrize("kernel,collapse,budget,block_bytes", LANES)
def test_lane_matches_jax_past_the_budget(csvs, kernel, collapse, budget, block_bytes):
    case, normal, abnormal = csvs
    jcfg, tcfg = lane_configs(kernel, collapse, budget, block_bytes)
    jres = jax_run(normal, abnormal, jcfg)
    tres = run_rca_native(normal, abnormal, tcfg, device="cpu")
    want = kernel if kernel != "auto" else ("pcsr" if budget < 8192 else "packed_blocked")
    assert_same_lane(jres, tres, want)
    assert [r for r in tres if r.ranking][0].ranking[0][0] == case.fault_pod_op


@pytest.mark.parametrize("collapse", ["off", "on"])
def test_pcsr_products_and_ranking_are_bitwise_pallas(small_case, collapse):
    graph, _ = jax_graph(small_case, "pcsr", collapse)
    tg = graph_from_numpy(graph, "cpu")
    pc = device_subset(graph_from_numpy(host_subset(graph, "pcsr"), "cpu"), "pcsr")
    pal = device_subset(tg, "pallas")
    group, theirs = pc.spmv_group, pal.spmv_group
    # The work list holds the pallas rows of p_sr and p_ss, entry for
    # entry, in the same order and cut into the same chunks; each ELL
    # slab row holds the pallas row of p_rs as its live prefix, whose
    # chunks the kernel walks.
    e_pc, e_pal = group.rows.entry_offsets, theirs.entry_offsets
    y_pc = np.cumsum((0, *group.rows.n_rows))
    y_pal = np.cumsum((0, *theirs.n_rows))

    def pallas_chunks(m_pal):
        return theirs.row_chunks[y_pal[m_pal]: y_pal[m_pal + 1]]

    for m, m_pal in enumerate((0, 1, 3, 4)):
        assert group.rows.n_rows[m] == theirs.n_rows[m_pal]
        assert torch.equal(group.rows.row_chunks[y_pc[m]: y_pc[m + 1]], pallas_chunks(m_pal))
        n_live = e_pc[m + 1] - e_pc[m]
        assert torch.equal(group.rows.cols[e_pc[m]: e_pc[m + 1]],
                           theirs.cols[e_pal[m_pal]: e_pal[m_pal] + n_live])
        assert torch.equal(group.rows.vals[e_pc[m]: e_pc[m + 1]],
                           theirs.vals[e_pal[m_pal]: e_pal[m_pal] + n_live])
    for ell, g, m_pal in zip(group.ell, (tg.normal, tg.abnormal), (2, 5)):
        rs = spmv_layouts(g)[2]
        live = ell.vals != 0
        assert ell.ops.shape[0] == rs.n_rows
        n_live = live.sum(1)
        assert torch.equal(n_live, (rs.indptr[1:] - rs.indptr[:-1]).to(torch.int64))
        assert torch.equal((n_live + CHUNK - 1).div(CHUNK, rounding_mode="floor").clamp_min(1),
                           pallas_chunks(m_pal))
        assert torch.equal(ell.ops[live], rs.cols[: int(rs.indptr[-1])])
        assert torch.equal(ell.vals[live], rs.vals[: int(rs.indptr[-1])])
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
          for n in (tg.normal.kind.shape[0], tg.normal.cov_unique.shape[0],
                    tg.abnormal.kind.shape[0], tg.abnormal.cov_unique.shape[0])]
    for y_pc, y_pal in zip(pcsr_spmv_group(group, xs), coo_spmv_group(theirs, xs)):
        assert torch.equal(y_pc, y_pal)
    outs = [fetch_rank_outputs(rank_window_traced_core(g, PageRankConfig(), SpectrumConfig(), k))
            for g, k in ((pc, "pcsr"), (pal, "pallas"))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pcsr_layouts_check_liveness(small_case):
    graph, _ = jax_graph(small_case, "pcsr", "off")
    bad = graph._replace(normal=graph.normal._replace(n_inc=np.int32(int(graph.normal.n_inc) + 1)))
    with pytest.raises(ValueError, match="nonzero entries"):
        device_subset(graph_from_numpy(bad, "cpu"), "pcsr")
    with pytest.raises(ValueError, match="partition-centric"):
        device_subset(graph_from_numpy(jax_graph(small_case, "packed", "off")[0], "cpu"), "pcsr")


@pytest.mark.parametrize("v,k,band_tiles", [(300, 1100, 1), (129, 2100, 2), (40, 513, 1)])
@pytest.mark.parametrize("w_out", [False, True])
def test_banded_plain_pair_gives_the_unbanded_bits(v, k, band_tiles, w_out):
    rng = np.random.default_rng(v + k)
    m = (rng.random((v, k)) < 0.35).astype(np.uint8)
    bits = torch.from_numpy(np.packbits(m, axis=1))
    vec = lambda n: torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))  # noqa: E731
    w_len, w_cov, w_o, rv, sv = vec(k), vec(v), vec(v), vec(k), vec(v)
    band_bytes = 4 * v * pattern.TILE_C * band_tiles

    def group(band):
        return pattern.pattern_group([bits], [w_len], [w_cov], [w_o if w_out else None], [k],
                                     band_bytes=band)

    whole, banded = group(None), group(band_bytes)
    assert banded.parts[0].band_cols == band_tiles * pattern.TILE_C
    assert banded.parts[0].dense is None and whole.parts[0].band_cols == 0
    (a,), (b,) = (pattern.pattern_pair_group(g, [rv], [sv]) for g in (whole, banded))
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    # A budget the whole matrix fits is not banded.
    assert group(4 * v * k).parts[0].band_cols == 0


def test_packed_blocked_rank_program_matches_jax(small_case):
    graph, names = jax_graph(small_case, "packed", "off")
    t_pad = graph.abnormal.kind.shape[0]
    v_pad = graph.abnormal.cov_unique.shape[0]
    block = v_pad * (t_pad // 4) * 4
    dg = jax.tree.map(jnp.asarray, graph)
    j = jax_tpu.rank_window_traced_device(
        dg, JaxPageRank(packed_block_bytes=block), JaxSpectrum(), None, "packed_blocked"
    )
    tg = device_subset(graph_from_numpy(host_subset(graph, "packed_blocked"), "cpu"),
                       "packed_blocked", block)
    t = fetch_rank_outputs(rank_window_traced_core(
        tg, PageRankConfig(packed_block_bytes=block), SpectrumConfig(), "packed_blocked"
    ))
    j_idx, j_sc, j_nv, j_res, j_it = (np.asarray(a) for a in j)
    t_idx, t_sc, t_nv, t_res, t_it = t
    assert (int(j_nv), int(j_it)) == (t_nv, t_it)
    assert names[t_idx[0]] == names[int(j_idx[0])] == small_case.fault_pod_op
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:t_nv]), list(j_sc[:t_nv]), list(t_idx[:t_nv]), list(t_sc[:t_nv]),
        k=t_nv, rtol=1e-4,
    )
    assert ok, why
    np.testing.assert_allclose(t_res, j_res, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_sparse_oracle_matches_jax(case_name, request):
    case = request.getfixturevalue(case_name)
    graph, names = jax_graph(case, "none", "off")
    jn, js = jax_oracle(graph, names)
    tn, ts = rank_window_sparse(graph, names)
    assert tn == jn and tn[0] == case.fault_pod_op
    np.testing.assert_allclose(ts, js, rtol=1e-12)
    # A convergence tol and another formula.
    tn, ts = rank_window_sparse(
        graph, names, PageRankConfig(tol=1e-6, iterations=80), SpectrumConfig(method="ochiai")
    )
    jn, js = jax_oracle(
        graph, names, JaxPageRank(tol=1e-6, iterations=80), JaxSpectrum(method="ochiai")
    )
    assert tn == jn
    np.testing.assert_allclose(ts, js, rtol=1e-12)
    with pytest.raises(ValueError, match="uncollapsed"):
        rank_window_sparse(jax_graph(case, "none", "on")[0], names)


def test_giant_window_is_deterministic_from_its_seed():
    a, b = giant_window(n_spans=40_000, n_ops=50), giant_window(n_spans=40_000, n_ops=50)
    c = giant_window(n_spans=40_000, n_ops=50, seed=13)
    for f in a.table._fields:
        va, vb = getattr(a.table, f), getattr(b.table, f)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f
    assert not np.array_equal(a.table.pod_op, c.table.pod_op)
    t = a.table
    assert t.n_spans == 40_000 and len(t.trace_names) == 10_000
    np.testing.assert_array_equal(a.normal_codes, np.arange(5_000))
    np.testing.assert_array_equal(a.abnormal_codes, np.arange(5_000, 10_000))
    # bench.py's first draw, and parents earlier in the same trace.
    bench_ops = np.random.default_rng(12).integers(0, 50, size=20_000, dtype=np.int64)
    np.testing.assert_array_equal(t.pod_op[:20_000], bench_ops)
    child = np.flatnonzero(t.parent_row >= 0)
    assert 0 < child.size <= 2 * 4 * 50
    assert np.all(t.parent_row[child] < child)
    assert np.all(t.trace_id[t.parent_row[child]] == t.trace_id[child])
    assert t.pod_op_names == sorted(t.pod_op_names)


def test_giant_window_ranks_like_the_oracle_on_the_cpu():
    # A small giant window past a lowered budget, through the lane's own
    # seams: pcsr and packed_blocked agree with the float64 oracle.
    gw = giant_window(n_spans=40_000, n_ops=64)
    for budget, kernel in ((64 * 1024, "pcsr"), (1 << 20, "packed_blocked")):
        cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="off", dense_budget_bytes=budget))
        rca = TableRCA(cfg, device="cpu")
        graph, names, resolved = rca.prepare_rank(gw.table, None, gw.normal_codes, gw.abnormal_codes)
        assert resolved == kernel
        top, scores, _ = rca.finalize_rank(rca.launch_rank(graph, names, resolved))
        o_top, o_scores = rank_window_sparse(graph, names)
        ok, why = tie_aware_topk_agreement(top, scores, o_top, o_scores, k=5, rtol=1e-4)
        assert ok, why
