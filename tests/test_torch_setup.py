"""K6's set-up (``ops/setup.py``, ``csrc/rank_setup.cu``): a rank
program's preference and initial vectors, held to the JAX package on
the CPU and its kernel to its plain version on the card.

* on the CPU (the wrapper's plain version), against JAX's
  ``_partition_setup`` (pref, sv0, rv0) and ``preference_vector`` at
  rtol 1e-5 (float32; JAX sums the two normalization sums in XLA's
  order, the port in the fixed tree of ``ops/fold.py``): each partition
  with the anomaly off and on, the ``reference`` and ``paper`` forms,
  collapsed and uncollapsed graphs of two synthetic cases; random
  partitions with every column live, none live and a few, kinds up to
  50, pads up to 70,000;
* a stacked group of three windows at trace pads 8, 96 and 5,120: each
  window's vectors bitwise its own set-up's, zero past its pad, and
  within rtol 1e-5 of JAX's;
* the main path takes its set-up from one ``rank_setup`` call
  (``window_weights_full`` through it, bitwise the plain version);
* the launch's plan (``setup_plan``, pure): every tile of every row
  dealt once (a block of a cluster a tile, or the grid's blocks in
  turn), the cluster the least power of two that holds the widest row,
  the forms at their edges (1, 2, 3, 8 and 9 tiles), the giant window's
  held tiles, the first design's grid, refused inputs, the argument
  block's words;
* on the card (``cuda`` marker, skipped here): the kernel bitwise its
  plain version run on the card (bit patterns), one window and a
  stacked B = 3, pads of 8, 96, 4,097, 70,000 and 2^21, collapsed and
  not, both forms, with every column live, none, and a count past the
  pad; rows of 1 tile, of 8 (a cluster of 8) and of 9 (the grid form)
  bitwise the plain version and the first design's kernel; one launch a
  call; bad inputs refused.

JAX is imported inside the CPU tests only, so the card's machine (no
JAX) runs the card tests alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_setup.py
"""

import functools
from typing import NamedTuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from microrank_tpu_torch.config import PageRankConfig
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import setup
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset
from microrank_tpu_torch.testing import giant_window

RTOL = 1e-5
PREFERENCES = ("reference", "paper")


class Part(NamedTuple):
    """The fields of a partition the set-up reads (and JAX's
    ``preference_vector``)."""

    kind: np.ndarray
    tracelen: np.ndarray
    n_cols: np.ndarray
    n_traces: np.ndarray
    n_ops: np.ndarray
    op_present: np.ndarray
    cov_unique: np.ndarray


def random_part(rng, t_pad, v, n_live, collapsed, lead=()):
    """A partition of ``t_pad`` trace columns (``n_live`` live, the rest
    padding of kind 1 and tracelen 1) over ``v`` ops."""
    kind = rng.integers(1, 51, lead + (t_pad,)).astype(np.int32)
    tracelen = rng.integers(1, 200, lead + (t_pad,)).astype(np.int32)
    n_live = np.broadcast_to(np.asarray(n_live, np.int32), lead)
    n_traces = np.where(collapsed, n_live * 3 + 1, n_live).astype(np.int32)
    return Part(
        kind=kind, tracelen=tracelen,
        n_cols=np.where(collapsed, n_live, -1).astype(np.int32),
        n_traces=n_traces,
        n_ops=np.broadcast_to(np.int32(max(1, v // 2)), lead).astype(np.int32),
        op_present=rng.random(lead + (v,)) < 0.6,
        cov_unique=rng.integers(0, 9, lead + (v,)).astype(np.int32),
    )


def to_torch(p: Part, device="cpu") -> Part:
    return Part(*(torch.from_numpy(np.array(x)).to(device) for x in p))


def bits(t):
    return t.contiguous().view(torch.int32)


def jax_setup(g, anomaly, preference, full=True, kernel="coo"):
    """JAX's (pref, sv0, rv0) of one partition: ``_partition_setup`` on a
    built graph (``full``), else ``preference_vector`` and the initial
    vectors' formula on a bare partition."""
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.rank_backends import jax_tpu

    cfg = JaxPageRank(preference=preference)
    jg = jax.tree.map(jnp.asarray, g)
    if full:
        _, pref, sv, rv, _ = jax_tpu._partition_setup(jg, anomaly, cfg, None, kernel)
        return tuple(np.asarray(x) for x in (pref, sv, rv))
    pref = np.asarray(jax_tpu.preference_vector(jg, anomaly, cfg))
    init = np.float32(1.0) / np.float32(int(g.n_ops) + int(g.n_traces))
    n_live = int(g.n_cols) if int(g.n_cols) >= 0 else int(g.n_traces)
    live = np.arange(g.kind.shape[0]) < n_live
    return pref, np.where(g.op_present, init, 0).astype(np.float32), np.where(
        live, init, 0).astype(np.float32)


def assert_close(got, want, rtol=RTOL):
    got = np.asarray(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def both_anomalies(g, cfg):
    """The set-up of one partition without and with the anomaly: the
    partition in both places of one ``rank_setup`` call."""
    return setup.rank_setup(g, g, cfg)


def built_graph(case, aux, collapse):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph

    nrm, abn = partition_case(case)
    graph, _, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse)
    return graph


@pytest.mark.parametrize("preference", PREFERENCES)
@pytest.mark.parametrize("aux,collapse", [("kind", "on"), ("auto", "off")],
                         ids=["collapsed", "uncollapsed"])
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_setup_matches_jax_partition_setup(case_name, aux, collapse, preference, request):
    graph = built_graph(request.getfixturevalue(case_name), aux, collapse)
    cfg = PageRankConfig(preference=preference)
    tg = graph_from_numpy(graph, "cpu")
    assert (int(graph.normal.n_cols) >= 0) == (collapse == "on")
    kernel = "kind" if aux == "kind" else "coo"
    for part in ("normal", "abnormal"):
        g = getattr(graph, part)
        got = both_anomalies(getattr(tg, part), cfg)
        for anomaly in (False, True):
            want = jax_setup(g, anomaly, preference, kernel=kernel)
            for x, y in zip(got[int(anomaly)], want):
                assert_close(x.numpy(), y)


@pytest.mark.parametrize("preference", PREFERENCES)
@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("t_pad,live", [(8, "all"), (96, "none"), (96, "few"), (700, "some"),
                                        (70_000, "some")])
def test_setup_matches_jax_preference_vector(t_pad, live, collapsed, preference):
    rng = np.random.default_rng(t_pad + 7 * collapsed)
    n_live = {"all": t_pad, "none": 0, "few": 3, "some": t_pad * 2 // 3}[live]
    p = random_part(rng, t_pad, 37, n_live, collapsed)
    cfg = PageRankConfig(preference=preference)
    got = both_anomalies(to_torch(p), cfg)
    for anomaly in (False, True):
        want = jax_setup(p, anomaly, preference, full=False)
        for x, y in zip(got[int(anomaly)], want):
            assert_close(x.numpy(), y)
        assert not got[int(anomaly)][0][n_live:].any()


# Three windows over one 13-op vocab with the kind views: two
# kind-collapsed at trace pads 8 and 96, one not at 5,120 (past one tile
# of the kernel's tree).
THREE_PADS = ((24, 3, "on"), (8000, 4, "on"), (20_000, 5, "off"))


@functools.lru_cache(maxsize=None)
def three_pad_windows():
    out = []
    for n_spans, seed, collapse in THREE_PADS:
        gw = giant_window(n_spans=n_spans, n_ops=13, spans_per_trace=2, seed=seed)
        graph, _, _, _ = build_window_graph_from_table(
            gw.table, None, gw.normal_codes, gw.abnormal_codes, aux="kind", collapse=collapse
        )
        out.append(host_subset(graph, "kind"))
    return tuple(out)


def test_the_three_windows_have_three_pads():
    pads = [p.kind.shape[-1] for g in three_pad_windows() for p in (g.normal, g.abnormal)]
    assert pads == [8, 8, 96, 96, 5120, 5120]
    assert [int(g.normal.n_cols) >= 0 for g in three_pad_windows()] == [True, True, False]


@pytest.mark.parametrize("preference", PREFERENCES)
def test_stacked_group_of_three_pads_is_bitwise_each_windows_own(preference):
    graphs = three_pad_windows()
    cfg = PageRankConfig(preference=preference)
    group = graph_from_numpy(stack_window_graphs(list(graphs)), "cpu")
    got = setup.rank_setup(group.normal, group.abnormal, cfg)
    for b, host in enumerate(graphs):
        own = graph_from_numpy(host, "cpu")
        want = setup.rank_setup(own.normal, own.abnormal, cfg)
        for p, part in enumerate(("normal", "abnormal")):
            t = getattr(own, part).kind.shape[-1]
            pref, sv, rv = got[p]
            assert torch.equal(bits(pref[b, :t]), bits(want[p][0]))
            assert torch.equal(bits(sv[b]), bits(want[p][1]))
            assert torch.equal(bits(rv[b, :t]), bits(want[p][2]))
            assert not pref[b, t:].any() and not rv[b, t:].any()
            jax_want = jax_setup(getattr(host, part), p == 1, preference, full=False)
            for x, y in zip((pref[b, :t], sv[b], rv[b, :t]), jax_want):
                assert_close(x.numpy(), y)


def test_window_weights_take_their_setup_from_one_call(monkeypatch):
    graph = host_subset(three_pad_windows()[1], "kind")
    dg = device_subset(graph_from_numpy(graph, "cpu"), "kind")
    calls = []

    def spy(normal, abnormal, cfg):
        calls.append(cfg)
        return setup.rank_setup(normal, abnormal, cfg)

    want = torch_cuda.window_weights_full(dg, PageRankConfig(), "kind")
    monkeypatch.setattr(torch_cuda, "rank_setup", spy)
    got = torch_cuda.window_weights_full(dg, PageRankConfig(), "kind")
    assert len(calls) == 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_setup_refuses_an_unknown_preference_form():
    p = to_torch(random_part(np.random.default_rng(0), 8, 5, 4, False))
    with pytest.raises(ValueError, match="preference"):
        setup.rank_setup(p, p, PageRankConfig(preference="other"))


# ------------------------------------------------------------------ plan

CARD = setup.H100
TILE = setup.TILE


def row_tiles(t_pads, windows):
    """Every (partition, window) row's tiles: [(row, tiles)]."""
    return [(p * windows + b, -(-t // TILE)) for p, t in enumerate(t_pads)
            for b in range(windows)]


@settings(max_examples=200, deadline=None)
@given(t_pads=st.lists(st.integers(0, 40 * 4096), min_size=2, max_size=2),
       windows=st.integers(1, 9), v=st.integers(0, 70_000))
def test_setup_plan_deals_every_tile_of_every_row_once(t_pads, windows, v):
    plan = setup.setup_plan(t_pads, windows, v, CARD)
    rows = row_tiles(t_pads, windows)
    assert plan.tree_items == sum(n for _, n in rows)
    if plan.form == "rows":
        # Block r of cluster `row` is tile r of that row: every tile has
        # its block, and a cluster is the least power of two that holds
        # the widest row.
        assert plan.grid == 2 * windows * plan.cluster and plan.hold == 0
        widest = max(n for _, n in rows)
        assert widest <= plan.cluster <= max(1, 2 * widest - 1)
        assert plan.cluster & (plan.cluster - 1) == 0
        assert plan.cluster <= CARD.cluster_max
    else:
        # Item i (the row-major tiles) goes to block i % grid, in turn.
        assert plan.form == "grid" and plan.cluster == 1
        assert max(n for _, n in rows) > CARD.cluster_max
        assert 1 <= plan.grid <= min(plan.tree_items, CARD.grid_blocks)
        per_block = [len(range(g, plan.tree_items, plan.grid)) for g in range(plan.grid)]
        assert sum(per_block) == plan.tree_items and min(per_block) >= 1
        assert plan.hold == min(max(per_block), CARD.hold_max)


@pytest.mark.parametrize("t_pad,form,cluster", [
    (0, "rows", 1), (8, "rows", 1), (4096, "rows", 1), (4097, "rows", 2),
    (3 * 4096, "rows", 4), (8 * 4096, "rows", 8), (8 * 4096 + 1, "grid", 1),
    (1 << 21, "grid", 1),
])
def test_setup_plan_forms_at_their_edges(t_pad, form, cluster):
    plan = setup.setup_plan((t_pad, 5), 3, 300, CARD)
    assert (plan.form, plan.cluster) == (form, cluster)


def test_setup_plan_of_the_giant_window_holds_its_tiles():
    # Two rows of 512 tiles on 132 blocks: eight tiles a block, six held.
    plan = setup.setup_plan((1 << 21, 1 << 21), 1, 2048, CARD)
    assert plan == setup.SetupPlan("grid", 1, 132, 6, 1024)


def test_setup_plan_of_the_first_design():
    plan = setup.setup_plan((96, 4097), 3, 9000, CARD, first_design=True)
    # 3 x (1 + 2) tiles and 2 x 3 x 3 sv0 tiles, a block each.
    assert plan == setup.SetupPlan("first", 1, 9 + 18, 0, 9)
    big = setup.setup_plan((1 << 21, 1 << 21), 1, 2048, CARD, first_design=True)
    assert big.grid == CARD.first_blocks


@pytest.mark.parametrize("t_pads,windows,v", [
    ((-1, 8), 1, 5), ((8,), 1, 5), ((8, 8, 8), 1, 5), ((8, 8), 0, 5), ((8, 8), 1, -1),
    ((setup.MAX_WIDTH + 1, 8), 1, 5),
])
def test_setup_plan_refuses_what_the_kernel_does_not_take(t_pads, windows, v):
    with pytest.raises(ValueError, match="setup_plan"):
        setup.setup_plan(t_pads, windows, v, CARD)


def test_setup_argument_block_is_the_library_words():
    # csrc Word: 2 x 10 partition words, then 12 more, then K19's four
    # init vectors and the grid form's words, the int8 scales' four
    # weights and output, and K19's flag design.
    assert setup.ARGS.size == 8 * 43
    assert setup.f32_bits(0.5) == 0x3F000000 and setup.f32_bits(0.1) == 0x3DCCCCCD


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the set-up is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def assert_bitwise(got, want):
    for p in range(2):
        for x, y in zip(got[p], want[p]):
            assert x.shape == y.shape
            assert torch.equal(bits(x).cpu(), bits(y).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("preference", PREFERENCES)
@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("t_pad", [8, 96, 4097, 70_000, 1 << 21])
@pytest.mark.parametrize("stacked", [False, True])
def test_setup_kernel_is_bitwise_its_plain_version(cuda_device, stacked, t_pad, collapsed,
                                                   preference):
    rng = np.random.default_rng(t_pad)
    lead = (3,) if stacked else ()
    live = (np.array([t_pad, 0, t_pad * 2 // 3 + 1], np.int32) if stacked
            else np.int32(t_pad * 2 // 3 + 1))
    cfg = PageRankConfig(preference=preference)
    normal = to_torch(random_part(rng, t_pad, 2048, live, collapsed, lead), cuda_device)
    abnormal = to_torch(random_part(rng, t_pad // 2 + 1, 2048, live // 2, collapsed, lead),
                        cuda_device)
    want = setup.rank_setup_plain(normal, abnormal, cfg)
    before = setup.rank_setup.launches
    for _ in range(3):
        got = setup.rank_setup(normal, abnormal, cfg)
        torch.cuda.synchronize()
        assert_bitwise(got, want)
    assert setup.rank_setup.launches - before == 3


@pytest.mark.cuda
def test_setup_kernel_takes_a_count_past_the_pad(cuda_device):
    rng = np.random.default_rng(1)
    p = random_part(rng, 96, 300, 200, True)  # 200 live of a pad of 96: all live
    g = to_torch(p, cuda_device)
    cfg = PageRankConfig()
    assert_bitwise(setup.rank_setup(g, g, cfg), setup.rank_setup_plain(g, g, cfg))


@pytest.mark.cuda
def test_setup_kernel_on_the_three_pads_group(cuda_device):
    group = graph_from_numpy(stack_window_graphs(list(three_pad_windows())), cuda_device)
    for preference in PREFERENCES:
        cfg = PageRankConfig(preference=preference)
        got = setup.rank_setup(group.normal, group.abnormal, cfg)
        want = setup.rank_setup_plain(group.normal, group.abnormal, cfg)
        torch.cuda.synchronize()
        assert_bitwise(got, want)


@pytest.mark.cuda
def test_setup_kernel_refuses_what_it_does_not_take(cuda_device):
    g = to_torch(random_part(np.random.default_rng(2), 8, 5, 4, False), cuda_device)
    with pytest.raises(ValueError, match="bool"):
        setup.rank_setup(g, g._replace(op_present=g.op_present.to(torch.int32)),
                         PageRankConfig())
    with pytest.raises(ValueError, match="shapes"):
        setup.rank_setup(g, g._replace(n_ops=g.n_ops[None]), PageRankConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("preference", PREFERENCES)
@pytest.mark.parametrize("t_pad,form", [(TILE, "rows"), (8 * TILE, "rows"),
                                        (8 * TILE + 1, "grid")])
@pytest.mark.parametrize("stacked", [False, True])
def test_setup_kernel_at_its_form_edges_is_bitwise_plain_and_the_first_design(
        cuda_device, stacked, t_pad, form, preference):
    # Rows of one tile (a block a row), of C = 8 tiles (a cluster of 8)
    # and of C + 1 (the grid); the abnormal rows of one tile beside them.
    rng = np.random.default_rng(t_pad + len(preference))
    lead = (3,) if stacked else ()
    live = np.array([t_pad, 0, t_pad - 1], np.int32) if stacked else np.int32(t_pad - 5)
    cfg = PageRankConfig(preference=preference)
    for collapsed in (False, True):
        normal = to_torch(random_part(rng, t_pad, 2048, live, collapsed, lead), cuda_device)
        abnormal = to_torch(random_part(rng, 97, 2048, np.minimum(live, 97), collapsed, lead),
                            cuda_device)
        assert setup.setup_plan((t_pad, 97), 3 if stacked else 1, 2048,
                                setup.kernel_config(cuda_device)).form == form
        want = setup.rank_setup_plain(normal, abnormal, cfg)
        got = setup.rank_setup(normal, abnormal, cfg)
        first = setup.rank_setup(normal, abnormal, cfg, first_design=True)
        torch.cuda.synchronize()
        assert_bitwise(got, want)
        assert_bitwise(first, want)
