"""K8, the packed_blocked pair's own kernel, on the CPU: what its plain
version and its host-side layout hold, and the giant-window rank program
against the JAX package's packed_blocked.

* the flag: only a packed_blocked group launches K8's kernel; kind,
  packed and packed_bf16 groups keep the tile kernel; a blocked group
  runs f32 only and sizes its own scratch (the fwd partials, no
  counters);
* the plain version at giant-like sparsity (about 4 set bits per column,
  all-zero rows and column tiles): banded is bitwise unbanded, equal
  rows and equal columns in different tiles give equal bits;
* the fwd partials' row-major layout (``blocked_partials_plain``)
  against a numpy recount with integer operands, whose sums are exact;
* a small giant window (65,536 spans, a lowered budget so that auto
  resolves packed_blocked) ranks within rtol 1e-4 of JAX's packed_blocked
  rank program on the same graph, with the same tie-aware top-5 and
  n_iters.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
from microrank_tpu_torch.ops import pattern
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
    window_pattern_group,
)
from microrank_tpu_torch.testing import giant_window
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

GIANT_SPANS = 65_536
GIANT_OPS = 256
# The window's unpacked matrices (2 x 256 x 8,192 floats, 16 MiB) exceed
# this budget and its bitmaps (2 x 256 KiB) fit a quarter of it: auto
# resolves packed_blocked.
BUDGET = 4 << 20
BLOCK = 4 * GIANT_OPS * 2 * pattern.TILE_C  # the plain version's bands: two column tiles


def giant_like(rng, v, k, per_col=4):
    """uint8 0/1 [v, k]: ``per_col`` set bits in each column (giant's 4
    spans a trace), an all-zero row and an all-zero column tile."""
    m = np.zeros((v, k), np.uint8)
    rows = rng.integers(0, v, size=(per_col, k))
    m[rows, np.arange(k)] = 1
    m[v // 3] = 0
    m[:, pattern.TILE_C: 2 * pattern.TILE_C] = 0
    return m


def group_of(m, rng, band_bytes=None, blocked=True, weights=None):
    v, k = m.shape
    w = weights or [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)) for n in (k, v, v)]
    g = pattern.pattern_group([torch.from_numpy(np.packbits(m, axis=1))], [w[0]], [w[1]], [w[2]],
                              [k], band_bytes=band_bytes, blocked=blocked)
    return g, w


@pytest.fixture(scope="module")
def giant():
    """The small giant window's graph, resolved by auto at BUDGET."""
    gw = giant_window(n_spans=GIANT_SPANS, n_ops=GIANT_OPS)
    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="off", dense_budget_bytes=BUDGET))
    graph, names, kernel = TableRCA(cfg, device="cpu").prepare_rank(
        gw.table, None, gw.normal_codes, gw.abnormal_codes
    )
    return graph, names, kernel, cfg


@pytest.mark.parametrize("kernel,blocked", [
    ("packed", False), ("packed_bf16", False), ("packed_blocked", True),
])
def test_only_packed_blocked_groups_launch_the_blocked_kernel(giant, kernel, blocked):
    graph = giant[0]
    g = window_pattern_group(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    assert g.blocked is blocked
    for p in g.parts:
        v, k = p.pattern.shape[0], p.n_cols
        n_rt, n_ct = -(-v // pattern.TILE_R), -(-k // pattern.TILE_C)
        if blocked:
            groups = -(-n_rt // p.rows_per_block)
            assert groups == 1 or n_ct < pattern.BLOCKED_TARGET_BLOCKS
            assert p.part.numel() == n_rt * pattern.TILE_R * pattern.blocked_ld(n_ct) + (
                n_rt * n_ct * pattern.TILE_C if groups > 1 else 0)
            assert p.counters.numel() == 0
        else:
            assert p.part.numel() == n_rt * n_ct * (pattern.TILE_R + pattern.TILE_C)
            assert p.counters.numel() == n_rt + n_ct and p.rows_per_block == 0


def test_kind_groups_keep_the_tile_kernel(small_case):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph

    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, aux="kind", collapse="on")
    g = window_pattern_group(graph_from_numpy(host_subset(graph, "kind"), "cpu"), "kind")
    assert g.blocked is False
    assert device_subset(graph_from_numpy(host_subset(graph, "kind"), "cpu"),
                         "kind").pattern_group.blocked is False


def test_blocked_group_runs_f32_only():
    rng = np.random.default_rng(0)
    g, _ = group_of(giant_like(rng, 40, 700), rng)
    rv, sv = torch.ones(700), torch.ones(40)
    for precision in ("bf16", "int8"):
        with pytest.raises(ValueError, match="f32 only"):
            pattern.pattern_pair_group(g, [rv], [sv], precision)
    assert pattern.pattern_pair_group(g, [rv], [sv])[0][0].shape == (40,)


@pytest.mark.parametrize("band_tiles", [1, 2])
def test_banded_plain_pair_is_unbanded_at_giant_sparsity(band_tiles):
    # V = 300, K = 2,100: three row tiles, five column tiles (the last
    # ragged), about 4 of 300 bits set per column.
    rng = np.random.default_rng(band_tiles)
    v, k = 300, 2100
    m = giant_like(rng, v, k)
    whole, w = group_of(m, rng)
    banded, _ = group_of(m, rng, band_bytes=4 * v * pattern.TILE_C * band_tiles, weights=w)
    assert banded.parts[0].band_cols == band_tiles * pattern.TILE_C
    assert banded.parts[0].dense is None and whole.parts[0].band_cols == 0
    rv = torch.from_numpy(rng.uniform(0, 1, k).astype(np.float32))
    sv = torch.from_numpy(rng.uniform(0, 1, v).astype(np.float32))
    (a,), (b,) = (pattern.pattern_pair_group(g, [rv], [sv]) for g in (whole, banded))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    y_fwd, y_bwd, _ = a
    assert y_fwd[v // 3] == 0 and not y_bwd[pattern.TILE_C: 2 * pattern.TILE_C].any()


def test_equal_rows_and_columns_in_different_tiles_give_equal_bits():
    rng = np.random.default_rng(5)
    v, k = 300, 2100
    m = giant_like(rng, v, k)
    m[260] = m[3]                                 # rows in row tiles 0 and 2
    m[:, 2099] = m[:, 7]                          # columns in column tiles 0 and 4
    g, _ = group_of(m, rng, band_bytes=4 * v * pattern.TILE_C)
    rv = torch.from_numpy(rng.uniform(0, 1, k).astype(np.float32))
    sv = torch.from_numpy(rng.uniform(0, 1, v).astype(np.float32))
    ((y_fwd, y_bwd, _),) = pattern.pattern_pair_group(g, [rv], [sv])
    assert y_fwd[260] == y_fwd[3] and y_bwd[2099] == y_bwd[7]


@pytest.mark.parametrize("v,k,band", [(300, 2100, None), (129, 1537, 1), (40, 400, None)])
def test_fwd_partials_layout_against_a_numpy_recount(v, k, band):
    # Integer operands (rv * w_len in 0 .. 7): every sum is exact, so
    # numpy's recount in any order must give the same floats.
    rng = np.random.default_rng(v)
    m = giant_like(rng, v, k, per_col=20)
    w_len = rng.integers(0, 8, k).astype(np.float32)
    weights = [torch.from_numpy(w_len)] + [torch.ones(v), torch.ones(v)]
    g, _ = group_of(m, rng, None if band is None else 4 * v * pattern.TILE_C * band,
                    weights=weights)
    rv = torch.ones(k)
    (got,) = pattern.blocked_partials_plain(g, [rv])
    n_ct = -(-k // pattern.TILE_C)
    if n_ct == 1:
        assert got is None
        return
    ld = pattern.blocked_ld(n_ct)
    assert ld % 4 == 0 and ld - 4 < n_ct <= ld
    want = np.zeros((-(-v // pattern.TILE_R) * pattern.TILE_R, ld), np.float32)
    prod = m * w_len
    for j in range(n_ct):
        want[:v, j] = prod[:, j * pattern.TILE_C: (j + 1) * pattern.TILE_C].sum(1)
    np.testing.assert_array_equal(got.numpy(), want)
    # Folded left to right, the partials give the plain pair's y_fwd.
    ((y_fwd, _, _),) = pattern.pattern_pair_group(g, [rv], [torch.ones(v)])
    np.testing.assert_array_equal(y_fwd.numpy(), prod.sum(1).astype(np.float32))


@pytest.mark.parametrize("n_rt,n_ct,want", [
    (16, 512, 16), (16, 264, 16), (16, 263, 8), (24, 14, 2), (2, 2, 1), (1, 10, 1), (8, 1, 1),
])
def test_row_tiles_per_block(n_rt, n_ct, want):
    # About BLOCKED_TARGET_BLOCKS blocks a partition: a column tile's row
    # tiles are cut into groups only where column tiles are fewer.
    rpb = pattern.blocked_rows_per_block(n_rt, n_ct)
    assert rpb == want and 1 <= rpb <= n_rt
    groups = -(-n_rt // rpb)
    assert groups == 1 or n_ct * (groups - 1) < pattern.BLOCKED_TARGET_BLOCKS


def test_blocked_partials_plain_checks_its_vectors():
    rng = np.random.default_rng(1)
    g, _ = group_of(giant_like(rng, 40, 1100), rng)
    with pytest.raises(ValueError, match="one rv"):
        pattern.blocked_partials_plain(g, [torch.ones(1099)])


def test_giant_window_ranks_like_jax_packed_blocked(giant):
    graph, names, kernel, cfg = giant
    assert kernel == "packed_blocked"
    dg = jax.tree.map(jnp.asarray, graph)
    j = jax_tpu.rank_window_traced_device(
        dg, JaxPageRank(packed_block_bytes=BLOCK), JaxSpectrum(), None, "packed_blocked"
    )
    j_idx, j_sc, j_nv, j_res, j_it = (np.asarray(a) for a in j)
    tg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel, BLOCK)
    assert tg.pattern_group.blocked
    assert all(p.band_cols == 2 * pattern.TILE_C for p in tg.pattern_group.parts)
    t_idx, t_sc, t_nv, t_res, t_it = fetch_rank_outputs(rank_window_traced_core(
        tg, PageRankConfig(packed_block_bytes=BLOCK), cfg.spectrum, kernel
    ))
    assert (int(j_nv), int(j_it)) == (t_nv, t_it)
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:t_nv]), list(j_sc[:t_nv]), list(t_idx[:t_nv]), list(t_sc[:t_nv]),
        k=5, rtol=1e-4,
    )
    assert ok, why
    np.testing.assert_allclose(t_sc[:t_nv], j_sc[:t_nv], rtol=1e-4)
    np.testing.assert_allclose(t_res, j_res, rtol=1e-4, atol=1e-6)
