"""K2 / K4, the pattern-pair kernels of the kind and packed power
iterations, held to the JAX package on the CPU (where the wrapper runs
its plain version, which repeats the kernel's order).

* the plain version's arithmetic: against an f64 product, in the
  kernel's tile order (checked in scalar float32 steps), bitwise equal
  outputs for equal rows and equal columns (also across tiles), bits
  decoded big-endian, int8 patterns packed to the same bitmap, rows
  padded to 16 bytes and inert;
* per product: the pattern pair plus the call-graph term (through K1)
  against JAX's ``_partition_setup`` matvecs, rtol 1e-6 — bf16 is held to
  the same rtol because both sides round the same f32 products to bf16
  and accumulate in f32;
* the rank program: ``rank_window_traced_core`` against JAX's for each
  kernel — f32 scores rtol 1e-5, residuals rtol 1e-4 / atol 1e-6; bf16
  scores rtol 5e-3 (the same residual bound held); identical top-1,
  ``n_valid`` and ``n_iters``;
* the auto policy: ``choose_kernel`` gives JAX's string, and raises
  where JAX picks a kernel this package has not ported (csr, coo).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import partition_case
from microrank_tpu.config import (
    PageRankConfig as JaxPageRank,
    SpectrumConfig as JaxSpectrum,
)
from microrank_tpu.graph import build_window_graph
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.ops import pattern
from microrank_tpu_torch.ops.spmv import coo_spmv_group
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    choose_kernel,
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
)
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

# (kernel, kind_precision, build aux, collapse)
KERNELS = [
    ("kind", "f32", "kind", "on"),
    ("kind", "bf16", "kind", "on"),
    ("kind", "f32", "kind", "off"),
    ("packed", "f32", "packed", "off"),
    ("packed_bf16", "f32", "packed", "off"),
    ("packed", "f32", "packed", "on"),
]
IDS = [f"{k}-{p}-{c}" for k, p, _, c in KERNELS]


def random_pattern(rng, v, k, density=0.3):
    return (rng.random((v, k)) < density).astype(np.uint8)


def plain_group(m01, bits, w_out=False, seed=0):
    """A one-partition group over a 0/1 matrix, with random weights."""
    rng = np.random.default_rng(seed)
    v, k = m01.shape
    pat = np.packbits(m01, axis=1) if bits else m01.astype(np.int8)
    vec = lambda n: torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))  # noqa: E731
    group = pattern.pattern_group(
        [torch.from_numpy(pat)], [vec(k)], [vec(v)], [vec(v) if w_out else None], [k], bits
    )
    return group, vec(k), vec(v)


@pytest.mark.parametrize("bits", [True, False])
@pytest.mark.parametrize("v,k", [(37, 13), (300, 700), (129, 8)])
def test_plain_pair_matches_f64_product(bits, v, k):
    rng = np.random.default_rng(v + k)
    m = random_pattern(rng, v, k)
    group, rv, sv = plain_group(m, bits, w_out=True, seed=k)
    (y_fwd, y_bwd, x_ss), = pattern.pattern_pair_group(group, [rv], [sv])
    p = group.parts[0]
    a = (rv * p.w_len).double().numpy()
    b = (sv * p.w_cov).double().numpy()
    np.testing.assert_allclose(y_fwd.numpy(), m @ a, rtol=1e-6)
    np.testing.assert_allclose(y_bwd.numpy(), b @ m, rtol=1e-6)
    np.testing.assert_array_equal(x_ss.numpy(), (sv * p.w_out).numpy())


def test_unpack_bits_is_big_endian_like_jax():
    rng = np.random.default_rng(3)
    m = random_pattern(rng, 9, 21, 0.5)
    packed = np.packbits(m, axis=1)
    ours = pattern.unpack_bits(torch.from_numpy(packed), 21)
    np.testing.assert_array_equal(ours.numpy(), m.astype(np.float32))
    theirs = np.asarray(jax_tpu.unpack_bits(jnp.asarray(packed), 21))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # Column t is bit 7 - (t & 7) of byte t >> 3.
    one = np.zeros((1, 2), np.uint8)
    one[0, 1] = 0b01000000
    assert pattern.unpack_bits(torch.from_numpy(one), 16)[0].nonzero().tolist() == [[9]]


@pytest.mark.parametrize("bits", [True, False])
def test_equal_rows_and_columns_give_equal_bits(bits):
    rng = np.random.default_rng(11)
    base = random_pattern(rng, 400, 300, 0.4)
    # Rows 0, 150 and 399 equal; columns 5, 77 and 290 equal.
    base[150] = base[0]
    base[399] = base[0]
    base[:, 77] = base[:, 5]
    base[:, 290] = base[:, 5]
    group, rv, sv = plain_group(base, bits, seed=2)
    (y_fwd, y_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv], bf16=False)
    assert y_fwd[0] == y_fwd[150] == y_fwd[399]
    assert y_bwd[5] == y_bwd[77] == y_bwd[290]
    (z_fwd, z_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv], bf16=True)
    assert z_fwd[0] == z_fwd[150] == z_fwd[399]
    assert z_bwd[5] == z_bwd[77] == z_bwd[290]


def test_padding_is_inert():
    # Columns past n_cols in the last byte, and rows past n_ops, add
    # nothing; y_bwd has exactly n_cols entries.
    rng = np.random.default_rng(5)
    m = random_pattern(rng, 20, 16, 0.5)
    m[:, 11:] = 1  # set bits beyond n_cols = 11
    packed = torch.from_numpy(np.packbits(m, axis=1))
    w = lambda n: torch.ones(n)  # noqa: E731
    group = pattern.pattern_group([packed], [w(11)], [w(20)], [None], [11], True)
    rv = torch.ones(11)
    sv = torch.cat([torch.ones(12), torch.zeros(8)])  # rows 12.. are padding
    (y_fwd, y_bwd, x_ss), = pattern.pattern_pair_group(group, [rv], [sv])
    assert x_ss is None and y_bwd.shape == (11,)
    np.testing.assert_array_equal(y_fwd.numpy(), m[:, :11].sum(1).astype(np.float32))
    np.testing.assert_array_equal(y_bwd.numpy(), m[:12, :11].sum(0).astype(np.float32))


@pytest.mark.parametrize("bits", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_equal_rows_and_columns_in_different_tiles_give_equal_bits(bits, bf16):
    # 300 x 1100 spans three row tiles and three column tiles: rows 0, 150
    # and 299 lie in different row tiles, columns 5, 600 and 1090 in
    # different column tiles, so each sum crosses the tile folds.
    assert pattern.TILE_R < 150 < 2 * pattern.TILE_R < 299
    assert pattern.TILE_C < 600 < 2 * pattern.TILE_C < 1090
    rng = np.random.default_rng(12)
    base = random_pattern(rng, 300, 1100, 0.4)
    base[150] = base[0]
    base[299] = base[0]
    base[:, 600] = base[:, 5]
    base[:, 1090] = base[:, 5]
    group, rv, sv = plain_group(base, bits, seed=4)
    (y_fwd, y_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv], bf16=bf16)
    assert y_fwd[0] == y_fwd[150] == y_fwd[299]
    assert y_bwd[5] == y_bwd[600] == y_bwd[1090]


@pytest.mark.parametrize("v,k", [(37, 13), (300, 1100)])
def test_int8_and_bitmap_groups_give_equal_bits(v, k):
    # pattern_group packs an int8 pattern (nonzero -> 1) into the kernel's
    # one layout: only the representation changes.
    rng = np.random.default_rng(v * k)
    m = random_pattern(rng, v, k, 0.35)
    i8 = m.astype(np.int8)
    i8[m == 1] = rng.integers(1, 128, int(m.sum()))  # any nonzero byte is a 1
    g_bits, rv, sv = plain_group(m, True, w_out=True, seed=9)
    g_i8, _, _ = plain_group(i8, False, w_out=True, seed=9)
    assert torch.equal(g_i8.parts[0].pattern, g_bits.parts[0].pattern)
    for bf16 in (False, True):
        (a,), (b,) = (pattern.pattern_pair_group(g, [rv], [sv], bf16) for g in (g_bits, g_i8))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("bits", [True, False])
@pytest.mark.parametrize("k", [448, 100])  # rows of 56 and 13 bytes
def test_rows_are_padded_to_16_bytes_and_inert(bits, k):
    rng = np.random.default_rng(k)
    v = 140
    m = random_pattern(rng, v, k, 0.5)
    if bits:
        pat = np.packbits(m, axis=1)
        pat[:, -1] |= np.uint8(0xFF >> (k % 8)) if k % 8 else 0  # set bits past n_cols
    else:
        pat = np.concatenate([m, np.ones((v, 5), np.uint8)], 1).astype(np.int8)
    w = lambda n: torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))  # noqa: E731
    w_len, w_cov, rv, sv = w(k), w(v), w(k), w(v)
    group = pattern.pattern_group([torch.from_numpy(pat)], [w_len], [w_cov], [None], [k], bits)
    stored = group.parts[0].pattern
    n_bytes = -(-k // 8)
    assert stored.shape == (v, -(-n_bytes // 16) * 16) and stored.shape[1] % pattern.ROW_ALIGN == 0
    assert not stored[:, n_bytes:].any()
    (y_fwd, y_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv])
    assert y_bwd.shape == (k,)
    a = (rv * w_len).double().numpy()
    b = (sv * w_cov).double().numpy()
    np.testing.assert_allclose(y_fwd.numpy(), m @ a, rtol=1e-6)
    np.testing.assert_allclose(y_bwd.numpy(), b @ m, rtol=1e-6)


@pytest.mark.parametrize("extra", [0, 1])
def test_plain_order_at_one_tile_and_one_past(extra):
    # Exactly one tile, and one tile plus a row and a column (a second
    # row tile and column tile of one row / one column each).
    v, k = pattern.TILE_R + extra, pattern.TILE_C + extra
    rng = np.random.default_rng(20 + extra)
    m = random_pattern(rng, v, k, 0.5)
    a = rng.uniform(0.0, 1.0, k).astype(np.float32)
    b = rng.uniform(0.0, 1.0, v).astype(np.float32)
    mt = torch.from_numpy(m.astype(np.float32))
    y_fwd = pattern.fwd_plain(mt, torch.from_numpy(a))
    y_bwd = pattern.bwd_plain(mt, torch.from_numpy(b))
    np.testing.assert_allclose(y_fwd.numpy(), m @ a.astype(np.float64), rtol=1e-6)
    np.testing.assert_allclose(y_bwd.numpy(), b.astype(np.float64) @ m, rtol=1e-6)
    # The kernel's order, written out in float32 scalar steps: lane sums
    # of LANE_COLS columns, the shuffle tree, the column-tile fold; rows
    # in order per row tile, the row-tile fold.
    f32 = np.float32
    lanes = pattern.TILE_C // pattern.LANE_COLS
    for r in (0, v - 1):
        y = f32(0)
        for t0 in range(0, k, pattern.TILE_C):
            acc = [f32(0)] * lanes
            for l in range(lanes):
                for c in range(t0 + l * pattern.LANE_COLS, t0 + (l + 1) * pattern.LANE_COLS):
                    acc[l] = f32(acc[l] + (a[c] if c < k and m[r, c] else f32(0)))
            off = lanes // 2
            while off:
                acc = [f32(acc[i] + acc[i + off]) for i in range(off)]
                off //= 2
            y = f32(y + acc[0])
        assert y_fwd[r].item() == y
    for c in (0, k - 1):
        y = f32(0)
        for r0 in range(0, v, pattern.TILE_R):
            acc = f32(0)
            for r in range(r0, min(v, r0 + pattern.TILE_R)):
                acc = f32(acc + (b[r] if m[r, c] else f32(0)))
            y = f32(y + acc)
        assert y_bwd[c].item() == y


def test_group_checks_its_inputs():
    pat = torch.zeros((4, 2), dtype=torch.uint8)
    ones = torch.ones
    with pytest.raises(TypeError, match="int8"):
        pattern.pattern_group([pat], [ones(9)], [ones(4)], [None], [9], False)
    with pytest.raises(ValueError, match="fewer than"):
        pattern.pattern_group([pat], [ones(17)], [ones(4)], [None], [17], True)
    with pytest.raises(ValueError, match="weight vectors"):
        pattern.pattern_group([pat], [ones(9)], [ones(5)], [None], [9], True)
    group = pattern.pattern_group([pat], [ones(9)], [ones(4)], [None], [9], True)
    with pytest.raises(ValueError, match="rv must hold 9"):
        pattern.pattern_pair_group(group, [ones(8)], [ones(4)])
    with pytest.raises(ValueError, match="unsupported device"):
        pattern.pattern_pair_group(group, [ones(9, device="meta")], [ones(4)])


def jax_graph(case, aux, collapse):
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse)
    return graph, names


@pytest.mark.parametrize("kernel,precision,aux,collapse", KERNELS, ids=IDS)
def test_products_match_jax_partition_setup(kernel, precision, aux, collapse, small_case):
    graph, _ = jax_graph(small_case, aux, collapse)
    cfg = PageRankConfig(kind_precision=precision)
    jcfg = JaxPageRank(kind_precision=precision)
    tg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    rng = np.random.default_rng(0)
    rvs, svs, want = [], [], []
    for part, anomaly in (("normal", False), ("abnormal", True)):
        g = getattr(graph, part)
        jg = jax.tree.map(jnp.asarray, g)
        mv = jax_tpu._partition_setup(jg, anomaly, jcfg, None, kernel)[0]
        sv = rng.uniform(0.0, 1.0, g.cov_unique.shape[0]).astype(np.float32)
        rv = rng.uniform(0.0, 1.0, g.kind.shape[0]).astype(np.float32)
        want.append([np.asarray(y) for y in mv(jnp.asarray(sv), jnp.asarray(rv))])
        rvs.append(torch.from_numpy(rv))
        svs.append(torch.from_numpy(sv))
    bf16 = kernel == "packed_bf16" or precision == "bf16"
    pairs = pattern.pattern_pair_group(tg.pattern_group, rvs, svs, bf16)
    xs = [sv if x is None else x for sv, (_, _, x) in zip(svs, pairs)]
    ss = coo_spmv_group(tg.spmv_group, xs)
    alpha = torch.tensor(cfg.call_weight, dtype=torch.float32)
    for (y_fwd, y_bwd, _), y_ss, (j_s, j_r) in zip(pairs, ss, want):
        np.testing.assert_allclose((y_fwd + alpha * y_ss).numpy(), j_s, rtol=1e-6)
        np.testing.assert_allclose(y_bwd.numpy(), j_r, rtol=1e-6)


def rank_both(graph, kernel, precision):
    dg = jax.tree.map(jnp.asarray, graph)
    j = jax_tpu.rank_window_traced_device(
        dg, JaxPageRank(kind_precision=precision), JaxSpectrum(), None, kernel
    )
    j = tuple(np.asarray(a) for a in j)
    tg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    t = fetch_rank_outputs(rank_window_traced_core(
        tg, PageRankConfig(kind_precision=precision), SpectrumConfig(), kernel
    ))
    return j, t


@pytest.mark.parametrize("kernel,precision,aux,collapse", KERNELS, ids=IDS)
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_rank_program_matches_jax(kernel, precision, aux, collapse, case_name, request):
    case = request.getfixturevalue(case_name)
    graph, names = jax_graph(case, aux, collapse)
    j, t = rank_both(graph, kernel, precision)
    rtol = 5e-3 if "bf16" in (kernel[-4:], precision) else 1e-5
    j_idx, j_sc, j_nv, j_res, j_it = j
    t_idx, t_sc, t_nv, t_res, t_it = t
    assert (int(j_nv), int(j_it)) == (t_nv, t_it)
    assert int(j_idx[0]) == int(t_idx[0])
    assert names[t_idx[0]] == case.fault_pod_op
    n = t_nv
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:n]), list(j_sc[:n]), list(t_idx[:n]), list(t_sc[:n]), k=n, rtol=rtol,
    )
    assert ok, why
    np.testing.assert_allclose(t_sc[:n], j_sc[:n], rtol=rtol)
    np.testing.assert_allclose(t_res, j_res, rtol=1e-4, atol=1e-6)


def test_rank_program_with_tol_matches_jax(small_case):
    graph, _ = jax_graph(small_case, "kind", "on")
    dg = jax.tree.map(jnp.asarray, graph)
    pr = dict(tol=1e-4, iterations=60)
    j = jax_tpu.rank_window_traced_device(dg, JaxPageRank(**pr), JaxSpectrum(), None, "kind")
    tg = device_subset(graph_from_numpy(host_subset(graph, "kind"), "cpu"), "kind")
    t = fetch_rank_outputs(rank_window_traced_core(tg, PageRankConfig(**pr), SpectrumConfig(), "kind"))
    assert 0 < t[4] < 60 and int(j[4]) == t[4]
    np.testing.assert_allclose(t[3], np.asarray(j[3]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("aux,collapse", [("kind", "on"), ("packed", "off"), ("auto", "on")])
@pytest.mark.parametrize("prefer_bf16", [True, False])
def test_choose_kernel_matches_jax(aux, collapse, prefer_bf16, small_case):
    graph, _ = jax_graph(small_case, aux, collapse)
    want = jax_tpu.choose_kernel(graph, None, prefer_bf16)
    assert choose_kernel(graph, None, prefer_bf16) == want
    assert choose_kernel(graph_from_numpy(graph, "cpu"), None, prefer_bf16) == want


def test_choose_kernel_raises_where_jax_picks_unported(small_case):
    # Past the dense budget the port picks what JAX picks: packed_blocked
    # over bitmaps whose unpacked matrices exceed the budget, pcsr over
    # the partition-centric views a tiny budget gives at build time. Only
    # csr (and coo), which this package has not ported, still raise.
    graph, _ = jax_graph(small_case, "packed", "off")
    assert jax_tpu.choose_kernel(graph, 1, True) == "packed_blocked"
    assert choose_kernel(graph, 1, True) == "packed_blocked"
    nrm, abn = partition_case(small_case)
    tiny, _, _, _ = build_window_graph(
        small_case.abnormal, nrm, abn, aux="auto", dense_budget_bytes=64
    )
    assert jax_tpu.choose_kernel(tiny, 64) == "pcsr"
    assert choose_kernel(tiny, 64) == "pcsr"
    csr, _ = jax_graph(small_case, "csr", "off")
    assert jax_tpu.choose_kernel(csr) == "csr"
    with pytest.raises(NotImplementedError, match="csr.*ROADMAP"):
        choose_kernel(csr)


@pytest.mark.parametrize("kernel", ["kind", "packed", "packed_bf16", "packed_blocked", "pcsr"])
def test_host_subset_drops_what_jax_drops(kernel, small_case):
    aux = {"kind": "kind", "pcsr": "pcsr"}.get(kernel, "packed")
    graph, _ = jax_graph(small_case, aux, "on")
    ours = host_subset(graph, kernel)
    theirs = jax_tpu.device_subset(graph, kernel)
    for part in ("normal", "abnormal"):
        for f in ours.normal._fields:
            a = np.asarray(getattr(getattr(ours, part), f))
            b = np.asarray(getattr(getattr(theirs, part), f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
    assert host_subset(graph, "pallas") is graph


def test_kernels_refuse_a_graph_without_their_views(small_case):
    graph, _ = jax_graph(small_case, "packed", "off")
    tg = graph_from_numpy(graph, "cpu")
    with pytest.raises(ValueError, match="kind views"):
        device_subset(tg, "kind")
    with pytest.raises(ValueError, match="resolved per window"):
        device_subset(tg, "auto")


@pytest.mark.parametrize("aux,collapse", [("kind", "on"), ("packed", "off")])
def test_graph_from_numpy_carries_the_views(aux, collapse, small_case):
    graph, _ = jax_graph(small_case, aux, collapse)
    tg = graph_from_numpy(graph, "cpu")
    for part in ("normal", "abnormal"):
        src, dst = getattr(graph, part), getattr(tg, part)
        for f in ("cov_bits", "ss_bits", "cov_i8", "ss_indptr", "inv_outdeg"):
            a, b = np.asarray(getattr(src, f)), getattr(dst, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert src.cov_bits.shape[-1] > 0
        assert (src.cov_i8.shape[-1] > 0) == (aux == "kind")
