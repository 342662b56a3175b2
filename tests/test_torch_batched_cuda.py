"""Stacked windows on an NVIDIA GPU: the kernels of a step with a
window axis (K1 over a stacked work list, the pattern pair's window
grid dimension, K5's 2B partitions; K8 and its fold, ``quantize_amax``
and the int8 pair with per-window scales, K5's per-window scales, the
pcsr step over slabs of several widths under one padded width) bitwise
their plain versions over 50 launches, and the stacked rank program
(K18) on the card bitwise the per-window program on the card, one
launch of each kernel a step for the whole group, on every route.

Every test here needs the card and skips without one (a CUDA kernel has
no CPU mode). The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_batched_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import pattern, setup, spmv, step
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    host_subset,
    rank_window_traced_core,
    window_weights_full,
)
from microrank_tpu_torch.testing import giant_window

pytestmark = pytest.mark.cuda

# (kernel, kind_precision, build aux, collapse)
ROUTES = [
    ("kind", "f32", "kind", "on"),
    ("kind", "bf16", "kind", "on"),
    ("pallas", "f32", "auto", "off"),
    ("packed", "f32", "packed", "off"),
    ("packed_bf16", "f32", "packed", "off"),
]
ROUTE_IDS = [f"{k}-{p}" for k, p, _, _ in ROUTES]
# The routes a stacked program runs since K8, pcsr and int8 took a window
# axis (held by the program test only; their kernels by the tests below).
PROGRAM_ROUTES = ROUTES + [
    ("packed_blocked", "f32", "packed", "off"),
    ("pcsr", "f32", "pcsr", "off"),
    ("kind", "int8", "kind", "on"),
]
PROGRAM_IDS = [f"{k}-{p}" for k, p, _, _ in PROGRAM_ROUTES]
# Three windows of different sizes (trace axes), one vocab.
SPANS = ((40_000, 3), (64_000, 4), (24_000, 5))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def host_windows(aux, collapse, empty_normal=False):
    out = []
    for n_spans, seed in SPANS:
        gw = giant_window(n_spans=n_spans, n_ops=192, seed=seed)
        normal = np.zeros(0, np.int64) if empty_normal and seed == 4 else gw.normal_codes
        graph, _, _, _ = build_window_graph_from_table(
            gw.table, None, normal, gw.abnormal_codes, aux=aux, collapse=collapse
        )
        out.append(graph)
    return tuple(out)


def stacked(device, aux, collapse, kernel, **kw):
    graphs = host_windows(aux, collapse, **kw)
    host = stack_window_graphs([host_subset(g, kernel) for g in graphs])
    return device_subset(graph_from_numpy(host, device), kernel), graphs


def bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b):
    assert a.shape == b.shape
    assert torch.equal(bits(a).cpu(), bits(b).cpu())


def random_like(rng, shape, device):
    return torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_window_axis_kernels_are_bitwise_their_plain_versions(
    cuda_device, kernel, precision, aux, collapse
):
    card, _ = stacked(cuda_device, aux, collapse, kernel)
    host, _ = stacked("cpu", aux, collapse, kernel)
    rng = np.random.default_rng(1)
    b = card.normal.kind.shape[0]
    vs = [card.normal.cov_unique.shape[-1], card.abnormal.cov_unique.shape[-1]]
    ts = [card.normal.kind.shape[-1], card.abnormal.kind.shape[-1]]
    svs = [random_like(rng, (b, v), "cpu") for v in vs]
    rvs = [random_like(rng, (b, t), "cpu") for t in ts]
    before = (spmv.coo_spmv.launches, pattern.pattern_pair_group.launches)
    if kernel == "pallas":
        xs = (rvs[0], svs[0], rvs[1], svs[1])
        want = spmv.coo_spmv_group(host.spmv_group, xs)
        for _ in range(50):
            got = spmv.coo_spmv_group(card.spmv_group, [x.to(cuda_device) for x in xs])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert_bitwise(g, w)
        assert spmv.coo_spmv.launches - before[0] == 50
        return
    prec = "bf16" if kernel == "packed_bf16" else precision
    want = pattern.pattern_pair_group(host.pattern_group, rvs, svs, prec)
    want_ss = spmv.coo_spmv_group(
        host.spmv_group, [sv if x is None else x for sv, (_, _, x) in zip(svs, want)]
    )
    crvs, csvs = [x.to(cuda_device) for x in rvs], [x.to(cuda_device) for x in svs]
    for _ in range(50):
        got = pattern.pattern_pair_group(card.pattern_group, crvs, csvs, prec)
        got_ss = spmv.coo_spmv_group(
            card.spmv_group, [sv if x is None else x for sv, (_, _, x) in zip(csvs, got)]
        )
        torch.cuda.synchronize()
        for g3, w3 in zip(got, want):
            for g, w in zip(g3, w3):
                if w is not None:
                    assert_bitwise(g, w)
        for g, w in zip(got_ss, want_ss):
            assert_bitwise(g, w)
    assert pattern.pattern_pair_group.launches - before[1] == 50
    assert not any(p.counters.any() for p in card.pattern_group.parts)


@pytest.mark.parametrize("variant", ["default", "tol", "walk"])
def test_stacked_step_chain_of_50_is_bitwise_plain(cuda_device, variant):
    # "walk": a grid of 8 blocks for the 4 windows' 16 (vector, window)
    # pairs, each one unit: two rows of a window's 4 units, which walk
    # the other two windows.
    rng = np.random.default_rng(7)
    b, sizes = 4, [(3072, 96), (3072, 8)]
    prefs = [random_like(rng, (b, t), cuda_device) for _, t in sizes]
    carry = tuple(
        (random_like(rng, (b, v), cuda_device), random_like(rng, (b, t), cuda_device))
        for v, t in sizes
    )
    products = tuple(
        (random_like(rng, (b, v), cuda_device), random_like(rng, (b, v), cuda_device),
         random_like(rng, (b, t), cuda_device))
        for v, t in sizes
    )
    tol = 0.3 if variant == "tol" else None
    n_steps = 50
    outs = []
    for mode in ("kernel", "plain"):
        plan = step.step_plan(prefs, 0.01, 0.85, tol, True, step.step_scratch(cuda_device, b))
        residuals = torch.zeros((b, 2, n_steps), device=cuda_device)
        n_iters = running = None
        if tol is not None:
            n_iters = torch.zeros(b, dtype=torch.int32, device=cuda_device)
            running = torch.ones(b, dtype=torch.bool, device=cuda_device)
        win = step.StepWindow(plan, carry, residuals, n_iters, running, mode=mode,
                              max_blocks=8 if variant == "walk" else None)
        if mode == "kernel" and variant == "walk":
            assert win.grid == 8 and win.units > win.grid
        c = carry
        for i in range(n_steps):
            # Each step's products: the carry's own values mixed in, so
            # the chain moves.
            ys = tuple((y0 * c_[0], y1, y2 * c_[1]) for (y0, y1, y2), c_ in zip(products, c))
            c, _ = win.step(ys, i)
        torch.cuda.synchronize()
        outs.append((c, residuals, n_iters, plan.scratch))
    (c_k, r_k, n_k, s_k), (c_p, r_p, n_p, _) = outs
    for pk, pp in zip(c_k, c_p):
        for a, w in zip(pk, pp):
            assert_bitwise(a, w)
    assert_bitwise(r_k, r_p)
    assert not s_k.any()
    if tol is not None:
        assert torch.equal(n_k, n_p)


def launch_counts():
    return (spmv.coo_spmv.launches, pattern.pattern_pair_group.launches,
            step.power_step.launches, spmv.pcsr_spmv_group.launches,
            pattern.pattern_pair_group.blocked_launches,
            pattern.pattern_pair_group.fold_launches, pattern.quantize_scales.launches,
            setup.rank_setup.scale_launches)


@pytest.mark.parametrize("kernel,precision,aux,collapse", PROGRAM_ROUTES, ids=PROGRAM_IDS)
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_stacked_program_on_the_card_is_bitwise_each_window(
    cuda_device, kernel, precision, aux, collapse, tol
):
    cfg = PageRankConfig(kind_precision=precision, tol=tol)
    card, graphs = stacked(cuda_device, aux, collapse, kernel)
    before = launch_counts()
    got = rank_window_traced_core(card, cfg, SpectrumConfig(), kernel)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(launch_counts(), before))
    # One window's launches for the whole group: K1, the pair, K5, pcsr,
    # K8, its fold, no scale launch, and the set-up's launches that gave
    # the first step's int8 scales.
    n = cfg.iterations
    want = {
        "pallas": (n, 0, n, 0, 0, 0, 0, 0),
        "pcsr": (0, 0, n, n, 0, 0, 0, 0),
        "packed_blocked": (n, n, n, 0, n, n, 0, 0),
    }.get(kernel, (n, n, n, 0, 0, 0, 0, int(precision == "int8")))
    assert made == want
    for b, graph in enumerate(graphs):
        one = device_subset(graph_from_numpy(host_subset(graph, kernel), cuda_device), kernel)
        want = rank_window_traced_core(one, cfg, SpectrumConfig(), kernel)
        n = int(want[2])
        assert int(got[2][b]) == n and int(got[4][b]) == int(want[4])
        assert_bitwise(got[0][b][:n], want[0][:n])
        assert_bitwise(got[1][b][:n], want[1][:n])
        assert_bitwise(got[3][b], want[3])


def test_stacked_weights_through_the_plain_step_on_the_card(cuda_device, monkeypatch):
    card, _ = stacked(cuda_device, "kind", "on", "kind", empty_normal=True)
    cfg = PageRankConfig()
    got = window_weights_full(card, cfg, "kind")
    with monkeypatch.context() as m:
        m.setattr(torch_cuda, "StepWindow", functools.partial(step.StepWindow, mode="plain"))
        want = window_weights_full(card, cfg, "kind")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    assert torch.isnan(got[4][1]).any()  # the window whose normal partition is empty


def random_bitmaps(rng, shapes, v, k, density, dense_tile=False):
    """[B, v, ceil(k / 8)] bitmaps of windows of the given live (rows,
    cols) shapes, zero past each window's own; with ``dense_tile`` the
    first window's first row tile is all ones (K8's dense mode)."""
    out = np.zeros((len(shapes), v, (k + 7) // 8), np.uint8)
    for w, (rows, cols) in enumerate(shapes):
        cells = rng.random((rows, cols)) < density
        if dense_tile and w == 0:
            cells[:128] = True
        out[w, :rows] = np.packbits(np.pad(cells, ((0, 0), (0, k - cols))), axis=1)[:, : out.shape[2]]
    return torch.from_numpy(out)


def window_vectors(rng, shapes, n, axis):
    """[B, n] positive vectors, zero past each window's own extent."""
    out = np.zeros((len(shapes), n), np.float32)
    for w, shape in enumerate(shapes):
        out[w, : shape[axis]] = rng.uniform(0.01, 1.0, shape[axis])
    return torch.from_numpy(out)


# (V, K, density, live shapes of the windows): several row tiles in
# groups over few column tiles (bwd partials and the fold's bwd half),
# and many column tiles of one group.
BLOCKED_CASES = {
    "row_groups": (1000, 3000, 0.01, [(1000, 3000), (700, 2100), (930, 600)]),
    "column_tiles": (300, 140_000, 0.002, [(300, 140_000), (250, 90_000), (120, 139_000)]),
}


@pytest.mark.parametrize("n_windows", [2, 3])
@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_k8_with_a_window_axis_is_bitwise_its_plain_version(cuda_device, case, n_windows):
    v, k, density, shapes = BLOCKED_CASES[case]
    shapes = shapes[:n_windows]
    rng = np.random.default_rng(11)
    bits = [random_bitmaps(rng, shapes, v, k, density, dense_tile=True) for _ in range(2)]
    w_len = [window_vectors(rng, shapes, k, 1) for _ in range(2)]
    w_cov = [window_vectors(rng, shapes, v, 0) for _ in range(2)]
    w_out = [window_vectors(rng, shapes, v, 0) for _ in range(2)]
    rvs = [window_vectors(rng, shapes, k, 1) for _ in range(2)]
    svs = [window_vectors(rng, shapes, v, 0) for _ in range(2)]

    def group(dev, band=None):
        return pattern.pattern_group([b.to(dev) for b in bits], [x.to(dev) for x in w_len],
                                     [x.to(dev) for x in w_cov], [x.to(dev) for x in w_out],
                                     [k, k], band_bytes=band, blocked=True)

    card = group(cuda_device)
    assert card.windows == n_windows
    p = card.parts[0]
    assert p.rows_per_block < -(-v // pattern.TILE_R) or -(-k // pattern.TILE_C) >= 264
    # The plain version on the CPU in bands of 16 column tiles a window.
    want = pattern.pattern_pair_group(group("cpu", 16 * 4 * v * pattern.TILE_C), rvs, svs)
    crvs, csvs = [x.to(cuda_device) for x in rvs], [x.to(cuda_device) for x in svs]
    before = launch_counts()
    for _ in range(50):
        got = pattern.pattern_pair_group(card, crvs, csvs)
        torch.cuda.synchronize()
        for g3, w3 in zip(got, want):
            for g, w in zip(g3, w3):
                assert_bitwise(g, w)
    made = tuple(a - b for a, b in zip(launch_counts(), before))
    assert made[1] == made[4] == made[5] == 50
    # Each window alone, at the group's padded shape, gives its row.
    for w in range(n_windows):
        one = pattern.pattern_group(
            [b[w].to(cuda_device) for b in bits], [x[w].to(cuda_device) for x in w_len],
            [x[w].to(cuda_device) for x in w_cov], [x[w].to(cuda_device) for x in w_out],
            [k, k], blocked=True)
        alone = pattern.pattern_pair_group(one, [x[w] for x in crvs], [x[w] for x in csvs])
        for g3, a3 in zip(got, alone):
            for g, a in zip(g3, a3):
                assert_bitwise(g[w], a)


def test_int8_scales_and_pair_are_each_windows_own(cuda_device):
    # quantize_amax and the int8 pair on a stacked group of three windows
    # of unequal shapes: window 1 all zeros, window 2 with a NaN in one
    # operand; bitwise the plain versions (CPU) and over 50 launches.
    rng = np.random.default_rng(12)
    v, k = 300, 1100
    shapes = [(300, 1100), (200, 700), (260, 1000)]
    bits = [random_bitmaps(rng, shapes, v, k, 0.3) for _ in range(2)]
    w_len = [window_vectors(rng, shapes, k, 1) for _ in range(2)]
    w_cov = [window_vectors(rng, shapes, v, 0) for _ in range(2)]
    rvs = [window_vectors(rng, shapes, k, 1) for _ in range(2)]
    svs = [window_vectors(rng, shapes, v, 0) for _ in range(2)]
    for x in (*rvs, *svs):
        x[1] = 0.0
    # The NaN's row holds no set bit, so its quantized value (which the
    # plain version and the kernel cast differently) is never summed.
    svs[1][2, 5] = float("nan")
    bits[1][2, 5] = 0

    def group(dev):
        return pattern.pattern_group([b.to(dev) for b in bits], [x.to(dev) for x in w_len],
                                     [x.to(dev) for x in w_cov], [None, None], [k, k])

    host, card = group("cpu"), group(cuda_device)
    want_sc = pattern.quantize_scales(host, rvs, svs)
    want = pattern.pattern_pair_group(host, rvs, svs, "int8", want_sc)
    crvs, csvs = [x.to(cuda_device) for x in rvs], [x.to(cuda_device) for x in svs]
    before = pattern.quantize_scales.launches
    for _ in range(50):
        sc = pattern.quantize_scales(card, crvs, csvs)
        got = pattern.pattern_pair_group(card, crvs, csvs, "int8", sc)
        torch.cuda.synchronize()
        assert_bitwise(sc, want_sc)
        for g3, w3 in zip(got, want):
            for g, w in zip(g3[:2], w3[:2]):
                assert_bitwise(g, w)
    assert pattern.quantize_scales.launches - before == 50
    assert not card.amax_scratch.any()
    assert sc.shape == (3, 4) and sc[1].tolist() == [1.0] * 4 and sc[2, 3].item() == 1.0
    assert torch.isfinite(sc[0]).all() and (sc[0] != 1.0).all()


@pytest.mark.parametrize("tol", [None, 0.3])
def test_stacked_step_gives_each_windows_int8_scales(cuda_device, tol):
    # step_grid_group with a scale group: each step's [B, 4] scales from
    # each window's own carry, bitwise the plain step's, over 50 steps;
    # window 1's normal partition empty (its NaN stays in its scales).
    rng = np.random.default_rng(13)
    b, sizes = 3, [(700, 96), (700, 40)]
    prefs = [random_like(rng, (b, t), cuda_device) for _, t in sizes]
    carry = tuple(
        (random_like(rng, (b, v), cuda_device), random_like(rng, (b, t), cuda_device))
        for v, t in sizes
    )
    products = tuple(
        (random_like(rng, (b, v), cuda_device), random_like(rng, (b, v), cuda_device),
         random_like(rng, (b, t), cuda_device))
        for v, t in sizes
    )
    for y in products[0]:
        y[1] = 0.0
    prefs[0][1] = 0.0
    bits = [torch.from_numpy(rng.integers(0, 256, (b, v, (t + 7) // 8), dtype=np.uint8))
            for v, t in sizes]
    scale_group = pattern.pattern_group(
        [x.to(cuda_device) for x in bits], [random_like(rng, (b, t), cuda_device) for _, t in sizes],
        [random_like(rng, (b, v), cuda_device) for v, _ in sizes], [None, None],
        [t for _, t in sizes])
    outs = []
    for mode in ("kernel", "plain"):
        plan = step.step_plan(prefs, 0.01, 0.85, tol, True, step.step_scratch(cuda_device, b),
                              scale_group)
        residuals = torch.zeros((b, 2, 50), device=cuda_device)
        n_iters = running = None
        if tol is not None:
            n_iters = torch.zeros(b, dtype=torch.int32, device=cuda_device)
            running = torch.ones(b, dtype=torch.bool, device=cuda_device)
        win = step.StepWindow(plan, carry, residuals, n_iters, running, mode=mode)
        c, scales = carry, []
        for i in range(50):
            ys = tuple((y0 * c_[0], y1, y2 * c_[1]) for (y0, y1, y2), c_ in zip(products, c))
            c, sc = win.step(ys, i, want_scales=True)
            scales.append(sc.clone())
        torch.cuda.synchronize()
        outs.append((c, residuals, scales, plan.scratch))
    (c_k, r_k, s_k, scratch), (c_p, r_p, s_p, _) = outs
    for a, w in zip(s_k, s_p):
        assert a.shape == (b, 4)
        assert_bitwise(a, w)
    for pk, pp in zip(c_k, c_p):
        for a, w in zip(pk, pp):
            assert_bitwise(a, w)
    assert_bitwise(r_k, r_p)
    assert not scratch.any()
    assert torch.isnan(c_k[0][0][1]).all() and s_k[-1][1, :2].tolist() == [1.0, 1.0]


def ell_window(rng, n_rows, width, n_ops, long_rows=0):
    """One window's ELL slab (ops, vals) of ``width`` slots, live entries
    a prefix of each row; ``long_rows`` rows of most of the width."""
    lens = rng.integers(1, min(width, 8) + 1, n_rows)
    lens[:long_rows] = rng.integers(width // 2, width + 1, long_rows)
    ops = rng.integers(0, n_ops, (n_rows, width)).astype(np.int32)
    vals = rng.uniform(0.01, 1.0, (n_rows, width)).astype(np.float32)
    pad = np.arange(width) >= lens[:, None]
    ops[pad], vals[pad] = 0, 0.0
    return ops, vals


@pytest.mark.parametrize("n_windows", [2, 3])
def test_pcsr_step_over_slabs_of_widths_4_and_64_under_one_width(cuda_device, n_windows):
    # A stacked pcsr step whose windows' slabs are 4 and 64 slots wide
    # (and 4 again), padded to 64 and read in one mode (8 threads a row,
    # then a warp a row): every window's rows bitwise its own slab read
    # alone in its own mode, and bitwise the plain version.
    rng = np.random.default_rng(14)
    v, t = 300, 900
    own = [ell_window(rng, t, 4, v), ell_window(rng, t, 64, v, long_rows=40),
           ell_window(rng, t, 4, v)][:n_windows]
    width = 64
    ops = np.zeros((n_windows, t, width), np.int32)
    vals = np.zeros((n_windows, t, width), np.float32)
    for w, (o, x) in enumerate(own):
        ops[w, :, : o.shape[1]] = np.where(x != 0, o + w * v, 0)
        vals[w, :, : o.shape[1]] = x
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n_windows, v)).astype(np.float32))
    # The work list: a random stacked matrix of V rows over x.
    e = 2000
    rows = torch.from_numpy(rng.integers(0, v, (n_windows, e)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, v, (n_windows, e)).astype(np.int32))
    mvals = torch.from_numpy(rng.uniform(0.01, 1.0, (n_windows, e)).astype(np.float32))

    def group(dev, mode):
        lay = spmv.row_layout(rows.to(dev), cols.to(dev), mvals.to(dev), v, n_x=v)
        work = spmv.spmv_group([lay], (0,), (n_windows * v,), n_windows)
        slab = spmv.ell_part(torch.from_numpy(ops.reshape(-1, width)).to(dev),
                             torch.from_numpy(vals.reshape(-1, width)).to(dev), 0, mode)
        return spmv.PcsrGroup(work, (slab,), (0, 1))

    want = spmv.pcsr_spmv_group(group("cpu", spmv.ELL_SHORT), [x])
    for mode in (spmv.ELL_SHORT, spmv.ELL_WARP):
        card = group(cuda_device, mode)
        for _ in range(50):
            got = spmv.pcsr_spmv_group(card, [x.to(cuda_device)])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert_bitwise(g, w)
        for w, (o, xv) in enumerate(own):
            alone = spmv.ell_part(torch.from_numpy(o - 0).to(cuda_device),
                                  torch.from_numpy(xv).to(cuda_device), 0)
            single = spmv.PcsrGroup(
                spmv.spmv_group([spmv.row_layout(rows[w].to(cuda_device), cols[w].to(cuda_device),
                                                 mvals[w].to(cuda_device), v)], (0,), (v,)),
                (alone,), (0, 1))
            mine = spmv.pcsr_spmv_group(single, [x[w].to(cuda_device)])
            torch.cuda.synchronize()
            assert_bitwise(got[0][w], mine[0])
            assert_bitwise(got[1][w], mine[1])


# Two windows over one 13-op vocab whose trace pads are 8 and 96 (kind:
# 6 and 91 kind columns; packed: 6 and 2000 traces), as the replay's
# group of two mixes them.
TWO_PADS = ((24, 3), (8000, 4))
STAGES = ("setup", "pair", "k1", "k5", "weights", "spectrum", "topk")


@functools.lru_cache(maxsize=None)
def two_pad_windows(aux, collapse):
    out = []
    for n_spans, seed in TWO_PADS:
        gw = giant_window(n_spans=n_spans, n_ops=13, spans_per_trace=2, seed=seed)
        graph, _, _, _ = build_window_graph_from_table(
            gw.table, None, gw.normal_codes, gw.abnormal_codes, aux=aux, collapse=collapse
        )
        out.append(graph)
    return tuple(out)


def program_stages(dg, cfg, kernel):
    """A rank program's values stage by stage, as 1-d float32 tensors of
    window 0 (the whole program for one window): the set-up (preference
    and initial vectors), the first step's pattern pair, K1 and K5
    outputs, the final weights, the spectrum and the top-k."""
    win = torch_cuda.stacked_windows(dg) is not None

    def w0(t):
        return (t[0] if win else t).reshape(-1)

    precision = ("bf16" if kernel == "packed_bf16"
                 else cfg.kind_precision if kernel == "kind" else "f32")
    setup = [torch_cuda._partition_setup(g, a, cfg, kernel)
             for g, a in ((dg.normal, False), (dg.abnormal, True))]
    (pref_n, sv_n, rv_n), (pref_a, sv_a, rv_a) = setup
    out = {"setup": [w0(t) for part in setup for t in part]}
    scales = (pattern.quantize_scales(dg.pattern_group, (rv_n, rv_a), (sv_n, sv_a))
              if precision == "int8" else None)
    pair = pattern.pattern_pair_group(dg.pattern_group, (rv_n, rv_a), (sv_n, sv_a), precision,
                                      scales)
    out["pair"] = [w0(t) for f, b, _ in pair for t in (f, b)]
    ss = spmv.coo_spmv_group(dg.spmv_group, [sv if x is None else x
                                             for sv, (_, _, x) in zip((sv_n, sv_a), pair)])
    out["k1"] = [w0(t) for t in ss]
    plan = step.step_plan((pref_n, pref_a), cfg.call_weight, cfg.damping, None,
                          cfg.max_normalize_each_iter, dg.step_scratch)
    lead = (dg.normal.kind.shape[0],) if win else ()
    residuals = torch.zeros(lead + (2, 1), dtype=torch.float32, device=sv_n.device)
    new, _ = step.StepWindow(plan, ((sv_n, rv_n), (sv_a, rv_a)), residuals).step(
        ((pair[0][0], ss[0], pair[0][1]), (pair[1][0], ss[1], pair[1][1])), 0)
    out["k5"] = [w0(t) for part in new for t in part] + [w0(residuals)]
    n_weight, a_weight = window_weights_full(dg, cfg, kernel)[:2]
    out["weights"] = [w0(n_weight), w0(a_weight)]
    scores, _ = torch_cuda.window_spectrum(a_weight, dg.abnormal, n_weight, dg.normal,
                                           SpectrumConfig())
    out["spectrum"] = [w0(scores)]
    top_idx, top_scores, n_valid = torch_cuda._finish_topk(dg, n_weight, a_weight,
                                                           SpectrumConfig())
    n = int(w0(n_valid)[0])
    out["topk"] = [w0(top_idx)[:n], w0(top_scores)[:n]]
    return out


def first_stage_that_differs(group, own):
    """The first of STAGES whose values of window 0 differ in a bit (a
    padded axis compared over the window's own extent; past it the
    group's values must be 0, or -inf in the spectrum), or None."""
    for name in STAGES:
        for g, o in zip(group[name], own[name]):
            n = o.shape[0]
            pad = g[n:]
            if not torch.equal(bits(g[:n]).cpu(), bits(o).cpu()):
                return name
            if name not in ("topk",) and pad.numel() and not bool(
                    ((pad == 0) | (pad == float("-inf"))).all()):
                return name
    return None


@pytest.mark.parametrize("kernel,precision,aux,collapse", [
    ("kind", "f32", "kind", "on"),
    ("kind", "int8", "kind", "on"),
    ("packed_bf16", "f32", "packed", "off"),
], ids=["kind-f32", "kind-int8", "packed_bf16"])
def test_two_pad_group_is_bitwise_its_windows_own_programs(cuda_device, kernel, precision,
                                                           aux, collapse):
    # A stacked group whose windows' trace pads are 8 and 96, compared
    # with window 0's own program stage by stage: the first stage whose
    # bits differ is named (the set-up's and the finish's sums over the
    # padded axis are where a pad could move a bit).
    graphs = [host_subset(g, kernel) for g in two_pad_windows(aux, collapse)]
    assert graphs[0].normal.kind.shape[-1] == 8 and graphs[1].normal.kind.shape[-1] > 8
    cfg = PageRankConfig(kind_precision=precision)
    group = device_subset(graph_from_numpy(stack_window_graphs(graphs), cuda_device), kernel)
    own = device_subset(graph_from_numpy(graphs[0], cuda_device), kernel)
    stages_group = program_stages(group, cfg, kernel)
    stages_own = program_stages(own, cfg, kernel)
    torch.cuda.synchronize()
    assert first_stage_that_differs(stages_group, stages_own) is None
    got = rank_window_traced_core(group, cfg, SpectrumConfig(), kernel)
    for b, host in enumerate(graphs):
        dg = device_subset(graph_from_numpy(host, cuda_device), kernel)
        want = rank_window_traced_core(dg, cfg, SpectrumConfig(), kernel)
        n = int(want[2])
        assert int(got[2][b]) == n and int(got[4][b]) == int(want[4])
        for x, y in ((got[0][b][:n], want[0][:n]), (got[1][b][:n], want[1][:n]),
                     (got[3][b], want[3])):
            assert_bitwise(x, y)


# ------------------------------------------- K5's group kernel, in depth


def group_step_inputs(rng, b, sizes, device, empty=()):
    """[B, n] products, carry and preference vectors per partition of
    (V, T) = sizes[p]; partition p in ``empty`` all zeros, and window 1
    all zeros in the normal partition too (an empty partition inside a
    group)."""
    out = []
    for p, (v, t) in enumerate(sizes):
        vecs = [random_like(rng, (b, n), device) for n in (v, v, t, t, v, t)]
        for x in vecs:
            if p in empty:
                x.zero_()
            elif p == 0 and b > 1 and "window" in empty:
                x[1] = 0.0
        out.append(vecs)
    products = tuple(tuple(x[:3]) for x in out)
    carry = tuple((x[4], x[5]) for x in out)
    prefs = [x[3] for x in out]
    return products, carry, prefs


def group_chain(mode, plan, products, carry, n_steps, want_scales=False, max_blocks=None,
                hold=True, moving=None):
    """``n_steps`` steps of one StepWindow in ``mode`` (its grid capped at
    ``max_blocks``): each step's products the fixed ones, those of the
    windows in ``moving`` times the carry. Returns every step's carry and
    scales, the residual trace, n_iters and running as one tensor of
    int32 bits, and the window."""
    dev = carry[0][0].device
    b = carry[0][0].shape[0]
    residuals = torch.zeros((b, 2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if plan.tol is not None:
        n_iters = torch.zeros(b, dtype=torch.int32, device=dev)
        running = torch.ones(b, dtype=torch.bool, device=dev)
    win = step.StepWindow(plan, carry, residuals, n_iters, running, mode=mode,
                          max_blocks=max_blocks, hold=hold)
    out, c = [], carry
    for i in range(n_steps):
        ys = products
        if moving is not None:
            ys = tuple((torch.where(moving, y0 * sv, y0), y1, torch.where(moving, y2 * rv, y2))
                       for (y0, y1, y2), (sv, rv) in zip(products, c))
        c, scales = win.step(ys, i, want_scales and i + 1 < n_steps)
        out += [t.clone() for part in c for t in part]
        out += [] if scales is None else [scales.clone()]
    out = [torch.cat([t.reshape(-1) for t in out] + [residuals.reshape(-1)]).view(torch.int32)]
    if n_iters is not None:
        out += [n_iters, running.to(torch.int32)]
    return torch.cat(out), win


def group_scale_group(rng, b, sizes, device, weight=1.0):
    bitmaps = [torch.from_numpy(rng.integers(0, 256, (b, v, (t + 7) // 8), dtype=np.uint8))
               for v, t in sizes]
    return pattern.pattern_group(
        [x.to(device) for x in bitmaps],
        [random_like(rng, (b, t), device) * weight for _, t in sizes],
        [random_like(rng, (b, v), device) * weight for v, _ in sizes], [None, None],
        [t for _, t in sizes])


@pytest.mark.parametrize("b", [2, 6])
@pytest.mark.parametrize("variant", ["default", "tol", "empty", "no-normalize", "int8"])
def test_group_step_chain_of_50_is_bitwise_plain_and_pr13s(cuda_device, b, variant):
    # step_grid_group<S> over 50 launches on the card's own grid, at the
    # config-5 kind window's shapes, bitwise the plain step and PR 13's
    # kernel; "tol": the odd windows move and the even ones freeze after
    # their second step; "empty": one window's normal partition empty.
    rng = np.random.default_rng(30 + b)
    sizes = [(3072, 96), (3072, 8)]
    products, carry, prefs = group_step_inputs(
        rng, b, sizes, cuda_device, ("window",) if variant == "empty" else ())
    group = group_scale_group(rng, b, sizes, cuda_device) if variant == "int8" else None
    tol = {"tol": 1e-4, "empty": 1e-4}.get(variant)
    moving = (torch.arange(b, device=cuda_device) % 2 == 1)[:, None]
    chains, launches = {}, {}
    for mode in ("kernel", "group_units", "plain"):
        plan = step.step_plan(prefs, 0.01, 0.85, tol, variant != "no-normalize",
                              step.step_scratch(cuda_device, b), group)
        before = dict(step.power_step.by_kernel)
        chains[mode], win = group_chain(mode, plan, products, carry, 50, group is not None,
                                        moving=moving if variant == "tol" else None)
        torch.cuda.synchronize()
        assert not plan.scratch.any()
        launches[mode] = {k: v - before.get(k, 0) for k, v in step.power_step.by_kernel.items()
                          if v - before.get(k, 0)}
        if mode == "kernel":
            assert (win.per_thread, win.slots, win.units) == (1, 1, 26 * b)
    assert launches == {"kernel": {"step_grid_group<1>": 50},
                        "group_units": {"step_grid_units": 50}, "plain": {}}
    assert torch.equal(chains["kernel"], chains["plain"])
    assert torch.equal(chains["group_units"], chains["plain"])
    if variant == "tol":
        n_iters = chains["kernel"][-2 * b:-b]
        assert len(set(n_iters.tolist())) > 1  # the windows froze at different steps


@pytest.mark.parametrize("where,hold", [
    ("mid", True), ("at", True), ("past", True), ("past", False), ("far", True), ("walk", True),
])
@pytest.mark.parametrize("variant", ["default", "tol", "int8", "int8-subnormal-scale"])
def test_group_step_below_at_and_past_the_slots(cuda_device, where, hold, variant):
    # A grid of one block a (vector, window) puts a chosen number of
    # elements on each thread of a group of 3: 6 ("mid": 8 slots, the
    # carry in registers), the slots exactly ("at": the carry in shared
    # memory), twice and one more ("past": held in shared memory, or
    # recomputed with hold off), the slots plus the held maximum plus 5
    # ("far": 5 recomputed); "walk" a grid cap of 5 blocks: one row of a
    # window's 4 units, which walks the other two windows. Bitwise the
    # plain step and PR 13's kernel over 25 steps.
    kcfg = step.kernel_config(cuda_device)
    slots, b = kcfg.group_slots, 3
    per = {"mid": 6, "at": slots, "past": 2 * slots + 1, "far": slots + kcfg.held_max + 5,
           "walk": 3}[where]
    width = 256 * per - 37
    sizes = [(width // 3, width), (width // 2, width - 1)]
    max_blocks = 5 if where == "walk" else 4 * b
    rng = np.random.default_rng(22)
    products, carry, prefs = group_step_inputs(rng, b, sizes, cuda_device)
    group = None
    if variant.startswith("int8"):
        w = 1e-37 if variant == "int8-subnormal-scale" else 1.0
        group = group_scale_group(rng, b, sizes, cuda_device, w)
    tol = 1e-30 if variant == "tol" else None
    plan = step.step_plan(prefs, 0.01, 0.85, tol, True, step.step_scratch(cuda_device, b), group)
    got, win = group_chain("kernel", plan, products, carry, 25, group is not None, max_blocks,
                           hold)
    in_slots = {"mid": 8, "walk": 4}.get(where, slots)
    held = min(per - in_slots, kcfg.held_max) if hold and per > in_slots else 0
    assert (win.per_thread, win.slots, win.grid_plan.held) == (per, in_slots, held)
    assert win.units == 4 * b and win.grid == 4 * min(b, max_blocks // 4)
    old, _ = group_chain("group_units", plan, products, carry, 25, group is not None,
                         max_blocks)
    plain, _ = group_chain("plain", plan, products, carry, 25, group is not None)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(old, plain)
    assert not plan.scratch.any()


def test_refused_cooperative_group_launch_raises(cuda_device):
    # A group whose grid is past what the card holds resident: the card
    # refuses the cooperative launch, the step raises, nothing is
    # counted, and nothing else runs in its place.
    kcfg = step.kernel_config(cuda_device)
    b, width = 2, 256 * kcfg.max_blocks
    rng = np.random.default_rng(5)
    products, carry, prefs = group_step_inputs(rng, b, [(1000, width), (1000, width)],
                                               cuda_device)
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch(cuda_device, b))
    residuals = torch.zeros((b, 2, 2), device=cuda_device)
    win = step.StepWindow(plan, carry, residuals, max_blocks=8 * kcfg.max_blocks)
    assert win.grid > kcfg.max_blocks and win.grid_plan.kernel == step.KERNEL_GROUP
    before = (step.power_step.launches, dict(step.power_step.by_kernel))
    with pytest.raises(RuntimeError, match="launch failed"):
        win.step(products, 0)
    assert (step.power_step.launches, dict(step.power_step.by_kernel)) == before
    assert not residuals.any()
