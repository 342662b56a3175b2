"""K10, the csr route in JAX's order of sums (``ops/scan.py``,
``csrc/csr_scan.cu``).

* ``compensated_scan`` is bitwise JAX's ``compensated_cumsum``
  (``lax.associative_scan`` with the TwoSum combine) on the same inputs,
  at lengths across the kernel's block edges and on a stacked axis;
* the kernel's block decomposition (up-sweep to block totals, one block
  at the top, down-sweep from two scanned totals), repeated here at small
  block sizes to reach every level, is bitwise the recursion;
* scan_step's decomposition, modelled here as the kernel computes it
  (a warp's 64 leaves by levels 1-6, a tile's 32 warp nodes by levels
  7-11, the tile totals of a segment scanned whole by the same split,
  the down-sweeps with the scan before each subtree, and the scan read
  only at the row offsets of each tile's run of marks), is bitwise
  ``compensated_scan`` and every row sum of the plain version, at
  lengths across the 2,048 and 2,048^2 edges, at smaller warp and block
  splits, and on stacked groups; its host plan and tables too;
* every row sum of the route (``csr_scan_spmv`` over
  ``window_scan_group``) is bitwise JAX's ``csr_rowsum`` of the same
  entry products (products given as an input: on the CPU, XLA contracts
  a multiply it computes into the scan's first adds, see ROADMAP.md
  Faults), one window and a stacked group;
* a live column outside its x raises, on the device check and on the
  host one;
* on the card (``-m cuda``): scan_step and the level passes bitwise the
  plain version at every depth of levels, one window and stacked.

JAX is imported inside the tests that compare with it, so the card
tests run with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_csr_scan.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from microrank_tpu_torch.ops import scan
from microrank_tpu_torch.ops.scan import compensated_scan, csr_scan_spmv, scan_group


def jax_scan(x):
    import jax

    from microrank_tpu.ops.segment import compensated_cumsum

    hi, lo = jax.jit(lambda v: compensated_cumsum(v, axis=-1))(x)
    return np.asarray(hi), np.asarray(lo)


def jax_rowsums(prod, indptr):
    """JAX's ``csr_rowsum`` of one window (``jax_tpu.py:671-700``, no
    shards) over given products."""
    import jax
    import jax.numpy as jnp

    from microrank_tpu.ops.segment import compensated_cumsum

    def rowsum(p, ip):
        hi, lo = compensated_cumsum(p)
        z = jnp.zeros((1,), jnp.float32)
        hi, lo = jnp.concatenate([z, hi]), jnp.concatenate([z, lo])
        a, b = ip[:-1], ip[1:]
        return (jnp.take(hi, b) - jnp.take(hi, a)) + (jnp.take(lo, b) - jnp.take(lo, a))

    return np.asarray(jax.jit(rowsum)(prod, indptr))


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 2047, 2048, 2049, 6001])
def test_compensated_scan_is_jaxs(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    hi, lo = compensated_scan(torch.from_numpy(x))
    jh, jl = jax_scan(x)
    assert bits(hi) == bits(jh) and bits(lo) == bits(jl)


def test_compensated_scan_is_jaxs_on_a_stacked_axis():
    x = np.random.default_rng(5).random((3, 1001)).astype(np.float32)
    hi, lo = compensated_scan(torch.from_numpy(x))
    jh, jl = jax_scan(x)
    assert bits(hi) == bits(jh) and bits(lo) == bits(jl)


def blocked_scan(x: torch.Tensor, log: int):
    """The kernel's design (csrc/csr_scan.cu) at blocks of 2**log
    entries: ``up`` reduces each block by the recursion's pairs to its
    total, the totals are scanned the same way (the top: one block), and
    ``down`` runs each block's down-sweep from the scan at its top and
    the previous block's. Returns (hi, lo)."""
    block = 1 << log
    comb = scan._comb

    def tree(h, l):
        levels = [(h, l)]
        for _ in range(log):
            h, l = comb((h[..., 0::2], l[..., 0::2]), (h[..., 1::2], l[..., 1::2]))
            levels.append((h, l))
        return levels

    def rec(h, l):
        n = h.shape[0]
        nb = -(-n // block)
        pad = nb * block - n
        h = torch.cat([h, torch.zeros(pad)]).view(nb, block)
        l = torch.cat([l, torch.zeros(pad)]).view(nb, block)
        levels = tree(h, l)
        if nb == 1:
            top = levels[-1]
        else:
            top = rec(levels[-1][0][:, 0].clone(), levels[-1][1][:, 0].clone())
            top = (top[0][:, None], top[1][:, None])
        prev_h = torch.cat([torch.zeros(1), top[0][:-1, 0]])
        prev_l = torch.cat([torch.zeros(1), top[1][:-1, 0]])
        scan_h, scan_l = top
        for v in range(log - 1, -1, -1):
            rh, rl = levels[v]
            width = block >> v
            out_h, out_l = rh.clone(), rl.clone()
            out_h[:, 1::2], out_l[:, 1::2] = scan_h, scan_l
            if width > 2:
                eh, el = comb((scan_h[:, :-1], scan_l[:, :-1]), (rh[:, 2::2], rl[:, 2::2]))
                out_h[:, 2::2], out_l[:, 2::2] = eh, el
            fh, fl = comb((prev_h, prev_l), (rh[:, 0], rl[:, 0]))
            out_h[1:, 0], out_l[1:, 0] = fh[1:], fl[1:]
            scan_h, scan_l = out_h, out_l
        return scan_h.reshape(-1)[:n], scan_l.reshape(-1)[:n]

    return rec(x, torch.zeros_like(x))


@pytest.mark.parametrize("log,n", [(1, 2), (1, 9), (2, 70), (3, 8), (3, 9), (3, 64), (3, 65),
                                   (3, 513), (3, 4097), (11, 5000)])
def test_the_kernels_block_design_is_the_recursion(log, n):
    x = torch.from_numpy(np.random.default_rng(n + log).random(n).astype(np.float32))
    want = compensated_scan(x)
    got = blocked_scan(x, log)
    assert bits(got[0]) == bits(want[0]) and bits(got[1]) == bits(want[1])


def _up(h, l, n_levels):
    """The recursion's levels over the last axis (2**n_levels nodes):
    [level 0, ..., the total]."""
    out = [(h, l)]
    for _ in range(n_levels):
        h, l = scan._comb((h[..., 0::2], l[..., 0::2]), (h[..., 1::2], l[..., 1::2]))
        out.append((h, l))
    return out


def _down(levels, top, prev, first):
    """The down-sweep of a subtree (``levels`` from ``_up``) from the
    scan at its root ``top`` [...], the scan before it ``prev`` [...] and
    ``first`` [...] (no prev): the scan at its level-0 nodes. Node j:
    odd, its parent's scan; even past 0, comb(the scan at its parent's
    left neighbour, its value); 0, comb(prev, its value), or its value
    where first (csrc ``warp_down``, ``leaf_scans``)."""
    sh, sl = top[0][..., None], top[1][..., None]
    for v in range(len(levels) - 2, -1, -1):
        rh, rl = levels[v]
        oh, ol = rh.clone(), rl.clone()
        oh[..., 1::2], ol[..., 1::2] = sh, sl
        if rh.shape[-1] > 2:
            eh, el = scan._comb((sh[..., :-1], sl[..., :-1]), (rh[..., 2::2], rl[..., 2::2]))
            oh[..., 2::2], ol[..., 2::2] = eh, el
        ch, cl = scan._comb(prev, (rh[..., 0], rl[..., 0]))
        oh[..., 0] = torch.where(first, rh[..., 0], ch)
        ol[..., 0] = torch.where(first, rl[..., 0], cl)
        sh, sl = oh, ol
    return sh, sl


def _split_scan(h, l, wlog, blog, top, prev, first):
    """A tile's (or the top's) leaves [..., 2**(wlog + blog)] scanned as
    scan_step does: each warp's 2**wlog leaves to its node, the block's
    2**blog warp nodes to the root; down from ``top`` over the block's
    levels, then each warp's from the scan at its node and the one
    before (the block's ``prev`` for warp 0)."""
    lead = h.shape[:-1]
    w = 1 << blog
    warp_levels = _up(h.reshape(*lead, w, -1), l.reshape(*lead, w, -1), wlog)
    wh, wl = warp_levels[-1][0][..., 0], warp_levels[-1][1][..., 0]
    block_levels = _up(wh, wl, blog)
    root = (block_levels[-1][0][..., 0], block_levels[-1][1][..., 0])
    if top is None:  # the top scan: the root's scan is the root
        top = root
    s6 = _down(block_levels, top, prev, first)
    wprev = (torch.cat([prev[0][..., None], s6[0][..., :-1]], -1),
             torch.cat([prev[1][..., None], s6[1][..., :-1]], -1))
    wfirst = torch.zeros(lead + (w,), dtype=torch.bool)
    wfirst[..., 0] = first
    sh, sl = _down(warp_levels, s6, wprev, wfirst)
    return sh.reshape(*lead, -1), sl.reshape(*lead, -1), root


def step_model_scan(x, wlog=6, blog=5):
    """scan_step's scan of one segment's products ``x`` [n], at tiles of
    2**(wlog + blog) leaves (the kernel's: 6, 5), at most that many
    tiles: phase 1 (each tile's total), phase 2's top scan of the tile
    totals (one split scan, redundant in every block that needs it) and
    each tile's down-sweep. Returns (hi, lo)."""
    tile = 1 << (wlog + blog)
    n = x.shape[0]
    nt = max(1, -(-n // tile))
    assert nt <= tile, "past tile^2 entries scan_step does not take the segment"
    h = torch.cat([x, torch.zeros(nt * tile - n)]).view(nt, tile)
    l = torch.zeros_like(h)
    z = torch.zeros(nt)
    # Phase 1: the tile totals (the root of each tile's split).
    _, _, (th, tl) = _split_scan(h, l, wlog, blog, (z, z), (z, z), torch.ones(nt, dtype=torch.bool))
    # Phase 2: the top scan of the totals, padded to a tile.
    ph = torch.cat([th, torch.zeros(tile - nt)])
    pl = torch.cat([tl, torch.zeros(tile - nt)])
    one = torch.zeros(())
    s11h, s11l, _ = _split_scan(ph, pl, wlog, blog, None, (one, one), torch.tensor(True))
    s11 = (s11h[:nt], s11l[:nt])
    s11p = (torch.cat([torch.zeros(1), s11[0][:-1]]), torch.cat([torch.zeros(1), s11[1][:-1]]))
    first = torch.arange(nt) == 0
    sh, sl, _ = _split_scan(h, l, wlog, blog, s11, s11p, first)
    return sh.reshape(-1)[:n], sl.reshape(-1)[:n]


@pytest.mark.parametrize("wlog,blog,n", [
    (1, 1, 1), (1, 1, 4), (1, 1, 5), (1, 1, 16), (2, 1, 7), (2, 2, 64), (2, 2, 65),
    (2, 2, 256), (3, 2, 1000), (3, 2, 1024), (6, 5, 2047), (6, 5, 2048), (6, 5, 2049),
    (6, 5, 64 * 2048 + 7),
])
def test_scan_steps_decomposition_is_the_recursion(wlog, blog, n):
    x = torch.from_numpy(np.random.default_rng(n + 7 * wlog).standard_normal(n).astype(np.float32))
    want = compensated_scan(x)
    got = step_model_scan(x, wlog, blog)
    assert bits(got[0]) == bits(want[0]) and bits(got[1]) == bits(want[1])


def segment_products(group, xs):
    """Each segment's products as the kernel computes them (0 past its
    live entries), in segment order."""
    b = group.windows or 1
    out, at = [], 0
    for ip, e, slot, n in zip(group.indptr, group.e_pad, group.x_slots, group.n_x):
        cols = group.cols[at: at + b * e].view(b, e).long()
        vals = group.vals[at: at + b * e].view(b, e)
        at += b * e
        x = xs[slot].reshape(b, n)
        live = torch.arange(e)[None, :] < ip[:, -1:]
        prod = vals * torch.gather(x, 1, torch.where(live, cols, 0))
        out += list(torch.where(live, prod, torch.zeros_like(prod)))
    return out


def step_model(group, xs):
    """scan_step over a group's own tables (``tiles``, ``marks``,
    ``mark_rows``): each segment's scan (``step_model_scan``), the scan
    at each mark of a tile's run read from that tile's stage (offset 0:
    the zero pair), then, mark by mark, the difference of its scan and
    the next mark's into the row that starts there. Returns y as
    ``csr_scan_spmv`` does."""
    tiles, marks = group.tiles, group.marks.long()
    ends = torch.full((marks.shape[0], 2), float("nan"))
    scans = [step_model_scan(p) for p in segment_products(group, xs)]
    for seg, lt, first, end in tiles.tolist():
        hi, lo = scans[seg]
        for j in range(first, end):
            off = int(marks[j])
            if off == 0:
                ends[j] = 0.0
                continue
            assert 0 <= off - 1 - lt * scan.BLOCK < scan.BLOCK, "a mark outside its tile's stage"
            ends[j, 0], ends[j, 1] = hi[off - 1], lo[off - 1]
    assert not torch.isnan(ends).any(), "a mark no tile wrote"
    rows = group.mark_rows.long()
    y = torch.full((int(rows.max()) + 1,), float("nan"))
    live = torch.nonzero(rows >= 0).flatten()
    a, b_ = ends[live], ends[live + 1]
    y[rows[live]] = (b_[:, 0] - a[:, 0]) + (b_[:, 1] - a[:, 1])
    assert not torch.isnan(y).any() and y.shape[0] == sum(
        r * (group.windows or 1) for r in group.n_rows), "a row no mark wrote"
    return scan._outputs(group, y)


@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("sizes", [
    [(5, 17, 9)],
    [(40, 2048, 50), (3, 0, 7)],
    [(300, 4097, 400), (10, 30, 11), (1, 1, 2)],
    [(3000, 2048 * 70 + 3, 900), (2, 2049, 5)],
])
def test_scan_step_model_is_the_plain_rowsums(windows, sizes):
    mats, slots, n_x, xs = random_group(np.random.default_rng(len(sizes) + 17), sizes, windows)
    group = scan_group(mats, slots, n_x, windows)
    assert group.plan is not None and group.out is None
    got = step_model(group, xs)
    for g, w in zip(got, csr_scan_spmv(group, xs)):
        assert bits(g) == bits(w)


def test_scan_step_model_at_the_largest_matrix_it_takes():
    """A matrix of 2048^2 entries (2048 tiles, the top scan full) is
    scan_step's; one entry more takes the first design."""
    mats, slots, n_x, xs = random_group(np.random.default_rng(3), [(4000, 2048 ** 2, 5000)])
    group = scan_group(mats, slots, n_x)
    assert group.plan is not None and int(group.tiles.shape[0]) == 2048
    got = step_model(group, xs)
    for g, w in zip(got, csr_scan_spmv(group, xs)):
        assert bits(g) == bits(w)
    big = [(torch.tensor([0, 5], dtype=torch.int32), torch.zeros(2048 ** 2 + 1, dtype=torch.int32),
            torch.ones(2048 ** 2 + 1))]
    past = scan_group(big, (0,), (1,))
    assert past.plan is None and past.out is not None and len(past.blocks) == 3


def test_scan_step_tables_and_plan():
    """Tiles of a segment in order, each with its run of marks; the plan
    a block an SM, no block empty, the held tiles within the share."""
    ip = torch.tensor([0, 0, 3000, 3000, 4096, 5000], dtype=torch.int32)
    group = scan_group([(ip, torch.zeros(5000, dtype=torch.int32), torch.ones(5000)),
                        (torch.tensor([0, 1], dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), torch.ones(1))],
                       (0, 0), (4, 4))
    # Offsets 0, 0 (tile 0: offset 0 is the zero pair), 3000, 3000 (tile
    # 1: positions 2999), 4096 (tile 1: position 4095), 5000 (tile 2).
    assert group.tiles.tolist() == [[0, 0, 0, 2], [0, 1, 2, 5], [0, 2, 5, 6], [1, 0, 6, 8]]
    assert group.marks.tolist() == [0, 0, 3000, 3000, 4096, 5000, 0, 1]
    assert group.segs[:, 5:7].tolist() == [[0, 3], [3, 1]]
    assert group.mark_rows.tolist() == [0, 1, 2, 3, 4, -1, 5, -1]
    assert group.plan == scan.TilePlan(4, 1, 1, scan.tile_smem(1, 1))
    card = scan.H100
    for n_tiles in (1, 131, 132, 133, 1800, 20_000):
        plan = scan.tile_plan(n_tiles, card)
        assert plan.grid <= card.sms and (plan.grid - 1) * plan.per < n_tiles <= plan.grid * plan.per
        assert plan.smem == scan.tile_smem(plan.per, plan.held) <= card.smem
        assert plan.held == plan.per or scan.tile_smem(plan.per, plan.held + 1) > card.smem
    assert scan.tile_plan(1800, card).held == 14
    assert scan.tile_plan(10 ** 6, card) is None


@pytest.fixture(scope="module")
def csr_graph():
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.testing import SyntheticConfig, generate_case

    from conftest import partition_case

    case = generate_case(SyntheticConfig(n_operations=16, n_pods=2, n_traces=160, seed=11))
    nrm, abn = partition_case(case)
    return build_window_graph(case.abnormal, nrm, abn, aux="csr")[0]


def step_inputs(graph, gen, lead=()):
    xs = []
    for g in (graph.normal, graph.abnormal):
        t, v = g.kind.shape[-1], g.cov_unique.shape[-1]
        xs += [torch.from_numpy(gen.random(lead + (t,)).astype(np.float32)),
               torch.from_numpy(gen.random(lead + (v,)).astype(np.float32))]
    return xs


def matrices(g):
    return [(g.inc_indptr_op, g.inc_trace_opmajor, g.sr_val_opmajor),
            (g.ss_indptr, g.ss_parent, g.ss_val),
            (g.inc_indptr_trace, g.inc_op, g.rs_val)]


def jax_route_rowsums(graph, xs):
    out = []
    for p, g in enumerate((graph.normal, graph.abnormal)):
        for (ip, cols, vals), slot in zip(matrices(g), (2 * p, 2 * p + 1, 2 * p + 1)):
            ip, cols, vals = (np.asarray(a) for a in (ip, cols, vals))
            prod = (torch.from_numpy(vals) * xs[slot][torch.from_numpy(cols).long()]).numpy()
            out.append(jax_rowsums(prod, ip))
    return out


def test_csr_rowsums_are_jaxs_order(csr_graph):
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import window_scan_group

    xs = step_inputs(csr_graph, np.random.default_rng(0))
    group = window_scan_group(graph_from_numpy(csr_graph, "cpu"))
    got = csr_scan_spmv(group, xs)
    for g, w in zip(got, jax_route_rowsums(csr_graph, xs)):
        assert bits(g) == bits(w)


def test_csr_rowsums_of_a_stacked_group_are_each_windows(csr_graph, small_case):
    from microrank_tpu.graph import build_window_graph

    from conftest import partition_case
    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import window_scan_group

    nrm, abn = partition_case(small_case)
    other = build_window_graph(small_case.abnormal, nrm, abn, aux="csr")[0]
    stacked = stack_window_graphs([csr_graph, other])
    gen = np.random.default_rng(1)
    xs = step_inputs(stacked, gen, (2,))
    got = csr_scan_spmv(window_scan_group(graph_from_numpy(stacked, "cpu")), xs)
    for b in range(2):
        ws = []
        for p, g in enumerate((stacked.normal, stacked.abnormal)):
            for (ip, cols, vals), slot in zip(matrices(g), (2 * p, 2 * p + 1, 2 * p + 1)):
                ip, cols, vals = (np.asarray(a)[b] for a in (ip, cols, vals))
                prod = (torch.from_numpy(vals) * xs[slot][b][torch.from_numpy(cols).long()])
                ws.append(jax_rowsums(prod.numpy(), ip))
        for g, w in zip(got, ws):
            assert bits(g[b]) == bits(w)


def test_a_column_outside_its_x_raises(csr_graph):
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import host_counts, window_scan_group

    n = csr_graph.normal.inc_trace_opmajor.size
    bad = csr_graph._replace(normal=csr_graph.normal._replace(
        inc_trace_opmajor=np.where(np.arange(n) == 0, 10_000,
                                   csr_graph.normal.inc_trace_opmajor).astype(np.int32)))
    with pytest.raises(IndexError, match="outside"):
        window_scan_group(graph_from_numpy(bad, "cpu"))
    with pytest.raises(IndexError, match="outside"):
        host_counts(bad, "csr")


def test_levels_of_a_group():
    """The launch plan: a matrix of E entries needs ceil(log_2048 E) - 1
    levels of totals; a short matrix beside a long one gets every level,
    each at least one total."""
    assert [scan._depth(e) for e in (0, 1, 2048, 2049, 2048**2, 2048**2 + 1)] == [0, 0, 0, 1, 1, 2]
    assert scan._levels(10, 2) == [1, 1]
    assert scan._levels(5000, 1) == [3]
    ip = torch.tensor([0, 3000, 5000], dtype=torch.int32)
    group = scan_group([(ip, torch.zeros(5000, dtype=torch.int32), torch.ones(5000)),
                        (torch.tensor([0, 1], dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), torch.ones(1))],
                       (0, 0), (4, 4))
    assert group.blocks == (3, 1)
    assert group.segs[:, scan.SEG_WORDS - scan.MAX_LEVELS].tolist() == [3, 1]


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the csr scan is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def random_group(gen, sizes, windows=None):
    mats, n_x = [], []
    b = windows or 1
    for rows, e, nx in sizes:
        lens = gen.integers(0, 2 * e // max(rows, 1) + 1, size=(b, rows))
        lens = np.minimum(np.cumsum(lens, 1), e)
        ip = np.concatenate([np.zeros((b, 1), np.int64), lens], 1).astype(np.int32)
        cols = gen.integers(0, nx, size=(b, e)).astype(np.int32)
        vals = gen.random((b, e)).astype(np.float32)
        sq = (lambda a: a[0]) if windows is None else (lambda a: a)
        mats.append(tuple(torch.from_numpy(sq(a)) for a in (ip, cols, vals)))
        n_x.append(nx)
    xs = [torch.from_numpy(gen.random(((windows,) if windows else ()) + (nx,)).astype(np.float32))
          for nx in n_x]
    return mats, tuple(range(len(sizes))), n_x, xs


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("sizes", [
    [(5, 17, 9)],
    [(40, 2048, 50), (3, 1, 7)],
    [(300, 5000, 400), (10, 30, 11), (2, 0, 5)],
    [(2000, 4_200_000, 3000), (50, 900, 60)],
])
def test_kernel_is_bitwise_its_plain_version(cuda_device, windows, sizes):
    if windows and sizes[0][1] > 1_000_000:
        pytest.skip("one window at this size is enough")
    mats, slots, n_x, xs = random_group(np.random.default_rng(len(sizes)), sizes, windows)
    cpu = scan_group(mats, slots, n_x, windows)
    card = scan_group([tuple(t.to(cuda_device) for t in m) for m in mats], slots, n_x, windows,
                      levels=True)
    want = csr_scan_spmv(cpu, xs)
    # scan_step where it takes the group (every matrix up to 2048^2
    # entries), and the level passes.
    designs = ("step", "levels") if card.plan is not None else ("levels",)
    assert (card.plan is None) == (max(card.e_pad) > scan.BLOCK ** 2)
    for design in designs:
        before = csr_scan_spmv.launches
        got = csr_scan_spmv(card, [x.to(cuda_device) for x in xs], design=design)
        assert csr_scan_spmv.launches == before + 1
        for g, w in zip(got, want):
            assert bits(g.cpu()) == bits(w), design
