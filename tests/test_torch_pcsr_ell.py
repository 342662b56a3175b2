"""The pcsr kernel's trace side: p_rs read straight from the
partition-centric views' ELL slab (``ops/spmv.py`` ``ell_spmv_plain``,
``pcsr_spmv_group``), held bitwise to K1 over the same rows as work
items (``coo_spmv_plain`` over the slab's row layout, the earlier pcsr
design over ``pcsr_layouts`` and the pallas work list).

On the CPU each wrapper runs its plain version; the ``cuda`` test holds
the kernel to it and skips without a card. The file imports neither JAX
nor the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pcsr_ell.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import spmv
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    host_subset,
    pcsr_layouts,
    window_spmv_group,
)
from microrank_tpu_torch.testing import giant_window


def slab(seed, counts, width, n_x=300):
    """An ELL slab with ``counts[r]`` live entries in row r (distinct
    ascending ops, values in [0.01, 1)), zero padding after them."""
    rng = np.random.default_rng(seed)
    ops = np.zeros((len(counts), width), np.int32)
    vals = np.zeros((len(counts), width), np.float32)
    for r, n in enumerate(counts):
        ops[r, :n] = np.sort(rng.choice(n_x, n, replace=False))
        vals[r, :n] = rng.uniform(0.01, 1.0, n)
    x = rng.uniform(0.0, 1.0, n_x).astype(np.float32)
    return torch.from_numpy(ops), torch.from_numpy(vals), torch.from_numpy(x)


def k1_rows(ops, vals):
    """K1's row layout of the slab's live entries: row r's entries in
    slot order, as ``pcsr_layouts`` builds p_rs."""
    live = vals != 0
    rows = torch.arange(ops.shape[0], dtype=torch.int32)[:, None].expand_as(ops)
    return spmv.row_layout(rows[live].contiguous(), ops[live], vals[live], ops.shape[0])


def random_counts(seed, n_rows, width):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, width + 1, n_rows)
    counts[:3] = (0, width, 1)  # an all-padding row, a full row, one entry
    return counts


@pytest.mark.parametrize("width", [1, 2, 4, 8, 32, 64, 256])
def test_ell_plain_is_bitwise_k1(width):
    ops, vals, x = slab(width, random_counts(width, 97, width), width)
    y = spmv.ell_spmv_plain(ops, vals, x)
    assert torch.equal(y, spmv.coo_spmv_plain(k1_rows(ops, vals), x))
    assert y[0].item() == 0.0 and not torch.signbit(y[0])


@pytest.mark.parametrize("width,counts", [
    (512, (300, 256, 257, 0, 1, 512, 511)),
    (1024, (700, 1024, 513, 255, 0, 769)),
    (1024, (1000, 1, 4, 0, 33, 2, 31, 32, 3, 65, 1)),
    (512, (300, *range(1, 9), *range(30, 35))),
])
def test_ell_plain_walks_chunks_like_k1(width, counts):
    # Rows past 256 entries: K1 cuts them into chunks of 256 and folds
    # the chunk sums left to right; the slab walks its live chunks. Short
    # rows beside one long row: the kernel reads a wide row by its length,
    # only its live columns of 32 slots, which changes no bit.
    ops, vals, x = slab(len(counts), counts, width, n_x=2000)
    assert torch.equal(spmv.ell_spmv_plain(ops, vals, x),
                       spmv.coo_spmv_plain(k1_rows(ops, vals), x))


@pytest.mark.parametrize("width", [4, 64, 512])
def test_equal_rows_give_equal_bits(width):
    ops, vals, x = slab(5, [width // 2 + 1] * 3, width, n_x=1000)
    ops[1], vals[1] = ops[0], vals[0]
    ops[2, : width // 2 + 1] = ops[0, : width // 2 + 1].flip(0)  # same set, other order
    y = spmv.ell_spmv_plain(ops, vals, x)
    assert torch.equal(y[0], y[1])
    assert torch.equal(y, spmv.coo_spmv_plain(k1_rows(ops, vals), x))


def test_padding_never_multiplies_x():
    # Padding slots hold op 0: a non-finite x[0] must not reach a row
    # whose live entries do not read it.
    ops, vals, x = slab(9, random_counts(9, 50, 8), 8)
    ops[vals != 0] = torch.clamp_min(ops[vals != 0], 1)
    y = spmv.ell_spmv_plain(ops, vals, x)
    x[0] = float("nan")
    assert torch.equal(spmv.ell_spmv_plain(ops, vals, x), y)


@pytest.mark.parametrize("width,counts,mode", [
    (4, (4, 0, 2, 1), spmv.ELL_SLAB),
    (32, (32,) * 4, spmv.ELL_SLAB),
    (512, (300, *range(0, 33)), spmv.ELL_SHORT),
    (64, (32, 32, 32), spmv.ELL_SHORT),
    (64, (33, 32, 32), spmv.ELL_WARP),
    (1024, (700, 1024, 513, 255, 0, 769), spmv.ELL_WARP),
])
def test_ell_part_counts_rows_and_picks_the_mode(width, counts, mode):
    # Past 32 slots a row is read by its length: 8 threads a row while
    # rows hold 32 live entries or fewer on average, else a warp a row.
    ops, vals, _ = slab(width, counts, width, n_x=2000)
    part = spmv.ell_part(ops, vals, 1)
    assert part.lens.dtype == torch.int32
    assert part.lens.tolist() == list(counts)
    assert (part.slot, part.mode) == (1, mode)
    assert spmv.ell_part(ops, vals, 1, spmv.ELL_WARP).mode == spmv.ELL_WARP


@pytest.fixture(scope="module")
def giant_graph():
    gw = giant_window(n_spans=40_000, n_ops=64)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, gw.abnormal_codes, aux="pcsr"
    )
    return graph


def test_pcsr_group_is_bitwise_the_work_list_designs(giant_graph):
    # The step over the ELL slabs against K1 over pcsr_layouts' work
    # list (the earlier design) and over the pallas work list.
    pc = device_subset(graph_from_numpy(host_subset(giant_graph, "pcsr"), "cpu"), "pcsr")
    full = graph_from_numpy(giant_graph, "cpu")
    group = pc.spmv_group
    assert group.rows.n_rows == (full.normal.cov_unique.shape[0],) * 4
    assert [e.ops.shape for e in group.ell] == [
        tuple(g.pc_ell_op.shape) for g in (full.normal, full.abnormal)
    ]
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
          for g in (full.normal, full.abnormal)
          for n in (g.kind.shape[0], g.cov_unique.shape[0])]
    for e in group.ell:  # the row lengths and mode the kernel reads
        assert torch.equal(e.lens, (e.vals != 0).sum(1, dtype=torch.int32))
        assert e.mode == spmv.ell_mode(e.ops.shape[1], e.ops.shape[0], int(e.lens.sum()))
    ours = spmv.pcsr_spmv_group(group, xs)
    for theirs in (window_spmv_group(pc, pcsr_layouts), device_subset(full, "pallas").spmv_group):
        for a, b in zip(ours, spmv.coo_spmv_group(theirs, xs)):
            assert torch.equal(a, b)


def test_pcsr_group_checks_the_slab(giant_graph):
    # The kernel reads a row's live entries as a prefix and trusts its
    # ops: a gap or an op outside x is refused once per window.
    def with_normal(**fields):
        g = host_subset(giant_graph, "pcsr")
        return graph_from_numpy(g._replace(normal=g.normal._replace(**fields)), "cpu")

    ops, vals = giant_graph.normal.pc_ell_op.copy(), giant_graph.normal.pc_ell_rs.copy()
    row = int(np.flatnonzero((vals[:, 0] != 0) & (vals[:, -1] == 0))[0])
    n = int((vals[row] != 0).sum())
    gap_vals = vals.copy()
    gap_vals[row, n], gap_vals[row, 0] = gap_vals[row, 0], 0.0
    with pytest.raises(ValueError, match="after padding"):
        device_subset(with_normal(pc_ell_rs=gap_vals), "pcsr")
    bad_ops = ops.copy()
    bad_ops[row, 0] = giant_graph.normal.cov_unique.shape[0]
    with pytest.raises(ValueError, match="outside"):
        device_subset(with_normal(pc_ell_op=bad_ops), "pcsr")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wide_mode", [spmv.ELL_SHORT, spmv.ELL_WARP])
@pytest.mark.parametrize("widths,max_short", [((2, 1024), None), ((4, 512), 40)])
def test_pcsr_kernel_matches_cpu_plain_bitwise(cuda_device, giant_graph, widths, max_short,
                                               wide_mode):
    # One launch: the window's work items, then two slabs of other widths
    # in place of its own: W = 2, and W = 1024 with rows of any length and
    # two of 700 entries; then W = 4, and W = 512 with rows of at most
    # ``max_short`` entries beside two full ones (the kernel reads a
    # row's live columns only). The wide slab is read in either mode.
    host = device_subset(graph_from_numpy(host_subset(giant_graph, "pcsr"), "cpu"), "pcsr")
    n_rows = [e.ops.shape[0] for e in host.spmv_group.ell]
    v = host.normal.cov_unique.shape[0]
    wide = random_counts(2, n_rows[1], widths[1])
    if max_short is not None:
        wide = np.random.default_rng(3).integers(0, max_short + 1, n_rows[1])
    slabs = [slab(1, random_counts(1, n_rows[0], widths[0]), widths[0], n_x=v),
             slab(2, np.minimum(wide, v), widths[1], n_x=v)]
    slabs[1][1][:2, :700] = 0.5  # two long rows: 700 entries or W (ops repeat)
    cpu = host.spmv_group._replace(ell=tuple(
        spmv.ell_part(o, w, e.slot, None if o.shape[1] <= 32 else wide_mode)
        for (o, w, _), e in zip(slabs, host.spmv_group.ell)
    ))
    dev = spmv.PcsrGroup(
        spmv.SpmvGroup(*(t.to(cuda_device) if torch.is_tensor(t) else t for t in cpu.rows)),
        tuple(spmv.EllPart(*(t.to(cuda_device) if torch.is_tensor(t) else t for t in e))
              for e in cpu.ell),
        cpu.order,
    )
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
          for n in cpu.rows.n_x]
    before = (spmv.pcsr_spmv_group.launches, spmv.pcsr_spmv_group.spmvs)
    ys = [torch.cat(spmv.pcsr_spmv_group(dev, [x.to(cuda_device) for x in xs]))
          for _ in range(3)]
    torch.cuda.synchronize()
    assert (spmv.pcsr_spmv_group.launches, spmv.pcsr_spmv_group.spmvs) == (
        before[0] + 3, before[1] + 18
    )
    want = torch.cat(spmv.pcsr_spmv_group_plain(cpu, xs))
    for y in ys:
        assert torch.equal(y.cpu(), want)
