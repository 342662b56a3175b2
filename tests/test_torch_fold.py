"""The rank program's fixed-order sums (``ops/fold.py``,
``csrc/row_fold.cu``): the tree order, its independence of the pad,
and the set-up and finish of a window alone and in a stacked group.

* the plain version against a recursive statement of the tree, on rows
  of every length up to 70 and on random lengths past a tile;
* the same sum on any pad: a row padded with zeros, with garbage past
  its length, or inside a wider matrix gives the same bits; n = 0 gives
  +0; within float64's reach of the exact sum;
* a window's preference vectors, initial vectors and finished weights
  at its own trace pad (8) are bitwise those of the same window stacked
  with a window of pad 96 (a torch reduction over the padded axis
  paired them otherwise on the card), and the stacked program on the
  CPU is bitwise each window's own;
* on the card (``-m cuda``): the kernel bitwise its plain version at
  one tile, past one tile, at a giant window's width and with lengths
  short of the width, over 50 launches, its counters back at 0.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fold.py
"""

import functools

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import fold
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
)
from microrank_tpu_torch.testing import giant_window


def tree(values, lo, size, n):
    """The node covering [lo, lo + size) of the tree over n leaves."""
    if size == 1:
        return np.float32(values[lo])
    half = size // 2
    left = tree(values, lo, half, n)
    if lo + half >= n:
        return left
    return np.float32(left + tree(values, lo + half, half, n))


def tree_sum(values, n):
    size = 1
    while size < n:
        size *= 2
    return np.float32(0.0) if n == 0 else tree(values, 0, size, n)


def bits(t):
    return t.contiguous().view(torch.int32)


def test_plain_fold_is_the_pairwise_tree():
    rng = np.random.default_rng(0)
    for n in range(71):
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        got = fold.fold_rows_plain(torch.from_numpy(x)[None], torch.tensor([n]))
        assert got.numpy().tobytes() == np.float32(tree_sum(x, n)).tobytes(), n
    for n in (4095, 4096, 4097, 9000, 20001):
        x = rng.random(n).astype(np.float32)
        got = fold.fold_rows_plain(torch.from_numpy(x)[None])
        assert got.numpy().tobytes() == np.float32(tree_sum(x, n)).tobytes(), n


def test_fold_does_not_depend_on_the_pad():
    rng = np.random.default_rng(1)
    lengths = [0, 1, 5, 8, 9, 96, 4096, 4097, 12345]
    rows = [rng.random(n).astype(np.float32) for n in lengths]
    want = [tree_sum(r, len(r)) for r in rows]
    for width in (12345, 16384, 20000):
        x = rng.standard_normal((len(rows), width)).astype(np.float32) * 1e30  # garbage
        for i, r in enumerate(rows):
            x[i, :len(r)] = r
        got = fold.fold_rows(torch.from_numpy(x), torch.tensor(lengths, dtype=torch.int32))
        assert [v.tobytes() for v in got.numpy()] == [np.float32(w).tobytes() for w in want]
    zero = fold.fold_rows(torch.zeros((1, 0)))
    assert zero.numpy().tobytes() == np.float32(0.0).tobytes()
    # Lengths past the width count the width.
    x = torch.from_numpy(rng.random((2, 50)).astype(np.float32))
    assert torch.equal(fold.fold_rows(x, torch.tensor([50, 50])),
                       fold.fold_rows(x, torch.tensor([70, 1 << 30])))


def test_fold_is_close_to_the_exact_sum_and_checks_its_input():
    rng = np.random.default_rng(2)
    x = rng.random((3, 30000)).astype(np.float32)
    got = fold.fold_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64).sum(1), rtol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        fold.fold_rows(torch.zeros(5))
    with pytest.raises(ValueError, match="float32"):
        fold.fold_rows(torch.zeros((2, 5), dtype=torch.float64))


# Two kind-collapsed windows over one 13-op vocab: 6 and 5 kind columns
# (trace pad 8), and 91 (pad 96), as the replay's group of two mixes.
TWO_PADS = ((24, 3), (8000, 4))


@functools.lru_cache(maxsize=None)
def two_pad_windows(aux="kind", collapse="on"):
    out = []
    for n_spans, seed in TWO_PADS:
        gw = giant_window(n_spans=n_spans, n_ops=13, spans_per_trace=2, seed=seed)
        graph, _, _, _ = build_window_graph_from_table(
            gw.table, None, gw.normal_codes, gw.abnormal_codes, aux=aux, collapse=collapse
        )
        out.append(graph)
    return tuple(out)


def test_the_two_windows_have_the_pads_of_the_replays_group():
    small, large = two_pad_windows()
    assert [p.kind.shape[-1] for p in (small.normal, small.abnormal)] == [8, 8]
    assert [p.kind.shape[-1] for p in (large.normal, large.abnormal)] == [96, 96]
    assert small.normal.cov_unique.shape == large.normal.cov_unique.shape


@pytest.mark.parametrize("preference", ["reference", "paper"])
def test_setup_and_finish_sums_at_pad_96_are_bitwise_pad_8(preference):
    graphs = [host_subset(g, "kind") for g in two_pad_windows()]
    cfg = PageRankConfig(preference=preference)
    own = graph_from_numpy(graphs[0], "cpu")
    group = graph_from_numpy(stack_window_graphs(graphs), "cpu")
    for part in ("normal", "abnormal"):
        g_own, g_grp = getattr(own, part), getattr(group, part)
        t = g_own.kind.shape[-1]
        for anomaly in (False, True):
            got = torch_cuda._partition_setup(g_grp, anomaly, cfg, "kind")
            want = torch_cuda._partition_setup(g_own, anomaly, cfg, "kind")
            pref, sv, rv = got
            assert torch.equal(bits(pref[0, :t]), bits(want[0]))
            assert not pref[0, t:].any()  # the group's pad past the window's
            assert torch.equal(bits(sv[0]), bits(want[1]))
            assert torch.equal(bits(rv[0, :t]), bits(want[2]))
        rng = np.random.default_rng(3)
        sv = torch.from_numpy(rng.random(g_grp.op_present.shape).astype(np.float32))
        w_grp, s_grp = torch_cuda._partition_finish(g_grp, sv)
        w_own, s_own = torch_cuda._partition_finish(g_own, sv[0])
        assert torch.equal(bits(w_grp[0]), bits(w_own))
        assert torch.equal(bits(s_grp[0]), bits(s_own))


@pytest.mark.parametrize("kernel,precision", [("kind", "f32"), ("kind", "int8"),
                                              ("pallas", "f32")])
def test_two_pad_group_is_bitwise_each_windows_own_program(kernel, precision):
    aux = "kind" if kernel == "kind" else "auto"
    graphs = [host_subset(g, kernel) for g in two_pad_windows(aux)]
    cfg = PageRankConfig(kind_precision=precision)

    def program(host):
        dg = device_subset(graph_from_numpy(host, "cpu"), kernel)
        return fetch_rank_outputs(rank_window_traced_core(dg, cfg, SpectrumConfig(), kernel))

    got = program(stack_window_graphs(graphs))
    for b, host in enumerate(graphs):
        want = program(host)
        n = want[2]
        assert (int(got[2][b]), int(got[4][b])) == (n, want[4])
        for x, y in ((got[0][b][:n], want[0][:n]), (got[1][b][:n], want[1][:n]),
                     (got[3][b], want[3])):
            assert x.tobytes() == y.tobytes()


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fold is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width,short", [(8, False), (96, True), (4096, False), (4097, True),
                                         (70_000, True), (2_621_440, False)])
def test_fold_kernel_is_bitwise_its_plain_version(cuda_device, width, short):
    rng = np.random.default_rng(width)
    rows = 6
    x = torch.from_numpy(rng.random((rows, width)).astype(np.float32))
    n = (torch.from_numpy(rng.integers(0, width + 1, rows).astype(np.int32)) if short
         else torch.full((rows,), width, dtype=torch.int32))
    want = fold.fold_rows_plain(x, n)
    xd, nd = x.to(cuda_device), n.to(cuda_device)
    before = fold.fold_rows.launches
    for i in range(50):
        got = fold.fold_rows(xd, nd if short or i % 2 else None)
        torch.cuda.synchronize()
        assert torch.equal(bits(got.cpu()), bits(want))
    assert fold.fold_rows.launches - before == 50


@pytest.mark.cuda
def test_fold_kernel_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="int32"):
        fold.fold_rows(torch.zeros((2, 5), device=cuda_device), torch.zeros(2, device=cuda_device))
    with pytest.raises(ValueError, match="rows"):
        fold.fold_rows(torch.zeros((1, fold.MAX_WIDTH + 1), device=cuda_device))
