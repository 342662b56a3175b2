"""K15, the explained program's attribution epilogue, on an NVIDIA GPU:
``ops.explain.explain_epilogue`` (``csrc/explain_epilogue.cu``) bitwise
its plain version (``explain_plain``) on the same card tensors, on every
route (the bitmap of kind and the packed family, the pcsr ELL slab, the
csr op-major view, the trace-major entries of coo, pallas, dense and
dense_bf16), with ``top_traces`` 5 (the warp-select) and 40 (the
bitonic path), on windows of one tile and of many (merge passes), with
``top_suspects``, J past the columns, and one launch counted a call; a
collapsed trace-major window, Ke past the 32-suspect match word, traces
that straddle a trace-major chunk's nominal edge, a partition far smaller
than the other; and the explained program through ``stage_rank_window``
with its first five outputs bitwise the traced program's.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_explain_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import ExplainConfig, PageRankConfig, SpectrumConfig
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import explain as kx
from microrank_tpu_torch.rank_backends import blob
from microrank_tpu_torch.rank_backends import torch_cuda as tc
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.testing import giant_window

pytestmark = pytest.mark.cuda

# kernel: (build aux, collapse)
ROUTES = {
    "kind": ("kind", "on"), "packed": ("packed", "off"), "packed_bf16": ("packed", "off"),
    "packed_blocked": ("packed", "off"), "pcsr": ("pcsr", "off"), "csr": ("csr", "off"),
    "coo": ("none", "off"), "pallas": ("none", "off"), "dense": ("none", "off"),
    "dense_bf16": ("none", "off"),
}
# Spans of a window: one fill tile a partition, and some 24 (merge passes).
SIZES = (40_000, 400_000)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K15 is a CUDA kernel with no CPU path")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def host_window(aux, collapse, n_spans, spans_per_trace=4, abnormal_share=1):
    """A giant-window build; ``abnormal_share`` > 1 keeps that fraction of
    the abnormal traces (a partition far smaller than the other)."""
    gw = giant_window(n_spans=n_spans, n_ops=192, spans_per_trace=spans_per_trace, seed=5)
    abnormal = gw.abnormal_codes[: max(1, len(gw.abnormal_codes) // abnormal_share)]
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, abnormal, aux=aux, collapse=collapse)
    return graph


def program(kernel, n_spans, device, spans_per_trace=4, collapse=None, abnormal_share=1,
            spectrum=SpectrumConfig()):
    """The window's rank program on the card: (device graph, its _Program)."""
    aux, default = ROUTES[kernel]
    host = host_window(aux, collapse or default, n_spans, spans_per_trace, abnormal_share)
    dg = tc.device_subset(graph_from_numpy(tc.host_subset(host, kernel), device), kernel)
    return dg, tc._rank_program(dg, PageRankConfig(), spectrum, kernel)


def k15_args(dg, out, kernel, ex, spectrum=SpectrumConfig()):
    return (dg.normal, dg.abnormal, out.rv_n, out.rv_a, out.epilogue, spectrum, ex, kernel)


def bits(t):
    return t.detach().cpu().contiguous().view(torch.uint8).numpy()


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(bits(x), bits(y))


@pytest.mark.parametrize("j", [5, 40])
@pytest.mark.parametrize("n_spans", SIZES)
@pytest.mark.parametrize("kernel", list(ROUTES))
def test_k15_is_bitwise_its_plain_version(cuda_device, kernel, n_spans, j):
    dg, out = program(kernel, n_spans, cuda_device)
    ex = ExplainConfig(enabled=True, top_traces=j)
    args = (dg.normal, dg.abnormal, out.rv_n, out.rv_a, out.epilogue, SpectrumConfig(), ex,
            kernel)
    before = (kx.explain_epilogue.launches, kx.explain_epilogue.kernel_launches)
    got = kx.explain_epilogue(*args)
    plan = kx.window_plan(dg.normal, dg.abnormal, kernel, j, int(got.counters.shape[1]))
    assert (kx.explain_epilogue.launches, kx.explain_epilogue.kernel_launches) == (
        before[0] + 1, before[1] + plan.kernel_launches)
    torch.cuda.synchronize()
    want = kx.explain_plain(*args)
    assert_bitwise(got, want)
    if n_spans == SIZES[-1]:
        assert plan.passes, plan   # the merge ran
    # Over repeated launches: the same bits.
    for _ in range(3):
        assert_bitwise(kx.explain_epilogue(*args), got)


@pytest.mark.parametrize("spans_per_trace,width", [(12, 8), (48, 32), (160, 128)])
@pytest.mark.parametrize("kernel", ["pcsr", "coo"])
def test_wide_traces(cuda_device, kernel, spans_per_trace, width):
    """Traces of many ops: ELL slabs past 8, 32 and 128 slots (a column
    read by 4, 16 and 32 lanes), and long runs of a tile's entries."""
    dg, out = program(kernel, 200_000, cuda_device, spans_per_trace)
    if kernel == "pcsr":
        assert int(dg.normal.pc_ell_op.shape[1]) >= width
    for j in (5, 40):
        args = (dg.normal, dg.abnormal, out.rv_n, out.rv_a, out.epilogue, SpectrumConfig(),
                ExplainConfig(enabled=True, top_traces=j), kernel)
        assert_bitwise(kx.explain_epilogue(*args), kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["kind", "pcsr", "csr", "coo"])
def test_top_suspects_and_j_past_the_columns(cuda_device, kernel):
    dg, out = program(kernel, SIZES[0], cuda_device)
    t_max = max(int(dg.normal.kind.shape[0]), int(dg.abnormal.kind.shape[0]))
    for ex in (ExplainConfig(enabled=True, top_traces=3, top_suspects=2),
               ExplainConfig(enabled=True, top_traces=min(kx.J_MAX, t_max + 5))):
        args = (dg.normal, dg.abnormal, out.rv_n, out.rv_a, out.epilogue, SpectrumConfig(),
                ex, kernel)
        got = kx.explain_epilogue(*args)
        assert got.trace_idx.shape[1:] == (kx.n_suspects(int(out.epilogue.top_idx.shape[0]),
                                                         ex), ex.top_traces)
        assert_bitwise(got, kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["coo", "dense", "pallas"])
def test_collapsed_trace_major_window(cuda_device, kernel):
    """A collapsed build's few kind columns, each fed by many entries:
    chunks of a few dozen entries, most inside one kind's run."""
    dg, out = program(kernel, SIZES[0], cuda_device, spans_per_trace=12, collapse="on")
    assert int(dg.normal.n_cols) >= 0
    for j in (5, 40):
        args = k15_args(dg, out, kernel, ExplainConfig(enabled=True, top_traces=j))
        assert_bitwise(kx.explain_epilogue(*args), kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["kind", "pcsr", "csr", "coo"])
def test_suspects_past_the_match_word(cuda_device, kernel):
    """Ke 46 (top_max 40, every rank row): two chunks of suspects."""
    spectrum = SpectrumConfig(top_max=40)
    dg, out = program(kernel, SIZES[0], cuda_device, spectrum=spectrum)
    ex = ExplainConfig(enabled=True, top_traces=5, top_suspects=0)
    args = k15_args(dg, out, kernel, ex, spectrum)
    got = kx.explain_epilogue(*args)
    assert got.counters.shape[1] > kx.SUS
    assert_bitwise(got, kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["coo", "dense_bf16"])
def test_traces_straddle_chunk_edges(cuda_device, kernel):
    """Traces of ~100 entries against chunks of 64 to 4,096: a chunk's
    nominal edge falls inside a trace, which the chunk that holds the
    trace's start sums whole."""
    dg, out = program(kernel, 200_000, cuda_device, spans_per_trace=160)
    ke = kx.n_suspects(int(out.epilogue.top_idx.shape[0]), ExplainConfig(enabled=True))
    plan = kx.window_plan(dg.normal, dg.abnormal, kernel, 5, ke)
    g = dg.normal
    starts, _ = kx.chunk_edges(g.inc_trace.cpu(), int(g.n_inc), int(g.kind.shape[0]),
                               plan.unit[0], plan.units[0])
    nominal = torch.arange(plan.units[0] + 1) * plan.unit[0]
    inside = (starts[1:-1] != nominal[1:-1]) & (nominal[1:-1] < int(g.n_inc))
    assert bool(inside.any())
    for j in (5, 40):
        args = k15_args(dg, out, kernel, ExplainConfig(enabled=True, top_traces=j))
        assert_bitwise(kx.explain_epilogue(*args), kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["kind", "pcsr", "csr", "coo"])
def test_a_partition_far_smaller_than_the_other(cuda_device, kernel):
    """An abnormal partition of 1/64 the normal one's traces: each planned
    on its own units."""
    dg, out = program(kernel, SIZES[1], cuda_device, abnormal_share=64)
    t_n, t_a = int(dg.normal.kind.shape[0]), int(dg.abnormal.kind.shape[0])
    assert 16 * t_a <= t_n
    for j in (5, 40):
        args = k15_args(dg, out, kernel, ExplainConfig(enabled=True, top_traces=j))
        plan = kx.window_plan(dg.normal, dg.abnormal, kernel, j,
                              int(out.epilogue.top_idx.shape[0]))
        assert plan.units[1] < plan.units[0]
        assert_bitwise(kx.explain_epilogue(*args), kx.explain_plain(*args))


@pytest.mark.parametrize("kernel", ["kind", "pcsr", "pallas"])
@pytest.mark.parametrize("use_blob", [True, False])
def test_explained_program_through_staging(cuda_device, kernel, use_blob):
    aux, collapse = ROUTES[kernel]
    host = tc.host_subset(host_window(aux, collapse, SIZES[0]), kernel)
    cfgs = (PageRankConfig(), SpectrumConfig())
    plain, _ = blob.stage_rank_window(host, *cfgs, kernel, cuda_device, use_blob,
                                      conv_trace=True)
    outs, _ = blob.stage_rank_window(host, *cfgs, kernel, cuda_device, use_blob,
                                     explain=ExplainConfig(enabled=True))
    fetched = tc.fetch_rank_outputs(outs)
    assert len(fetched) == 10
    for a, b in zip(tc.fetch_rank_outputs(plain), fetched[:5]):
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    assert fetched[8].dtype == np.int32 and fetched[9].dtype == np.float32


def test_a_cuda_tensor_never_takes_the_plain_version(cuda_device):
    dg, out = program("coo", SIZES[0], cuda_device)
    with pytest.raises(ValueError, match="top_traces"):
        kx.explain_epilogue(dg.normal, dg.abnormal, out.rv_n, out.rv_a, out.epilogue,
                            SpectrumConfig(), ExplainConfig(enabled=True,
                                                            top_traces=kx.J_MAX + 1), "coo")
