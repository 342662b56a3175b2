"""K15, the explained program's attribution epilogue, on an NVIDIA GPU:
``ops.explain.explain_epilogue`` (``csrc/explain_epilogue.cu``) bitwise
its plain version (``explain_plain``) on the same card tensors, on every
route (the bitmap of kind and the packed family, the pcsr ELL slab, the
csr op-major view, the trace-major entries of coo, pallas, dense and
dense_bf16), with ``top_traces`` 5 (the warp-select) and 40 (the
bitonic path), on windows of one tile and of many (merge passes), with
``top_suspects``, J past the columns, and one launch counted a call; and
the explained program through ``stage_rank_window`` with its first five
outputs bitwise the traced program's.

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
def host_window(aux, collapse, n_spans, spans_per_trace=4):
    gw = giant_window(n_spans=n_spans, n_ops=192, spans_per_trace=spans_per_trace, seed=5)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, gw.abnormal_codes, aux=aux, collapse=collapse)
    return graph


def program(kernel, n_spans, device, spans_per_trace=4):
    """The window's rank program on the card: (device graph, its _Program)."""
    aux, collapse = ROUTES[kernel]
    host = host_window(aux, collapse, n_spans, spans_per_trace)
    dg = tc.device_subset(graph_from_numpy(tc.host_subset(host, kernel), device), kernel)
    return dg, tc._rank_program(dg, PageRankConfig(), SpectrumConfig(), kernel)


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
    plan = kx.explain_plan(int(dg.normal.kind.shape[0]), int(dg.abnormal.kind.shape[0]), j,
                           int(got.counters.shape[1]))
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
