"""Blob staging on an NVIDIA GPU: the leaves decoded on the card are
bitwise the host arrays, each at a 256-byte-aligned address of the one
device buffer (so a pcsr window passes the ELL slab's alignment check);
the rank program over the blob is bitwise the per-leaf (tree) path's
with the same launches, on every route, stacked groups too; on every
route (pcsr and pallas too, their counts from the host graph) the
stage, the layouts and the program of a window and of a stacked group
issue under ``torch.cuda.set_sync_debug_mode("error")``; and the pinned
blob is held with the window's outputs until they are fetched.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_blob_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
from microrank_tpu_torch.config import SpectrumConfig
from microrank_tpu_torch.graph.structures import PartitionGraph
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import pattern, spmv, step
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.rank_backends import blob
from microrank_tpu_torch.rank_backends.torch_cuda import (
    fetch_rank_outputs,
    host_subset,
    pack_rank_outputs,
    unpack_rank_outputs,
)
from microrank_tpu_torch.testing import giant_window

pytestmark = pytest.mark.cuda

# (kernel, kind_precision, build aux, collapse)
ROUTES = [
    ("kind", "f32", "kind", "on"),
    ("kind", "int8", "kind", "on"),
    ("packed", "f32", "packed", "off"),
    ("packed_bf16", "f32", "packed", "off"),
    ("packed_blocked", "f32", "packed", "off"),
    ("pcsr", "f32", "pcsr", "off"),
    ("pallas", "f32", "auto", "off"),
]
ROUTE_IDS = [f"{k}-{p}" for k, p, _, _ in ROUTES]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: blob staging's copy is a pinned host-to-card copy")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def host_window(aux, collapse, seed=3):
    gw = giant_window(n_spans=40_000, n_ops=192, seed=seed)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, gw.abnormal_codes, aux=aux, collapse=collapse
    )
    return graph


def counts():
    return (spmv.coo_spmv.launches, spmv.pcsr_spmv_group.launches,
            pattern.pattern_pair_group.launches, pattern.pattern_pair_group.fold_launches,
            pattern.quantize_scales.launches, step.power_step.launches)


def ranked(host, kernel, precision, device, use_blob):
    """(fetched outputs, launches, pinned blob) of one staged program."""
    before = counts()
    outs, staged = blob.stage_rank_window(
        host, PageRankConfig(kind_precision=precision), SpectrumConfig(), kernel, device,
        use_blob, conv_trace=True,
    )
    fetched = fetch_rank_outputs(outs)
    return fetched, tuple(a - b for a, b in zip(counts(), before)), staged


def assert_outputs_bitwise(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8))


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_views_are_the_host_arrays_at_aligned_addresses(cuda_device, kernel, precision, aux,
                                                       collapse):
    host = host_subset(host_window(aux, collapse), kernel)
    buf, layout = blob.pack_graph_blob(host, pin=True)
    assert buf.is_pinned()
    card = buf.to(cuda_device, non_blocking=True)
    graph = blob.unpack_graph_blob(card, layout)
    for name in ("normal", "abnormal"):
        for f in PartitionGraph._fields:
            a, b = np.asarray(getattr(getattr(host, name), f)), getattr(getattr(graph, name), f)
            assert b.is_cuda and tuple(b.shape) == a.shape, f
            got = b.cpu().numpy()
            assert got.dtype == a.dtype, f
            np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                          np.atleast_1d(a).view(np.uint8), err_msg=f)
            if b.numel():
                assert b.data_ptr() % blob.ALIGN_BYTES == 0, f


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_blob_program_is_bitwise_the_tree_program(cuda_device, kernel, precision, aux,
                                                  collapse):
    host = host_subset(host_window(aux, collapse), kernel)
    tree, tree_launches, none = ranked(host, kernel, precision, cuda_device, False)
    got, launches, staged = ranked(host, kernel, precision, cuda_device, True)
    assert none is None and staged.is_pinned()
    assert launches == tree_launches and launches[-1] == PageRankConfig().iterations
    assert_outputs_bitwise(got, tree)


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_stacked_group_blob_is_bitwise_the_tree_group(cuda_device, kernel, precision, aux,
                                                      collapse):
    host = stack_window_graphs([host_subset(host_window(aux, collapse, seed), kernel)
                                for seed in (3, 4)])
    cfg = PageRankConfig(kind_precision=precision)
    outs = []
    for use_blob in (False, True):
        before = counts()
        o, _ = blob.stage_rank_windows_batched(host, cfg, SpectrumConfig(), kernel,
                                               cuda_device, use_blob, conv_trace=True)
        outs.append((fetch_rank_outputs(o), tuple(a - b for a, b in zip(counts(), before))))
    assert outs[0][1] == outs[1][1]
    assert_outputs_bitwise(outs[1][0], outs[0][0])


def test_pcsr_window_passes_the_slab_alignment_check(cuda_device):
    host = host_subset(host_window("pcsr", "off"), "pcsr")
    before = spmv.pcsr_spmv_group.launches
    ranked(host, "pcsr", "f32", cuda_device, True)
    assert spmv.pcsr_spmv_group.launches - before == PageRankConfig().iterations


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_stage_layouts_and_program_issue_without_a_host_sync(cuda_device, kernel, precision,
                                                             aux, collapse):
    host = host_subset(host_window(aux, collapse), kernel)
    cfg = PageRankConfig(kind_precision=precision)
    ranked(host, kernel, precision, cuda_device, True)  # builds and binds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, staged = blob.stage_rank_window(host, cfg, SpectrumConfig(), kernel,
                                              cuda_device, True, conv_trace=True)
        packed = pack_rank_outputs(outs, staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = unpack_rank_outputs(packed)
    ref, _, _ = ranked(host, kernel, precision, cuda_device, False)
    assert_outputs_bitwise(got, ref)


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_stacked_group_issues_without_a_host_sync(cuda_device, kernel, precision, aux,
                                                  collapse):
    host = stack_window_graphs([host_subset(host_window(aux, collapse, seed), kernel)
                                for seed in (3, 4)])
    cfg = PageRankConfig(kind_precision=precision)

    def staged():
        outs, pinned = blob.stage_rank_windows_batched(host, cfg, SpectrumConfig(), kernel,
                                                       cuda_device, True, conv_trace=True)
        return pack_rank_outputs(outs, pinned)

    want = unpack_rank_outputs(staged())  # builds and binds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = staged()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_outputs_bitwise(unpack_rank_outputs(packed), want)


def test_the_pinned_blob_is_held_until_the_fetch(cuda_device):
    gw = giant_window(n_spans=40_000, n_ops=192, seed=3)
    rca = TableRCA(MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="on")), device="cuda")
    graph, names, kernel = rca.prepare_rank(gw.table, None, gw.normal_codes, gw.abnormal_codes)
    packed, _ = rca.launch_rank(graph, names, kernel)
    host = host_subset(graph, kernel)
    want, _ = blob.pack_graph_blob(host)
    # The handle holds the window's pinned blob, bytes intact, until the
    # outputs are unpacked; a later window's pack gets other memory.
    assert packed.staged is not None and packed.staged.is_pinned()
    later, _ = blob.pack_graph_blob(host, pin=True)
    assert later.data_ptr() != packed.staged.data_ptr()
    assert torch.equal(packed.staged, want)
    unpack_rank_outputs(packed)
    tree = TableRCA(MicroRankConfig(runtime=RuntimeConfig(collapse_kinds="on",
                                                          blob_staging=False)), device="cuda")
    packed_tree, _ = tree.launch_rank(graph, names, kernel)
    assert packed_tree.staged is None
    assert_outputs_bitwise(unpack_rank_outputs(packed_tree), unpack_rank_outputs(packed))
