"""Stacked windows on an NVIDIA GPU: the three kernels of a step with a
window axis (K1 over a stacked work list, the pattern pair's window
grid dimension, K5's 2B partitions) bitwise their plain versions over
50 launches, and the stacked rank program (K18) on the card bitwise the
per-window program on the card, one launch of each kernel a step for
the whole group.

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
from microrank_tpu_torch.ops import pattern, spmv, step
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
    # "walk": a grid of 8 blocks for the 4 windows' 104 units of 256
    # elements, so every block walks 13 of them.
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


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_stacked_program_on_the_card_is_bitwise_each_window(
    cuda_device, kernel, precision, aux, collapse, tol
):
    cfg = PageRankConfig(kind_precision=precision, tol=tol)
    card, graphs = stacked(cuda_device, aux, collapse, kernel)
    counts = (spmv.coo_spmv.launches, pattern.pattern_pair_group.launches,
              step.power_step.launches)
    got = rank_window_traced_core(card, cfg, SpectrumConfig(), kernel)
    torch.cuda.synchronize()
    made = (spmv.coo_spmv.launches - counts[0], pattern.pattern_pair_group.launches - counts[1],
            step.power_step.launches - counts[2])
    pair = 0 if kernel == "pallas" else cfg.iterations
    assert made == (cfg.iterations, pair, cfg.iterations)
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
