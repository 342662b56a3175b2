"""The port on an NVIDIA GPU: K1's, the pcsr kernel's and K2 / K4's CUDA
kernels against their plain versions (bitwise: the same arithmetic in the same order),
and the run lane on the card against the same lane on the CPU, for the
pinned pallas kernel and the default kernel="auto".

Every test here needs the card and skips without one (the CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
from microrank_tpu_torch.ops import pattern, spmv
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

pytestmark = pytest.mark.cuda

# A case whose injected fault ranks first (and whose tol run stops early).
CASE = SyntheticConfig(
    n_operations=60, n_traces=800, n_kinds=24, child_keep_prob=0.6, seed=5
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def random_coo(seed, n_live, n_pad, n_rows, n_cols):
    """Unsorted COO entries, one long row, trailing zero padding."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n_live)
    rows[rng.choice(n_live, n_live // 4, replace=False)] = n_rows // 2
    cols = rng.integers(0, n_cols, n_live)
    vals = rng.uniform(0.01, 1.0, n_live)
    pad = np.zeros(n_pad, np.int64)
    return (
        np.concatenate([rows, pad]).astype(np.int32),
        np.concatenate([cols, pad]).astype(np.int32),
        np.concatenate([vals, pad]).astype(np.float32),
        rng.uniform(0.0, 1.0, n_cols).astype(np.float32),
    )


def step_group(seed, device):
    """A step-shaped group (six matrices over four x slots, as
    ``STEP_X_SLOTS``) with a row of many chunks, rows of exactly CHUNK
    and CHUNK + 1 entries, empty rows and padding; returns the group on
    ``device``, the same group on the CPU, and the x vectors on both."""
    from microrank_tpu_torch.rank_backends.torch_cuda import STEP_X_SLOTS

    rng = np.random.default_rng(seed)
    n_x = (7000, 3000, 3000, 500, 3000, 3000)
    n_rows = (3000, 3000, 7000, 3000, 3000, 500)
    host, dev = [], []
    for m in range(6):
        lens = rng.integers(0, 60 if m != 1 else 3, n_rows[m])
        lens[rng.random(n_rows[m]) < 0.1] = 0
        if m == 0:
            lens[:3] = (7000, spmv.CHUNK, spmv.CHUNK + 1)
        rows = rng.permutation(np.repeat(np.arange(n_rows[m]), lens))
        n_live = rows.shape[0]
        pad = np.zeros(33, np.int64)
        arrays = (
            np.concatenate([rows, pad]).astype(np.int32),
            np.concatenate([rng.integers(0, n_x[m], n_live), pad]).astype(np.int32),
            np.concatenate([rng.uniform(0.01, 1.0, n_live), pad]).astype(np.float32),
        )
        t = [torch.from_numpy(a) for a in arrays]
        host.append(spmv.row_layout(*t, n_rows[m], n_live))
        dev.append(spmv.row_layout(*(a.to(device) for a in t), n_rows[m], n_live))
    xs = [torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
          for n in (7000, 3000, 500, 3000)]
    return (
        spmv.spmv_group(dev, STEP_X_SLOTS, n_x),
        spmv.spmv_group(host, STEP_X_SLOTS, n_x),
        [x.to(device) for x in xs],
        xs,
    )


def test_group_kernel_matches_cpu_plain_bitwise(cuda_device):
    group, cpu_group, xs, cpu_xs = step_group(3, cuda_device)
    assert group.max_chunks >= 28  # the 7,000-entry row
    before = (spmv.coo_spmv.launches, spmv.coo_spmv.spmvs)
    ys = spmv.coo_spmv_group(group, xs)
    torch.cuda.synchronize()
    assert (spmv.coo_spmv.launches, spmv.coo_spmv.spmvs) == (before[0] + 1, before[1] + 6)
    for y, ref in zip(ys, spmv.coo_spmv_group_plain(cpu_group, cpu_xs)):
        assert torch.equal(y.cpu(), ref)
    assert not group.counters.any()  # every arrival counter reset


def test_group_kernel_repeatable_over_50_launches(cuda_device):
    group, _, xs, _ = step_group(4, cuda_device)
    first = torch.cat(spmv.coo_spmv_group(group, xs)).clone()
    outs = [torch.cat(spmv.coo_spmv_group(group, xs)) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, first) for y in outs)
    assert not group.counters.any()


@pytest.mark.parametrize("seed,n_live,n_pad,n_rows,n_cols", [
    (0, 1500, 37, 77, 50),
    (1, 30001, 499, 300, 1000),
    (2, 200_000, 1000, 5000, 7000),
])
def test_kernel_matches_plain_bitwise(cuda_device, seed, n_live, n_pad, n_rows, n_cols):
    host = [torch.from_numpy(a) for a in random_coo(seed, n_live, n_pad, n_rows, n_cols)]
    dev = [a.to(cuda_device) for a in host]
    before = spmv.coo_spmv.launches
    lay = spmv.row_layout(dev[0], dev[1], dev[2], n_rows, n_live)
    y1 = spmv.coo_spmv(lay, dev[3])
    y2 = spmv.coo_spmv(lay, dev[3])
    torch.cuda.synchronize()
    assert spmv.coo_spmv.launches == before + 2
    assert torch.equal(y1, y2)
    plain = spmv.coo_spmv_plain(spmv.row_layout(*host[:3], n_rows, n_live), host[3])
    assert torch.equal(y1.cpu(), plain)


def test_wrapper_rejects_bad_cuda_inputs(cuda_device):
    rows = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    lay = spmv.row_layout(rows, rows.clone(), torch.ones(2, device=cuda_device), 2)
    with pytest.raises(ValueError, match="float32"):
        spmv.coo_spmv(lay, torch.ones(2, dtype=torch.float64, device=cuda_device))
    group = spmv.spmv_group([lay], (0,), (2,))
    x = torch.ones(2, device=cuda_device)
    with pytest.raises(ValueError, match="group's tensors"):
        spmv.coo_spmv_group(group._replace(items=group.items.cpu()), (x,))
    with pytest.raises(ValueError, match="2 floats"):
        spmv.coo_spmv_group(group, (torch.ones(3, device=cuda_device),))


@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_run_lane_on_cuda_matches_cpu(cuda_device, collapse, tmp_path):
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(runtime=RuntimeConfig(kernel="pallas", collapse_kinds=collapse))
    spmv.coo_spmv.launches = spmv.coo_spmv.spmvs = 0
    gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
    ranked = [r for r in gpu if r.ranking]
    # One launch per power-iteration step, six SpMVs in each.
    assert spmv.coo_spmv.launches == 25 * len(ranked) > 0
    assert spmv.coo_spmv.spmvs == 150 * len(ranked)
    assert ranked[0].ranking[0][0] == case.fault_pod_op
    cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    for g, c in zip(gpu, cpu):
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in g.ranking], [s for _, s in g.ranking],
            [n for n, _ in c.ranking], [s for _, s in c.ranking],
            k=len(g.ranking), rtol=1e-5,
        )
        assert ok, why
        assert g.rank_iterations == c.rank_iterations


def test_tol_program_on_cuda_matches_cpu(cuda_device, tmp_path):
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(pagerank=PageRankConfig(tol=1e-4, iterations=60))
    gpu = [r for r in run_rca_native(normal, abnormal, cfg, device="cuda") if r.ranking]
    cpu = [r for r in run_rca_native(normal, abnormal, cfg, device="cpu") if r.ranking]
    assert gpu and 0 < gpu[0].rank_iterations < 60
    assert [r.rank_iterations for r in gpu] == [r.rank_iterations for r in cpu]
    assert [r.ranking[0][0] for r in gpu] == [r.ranking[0][0] for r in cpu]


def pattern_case(seed, v, k, device, w_out=True):
    """A pattern group of two partitions with equal rows and equal
    columns, on ``device`` and on the CPU, plus rv / sv on both."""
    rng = np.random.default_rng(seed)
    host, dev, vecs = [], [], []
    for part in range(2):
        kk = k if part == 0 else k // 7 + 3
        m = (rng.random((v, kk)) < 0.3).astype(np.uint8)
        m[v // 2] = m[0]
        m[:, kk - 1] = m[:, 1]
        pat = np.packbits(m, axis=1)
        arrays = [torch.from_numpy(pat)] + [
            torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
            for n in (kk, v, v, kk, v)  # w_len, w_cov, w_out, rv, sv
        ]
        host.append(arrays)
        dev.append([a.to(device) for a in arrays])
        vecs.append(kk)

    def group(parts):
        return pattern.pattern_group(
            [a[0] for a in parts], [a[1] for a in parts], [a[2] for a in parts],
            [a[3] if w_out else None for a in parts], vecs,
        )

    return (group(dev), [a[4] for a in dev], [a[5] for a in dev],
            group(host), [a[4] for a in host], [a[5] for a in host])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("v,k", [(3000, 7000), (300, 1100)])
def test_pattern_kernel_matches_cpu_plain_bitwise(cuda_device, precision, v, k):
    # Both shapes span several row and column tiles with ragged edges;
    # at 300 x 1100 the equal rows (0, 150) and columns (1, k - 1) lie in
    # different tiles. (int8: tests/test_torch_int8.py.)
    group, rvs, svs, cpu_group, cpu_rvs, cpu_svs = pattern_case(7, v, k, cuda_device)
    before = (pattern.pattern_pair_group.launches, pattern.pattern_pair_group.products)
    outs = pattern.pattern_pair_group(group, rvs, svs, precision)
    torch.cuda.synchronize()
    assert (pattern.pattern_pair_group.launches, pattern.pattern_pair_group.products) == (
        before[0] + 1, before[1] + 4
    )
    ref = pattern.pattern_pair_plain(cpu_group, cpu_rvs, cpu_svs, precision)
    for got, want in zip(outs, ref):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    for (y_fwd, y_bwd, _), kk in zip(outs, [p.n_cols for p in group.parts]):
        assert y_fwd[0] == y_fwd[v // 2] and y_bwd[1] == y_bwd[kk - 1]
    for p in group.parts:
        assert not p.counters.any()  # every arrival counter reset


def test_pattern_kernel_repeatable_over_50_launches(cuda_device):
    group, rvs, svs, *_ = pattern_case(8, 3072, 7168, cuda_device)
    first = [torch.cat([t for t in o if t is not None])
             for o in pattern.pattern_pair_group(group, rvs, svs, "bf16")]
    for _ in range(50):
        again = [torch.cat([t for t in o if t is not None])
                 for o in pattern.pattern_pair_group(group, rvs, svs, "bf16")]
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    torch.cuda.synchronize()
    for p in group.parts:
        assert not p.counters.any()  # every stripe's arrival counter reset


@pytest.mark.parametrize("collapse,kernel", [("auto", "kind"), ("off", "packed_bf16")])
def test_auto_lane_on_cuda_matches_cpu(cuda_device, collapse, kernel, tmp_path):
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds=collapse))
    spmv.coo_spmv.launches = spmv.coo_spmv.spmvs = pattern.pattern_pair_group.launches = 0
    gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
    ranked = [r for r in gpu if r.ranking]
    assert ranked and {r.kernel for r in ranked} == {kernel}
    # One pattern-pair launch and one K1 launch (two SpMVs) per step.
    assert pattern.pattern_pair_group.launches == spmv.coo_spmv.launches == 25 * len(ranked)
    assert spmv.coo_spmv.spmvs == 50 * len(ranked)
    assert ranked[0].ranking[0][0] == case.fault_pod_op
    cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    rtol = 5e-3 if kernel == "packed_bf16" else 1e-5
    for g, c in zip(gpu, cpu):
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in g.ranking], [s for _, s in g.ranking],
            [n for n, _ in c.ranking], [s for _, s in c.ranking],
            k=len(g.ranking), rtol=rtol,
        )
        assert ok, why
        assert g.rank_iterations == c.rank_iterations


@pytest.mark.parametrize("budget,kernel", [(64 * 1024, "packed_blocked"), (4096, "pcsr")])
def test_lane_past_the_budget_on_cuda_matches_cpu(cuda_device, budget, kernel, tmp_path):
    # A lowered dense budget sends auto past it: packed_blocked (one
    # pattern-pair launch and one K1 launch of two SpMVs per step) or
    # pcsr (one launch of the pcsr kernel, six SpMVs, per step).
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(
        runtime=RuntimeConfig(collapse_kinds="off", dense_budget_bytes=budget)
    )
    spmv.coo_spmv.launches = spmv.coo_spmv.spmvs = pattern.pattern_pair_group.launches = 0
    spmv.pcsr_spmv_group.launches = spmv.pcsr_spmv_group.spmvs = 0
    gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
    ranked = [r for r in gpu if r.ranking]
    assert ranked and {r.kernel for r in ranked} == {kernel}
    n = 25 * len(ranked)
    counts = (pattern.pattern_pair_group.launches, spmv.coo_spmv.launches, spmv.coo_spmv.spmvs,
              spmv.pcsr_spmv_group.launches, spmv.pcsr_spmv_group.spmvs)
    assert counts == ((n, n, 2 * n, 0, 0) if kernel == "packed_blocked" else (0, 0, 0, n, 6 * n))
    assert ranked[0].ranking[0][0] == case.fault_pod_op
    cpu = run_rca_native(normal, abnormal, cfg, device="cpu")
    for g, c in zip(gpu, cpu):
        ok, why = tie_aware_topk_agreement(
            [n_ for n_, _ in g.ranking], [s for _, s in g.ranking],
            [n_ for n_, _ in c.ranking], [s for _, s in c.ranking],
            k=len(g.ranking), rtol=1e-5,
        )
        assert ok, why
        assert g.rank_iterations == c.rank_iterations


def test_pcsr_group_on_cuda_is_bitwise_pallas_and_plain(cuda_device, tmp_path):
    # The pcsr kernel's step, staged on the card from the partition-centric
    # views, gives the pallas work list's bits, the earlier design's (K1
    # over pcsr_layouts' work list) and its plain version's.
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        host_subset,
        pcsr_layouts,
        window_spmv_group,
    )
    from microrank_tpu_torch.testing import giant_window

    gw = giant_window(n_spans=200_000, n_ops=256)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, gw.abnormal_codes, aux="pcsr"
    )
    pc = device_subset(graph_from_numpy(host_subset(graph, "pcsr"), cuda_device), "pcsr")
    pal = device_subset(graph_from_numpy(graph, cuda_device), "pallas")
    rng = np.random.default_rng(4)
    sizes = [p.kind.shape[0] if i % 2 == 0 else p.cov_unique.shape[0]
             for i, p in enumerate((graph.normal, graph.normal, graph.abnormal, graph.abnormal))]
    xs = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(cuda_device) for n in sizes]
    y_pc = torch.cat(spmv.pcsr_spmv_group(pc.spmv_group, xs))
    y_pal = torch.cat(spmv.coo_spmv_group(pal.spmv_group, xs))
    y_prior = torch.cat(spmv.coo_spmv_group(window_spmv_group(pc, pcsr_layouts), xs))
    group = pc.spmv_group
    cpu_group = spmv.PcsrGroup(
        spmv.SpmvGroup(*(t.cpu() if torch.is_tensor(t) else t for t in group.rows)),
        tuple(spmv.EllPart(*(t.cpu() if torch.is_tensor(t) else t for t in e)) for e in group.ell),
        group.order,
    )
    y_plain = torch.cat(spmv.pcsr_spmv_group_plain(cpu_group, [x.cpu() for x in xs]))
    torch.cuda.synchronize()
    assert torch.equal(y_pc, y_pal) and torch.equal(y_pc, y_prior)
    assert torch.equal(y_pc.cpu(), y_plain)


def timeline_tables(tmp_path):
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import generate_timeline

    tl = generate_timeline(CASE, 4, [0, 1, 3])
    normal, abnormal = tl.write_csvs(tmp_path)
    return tl, load_span_table(normal, cache=False), load_span_table(abnormal, cache=False)


def test_async_loop_on_cuda_is_bitwise_the_sync_loop(cuda_device, tmp_path):
    # The same kernels in the same order on the stage worker's stream:
    # the same bits as the synchronous loop, in stream and bulk mode.
    from microrank_tpu_torch.pipeline import TableRCA

    tl, normal, table = timeline_tables(tmp_path)
    runs = {}
    for name, kw in {
        "sync": dict(pipeline_depth=1, async_dispatch=False),
        "stream": {},
        "bulk": dict(fetch_mode="bulk"),
    }.items():
        rca = TableRCA(MicroRankConfig(runtime=RuntimeConfig(**kw)), device="cuda")
        rca.fit_baseline(normal)
        runs[name] = [(r.start, r.ranking, r.rank_iterations) for r in rca.run(table)]
    ranked = [w for w in runs["sync"] if w[1]]
    assert len(ranked) >= 2 and all(w[1][0][0] == tl.fault_pod_op for w in ranked)
    assert runs["stream"] == runs["sync"] and runs["bulk"] == runs["sync"]


def test_stage_worker_launches_on_its_own_stream(cuda_device, tmp_path):
    from microrank_tpu_torch.pipeline import TableRCA

    _, normal, table = timeline_tables(tmp_path)
    rca = TableRCA(MicroRankConfig(), device="cuda")
    rca.fit_baseline(normal)
    seen = []
    real = rca.launch_rank

    def spy(*args):
        seen.append(torch.cuda.current_stream())
        return real(*args)

    rca.launch_rank = spy
    assert any(r.ranking for r in rca.run(table))
    assert seen and len(set(seen)) == 1
    assert seen[0] != torch.cuda.default_stream()
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


def test_pinned_fetch_equals_cpu_copy(cuda_device):
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        pack_rank_outputs,
        unpack_rank_outputs,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    outs = (
        torch.randint(0, 5000, (11,), generator=gen, device=cuda_device, dtype=torch.int32),
        torch.rand(11, generator=gen, device=cuda_device),
        torch.tensor(9, dtype=torch.int32, device=cuda_device),
        torch.rand((2, 25), generator=gen, device=cuda_device),
        torch.tensor(25, dtype=torch.int32, device=cuda_device),
    )
    packed = pack_rank_outputs(outs)
    assert packed.host.is_pinned() and packed.ready is not None
    got = unpack_rank_outputs(packed)
    for g, t in zip(got, outs):
        np.testing.assert_array_equal(np.asarray(g), t.cpu().numpy())


def blocked_case(seed, v, k, density, device):
    """Two partitions (the second narrower) of a bitmap of ``density``
    (1.0: every bit), with a zero row and, past one column tile, a zero
    column tile. Returns K8's blocked group and the tile kernel's group
    on ``device``, the blocked group on the CPU, and rv / sv on the
    device and on the CPU."""
    rng = np.random.default_rng(seed)
    host, dev, cols = [], [], []
    for part in range(2):
        kk = k if part == 0 else k // 3 + 5
        m = (rng.random((v, kk)) < density).astype(np.uint8)
        if density < 1.0:
            m[v // 3] = 0
            if kk > pattern.TILE_C:
                m[:, pattern.TILE_C: 2 * pattern.TILE_C] = 0
        arrays = [torch.from_numpy(np.packbits(m, axis=1))] + [
            torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
            for n in (kk, v, v, kk, v)  # w_len, w_cov, w_out, rv, sv
        ]
        host.append(arrays)
        dev.append([a.to(device) for a in arrays])
        cols.append(kk)

    def group(parts, blocked):
        return pattern.pattern_group(
            [a[0] for a in parts], [a[1] for a in parts], [a[2] for a in parts],
            [a[3] for a in parts], cols, blocked=blocked,
        )

    return (group(dev, True), group(dev, False), group(host, True),
            [a[4] for a in dev], [a[5] for a in dev], [a[4] for a in host], [a[5] for a in host])


def flat_pair(outs):
    return torch.cat([t for pair in outs for t in pair if t is not None])


@pytest.mark.parametrize("density", [0.002, 0.02, 0.5, 1.0])
@pytest.mark.parametrize("v,k", [
    (100, 400), (129, 513), (1000, 300), (100, 5000), (300, 2100), (300, 140_000),
])
def test_blocked_kernel_is_bitwise_plain_and_tile_kernel(cuda_device, v, k, density):
    # One and many row and column tiles, ragged edges (129 x 513), row
    # tiles cut into groups (most shapes) or walked by one block each
    # (300 x 140,000: past BLOCKED_TARGET_BLOCKS column tiles):
    # K8's kernel against its plain version on the CPU and against the
    # tile kernel in f32 on the same inputs, bitwise; its fwd partials
    # as blocked_partials_plain lays them out; a fold launch after it
    # where a partition has more than one column tile.
    blocked, tiled, cpu, rvs, svs, c_rvs, c_svs = blocked_case(11, v, k, density, cuda_device)
    g = pattern.pattern_pair_group
    before = (g.launches, g.blocked_launches, g.fold_launches)
    got = pattern.pattern_pair_group(blocked, rvs, svs)
    torch.cuda.synchronize()
    folds = int(any(p.n_cols > pattern.TILE_C or p.rows_per_block * pattern.TILE_R < v
                    for p in blocked.parts))
    assert (g.launches, g.blocked_launches, g.fold_launches) == (
        before[0] + 1, before[1] + 1, before[2] + folds)
    ref = pattern.pattern_pair_plain(cpu, c_rvs, c_svs)
    assert torch.equal(flat_pair(got).cpu(), flat_pair(ref))
    assert torch.equal(flat_pair(got), flat_pair(pattern.pattern_pair_group(tiled, rvs, svs)))
    for p, want in zip(blocked.parts, pattern.blocked_partials_plain(cpu, c_rvs)):
        if want is not None:
            assert torch.equal(p.part[: want.numel()].view(want.shape).cpu(), want)
        assert p.counters.numel() == 0  # no arrival counters to reset


def test_blocked_kernel_repeatable_over_50_launches(cuda_device):
    # Every launch writes every partial it folds: scratch poisoned with
    # NaN between launches changes no bit of the result.
    blocked, _, _, rvs, svs, _, _ = blocked_case(12, 2048, 40_000, 0.002, cuda_device)
    first = flat_pair(pattern.pattern_pair_group(blocked, rvs, svs))
    for i in range(50):
        if i % 10 == 0:
            for p in blocked.parts:
                p.part.fill_(float("nan"))
        assert torch.equal(flat_pair(pattern.pattern_pair_group(blocked, rvs, svs)), first)
    torch.cuda.synchronize()


def test_blocked_group_runs_f32_only(cuda_device):
    blocked, _, _, rvs, svs, _, _ = blocked_case(13, 64, 700, 0.02, cuda_device)
    with pytest.raises(ValueError, match="f32 only"):
        pattern.pattern_pair_group(blocked, rvs, svs, "bf16")
