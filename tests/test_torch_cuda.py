"""The port on an NVIDIA GPU: K1's CUDA kernel against its plain
version, and the run lane on the card against the same lane on the CPU.

Every test here needs the card and skips without one (the CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
from microrank_tpu_torch.ops import spmv
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
    with pytest.raises(ValueError, match="indptr"):
        spmv.coo_spmv(lay._replace(indptr=lay.indptr.cpu()), torch.ones(2, device=cuda_device))


@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_run_lane_on_cuda_matches_cpu(cuda_device, collapse, tmp_path):
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(runtime=RuntimeConfig(collapse_kinds=collapse))
    spmv.coo_spmv.launches = 0
    gpu = run_rca_native(normal, abnormal, cfg, device="cuda")
    ranked = [r for r in gpu if r.ranking]
    assert spmv.coo_spmv.launches == 150 * len(ranked) > 0
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
