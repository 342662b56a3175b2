"""K1, the COO segment-sum SpMV: the port's plain version and the
row-sorted layout its CUDA kernel consumes, held against the JAX
package's Pallas kernel (interpret mode on the CPU) and its wrapper.

Tolerance: rtol 1e-6 against JAX — both sum float32 products, in
another order. Between the port's kernel and its plain version the
arithmetic is the same, so those compare bitwise
(tests/test_torch_cuda.py, on a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microrank_tpu.ops.pallas_spmv import coo_matvec_pallas, coo_segment_sum_pallas
from microrank_tpu_torch.ops import spmv
from microrank_tpu_torch.ops.segment import coo_matvec

RTOL = 1e-6


def random_coo(seed, n_live, n_pad, n_rows, n_cols, long_rows=()):
    """Unsorted COO entries with ``n_pad`` trailing padding entries
    (row 0, col 0, value 0, as the graph build pads). ``long_rows``
    receive extra entries so some rows span many warps' worth of work."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n_live)
    for r in long_rows:
        rows[rng.choice(n_live, n_live // 8, replace=False)] = r
    cols = rng.integers(0, n_cols, n_live)
    vals = rng.uniform(0.01, 1.0, n_live)
    rows = np.concatenate([rows, np.zeros(n_pad, np.int64)]).astype(np.int32)
    cols = np.concatenate([cols, np.zeros(n_pad, np.int64)]).astype(np.int32)
    vals = np.concatenate([vals, np.zeros(n_pad)]).astype(np.float32)
    x = rng.uniform(0.0, 1.0, n_cols).astype(np.float32)
    return rows, cols, vals, x


def kernel_order_reference(rows, cols, vals, x, n_rows):
    """The CUDA kernel's arithmetic spelled out in Python: per row, lane
    l sums positions l, l+32, ... of the row's entries (in entry order)
    in float32, then the shuffle tree 16, 8, 4, 2, 1."""
    y = np.zeros(n_rows, np.float32)
    for r in range(n_rows):
        ent = np.flatnonzero(rows == r)
        lanes = np.zeros(32, np.float32)
        for q, e in enumerate(ent):
            lanes[q % 32] = np.float32(lanes[q % 32] + np.float32(vals[e] * x[cols[e]]))
        off = 16
        while off:
            lanes[:off] = lanes[:off] + lanes[off: 2 * off]
            off //= 2
        y[r] = lanes[0]
    return y


CASES = [
    # (seed, live entries, padding, rows, cols, long rows)
    (0, 1500, 37, 77, 50, ()),
    (1, 3001, 499, 300, 1000, (5, 200)),
    (2, 900, 125, 130, 7, (0,)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_plain_and_layout_match_pallas(case):
    seed, n_live, n_pad, n_rows, n_cols, long_rows = case
    rows, cols, vals, x = random_coo(seed, n_live, n_pad, n_rows, n_cols, long_rows)
    assert (n_live + n_pad) % 1024 and n_rows % 128
    prod = vals * x[cols]
    ref_seg = np.asarray(
        coo_segment_sum_pallas(jnp.asarray(rows), jnp.asarray(prod), n_rows, interpret=True)
    )
    ref_mv = np.asarray(
        coo_matvec_pallas(
            jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(x), n_rows, interpret=True,
        )
    )
    np.testing.assert_allclose(ref_seg, ref_mv, rtol=RTOL)

    t = [torch.from_numpy(a) for a in (rows, cols, vals, x)]
    plain = coo_matvec(t[0], t[1], t[2], t[3], n_rows).numpy()
    np.testing.assert_allclose(plain, ref_mv, rtol=RTOL)
    for n_live_arg in (None, n_live, torch.tensor(n_live, dtype=torch.int32)):
        lay = spmv.row_layout(t[0], t[1], t[2], n_rows, n_live_arg)
        y = spmv.coo_spmv(lay, t[3]).numpy()
        np.testing.assert_allclose(y, ref_mv, rtol=RTOL)
        # Dropping the zero-valued padding changes no bit.
        np.testing.assert_array_equal(
            y, spmv.coo_spmv(spmv.row_layout(*t[:3], n_rows), t[3]).numpy()
        )


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_layout_is_stable_row_sort(case):
    seed, n_live, n_pad, n_rows, n_cols, long_rows = case
    rows, cols, vals, _ = random_coo(seed, n_live, n_pad, n_rows, n_cols, long_rows)
    lay = spmv.row_layout(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals),
        n_rows, n_live,
    )
    indptr = lay.indptr.numpy()
    perm = lay.perm.numpy()
    assert lay.indptr.dtype == torch.int32 and lay.cols.dtype == torch.int32
    assert indptr[0] == 0 and indptr[-1] == n_live and np.all(np.diff(indptr) >= 0)
    for r in range(n_rows):
        seg = perm[indptr[r]: indptr[r + 1]]
        # Exactly row r's live entries, in their original order.
        np.testing.assert_array_equal(seg, np.flatnonzero(rows[:n_live] == r))
    np.testing.assert_array_equal(lay.cols.numpy(), cols[perm])
    np.testing.assert_array_equal(lay.vals.numpy(), vals[perm])
    # Padding sits past indptr[-1], outside every row.
    assert np.all(perm[n_live:] >= n_live)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_plain_repeats_kernel_arithmetic_bitwise(case):
    seed, n_live, n_pad, n_rows, n_cols, long_rows = case
    rows, cols, vals, x = random_coo(seed, n_live, n_pad, n_rows, n_cols, long_rows)
    lay = spmv.row_layout(*(torch.from_numpy(a) for a in (rows, cols, vals)), n_rows, n_live)
    y = spmv.coo_spmv_plain(lay, torch.from_numpy(x)).numpy()
    ref = kernel_order_reference(rows[:n_live], cols[:n_live], vals[:n_live], x, n_rows)
    np.testing.assert_array_equal(y, ref)


def test_equal_rows_give_bitwise_equal_sums():
    # Rows 3 and 9 carry the same value sequence (same vals, same x
    # values at their columns), interleaved with other rows' entries at
    # different offsets: their sums must be bitwise equal so an exact
    # score tie survives.
    rng = np.random.default_rng(5)
    seq_v = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    x = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    seq_c = rng.integers(0, 32, 200)
    rows, cols, vals = [], [], []
    for i in range(200):
        for r, c in ((3, seq_c[i]), (9, seq_c[i] + 32)):
            for _ in range(int(rng.integers(0, 3))):  # noise rows in between
                rows.append(int(rng.integers(10, 20)))
                cols.append(int(rng.integers(0, 64)))
                vals.append(float(rng.uniform()))
            rows.append(r)
            cols.append(int(c))
            vals.append(float(seq_v[i]))
    x[32:] = x[:32]  # column c and c + 32 hold the same x value
    t_rows = torch.tensor(rows, dtype=torch.int32)
    t_cols = torch.tensor(cols, dtype=torch.int32)
    t_vals = torch.tensor(vals, dtype=torch.float32)
    y = spmv.coo_spmv(spmv.row_layout(t_rows, t_cols, t_vals, 20), torch.from_numpy(x))
    assert y[3].item() == y[9].item()
    assert y[3].item() > 0


def test_wrapper_validates_inputs():
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([0, 1], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0])
    with pytest.raises(TypeError):
        spmv.row_layout(rows.long(), cols, vals, 2)
    with pytest.raises(TypeError):
        spmv.row_layout(rows, cols, vals.double(), 2)
    with pytest.raises(ValueError, match="out of range"):
        spmv.row_layout(torch.tensor([0, 5], dtype=torch.int32), cols, vals, 2)
    lay = spmv.row_layout(rows, cols, vals, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        spmv.coo_spmv(lay, torch.empty(2, device="meta"))
    # A column outside x fails loudly instead of being clamped.
    bad = spmv.row_layout(rows, torch.tensor([0, 7], dtype=torch.int32), vals, 2)
    with pytest.raises(IndexError):
        spmv.coo_spmv(bad, torch.ones(2))


def test_cpu_tensors_never_count_a_launch():
    before = spmv.coo_spmv.launches
    rows, cols, vals, x = random_coo(3, 100, 4, 10, 10)
    t = [torch.from_numpy(a) for a in (rows, cols, vals, x)]
    spmv.coo_spmv(spmv.row_layout(*t[:3], 10), t[3])
    assert spmv.coo_spmv.launches == before
