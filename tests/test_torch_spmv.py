"""K1, the COO segment-sum SpMV: the port's plain version, the
row-sorted layout and the chunked work list its CUDA kernel consumes,
held against the JAX package's Pallas kernel (interpret mode on the
CPU) and its wrapper.

Tolerance: rtol 1e-6 against JAX — both sum float32 products, in
another order. Between the port's kernel and its plain version the
arithmetic is the same, so those compare bitwise
(tests/test_torch_cuda.py, on a card); here the plain version is held
bitwise to the kernel's order spelled out in Python.
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


def shaped_coo(seed, row_lens, n_pad, n_cols):
    """COO entries with exactly ``row_lens[r]`` entries in row r, in a
    shuffled entry order, plus ``n_pad`` trailing padding entries."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(np.repeat(np.arange(len(row_lens)), row_lens))
    n_live = rows.shape[0]
    cols = rng.integers(0, n_cols, n_live)
    vals = rng.uniform(0.01, 1.0, n_live)
    rows = np.concatenate([rows, np.zeros(n_pad, np.int64)]).astype(np.int32)
    cols = np.concatenate([cols, np.zeros(n_pad, np.int64)]).astype(np.int32)
    vals = np.concatenate([vals, np.zeros(n_pad)]).astype(np.float32)
    x = rng.uniform(0.0, 1.0, n_cols).astype(np.float32)
    return rows, cols, vals, x


def kernel_order_reference(rows, cols, vals, x, n_rows):
    """The CUDA kernel's arithmetic spelled out in Python. Per row, the
    row's entries (in entry order) are cut into chunks of CHUNK = 256 at
    positions [j * 256, (j + 1) * 256); in each chunk lane l sums
    positions l, l+32, ... in float32, then the shuffle tree 16, 8, 4,
    2, 1 gives the chunk's sum; the chunk sums are folded left to right,
    ((p0 + p1) + p2) .... An empty row is one empty chunk: 0."""
    assert spmv.CHUNK == 256
    y = np.zeros(n_rows, np.float32)
    for r in range(n_rows):
        ent = np.flatnonzero(rows == r)
        sums = []
        for j in range(0, max(len(ent), 1), spmv.CHUNK):
            lanes = np.zeros(32, np.float32)
            for q, e in enumerate(ent[j: j + spmv.CHUNK]):
                lanes[q % 32] = np.float32(lanes[q % 32] + np.float32(vals[e] * x[cols[e]]))
            off = 16
            while off:
                lanes[:off] = lanes[:off] + lanes[off: 2 * off]
                off //= 2
            sums.append(lanes[0])
        acc = sums[0]
        for p in sums[1:]:
            acc = np.float32(acc + p)
        y[r] = acc
    return y


# Row lengths of the shaped cases: a row of 8+ chunks, rows of exactly
# CHUNK and CHUNK + 1 (and one either side of two chunks), and empty
# rows inside and at the end of the row range.
SHAPED = {
    "long2100": [3, 2100, 40, 0, 17] + [5] * 40,
    "exact_chunk": [256, 257, 255, 511, 512, 513, 1, 0, 256] * 3,
    "empty_rows": [0, 0, 7, 0, 300, 0, 0, 33, 1, 0] * 5 + [0] * 9,
}

CASES = [
    # (seed, live entries, padding, rows, cols, long rows)
    (0, 1500, 37, 77, 50, ()),
    (1, 3001, 499, 300, 1000, (5, 200)),
    (2, 900, 125, 130, 7, (0,)),
] + [
    # (name, row lengths, padding, cols)
    (name, lens, 61, 90) for name, lens in SHAPED.items()
]


def case_arrays(case):
    """(rows, cols, vals, x, n_live, n_rows) of a CASES entry."""
    if isinstance(case[0], str):
        _, lens, n_pad, n_cols = case
        rows, cols, vals, x = shaped_coo(len(lens), lens, n_pad, n_cols)
        return rows, cols, vals, x, sum(lens), len(lens)
    seed, n_live, n_pad, n_rows, n_cols, long_rows = case
    rows, cols, vals, x = random_coo(seed, n_live, n_pad, n_rows, n_cols, long_rows)
    return rows, cols, vals, x, n_live, n_rows


def case_id(case):
    return case[0] if isinstance(case[0], str) else f"seed{case[0]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_and_layout_match_pallas(case):
    rows, cols, vals, x, n_live, n_rows = case_arrays(case)
    n_pad = rows.shape[0] - n_live
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


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_layout_is_stable_row_sort(case):
    rows, cols, vals, _, n_live, n_rows = case_arrays(case)
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


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_repeats_kernel_arithmetic_bitwise(case):
    rows, cols, vals, x, n_live, n_rows = case_arrays(case)
    lay = spmv.row_layout(*(torch.from_numpy(a) for a in (rows, cols, vals)), n_rows, n_live)
    y = spmv.coo_spmv_plain(lay, torch.from_numpy(x)).numpy()
    ref = kernel_order_reference(rows[:n_live], cols[:n_live], vals[:n_live], x, n_rows)
    np.testing.assert_array_equal(y, ref)


def test_equal_rows_give_bitwise_equal_sums():
    # Rows 3 and 9 carry the same value sequence (same vals, same x
    # values at their columns), 800 entries each (more than 3 chunks),
    # interleaved with other rows' entries, so they start at different
    # offsets of the row-sorted layout: their sums must be bitwise equal
    # so an exact score tie survives.
    n_seq = 800
    assert n_seq > 3 * spmv.CHUNK
    rng = np.random.default_rng(5)
    seq_v = rng.uniform(0.1, 1.0, n_seq).astype(np.float32)
    x = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    seq_c = rng.integers(0, 32, n_seq)
    noise_rows = [r for r in range(20) if r not in (3, 9)]
    rows, cols, vals = [], [], []
    for i in range(n_seq):
        for r, c in ((3, seq_c[i]), (9, seq_c[i] + 32)):
            for _ in range(int(rng.integers(0, 3))):  # noise rows in between
                rows.append(int(rng.choice(noise_rows)))
                cols.append(int(rng.integers(0, 64)))
                vals.append(float(rng.uniform()))
            rows.append(r)
            cols.append(int(c))
            vals.append(float(seq_v[i]))
    x[32:] = x[:32]  # column c and c + 32 hold the same x value
    t_rows = torch.tensor(rows, dtype=torch.int32)
    t_cols = torch.tensor(cols, dtype=torch.int32)
    t_vals = torch.tensor(vals, dtype=torch.float32)
    lay = spmv.row_layout(t_rows, t_cols, t_vals, 20)
    indptr = lay.indptr.tolist()
    assert indptr[3] != indptr[9] and indptr[4] - indptr[3] == n_seq
    y = spmv.coo_spmv(lay, torch.from_numpy(x))
    assert y[3].item() == y[9].item()
    assert y[3].item() > 0


def random_group(seed):
    """Six row layouts shaped like a step's matrices (two partitions x
    p_sr, p_ss, p_rs, with long rows, empty rows and padding) and the
    four x vectors they read through ``STEP_X_SLOTS``."""
    rng = np.random.default_rng(seed)
    n_x = (600, 90, 90, 70, 90, 90)  # rv_n, sv_n, sv_n, rv_a, sv_a, sv_a
    n_rows = (90, 90, 600, 90, 90, 70)
    lens = [
        [1200, 0, 3] + list(rng.integers(0, 40, 87)),
        list(rng.integers(0, 3, 90)),
        list(rng.integers(0, 6, 590)) + [0] * 10,
        [257, 256] + list(rng.integers(0, 30, 88)),
        [0] * 90,
        list(rng.integers(0, 300, 70)),
    ]
    layouts = []
    for m in range(6):
        assert len(lens[m]) == n_rows[m]
        rows, cols, vals, _ = shaped_coo(seed + m, lens[m], 17, n_x[m])
        t = [torch.from_numpy(a) for a in (rows, cols, vals)]
        layouts.append(spmv.row_layout(*t, n_rows[m], int(sum(lens[m]))))
    slot_len = {0: 600, 1: 90, 2: 70, 3: 90}
    xs = tuple(
        torch.from_numpy(rng.uniform(0.0, 1.0, slot_len[s]).astype(np.float32))
        for s in range(4)
    )
    return layouts, n_x, xs


def test_group_plain_equals_single_calls_bitwise():
    from microrank_tpu_torch.rank_backends.torch_cuda import STEP_X_SLOTS

    layouts, n_x, xs = random_group(7)
    group = spmv.spmv_group(layouts, STEP_X_SLOTS, n_x)
    ys = spmv.coo_spmv_group(group, xs)
    assert len(ys) == 6
    for lay, slot, y in zip(layouts, STEP_X_SLOTS, ys):
        assert y.shape == (lay.n_rows,)
        np.testing.assert_array_equal(y.numpy(), spmv.coo_spmv(lay, xs[slot]).numpy())
    # One flat y: the six outputs are consecutive views of it.
    offsets = np.cumsum([0, *group.n_rows[:-1]])
    assert all(y.data_ptr() == ys[0].data_ptr() + 4 * int(o) for y, o in zip(ys, offsets))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_work_list_cuts_rows_into_chunks(case):
    rows, cols, vals, x, n_live, n_rows = case_arrays(case)
    lay = spmv.row_layout(*(torch.from_numpy(a) for a in (rows, cols, vals)), n_rows, n_live)
    group = spmv.spmv_group([lay], (0,), (x.shape[0],))
    items = group.items.numpy()
    assert items.dtype == np.int32 and items.shape[1] == len(spmv.ITEM_FIELDS)
    slot, row, begin, end, chunk, n_chunks = items.T
    indptr = lay.indptr.numpy()
    lens = np.diff(indptr)
    assert np.all(slot == 0)
    # Rows in order, each cut at multiples of CHUNK from its start; an
    # empty row is one empty item.
    np.testing.assert_array_equal(np.bincount(row, minlength=n_rows),
                                  np.maximum(-(-lens // spmv.CHUNK), 1))
    np.testing.assert_array_equal(begin, indptr[row] + chunk * spmv.CHUNK)
    np.testing.assert_array_equal(end, np.minimum(begin + spmv.CHUNK, indptr[row + 1]))
    assert np.all(np.diff(row) >= 0) and np.all(n_chunks == np.maximum(-(-lens[row] // 256), 1))
    # The items tile the live entries exactly once.
    assert end.sum() - begin.sum() == n_live and np.all(begin[1:] == end[:-1])
    assert group.counters.shape == (n_rows,) and not group.counters.any()


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
    # The kernel does not check columns: the work list does, once, for
    # every matrix of a group.
    with pytest.raises(IndexError, match="1 column"):
        spmv.spmv_group([lay, bad], (0, 1), (2, 2))
    neg = spmv.row_layout(rows, torch.tensor([-1, 0], dtype=torch.int32), vals, 2)
    with pytest.raises(IndexError):
        spmv.spmv_group([neg], (0,), (2,))
    with pytest.raises(ValueError, match="x slots"):
        spmv.spmv_group([lay], (spmv.MAX_X,), (2,))
    with pytest.raises(ValueError, match="2 floats"):
        spmv.coo_spmv_group(spmv.spmv_group([lay], (0,), (2,)), (torch.ones(3),))


def test_cpu_tensors_never_count_a_launch():
    before = spmv.coo_spmv.launches
    rows, cols, vals, x = random_coo(3, 100, 4, 10, 10)
    t = [torch.from_numpy(a) for a in (rows, cols, vals, x)]
    spmv.coo_spmv(spmv.row_layout(*t[:3], 10), t[3])
    assert spmv.coo_spmv.launches == before
