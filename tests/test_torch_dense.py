"""K12, the dense kernel family's products (``ops/dense.py``,
``csrc/dense_mv.cu``):

* the plain version against a float64 matvec (f32 within 1e-5 of the
  row's sum of absolute products; bf16 the same against the float64
  product of the bf16-rounded operands, since the accumulation is f32);
* its order of sums, stated element by element (lane l's sum j over
  columns (32 i + l) * vec + j, the lane's sums left to right, the
  shuffle tree), bitwise; equal rows give equal sums wherever they lie;
* a stacked group's rows bitwise each window's own, at its own smaller
  row stride;
* ``densify`` bitwise JAX's ``densify`` (the same f32 matrices), and a
  real entry at (0, 0) kept beside the padding entries that land there
  too (added, as JAX's ``.at[].add``; an overwrite would erase it);
* on the card (``-m cuda``): the kernel bitwise its plain version in f32
  and bf16, one window and stacked, with row strides past one step,
  vectors whose length is not a multiple of a load and vectors not
  16-byte aligned, over 50 launches; the launch count; what the wrapper
  refuses.

JAX is imported inside the tests that compare with it, so the card
tests run without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dense.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.ops import dense
from microrank_tpu_torch.ops.dense import DenseGroup, dense_matvecs, dense_matvecs_plain
from microrank_tpu_torch.ops.spmv import WARP

X_SLOTS = (0, 1, 1, 2, 3, 3)


def random_group(rng, v, ts, bf16, windows=None, density=0.3, ld_extra=0):
    """A step's six matrices (p_sr, p_ss, p_rs of two partitions of V
    ops and trace axes ``ts``) of random sparse values, padded to the
    kernel's row stride (plus ``ld_extra`` steps of zero columns), and
    random vectors (rv_n, sv_n, rv_a, sv_a)."""
    lead = () if windows is None else (windows,)
    mult = dense.row_multiple(bf16)
    mats, n_cols = [], []
    for t in ts:
        for rows, cols in ((v, t), (v, v), (t, v)):
            ld = -(-cols // mult) * mult + ld_extra * mult
            m = np.zeros(lead + (rows, ld), np.float32)
            vals = rng.random(lead + (rows, cols)).astype(np.float32)
            vals[rng.random(vals.shape) > density] = 0.0
            m[..., :cols] = vals
            t_m = torch.from_numpy(m)
            mats.append(t_m.to(torch.bfloat16) if bf16 else t_m)
            n_cols.append(cols)
    xs = [torch.from_numpy(rng.random(lead + (n,)).astype(np.float32))
          for n in (ts[0], v, ts[1], v)]
    return DenseGroup(tuple(mats), X_SLOTS, tuple(n_cols), bf16, windows), xs


def reference_order(mat, x, bf16):
    """One row set's sums in the kernel's order, element by element in
    numpy float32."""
    vec = dense.vec_width(bf16)
    m = mat.to(torch.float32).numpy()
    xv = np.zeros(m.shape[-1], np.float32)
    xv[: x.shape[-1]] = x.numpy()
    if bf16:
        xv = torch.from_numpy(xv).to(torch.bfloat16).to(torch.float32).numpy()
    out = []
    for row in m:
        lanes = []
        for lane in range(WARP):
            acc = [np.float32(0.0)] * vec
            for i in range(m.shape[-1] // (WARP * vec)):
                for j in range(vec):
                    c = (i * WARP + lane) * vec + j
                    acc[j] = np.float32(acc[j] + np.float32(row[c] * xv[c]))
            s = acc[0]
            for j in range(1, vec):
                s = np.float32(s + acc[j])
            lanes.append(s)
        off = WARP // 2
        while off:
            lanes = [np.float32(lanes[i] + lanes[i + off]) for i in range(off)]
            off //= 2
        out.append(lanes[0])
    return np.array(out, np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_float64(bf16):
    rng = np.random.default_rng(3)
    group, xs = random_group(rng, 40, (300, 70), bf16)
    ys = dense_matvecs(group, xs)  # CPU tensors: the plain version
    for mat, slot, n, y in zip(group.mats, group.x_slots, group.n_cols, ys):
        m = mat.to(torch.float32).numpy()[:, :n].astype(np.float64)
        x = xs[slot]
        if bf16:
            x = x.to(torch.bfloat16).to(torch.float32)
        x = x.numpy().astype(np.float64)
        want = m @ x
        scale = np.abs(m) @ np.abs(x)
        assert y.dtype == torch.float32 and y.shape == (m.shape[0],)
        assert np.all(np.abs(y.numpy() - want) <= 1e-5 * scale + 1e-30)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_order_is_the_kernels(bf16):
    rng = np.random.default_rng(5)
    group, xs = random_group(rng, 6, (45, 9), bf16, ld_extra=1)
    ys = dense_matvecs_plain(group, xs)
    for mat, slot, y in zip(group.mats, group.x_slots, ys):
        np.testing.assert_array_equal(y.numpy().view(np.int32),
                                      reference_order(mat, xs[slot], bf16).view(np.int32))


@pytest.mark.parametrize("bf16", [False, True])
def test_equal_rows_give_equal_sums(bf16):
    # Exact score ties survive: the order of a row's sums is a function
    # of the column index alone.
    rng = np.random.default_rng(7)
    group, xs = random_group(rng, 32, (200, 50), bf16, density=0.6)
    mats = list(group.mats)
    p_sr = mats[0].clone()
    p_sr[5] = p_sr[17]
    p_sr[30] = p_sr[17]
    mats[0] = p_sr
    y = dense_matvecs_plain(group._replace(mats=tuple(mats)), xs)[0]
    assert y[5].item() == y[17].item() == y[30].item()
    assert y[5].view(torch.int32).item() == y[17].view(torch.int32).item()


@pytest.mark.parametrize("bf16", [False, True])
def test_stacked_rows_are_each_windows_own(bf16):
    # A group's windows share the widest row stride; a window's rows at
    # the group's stride are bitwise its own at its own.
    rng = np.random.default_rng(11)
    group, xs = random_group(rng, 24, (150, 40), bf16, windows=3, ld_extra=2)
    ys = dense_matvecs_plain(group, xs)
    mult = dense.row_multiple(bf16)
    for b in range(3):
        own_mats = []
        for mat, n in zip(group.mats, group.n_cols):
            ld = -(-n // mult) * mult
            own_mats.append(mat[b, :, :ld].contiguous())
        own = DenseGroup(tuple(own_mats), group.x_slots, group.n_cols, bf16, None)
        want = dense_matvecs_plain(own, [x[b] for x in xs])
        for got, w in zip(ys, want):
            assert torch.equal(got[b].view(torch.int32), w.view(torch.int32))


def toy_partition(entries, ss, v, t):
    """A PartitionGraph of tensors with the given (op, trace, sr, rs)
    entries and (child, parent, val) edges, each list padded by two
    entries of value 0 at index 0."""
    from microrank_tpu_torch.graph.structures import PartitionGraph

    pad = [(0, 0, 0.0, 0.0)] * 2
    e = entries + pad
    c = ss + [(0, 0, 0.0)] * 2
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    empty = torch.zeros(0, dtype=torch.int32)
    return PartitionGraph(
        inc_op=i32([r[0] for r in e]), inc_trace=i32([r[1] for r in e]),
        sr_val=f32([r[2] for r in e]), rs_val=f32([r[3] for r in e]),
        ss_child=i32([r[0] for r in c]), ss_parent=i32([r[1] for r in c]),
        ss_val=f32([r[2] for r in c]),
        inc_trace_opmajor=empty, sr_val_opmajor=torch.zeros(0), inc_indptr_op=empty,
        inc_indptr_trace=empty, ss_indptr=empty,
        cov_bits=torch.zeros((v, 0), dtype=torch.uint8),
        ss_bits=torch.zeros((v, 0), dtype=torch.uint8),
        inv_tracelen=torch.zeros(t), inv_cov_dup=torch.zeros(v), inv_outdeg=torch.zeros(v),
        kind=torch.ones(t, dtype=torch.int32), tracelen=torch.ones(t, dtype=torch.int32),
        cov_unique=torch.ones(v, dtype=torch.int32), op_present=torch.ones(v, dtype=torch.bool),
        n_ops=torch.tensor(v, dtype=torch.int32), n_traces=torch.tensor(t, dtype=torch.int32),
        n_inc=torch.tensor(len(entries), dtype=torch.int32),
        n_ss=torch.tensor(len(ss), dtype=torch.int32),
    )


def test_densify_keeps_a_real_entry_at_the_origin():
    # The padding entries (value 0) land on (0, 0) of every matrix, where
    # the window has real entries too: they are added, so the real
    # values stay.
    g = toy_partition([(0, 0, 0.5, 0.25), (1, 0, 0.5, 0.75), (1, 2, 1.0, 0.125)],
                      [(0, 0, 0.375), (2, 1, 0.5)], v=3, t=3)
    p_ss, p_sr, p_rs = dense.densify(g, multiple=128)
    assert p_sr.shape == (3, 128) and p_ss.shape == (3, 128) and p_rs.shape == (3, 128)
    assert p_sr[0, 0].item() == 0.5 and p_rs[0, 0].item() == 0.25 and p_ss[0, 0].item() == 0.375
    assert p_sr[1, 2].item() == 1.0 and p_rs[2, 1].item() == 0.125 and p_ss[2, 1].item() == 0.5
    assert int((p_sr != 0).sum()) == 3 and int((p_ss != 0).sum()) == 2
    # Written instead of added, the padding's zeros would erase them.
    overwrite = torch.zeros(3, 3).index_put_(
        (g.inc_op.long(), g.inc_trace.long()), g.sr_val, accumulate=False)
    assert overwrite[0, 0].item() == 0.0


@pytest.mark.parametrize("collapse", ["off", "on"])
def test_densify_is_jaxs(small_case, collapse):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.rank_backends import jax_tpu
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy

    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn, collapse=collapse)
    tg = graph_from_numpy(graph, "cpu")
    for jp, tp in ((graph.normal, tg.normal), (graph.abnormal, tg.abnormal)):
        want = [np.asarray(m) for m in jax_tpu.densify(jp)]
        got = dense.densify(tp, multiple=dense.row_multiple(False))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy()[:, : w.shape[1]], w)
            assert not g.numpy()[:, w.shape[1]:].any()


def test_dense_group_casts_as_jax(small_case):
    from conftest import partition_case
    import jax.numpy as jnp
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.rank_backends import jax_tpu
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy

    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn)
    group = dense.dense_group(graph_from_numpy(graph, "cpu"), True, X_SLOTS)
    assert group.bf16 and all(m.dtype == torch.bfloat16 for m in group.mats)
    assert all(m.shape[-1] % dense.row_multiple(True) == 0 for m in group.mats)
    p_ss, p_sr, p_rs = jax_tpu.densify(graph.normal)
    for got, want in zip(group.mats[:3], (p_sr, p_ss, p_rs)):
        w = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.to(torch.float32).numpy()[:, : w.shape[1]], w)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dense kernel is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def on(group, xs, dev):
    return group._replace(mats=tuple(m.to(dev) for m in group.mats)), [x.to(dev) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("v,ts,ld_extra", [(40, (300, 70), 0), (130, (1030, 5), 2),
                                           (8, (1, 3), 0), (600, (4100, 257), 1)])
def test_kernel_is_bitwise_its_plain_version(cuda_device, bf16, windows, v, ts, ld_extra):
    rng = np.random.default_rng(v + sum(ts))
    group, xs = random_group(rng, v, ts, bf16, windows, ld_extra=ld_extra)
    want = dense_matvecs_plain(group, xs)
    dg, dxs = on(group, xs, cuda_device)
    dense.check_group(dg, cuda_device)
    before = dense.dense_matvecs.launches
    for _ in range(50):
        got = dense_matvecs(dg, dxs)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    assert dense.dense_matvecs.launches == before + 50


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_reads_unaligned_vectors(cuda_device, bf16):
    # Vectors that start off a 16-byte boundary (views one float in) and
    # lengths that are no multiple of a load take the scalar reads.
    rng = np.random.default_rng(2)
    group, xs = random_group(rng, 33, (77, 21), bf16)
    want = dense_matvecs_plain(group, xs)
    dg, _ = on(group, xs, cuda_device)
    shifted = []
    for x in xs:
        buf = torch.zeros(x.numel() + 1, device=cuda_device)
        buf[1:] = x.to(cuda_device)
        shifted.append(buf[1:])
    assert any(x.data_ptr() % 16 for x in shifted)
    for g, w in zip(dense_matvecs(dg, shifted), want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(4)
    group, xs = random_group(rng, 16, (40, 9), False)
    dg, dxs = on(group, xs, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        dense_matvecs(dg, [x.to(torch.float64) for x in dxs])
    with pytest.raises(ValueError, match="x slot"):
        dense_matvecs(dg, [dxs[1]] * 4)
    bad = dg._replace(mats=(dg.mats[0][:, :100],) + dg.mats[1:])
    with pytest.raises(ValueError, match="contiguous"):
        dense.check_group(bad, cuda_device)
