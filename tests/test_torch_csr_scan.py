"""K10, the csr route in JAX's order of sums (``ops/scan.py``,
``csrc/csr_scan.cu``).

* ``compensated_scan`` is bitwise JAX's ``compensated_cumsum``
  (``lax.associative_scan`` with the TwoSum combine) on the same inputs,
  at lengths across the kernel's block edges and on a stacked axis;
* the kernel's block decomposition (up-sweep to block totals, one block
  at the top, down-sweep from two scanned totals), repeated here at small
  block sizes to reach every level, is bitwise the recursion;
* every row sum of the route (``csr_scan_spmv`` over
  ``window_scan_group``) is bitwise JAX's ``csr_rowsum`` of the same
  entry products (products given as an input: on the CPU, XLA contracts
  a multiply it computes into the scan's first adds, see ROADMAP.md
  Faults), one window and a stacked group;
* a live column outside its x raises, on the device check and on the
  host one;
* on the card (``-m cuda``): the kernel bitwise its plain version at
  every depth of levels, one window and stacked.

JAX is imported inside the tests that compare with it, so the card
tests run with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_csr_scan.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from microrank_tpu_torch.ops import scan
from microrank_tpu_torch.ops.scan import compensated_scan, csr_scan_spmv, scan_group


def jax_scan(x):
    import jax

    from microrank_tpu.ops.segment import compensated_cumsum

    hi, lo = jax.jit(lambda v: compensated_cumsum(v, axis=-1))(x)
    return np.asarray(hi), np.asarray(lo)


def jax_rowsums(prod, indptr):
    """JAX's ``csr_rowsum`` of one window (``jax_tpu.py:671-700``, no
    shards) over given products."""
    import jax
    import jax.numpy as jnp

    from microrank_tpu.ops.segment import compensated_cumsum

    def rowsum(p, ip):
        hi, lo = compensated_cumsum(p)
        z = jnp.zeros((1,), jnp.float32)
        hi, lo = jnp.concatenate([z, hi]), jnp.concatenate([z, lo])
        a, b = ip[:-1], ip[1:]
        return (jnp.take(hi, b) - jnp.take(hi, a)) + (jnp.take(lo, b) - jnp.take(lo, a))

    return np.asarray(jax.jit(rowsum)(prod, indptr))


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 2047, 2048, 2049, 6001])
def test_compensated_scan_is_jaxs(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    hi, lo = compensated_scan(torch.from_numpy(x))
    jh, jl = jax_scan(x)
    assert bits(hi) == bits(jh) and bits(lo) == bits(jl)


def test_compensated_scan_is_jaxs_on_a_stacked_axis():
    x = np.random.default_rng(5).random((3, 1001)).astype(np.float32)
    hi, lo = compensated_scan(torch.from_numpy(x))
    jh, jl = jax_scan(x)
    assert bits(hi) == bits(jh) and bits(lo) == bits(jl)


def blocked_scan(x: torch.Tensor, log: int):
    """The kernel's design (csrc/csr_scan.cu) at blocks of 2**log
    entries: ``up`` reduces each block by the recursion's pairs to its
    total, the totals are scanned the same way (the top: one block), and
    ``down`` runs each block's down-sweep from the scan at its top and
    the previous block's. Returns (hi, lo)."""
    block = 1 << log
    comb = scan._comb

    def tree(h, l):
        levels = [(h, l)]
        for _ in range(log):
            h, l = comb((h[..., 0::2], l[..., 0::2]), (h[..., 1::2], l[..., 1::2]))
            levels.append((h, l))
        return levels

    def rec(h, l):
        n = h.shape[0]
        nb = -(-n // block)
        pad = nb * block - n
        h = torch.cat([h, torch.zeros(pad)]).view(nb, block)
        l = torch.cat([l, torch.zeros(pad)]).view(nb, block)
        levels = tree(h, l)
        if nb == 1:
            top = levels[-1]
        else:
            top = rec(levels[-1][0][:, 0].clone(), levels[-1][1][:, 0].clone())
            top = (top[0][:, None], top[1][:, None])
        prev_h = torch.cat([torch.zeros(1), top[0][:-1, 0]])
        prev_l = torch.cat([torch.zeros(1), top[1][:-1, 0]])
        scan_h, scan_l = top
        for v in range(log - 1, -1, -1):
            rh, rl = levels[v]
            width = block >> v
            out_h, out_l = rh.clone(), rl.clone()
            out_h[:, 1::2], out_l[:, 1::2] = scan_h, scan_l
            if width > 2:
                eh, el = comb((scan_h[:, :-1], scan_l[:, :-1]), (rh[:, 2::2], rl[:, 2::2]))
                out_h[:, 2::2], out_l[:, 2::2] = eh, el
            fh, fl = comb((prev_h, prev_l), (rh[:, 0], rl[:, 0]))
            out_h[1:, 0], out_l[1:, 0] = fh[1:], fl[1:]
            scan_h, scan_l = out_h, out_l
        return scan_h.reshape(-1)[:n], scan_l.reshape(-1)[:n]

    return rec(x, torch.zeros_like(x))


@pytest.mark.parametrize("log,n", [(1, 2), (1, 9), (2, 70), (3, 8), (3, 9), (3, 64), (3, 65),
                                   (3, 513), (3, 4097), (11, 5000)])
def test_the_kernels_block_design_is_the_recursion(log, n):
    x = torch.from_numpy(np.random.default_rng(n + log).random(n).astype(np.float32))
    want = compensated_scan(x)
    got = blocked_scan(x, log)
    assert bits(got[0]) == bits(want[0]) and bits(got[1]) == bits(want[1])


@pytest.fixture(scope="module")
def csr_graph():
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.testing import SyntheticConfig, generate_case

    from conftest import partition_case

    case = generate_case(SyntheticConfig(n_operations=16, n_pods=2, n_traces=160, seed=11))
    nrm, abn = partition_case(case)
    return build_window_graph(case.abnormal, nrm, abn, aux="csr")[0]


def step_inputs(graph, gen, lead=()):
    xs = []
    for g in (graph.normal, graph.abnormal):
        t, v = g.kind.shape[-1], g.cov_unique.shape[-1]
        xs += [torch.from_numpy(gen.random(lead + (t,)).astype(np.float32)),
               torch.from_numpy(gen.random(lead + (v,)).astype(np.float32))]
    return xs


def matrices(g):
    return [(g.inc_indptr_op, g.inc_trace_opmajor, g.sr_val_opmajor),
            (g.ss_indptr, g.ss_parent, g.ss_val),
            (g.inc_indptr_trace, g.inc_op, g.rs_val)]


def jax_route_rowsums(graph, xs):
    out = []
    for p, g in enumerate((graph.normal, graph.abnormal)):
        for (ip, cols, vals), slot in zip(matrices(g), (2 * p, 2 * p + 1, 2 * p + 1)):
            ip, cols, vals = (np.asarray(a) for a in (ip, cols, vals))
            prod = (torch.from_numpy(vals) * xs[slot][torch.from_numpy(cols).long()]).numpy()
            out.append(jax_rowsums(prod, ip))
    return out


def test_csr_rowsums_are_jaxs_order(csr_graph):
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import window_scan_group

    xs = step_inputs(csr_graph, np.random.default_rng(0))
    group = window_scan_group(graph_from_numpy(csr_graph, "cpu"))
    got = csr_scan_spmv(group, xs)
    for g, w in zip(got, jax_route_rowsums(csr_graph, xs)):
        assert bits(g) == bits(w)


def test_csr_rowsums_of_a_stacked_group_are_each_windows(csr_graph, small_case):
    from microrank_tpu.graph import build_window_graph

    from conftest import partition_case
    from microrank_tpu_torch.parallel import stack_window_graphs
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import window_scan_group

    nrm, abn = partition_case(small_case)
    other = build_window_graph(small_case.abnormal, nrm, abn, aux="csr")[0]
    stacked = stack_window_graphs([csr_graph, other])
    gen = np.random.default_rng(1)
    xs = step_inputs(stacked, gen, (2,))
    got = csr_scan_spmv(window_scan_group(graph_from_numpy(stacked, "cpu")), xs)
    for b in range(2):
        ws = []
        for p, g in enumerate((stacked.normal, stacked.abnormal)):
            for (ip, cols, vals), slot in zip(matrices(g), (2 * p, 2 * p + 1, 2 * p + 1)):
                ip, cols, vals = (np.asarray(a)[b] for a in (ip, cols, vals))
                prod = (torch.from_numpy(vals) * xs[slot][b][torch.from_numpy(cols).long()])
                ws.append(jax_rowsums(prod.numpy(), ip))
        for g, w in zip(got, ws):
            assert bits(g[b]) == bits(w)


def test_a_column_outside_its_x_raises(csr_graph):
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import host_counts, window_scan_group

    n = csr_graph.normal.inc_trace_opmajor.size
    bad = csr_graph._replace(normal=csr_graph.normal._replace(
        inc_trace_opmajor=np.where(np.arange(n) == 0, 10_000,
                                   csr_graph.normal.inc_trace_opmajor).astype(np.int32)))
    with pytest.raises(IndexError, match="outside"):
        window_scan_group(graph_from_numpy(bad, "cpu"))
    with pytest.raises(IndexError, match="outside"):
        host_counts(bad, "csr")


def test_levels_of_a_group():
    """The launch plan: a matrix of E entries needs ceil(log_2048 E) - 1
    levels of totals; a short matrix beside a long one gets every level,
    each at least one total."""
    assert [scan._depth(e) for e in (0, 1, 2048, 2049, 2048**2, 2048**2 + 1)] == [0, 0, 0, 1, 1, 2]
    assert scan._levels(10, 2) == [1, 1]
    assert scan._levels(5000, 1) == [3]
    ip = torch.tensor([0, 3000, 5000], dtype=torch.int32)
    group = scan_group([(ip, torch.zeros(5000, dtype=torch.int32), torch.ones(5000)),
                        (torch.tensor([0, 1], dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), torch.ones(1))],
                       (0, 0), (4, 4))
    assert group.blocks == (3, 1)
    assert group.segs[:, scan.SEG_WORDS - scan.MAX_LEVELS].tolist() == [3, 1]


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the csr scan is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def random_group(gen, sizes, windows=None):
    mats, n_x = [], []
    b = windows or 1
    for rows, e, nx in sizes:
        lens = gen.integers(0, 2 * e // max(rows, 1) + 1, size=(b, rows))
        lens = np.minimum(np.cumsum(lens, 1), e)
        ip = np.concatenate([np.zeros((b, 1), np.int64), lens], 1).astype(np.int32)
        cols = gen.integers(0, nx, size=(b, e)).astype(np.int32)
        vals = gen.random((b, e)).astype(np.float32)
        sq = (lambda a: a[0]) if windows is None else (lambda a: a)
        mats.append(tuple(torch.from_numpy(sq(a)) for a in (ip, cols, vals)))
        n_x.append(nx)
    xs = [torch.from_numpy(gen.random(((windows,) if windows else ()) + (nx,)).astype(np.float32))
          for nx in n_x]
    return mats, tuple(range(len(sizes))), n_x, xs


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("sizes", [
    [(5, 17, 9)],
    [(40, 2048, 50), (3, 1, 7)],
    [(300, 5000, 400), (10, 30, 11), (2, 0, 5)],
    [(2000, 4_200_000, 3000), (50, 900, 60)],
])
def test_kernel_is_bitwise_its_plain_version(cuda_device, windows, sizes):
    if windows and sizes[0][1] > 1_000_000:
        pytest.skip("one window at this size is enough")
    mats, slots, n_x, xs = random_group(np.random.default_rng(len(sizes)), sizes, windows)
    cpu = scan_group(mats, slots, n_x, windows)
    card = scan_group([tuple(t.to(cuda_device) for t in m) for m in mats], slots, n_x, windows)
    before = csr_scan_spmv.launches
    got = csr_scan_spmv(card, [x.to(cuda_device) for x in xs])
    assert csr_scan_spmv.launches == before + 1
    for g, w in zip(got, csr_scan_spmv(cpu, xs)):
        assert bits(g.cpu()) == bits(w)
