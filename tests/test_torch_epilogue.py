"""K6's epilogue (``ops/epilogue.py``, ``csrc/rank_epilogue.cu``): a rank
program's finish, spectrum and tie-aware top-k, held to the JAX package
on the CPU and its kernel to its plain version on the card.

* on the CPU (the wrapper's plain version), against JAX's
  ``_finish_topk`` after ``_partition_finish``, for all 13 methods and
  the ``simplematcing`` alias: top_idx and n_valid identical,
  top_scores, weights and scores at rtol 1e-5 with their NaN positions
  equal. The final carries are dyadic (multiples of 1/1024, the largest
  present one 1.0), so that every sum is exact in any order and both
  sides' weights are the same floats, and no two ops share a coverage,
  so that no scores tie but by intent (XLA's CPU arithmetic can differ
  from one IEEE op by an ulp, as seen in ochiai, and an ulp must not
  decide an order). Cases: random partitions; tarantula saturation
  (many scores exactly 1.0, tied by index); ops present only in the
  normal partition (the asymmetric branch); an empty normal partition
  (NaN weights); a NaN carry (NaN scores, last by index); no valid op
  (every score -inf, n_valid 0); k >= V; -0.0 and +0.0 scores (one
  key). Random, non-dyadic carries hold the finish at rtol 1e-5;
* an unknown method raises, the alias ranks as ``simplematching``;
* the main path's epilogue is one ``rank_epilogue`` call, bitwise the
  pieces it replaces (``torch_cuda._finish_topk`` after
  ``_partition_finish``), for a window and a stacked group;
* the launch's plan (``epilogue_plan``, pure): slices that a block holds
  and that cover the vocabulary, the cluster the least power of two,
  the warp-select for k <= 32, the forms at their edges (V 8,192, 8,193,
  16,385, 65,536 and 65,537; k 32 and 33), a card of smaller clusters,
  refused inputs, the shared memory and argument block the library
  reads;
* on the card (``cuda`` marker, skipped here): the kernel bitwise its
  plain version run on the card (bit patterns: NaN compares), one
  window and a stacked B = 3, V of 8, 2,048, 8,192 and 65,536, k of 1,
  11 and V, every method, with ties, -0.0, -inf and NaN; at the forms'
  edges (V 8,192, 8,193 and 16,385; k 1, 32, 33 and V; every method at
  8,192 / 32 and 8,193 / 33) bitwise the plain version and the first
  design's kernel; one launch a call; bad inputs refused;
* K13, every formula in one launch (``rank_epilogue_all_methods``): on
  the CPU its plain version's row m bitwise the one-formula epilogue's
  for every case, one window and B = 3, k = 11 and k = V; on the card the
  kernel bitwise its plain version and row m bitwise the one-formula
  kernel's launch (V 8 to 65,537: a block, clusters of 2 and 4, the
  first design; k 1, 11, 33 and V; the first design's kernel too), one
  launch a call, counted as "all_methods"; the checked launch refuses
  the methods axis.

JAX is imported inside the CPU tests only, so the card's machine (no
JAX) runs the card tests alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_epilogue.py
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops import epilogue
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset
from microrank_tpu_torch.spectrum.formulas import FORMULAS
from microrank_tpu_torch.spectrum.formulas import METHODS as ALL_METHODS
from microrank_tpu_torch.testing import giant_window

RTOL = 1e-5
METHODS = sorted(FORMULAS)  # the 13 formulas and the "simplematcing" alias
CASES = ("random", "tarantula_saturation", "only_in_normal", "empty_normal", "nan_carry",
         "no_valid", "k_at_least_v", "signed_zeros")


class Part(NamedTuple):
    """The fields of a partition the epilogue reads."""

    op_present: np.ndarray
    cov_unique: np.ndarray
    n_traces: np.ndarray
    n_ops: np.ndarray


class Window(NamedTuple):
    normal: Part
    abnormal: Part


def distinct_cov(rng, v, n_traces, lead=()):
    """Each op's covering traces, distinct across the ops (so that no two
    ops' scores tie but by intent), in [1, n_traces]."""
    rows = [rng.permutation(n_traces)[:v] + 1 for _ in range(int(np.prod(lead, dtype=int)))]
    return np.stack(rows).reshape(lead + (v,)).astype(np.int32)


def random_part(rng, v, n_traces, present=0.7, lead=()):
    n_traces = max(n_traces, v)
    op_present = rng.random(lead + (v,)) < present
    cov = np.where(op_present, distinct_cov(rng, v, n_traces, lead), 0).astype(np.int32)
    return Part(op_present, cov, np.full(lead, n_traces, np.int32),
                op_present.sum(-1).astype(np.int32))


def dyadic_carry(rng, part, lead=()):
    """A final carry of multiples of 1/1024 on the present ops (0
    elsewhere), its largest present value 1.0."""
    v = part.op_present.shape[-1]
    sv = rng.integers(0, 1024, lead + (v,)).astype(np.float32) / np.float32(1024)
    sv = np.where(part.op_present, sv, np.float32(0))
    flat_sv, flat_p = sv.reshape(-1, v), part.op_present.reshape(-1, v)
    for row, present in zip(flat_sv, flat_p):
        if present.any():
            row[np.flatnonzero(present)[0]] = 1.0
    return flat_sv.reshape(sv.shape)


def make_case(name, rng, v=300, lead=()):
    """(window, sv_n, sv_a) of one named case."""
    if name == "k_at_least_v":
        v = 5
    n, a = random_part(rng, v, 5000, lead=lead), random_part(rng, v, 3000, lead=lead)
    if name == "tarantula_saturation":
        # a-present ops covered by every abnormal trace and no normal
        # trace, present in the normal partition: ef / (ef + 0) = 1,
        # ep = 0, so tarantula gives exactly 1.0.
        sat = rng.random(lead + (v,)) < 0.4
        a = a._replace(op_present=a.op_present | sat,
                       cov_unique=np.where(sat, a.n_traces[..., None],
                                           a.cov_unique).astype(np.int32))
        n = n._replace(op_present=n.op_present | sat,
                       cov_unique=np.where(sat, 0, n.cov_unique).astype(np.int32))
        a = a._replace(n_ops=a.op_present.sum(-1).astype(np.int32))
        n = n._replace(n_ops=n.op_present.sum(-1).astype(np.int32))
    if name == "only_in_normal":
        only = rng.random(lead + (v,)) < 0.3
        a = a._replace(op_present=a.op_present & ~only,
                       cov_unique=np.where(only, 0, a.cov_unique).astype(np.int32))
        fresh = distinct_cov(rng, v, int(n.n_traces.flat[0]), lead)
        n = n._replace(op_present=n.op_present | only,
                       cov_unique=np.where(only, fresh, n.cov_unique).astype(np.int32))
        a = a._replace(n_ops=a.op_present.sum(-1).astype(np.int32))
        n = n._replace(n_ops=n.op_present.sum(-1).astype(np.int32))
    if name in ("empty_normal", "no_valid"):
        n = Part(np.zeros_like(n.op_present), np.zeros_like(n.cov_unique),
                 np.zeros_like(n.n_traces), np.zeros_like(n.n_ops))
    if name == "no_valid":
        a = Part(np.zeros_like(a.op_present), np.zeros_like(a.cov_unique),
                 np.zeros_like(a.n_traces), np.zeros_like(a.n_ops))
    sv_n, sv_a = dyadic_carry(rng, n, lead), dyadic_carry(rng, a, lead)
    if name == "nan_carry":
        sv_a.reshape(-1, v)[:, 3] = np.nan
    if name == "signed_zeros":
        # Present ops of carry -0.0 and +0.0: their weights, ef and the
        # jaccard score keep the sign; the ranking ties them by index.
        zero = (rng.random(lead + (v,)) < 0.3) & a.op_present
        sv_a = np.where(zero, np.where(rng.random(lead + (v,)) < 0.5, -0.0, 0.0),
                        sv_a).astype(np.float32)
    return Window(n, a), sv_n, sv_a


def to_torch(w: Window, device="cpu") -> Window:
    return Window(*(Part(*(torch.from_numpy(np.array(x)).to(device) for x in p)) for p in w))


def jax_epilogue(w: Window, sv_n, sv_a, method, top_max=5, extra_rows=6):
    """JAX's finish of both partitions, then ``_finish_topk``."""
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import SpectrumConfig as JaxSpectrum
    from microrank_tpu.rank_backends import jax_tpu

    jw = jax.tree.map(jnp.asarray, w)
    n_weight, score_n = jax_tpu._partition_finish(jw.normal, jnp.asarray(sv_n))
    a_weight, score_a = jax_tpu._partition_finish(jw.abnormal, jnp.asarray(sv_a))
    cfg = JaxSpectrum(method=method, top_max=top_max, extra_rows=extra_rows)
    top = jax_tpu._finish_topk(jw, n_weight, a_weight, cfg)
    return tuple(np.asarray(x) for x in (n_weight, a_weight, score_n, score_a, *top))


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def check_against_jax(w, sv_n, sv_a, method, **spectrum):
    got = epilogue.rank_epilogue(*to_torch(w), torch.from_numpy(sv_n), torch.from_numpy(sv_a),
                                 SpectrumConfig(method=method, **spectrum))
    want = jax_epilogue(w, sv_n, sv_a, method, **spectrum)
    for x, y in zip(got[:4], want[:4]):
        assert_close(x.numpy(), y)
    np.testing.assert_array_equal(got.top_idx.numpy(), want[4])
    assert_close(got.top_scores.numpy(), want[5])
    assert int(got.n_valid) == int(want[6])
    return got


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_epilogue_matches_jax(case, method):
    rng = np.random.default_rng(sum(map(ord, case + method)))
    w, sv_n, sv_a = make_case(case, rng)
    got = check_against_jax(w, sv_n, sv_a, method)
    v = sv_n.shape[-1]
    k = min(SpectrumConfig().n_rows, v)
    assert got.top_idx.shape == (k,)
    if case == "no_valid":
        assert int(got.n_valid) == 0
        assert torch.equal(got.top_idx, torch.arange(k, dtype=torch.int32))
        assert bool((got.top_scores == float("-inf")).all())
    if case == "empty_normal":
        assert bool(torch.isnan(got.n_weight).all())
    if case == "nan_carry":
        assert bool(torch.isnan(got.a_weight).all())


def test_tarantula_saturation_ties_by_index():
    rng = np.random.default_rng(5)
    w, sv_n, sv_a = make_case("tarantula_saturation", rng)
    got = check_against_jax(w, sv_n, sv_a, "tarantula", top_max=40, extra_rows=0)
    ones = got.top_idx[got.top_scores == 1.0].tolist()
    assert len(ones) == 40 and ones == sorted(ones)


def test_signed_zeros_are_one_key():
    rng = np.random.default_rng(6)
    w, sv_n, sv_a = make_case("signed_zeros", rng)
    got = check_against_jax(w, sv_n, sv_a, "jaccard", top_max=300, extra_rows=0)
    zero = got.top_scores == 0.0
    assert int(zero.sum()) > 10
    assert not torch.signbit(got.top_scores[zero]).any()  # +0: the sort key
    zero_idx = got.top_idx[zero].tolist()
    assert zero_idx == sorted(zero_idx)


def test_nan_scores_come_last_by_index():
    rng = np.random.default_rng(7)
    w, sv_n, sv_a = make_case("nan_carry", rng)
    got = check_against_jax(w, sv_n, sv_a, "ochiai", top_max=300, extra_rows=0)
    nan = torch.isnan(got.top_scores)
    first = int(nan.int().argmax())
    assert nan.any() and bool(nan[first:].all())
    assert got.top_idx[first:].tolist() == sorted(got.top_idx[first:].tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_finish_of_random_carries_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w, _, _ = make_case("random", rng, v=2000)
    sv_n = rng.random(2000).astype(np.float32)
    sv_a = rng.random(2000).astype(np.float32)
    got = epilogue.rank_epilogue(*to_torch(w), torch.from_numpy(sv_n), torch.from_numpy(sv_a),
                                 SpectrumConfig())
    want = jax_epilogue(w, sv_n, sv_a, "dstar2")
    for x, y in zip(got[:4], want[:4]):
        assert_close(x.numpy(), y)


def test_the_alias_ranks_as_simplematching_and_unknown_methods_raise():
    rng = np.random.default_rng(8)
    w, sv_n, sv_a = make_case("random", rng)
    args = (*to_torch(w), torch.from_numpy(sv_n), torch.from_numpy(sv_a))
    a = epilogue.rank_epilogue(*args, SpectrumConfig(method="simplematcing"))
    b = epilogue.rank_epilogue(*args, SpectrumConfig(method="simplematching"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert epilogue.method_id("simplematcing") == epilogue.method_id("simplematching")
    with pytest.raises(ValueError, match="unknown spectrum method"):
        epilogue.rank_epilogue(*args, SpectrumConfig(method="nope"))
    with pytest.raises(ValueError, match="unknown spectrum method"):
        epilogue.method_id("nope")


def test_stacked_epilogue_is_each_windows_own():
    rng = np.random.default_rng(9)
    w, sv_n, sv_a = make_case("random", rng, lead=(3,))
    cfg = SpectrumConfig(method="ochiai")
    got = epilogue.rank_epilogue(*to_torch(w), torch.from_numpy(sv_n), torch.from_numpy(sv_a),
                                 cfg)
    for b in range(3):
        own = Window(*(Part(*(x[b] for x in p)) for p in w))
        want = epilogue.rank_epilogue(*to_torch(own), torch.from_numpy(sv_n[b]),
                                      torch.from_numpy(sv_a[b]), cfg)
        for x, y in zip(got, want):
            assert torch.equal(x[b].view(torch.int32) if x.dtype == torch.float32 else x[b],
                               y.view(torch.int32) if y.dtype == torch.float32 else y)


def rows_of(out, m):
    """Formula m's row of an all-methods epilogue as a one-formula
    epilogue's fields."""
    return out._replace(top_idx=out.top_idx[..., m, :], top_scores=out.top_scores[..., m, :])


def assert_same_bits(got, want):
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("top_max", [5, 1000])
def test_all_methods_rows_are_the_one_method_epilogues(case, lead, top_max):
    rng = np.random.default_rng(21)
    w, sv_n, sv_a = make_case(case, rng, lead=lead)
    args = (*to_torch(w), torch.from_numpy(sv_n), torch.from_numpy(sv_a))
    cfg = SpectrumConfig(top_max=top_max)
    every = epilogue.rank_epilogue_all_methods(*args, cfg)
    v = sv_n.shape[-1]
    assert every.top_idx.shape == lead + (13, min(top_max + 6, v))
    for m, method in enumerate(ALL_METHODS):
        one = epilogue.rank_epilogue(*args, SpectrumConfig(method=method, top_max=top_max))
        assert_same_bits(rows_of(every, m), one)


def small_window():
    gw = giant_window(n_spans=8000, n_ops=13, spans_per_trace=2, seed=4)
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, gw.normal_codes, gw.abnormal_codes, aux="kind", collapse="on"
    )
    return host_subset(graph, "kind")


@pytest.mark.parametrize("stacked", [False, True])
def test_rank_program_epilogue_is_one_call_bitwise_the_pieces(stacked, monkeypatch):
    host = small_window()
    if stacked:
        host = stack_window_graphs([host, host])
    dg = device_subset(graph_from_numpy(host, "cpu"), "kind")
    cfg = SpectrumConfig(method="tarantula")
    calls = []

    def spy(*args):
        calls.append(args[-1])
        return epilogue.rank_epilogue(*args)

    monkeypatch.setattr(torch_cuda, "rank_epilogue", spy)
    weights = torch_cuda.window_weights_full(dg, PageRankConfig(), "kind")
    ranked = torch_cuda.rank_window_traced_core(dg, PageRankConfig(), cfg, "kind")
    assert len(calls) == 2
    n_weight, a_weight = weights[:2]
    top_idx, top_scores, n_valid = torch_cuda._finish_topk(dg, n_weight, a_weight, cfg)
    assert torch.equal(ranked[0], top_idx)
    assert torch.equal(ranked[1].view(torch.int32), top_scores.view(torch.int32))
    assert torch.equal(ranked[2], n_valid)


# ------------------------------------------------------------------ plan

CARD = epilogue.H100


@settings(max_examples=200, deadline=None)
@given(v=st.integers(1, 200_000), k=st.integers(1, 3000), windows=st.integers(1, 65535))
def test_epilogue_plan_covers_the_vocabulary_in_slices_a_block_holds(v, k, windows):
    k = min(k, v)
    plan = epilogue.epilogue_plan(v, k, windows, CARD)
    assert plan.k_pad >= k and plan.k_pad & (plan.k_pad - 1) == 0 and plan.k_pad < 2 * k
    if plan.form == "first":
        assert v > CARD.cluster_max * CARD.slice_max and plan.select == "first"
        return
    assert plan.select == ("warp" if k <= CARD.warp_k else
                           "sort" if k >= epilogue.SORT_SHARE * v else "radix")
    assert plan.slice <= CARD.slice_max and plan.cluster * plan.slice >= v
    if plan.select == "sort":
        # A list of a power of two that holds the block's slice.
        assert plan.sort_keys >= max(plan.slice, 32) > plan.sort_keys // 2
        assert plan.sort_keys & (plan.sort_keys - 1) == 0
    else:
        assert plan.sort_keys == 0
    assert plan.smem == epilogue.window_smem(plan.slice, plan.sort_keys) <= 227 * 1024 - 8192
    if plan.form == "block":
        assert plan.cluster == 1 and plan.slice == v <= CARD.slice_max
    else:
        # The least power of two of whole-tile slices; its blocks' tiles
        # are the window's tiles in order.
        assert plan.form == "cluster" and v > CARD.slice_max
        assert plan.cluster & (plan.cluster - 1) == 0 and plan.cluster <= CARD.cluster_max
        assert plan.cluster // 2 * CARD.slice_max < v
        assert plan.slice % CARD.tile == 0


@pytest.mark.parametrize("v,k,form,select,cluster", [
    (1, 1, "block", "warp", 1), (3072, 11, "block", "warp", 1), (8192, 32, "block", "warp", 1),
    (8192, 33, "block", "radix", 1), (8193, 11, "cluster", "warp", 2),
    (16_385, 11, "cluster", "warp", 4), (65_536, 65_536, "cluster", "sort", 8),
    (65_536, 33, "cluster", "radix", 8), (3072, 3072, "block", "sort", 1),
    (65_537, 11, "first", "first", 1),
])
def test_epilogue_plan_forms_at_their_edges(v, k, form, select, cluster):
    plan = epilogue.epilogue_plan(v, k, 3, CARD)
    assert (plan.form, plan.select, plan.cluster) == (form, select, cluster)


def test_epilogue_plan_of_a_card_of_smaller_clusters_and_the_first_design():
    small = CARD._replace(cluster_max=2)
    assert epilogue.epilogue_plan(16_384, 11, 1, small).cluster == 2
    assert epilogue.epilogue_plan(16_385, 11, 1, small).form == "first"
    assert epilogue.epilogue_plan(3072, 11, 1, CARD, first_design=True) == (
        epilogue.EpiloguePlan("first", "first", 1, 3072, 16, 0))


@pytest.mark.parametrize("v,k,windows", [(0, 1, 1), (5, 0, 1), (5, 6, 1), (5, 1, 0),
                                         (5, 1, 65536), (epilogue.MAX_WIDTH + 1, 1, 1)])
def test_epilogue_plan_refuses_what_the_kernel_does_not_take(v, k, windows):
    with pytest.raises(ValueError, match="epilogue_plan"):
        epilogue.epilogue_plan(v, k, windows, CARD)


def test_epilogue_shared_memory_is_the_library_layout():
    # csrc window_smem: 1,024 keys, four 4-byte rows and two 1-byte rows
    # with 16 bytes of room each, rounded to 16.
    assert epilogue.window_smem(3072) == 8192 + 4 * 12304 + 2 * 3088
    assert epilogue.window_smem(8192) == 155_744
    # The argument block: 33 words, K14's check words, residual trace,
    # n_iters and steps, K13's method rows and the sort's list.
    assert epilogue.ARGS.size == 8 * 39


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the epilogue is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def card_case(case, v, windows, seed):
    """A case's inputs with random (non-dyadic) carries, on the card."""
    rng = np.random.default_rng(seed)
    lead = () if windows is None else (windows,)
    w, sv_n, sv_a = make_case(case, rng, v=v, lead=lead)
    if case not in ("nan_carry", "signed_zeros"):
        sv_n = np.where(w.normal.op_present, rng.random(sv_n.shape), 0).astype(np.float32)
        sv_a = np.where(w.abnormal.op_present, rng.random(sv_a.shape), 0).astype(np.float32)
    return w, torch.from_numpy(sv_n), torch.from_numpy(sv_a)


def assert_bitwise(got, want):
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x.cpu(), y.cpu())


def card_check(device, case, v, windows, method, k, first_design=False):
    """The kernel bitwise its plain version (and, with ``first_design``,
    the first design's kernel bitwise it too)."""
    w, sv_n, sv_a = card_case(case, v, windows, v + k)
    tw = to_torch(w, device)
    cfg = SpectrumConfig(method=method, top_max=k, extra_rows=0)
    args = (*tw, sv_n.to(device), sv_a.to(device), cfg)
    want = epilogue.rank_epilogue_plain(*args)
    before = epilogue.rank_epilogue.launches
    got = epilogue.rank_epilogue(*args)
    torch.cuda.synchronize()
    assert epilogue.rank_epilogue.launches - before == 1
    assert_bitwise(got, want)
    if first_design:
        assert_bitwise(epilogue.rank_epilogue(*args, first_design=True), want)


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("v", [8, 2048, 8192, 65_536])
@pytest.mark.parametrize("k", [1, 11, "v"])
def test_epilogue_kernel_is_bitwise_its_plain_version(cuda_device, k, v, windows):
    k = v if k == "v" else min(k, v)
    for case in ("random", "tarantula_saturation", "signed_zeros", "nan_carry"):
        card_check(cuda_device, case, v, windows, "tarantula", k)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_epilogue_kernel_every_method_and_case(cuda_device, case, method):
    for windows in (None, 3):
        card_check(cuda_device, case, 2048, windows, method, 11)


@pytest.mark.cuda
def test_epilogue_kernel_refuses_what_it_does_not_take(cuda_device):
    w, sv_n, sv_a = card_case("random", 64, None, 0)
    tw = to_torch(w, cuda_device)
    sv_n, sv_a = sv_n.to(cuda_device), sv_a.to(cuda_device)
    with pytest.raises(ValueError, match="unknown spectrum method"):
        epilogue.rank_epilogue(*tw, sv_n, sv_a, SpectrumConfig(method="nope"))
    with pytest.raises(ValueError, match="float32"):
        epilogue.rank_epilogue(*tw, sv_n.double(), sv_a, SpectrumConfig())
    bad = tw.normal._replace(op_present=tw.normal.op_present.int())
    with pytest.raises(ValueError, match="bool"):
        epilogue.rank_epilogue(bad, tw.abnormal, sv_n, sv_a, SpectrumConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("v", [8192, 8193, 16_385])
@pytest.mark.parametrize("k", [1, 32, 33, "v"])
def test_epilogue_kernel_at_its_form_edges(cuda_device, k, v, windows):
    # V at the one-block limit and one past it (a cluster of 2), a cluster
    # of 4 whose last block holds nothing; k at both sides of the
    # warp-select's limit and V (the radix select, keys sorted in scratch).
    k = v if k == "v" else k
    cases = ("random", "tarantula_saturation", "signed_zeros", "nan_carry", "empty_normal",
             "no_valid")
    for case in cases:
        card_check(cuda_device, case, v, windows, "tarantula", k, first_design=True)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("v,k", [(8192, 32), (8193, 33)])
def test_epilogue_kernel_every_method_at_the_block_and_cluster_edges(cuda_device, v, k, method):
    for case in ("random", "tarantula_saturation", "only_in_normal"):
        card_check(cuda_device, case, v, 3, method, k, first_design=True)


def card_check_all(device, case, v, windows, k, first_design=False):
    """K13 bitwise its plain version, and row m bitwise the one-formula
    launch of formula m."""
    w, sv_n, sv_a = card_case(case, v, windows, v + 3 * k)
    tw = to_torch(w, device)
    cfg = SpectrumConfig(top_max=k, extra_rows=0)
    args = (*tw, sv_n.to(device), sv_a.to(device))
    want = epilogue.rank_epilogue_plain(*args, cfg, all_methods=True)
    before = (epilogue.rank_epilogue.launches, epilogue.rank_epilogue.by_kind["all_methods"])
    got = epilogue.rank_epilogue_all_methods(*args, cfg, first_design=first_design)
    torch.cuda.synchronize()
    assert (epilogue.rank_epilogue.launches - before[0],
            epilogue.rank_epilogue.by_kind["all_methods"] - before[1]) == (1, 1)
    assert_bitwise(got, want)
    for m, method in enumerate(ALL_METHODS):
        one = epilogue.rank_epilogue(*args, SpectrumConfig(method=method, top_max=k, extra_rows=0),
                                     first_design=first_design)
        assert_bitwise(rows_of(got, m), one)


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("v", [8, 3072, 8193, 16_385, 65_537])
@pytest.mark.parametrize("k", [1, 11, 33, "v"])
def test_all_methods_kernel_is_bitwise_its_plain_version_and_each_formula(cuda_device, k, v,
                                                                          windows):
    k = v if k == "v" else min(k, v)
    for case in ("random", "tarantula_saturation", "nan_carry", "only_in_normal"):
        card_check_all(cuda_device, case, v, windows, k)
    card_check_all(cuda_device, "signed_zeros", v, windows, k, first_design=True)


@pytest.mark.cuda
def test_the_checked_launch_refuses_the_methods_axis(cuda_device):
    w, sv_n, sv_a = card_case("random", 64, None, 0)
    tw = to_torch(w, cuda_device)
    with pytest.raises(ValueError, match="one formula"):
        epilogue._rank_epilogue(*tw, sv_n.to(cuda_device), sv_a.to(cuda_device),
                                SpectrumConfig(), False, None, check=True, all_methods=True)
