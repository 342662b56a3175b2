"""The epilogue's top-k past the warp-select (``csrc/rank_epilogue.cu``
``epilogue_window``, ``ops/epilogue.py`` ``epilogue_plan``): the sort of
every key in shared memory, merged across a cluster, against the radix
select and the plain version.

* on the CPU, a model of the kernel's sort as it computes it: each
  block's slice of 64-bit keys (``sort_key``: descending score, index
  on ties, NaN last) padded with keys above every key to the plan's
  list, sorted by the bitonic network split as ``sort_list<Q>`` splits
  it (runs of 32 Q keys a warp, key j * 32 + lane of a run in register
  j: shuffles below stride 32, register swaps up to the run, the
  strides past it over shared memory), then each block's keys of rank <
  k written by merge path (its place in its list plus, by binary
  search, the keys below it in each peer's list). It equals a model of
  the radix select (8-bit digits from the top, the bin of the k-th key,
  its keys gathered and sorted) and the plain version's stable sort, at
  k of 33, V / 2 and V, on one block and on clusters of 2 and 4 slices
  (the last one empty), with ties, -inf, NaN and signed zeros;
* the plan sorts from ``SORT_SHARE`` of V on, and a measurement may ask
  for either selection past the warp-select;
* on the card (``cuda`` marker, skipped here): the kernel's sort and its
  radix select bitwise the plain version, one window and three, K13's
  rows too.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_epilogue_sort.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import SpectrumConfig
from microrank_tpu_torch.ops import epilogue

CARD = epilogue.H100
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def sort_keys(scores: np.ndarray) -> np.ndarray:
    """``rank_common.cuh`` ``sort_key`` of canonical scores (score + 0)
    at their indices."""
    s = scores.astype(np.float32)
    u = (-s).view(np.uint32).astype(np.uint64)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    hi = np.where(np.isnan(s), np.uint64(0xFFFFFFFF), hi).astype(np.uint64)
    return (hi << np.uint64(32)) | np.arange(s.shape[0], dtype=np.uint64)


def compare_exchange(keys, lo, hi, ascending):
    x, y = keys[lo], keys[hi]
    swap = (x > y) == ascending
    keys[lo] = np.where(swap, y, x)
    keys[hi] = np.where(swap, x, y)


def run_stages(regs, base, size, strides):
    """``run_stage`` on every run at once: regs [runs, Q, 32] (register
    j of lane l holds key base + j * 32 + l of the run)."""
    runs, q, _ = regs.shape
    lane = np.arange(32)
    for stride in strides:
        i = base[:, None, None] + np.arange(q)[None, :, None] * 32 + lane[None, None, :]
        ascending = (i & size) == 0
        if stride < 32:
            y = regs[:, :, lane ^ stride]                       # __shfl_xor_sync
            upper = (lane & stride) != 0
            regs = np.where((y < regs) == (upper == ~ascending), y, regs)
        else:
            d = stride // 32
            for j in range(q):
                if j & d:
                    continue
                x, y = regs[:, j].copy(), regs[:, j + d].copy()
                swap = (y < x) == ascending[:, j]
                regs[:, j] = np.where(swap, y, x)
                regs[:, j + d] = np.where(swap, x, y)
    return regs


def sort_list(keys: np.ndarray) -> np.ndarray:
    """``sort_list<Q>`` of a list of n keys (a power of two, >= 32)."""
    n = keys.shape[0]
    q = 1 if n <= 1024 else 2 if n == 2048 else 4
    run = 32 * q
    runs = n // run
    base = np.arange(runs) * run

    def to_regs(k):
        return k.reshape(runs, q, 32)

    def halves(top):
        out, s = [], top
        while s >= 1:
            out.append(s)
            s //= 2
        return out

    regs = to_regs(keys.copy())
    size = 2
    while size <= run:
        regs = run_stages(regs, base, size, halves(size // 2))
        size *= 2
    keys = regs.reshape(-1)
    while size <= n:
        stride = size // 2
        while stride >= run:   # over shared memory, a barrier each
            i = np.arange(n // 2)
            lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1))
            compare_exchange(keys, lo, lo + stride, (lo & size) == 0)
            stride //= 2
        keys = run_stages(to_regs(keys), base, size, halves(run // 2)).reshape(-1)
        size *= 2
    return keys


def keys_below(lst: np.ndarray, key) -> int:
    """csrc ``keys_below``: binary search over a sorted list of n keys."""
    n, c, step = lst.shape[0], 0, lst.shape[0]
    while step > 0:
        if c + step <= n and lst[c + step - 1] < key:
            c += step
        step //= 2
    return c


def sort_select(scores: np.ndarray, k: int, plan) -> np.ndarray:
    """The kernel's sort path over the plan's slices: top_idx [k]."""
    v = scores.shape[0]
    keys = sort_keys(scores)
    lists, lens = [], []
    for r in range(plan.cluster):
        lo = r * plan.slice
        n_live = max(0, min(plan.slice, v - lo))
        lst = np.full(plan.sort_keys, PAD, dtype=np.uint64)
        lst[:n_live] = keys[lo: lo + n_live]
        lists.append(sort_list(lst))
        lens.append(n_live)
    top = np.full(k, -1, dtype=np.int64)
    for r, (lst, n_live) in enumerate(zip(lists, lens)):
        for i in range(min(n_live, k)):
            rank = i + sum(keys_below(other, lst[i]) for rr, other in enumerate(lists) if rr != r)
            if rank < k:
                assert top[rank] == -1, "two keys of one rank"
                top[rank] = int(lst[i] & np.uint64(0xFFFFFFFF))
    assert (top >= 0).all(), "a rank below k no key took"
    return top


def radix_select(scores: np.ndarray, k: int) -> np.ndarray:
    """The radix select: 8-bit digits from the top, the bin that holds
    the k-th key, done where the whole bin is wanted; the keys at or
    below the prefix gathered and sorted."""
    keys = sort_keys(scores)
    pre, want, shift = np.uint64(0), k, 56
    while True:
        sh = np.uint64(shift)
        sel = keys if shift == 56 else keys[(keys >> np.uint64(shift + 8))
                                            == (pre >> np.uint64(shift + 8))]
        hist = np.bincount(((sel >> sh) & np.uint64(255)).astype(np.int64), minlength=256)
        incl = np.cumsum(hist)
        b = int(np.searchsorted(incl, want))  # the first bin with incl >= want
        excl = incl[b] - hist[b]
        pre = pre | (np.uint64(b) << sh)
        done = hist[b] == want - excl
        want -= int(excl)
        if done or shift == 0:
            break
        shift -= 8
    top = pre >> np.uint64(shift)
    gathered = np.sort(keys[(keys >> np.uint64(shift)) <= top])
    return (gathered[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def canonical_scores(v: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.choice(np.float32([0.5, 0.25, 1.0, 3.0]), v)      # many exact ties
    s = np.where(rng.random(v) < 0.5, rng.random(v).astype(np.float32), s)
    s[rng.random(v) < 0.1] = -np.inf
    s[rng.random(v) < 0.05] = np.float32(-0.0)
    s[rng.random(v) < 0.02] = np.nan
    return (s.astype(np.float32) + np.float32(0.0)).astype(np.float32)


def plain_top(scores: np.ndarray, k: int) -> np.ndarray:
    _, idx = epilogue.top_k_tiebroken(torch.from_numpy(scores), k)
    return idx.numpy().astype(np.int64)


@pytest.mark.parametrize("v", [40, 300, 3072, 9000, 20_000])
@pytest.mark.parametrize("k", [33, "half", "v"])
def test_sort_and_merge_equals_the_radix_select_and_the_plain_version(v, k):
    k = {"half": max(33, v // 2), "v": v}.get(k, k)
    scores = canonical_scores(v, v + k)
    plan = epilogue.epilogue_plan(v, k, 1, CARD, select="sort")
    assert plan.select == "sort" and plan.form == ("block" if v <= CARD.slice_max else "cluster")
    if v == 20_000:
        assert plan.cluster == 4 and 3 * plan.slice >= v  # the last block holds nothing
    want = plain_top(scores, k)
    assert np.array_equal(sort_select(scores, k, plan), want)
    assert np.array_equal(radix_select(scores, k), want)


@pytest.mark.parametrize("n", [32, 64, 1024, 2048, 4096, 8192])
def test_the_split_network_sorts(n):
    keys = sort_keys(canonical_scores(n, n))[np.random.default_rng(n).permutation(n)]
    assert np.array_equal(sort_list(keys), np.sort(keys))


def test_the_plan_sorts_from_its_share_and_a_measurement_may_choose():
    v = 3072
    at = int(np.ceil(epilogue.SORT_SHARE * v))
    assert epilogue.epilogue_plan(v, at, 1, CARD).select == "sort"
    assert epilogue.epilogue_plan(v, at - 1, 1, CARD).select == ("radix" if at - 1 > 32
                                                                 else "warp")
    assert epilogue.epilogue_plan(v, v, 1, CARD).sort_keys == 4096
    assert epilogue.epilogue_plan(v, v, 1, CARD, select="radix").select == "radix"
    assert epilogue.epilogue_plan(v, 33, 1, CARD, select="sort").select == "sort"
    assert epilogue.epilogue_plan(v, 11, 1, CARD, select="sort").select == "warp"
    assert epilogue.epilogue_plan(40, 40, 1, CARD).sort_keys == 64
    with pytest.raises(ValueError, match="select"):
        epilogue.epilogue_plan(v, v, 1, CARD, select="heap")


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the epilogue is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def card_inputs(v, windows, seed, device):
    """Random partitions and carries with exact ties (tarantula
    saturates at 1.0) on the card."""
    rng = np.random.default_rng(seed)
    lead = () if windows is None else (windows,)

    def part():
        present = rng.random(lead + (v,)) < 0.8
        cov = np.where(present, rng.integers(1, 40, lead + (v,)), 0).astype(np.int32)
        return (torch.from_numpy(present), torch.from_numpy(cov),
                torch.from_numpy(np.full(lead, 50, np.int32)),
                torch.from_numpy(np.asarray(present.sum(-1), dtype=np.int32)))

    from types import SimpleNamespace

    parts = []
    for _ in range(2):
        present, cov, n_traces, n_ops = part()
        parts.append(SimpleNamespace(op_present=present.to(device), cov_unique=cov.to(device),
                                     n_traces=n_traces.to(device), n_ops=n_ops.to(device)))
    svs = [torch.from_numpy(np.where(p.op_present.cpu().numpy(), rng.random(lead + (v,)), 0)
                            .astype(np.float32)).to(device) for p in parts]
    return parts, svs


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("v", [40, 3072, 8192, 9000, 20_000])
@pytest.mark.parametrize("k", [33, "half", "v"])
def test_the_kernels_sort_and_radix_select_are_bitwise_the_plain_version(cuda_device, k, v,
                                                                        windows):
    k = {"half": max(33, v // 2), "v": v}.get(k, k)
    (normal, abnormal), (sv_n, sv_a) = card_inputs(v, windows, v + k, cuda_device)
    cfg = SpectrumConfig(method="tarantula", top_max=k, extra_rows=0)
    want = epilogue.rank_epilogue_plain(normal, abnormal, sv_n, sv_a, cfg)
    for select in ("sort", "radix"):
        got = epilogue.rank_epilogue(normal, abnormal, sv_n, sv_a, cfg, select=select)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            x, y = x.cpu(), y.cpu()
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), select
    every = epilogue.rank_epilogue_all_methods(normal, abnormal, sv_n, sv_a, cfg, select="sort")
    plain = epilogue.rank_epilogue_plain(normal, abnormal, sv_n, sv_a, cfg, all_methods=True)
    torch.cuda.synchronize()
    assert torch.equal(every.top_idx.cpu(), plain.top_idx.cpu())
    assert torch.equal(every.top_scores.cpu().view(torch.int32),
                       plain.top_scores.cpu().view(torch.int32))
