"""The set-up's int8 scales and K19's keyed warm choice (``ops/setup.py``
``rank_setup(..., scale_group=...)``, ``csrc/rank_setup.cu``'s keyed
instances), held to the JAX package on the CPU and the kernel to its
plain version, to ``quantize_amax`` and to K19's flag design on the card.

* on the CPU, bitwise: the plain set-up's scales are
  ``quantize_scales_plain`` of its own start vectors and JAX's
  ``quantize_i8`` scale of each weighted operand (rv0 * w_len, sv0 *
  w_cov, per partition) over JAX's ``_warm_override`` of the same cold
  vectors, for cold, warm and all-miss inits and adversarial values (0,
  NaN, negative, -0.0, subnormal, inf) in live slots and in padding, of
  the init and of the weights, kind-collapsed and not; a stacked group of
  B = 1-6 windows, each row its own window's and JAX's; the kernel's
  order keys (a numpy model of ``order_key``, ``warm_key``,
  ``amax_key``, ``scale_of``) give JAX's choice and scale on the same
  adversarial values; the rank program takes its first scales from the
  set-up (``quantize_scales`` never called), and refused inputs;
* on the card (``cuda`` marker, skipped here): the kernel's scales
  bitwise the plain version's and ``quantize_amax``'s on the kernel's own
  vectors, in every form (a block a row; clusters of 2, 4 and 8; the
  grid with more tiles than a block holds), stacked, warm and cold; the
  keyed warm instance bitwise its plain version and K19's flag design;
  all of it over 50 launches.

JAX is imported inside the CPU tests only, so the card's machine (no
JAX) runs the card tests alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_setup_scales.py
"""

import types

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import PageRankConfig
from microrank_tpu_torch.ops import pattern, setup
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

from test_torch_setup import random_part, three_pad_windows, to_torch

FLT_MIN = np.finfo(np.float32).tiny
V = 300

# Adversarial values written into an init or a weight vector: into its
# live slots (the first `n_live`) or into its padding.
SPECIALS = {
    "zero": 0.0,
    "nan": np.nan,
    "neg_nan": -np.nan,
    "negative": -2.5,
    "neg_zero": -0.0,
    "subnormal": 1e-41,
    "inf": np.inf,
}
INITS = ("cold", "warm", "all_miss", "nan_live", "nan_pad", "negative", "neg_zero_live",
         "subnormal_live", "zero_live_rest_pad")
WEIGHTS = ("random", "nan_pad", "inf_pad", "subnormal", "zero", "negative", "neg_zero")


def bits(t):
    return t.contiguous().view(torch.int32)


def weights(rng, n, n_live, case):
    """A weight vector of n floats, ``n_live`` of them live (float32)."""
    w = rng.uniform(0.01, 2.0, n).astype(np.float32)
    if case == "nan_pad" and n_live < n:
        w[n_live:] = np.nan
    elif case == "inf_pad" and n_live < n:
        w[-1] = np.inf
    elif case == "subnormal":
        w[::3] = 1e-39  # products with the start values are subnormal
    elif case == "zero":
        w[:] = 0.0
    elif case == "negative":
        w[::2] *= -1.0
    elif case == "neg_zero":
        w[1::2] = -0.0
    return w


def init_vectors(rng, part_n, part_a, case):
    """(sv_n, rv_n, sv_a, rv_a) float32 of an init ``case``, or None
    (cold), on the partitions' axes."""
    if case == "cold":
        return None
    v = part_n.op_present.shape[-1]
    out = [rng.uniform(0.0, 1.0, n).astype(np.float32)
           for n in (v, part_n.kind.shape[-1], v, part_a.kind.shape[-1])]
    live = [int(p.n_cols) if int(p.n_cols) >= 0 else int(p.n_traces) for p in (part_n, part_a)]
    present = [np.flatnonzero(p.op_present) for p in (part_n, part_a)]
    absent = [np.flatnonzero(~p.op_present) for p in (part_n, part_a)]
    if case == "all_miss":
        out = [np.zeros_like(x) for x in out]
    elif case == "nan_live":  # the normal rv side and the abnormal sv side start cold
        out[1][min(live[0], len(out[1])) // 2] = np.nan
        out[2][present[1][:1]] = -np.nan
    elif case == "nan_pad":  # masked off: both sides stay warm
        out[1][live[0]:] = np.nan
        out[0][absent[0]] = np.nan
        out[3][live[1]:] = np.inf
    elif case == "negative":  # every live value <= 0 on the rv sides: cold there
        out[1][:] = -out[1]
        out[3][:] = -out[3]
        out[1][live[0]:] = 5.0  # padding, masked off
    elif case == "neg_zero_live":
        out[1][:] = -0.0
        out[1][: max(live[0] // 2, 0)] = 0.25
        out[0][present[0]] = -0.0
    elif case == "subnormal_live":
        out[1][: live[0]] = 1e-41
        out[2][present[1]] = 1e-41
    elif case == "zero_live_rest_pad":  # mass only where masked off: cold
        out[1][: live[0]] = 0.0
        out[1][live[0]:] = 1.0
        out[2][:] = 0.0
        out[2][absent[1]] = 1.0
    return [torch.from_numpy(x) for x in out]


def scale_group(w_lens, w_covs, device="cpu"):
    """A pattern group that carries only the weights the scales read
    (zero bitmaps of one row chunk: neither the set-up nor
    ``quantize_amax`` reads a pattern)."""
    windows = w_lens[0].shape[0] if w_lens[0].dim() == 2 else None
    lead = () if windows is None else (windows,)
    parts = tuple(
        pattern.PatternPart(
            pattern=torch.zeros(lead + (w_cov.shape[-1], pattern.ROW_ALIGN), dtype=torch.uint8,
                                device=device),
            w_len=w_len.to(device).contiguous(), w_cov=w_cov.to(device).contiguous(), w_out=None,
            part=torch.zeros(1, device=device),
            counters=torch.zeros(0, dtype=torch.int32, device=device),
            dense=None, n_cols=int(w_len.shape[-1]))
        for w_len, w_cov in zip(w_lens, w_covs))
    return pattern.PatternGroup(
        parts=parts,
        amax_scratch=torch.zeros(pattern.MAX_VECS * (windows or 1) + 1, dtype=torch.int32,
                                 device=device),
        windows=windows)


def case_inputs(t_n, t_a, collapsed, init_case, weight_case, seed, lead=(), v=V):
    rng = np.random.default_rng(seed)
    live_n = np.int32(t_n * 2 // 3 + 1)
    live_a = np.int32(max(t_a // 2, 1))
    if lead:
        live_n = np.array([t_n, 0] + [t_n * 2 // 3 + 1] * (lead[0] - 2), np.int32)[: lead[0]]
        live_a = np.minimum(live_n, t_a)
    normal = random_part(rng, t_n, v, live_n, collapsed, lead)
    abnormal = random_part(rng, t_a, v, live_a, collapsed, lead)
    init = None if lead else init_vectors(rng, normal, abnormal, init_case)
    w_lens = [torch.from_numpy(weights(rng, int(np.prod(lead + (t,))), int(t * 2 // 3 + 1),
                                       weight_case).reshape(lead + (t,)))
              for t in (t_n, t_a)]
    w_covs = [torch.from_numpy(weights(rng, int(np.prod(lead + (v,))), v, weight_case)
                               .reshape(lead + (v,)))
              for _ in range(2)]
    return normal, abnormal, init, w_lens, w_covs


# ------------------------------------------------------------------ CPU


def jax_start_and_scales(normal, abnormal, cold, init, w_lens, w_covs):
    """JAX's start vectors (``_warm_override`` of the port's cold ones
    with ``init``) and the first step's four scales (``quantize_i8`` of
    rv * w_len, then sv * w_cov, per partition, op by op: under ``jit``
    XLA turns amax / 127 into amax * (1 / 127), which can move the last
    bit; the port divides, as ``quantize_i8`` is written and as
    ``tests/test_torch_int8.py`` holds it)."""
    import jax.numpy as jnp
    from microrank_tpu.rank_backends.jax_tpu import _warm_override, quantize_i8

    vec = [(jnp.asarray(sv.numpy()), jnp.asarray(rv.numpy())) for _, sv, rv in cold]
    graph = types.SimpleNamespace(normal=normal, abnormal=abnormal)
    start = _warm_override(graph, tuple(vec), None if init is None else
                           tuple(x.numpy() for x in init), None)
    def scale(x, w):
        return quantize_i8(x * w)[1]

    scales = []
    for (sv, rv), w_len, w_cov in zip(start, w_lens, w_covs):
        scales += [scale(rv, jnp.asarray(w_len.numpy())), scale(sv, jnp.asarray(w_cov.numpy()))]
    return start, np.asarray(jnp.stack(scales))


@pytest.mark.parametrize("weight_case", WEIGHTS)
@pytest.mark.parametrize("init_case", INITS)
@pytest.mark.parametrize("collapsed", [False, True])
def test_plain_scales_are_quantize_scales_plain_and_jax(collapsed, init_case, weight_case):
    normal, abnormal, init, w_lens, w_covs = case_inputs(
        96, 40, collapsed, init_case, weight_case, seed=len(init_case) * 31 + len(weight_case))
    cfg = PageRankConfig(kind_precision="int8")
    tn, ta = to_torch(normal), to_torch(abnormal)
    group = scale_group(w_lens, w_covs)
    (pn, svn, rvn), (pa, sva, rva), scales = setup.rank_setup(tn, ta, cfg, init=init,
                                                              scale_group=group)
    assert scales.shape == (4,) and scales.dtype == torch.float32
    own = pattern.quantize_scales_plain(group, (rvn, rva), (svn, sva))
    assert torch.equal(bits(scales), bits(own))
    # The start vectors are the set-up's without scales.
    plain = setup.rank_setup(tn, ta, cfg, init=init)
    for got, want in zip(((pn, svn, rvn), (pa, sva, rva)), plain):
        for x, y in zip(got, want):
            assert torch.equal(bits(x), bits(y))
    cold = setup.rank_setup(tn, ta, cfg)
    start, jax_scales = jax_start_and_scales(normal, abnormal, cold, init, w_lens, w_covs)
    for (sv_j, rv_j), sv, rv in zip(start, (svn, sva), (rvn, rva)):
        assert np.asarray(sv_j).tobytes() == sv.numpy().tobytes()
        assert np.asarray(rv_j).tobytes() == rv.numpy().tobytes()
    assert jax_scales.tobytes() == scales.numpy().tobytes()


@pytest.mark.parametrize("windows", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("collapsed", [False, True])
def test_stacked_scales_are_each_windows_own_and_jax(windows, collapsed):
    lead = (windows,)
    normal, abnormal, _, w_lens, w_covs = case_inputs(
        70, 24, collapsed, "cold", "nan_pad" if windows % 2 else "subnormal", seed=windows,
        lead=lead)
    cfg = PageRankConfig(kind_precision="int8")
    tn, ta = to_torch(normal), to_torch(abnormal)
    got = setup.rank_setup(tn, ta, cfg, scale_group=scale_group(w_lens, w_covs))
    assert got[2].shape == (windows, 4)
    for b in range(windows):
        one = [to_torch(type(p)(*(x[b] for x in p))) for p in (normal, abnormal)]
        w_l, w_c = [w[b] for w in w_lens], [w[b] for w in w_covs]
        own = setup.rank_setup(*one, cfg, scale_group=scale_group(w_l, w_c))
        assert torch.equal(bits(got[2][b]), bits(own[2]))
        cold = setup.rank_setup(*one, cfg)
        bare = [type(p)(*(x[b] for x in p)) for p in (normal, abnormal)]
        _, jax_scales = jax_start_and_scales(*bare, cold, None, w_l, w_c)
        assert jax_scales.tobytes() == own[2].numpy().tobytes()


# The kernel's order keys, in numpy (csrc/rank_setup.cu Key).
def order_key(x):
    u = x.view(np.uint32)
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), k).astype(np.uint32)


def warm_key(key):
    return bool(key >= 0x80800000 and key != 0xFFFFFFFF)


def amax_key(x, w):
    p = np.abs((x * w).astype(np.float32))
    return np.where(p < FLT_MIN, np.float32(0.0), p).astype(np.float32).view(np.uint32)


def scale_of(key):
    amax = np.array([key], np.uint32).view(np.float32)[0]
    if not amax > 0:
        return np.float32(1.0)
    s = np.float32(amax / np.float32(127.0))
    return np.float32(0.0) if abs(s) < FLT_MIN else s


@pytest.mark.parametrize("special", list(SPECIALS))
@pytest.mark.parametrize("where", ["live", "pad", "everywhere"])
def test_the_kernels_keys_give_jaxs_choice_and_scale(special, where):
    import jax.numpy as jnp
    from microrank_tpu.rank_backends.jax_tpu import quantize_i8

    rng = np.random.default_rng(len(special) + 7 * len(where))
    n, n_live = 64, 40
    for base in ("positive", "mixed", "zero"):
        x = {"positive": rng.uniform(0.0, 1.0, n), "mixed": rng.uniform(-1.0, 1.0, n),
             "zero": np.zeros(n)}[base].astype(np.float32)
        sel = {"live": slice(3, 9), "pad": slice(n_live, n), "everywhere": slice(0, n)}[where]
        x[sel] = SPECIALS[special]
        w = rng.uniform(0.01, 2.0, n).astype(np.float32)
        live = np.arange(n) < n_live
        masked = np.where(live, x, np.float32(0.0)).astype(np.float32)
        # JAX's choice: the masked init's max > 0.
        want = bool(jnp.max(jnp.asarray(masked)) > 0)
        key = order_key(x[live]).max(initial=np.uint32(0))
        assert warm_key(key) == want
        # quantize_i8's scale of the weighted operand, op by op.
        scale = np.asarray(quantize_i8(jnp.asarray(masked) * jnp.asarray(w))[1])
        got = scale_of(amax_key(masked, w).max(initial=np.uint32(0)))
        assert np.float32(got).tobytes() == scale.tobytes()
        # And the port's plain version.
        assert np.float32(got).tobytes() == pattern.quantize_scale(
            torch.from_numpy(masked) * torch.from_numpy(w)).numpy().tobytes()


def kind_window():
    graph = host_subset(three_pad_windows()[1], "kind")
    return device_subset(graph_from_numpy(graph, "cpu"), "kind")


def test_the_int8_program_takes_its_first_scales_from_the_setup(monkeypatch):
    dg = kind_window()
    cfg = PageRankConfig(kind_precision="int8")
    want = torch_cuda.window_weights_full(dg, cfg, "kind")
    seen, first = [], []

    def spy_setup(*args, **kw):
        out = setup.rank_setup(*args, **kw)
        seen.append(kw.get("scale_group"))
        if kw.get("scale_group") is not None:
            (_, sv_n, rv_n), (_, sv_a, rv_a), scales = out
            own = pattern.quantize_scales_plain(kw["scale_group"], (rv_n, rv_a), (sv_n, sv_a))
            assert torch.equal(bits(scales), bits(own))
        return out

    def spy_pair(group, rvs, svs, precision="f32", scales=None):
        if not first:
            first.append(scales)
        return pattern.pattern_pair_group(group, rvs, svs, precision, scales)

    def refuse(*args, **kw):
        raise AssertionError("the program launched the scale kernel")

    monkeypatch.setattr(torch_cuda, "rank_setup", spy_setup)
    monkeypatch.setattr(torch_cuda, "pattern_pair_group", spy_pair)
    monkeypatch.setattr(pattern, "quantize_scales", refuse)
    got = torch_cuda.window_weights_full(dg, cfg, "kind")
    assert len(seen) == 1 and seen[0] is dg.pattern_group
    (_, sv_n, rv_n), (_, sv_a, rv_a), scales = setup.rank_setup(
        dg.normal, dg.abnormal, cfg, scale_group=dg.pattern_group)
    assert torch.equal(bits(first[0]), bits(scales))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_an_f32_program_asks_for_no_scales(monkeypatch):
    dg = kind_window()
    calls = []

    def spy(normal, abnormal, cfg):  # the cold call takes no keywords
        calls.append(cfg)
        return setup.rank_setup(normal, abnormal, cfg)

    monkeypatch.setattr(torch_cuda, "rank_setup", spy)
    torch_cuda.window_weights_full(dg, PageRankConfig(), "kind")
    assert len(calls) == 1


def test_the_scales_refuse_what_the_kernel_does_not_take():
    normal, abnormal, init, w_lens, w_covs = case_inputs(16, 8, True, "warm", "random", seed=3)
    tn, ta = to_torch(normal), to_torch(abnormal)
    cfg = PageRankConfig(kind_precision="int8")
    group = scale_group(w_lens, w_covs)
    with pytest.raises(ValueError, match="first designs"):
        setup.rank_setup(tn, ta, cfg, first_design=True, scale_group=group)
    with pytest.raises(ValueError, match="first designs"):
        setup.rank_setup(tn, ta, cfg, init=init, warm_flags=True, scale_group=group)
    with pytest.raises(ValueError, match="takes a warm init"):
        setup.rank_setup(tn, ta, cfg, warm_flags=True)
    with pytest.raises(ValueError, match="weights"):
        setup.rank_setup(tn, ta, cfg, scale_group=scale_group([w_lens[1], w_lens[0]], w_covs))
    with pytest.raises(ValueError, match="both partitions"):
        setup.rank_setup(tn, ta, cfg, scale_group=group._replace(parts=group.parts[:1]))
    stacked = scale_group([w[None] for w in w_lens], [w[None] for w in w_covs])
    with pytest.raises(ValueError, match="windows"):
        setup.rank_setup(tn, ta, cfg, scale_group=stacked)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the set-up's scales and K19's keyed instances are "
                    "CUDA kernels with no CPU mode")
    return torch.device("cuda")


def on(xs, dev):
    return None if xs is None else [x.to(dev) for x in xs]


def assert_setup_bitwise(got, want):
    for p in range(2):
        for x, y in zip(got[p], want[p]):
            assert x.shape == y.shape
            assert torch.equal(bits(x).cpu(), bits(y).cpu())


# Trace pads: a block a row (8, 4096), clusters of 2, 4 and 8 (4097,
# 3 * 4096 + 1, 20,000), the grid (70,000: 18 tiles a row; 2^21: 512, more
# tiles than a block holds across the barrier).
CARD_PADS = [8, 4096, 4097, 3 * 4096 + 1, 20_000, 70_000, 1 << 21]


@pytest.mark.cuda
@pytest.mark.parametrize("init_case", ["cold", "warm", "all_miss", "nan_live", "nan_pad",
                                       "negative", "zero_live_rest_pad"])
@pytest.mark.parametrize("weight_case", ["random", "nan_pad", "subnormal"])
@pytest.mark.parametrize("t_pad", CARD_PADS)
def test_setup_scales_kernel_is_bitwise_plain_and_quantize_amax(cuda_device, t_pad, weight_case,
                                                                init_case):
    v = 2048 if t_pad < (1 << 21) else 512
    normal, abnormal, init, w_lens, w_covs = case_inputs(
        t_pad, t_pad // 2 + 1, t_pad % 2 == 0, init_case, weight_case, seed=t_pad, v=v)
    cfg = PageRankConfig(kind_precision="int8")
    want = setup.rank_setup(to_torch(normal), to_torch(abnormal), cfg, init=init,
                            scale_group=scale_group(w_lens, w_covs))
    dn, da = to_torch(normal, cuda_device), to_torch(abnormal, cuda_device)
    group = scale_group(w_lens, w_covs, cuda_device)
    before = (setup.rank_setup.launches, setup.rank_setup.scale_launches,
              pattern.quantize_scales.launches)
    got = setup.rank_setup(dn, da, cfg, init=on(init, cuda_device), scale_group=group)
    torch.cuda.synchronize()
    assert (setup.rank_setup.launches, setup.rank_setup.scale_launches,
            pattern.quantize_scales.launches) == (before[0] + 1, before[1] + 1, before[2])
    assert_setup_bitwise(got, want)
    assert torch.equal(bits(got[2]).cpu(), bits(want[2]))
    (_, sv_n, rv_n), (_, sv_a, rv_a) = got[:2]
    amax = pattern.quantize_scales(group, (rv_n, rv_a), (sv_n, sv_a))
    assert torch.equal(bits(amax), bits(got[2]))
    # Without scales: the same vectors.
    assert_setup_bitwise(setup.rank_setup(dn, da, cfg, init=on(init, cuda_device)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 3, 6])
@pytest.mark.parametrize("t_pad", [96, 4097, 20_000, 70_000])
def test_stacked_setup_scales_kernel_is_bitwise_plain_and_quantize_amax(cuda_device, t_pad,
                                                                        windows):
    normal, abnormal, _, w_lens, w_covs = case_inputs(
        t_pad, t_pad // 3 + 1, t_pad % 2 == 1, "cold", "nan_pad", seed=windows + t_pad,
        lead=(windows,), v=1024)
    cfg = PageRankConfig(kind_precision="int8")
    want = setup.rank_setup(to_torch(normal), to_torch(abnormal), cfg,
                            scale_group=scale_group(w_lens, w_covs))
    group = scale_group(w_lens, w_covs, cuda_device)
    got = setup.rank_setup(to_torch(normal, cuda_device), to_torch(abnormal, cuda_device), cfg,
                           scale_group=group)
    torch.cuda.synchronize()
    assert_setup_bitwise(got, want)
    assert got[2].shape == (windows, 4)
    assert torch.equal(bits(got[2]).cpu(), bits(want[2]))
    (_, sv_n, rv_n), (_, sv_a, rv_a) = got[:2]
    assert torch.equal(bits(pattern.quantize_scales(group, (rv_n, rv_a), (sv_n, sv_a))),
                       bits(got[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("init_case", ["warm", "all_miss", "nan_live", "nan_pad", "negative",
                                       "neg_zero_live", "subnormal_live", "zero_live_rest_pad"])
@pytest.mark.parametrize("t_pad", CARD_PADS)
def test_keyed_warm_instance_is_bitwise_plain_and_the_flag_design(cuda_device, t_pad, init_case):
    normal, abnormal, init, _, _ = case_inputs(t_pad, t_pad // 2 + 1, t_pad % 2 == 1, init_case,
                                               "random", seed=t_pad + 1)
    cfg = PageRankConfig()
    want = setup.rank_setup(to_torch(normal), to_torch(abnormal), cfg, init=init)
    dn, da = to_torch(normal, cuda_device), to_torch(abnormal, cuda_device)
    d_init = on(init, cuda_device)
    got = setup.rank_setup(dn, da, cfg, init=d_init)
    flags = setup.rank_setup(dn, da, cfg, init=d_init, warm_flags=True)
    torch.cuda.synchronize()
    assert_setup_bitwise(got, want)
    assert_setup_bitwise(flags, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t_pad", [96, 20_000, 1 << 21])
def test_keyed_instances_over_50_launches(cuda_device, t_pad):
    normal, abnormal, init, w_lens, w_covs = case_inputs(t_pad, t_pad // 2 + 1, True, "warm",
                                                         "nan_pad", seed=50, v=512)
    cfg = PageRankConfig(kind_precision="int8")
    dn, da = to_torch(normal, cuda_device), to_torch(abnormal, cuda_device)
    group = scale_group(w_lens, w_covs, cuda_device)
    d_init = on(init, cuda_device)
    calls = {
        "warm_scales": lambda: setup.rank_setup(dn, da, cfg, init=d_init, scale_group=group),
        "cold_scales": lambda: setup.rank_setup(dn, da, cfg, scale_group=group),
        "warm": lambda: setup.rank_setup(dn, da, cfg, init=d_init),
    }
    for name, call in calls.items():
        first = call()
        flat = [bits(x).clone() for part in first[:2] for x in part]
        if len(first) > 2:
            flat.append(bits(first[2]).clone())
        for _ in range(50):
            again = call()
            now = [bits(x) for part in again[:2] for x in part]
            if len(again) > 2:
                now.append(bits(again[2]))
            assert all(torch.equal(x, y) for x, y in zip(now, flat)), name
    torch.cuda.synchronize()
