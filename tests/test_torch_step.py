"""K5, the power-iteration step (``ops.step``), held to the JAX package
on the CPU and its kernel to its plain version on the card.

* the step: ``power_step_plain`` against JAX's ``_partition_step`` and
  ``window_weights_full``'s ``part_delta`` on seeded numpy inputs, both
  partitions, normalization on and off, ``tol`` None and set (a running
  step and a frozen one), and an empty partition (NaN where JAX gives
  NaN). JAX's step run op by op on the CPU rounds each op on its own, as
  the plain step does: bitwise. Jitted, XLA's CPU fuses the damped
  combination into FMAs: rtol 1e-6 (one rounding of each product saved).
* the slice: ``window_weights_full`` on every route against JAX's
  ``window_weights_full`` on the same graph, at the rank tests'
  tolerances: rtol 1e-5 (float32 sums in another order over 25 steps),
  5e-3 with bf16 or int8 operands, 1e-4 for packed_blocked (JAX's own
  blocked-vs-packed gate); residuals rtol 1e-4 / atol 1e-6 (int8: 5e-3);
  n_iters equal; with ``tol`` too.
* the per-window state (``step_window``) on the CPU: its chain of
  steps gives the carries, residuals, n_iters and scales of a chain of
  ``power_step_plain`` calls (default, ``tol``, an empty partition,
  int8); its two carry buffers alternate and a step never writes the
  carry it reads; a window's last carry is never written again; a
  mismatched window is refused at set-up, and the checks run once.
* on the card (``cuda`` marker, skipped here): the fused kernel (one
  cooperative launch a step) bitwise ``power_step_plain`` run on the
  card, over whole windows of every route
  (25 launches each), with ``tol`` and with an empty partition; at
  sizes below, at and past the register slots, with ``tol``, an empty
  partition, no normalization and int8 scales; over chains of 50 steps
  (one launch a normalized step); the int8 scales it gives bitwise
  ``quantize_scales_plain`` of the vectors it carries, at every step; a
  grid the card cannot hold resident is refused and raises.

JAX is imported inside the CPU tests only, so the card's machine (no
JAX) runs the card tests alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step.py
"""

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import PageRankConfig
from microrank_tpu_torch.ops import pattern, step
from microrank_tpu_torch.rank_backends import torch_cuda
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    host_subset,
    window_weights_full,
)

# (kernel, kind_precision, build aux, collapse)
ROUTES = [
    ("pallas", "f32", "auto", "off"),
    ("pcsr", "f32", "pcsr", "off"),
    ("kind", "f32", "kind", "on"),
    ("kind", "bf16", "kind", "on"),
    ("kind", "int8", "kind", "on"),
    ("packed", "f32", "packed", "off"),
    ("packed_bf16", "f32", "packed", "off"),
    ("packed_blocked", "f32", "packed", "off"),
]
ROUTE_IDS = [f"{k}-{p}" for k, p, _, _ in ROUTES]


def step_inputs(rng, sizes, empty=()):
    """Per partition (y_sr, y_ss, y_rs, pref, sv, rv) as float32 numpy,
    of (V, T) = sizes[p]; partition p in ``empty`` is all zeros (an
    empty partition at its pad)."""
    out = []
    for p, (v, t) in enumerate(sizes):
        scale = 10.0 ** rng.integers(-3, 2)
        vecs = [(rng.uniform(0.0, 1.0, n) * scale).astype(np.float32) for n in (v, v, t, t, v, t)]
        out.append([np.zeros_like(x) for x in vecs] if p in empty else vecs)
    return out


def torch_step_args(inputs, device="cpu"):
    def t(x):
        return torch.from_numpy(x).to(device)

    products = tuple((t(y_sr), t(y_ss), t(y_rs)) for y_sr, y_ss, y_rs, *_ in inputs)
    carry = tuple((t(sv), t(rv)) for *_, sv, rv in inputs)
    prefs = [t(p[3]) for p in inputs]
    return products, carry, prefs


def jax_step(inputs, normalize, jit):
    """JAX's ``_partition_step`` of each partition, and
    ``window_weights_full``'s ``part_delta``, on the same inputs."""
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.rank_backends import jax_tpu

    cfg = JaxPageRank(max_normalize_each_iter=normalize)

    def one(y_sr, y_ss, y_rs, pref, sv, rv):
        def matvecs(sv_, rv_):
            # The products with the call-graph term, as every JAX route's
            # matvecs return them.
            return y_sr + jnp.float32(cfg.call_weight) * y_ss, y_rs

        new = jax_tpu._partition_step(matvecs, pref, sv, rv, cfg)
        delta = jnp.maximum(
            jnp.max(jnp.abs(new[0] - sv)), jnp.max(jnp.abs(new[1] - rv))
        )
        return new, delta

    fn = jax.jit(one) if jit else one
    outs = [fn(*(jnp.asarray(x) for x in p)) for p in inputs]
    return [(np.asarray(s), np.asarray(r)) for (s, r), _ in outs], np.array(
        [np.asarray(d) for _, d in outs]
    )


def assert_same(got, want, bitwise, rtol=0.0):
    """Equal NaN positions; bitwise (or within rtol) elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if bitwise:
        assert got[ok].tobytes() == want[ok].tobytes()
    else:
        np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("empty", [(), (0,)], ids=["full", "empty-normal"])
def test_plain_step_matches_jax_partition_step(jit, normalize, empty):
    rng = np.random.default_rng(3 + normalize + 2 * len(empty))
    inputs = step_inputs(rng, [(37, 53), (40, 106)], empty)
    products, carry, prefs = torch_step_args(inputs)
    cfg = PageRankConfig(max_normalize_each_iter=normalize)
    plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, None, normalize,
                          step.step_scratch("cpu"))
    residuals = torch.zeros((2, 4), dtype=torch.float32)
    new, scales = step.power_step(plan, products, carry, residuals, 2)
    assert scales is None
    want, deltas = jax_step(inputs, normalize, jit)
    for (sv, rv), (j_sv, j_rv) in zip(new, want):
        assert_same(sv, j_sv, not jit, 1e-6)
        assert_same(rv, j_rv, not jit, 1e-6)
    assert_same(residuals[:, 2], deltas, not jit, 1e-6)
    assert not residuals[:, [0, 1, 3]].any()
    if empty and normalize:  # 0 / 0
        assert torch.isnan(residuals[0, 2]) and torch.isnan(new[0][0]).all()


def test_plain_step_with_tol_freezes_like_jax_while_loop():
    # JAX's while_loop stops when max(deltas) <= tol; the port runs every
    # step and freezes: the carry stays, the residual is 0, n_iters stops.
    rng = np.random.default_rng(8)
    inputs = step_inputs(rng, [(37, 53), (40, 106)])
    products, carry, prefs = torch_step_args(inputs)
    want, deltas = jax_step(inputs, True, jit=False)
    cfg = PageRankConfig()
    for tol, keeps_running in ((float(deltas.max()) / 2, True), (float(deltas.max()), False)):
        plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, tol, True,
                              step.step_scratch("cpu"))
        residuals = torch.zeros((2, 3), dtype=torch.float32)
        n_iters = torch.zeros((), dtype=torch.int32)
        running = torch.ones((), dtype=torch.bool)
        new, _ = step.power_step(plan, products, carry, residuals, 0, n_iters, running)
        for (sv, rv), (j_sv, j_rv) in zip(new, want):
            assert_same(sv, j_sv, True)
            assert_same(rv, j_rv, True)
        assert_same(residuals[:, 0], deltas, True)
        assert int(n_iters) == 1 and bool(running) == keeps_running
        # A stopped loop: the carry comes back unchanged, residual 0.
        running.fill_(False)
        again, _ = step.power_step(plan, products, new, residuals, 1, n_iters, running)
        for (sv, rv), (o_sv, o_rv) in zip(again, new):
            assert torch.equal(sv, o_sv) and torch.equal(rv, o_rv)
        assert not residuals[:, 1].any() and int(n_iters) == 1 and not bool(running)


def test_plain_step_int8_scales_are_the_next_steps_quantize_scales():
    rng = np.random.default_rng(2)
    sizes = [(37, 53), (37, 106)]
    inputs = step_inputs(rng, sizes)
    products, carry, prefs = torch_step_args(inputs)
    m = [(rng.random((v, t)) < 0.3).astype(np.uint8) for v, t in sizes]
    group = pattern.pattern_group(
        [torch.from_numpy(np.packbits(x, axis=1)) for x in m],
        [torch.from_numpy(rng.uniform(0, 1, t).astype(np.float32)) for _, t in sizes],
        [torch.from_numpy(rng.uniform(0, 1, v).astype(np.float32)) for v, _ in sizes],
        [None, None], [t for _, t in sizes],
    )
    cfg = PageRankConfig()
    plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, None, True,
                          step.step_scratch("cpu"), group)
    residuals = torch.zeros((2, 2), dtype=torch.float32)
    new, scales = step.power_step(plan, products, carry, residuals, 0, want_scales=True)
    want = pattern.quantize_scales(group, [p[1] for p in new], [p[0] for p in new])
    assert scales.numpy().tobytes() == want.numpy().tobytes()


def test_step_plan_and_kernel_checks_reject_bad_input():
    # A plan needs both partitions' preference vectors; the window's
    # set-up refuses a residual trace that is not [2, n_steps] float32,
    # and its first step products of the wrong length.
    rng = np.random.default_rng(1)
    products, carry, prefs = torch_step_args(step_inputs(rng, [(5, 7), (5, 9)]))
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch("cpu"))
    with pytest.raises(ValueError):
        step.step_plan(prefs[:1], 0.01, 0.85, None, True, step.step_scratch("cpu"))
    with pytest.raises(ValueError):
        step.StepWindow(plan, carry, torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        step.StepWindow(plan, carry, torch.zeros((2, 3), dtype=torch.float64))
    bad = (products[0], (products[1][0][:3],) + products[1][1:])
    with pytest.raises(ValueError):
        step.StepWindow(plan, carry, torch.zeros((2, 3))).step(bad, 0)


# ------------------------------------------------ the per-window state


def int8_group(rng, sizes):
    """A tiny pattern group of seeded bitmaps and weights: the int8
    scales' weights (w_len for rv, w_cov for sv)."""
    bitmaps = []
    for v, t in sizes:
        b = rng.integers(0, 256, (v, -(-t // 8)), dtype=np.uint8)
        b[:, -1] &= np.uint8((0xFF00 >> (t - 8 * (b.shape[1] - 1))) & 0xFF)  # no bit past t
        bitmaps.append(torch.from_numpy(b))
    return pattern.pattern_group(
        bitmaps,
        [torch.from_numpy(rng.uniform(0, 1, t).astype(np.float32)) for _, t in sizes],
        [torch.from_numpy(rng.uniform(0, 1, v).astype(np.float32)) for v, _ in sizes],
        [None, None], [t for _, t in sizes],
    )


def window_chain(fn, plan, products, carry, n_steps, want_scales=False, max_blocks=None):
    """``n_steps`` steps on fixed products: through one ``step_window``
    (``fn`` None; its grid capped at ``max_blocks``) or a chain of ``fn``
    calls (power_step_plain ...).
    Returns every step's carry and scales, the residual trace, n_iters
    and running, as one tensor of int32 bits."""
    dev = carry[0][0].device
    residuals = torch.zeros((2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if plan.tol is not None:
        n_iters = torch.zeros((), dtype=torch.int32, device=dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
    win = None
    if fn is None:
        win = step.StepWindow(plan, carry, residuals, n_iters, running, max_blocks=max_blocks)
    out = []
    for i in range(n_steps):
        scales_i = want_scales and i + 1 < n_steps
        if win is None:
            carry, scales = fn(plan, products, carry, residuals, i, n_iters, running, scales_i)
        else:
            carry, scales = win.step(products, i, scales_i)
        out += [t.clone() for part in carry for t in part]
        out += [] if scales is None else [scales.clone()]
    out = [torch.cat(out + [residuals.reshape(-1)]).view(torch.int32)]
    if n_iters is not None:
        out += [n_iters.reshape(1), running.to(torch.int32).reshape(1)]
    return torch.cat(out)


@pytest.mark.parametrize("variant", ["default", "tol", "empty", "int8"])
def test_step_window_chain_matches_plain_chain(variant):
    rng = np.random.default_rng(11)
    sizes = [(37, 53), (37, 106)]
    inputs = step_inputs(rng, sizes, empty=(0,) if variant == "empty" else ())
    products, carry, prefs = torch_step_args(inputs)
    cfg = PageRankConfig()
    tol = None
    if variant in ("tol", "empty"):
        # Half the first step's residual: the second step freezes (every
        # later step on fixed products repeats the first one's vectors).
        probe = step.step_plan(prefs, cfg.call_weight, cfg.damping, None, True,
                               step.step_scratch("cpu"))
        res = torch.zeros((2, 1), dtype=torch.float32)
        step.power_step_plain(probe, products, carry, res, 0)
        tol = 1e-4 if variant == "empty" else float(res.max()) / 2
    group = int8_group(rng, sizes) if variant == "int8" else None
    plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, tol, True,
                          step.step_scratch("cpu"), group)
    got = window_chain(None, plan, products, carry, 6, variant == "int8")
    want = window_chain(step.power_step_plain, plan, products, carry, 6, variant == "int8")
    assert torch.equal(got, want)


def test_step_window_buffers_alternate_and_never_alias_the_input():
    rng = np.random.default_rng(12)
    products, carry, prefs = torch_step_args(step_inputs(rng, [(37, 53), (40, 106)]))
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch("cpu"))

    def ptrs(c):
        return {t.data_ptr() for part in c for t in part}

    wins = [step.StepWindow(plan, carry, torch.zeros((2, 5), dtype=torch.float32))
            for _ in range(2)]
    slots, seen = [], []
    for i in range(5):
        for k, win in enumerate(wins):
            before = win.carry
            new, _ = win.step(products, i)
            assert not ptrs(before) & ptrs(new)  # never writes what it reads
            assert new is win.carry
            if k == 0:
                slots.append(win.slot)
                seen.append(ptrs(new))
    assert slots == [1, 2, 1, 2, 1]
    assert seen[0] == seen[2] == seen[4] and seen[1] == seen[3] and not seen[0] & seen[1]
    # The first carry is the caller's and is never written.
    assert ptrs(wins[0].carries[0]) == ptrs(carry)
    # Each window has buffers of its own: one's last carry is not the
    # other's.
    assert not ptrs(wins[0].carry) & ptrs(wins[1].carry)
    final = [t.clone() for part in wins[0].carry for t in part]
    wins[1].step(products, 4)
    assert all(torch.equal(a, b) for a, b in zip(final, (t for part in wins[0].carry
                                                          for t in part)))


def test_step_window_rejects_a_mismatched_window_once_at_set_up(monkeypatch):
    rng = np.random.default_rng(13)
    sizes = [(37, 53), (40, 106)]
    products, carry, prefs = torch_step_args(step_inputs(rng, sizes))
    cfg = PageRankConfig()

    def plan_of(prefs_, tol=None, group=None, scratch=None):
        return step.step_plan(prefs_, cfg.call_weight, cfg.damping, tol, True,
                              step.step_scratch("cpu") if scratch is None else scratch, group)

    res = torch.zeros((2, 4), dtype=torch.float32)
    short_pref = [prefs[0], prefs[1][:-1]]
    bad = [
        (plan_of(short_pref), carry, res, None, None),                      # pref vs rv
        (plan_of(prefs), carry, res[:, :0], None, None),                    # no steps
        (plan_of(prefs), carry, res, torch.zeros((), dtype=torch.int32),
         torch.ones((), dtype=torch.bool)),                                  # n_iters, no tol
        (plan_of(prefs, 1e-4), carry, res, None, None),                     # tol, no n_iters
        (plan_of(prefs, scratch=torch.zeros(3, dtype=torch.int32)), carry, res, None, None),
        (plan_of(prefs, group=int8_group(rng, [(37, 53), (37, 106)])), carry, res, None, None),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            step.StepWindow(*args)
    with pytest.raises(ValueError):
        step.StepWindow(plan_of(prefs), carry, res, mode="fast")
    # A good window: checked at set-up, its products at the first step
    # only.
    calls = {"window": 0, "products": 0}
    for name, key in (("_check_window", "window"), ("_check_products", "products")):
        real = getattr(step, name)

        def counted(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(step, name, counted)
    win = step.StepWindow(plan_of(prefs), carry, res)
    for i in range(4):
        win.step(products, i)
    assert calls == {"window": 1, "products": 1}
    with pytest.raises(ValueError):  # past the trace
        win.step(products, 4)
    with pytest.raises(ValueError):  # scales without a scale group
        win.step(products, 0, want_scales=True)


# ------------------------------------------------------------- the slice


def jax_graph(case, aux, collapse):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph

    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse)
    return graph


def blocked_bytes(graph):
    """A packed_blocked band of a quarter of the trace axis, so that the
    plain version works in bands (tests/test_torch_blocked_pcsr.py)."""
    t_pad = graph.abnormal.kind.shape[0]
    v_pad = graph.abnormal.cov_unique.shape[0]
    return v_pad * (t_pad // 4) * 4


def weights_both(graph, kernel, pr):
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.rank_backends import jax_tpu

    dg = jax.tree.map(jnp.asarray, graph)
    j = jax.jit(
        lambda g: jax_tpu.window_weights_full(g, JaxPageRank(**pr), None, kernel)
    )(dg)
    j = [np.asarray(a) for a in j]
    tg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel,
                       pr.get("packed_block_bytes", PageRankConfig.packed_block_bytes))
    t = window_weights_full(tg, PageRankConfig(**pr), kernel)
    return j, [x.numpy() for x in t]


def assert_weights_close(j, t, rtol, residual_rtol=1e-4):
    names = ("n_weight", "a_weight", "rv_n", "rv_a", "residuals", "n_iters", "score_n",
             "score_a")
    for name, jv, tv in zip(names, j, t):
        if name == "n_iters":
            assert int(jv) == int(tv)
        elif name == "residuals":
            np.testing.assert_allclose(tv, jv, rtol=residual_rtol, atol=1e-6)
        else:
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_window_weights_full_matches_jax(kernel, precision, aux, collapse, case_name, request):
    graph = jax_graph(request.getfixturevalue(case_name), aux, collapse)
    pr = {"kind_precision": precision}
    if kernel == "packed_blocked":
        pr["packed_block_bytes"] = blocked_bytes(graph)
    j, t = weights_both(graph, kernel, pr)
    if kernel == "packed_blocked":
        rtol = 1e-4
    elif "bf16" in (kernel[-4:], precision) or precision == "int8":
        rtol = 5e-3
    else:
        rtol = 1e-5
    assert int(t[5]) == 25
    # int8: a last-bit difference in an operand can move its quantization
    # step, and the residual (a difference of nearly equal vectors) shows
    # it most: the residuals at the int8 tolerance too.
    assert_weights_close(j, t, rtol, rtol if precision == "int8" else 1e-4)


@pytest.mark.parametrize("kernel,aux,collapse", [
    ("pallas", "auto", "off"), ("kind", "kind", "on"), ("pcsr", "pcsr", "off"),
])
def test_window_weights_full_with_tol_matches_jax(kernel, aux, collapse, small_case):
    graph = jax_graph(small_case, aux, collapse)
    j, t = weights_both(graph, kernel, {"tol": 1e-4, "iterations": 60})
    assert 0 < int(t[5]) < 60
    assert not t[4][:, int(t[5]):].any()
    assert_weights_close(j, t, 1e-5)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def card_window(device, aux, collapse, kernel, empty_normal=False, block_bytes=None):
    """A giant-tier window (port-only, no JAX) built for ``aux`` on the
    card, with its layouts for ``kernel``."""
    from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
    from microrank_tpu_torch.testing import giant_window

    gw = giant_window(n_spans=60_000, n_ops=192)
    normal = np.zeros(0, np.int64) if empty_normal else gw.normal_codes
    graph, _, _, _ = build_window_graph_from_table(
        gw.table, None, normal, gw.abnormal_codes, aux=aux, collapse=collapse
    )
    block = block_bytes or PageRankConfig.packed_block_bytes
    return device_subset(graph_from_numpy(host_subset(graph, kernel), device), kernel, block)


def bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def both_steps(monkeypatch, dgraph, cfg, kernel):
    """window_weights_full through the fused kernel, then through the
    plain step on the card; the fused kernel's launches counted. Returns
    (got, [plain], launches)."""
    import functools

    before = step.power_step.launches
    got = window_weights_full(dgraph, cfg, kernel)
    launches = step.power_step.launches - before
    wants = []
    for mode in ("plain",):
        with monkeypatch.context() as m:
            m.setattr(torch_cuda, "StepWindow", functools.partial(step.StepWindow, mode=mode))
            wants.append(window_weights_full(dgraph, cfg, kernel))
    torch.cuda.synchronize()
    assert not dgraph.step_scratch.any()  # every slot and the count reset
    return got, wants, launches


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_power_step_is_bitwise_plain_over_a_window(cuda_device, monkeypatch, kernel, precision,
                                                   aux, collapse):
    block = 1 << 20 if kernel == "packed_blocked" else None
    dgraph = card_window(cuda_device, aux, collapse, kernel, block_bytes=block)
    cfg = PageRankConfig(kind_precision=precision)
    got, wants, launches = both_steps(monkeypatch, dgraph, cfg, kernel)
    assert launches == 25  # one launch a step
    for want in wants:
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,aux,collapse", [
    ("pallas", "auto", "off"), ("kind", "kind", "on"), ("pcsr", "pcsr", "off"),
])
@pytest.mark.parametrize("variant", ["tol", "empty", "no-normalize"])
def test_power_step_is_bitwise_plain_with_tol_and_empty(cuda_device, monkeypatch, kernel, aux,
                                                        collapse, variant):
    dgraph = card_window(cuda_device, aux, collapse, kernel, empty_normal=variant == "empty")
    cfg = {
        "tol": PageRankConfig(tol=1e-4, iterations=60),
        "empty": PageRankConfig(tol=1e-4),
        "no-normalize": PageRankConfig(max_normalize_each_iter=False),
    }[variant]
    got, wants, launches = both_steps(monkeypatch, dgraph, cfg, kernel)
    assert launches == cfg.iterations
    for want in wants:
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))
    if variant == "tol":
        assert 0 < int(got[5]) < 60
    if variant == "empty":
        assert torch.isnan(got[0]).all() and int(got[5]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [(), (1,)], ids=["full", "empty-abnormal"])
def test_power_step_chain_of_50_is_bitwise_plain(cuda_device, empty):
    # 50 steps on fixed products: the carries, residuals, n_iters and
    # running flag of the kernel's chain bitwise the plain chain's, each
    # step a window of its own (power_step) and all in one window.
    rng = np.random.default_rng(6)
    inputs = step_inputs(rng, [(5000, 70_000), (5000, 9000)], empty)
    products, carry0, prefs = torch_step_args(inputs, cuda_device)
    cfg = PageRankConfig()
    plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, 1e-30, True,
                          step.step_scratch(cuda_device))
    before = step.power_step.launches
    chains = [window_chain(fn, plan, products, carry0, 50)
              for fn in (step.power_step, None, step.power_step_plain)]
    torch.cuda.synchronize()
    assert step.power_step.launches - before == 100  # one a normalized step
    for chain in chains[:2]:
        assert torch.equal(chain, chains[2])
    assert not plan.scratch.any()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["below", "mid", "at", "past"])
@pytest.mark.parametrize("variant", ["default", "tol", "empty", "no-normalize", "int8",
                                     "int8-subnormal-scale"])
def test_fused_step_below_at_and_past_the_slots(cuda_device, where, variant):
    # One block a vector (max_blocks 4) puts a chosen number of elements
    # on each thread: 6 ("mid": 8 slots, the carry in registers), the
    # slots exactly ("at": the carry in shared memory), twice and one
    # more ("past": those recomputed in phase 2); "below" the card's own
    # grid, one element a thread. Bitwise the plain step over 25 steps.
    kcfg = step.kernel_config(cuda_device)
    slots = kcfg.slots
    per = {"below": 1, "mid": 6, "at": slots, "past": 2 * slots + 1}[where]
    width = 5000 if where == "below" else 256 * per - 37
    sizes = [(width // 3, width), (width // 2, width - 1)]
    max_blocks = None if where == "below" else 4
    rng = np.random.default_rng(21)
    inputs = step_inputs(rng, sizes, empty=(0,) if variant == "empty" else ())
    products, carry, prefs = torch_step_args(inputs, cuda_device)
    cfg = PageRankConfig()
    group = None
    if variant.startswith("int8"):
        # int8-subnormal-scale: weights of at most 1e-37 put every
        # operand's amax / 127 below FLT_MIN, so each scale flushes to 0.
        w = 1e-37 if variant == "int8-subnormal-scale" else 1.0
        group = int8_group(rng, sizes)
        group = group._replace(parts=[p._replace(w_len=(p.w_len * w).to(cuda_device),
                                                 w_cov=(p.w_cov * w).to(cuda_device))
                                      for p in group.parts])
    tol = {"tol": 1e-30, "empty": 1e-4}.get(variant)
    plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, tol, variant != "no-normalize",
                          step.step_scratch(cuda_device), group)
    win = step.StepWindow(plan, carry, torch.zeros((2, 25), device=cuda_device),
                           max_blocks=max_blocks,
                           **({} if tol is None else dict(
                               n_iters=torch.zeros((), dtype=torch.int32, device=cuda_device),
                               running=torch.ones((), dtype=torch.bool, device=cuda_device))))
    in_slots = {"below": 1, "mid": 8, "at": slots, "past": slots}[where]
    assert (win.per_thread, win.slots) == (per, in_slots)
    del win

    def chain(fn):
        return window_chain(fn, plan, products, carry, 25, group is not None, max_blocks)

    before = step.power_step.launches
    got = chain(None)
    assert step.power_step.launches - before == 25
    plain = chain(step.power_step_plain)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert not plan.scratch.any()


@pytest.mark.cuda
def test_fused_int8_scales_are_bitwise_plain_at_every_step(cuda_device, monkeypatch):
    dgraph = card_window(cuda_device, "kind", "on", "kind")
    cfg = PageRankConfig(kind_precision="int8")
    seen = []

    class Checked(step.StepWindow):
        def step(self, products, i, want_scales=False):
            new, scales = super().step(products, i, want_scales)
            if want_scales:
                want = pattern.quantize_scales_plain(
                    self.plan.scale_group, [p[1] for p in new], [p[0] for p in new]
                )
                seen.append(torch.equal(bits(scales), bits(want)))
            return new, scales

    from microrank_tpu_torch.ops import setup

    before = pattern.quantize_scales.launches, setup.rank_setup.scale_launches
    monkeypatch.setattr(torch_cuda, "StepWindow", Checked)
    window_weights_full(dgraph, cfg, "kind")
    torch.cuda.synchronize()
    assert seen == [True] * 24  # every step but the last gives the next one's
    # The first step's, once, from the set-up's launch (no scale launch).
    assert (pattern.quantize_scales.launches - before[0],
            setup.rank_setup.scale_launches - before[1]) == (0, 1)


@pytest.mark.cuda
def test_refused_cooperative_launch_raises(cuda_device):
    # A grid past what the card holds resident: the card refuses the
    # cooperative launch, the step raises, and nothing is counted; a
    # window on the card's own grid then runs.
    cfg_k = step.kernel_config(cuda_device)
    assert cfg_k.cooperative and cfg_k.blocks_per_sm >= 1
    width = 256 * cfg_k.max_blocks
    rng = np.random.default_rng(4)
    products, carry, prefs = torch_step_args(
        step_inputs(rng, [(1000, width), (1000, width)]), cuda_device)
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch(cuda_device))
    residuals = torch.zeros((2, 2), dtype=torch.float32, device=cuda_device)
    win = step.StepWindow(plan, carry, residuals, max_blocks=8 * cfg_k.max_blocks)
    assert win.grid > cfg_k.max_blocks
    before = step.power_step.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        win.step(products, 0)
    assert step.power_step.launches == before
    good = step.StepWindow(plan, carry, residuals)
    assert good.grid <= cfg_k.max_blocks
    new, _ = good.step(products, 0)
    want, _ = step.power_step_plain(plan, products, carry, torch.zeros_like(residuals), 0)
    torch.cuda.synchronize()
    for a, b in zip(new, want):
        assert torch.equal(bits(a[0]), bits(b[0])) and torch.equal(bits(a[1]), bits(b[1]))


@pytest.mark.cuda
def test_power_step_rejects_bad_cuda_inputs(cuda_device):
    rng = np.random.default_rng(1)
    products, carry, prefs = torch_step_args(step_inputs(rng, [(5, 7), (5, 9)]), cuda_device)
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch(cuda_device))
    residuals = torch.zeros((2, 3), device=cuda_device)
    with pytest.raises(ValueError):  # a product of the wrong length
        step.power_step(plan, (products[0], (products[1][0][:3],) + products[1][1:]), carry,
                        residuals, 0)
    with pytest.raises(ValueError):  # the step past the trace
        step.power_step(plan, products, carry, residuals, 3)
    with pytest.raises(ValueError):  # n_iters without a tol
        step.power_step(plan, products, carry, residuals, 0,
                        torch.zeros((), dtype=torch.int32, device=cuda_device),
                        torch.ones((), dtype=torch.bool, device=cuda_device))
