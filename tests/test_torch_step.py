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
* on the card (``cuda`` marker, skipped here): ``power_step`` bitwise
  ``power_step_plain`` run on the card, over whole windows of every
  route (50 launches each), with ``tol`` and with an empty partition,
  and over a chain of 50 steps; the int8 scales it gives bitwise
  ``quantize_scales_plain`` of the vectors it carries, at every step.

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
    # A plan needs both partitions' preference vectors; the kernel's
    # checks refuse a tensor that is not on the card.
    rng = np.random.default_rng(1)
    products, carry, prefs = torch_step_args(step_inputs(rng, [(5, 7), (5, 9)]))
    plan = step.step_plan(prefs, 0.01, 0.85, None, True, step.step_scratch("cpu"))
    with pytest.raises(ValueError):
        step.step_plan(prefs[:1], 0.01, 0.85, None, True, step.step_scratch("cpu"))
    with pytest.raises(ValueError):
        step._check(plan, products, carry, torch.zeros((2, 3)), 0, None, None, False,
                    torch.device("cpu"))


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
    """window_weights_full through the kernel, then through the plain
    step on the card; the kernel's launches counted."""
    before = step.power_step.launches
    got = window_weights_full(dgraph, cfg, kernel)
    launches = step.power_step.launches - before
    with monkeypatch.context() as m:
        m.setattr(torch_cuda, "power_step", step.power_step_plain)
        want = window_weights_full(dgraph, cfg, kernel)
    torch.cuda.synchronize()
    assert not dgraph.step_scratch.any()  # every slot and the count reset
    return got, want, launches


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,precision,aux,collapse", ROUTES, ids=ROUTE_IDS)
def test_power_step_is_bitwise_plain_over_a_window(cuda_device, monkeypatch, kernel, precision,
                                                   aux, collapse):
    block = 1 << 20 if kernel == "packed_blocked" else None
    dgraph = card_window(cuda_device, aux, collapse, kernel, block_bytes=block)
    cfg = PageRankConfig(kind_precision=precision)
    got, want, launches = both_steps(monkeypatch, dgraph, cfg, kernel)
    assert launches == 50
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
    got, want, launches = both_steps(monkeypatch, dgraph, cfg, kernel)
    assert launches == (25 if variant == "no-normalize" else 2 * cfg.iterations)
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
    # running flag of the kernel's chain bitwise the plain chain's.
    rng = np.random.default_rng(6)
    inputs = step_inputs(rng, [(5000, 70_000), (5000, 9000)], empty)
    products, carry0, prefs = torch_step_args(inputs, cuda_device)
    cfg = PageRankConfig()
    out = []
    for fn in (step.power_step, step.power_step_plain):
        plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, 1e-30, True,
                              step.step_scratch(cuda_device))
        residuals = torch.zeros((2, 50), dtype=torch.float32, device=cuda_device)
        n_iters = torch.zeros((), dtype=torch.int32, device=cuda_device)
        running = torch.ones((), dtype=torch.bool, device=cuda_device)
        carry, trail = carry0, []
        for i in range(50):
            carry, _ = fn(plan, products, carry, residuals, i, n_iters, running)
            trail.append(torch.cat([t for part in carry for t in part]))
        out.append((torch.stack(trail), residuals, n_iters, running))
    torch.cuda.synchronize()
    for g, w in zip(*out):
        assert torch.equal(bits(g), bits(w))


@pytest.mark.cuda
def test_fused_int8_scales_are_bitwise_plain_at_every_step(cuda_device, monkeypatch):
    dgraph = card_window(cuda_device, "kind", "on", "kind")
    cfg = PageRankConfig(kind_precision="int8")
    seen = []

    def checked(plan, products, carry, residuals, i, n_iters=None, running=None,
                want_scales=False):
        new, scales = step.power_step(plan, products, carry, residuals, i, n_iters, running,
                                      want_scales)
        if want_scales:
            want = pattern.quantize_scales_plain(
                plan.scale_group, [p[1] for p in new], [p[0] for p in new]
            )
            seen.append(torch.equal(bits(scales), bits(want)))
        return new, scales

    before = pattern.quantize_scales.launches
    monkeypatch.setattr(torch_cuda, "power_step", checked)
    window_weights_full(dgraph, cfg, "kind")
    torch.cuda.synchronize()
    assert seen == [True] * 24  # every step but the last gives the next one's
    assert pattern.quantize_scales.launches - before == 1  # the first step's, once


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
