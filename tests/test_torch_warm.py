"""K19, the warm-start program, held to the JAX package on the CPU.

On overlapping windows of a JAX timeline (its frames' timestamps cast to
``datetime64[ns]``, which JAX's stream and window code assume), built by
JAX's builder with the column retention (``retain_columns``), and the
same mapped init (JAX's ``map_warm_state``):

* the port's ``map_warm_state`` / ``capture_warm_state`` give JAX's
  arrays bitwise, from the same fetched state and ``ExplainContext``;
* ``rank_window_warm_core`` against JAX's on ``kind``, ``pallas``,
  ``packed`` and ``csr``, cold and warm: tie-aware top-k identical,
  ``n_valid`` and ``n_iters`` equal, the state tail within rtol 1e-5
  (csr 5e-5, see ``STATE_RTOL``; atol 1e-7);
* an all-miss init falls back to cold, bitwise the cold program;
  a window with warm vectors that are partly masked (padding, absent ops)
  masks them as JAX's ``_warm_override``;
* the iteration drop of JAX's
  ``test_warm_start_drops_iterations_on_overlapping_replay``;
* a stacked group refuses a warm init.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.explain import ExplainContext
from microrank_tpu_torch.ops.setup import rank_setup, warm_override_plain
from microrank_tpu_torch.rank_backends import warm
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
    rank_window_warm,
    rank_window_warm_core,
)
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

AUX = {"kind": "kind", "pallas": "none", "packed": "packed", "csr": "csr"}
PR = dict(tol=1e-4, iterations=50)
# csr's state tail at 5e-5: on the CPU, XLA contracts JAX's csr products
# into its prefix sums (ROADMAP.md, Faults), 1.9e-5 from the port's
# correctly rounded sums on these windows.
STATE_RTOL = {"csr": 5e-5}


def ns_frames(frame):
    """JAX's stream code reads startTime / endTime as nanoseconds."""
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


@pytest.fixture(scope="module")
def windows():
    """Two overlapping windows (50% span overlap) of a JAX timeline and
    its SLO baseline."""
    from microrank_tpu.config import MicroRankConfig
    from microrank_tpu.detect import compute_slo, detect_partition
    from microrank_tpu.testing import SyntheticConfig
    from microrank_tpu.testing.synthetic import generate_timeline

    tl = generate_timeline(SyntheticConfig(n_operations=24, n_traces=160, n_kinds=12, seed=9),
                           3, [0, 1, 2])
    frames = ns_frames(tl.timeline)
    vocab, slo = compute_slo(tl.normal)
    w_us = int(tl.window_minutes * 60e6)
    start = int(tl.start.value // 1000)
    t_us = frames["startTime"].astype("int64") // 1000
    out = []
    for lo_w, hi_w in ((0, 2), (1, 3)):
        f = frames[(t_us >= start + lo_w * w_us) & (t_us < start + hi_w * w_us)]
        flag, nrm, abn = detect_partition(MicroRankConfig(), vocab, slo, f)
        assert flag and nrm and abn
        out.append((f, nrm, abn))
    return out


def build(window, kernel):
    from microrank_tpu.explain.bundle import ExplainContext as JaxContext
    from microrank_tpu.graph import build_window_graph

    f, nrm, abn = window
    collapse = "on" if kernel == "kind" else "off"
    graph, names, ids_n, ids_a, cmap = build_window_graph(
        f, nrm, abn, aux=AUX[kernel], collapse=collapse, retain_columns=True)
    return graph, names, JaxContext.from_build(graph, ids_n, ids_a, *cmap), (ids_n, ids_a, cmap)


def jax_run(graph, init, kernel, pr=PR):
    import jax

    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import SpectrumConfig as JaxSpectrum
    from microrank_tpu.rank_backends.jax_tpu import device_subset as jax_subset
    from microrank_tpu.rank_backends.jax_tpu import rank_window_warm_device

    out = jax.device_get(rank_window_warm_device(
        jax_subset(graph, kernel), init, JaxPageRank(**pr), JaxSpectrum(), kernel))
    return [np.asarray(a) for a in out]


def port_graph(graph, kernel):
    return device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)


def port_run(graph, init, kernel, pr=PR):
    return rank_window_warm(port_graph(graph, kernel), init, PageRankConfig(**pr),
                            SpectrumConfig(), kernel)


def assert_matches(j, t, state_rtol=1e-5):
    n = int(t[2])
    assert int(j[2]) == n and int(j[4]) == int(t[4])
    ok, why = tie_aware_topk_agreement(list(j[0][:n]), list(j[1][:n]), list(t[0][:n]),
                                       list(t[1][:n]), k=n, rtol=1e-5)
    assert ok, why
    for a, b in zip(j[5:9], t[5:9]):
        np.testing.assert_allclose(b, a, rtol=state_rtol, atol=1e-7)


@pytest.mark.parametrize("kernel", list(AUX))
def test_warm_program_matches_jax(windows, kernel):
    from microrank_tpu.rank_backends import warm as jax_warm

    g1, names1, ectx1, _ = build(windows[0], kernel)
    g2, names2, ectx2, _ = build(windows[1], kernel)
    cold1_j, cold1_t = jax_run(g1, None, kernel), port_run(g1, None, kernel)
    assert_matches(cold1_j, cold1_t, STATE_RTOL.get(kernel, 1e-5))
    state_j = jax_warm.capture_warm_state(names1, ectx1, cold1_j[5:9])
    init = jax_warm.map_warm_state(state_j, names2, ectx2, g2)
    # The port's mapping, from the port's own fetched state and context.
    port_ctx = ExplainContext(ectx2.normal_trace_ids, ectx2.abnormal_trace_ids,
                              ectx2.normal_mult, ectx2.abnormal_mult)
    state_t = warm.capture_warm_state(names1, ectx1, cold1_j[5:9])
    for a, b in zip(warm.map_warm_state(state_t, names2, port_ctx, g2), init):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    warm_j, warm_t = jax_run(g2, init, kernel), port_run(g2, init, kernel)
    assert_matches(warm_j, warm_t, STATE_RTOL.get(kernel, 1e-5))
    cold2_t = port_run(g2, None, kernel)
    assert int(warm_t[4]) <= int(cold2_t[4])


def test_an_all_miss_init_is_the_cold_program(windows):
    g, names, ectx, _ = build(windows[1], "kind")
    pg = port_graph(g, "kind")
    zeros = tuple(np.zeros(n, np.float32) for n in (
        g.normal.cov_unique.shape[-1], g.normal.kind.shape[-1],
        g.abnormal.cov_unique.shape[-1], g.abnormal.kind.shape[-1]))
    cold = fetch_rank_outputs(rank_window_traced_core(pg, PageRankConfig(**PR),
                                                      SpectrumConfig(), "kind"))
    warm_out = rank_window_warm(pg, zeros, PageRankConfig(**PR), SpectrumConfig(), "kind")
    for a, b in zip(cold, warm_out[:5]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_the_override_masks_as_jax(windows):
    """Mass on absent ops and padding columns is dropped; a side whose
    live init is all 0 (or holds a NaN, or is subnormal: XLA's CPU
    compares a subnormal max as 0) starts cold; the other side starts
    warm."""
    import jax.numpy as jnp

    from microrank_tpu.rank_backends.jax_tpu import _warm_override

    g, _, _, _ = build(windows[1], "kind")
    pg = graph_from_numpy(g, "cpu")
    gen = np.random.default_rng(4)
    v, tn, ta = (g.normal.cov_unique.shape[-1], g.normal.kind.shape[-1],
                 g.abnormal.kind.shape[-1])
    cases = {
        "random": [gen.random(n).astype(np.float32) for n in (v, tn, v, ta)],
        "sv_n dead": [np.where(np.asarray(g.normal.op_present), 0, 1).astype(np.float32),
                      gen.random(tn).astype(np.float32), gen.random(v).astype(np.float32),
                      gen.random(ta).astype(np.float32)],
        "nan": [np.full(v, np.nan, np.float32), gen.random(tn).astype(np.float32),
                gen.random(v).astype(np.float32), np.zeros(ta, np.float32)],
        "subnormal": [gen.random(v).astype(np.float32), np.full(tn, 1e-41, np.float32),
                      np.full(v, -1e-41, np.float32), np.full(ta, 1e-41, np.float32)],
    }
    cfg = PageRankConfig()
    cold = rank_setup(pg.normal, pg.abnormal, cfg)
    for name, init in cases.items():
        t = rank_setup(pg.normal, pg.abnormal, cfg, init=tuple(torch.from_numpy(x) for x in init))
        j = _warm_override(
            g, ((jnp.asarray(cold[0][1].numpy()), jnp.asarray(cold[0][2].numpy())),
                (jnp.asarray(cold[1][1].numpy()), jnp.asarray(cold[1][2].numpy()))),
            tuple(init), None)
        for (sv_j, rv_j), (_, sv_t, rv_t) in zip(j, t):
            assert np.asarray(sv_j).tobytes() == sv_t.numpy().tobytes(), name
            assert np.asarray(rv_j).tobytes() == rv_t.numpy().tobytes(), name
    sv, rv = warm_override_plain(pg.normal, cold[0][1], cold[0][2],
                                 torch.zeros(v), torch.ones(tn))
    assert torch.equal(sv, cold[0][1]) and not torch.equal(rv, cold[0][2])


def test_warm_start_drops_iterations_on_overlapping_replay(windows):
    g1, names1, ectx1, _ = build(windows[0], "kind")
    g2, names2, ectx2, _ = build(windows[1], "kind")
    cold1 = port_run(g1, None, "kind")
    state = warm.capture_warm_state(names1, ectx1, cold1[5:9])
    cold2 = port_run(g2, None, "kind")
    warm2 = port_run(g2, warm.map_warm_state(state, names2, ectx2, g2), "kind")
    it_cold, it_warm = int(cold2[4]), int(warm2[4])
    assert it_warm <= it_cold
    state2 = warm.capture_warm_state(names2, ectx2, warm2[5:9])
    again = port_run(g2, warm.map_warm_state(state2, names2, ectx2, g2), "kind")
    assert int(again[4]) <= 3 < it_cold
    n = int(cold2[2])
    ok, why = tie_aware_topk_agreement(list(cold2[0][:n]), list(cold2[1][:n]),
                                       list(warm2[0][:n]), list(warm2[1][:n]), k=n, rtol=1e-3)
    assert ok, why


def test_a_stacked_group_refuses_a_warm_init(windows):
    from microrank_tpu_torch.parallel import stack_window_graphs

    g, _, _, _ = build(windows[1], "pallas")
    stacked = port_graph(stack_window_graphs([g, g]), "pallas")
    with pytest.raises(ValueError, match="one window"):
        rank_window_warm_core(stacked, None, PageRankConfig(), SpectrumConfig(), "pallas")


def test_int8_scales_come_from_the_warm_vectors(windows):
    """kind int8: the first step's scales are the overridden vectors'
    (a warm start from the cold fixed point converges at once)."""
    from microrank_tpu.rank_backends import warm as jax_warm

    g, names, ectx, _ = build(windows[1], "kind")
    pr = dict(PR, kind_precision="int8")
    cold = port_run(g, None, "kind", pr)
    state = jax_warm.capture_warm_state(names, ectx, cold[5:9])
    init = jax_warm.map_warm_state(state, names, ectx, g)
    assert_matches(jax_run(g, init, "kind", pr), port_run(g, init, "kind", pr))


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the set-up's warm instance is a CUDA kernel with "
                    "no CPU mode")
    return torch.device("cuda")


def warm_inits(gen, v, t_n, t_a, case):
    init = [gen.random(n).astype(np.float32) for n in (v, t_n, v, t_a)]
    if case == "all_miss":
        init = [np.zeros_like(x) for x in init]
    elif case == "rv_miss":
        init[1][:] = 0
        init[3][:] = 0
    elif case == "nan":
        init[0][v // 3] = np.nan
        init[3][:] = -1.0
    return [torch.from_numpy(x) for x in init]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_miss", "rv_miss", "nan"])
@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("t_pad", [8, 4097, 20_000, 70_000, 1 << 21])
def test_warm_setup_kernel_is_bitwise_its_plain_version(cuda_device, t_pad, collapsed, case):
    """The rows form (a block a row, clusters of 2 and 8) and the grid
    form's warm instances against ``warm_override_plain``."""
    from test_torch_setup import random_part, to_torch

    rng = np.random.default_rng(t_pad)
    live = np.int32(t_pad * 2 // 3 + 1)
    normal = random_part(rng, t_pad, 2048, live, collapsed)
    abnormal = random_part(rng, t_pad // 2 + 1, 2048, live // 2, collapsed)
    init = warm_inits(rng, 2048, t_pad, t_pad // 2 + 1, case)
    cfg = PageRankConfig()
    want = rank_setup(to_torch(normal), to_torch(abnormal), cfg, init=init)
    dn, da = to_torch(normal, cuda_device), to_torch(abnormal, cuda_device)
    from microrank_tpu_torch.ops import setup

    before = setup.rank_setup.warm_launches
    got = rank_setup(dn, da, cfg, init=[x.to(cuda_device) for x in init])
    torch.cuda.synchronize()
    assert setup.rank_setup.warm_launches == before + 1
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("collapse", ["on", "off"])
def test_the_builds_column_identity(collapse):
    """``mr_export_columns``: on a kind-collapsed build each column's
    representative is a member of its kind group (its coverage is the
    column's) and the group's lowest local trace; uncollapsed, the
    identity (JAX's ``retain_columns`` map of None)."""
    import tempfile
    from pathlib import Path

    from microrank_tpu_torch.config import DetectorConfig
    from microrank_tpu_torch.graph import table_ops
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.testing import SyntheticConfig, generate_case

    case = generate_case(SyntheticConfig(n_operations=24, n_traces=200, n_kinds=8, seed=3))
    with tempfile.TemporaryDirectory() as d:
        normal, abnormal = case.write_csvs(Path(d))
        tab = load_span_table(abnormal, cache=False)
        tv, tb = table_ops.compute_slo_from_table(load_span_table(normal, cache=False))
    mask, nrm, abn, _, rng = table_ops.detect_window_partition(
        tab, int(tab.start_us.min()), int(tab.end_us.max()), tv, tb, DetectorConfig(),
        with_range=True)
    aux = "kind" if collapse == "on" else "none"
    g, _, cn, ca, cmap = table_ops.build_window_graph_from_table(
        tab, mask, nrm, abn, aux=aux, collapse=collapse, row_range=rng, retain_columns=True)
    plain = table_ops.build_window_graph_from_table(tab, mask, nrm, abn, aux=aux,
                                                    collapse=collapse, row_range=rng)[0]
    for f in g.normal._fields:  # retaining the columns changes no leaf
        assert np.asarray(getattr(g.normal, f)).tobytes() == \
            np.asarray(getattr(plain.normal, f)).tobytes()
    if collapse == "off":
        assert cmap == (None, None)
        return
    for part, codes, cols in ((g.normal, cn, cmap[0]), (g.abnormal, ca, cmap[1])):
        n_cols = int(part.n_cols)
        assert n_cols > 0 and len(cols) == n_cols and len(set(cols.tolist())) == n_cols
        # Each local trace's ops (its coverage) from the table's rows.
        code_of = {int(c): i for i, c in enumerate(codes)}
        ops = [set() for _ in codes]
        for row in np.flatnonzero(mask):
            t = code_of.get(int(tab.trace_id[rng[0] + row]))
            if t is not None:
                ops[t].add(int(tab.pod_op[rng[0] + row]))
        bits = np.unpackbits(np.asarray(part.cov_bits), axis=1)
        for c, rep in enumerate(cols.tolist()):
            column_ops = set(np.flatnonzero(bits[:, c]).tolist())
            assert ops[rep] == column_ops
            # No lower local trace has the same coverage and length.
            same = [t for t in range(rep) if ops[t] == column_ops]
            assert not [t for t in same if sum(
                tab.trace_id[rng[0] + np.flatnonzero(mask)] == codes[t]) == int(part.tracelen[c])]
