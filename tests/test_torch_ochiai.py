"""ochiai at its 1.0 saturation, held where the reference lets it be held
(ROADMAP.md, Faults: settled).

The port computes ochiai IEEE: ``ef / sqrt(d)``, d = (ep + ef) * (ef +
nf), each op correctly rounded. XLA's CPU backend rewrites ``ef /
sqrt(d)`` to ``ef * rsqrt(d)`` with an approximate rsqrt that depends on
the host CPU, so no chain of correctly rounded operations gives JAX's
bits. On the windows of ``cli eval --all-methods``' seeds 1027 and
1032 (its defaults: 30 ops, 400 traces, 48 kinds, keep 0.15), where the
fault and another op both score about 1.0:

* JAX's ochiai formula (its one-formula program's, jitted on the CPU)
  on the port's counters is within 2 ulp of the port's scores;
* the port's spectrum and ochiai on the weights of JAX's power
  iteration are within 2 ulp of JAX's whole one-formula program on the
  same graph and route (``coo``);
* the port's whole program is within 4 ulp of JAX's: its f32 power
  iteration's weights are not JAX's bits (up to 16 ulp apart on the
  normal side at seed 1027, 2 on the abnormal), which moves a score by
  one ulp past the formula's two (3 measured at seed 1027, 2 at 1032);
* the port's ochiai scores are bitwise ``ef / torch.sqrt(d)`` of its
  own counters.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, SpectrumConfig
from microrank_tpu_torch.evaluation import EvalConfig, _case_config, _detect_partition, _load
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.ops.epilogue import spectrum_counters, window_spectrum
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
    window_weights_full,
)
from microrank_tpu_torch.testing import generate_case

SEEDS = (1027, 1032)
CLI_EVAL = EvalConfig(n_traces=400, n_kinds=48, child_keep_prob=0.15)


@pytest.fixture(scope="module", params=SEEDS)
def window(request, tmp_path_factory):
    case = generate_case(_case_config(CLI_EVAL, request.param))
    normal, table = _load(case, tmp_path_factory.mktemp(f"ochiai{request.param}"))
    ok, mask, nrm, abn, rng = _detect_partition(normal, table, MicroRankConfig())
    assert ok
    graph, names, _, _ = build_window_graph_from_table(table, mask, nrm, abn, aux="none",
                                                       row_range=rng)
    return graph, names, case.fault_pod_ops[0]


def by_op(idx, scores, n, v):
    out = np.full(v, np.nan, np.float32)
    out[np.asarray(idx)[:n]] = np.asarray(scores)[:n]
    return out


def port_ochiai(graph):
    v = graph.normal.cov_unique.shape[-1]
    spec = SpectrumConfig(method="ochiai", top_max=v)
    dg = device_subset(graph_from_numpy(host_subset(graph, "coo"), "cpu"), "coo")
    idx, scores, n, _, _ = fetch_rank_outputs(
        rank_window_traced_core(dg, PageRankConfig(), spec, "coo"))
    return dg, by_op(idx, scores, n, v), spec


def ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def test_ochiai_is_within_2_ulp_of_jaxs_one_formula_program(window):
    """JAX's ochiai (its one-formula program's formula, jitted on the CPU)
    on the port's counters is within 2 ulp of the port's scores; the
    port's spectrum on JAX's weights is within 2 ulp of JAX's whole
    one-formula program, and the port's whole program within 4 ulp."""
    import jax
    import jax.numpy as jnp

    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import SpectrumConfig as JaxSpectrum
    from microrank_tpu.rank_backends import jax_tpu
    from microrank_tpu.spectrum.formulas import spectrum_scores as jax_scores

    graph, names, fault = window
    dg, port, spec = port_ochiai(graph)
    n_w, a_w = window_weights_full(dg, PageRankConfig(), "coo")[:2]
    ef, nf, ep, np_, valid = spectrum_counters(a_w, dg.abnormal, n_w, dg.normal, spec)
    ref = np.asarray(jax.jit(lambda *c: jax_scores(*c, "ochiai"))(
        *(jnp.asarray(t.numpy()) for t in (ef, nf, ep, np_))))
    live = valid.numpy()
    assert ulps(port[live], ref[live]).max() <= 2
    # The whole program: JAX's coo route on the same graph.
    v = port.shape[0]
    jg = jax.tree.map(jnp.asarray, graph)
    idx, scores, n = [np.asarray(a) for a in jax_tpu.rank_window_traced_device(
        jg, JaxPageRank(), JaxSpectrum(method="ochiai", top_max=v), None, "coo")[:3]]
    whole = by_op(idx, scores, int(n), v)
    assert np.array_equal(~np.isnan(whole), live)
    # The port's spectrum on JAX's weights: the formula's 2 ulp alone.
    jn, ja = jax.jit(lambda g: jax_tpu.window_weights_full(g, JaxPageRank(), None, "coo")[:2])(jg)
    on_jax = window_spectrum(torch.from_numpy(np.array(ja)), dg.abnormal,
                             torch.from_numpy(np.array(jn)), dg.normal, spec)[0].numpy()
    assert ulps(on_jax[live], whole[live]).max() <= 2
    # The port's whole program: the weights' ulps on top.
    assert ulps(port[live], whole[live]).max() <= 4
    # The window is the saturated one: the fault scores about 1.0.
    assert abs(port[names.index(fault)] - 1.0) < 1e-6


def test_ochiai_is_ieee_division_by_the_square_root(window):
    graph, _, _ = window
    dg, port, spec = port_ochiai(graph)
    n_w, a_w = window_weights_full(dg, PageRankConfig(), "coo")[:2]
    ef, nf, ep, _, valid = spectrum_counters(a_w, dg.abnormal, n_w, dg.normal, spec)
    want = (ef / torch.sqrt((ep + ef) * (ef + nf))).numpy()
    live = valid.numpy()
    assert port[live].tobytes() == want[live].tobytes()
