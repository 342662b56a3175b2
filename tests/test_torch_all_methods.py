"""K13, every spectrum formula ranked in one program, held to the JAX
package on the CPU (where the epilogue's wrapper runs its plain version,
``ops.epilogue.finish_topk_all_methods``):

* the port's ``rank_window_all_methods`` against JAX's
  ``rank_window_all_methods_device`` on the same numpy graph
  (``graph_from_numpy``), routes kind, pallas, packed_bf16 and dense,
  collapsed and not, two cases: per formula, the indices tie-aware
  identical, ``n_valid`` equal, the scores within rtol 1e-5 (packed_bf16
  5e-3). goodman's and hamann's numerators are differences of the
  counters, so their scores (in [-1, 1]) carry the counters' rounding at
  the scale of 1: they are held at that rtol of max(|score|, 1). JAX's
  own f32 routes differ by 4.6e-5 of pod_case's rank-5 goodman score
  (0.0069428 kind, 0.0069431 pallas, 0.0069429 dense);
* row m bitwise the one-formula program with formula m (the weights,
  scores and n_valid too), at k = n_rows and at k = V;
* the epilogue alone: ``rank_epilogue_all_methods`` on a stacked group
  row for row its windows' own, and the rows in ``METHODS`` order, which
  is the kernel's formula order;
* a stacked group and the checked epilogue refuse the all-methods
  program, as JAX has neither.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import partition_case
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.graph import build_window_graph
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu.spectrum.formulas import METHODS as JAX_METHODS
from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.ops import epilogue
from microrank_tpu_torch.parallel import stack_window_graphs
from microrank_tpu_torch.rank_backends import torch_cuda as tc
from microrank_tpu_torch.rank_backends.blob import stage_rank_window
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.spectrum.formulas import METHODS

# Formulas whose numerator is a difference of the counters (scores in
# [-1, 1]): compared relative to max(|score|, 1).
DIFFERENCE_FORMULAS = ("goodman", "hamann")

ROUTES = {  # kernel: the aux views its window is built with
    "kind": "kind",
    "pallas": "none",
    "packed_bf16": "packed",
    "dense": "none",
}


def rtol_of(kernel):
    return 5e-3 if kernel == "packed_bf16" else 1e-5


def host_graph(case, kernel, collapse):
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=ROUTES[kernel],
                                            collapse=collapse)
    return graph, names


def port_graph(graph, kernel):
    return tc.device_subset(graph_from_numpy(tc.host_subset(graph, kernel), "cpu"), kernel)


def jax_all_methods(graph, kernel, spectrum=None):
    out = jax_tpu.rank_window_all_methods_device(
        jax.tree.map(jnp.asarray, graph), JaxPageRank(), spectrum or JaxSpectrum(), None, kernel)
    return [np.asarray(a) for a in out]


def rows_agree(ids_a, scores_a, ids_b, scores_b, rtol, floor=0.0):
    """Two rankings of one formula agree: rank by rank the scores within
    ``rtol`` of max(|a|, |b|, ``floor``), and where the ids differ both
    are in the other list with scores tied to the rank's (the tie-aware
    rule of ``utils.ranking_compare``). Returns (agree, reason)."""
    def tied(a, b):
        return abs(a - b) <= rtol * max(abs(a), abs(b), floor, 1e-12)

    ids_a, ids_b = [int(i) for i in ids_a], [int(i) for i in ids_b]
    if len(ids_a) != len(ids_b):
        return False, "length mismatch"
    for r, (sa, sb) in enumerate(zip(map(float, scores_a), map(float, scores_b))):
        if not tied(sa, sb):
            return False, f"score mismatch at rank {r}: {sa} vs {sb}"
        if ids_a[r] == ids_b[r]:
            continue
        if ids_a[r] not in ids_b or ids_b[r] not in ids_a:
            return False, f"id mismatch at rank {r}: {ids_a[r]} vs {ids_b[r]}"
        for cross in (float(scores_b[ids_b.index(ids_a[r])]),
                      float(scores_a[ids_a.index(ids_b[r])])):
            if not tied(cross, sa):
                return False, f"non-tied id swap at rank {r}"
    return True, "ok"


def assert_rows_match(j, t, rtol):
    n = t[2]
    assert int(j[2]) == n > 0
    for m, method in enumerate(METHODS):
        floor = 1.0 if method in DIFFERENCE_FORMULAS else 0.0
        ok, why = rows_agree(j[0][m, :n], j[1][m, :n], t[0][m, :n], t[1][m, :n], rtol, floor)
        assert ok, f"{method}: {why}"
        assert np.all(np.isneginf(t[1][m, n:])) and np.all(np.isneginf(j[1][m, n:]))


def test_the_rows_are_jaxs_methods_in_the_kernels_order():
    assert METHODS == JAX_METHODS and len(METHODS) == 13
    assert "simplematcing" in METHODS and "simplematching" not in METHODS
    assert [epilogue.method_id(m) for m in METHODS] == list(range(13))


@pytest.mark.parametrize("kernel", list(ROUTES))
@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_all_methods_match_jax(request, case_name, collapse, kernel):
    graph, names = host_graph(request.getfixturevalue(case_name), kernel, collapse)
    j = jax_all_methods(graph, kernel)
    t = tc.rank_window_all_methods(port_graph(graph, kernel), PageRankConfig(),
                                   SpectrumConfig(), kernel)
    assert t[0].shape == t[1].shape == j[0].shape == (13, j[0].shape[1])
    assert t[0].dtype == np.int32 and t[1].dtype == np.float32
    assert_rows_match(j, t, rtol_of(kernel))


@pytest.mark.parametrize("kernel", list(ROUTES))
@pytest.mark.parametrize("top_max", [5, None])
def test_each_row_is_the_one_method_program(pod_case, kernel, top_max):
    """Row m bitwise the program ranked by formula m alone, at k = n_rows
    and (top_max None) at k = V."""
    graph, _ = host_graph(pod_case, kernel, "on" if kernel == "kind" else "off")
    v = graph.normal.cov_unique.shape[-1]
    top = v if top_max is None else top_max
    dg = port_graph(graph, kernel)
    pr = PageRankConfig()
    all_prog = tc._rank_program(dg, pr, SpectrumConfig(top_max=top), kernel, "all_methods")
    assert all_prog.epilogue.top_idx.shape == (13, min(top + 6, v))
    for m, method in enumerate(METHODS):
        one = tc._rank_program(dg, pr, SpectrumConfig(method=method, top_max=top), kernel)
        for field in ("top_idx", "top_scores"):
            a = getattr(all_prog.epilogue, field)[m]
            b = getattr(one.epilogue, field)
            assert a.numpy().tobytes() == b.numpy().tobytes(), (method, field)
        for field in ("n_weight", "a_weight", "score_n", "score_a", "n_valid"):
            a, b = getattr(all_prog.epilogue, field), getattr(one.epilogue, field)
            assert a.numpy().tobytes() == b.numpy().tobytes(), (method, field)


def test_full_depth_matches_jax(pod_case):
    """k = V (the harness ranks full depth): JAX's program at the same k."""
    graph, _ = host_graph(pod_case, "pallas", "off")
    v = graph.normal.cov_unique.shape[-1]
    j = jax_all_methods(graph, "pallas", JaxSpectrum(top_max=v))
    t = tc.rank_window_all_methods(port_graph(graph, "pallas"), PageRankConfig(),
                                   SpectrumConfig(top_max=v), "pallas")
    assert t[0].shape == j[0].shape == (13, v)
    assert_rows_match(j, t, 1e-5)


def test_staged_program_matches_the_direct_one(small_case):
    """Blob staging (the harness's path) and the direct program: the
    same bits."""
    graph, _ = host_graph(small_case, "kind", "on")
    pr, sp = PageRankConfig(), SpectrumConfig()
    direct = tc.rank_window_all_methods(port_graph(graph, "kind"), pr, sp, "kind")
    for blob in (True, False):
        outs, _ = stage_rank_window(tc.host_subset(graph, "kind"), pr, sp, "kind", "cpu", blob,
                                    all_methods=True)
        staged = tc.fetch_rank_outputs(outs)
        assert len(staged) == 3
        for a, b in zip(staged, direct):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_epilogue_on_a_group_is_its_windows_rows(small_case, pod_case):
    """The epilogue's wrapper takes a window axis: on a stacked pair its
    [B, M, k] rows are each window's own, and its weights the one-method
    epilogue's."""
    graphs = [host_graph(c, "pallas", "off")[0] for c in (small_case, pod_case)]
    pr, sp = PageRankConfig(), SpectrumConfig(top_max=8)
    stacked = port_graph(stack_window_graphs(graphs), "pallas")
    prog = tc._rank_program(stacked, pr, sp, "pallas")
    g = stacked
    both = epilogue.rank_epilogue_all_methods(g.normal, g.abnormal, prog.sv_n, prog.sv_a, sp)
    assert both.top_idx.shape == (2, 13, 14)
    for name in ("n_weight", "a_weight", "score_n", "score_a", "n_valid"):
        assert torch.equal(getattr(both, name), getattr(prog.epilogue, name))
    for b, graph in enumerate(graphs):
        own = tc._rank_program(port_graph(graph, "pallas"), pr, sp, "pallas", "all_methods")
        n = int(own.epilogue.n_valid)
        assert int(both.n_valid[b]) == n
        assert torch.equal(both.top_idx[b, :, :n], own.epilogue.top_idx[:, :n])


def test_refusals(small_case):
    graph, _ = host_graph(small_case, "pallas", "off")
    stacked = port_graph(stack_window_graphs([graph, graph]), "pallas")
    with pytest.raises(ValueError, match="one window"):
        tc.rank_window_all_methods_core(stacked, PageRankConfig(), SpectrumConfig(), "pallas")
    dg = port_graph(graph, "pallas")
    with pytest.raises(ValueError, match="unknown epilogue"):
        tc._rank_program(dg, PageRankConfig(), SpectrumConfig(), "pallas", "every")
    prog = tc._rank_program(dg, PageRankConfig(), SpectrumConfig(), "pallas")
    with pytest.raises(ValueError, match="one formula"):
        epilogue._rank_epilogue(dg.normal, dg.abnormal, prog.sv_n, prog.sv_a,
                                SpectrumConfig(), False, None, check=True, all_methods=True)
