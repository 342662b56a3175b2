"""The port's numpy oracle (``rank_backends.NumpyRefBackend`` over
``graph.dicts.pagerank_graph_dicts``, serve's degradation path) against
the JAX package's ``NumpyRefBackend`` on the same windows.

Both packages read the same CSV pair (the port through its C++ loader,
JAX through pandas) and partition it with the port's C++ detector; JAX
is handed the window's rows in the port's table order (a stable sort by
start time, as the loader leaves them), so that the dicts are compared
key order and all. Tolerance: none. The dicts are equal, and the names,
scores and convergence record are bitwise JAX's. With JAX's frame in its
own CSV order (the childless ops come in another order) the names are
equal, the scores within 1e-12 relative and the residual trace within
1e-15 absolute.
"""

from __future__ import annotations

import numpy as np
import pytest

from microrank_tpu_torch.config import (
    DetectorConfig,
    MicroRankConfig,
    PageRankConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.graph.dicts import pagerank_graph_dicts
from microrank_tpu_torch.graph.table_ops import compute_slo_from_table, detect_window_partition
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.rank_backends import NumpyRefBackend, validate_partitions
from microrank_tpu_torch.testing import SyntheticConfig, generate_case

CASES = {
    "serve_case": dict(n_operations=24, n_traces=120, seed=7),
    "pods": dict(n_operations=16, n_pods=2, n_traces=160, seed=11),
    "kinds": dict(n_operations=30, n_traces=200, n_kinds=24, child_keep_prob=0.6, seed=42),
}
CONFIGS = {
    "default": MicroRankConfig(),
    "paper_tol": MicroRankConfig(pagerank=PageRankConfig(preference="paper", tol=1e-4,
                                                         iterations=50)),
    "ochiai_top3": MicroRankConfig(spectrum=SpectrumConfig(method="ochiai", top_max=3)),
}


@pytest.fixture(scope="module", params=list(CASES))
def window(request, tmp_path_factory):
    """(port table, JAX frame in table order, JAX frame in CSV order,
    normal codes, abnormal codes) of one case's abnormal window."""
    from microrank_tpu.io import load_traces_csv

    case = generate_case(SyntheticConfig(**CASES[request.param]))
    normal_csv, abnormal_csv = case.write_csvs(tmp_path_factory.mktemp(request.param))
    normal = load_span_table(normal_csv, cache=False)
    table = load_span_table(abnormal_csv, cache=False)
    vocab, slo = compute_slo_from_table(normal)
    _, nrm, abn, _ = detect_window_partition(
        table, int(table.start_us.min()), int(table.end_us.max()), vocab, slo, DetectorConfig())
    assert len(nrm) and len(abn)
    df = load_traces_csv(abnormal_csv)
    in_table_order = df.iloc[np.argsort(df["startTime"].to_numpy(), kind="stable")]
    return table, in_table_order.reset_index(drop=True), df, list(nrm), list(abn)


def test_graph_dicts_equal_jax(window):
    from microrank_tpu.graph.dicts import pagerank_graph_dicts as jax_dicts

    table, frame, _, nrm, abn = window
    for codes in (nrm, abn):
        ids = [table.trace_names[c] for c in codes]
        ours, theirs = pagerank_graph_dicts(codes, table), jax_dicts(ids, frame)
        for a, b in zip(ours, theirs):
            assert list(a) == list(b)
            assert a == b


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_rank_window_bitwise_jax(window, cfg_name):
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import SpectrumConfig as JaxSpectrum
    from microrank_tpu.rank_backends import NumpyRefBackend as JaxBackend

    table, frame, csv_frame, nrm, abn = window
    cfg = CONFIGS[cfg_name]
    jcfg = JaxConfig(pagerank=JaxPageRank(**vars(cfg.pagerank)),
                     spectrum=JaxSpectrum(**vars(cfg.spectrum)))
    ours = NumpyRefBackend(cfg)
    names, scores = ours.rank_window(table, nrm, abn)
    ids_n = [table.trace_names[c] for c in nrm]
    ids_a = [table.trace_names[c] for c in abn]
    theirs = JaxBackend(jcfg)
    assert theirs.rank_window(frame, ids_n, ids_a) == (names, scores)  # bitwise
    assert ours.last_convergence == theirs.last_convergence
    # JAX's frame in its CSV order appends the childless ops in another
    # order (a zero column of p_ss elsewhere, so BLAS sums in another
    # order): the same names, scores within 1e-12 relative and the
    # residual trace within 1e-15 absolute (float64 rounding).
    theirs = JaxBackend(jcfg)
    j_names, j_scores = theirs.rank_window(csv_frame, ids_n, ids_a)
    assert j_names == names
    np.testing.assert_allclose(scores, j_scores, rtol=1e-12, atol=0)
    for part in ("normal", "abnormal"):
        np.testing.assert_allclose(ours.last_convergence["residuals"][part],
                                   theirs.last_convergence["residuals"][part], rtol=0,
                                   atol=1e-15)
    assert len(names) == cfg.spectrum.n_rows


def test_empty_partition_raises_as_jax():
    with pytest.raises(ValueError, match="non-empty normal AND abnormal"):
        validate_partitions([], [1])
    with pytest.raises(ValueError, match="non-empty normal AND abnormal"):
        NumpyRefBackend().rank_window(None, [0], [])


def test_numpy_ref_module_is_jax_copy():
    """The oracle's functions compute JAX's values on the same dicts
    (the serve case's window through both modules)."""
    import microrank_tpu.rank_backends.numpy_ref as jax_ref
    from microrank_tpu_torch.rank_backends import numpy_ref

    dicts = (
        {"a": ["b", "c", "c"], "b": ["c"], "c": []},
        {"t1": ["a", "b"], "t2": ["a", "c", "c"], "t3": ["b"]},
        {"a": ["t1", "t2"], "b": ["t1", "t3"], "c": ["t2", "t2"]},
    )
    pr = {k: list(v) for k, v in dicts[1].items()}
    for anomaly in (False, True):
        a = numpy_ref.trace_pagerank(*dicts, pr, anomaly)
        b = jax_ref.trace_pagerank(*dicts, pr, anomaly)
        assert a == b
