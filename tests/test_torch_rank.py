"""The port's per-window rank program against the JAX package's
``rank_window_traced_core(kernel="pallas")`` (the Pallas kernel runs in
interpret mode on the CPU): the same WindowGraph — built by the JAX
package and carried over with ``graph_from_numpy`` — goes through both.

Tolerances: top-k indices tie-aware equal (exact ties may permute only
among themselves, scores tied within 1e-5); n_valid and n_iters equal;
scores rtol 1e-5 (float32 sums in another order, amplified by 25 steps
and the spectrum formula); residuals rtol 1e-4 / atol 1e-6 (differences
of nearly equal vectors lose digits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import partition_case
from microrank_tpu.config import (
    MicroRankConfig as JaxConfig,
    PageRankConfig as JaxPageRank,
    SpectrumConfig as JaxSpectrum,
)
from microrank_tpu.graph import build_window_graph
from microrank_tpu.rank_backends.jax_tpu import rank_window_traced_device
from microrank_tpu.spectrum.formulas import (
    METHODS as JAX_METHODS,
    spectrum_scores as jax_spectrum_scores,
)
from microrank_tpu_torch.config import PageRankConfig, SpectrumConfig
from microrank_tpu_torch.rank_backends.convert import (
    baseline_from_numpy,
    graph_from_numpy,
)
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    rank_window_traced_core,
)
from microrank_tpu_torch.spectrum.formulas import METHODS, spectrum_scores
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement


def rank_both(graph, pr_kwargs=None, sp_kwargs=None):
    pr_kwargs, sp_kwargs = pr_kwargs or {}, sp_kwargs or {}
    dg = jax.tree.map(jnp.asarray, graph)
    j = rank_window_traced_device(
        dg, JaxPageRank(**pr_kwargs), JaxSpectrum(**sp_kwargs), None, "pallas"
    )
    j = tuple(np.asarray(a) for a in j)
    tg = device_subset(graph_from_numpy(graph, "cpu"), "pallas")
    t = fetch_rank_outputs(
        rank_window_traced_core(
            tg, PageRankConfig(**pr_kwargs), SpectrumConfig(**sp_kwargs), "pallas"
        )
    )
    return j, t


def assert_parity(j, t):
    j_idx, j_sc, j_nv, j_res, j_it = j
    t_idx, t_sc, t_nv, t_res, t_it = t
    assert int(j_nv) == t_nv
    assert int(j_it) == t_it
    n = t_nv
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:n]), list(j_sc[:n]), list(t_idx[:n]), list(t_sc[:n]),
        k=n, rtol=1e-5,
    )
    assert ok, why
    np.testing.assert_allclose(t_sc[:n], j_sc[:n], rtol=1e-5)
    np.testing.assert_allclose(t_res, j_res, rtol=1e-4, atol=1e-6)
    assert np.all(t_res[:, t_it:] == 0)


@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_rank_parity_with_jax_pallas(case_name, collapse, request):
    case = request.getfixturevalue(case_name)
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(
        case.abnormal, nrm, abn, collapse=collapse
    )
    assert (int(graph.normal.n_cols) >= 0) == (collapse == "on")
    j, t = rank_both(graph)
    assert_parity(j, t)
    assert names[t[0][0]] == case.fault_pod_op


def test_rank_parity_with_tol(small_case):
    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn)
    pr = dict(tol=1e-4, iterations=60)
    j, t = rank_both(graph, pr)
    assert 0 < t[4] < 60  # stopped early, on the device flag
    assert_parity(j, t)


def test_tie_order_pinned_like_jax():
    # Tarantula saturation (the JAX suite's tie case): three ops present
    # only in abnormal traces, covering all of them, score exactly 2/3.
    # Exact ties must come out in ascending vocab index (= op name) in
    # both packages: positional equality, not just tie-aware.
    import pandas as pd

    rows = []
    sid = 0

    def trace(tid, ops):
        nonlocal sid
        root_sid = f"s{sid}"
        for i, op in enumerate(ops):
            rows.append(dict(
                traceID=tid, spanID=f"s{sid}",
                ParentSpanId="missing" if i == 0 else root_sid,
                operationName=op, serviceName="svc", podName="svc-0",
                duration=1000, startTime=0, endTime=10,
            ))
            sid += 1

    nrm = [f"n{i}" for i in range(4)]
    abn = [f"a{i}" for i in range(4)]
    for tid in nrm:
        trace(tid, ["root"])
    for tid in abn:
        trace(tid, ["root", "tie-b", "tie-a", "tie-c"])
    graph, names, _, _ = build_window_graph(pd.DataFrame(rows), nrm, abn)
    j, t = rank_both(graph, sp_kwargs=dict(method="tarantula"))
    n = t[2]
    np.testing.assert_array_equal(t[0][:n], j[0][:n])
    assert [names[i] for i in t[0][:3]] == [
        "svc-0_tie-a", "svc-0_tie-b", "svc-0_tie-c"
    ]
    assert t[1][0] == t[1][1] == t[1][2]


def test_all_formulas_match_jax():
    rng = np.random.default_rng(0)
    ef, nf, ep, np_ = (rng.uniform(1e-7, 50.0, 257).astype(np.float32) for _ in range(4))
    assert set(METHODS) == set(JAX_METHODS) and len(METHODS) == 13
    for method in METHODS + ("simplematching",):
        j = np.asarray(jax_spectrum_scores(*map(jnp.asarray, (ef, nf, ep, np_)), method))
        t = spectrum_scores(*map(torch.from_numpy, (ef, nf, ep, np_)), method).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=method)
    with pytest.raises(ValueError):
        spectrum_scores(*map(torch.from_numpy, (ef, nf, ep, np_)), "nope")


def test_graph_from_numpy_carries_every_field(small_case):
    nrm, abn = partition_case(small_case)
    graph, _, _, _ = build_window_graph(small_case.abnormal, nrm, abn)
    tg = graph_from_numpy(graph, "cpu")
    for part in ("normal", "abnormal"):
        src, dst = getattr(graph, part), getattr(tg, part)
        for f in src._fields:
            if f == "cov_i8":
                # The port keeps the kind pattern as the bitmap JAX unpacks.
                if src.cov_i8.shape[-1]:
                    np.testing.assert_array_equal(
                        np.unpackbits(dst.cov_bits.numpy(), axis=1)[:, : src.cov_i8.shape[1]],
                        src.cov_i8,
                    )
                continue
            a, b = np.asarray(getattr(src, f)), getattr(dst, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_baseline_from_numpy():
    from microrank_tpu.io.interning import Vocab as JaxVocab

    names = ["svc_a", "svc_b"]
    vocab, base = baseline_from_numpy(names, [1.5, 2.0], [0.25, 0.5])
    assert vocab.names == JaxVocab(names).names
    assert vocab.encode(["svc_b", "x"]).tolist() == [1, -1]
    assert base.mean_ms.dtype == np.float32 and base.std_ms.tolist() == [0.25, 0.5]
