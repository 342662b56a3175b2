"""K14, the checked program (``RuntimeConfig.device_checks``), held to
the JAX package's ``rank_window_checked`` / ``rank_window_checked_traced``
and its ``tests/test_sanitizers.py`` cases on the CPU:

* the checked program ranks bitwise what the unchecked one ranks, on
  every route, and its check word is 0; JAX's checked ranking is equal
  too (tie-aware, scores rtol 1e-5);
* a window whose ``abnormal.sr_val[0]`` is NaN raises ``DeviceCheckError``
  whose message holds "non-finite", as JAX raises
  ``checkify.JaxRuntimeError``; the message is JAX's, and the first
  failed check's in JAX's order;
* the check word's three bits (``check_word_plain``): live scores only,
  n_valid outside [0, k], live residuals only;
* blob staging's checked branch issues with no wait and the fetch
  raises; the run loop honors ``device_checks`` (rankings equal to the
  unchecked run's, as JAX's lane test) and makes JAX's decisions with
  JAX's warnings (synchronous dispatch; micro-batched dispatch per
  window; ``batch_windows=True`` unchecked); ``cli run --device-checks``;
* on the card (``-m cuda``): the epilogue's check word bitwise the
  plain version's in every form (a block, a cluster, the first design
  past a cluster's reach), one window and stacked, with the residual
  trace and without, and every other output bitwise the unchecked
  launch's.

JAX is imported inside the CPU tests only:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_checked.py
"""

import logging
from typing import NamedTuple

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import (
    IngestConfig,
    MicroRankConfig,
    RuntimeConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.ops import epilogue
from microrank_tpu_torch.ops.epilogue import (
    CHECK_MESSAGES,
    CHECK_N_VALID,
    CHECK_NONFINITE_RESIDUAL,
    CHECK_NONFINITE_SCORE,
    check_word_plain,
)
from microrank_tpu_torch.rank_backends import blob
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    DeviceCheckError,
    device_subset,
    fetch_rank_outputs,
    host_subset,
    pack_rank_outputs,
    rank_window_checked,
    rank_window_checked_traced,
    rank_window_traced_core,
    unpack_rank_outputs,
)

# (kernel, build aux)
ROUTES = [("coo", "none"), ("csr", "csr"), ("dense", "none"), ("dense_bf16", "none"),
          ("pallas", "none"), ("kind", "kind"), ("packed_bf16", "packed"), ("pcsr", "pcsr")]


def jax_graph(case, aux="none", collapse="off"):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph

    nrm, abn = partition_case(case)
    collapse = "on" if aux == "kind" else collapse
    graph, _, _, _ = build_window_graph(case.abnormal, nrm, abn, aux=aux, collapse=collapse)
    return graph


def bitwise(a, b):
    """Fetched outputs equal bit for bit (a scalar by value: one window's
    comes out an int, a group's as an element of its int32 array)."""
    return len(a) == len(b) and all(
        int(x) == int(y) if np.ndim(x) == 0 else
        (np.shape(x) == np.shape(y) and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for x, y in zip(a, b))


@pytest.mark.parametrize("kernel,aux", ROUTES)
def test_checked_rank_matches_unchecked(small_case, kernel, aux):
    cfg = MicroRankConfig()
    host = host_subset(jax_graph(small_case, aux), kernel)
    dg = device_subset(graph_from_numpy(host, "cpu"), kernel)
    ref = fetch_rank_outputs(rank_window_traced_core(dg, cfg.pagerank, cfg.spectrum, kernel))
    traced = rank_window_checked_traced(dg, cfg.pagerank, cfg.spectrum, kernel)
    ranked = rank_window_checked(dg, cfg.pagerank, cfg.spectrum, kernel)
    assert bitwise(traced, ref) and len(traced) == 5
    assert bitwise(ranked, ref[:3]) and len(ranked) == 3


@pytest.mark.parametrize("kernel,aux", [("coo", "none"), ("dense", "none")])
def test_checked_rank_matches_jax(small_case, kernel, aux):
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.rank_backends.jax_tpu import rank_window_checked_traced as jax_checked

    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    graph = jax_graph(small_case, aux)
    jcfg, cfg = JaxConfig(), MicroRankConfig()
    j = [np.asarray(a) for a in jax_checked(jax.tree.map(jnp.asarray, graph),
                                            jcfg.pagerank, jcfg.spectrum, kernel)]
    dg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    t = rank_window_checked_traced(dg, cfg.pagerank, cfg.spectrum, kernel)
    n = t[2]
    assert n == int(j[2]) and t[4] == int(j[4])
    ok, why = tie_aware_topk_agreement(list(j[0][:n]), list(j[1][:n]), list(t[0][:n]),
                                       list(t[1][:n]), k=n, rtol=1e-5)
    assert ok, why
    np.testing.assert_allclose(t[3], j[3], rtol=1e-4, atol=1e-6)


def poisoned(graph, field="sr_val"):
    bad = np.asarray(getattr(graph.abnormal, field)).copy()
    bad[0] = np.nan
    return graph._replace(abnormal=graph.abnormal._replace(**{field: bad}))


@pytest.mark.parametrize("kernel,aux,field", [("coo", "none", "sr_val"),
                                              ("dense", "none", "sr_val"),
                                              ("csr", "csr", "sr_val_opmajor")])
def test_checked_rank_traps_nonfinite_like_jax(small_case, kernel, aux, field):
    # tests/test_sanitizers.py's case: one incidence value poisoned, so
    # NaN flows into the ranking; the in-program check names it.
    import jax
    import jax.numpy as jnp
    from jax.experimental import checkify
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.rank_backends.jax_tpu import rank_window_checked as jax_checked

    graph = poisoned(jax_graph(small_case, aux), field)
    jcfg, cfg = JaxConfig(), MicroRankConfig()
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite") as jerr:
        jax_checked(jax.tree.map(jnp.asarray, graph), jcfg.pagerank, jcfg.spectrum, kernel)
    dg = device_subset(graph_from_numpy(host_subset(graph, kernel), "cpu"), kernel)
    with pytest.raises(DeviceCheckError, match="non-finite") as terr:
        rank_window_checked(dg, cfg.pagerank, cfg.spectrum, kernel)
    assert str(terr.value) in str(jerr.value)
    assert isinstance(terr.value, RuntimeError)
    with pytest.raises(DeviceCheckError, match="non-finite ranked score"):
        rank_window_checked_traced(dg, cfg.pagerank, cfg.spectrum, kernel)
    # Unchecked, the same window ranks to non-finite scores silently.
    out = fetch_rank_outputs(rank_window_traced_core(dg, cfg.pagerank, cfg.spectrum, kernel))
    assert not np.isfinite(out[1][: out[2]]).all()


def test_check_word_bits():
    scores = torch.tensor([[3.0, 2.0, float("nan"), float("-inf")],
                           [3.0, float("inf"), 1.0, 0.5],
                           [1.0, 1.0, 1.0, 1.0]])
    n_valid = torch.tensor([2, 2, 5], dtype=torch.int32)
    word = check_word_plain(scores, n_valid)
    # Row 0: the NaN is past n_valid; row 1: inf is live; row 2: n_valid
    # past k (and every score live and finite).
    assert word.tolist() == [0, CHECK_NONFINITE_SCORE, CHECK_N_VALID]
    assert check_word_plain(scores[0], torch.tensor(3, dtype=torch.int32)).item() == 1
    assert check_word_plain(scores[2], torch.tensor(-1, dtype=torch.int32)).item() == 2
    res = torch.zeros(3, 2, 5)
    res[0, 1, 4] = float("nan")  # past n_iters = 4: not live
    res[1, 0, 2] = float("inf")
    n_iters = torch.tensor([4, 3, 5], dtype=torch.int32)
    word = check_word_plain(scores, n_valid, res, n_iters)
    assert word.tolist() == [0, CHECK_NONFINITE_SCORE | CHECK_NONFINITE_RESIDUAL, CHECK_N_VALID]
    assert [bit for bit, _ in CHECK_MESSAGES] == [1, 2, 4]


def test_fetch_raises_the_first_failed_check_in_jax_order():
    outs = (torch.zeros(3, dtype=torch.int32), torch.zeros(3), torch.tensor(2, dtype=torch.int32),
            torch.zeros(2, 4), torch.tensor(4, dtype=torch.int32))
    for word, message in ((0, None), (6, "n_valid outside [0, k]"),
                          (4, "non-finite power-iteration residual"),
                          (7, "non-finite ranked score")):
        packed = pack_rank_outputs(outs + (torch.tensor(word, dtype=torch.int32),),
                                   checked=True)
        if message is None:
            assert bitwise(unpack_rank_outputs(packed), fetch_rank_outputs(outs))
        else:
            with pytest.raises(DeviceCheckError, match=message.replace("[", r"\[")):
                unpack_rank_outputs(packed)


def test_stage_rank_window_checked_raises_at_the_fetch(small_case):
    cfg = MicroRankConfig()
    host = host_subset(poisoned(jax_graph(small_case)), "coo")
    outs, staged = blob.stage_rank_window(host, cfg.pagerank, cfg.spectrum, "coo", "cpu", True,
                                          checked=True, conv_trace=True)
    assert len(outs) == 6 and outs[-1].dtype == torch.int32 and staged is None
    assert outs[-1].item() == CHECK_NONFINITE_SCORE | CHECK_NONFINITE_RESIDUAL
    with pytest.raises(DeviceCheckError, match="non-finite"):
        unpack_rank_outputs(pack_rank_outputs(outs, staged, checked=True))
    short, _ = blob.stage_rank_window(host, cfg.pagerank, cfg.spectrum, "coo", "cpu", True,
                                      checked=True)
    assert len(short) == 4 and short[-1].item() == CHECK_NONFINITE_SCORE


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    from microrank_tpu_torch.testing import SyntheticConfig, generate_case

    case = generate_case(SyntheticConfig(n_operations=30, n_traces=300, n_kinds=24,
                                         child_keep_prob=0.6, seed=5))
    return (case, *case.write_csvs(tmp_path_factory.mktemp("checked")))


def port_config(**runtime):
    return MicroRankConfig(runtime=RuntimeConfig(**runtime), ingest=IngestConfig(enabled=False))


@pytest.mark.parametrize("kernel", ["auto", "coo", "dense"])
def test_pipeline_lane_honors_device_checks(dump, kernel):
    from microrank_tpu.config import IngestConfig as JaxIngest
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import RuntimeConfig as JaxRuntime
    from microrank_tpu.pipeline import run_rca_native as jax_run

    from microrank_tpu_torch.pipeline import run_rca_native

    case, normal, abnormal = dump
    base = run_rca_native(normal, abnormal, port_config(kernel=kernel), device="cpu")
    checked = run_rca_native(normal, abnormal, port_config(kernel=kernel, device_checks=True),
                             device="cpu")
    assert [r.ranking for r in checked] == [r.ranking for r in base]
    assert [r.rank_iterations for r in checked] == [r.rank_iterations for r in base]
    assert any(r.ranking for r in base)
    jres = jax_run(normal, abnormal, JaxConfig(
        runtime=JaxRuntime(kernel=kernel, device_checks=True, tuned_policy="off"),
        ingest=JaxIngest(enabled=False)))
    assert [r.kernel for r in jres] == [r.kernel for r in checked]
    assert [bool(r.ranking) for r in jres] == [bool(r.ranking) for r in checked]
    assert next(r for r in checked if r.ranking).ranking[0][0] == case.fault_pod_op


def warnings_of(caplog, run):
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        run()
    return sorted(r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING)


@pytest.mark.parametrize("mode", ["async", "chunked", "batch"])
def test_device_checks_make_jaxs_decisions_with_jaxs_warnings(dump, caplog, mode):
    from microrank_tpu.config import IngestConfig as JaxIngest
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import RuntimeConfig as JaxRuntime
    from microrank_tpu.native import load_span_table as jax_load
    from microrank_tpu.pipeline import TableRCA as JaxTableRCA

    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA

    _, normal, abnormal = dump
    runtime = dict(device_checks=True, tuned_policy="off")
    if mode == "chunked":
        runtime["dispatch_batch_windows"] = 2
    batch = mode == "batch"
    rca = TableRCA(port_config(**runtime), device="cpu")
    rca.fit_baseline(load_span_table(normal))
    jrca = JaxTableRCA(JaxConfig(runtime=JaxRuntime(**runtime), ingest=JaxIngest(enabled=False)))
    jrca.fit_baseline(jax_load(normal))
    table, jtable = load_span_table(abnormal), jax_load(abnormal)
    ours = warnings_of(caplog, lambda: rca.run(table, batch_windows=batch))
    theirs = warnings_of(caplog, lambda: jrca.run(jtable, batch_windows=batch))
    device_msgs = [m for m in theirs if "device_checks" in m]
    assert device_msgs and [m for m in ours if "device_checks" in m] == device_msgs
    if batch:
        # The stacked program ranks unchecked, so a poisoned window does
        # not raise there; per window it does.
        assert any("without checkify" in m for m in ours)


def test_run_raises_on_a_poisoned_window_in_the_loop(dump, monkeypatch):
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA, table_runner

    _, normal, abnormal = dump
    real = table_runner.host_subset

    def poison(graph, kernel):
        return real(poisoned(graph), kernel)

    monkeypatch.setattr(table_runner, "host_subset", poison)
    rca = TableRCA(port_config(kernel="coo", device_checks=True), device="cpu")
    rca.fit_baseline(load_span_table(normal))
    with pytest.raises(DeviceCheckError, match="non-finite"):
        rca.run(load_span_table(abnormal))


def test_cli_run_device_checks(dump, tmp_path):
    from microrank_tpu_torch import cli

    _, normal, abnormal = dump
    outs = []
    for extra in ([], ["--device-checks"]):
        out = tmp_path / ("checked" if extra else "plain")
        assert cli.main(["run", "--normal", str(normal), "--abnormal", str(abnormal),
                         "-o", str(out), "--device", "cpu", "--kernel", "coo",
                         "--no-tuned-policy", *extra]) == 0
        outs.append((out / "result.csv").read_text())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------- the card


class Part(NamedTuple):
    """The fields of a partition the epilogue reads."""

    op_present: torch.Tensor
    cov_unique: torch.Tensor
    n_traces: torch.Tensor
    n_ops: torch.Tensor


def card_inputs(rng, v, windows, nan_ops=0):
    lead = () if windows is None else (windows,)
    parts = []
    for n_traces in (4000, 2500):
        present = rng.random(lead + (v,)) < 0.7
        cov = np.where(present, rng.integers(1, n_traces, lead + (v,)), 0).astype(np.int32)
        parts.append(Part(torch.from_numpy(present), torch.from_numpy(cov),
                          torch.from_numpy(np.full(lead, n_traces, np.int32)),
                          torch.from_numpy(np.asarray(present.sum(-1), np.int32))))
    svs = [torch.from_numpy(np.where(p.op_present.numpy(), rng.random(lead + (v,)), 0)
                            .astype(np.float32)) for p in parts]
    if nan_ops:
        svs[1].reshape(-1, v)[:, :nan_ops] = float("nan")
    return parts, svs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the epilogue is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v,first", [(300, False), (9000, False), (300, True), (70_000, False)])
@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("poison", ["none", "scores", "residuals", "both"])
def test_check_word_is_bitwise_its_plain_version(cuda_device, v, first, windows, poison):
    rng = np.random.default_rng(v + (windows or 1))
    parts, svs = card_inputs(rng, v, windows, nan_ops=5 if poison in ("scores", "both") else 0)
    lead = () if windows is None else (windows,)
    residuals = torch.from_numpy(rng.random(lead + (2, 25)).astype(np.float32))
    n_iters = torch.from_numpy(np.full(lead, 20, np.int32))
    residuals[..., 22] = float("nan")  # past n_iters: never flagged
    if poison in ("residuals", "both"):
        residuals.reshape(-1, 2, 25)[-1, 1, 7] = float("inf")
    cfg = SpectrumConfig()
    dp = [Part(*(t.to(cuda_device) for t in p)) for p in parts]
    dsv = [s.to(cuda_device) for s in svs]
    want, want_word = epilogue.rank_epilogue_checked(*parts, *svs, cfg, residuals, n_iters)
    assert want_word.tolist() == check_word_plain(want.top_scores, want.n_valid, residuals,
                                                  n_iters).tolist()
    before = epilogue.rank_epilogue.launches
    got, word = epilogue.rank_epilogue_checked(*dp, *dsv, cfg, residuals.to(cuda_device),
                                               n_iters.to(cuda_device), first_design=first)
    ranked, ranked_word = epilogue.rank_epilogue_checked(*dp, *dsv, cfg, first_design=first)
    unchecked = epilogue.rank_epilogue(*dp, *dsv, cfg, first_design=first)
    torch.cuda.synchronize()
    assert epilogue.rank_epilogue.launches - before == 3
    assert word.dtype == torch.int32 and word.shape == lead
    assert torch.equal(word.cpu(), want_word)
    assert torch.equal(ranked_word.cpu(), check_word_plain(want.top_scores, want.n_valid))
    for a, b, c in zip(got, unchecked, ranked):
        if a.dtype == torch.float32:
            a, b, c = a.view(torch.int32), b.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, b) and torch.equal(a, c)
