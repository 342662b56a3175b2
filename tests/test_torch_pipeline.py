"""The port's native lane end to end against the JAX package's:
``run_rca_native`` of both packages on the same CSVs (the otel_demo
fixture and a small synthetic case from the port's generator), with
``kernel="pallas"``, ingest admission off in both packages and, on the
JAX side, the tuned policy off (the port has none yet); admission itself
is held to JAX in tests/test_torch_admission.py. Same windows, anomaly
flags and
partition sizes; rankings tie-aware equal with scores within rtol 1e-5.
Below the end-to-end check, each host seam is held to its JAX twin
exactly: the span tables, the SLO baseline, detection and the C++ graph
build.
"""

import csv
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu.config import (
    IngestConfig,
    MicroRankConfig as JaxConfig,
    RuntimeConfig as JaxRuntime,
)
from microrank_tpu.graph import table_ops as jax_table_ops
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.pipeline.table_runner import run_rca_native as jax_run
from microrank_tpu.testing import SyntheticConfig as JaxSynthetic
from microrank_tpu.testing import generate_case as jax_generate_case
from microrank_tpu_torch.config import DetectorConfig, MicroRankConfig, RuntimeConfig
from microrank_tpu_torch.config import IngestConfig as PortIngest
from microrank_tpu_torch.graph import table_ops
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.pipeline import run_rca_native
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

OTEL = Path(__file__).parent / "data" / "otel_demo"
SYNTH = dict(n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5)


def port_config(pagerank=None, **runtime):
    """The port's config with admission off, like the JAX side's."""
    kw = {} if pagerank is None else {"pagerank": pagerank}
    return MicroRankConfig(
        runtime=RuntimeConfig(**runtime), ingest=PortIngest(enabled=False), **kw
    )


def jax_config(collapse):
    return JaxConfig(
        runtime=JaxRuntime(
            kernel="pallas", collapse_kinds=collapse, tuned_policy="off"
        ),
        ingest=IngestConfig(enabled=False),
    )


@pytest.fixture(scope="module")
def synth_csvs(tmp_path_factory):
    case = generate_case(SyntheticConfig(**SYNTH))
    normal, abnormal = case.write_csvs(tmp_path_factory.mktemp("synth"))
    return case, normal, abnormal


def assert_same_run(jres, tres):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert (j.start, j.end, j.anomaly, j.skipped_reason) == (
            t.start, t.end, t.anomaly, t.skipped_reason
        )
        assert (j.n_traces, j.n_normal, j.n_abnormal) == (
            t.n_traces, t.n_normal, t.n_abnormal
        )
        assert j.rank_iterations == t.rank_iterations
        assert j.kind_dedup == pytest.approx(t.kind_dedup)
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=1e-5,
        )
        assert ok, f"{t.start}: {why}"


def read_result_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_otel_fixture_matches_jax_lane(collapse, tmp_path):
    normal, abnormal = OTEL / "normal.csv", OTEL / "abnormal.csv"
    jres = jax_run(normal, abnormal, jax_config(collapse), out_dir=tmp_path / "jax")
    tres = run_rca_native(
        normal, abnormal,
        port_config(kernel="pallas", collapse_kinds=collapse),
        out_dir=tmp_path / "torch", device="cpu",
    )
    assert any(r.ranking for r in tres)
    assert_same_run(jres, tres)
    jcsv = read_result_csv(tmp_path / "jax" / "result.csv")
    tcsv = read_result_csv(tmp_path / "torch" / "result.csv")
    assert [list(r) for r in tcsv[:1]] == [list(r) for r in jcsv[:1]]
    assert len(jcsv) == len(tcsv)
    for jr, tr in zip(jcsv, tcsv):
        assert (jr["level"], jr["rank"], jr["window_start"]) == (
            tr["level"], tr["rank"], tr["window_start"]
        )
        assert float(tr["confidence"]) == pytest.approx(float(jr["confidence"]), rel=1e-5)


def test_synthetic_case_matches_jax_lane(synth_csvs):
    case, normal, abnormal = synth_csvs
    jres = jax_run(normal, abnormal, jax_config("auto"))
    tres = run_rca_native(
        normal, abnormal, port_config(kernel="pallas"),
        device="cpu",
    )
    assert_same_run(jres, tres)
    ranked = [r for r in tres if r.ranking]
    assert ranked and ranked[0].ranking[0][0] == case.fault_pod_op


def test_generator_matches_jax_generator(tmp_path):
    # The same config and seed: the port's CSV through the port's loader
    # gives the same SpanTable as JAX's frame through JAX's loader.
    for kw in (SYNTH, dict(n_operations=16, n_pods=2, n_traces=160, seed=11)):
        jcase = jax_generate_case(JaxSynthetic(**kw))
        tcase = generate_case(SyntheticConfig(**kw))
        assert tcase.fault_pod_op == jcase.fault_pod_op
        tnormal, tabnormal = tcase.write_csvs(tmp_path / "t")
        for frame, tpath in ((jcase.normal, tnormal), (jcase.abnormal, tabnormal)):
            jpath = tmp_path / f"j_{tpath.name}"
            frame.to_csv(jpath, index=False)
            a, b = jax_load(jpath, cache=False), load_span_table(tpath, cache=False)
            for f in a._fields:
                va, vb = getattr(a, f), getattr(b, f)
                if isinstance(va, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=f)
                else:
                    assert va == vb, f


def test_sidecar_cache_round_trip(synth_csvs, tmp_path):
    _, normal, _ = synth_csvs
    src = tmp_path / "n.csv"
    src.write_bytes(Path(normal).read_bytes())
    first = load_span_table(src)
    assert list(tmp_path.glob("n.csv.mrt-torch-*.npz"))
    again = load_span_table(src)
    for f in first._fields:
        va, vb = getattr(first, f), getattr(again, f)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f


@pytest.mark.parametrize("stat", ["mean", "p90"])
def test_slo_and_detection_match_jax(synth_csvs, stat):
    _, normal, abnormal = synth_csvs
    jn, ja = jax_load(normal, cache=False), jax_load(abnormal, cache=False)
    tn, ta = load_span_table(normal, cache=False), load_span_table(abnormal, cache=False)
    jv, jb = jax_table_ops.compute_slo_from_table(jn, stat)
    tv, tb = table_ops.compute_slo_from_table(tn, stat)
    assert jv.names == tv.names
    np.testing.assert_array_equal(jb.mean_ms, tb.mean_ms)
    np.testing.assert_array_equal(jb.std_ms, tb.std_ms)

    from microrank_tpu.config import DetectorConfig as JaxDetector

    w0 = int(ta.start_us.min())
    w1 = w0 + 300_000_000
    jout = jax_table_ops.detect_window_partition(
        ja, w0, w1, jv, jb, JaxDetector(), with_range=True
    )
    tout = table_ops.detect_window_partition(
        ta, w0, w1, tv, tb, DetectorConfig(), with_range=True
    )
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_detect_numpy_matches_jax():
    from microrank_tpu.config import DetectorConfig as JaxDetector
    from microrank_tpu.detect.detector import detect_numpy as jax_detect
    from microrank_tpu.graph.structures import DetectBatch as JaxBatch
    from microrank_tpu.graph.structures import SloBaseline as JaxBaseline
    from microrank_tpu_torch.detect import detect_numpy
    from microrank_tpu_torch.graph.structures import DetectBatch, SloBaseline

    rng = np.random.default_rng(1)
    s, n_tr, n_ops = 500, 60, 12
    arrays = (
        np.where(rng.random(s) < 0.1, -1, rng.integers(0, n_ops, s)).astype(np.int32),
        rng.integers(0, n_tr, s).astype(np.int32),
        rng.uniform(0, 5e4, s).astype(np.float32),
        np.int32(s - 20),
        np.int32(n_tr),
    )
    base = (rng.uniform(1, 20, n_ops).astype(np.float32),
            rng.uniform(0, 3, n_ops).astype(np.float32))
    j = jax_detect(JaxBatch(*arrays), JaxBaseline(*base), JaxDetector(k_sigma=1.0))
    t = detect_numpy(DetectBatch(*arrays), SloBaseline(*base), DetectorConfig(k_sigma=1.0))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def assert_same_build(synth_csvs, aux, collapse, **kw):
    """The port's native build and JAX's, field by field, array-equal."""
    _, normal, abnormal = synth_csvs
    tab = load_span_table(abnormal, cache=False)
    jtab = jax_load(abnormal, cache=False)
    tv, tb = table_ops.compute_slo_from_table(load_span_table(normal, cache=False))
    w0 = int(tab.start_us.min())
    mask, nrm, abn, _, rng = table_ops.detect_window_partition(
        tab, w0, w0 + 300_000_000, tv, tb, DetectorConfig(), with_range=True
    )
    tg, tnames, tn, ta = table_ops.build_window_graph_from_table(
        tab, mask, nrm, abn, aux=aux, collapse=collapse, row_range=rng, **kw
    )
    jg, jnames, jn, ja = jax_table_ops.build_window_graph_from_table(
        jtab, mask, nrm, abn, aux=aux, collapse=collapse, row_range=rng, **kw
    )
    assert tnames == jnames
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ta, ja)
    for part in ("normal", "abnormal"):
        jp, tp = getattr(jg, part), getattr(tg, part)
        for f in jp._fields:
            a, b = np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    return tg


@pytest.mark.parametrize("collapse", ["off", "auto", "on"])
def test_native_graph_build_matches_jax(synth_csvs, collapse):
    assert_same_build(synth_csvs, "none", collapse)


@pytest.mark.parametrize("aux,collapse,views", [
    ("packed", "off", "bits"),
    ("packed", "on", "bits"),
    ("kind", "on", "kind"),
    ("kind", "off", "kind"),
    ("auto", "off", "bits"),
    ("auto", "auto", "kind"),
    ("auto", "on", "kind"),
])
def test_native_graph_build_views_match_jax(synth_csvs, aux, collapse, views):
    # The bitmaps (cov_bits, ss_bits) and kind views (cov_i8, ss_indptr)
    # too; "auto" resolves to kind on a collapsed window past the dedup
    # threshold.
    tg = assert_same_build(synth_csvs, aux, collapse)
    for p in (tg.normal, tg.abnormal):
        assert p.cov_bits.shape[1] > 0 and p.ss_bits.shape[1] > 0
        assert (p.cov_i8.shape[-1] > 0) == (views == "kind")
        assert (p.ss_indptr.shape[0] > 0) == (views == "kind")


def test_native_build_threshold_matches_jax(synth_csvs):
    # Past the measured dedup factor the collapsed auto build keeps
    # bitmaps only, in both packages.
    tg = assert_same_build(synth_csvs, "auto", "auto", kind_dedup_threshold=1e9)
    assert tg.normal.cov_i8.shape[-1] == 0 and tg.normal.cov_bits.shape[1] > 0


def test_unported_aux_modes_raise(synth_csvs):
    # The CSR views are not ported and raise; the partition-centric ones
    # come out as JAX's.
    _, _, abnormal = synth_csvs
    tab = load_span_table(abnormal, cache=False)
    for aux in ("csr", "all"):
        with pytest.raises(NotImplementedError, match="aux mode"):
            table_ops.build_window_graph_from_table(tab, None, [0], [1], aux=aux)
    tg = assert_same_build(synth_csvs, "pcsr", "off")
    assert all(p.pc_trace.shape[-1] > 0 for p in (tg.normal, tg.abnormal))


def auto_config(collapse, **runtime):
    return (
        JaxConfig(
            runtime=JaxRuntime(
                kernel="auto", collapse_kinds=collapse, tuned_policy="off", **runtime
            ),
            ingest=IngestConfig(enabled=False),
        ),
        port_config(collapse_kinds=collapse, **runtime),
    )


def assert_same_auto_run(jres, tres, bf16=False):
    """Same windows and resolved kernels; rankings tie-aware equal at the
    resolved kernel's tolerance (f32 1e-5, bf16 5e-3)."""
    assert [r.kernel for r in jres] == [r.kernel for r in tres]
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert (j.start, j.anomaly, j.n_normal, j.n_abnormal, j.rank_iterations) == (
            t.start, t.anomaly, t.n_normal, t.n_abnormal, t.rank_iterations
        )
        rtol = 5e-3 if bf16 or t.kernel == "packed_bf16" else 1e-5
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=rtol,
        )
        assert ok, f"{t.start}: {why}"
        if j.ranking:
            assert j.ranking[0][0] == t.ranking[0][0]


@pytest.mark.parametrize("collapse,kernel", [("auto", "kind"), ("off", "packed_bf16")])
def test_auto_lane_matches_jax_on_synthetic_case(synth_csvs, collapse, kernel):
    case, normal, abnormal = synth_csvs
    jcfg, tcfg = auto_config(collapse)
    assert tcfg.runtime.kernel == "auto"
    jres = jax_run(normal, abnormal, jcfg)
    tres = run_rca_native(normal, abnormal, device="cpu", config=tcfg)
    ranked = [r for r in tres if r.ranking]
    assert ranked and {r.kernel for r in ranked} == {kernel}
    assert ranked[0].ranking[0][0] == case.fault_pod_op
    assert_same_auto_run(jres, tres)


@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_auto_lane_matches_jax_on_otel_fixture(collapse):
    normal, abnormal = OTEL / "normal.csv", OTEL / "abnormal.csv"
    jcfg, tcfg = auto_config(collapse)
    tres = run_rca_native(normal, abnormal, tcfg, device="cpu")
    assert any(r.ranking for r in tres)
    assert_same_auto_run(jax_run(normal, abnormal, jcfg), tres)


def test_dedup_threshold_turns_kind_into_packed_bf16_like_jax(synth_csvs):
    # The threshold reaches the build: above the measured dedup factor
    # the window ranks with packed_bf16, below it with kind.
    _, normal, abnormal = synth_csvs
    for threshold, kernel in ((1e9, "packed_bf16"), (1.5, "kind")):
        jcfg, tcfg = auto_config("auto", kind_dedup_threshold=threshold)
        tres = run_rca_native(normal, abnormal, tcfg, device="cpu")
        ranked = [r for r in tres if r.ranking]
        assert ranked and all(r.kernel == kernel for r in ranked)
        assert all(r.kind_dedup > 1.5 for r in ranked)
        assert_same_auto_run(jax_run(normal, abnormal, jcfg), tres)


@pytest.mark.parametrize("kernel,precision", [("kind", "f32"), ("kind", "bf16"), ("packed", "f32")])
def test_forced_kernels_match_jax_lane(synth_csvs, kernel, precision):
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu_torch.config import PageRankConfig

    _, normal, abnormal = synth_csvs
    jres = jax_run(normal, abnormal, JaxConfig(
        pagerank=JaxPageRank(kind_precision=precision),
        runtime=JaxRuntime(kernel=kernel, collapse_kinds="auto", tuned_policy="off"),
        ingest=IngestConfig(enabled=False),
    ))
    tres = run_rca_native(normal, abnormal, port_config(
        pagerank=PageRankConfig(kind_precision=precision),
        kernel=kernel, collapse_kinds="auto",
    ), device="cpu")
    assert {r.kernel for r in tres if r.ranking} == {kernel}
    assert_same_auto_run(jres, tres, bf16=precision == "bf16")


def test_cli_synth_then_run_on_cpu(tmp_path):
    import json

    from microrank_tpu_torch import cli

    case_dir, out = tmp_path / "case", tmp_path / "out"
    assert cli.main(["synth", "-o", str(case_dir), "--operations", "30",
                     "--traces", "300", "--seed", "3"]) == 0
    truth = json.loads((case_dir / "ground_truth.json").read_text())
    assert cli.main(["run", "--normal", str(case_dir / "normal.csv"),
                     "--abnormal", str(case_dir / "abnormal.csv"),
                     "-o", str(out), "--device", "cpu"]) == 0
    rows = read_result_csv(out / "result.csv")
    assert rows[0]["rank"] == "1" and rows[0]["result"] == truth["fault_pod_op"]
    assert (out / "windows.jsonl").read_text().count("\n") >= 1
    # The kernel flags reach the config.
    args = cli.build_parser().parse_args([
        "run", "--normal", "n", "--abnormal", "a", "--kernel", "kind",
        "--kind-precision", "bf16",
    ])
    cfg = cli._config_from_args(args)
    assert (cfg.runtime.kernel, cfg.pagerank.kind_precision) == ("kind", "bf16")
    assert cli._config_from_args(
        cli.build_parser().parse_args(["run", "--normal", "n", "--abnormal", "a"])
    ).runtime.kernel == "auto"
