"""Ingest admission (``microrank_tpu_torch.ingest.admit_table``) held to
the JAX package's ``admit_table`` on the same tables: the same rows
kept, the same per-reason counts, the same parent stitch; and the
native lane with admission on in both packages on ROADMAP's reproducer
(one negative-duration span on the faulted operation), which gives the
same SLOs, detection and ranking."""

import numpy as np
import pytest

from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.ingest import QuarantineStore
from microrank_tpu.ingest import admit_table as jax_admit
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.pipeline.table_runner import TableRCA as JaxTableRCA
from microrank_tpu.pipeline.table_runner import run_rca_native as jax_run
from microrank_tpu_torch.config import IngestConfig, MicroRankConfig, RuntimeConfig
from microrank_tpu_torch.ingest import admit_table
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.pipeline import TableRCA, run_rca_native
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

SYNTH = dict(n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5)


def poisoned_csvs(out_dir):
    """The synthetic case with one span of the faulted operation in the
    normal dump given a negative duration (ROADMAP's reproducer), and
    the same in the abnormal dump. Returns (case, normal, abnormal)."""
    case = generate_case(SyntheticConfig(**SYNTH))
    fault = case.fault_op
    for spans in (case.normal, case.abnormal):
        row = int(np.flatnonzero(spans["op"] == fault)[0])
        spans["duration_us"] = spans["duration_us"].copy()
        spans["duration_us"][row] = -5_000_000_000
    normal, abnormal = case.write_csvs(out_dir)
    return case, normal, abnormal


def assert_same_tables(a, b):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    return poisoned_csvs(tmp_path_factory.mktemp("poisoned"))


def hostile_table(table, rng):
    """A copy of ``table`` with every kind of row admission rejects: a
    negative duration, an end before the start, a duration past the
    maximum, and parents pointing at rejected rows."""
    dur = table.duration_us.copy()
    start, end = table.start_us.copy(), table.end_us.copy()
    # Rows that are parents first, so that rejecting them orphans spans.
    parents = np.unique(table.parent_row[table.parent_row >= 0])
    rows = rng.choice(parents, 12, replace=False)
    dur[rows[:4]] = -rng.integers(1, 10**6, 4)
    end[rows[4:8]] = start[rows[4:8]] - 1
    dur[rows[8:]] = 3_600_000_001 + rng.integers(0, 10, 4)
    return table._replace(duration_us=dur, start_us=start, end_us=end)


@pytest.mark.parametrize("max_spans_per_trace", [4096, 5, 1])
def test_admit_table_matches_jax(poisoned, max_spans_per_trace):
    _, _, abnormal = poisoned
    rng = np.random.default_rng(max_spans_per_trace)
    table = hostile_table(load_span_table(abnormal, cache=False), rng)
    jtable = hostile_table(jax_load(abnormal, cache=False), np.random.default_rng(max_spans_per_trace))
    assert_same_tables(table, jtable)
    cfg = IngestConfig(max_spans_per_trace=max_spans_per_trace)
    jcfg = JaxIngest(max_spans_per_trace=max_spans_per_trace)
    clean, counts = admit_table(table, cfg)
    jclean, jcounts = jax_admit(jtable, jcfg, quarantine=QuarantineStore(None))
    assert counts == jcounts
    assert counts["bad_duration"] >= 4 and counts["bad_timestamp"] >= 4
    assert counts["duration_overflow"] == 4
    assert ("trace_too_long" in counts) == (max_spans_per_trace < 4096)
    assert_same_tables(clean, jclean)
    assert clean.n_spans == table.n_spans - sum(counts.values())
    # The stitch: a kept span keeps its parent's new row when the parent
    # was kept, and becomes a root when it was rejected.
    kept = clean.parent_row >= 0
    assert np.all(clean.trace_id[clean.parent_row[kept]] == clean.trace_id[kept])
    if max_spans_per_trace == 4096:
        dur = table.duration_us
        keep = ~((dur < 0) | (dur > 3_600_000_000) | (table.end_us < table.start_us))
        new_pos = np.cumsum(keep) - 1
        child = np.flatnonzero(keep & (table.parent_row >= 0))
        parent = table.parent_row[child]
        orphaned = ~keep[parent]
        assert orphaned.any()
        np.testing.assert_array_equal(clean.parent_row[new_pos[child[orphaned]]], -1)
        np.testing.assert_array_equal(
            clean.parent_row[new_pos[child[~orphaned]]], new_pos[parent[~orphaned]]
        )


def test_admit_table_passes_clean_tables_and_honours_enabled(poisoned):
    _, normal, _ = poisoned
    table = load_span_table(normal, cache=False)
    assert admit_table(table, IngestConfig(enabled=False)) == (table, {})
    clean, counts = admit_table(table, IngestConfig())
    assert counts == {"bad_duration": 1}
    again, none = admit_table(clean, IngestConfig())
    assert again is clean and none == {}


def test_reproducer_slos_match_jax_with_admission_on(poisoned):
    _, normal, _ = poisoned
    port = TableRCA(MicroRankConfig(), device="cpu")
    port.fit_baseline(load_span_table(normal, cache=False))
    jax_rca = JaxTableRCA(JaxConfig(runtime=JaxRuntime(tuned_policy="off")))
    jax_rca.fit_baseline(jax_load(normal, cache=False))
    assert port.slo_vocab.names == jax_rca.slo_vocab.names
    np.testing.assert_array_equal(port.baseline.mean_ms, jax_rca.baseline.mean_ms)
    np.testing.assert_array_equal(port.baseline.std_ms, jax_rca.baseline.std_ms)
    # Without admission the poisoned row moves the fault's SLO.
    raw = TableRCA(MicroRankConfig(ingest=IngestConfig(enabled=False)), device="cpu")
    raw.fit_baseline(load_span_table(normal, cache=False))
    assert not np.array_equal(raw.baseline.mean_ms, port.baseline.mean_ms)


@pytest.mark.parametrize("kernel", ["pallas", "auto"])
def test_reproducer_run_matches_jax_with_admission_on(poisoned, kernel):
    case, normal, abnormal = poisoned
    jres = jax_run(normal, abnormal, JaxConfig(
        runtime=JaxRuntime(kernel=kernel, tuned_policy="off"),
    ))
    tres = run_rca_native(
        normal, abnormal, MicroRankConfig(runtime=RuntimeConfig(kernel=kernel)), device="cpu"
    )
    assert len(jres) == len(tres)
    ranked = [r for r in tres if r.ranking]
    assert ranked and ranked[0].ranking[0][0] == case.fault_pod_op
    for j, t in zip(jres, tres):
        assert (j.start, j.anomaly, j.n_normal, j.n_abnormal, j.kernel, j.rank_iterations) == (
            t.start, t.anomaly, t.n_normal, t.n_abnormal, t.kernel, t.rank_iterations
        )
        rtol = 5e-3 if t.kernel == "packed_bf16" else 1e-5
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=rtol,
        )
        assert ok, f"{t.start}: {why}"
