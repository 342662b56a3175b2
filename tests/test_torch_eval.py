"""The accuracy harness (``microrank_tpu_torch.evaluation``, ``cli
eval``) held to the JAX package's on the CPU.

The port runs each case through the table lane (the C++ loader,
detector and build, the staged program with the kernels' plain
versions); JAX's harness runs its pandas lane. On the same seeds:

* ``evaluate`` (6 cases), ``evaluate_all_methods`` (6 cases, every
  formula), ``evaluate_overlap_ablation`` (2 cases an overlap, five
  overlaps) and ``evaluate_detection`` (6 timelines of 4 windows): every
  ``CaseResult`` equal (seed, faults, ranks, ``n_ranked_ops``,
  detected), ``recall_at`` and the detection rate exactly, both Exam
  Scores to 1e-12, the detection counts equal, and the summary lines;
* the generator's spans with the fault-placement control
  (``fault_path_overlap`` None, 0, 0.5, 1; 2 and 3 faults): the port's
  CSV byte for byte the JAX frame's ``to_csv``, the same faults and
  achieved overlap, also through the 512-candidate pool;
* ``cli eval`` (default, ``--all-methods``, ``--detection``,
  ``--overlap-ablation``, each with ``--json``) with ``--device cpu``:
  the JAX CLI's lines and JSON;
* the tie-aware ranking helpers (JAX's ``tie_aware_ranks`` and the
  scores over it) give JAX's values on ties, near-ties and chains;
* the numpy_ref backend raises, naming the port queue's item 9.
"""

import dataclasses
import json

import numpy as np
import pytest

from microrank_tpu import evaluation as jax_eval
from microrank_tpu.cli.main import main as jax_main
from microrank_tpu.testing import SyntheticConfig as JaxSynthetic
from microrank_tpu.testing import generate_case as jax_generate_case
from microrank_tpu.testing import generate_timeline as jax_generate_timeline
from microrank_tpu_torch import cli, evaluation
from microrank_tpu_torch.config import MicroRankConfig, RuntimeConfig
from microrank_tpu_torch.spectrum.formulas import METHODS
from microrank_tpu_torch.testing import SyntheticConfig, generate_case, generate_timeline
from microrank_tpu_torch.testing.synthetic import write_spans_csv

# JAX's CLI defaults (cmd_eval): 30 ops, 400 traces, 48 kinds, keep 0.15.
SIZE = dict(n_traces=400, n_kinds=48, child_keep_prob=0.15)


def assert_reports_equal(j, t):
    assert [dataclasses.asdict(c) for c in t.cases] == [dataclasses.asdict(c) for c in j.cases]
    assert t.recall_at == j.recall_at
    assert t.detection_rate == j.detection_rate
    assert abs(t.exam_score - j.exam_score) <= 1e-12
    assert abs(t.exam_score_paper - j.exam_score_paper) <= 1e-12
    assert t.summary() == j.summary()


@pytest.fixture(scope="module")
def six():
    return dict(n_cases=6, **SIZE)


def test_evaluate_matches_jax(six):
    j = jax_eval.evaluate(eval_cfg=jax_eval.EvalConfig(**six))
    t = evaluation.evaluate(eval_cfg=evaluation.EvalConfig(**six), device="cpu")
    assert_reports_equal(j, t)
    assert len(t.cases) == 6 and all(c.detected for c in t.cases)


def test_evaluate_records_each_case_by_stage(six):
    timings = []
    evaluation.evaluate(eval_cfg=evaluation.EvalConfig(**dict(six, n_cases=2)), device="cpu",
                        timings=timings)
    assert [t["seed"] for t in timings] == [1000, 1001]
    for t in timings:
        assert set(t) == {"seed", "generate_s", "load_s", "detect_s", "build_s", "rank_s",
                          "kernel"}
        assert t["kernel"] in ("kind", "packed_bf16")
        assert all(v >= 0 for k, v in t.items() if k.endswith("_s"))


def test_evaluate_all_methods_matches_jax(six):
    j = jax_eval.evaluate_all_methods(eval_cfg=jax_eval.EvalConfig(**six))
    t = evaluation.evaluate_all_methods(eval_cfg=evaluation.EvalConfig(**six), device="cpu")
    assert list(t) == list(j) == list(METHODS)
    for m in METHODS:
        assert_reports_equal(j[m], t[m])


def test_each_formula_ranks_as_evaluate_does(six):
    """evaluate_all_methods' row of a formula is evaluate with that
    formula (one program for all of them, the same rankings)."""
    ecfg = evaluation.EvalConfig(**dict(six, n_cases=3))
    every = evaluation.evaluate_all_methods(eval_cfg=ecfg, device="cpu")
    for m in ("ochiai", "tarantula"):
        cfg = MicroRankConfig()
        cfg = cfg.replace(spectrum=dataclasses.replace(cfg.spectrum, method=m))
        one = evaluation.evaluate(cfg, ecfg, device="cpu")
        assert [dataclasses.asdict(c) for c in one.cases] == [
            dataclasses.asdict(c) for c in every[m].cases]


def test_evaluate_overlap_ablation_matches_jax():
    ecfg = dict(n_cases=2, n_faults=2, **SIZE)
    j = jax_eval.evaluate_overlap_ablation(eval_cfg=jax_eval.EvalConfig(**ecfg))
    t = evaluation.evaluate_overlap_ablation(eval_cfg=evaluation.EvalConfig(**ecfg),
                                             device="cpu")
    assert list(t) == list(j) == [0.0, 0.25, 0.5, 0.75, 1.0]
    for ov in t:
        assert_reports_equal(j[ov], t[ov])
        assert all(len(c.faults) == 2 for c in t[ov].cases)


def test_evaluate_detection_matches_jax(six):
    j = jax_eval.evaluate_detection(eval_cfg=jax_eval.EvalConfig(**six), n_windows=4)
    t = evaluation.evaluate_detection(eval_cfg=evaluation.EvalConfig(**six), n_windows=4,
                                      device="cpu")
    assert (t.tp, t.fp, t.fn, t.tn) == (j.tp, j.fp, j.fn, j.tn)
    assert t.tp + t.fp + t.fn + t.tn == 24
    assert t.summary() == j.summary()


@pytest.mark.parametrize("overlap", [None, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("n_faults", [2, 3])
def test_generator_places_faults_as_jax(tmp_path, overlap, n_faults):
    kw = dict(n_operations=30, n_traces=120, n_kinds=24, child_keep_prob=0.6, seed=21,
              n_faults=n_faults, fault_path_overlap=overlap)
    jcase = jax_generate_case(JaxSynthetic(**kw))
    tcase = generate_case(SyntheticConfig(**kw))
    assert tcase.faults == jcase.faults and len(tcase.faults) == n_faults
    assert tcase.fault_overlap == jcase.fault_overlap
    assert tcase.fault_pod_ops == jcase.fault_pod_ops
    if overlap is not None:
        assert tcase.fault_overlap is not None
    for frame, spans, name in ((jcase.normal, tcase.normal, "normal"),
                               (jcase.abnormal, tcase.abnormal, "abnormal")):
        jpath, tpath = tmp_path / f"j_{name}.csv", tmp_path / f"t_{name}.csv"
        frame.to_csv(jpath, index=False)
        write_spans_csv(spans, tpath, tcase.n_operations)
        assert tpath.read_bytes() == jpath.read_bytes(), name


@pytest.mark.parametrize("overlap", [0.0, 0.5])
def test_fault_pool_past_512_candidates_draws_as_jax(overlap):
    """Past 512 candidates the placement draws a pool of 512 first: the
    same faults as JAX's, and the generator left in JAX's state."""
    from microrank_tpu.testing import synthetic as jax_synthetic
    from microrank_tpu_torch.testing import synthetic

    kw = dict(n_operations=1500, n_kinds=40, child_keep_prob=0.55, seed=3, n_faults=2,
              fault_path_overlap=overlap)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    tj = jax_synthetic._make_topology(JaxSynthetic(**kw), rj)
    tt = synthetic._make_topology(SyntheticConfig(**kw), rt)
    assert len(np.unique(np.concatenate(tt.kinds))) > 513
    assert synthetic._pick_faults(tt, rt, 1, 2, overlap) == jax_synthetic._pick_faults(
        tj, rj, 1, 2, overlap)
    assert rt.random() == rj.random()


def test_timeline_places_faults_as_jax(tmp_path):
    kw = dict(n_operations=30, n_traces=60, seed=4, n_faults=2, fault_path_overlap=0.0)
    jtl = jax_generate_timeline(JaxSynthetic(**kw), 3, [1])
    ttl = generate_timeline(SyntheticConfig(**kw), 3, [1])
    assert ttl.fault_pod_ops == jtl.fault_pod_ops
    jtl.timeline.to_csv(tmp_path / "j.csv", index=False)
    write_spans_csv(ttl.windows, tmp_path / "t.csv", ttl.n_operations)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def nan_free(x):
    """``x`` with every float NaN as the string "nan" (NaN equals nothing)."""
    if isinstance(x, dict):
        return {k: nan_free(v) for k, v in x.items()}
    return "nan" if isinstance(x, float) and x != x else x


@pytest.mark.parametrize("scores", [
    [3.0, 2.0, 1.0, 0.5],
    [1.0, 1.0, 0.99999994, 0.5, 0.5],        # an exact tie, then one within 1e-6
    [2.0, 2.0 * (1 - 9e-7), 2.0 * (1 - 1.8e-6), 1.0],  # a chain of near-ties
    [0.0, 0.0, -1.0],
])
def test_tie_aware_helpers_match_jax(scores):
    names = [f"op{i}" for i in range(len(scores))]
    for truth in (["op1"], ["op0", "op2"], ["op3", "missing"], []):
        for fn in ("tie_aware_ranks", "rank_of_culprit", "topk_exact", "reciprocal_rank",
                   "average_precision", "ranking_metrics"):
            if fn == "tie_aware_ranks":
                args = (names, scores)
            elif fn == "rank_of_culprit":
                args = (names, scores, truth[0] if truth else "op0")
            elif fn == "topk_exact":
                args = (names, scores, truth, 2)
            else:
                args = (names, scores, truth)
            want, got = getattr(jax_eval, fn)(*args), getattr(evaluation, fn)(*args)
            assert nan_free(got) == nan_free(want), (fn, truth)


def test_numpy_ref_backend_is_not_ported():
    cfg = MicroRankConfig(runtime=RuntimeConfig(backend="numpy_ref"))
    ecfg = evaluation.EvalConfig(n_cases=1)
    for fn in (evaluation.evaluate, evaluation.evaluate_all_methods,
               evaluation.evaluate_detection):
        with pytest.raises(NotImplementedError, match="item 9"):
            fn(cfg, ecfg, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        RuntimeConfig(backend="jax")


@pytest.mark.parametrize("mode", [[], ["--all-methods"], ["--detection", "--windows", "4"],
                                  ["--overlap-ablation"]],
                         ids=["default", "all_methods", "detection", "overlap_ablation"])
def test_cli_eval_matches_jax(tmp_path, capsys, mode):
    base = ["eval", "--cases", "2", *mode]
    assert jax_main(base + ["--json", str(tmp_path / "j.json")]) == 0
    j_out = capsys.readouterr().out
    assert cli.main(base + ["--device", "cpu", "--json", str(tmp_path / "t.json")]) == 0
    t_out = capsys.readouterr().out
    assert t_out == j_out and t_out.strip()
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert_json_equal(j, t)


def assert_json_equal(j, t):
    assert type(t) is type(j)
    if isinstance(j, dict):
        assert list(t) == list(j)
        for key in j:
            assert_json_equal(j[key], t[key])
    elif isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(j, t):
            assert_json_equal(a, b)
    elif isinstance(j, float):
        assert np.isclose(t, j, rtol=0, atol=1e-12) or (np.isnan(j) and np.isnan(t))
    else:
        assert t == j
