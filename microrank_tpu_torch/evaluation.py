"""The accuracy harness: R@k and Exam Score over synthetic chaos cases
(counterpart of ``microrank_tpu/evaluation.py``).

The paper's headline numbers are localization accuracy (Tables 4-6):
R@k, the share of injected faults whose root cause ranks in the top k,
and the Exam Score, how far down the ranked list an operator reads.
Each case is generated (``testing.synthetic``, the JAX generator's
draws), run through detection, partitioning and the rank program, and
scored as the JAX harness scores it. Multi-fault cases score each fault
on its own (R@k over faults, not cases).

The JAX harness detects on its pandas lane; this one runs the table
lane, numpy and C++ only: the case's two windows go through the C++
loader (as CSVs, written to a temporary directory), the SLO baseline
from the normal table (``graph.table_ops.compute_slo_from_table``), the
fused C++ detector over the whole abnormal table
(``detect_window_partition``: the flag is ``len(abn) >=
min_abnormal_traces``, with both partitions non-empty and the compat
partition swap, as JAX's ``detect.detect_partition`` sets it), the C++
graph build (``build_window_graph_from_table``), ``choose_kernel`` and
the staged rank program, ranked full depth (``top_max = n_operations *
n_pods``). No admission and no tuned policy: JAX's harness runs
neither. ``evaluate_all_methods`` ranks each case under every formula
in one program (K13, ``torch_cuda.rank_window_all_methods_core``).

Every entry point runs on the card unless ``device="cpu"`` is given (or
``config.runtime.device`` says so), where each kernel's plain version
runs; on the card every kernel launches, with no fallback. The
``numpy_ref`` backend (``rank_backends.NumpyRefBackend``) is not wired
into the harness yet (ROADMAP.md, port queue item 9):
``config.runtime.backend == "numpy_ref"`` raises.
"""

from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import MicroRankConfig
from .graph.build import aux_for_kernel
from .graph.table_ops import (
    build_window_graph_from_table,
    compute_slo_from_table,
    detect_window_partition,
)
from .native import load_span_table
from .rank_backends.blob import stage_rank_window
from .rank_backends.torch_cuda import (
    choose_kernel,
    host_subset,
    pack_rank_outputs,
    unpack_rank_outputs,
)
from .spectrum.formulas import METHODS
from .testing.synthetic import SyntheticConfig, generate_case, generate_timeline
from .utils.device import resolve_device
from .utils.guards import claim_device_owner
from .utils.ranking_compare import scores_tied

log = logging.getLogger("microrank_tpu_torch.evaluation")

# ---------------------------------------------------------------------------
# Tie-aware ranking metrics (JAX's, over the one comparator
# ``utils.ranking_compare.scores_tied``): suspects whose scores agree
# within rounding share the minimum rank of their tie group.

#: Tie tolerance for device-produced score lists: within one fetched
#: ranking only genuine float ties should collapse.
DEFAULT_TIE_RTOL = 1e-6


def tie_aware_ranks(names, scores, rtol: float = DEFAULT_TIE_RTOL) -> Dict[str, int]:
    """1-based tie-aware rank per name over one descending ranked list:
    members of a tie group (scores tied to the group's head within
    ``rtol``, head-anchored so that chained near-ties cannot drift a
    group downhill) all take the group's first position."""
    ranks: Dict[str, int] = {}
    head = None
    group_rank = 1
    for i, (name, score) in enumerate(zip(names, scores)):
        s = float(score)
        if head is None or not scores_tied(s, head, rtol):
            group_rank = i + 1
            head = s
        ranks.setdefault(str(name), group_rank)
    return ranks


def rank_of_culprit(names, scores, culprit: str,
                    rtol: float = DEFAULT_TIE_RTOL) -> Optional[int]:
    """Tie-aware 1-based rank of ``culprit`` (None when unranked)."""
    return tie_aware_ranks(names, scores, rtol).get(str(culprit))


def topk_exact(names, scores, truth, k: int, rtol: float = DEFAULT_TIE_RTOL) -> bool:
    """True when every true culprit sits inside the tie-expanded top-k."""
    truth = [str(t) for t in truth]
    if not truth:
        return False
    ranks = tie_aware_ranks(names, scores, rtol)
    return all(t in ranks and ranks[t] <= k for t in truth)


def reciprocal_rank(names, scores, truth, rtol: float = DEFAULT_TIE_RTOL) -> float:
    """1 / best tie-aware rank over the culprit set (0.0 = none ranked)."""
    ranks = tie_aware_ranks(names, scores, rtol)
    found = [ranks[str(t)] for t in truth if str(t) in ranks]
    return 1.0 / min(found) if found else 0.0


def average_precision(names, scores, truth, rtol: float = DEFAULT_TIE_RTOL) -> float:
    """AP of one ranked list against the culprit set, tie-aware: the i-th
    found culprit (ascending tie-aware rank r_i) contributes i / r_i;
    unranked culprits contribute 0; the mean runs over all culprits."""
    truth = [str(t) for t in truth]
    if not truth:
        return float("nan")
    ranks = tie_aware_ranks(names, scores, rtol)
    found = sorted(ranks[t] for t in truth if t in ranks)
    return sum((i + 1) / r for i, r in enumerate(found)) / len(truth)


def ranking_metrics(names, scores, truth, ks: Tuple[int, ...] = (1, 3, 5),
                    rtol: float = DEFAULT_TIE_RTOL) -> Dict[str, object]:
    """One ranked list's scorecard against the culprit set: AP,
    reciprocal rank, tie-aware rank per culprit, and tie-expanded top-k
    exactness per k."""
    truth = [str(t) for t in truth]
    ranks = tie_aware_ranks(names, scores, rtol)
    return {
        "ap": average_precision(names, scores, truth, rtol),
        "rr": reciprocal_rank(names, scores, truth, rtol),
        "ranks": {t: ranks.get(t) for t in truth},
        "topk_exact": {int(k): topk_exact(names, scores, truth, int(k), rtol) for k in ks},
    }


@dataclass(frozen=True)
class EvalConfig:
    n_cases: int = 20
    n_operations: int = 30
    n_traces: int = 200
    n_pods: int = 1
    n_kinds: int = 24
    child_keep_prob: float = 0.6
    n_faults: int = 1
    fault_latency_ms: float = 2000.0
    # Target root-path overlap between the injected faults (the
    # multi-fault hardness control, ``testing.synthetic.path_overlap``);
    # None = the unconstrained choice.
    fault_path_overlap: Optional[float] = None
    seed0: int = 1000
    # R@k columns (2 for the paper's two-fault R@2, Table 5).
    ks: Tuple[int, ...] = (1, 2, 3, 5)


@dataclass
class CaseResult:
    seed: int
    faults: List[str]
    ranks: List[Optional[int]]  # 1-based rank per fault, None = not ranked
    n_ranked_ops: int
    detected: bool


@dataclass
class EvalReport:
    cases: List[CaseResult] = field(default_factory=list)
    recall_at: Dict[int, float] = field(default_factory=dict)
    # Mean normalized inspection depth, (rank - 1) / candidates.
    exam_score: float = float("nan")
    # The paper's Exam Score (Tables 4-6): the mean unnormalized
    # inspection count, rank - 1. Unranked faults count a full scan.
    exam_score_paper: float = float("nan")
    detection_rate: float = float("nan")

    def summary(self) -> str:
        r = " ".join(f"R@{k}={v:.2%}" for k, v in sorted(self.recall_at.items()))
        return (
            f"{len(self.cases)} cases, detection {self.detection_rate:.2%}, "
            f"{r}, ExamScore={self.exam_score:.4f} "
            f"(paper form {self.exam_score_paper:.2f})"
        )


@dataclass
class DetectionReport:
    """Per-window anomaly-detection quality (the paper's Fig. 9)."""

    tp: int = 0
    fp: int = 0
    fn: int = 0
    tn: int = 0

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-12)

    def summary(self) -> str:
        return (
            f"windows tp={self.tp} fp={self.fp} fn={self.fn} tn={self.tn}: "
            f"precision={self.precision:.2%} recall={self.recall:.2%} "
            f"F1={self.f1:.2%}"
        )


def _widen_spectrum(config: MicroRankConfig, eval_cfg: EvalConfig) -> MicroRankConfig:
    """Full-depth rankings (top_max covers every op), so that the Exam
    Score is exact."""
    return config.replace(spectrum=dataclasses.replace(
        config.spectrum, top_max=eval_cfg.n_operations * max(1, eval_cfg.n_pods)))


def _case_config(eval_cfg: EvalConfig, seed: int) -> SyntheticConfig:
    return SyntheticConfig(
        n_operations=eval_cfg.n_operations,
        n_pods=eval_cfg.n_pods,
        n_kinds=eval_cfg.n_kinds,
        child_keep_prob=eval_cfg.child_keep_prob,
        n_traces=eval_cfg.n_traces,
        fault_latency_ms=eval_cfg.fault_latency_ms,
        n_faults=eval_cfg.n_faults,
        fault_path_overlap=eval_cfg.fault_path_overlap,
        seed=seed,
    )


def _finalize_report(report: EvalReport, all_ranks: List[Tuple[Optional[int], int]],
                     detected: int, eval_cfg: EvalConfig) -> EvalReport:
    """R@k over faults, the Exam Score in both forms (unranked faults
    count a full candidate scan; an undetected case, which ranked no op,
    the workload's whole candidate space) and the detection rate."""
    n_faults = len(all_ranks)
    for k in eval_cfg.ks:
        report.recall_at[k] = (
            sum(1 for r, _ in all_ranks if r is not None and r <= k) / max(n_faults, 1))
    depths = [((r - 1) / max(n, 1)) if r is not None else 1.0 for r, n in all_ranks]
    full_scan = eval_cfg.n_operations * max(1, eval_cfg.n_pods)
    raw = [(r - 1) if r is not None else (n if n > 0 else full_scan) for r, n in all_ranks]
    report.exam_score = float(np.mean(depths)) if depths else float("nan")
    report.exam_score_paper = float(np.mean(raw)) if raw else float("nan")
    report.detection_rate = detected / max(eval_cfg.n_cases, 1)
    return report


def _check_backend(config: MicroRankConfig) -> None:
    if config.runtime.backend == "numpy_ref":
        raise NotImplementedError(
            "backend 'numpy_ref' (rank_backends.NumpyRefBackend, serve's degradation "
            "oracle) is not wired into the accuracy harness: ROADMAP.md, port queue item 9"
        )


class _Clock:
    """A case's host seconds by stage (``timings``)."""

    def __init__(self, seed: int):
        self.spent = {"seed": seed}
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.spent[f"{stage}_s"] = self.spent.get(f"{stage}_s", 0.0) + now - self._t
        self._t = now


def _load(windows, workdir: Path):
    """Write windows (a case or a timeline) as CSVs and read them back
    through the C++ loader: (normal table, abnormal table)."""
    normal, abnormal = windows.write_csvs(workdir)
    return load_span_table(normal, cache=False), load_span_table(abnormal, cache=False)


def _detect_partition(normal_table, table, config: MicroRankConfig):
    """The front half of a case: the SLO baseline from the normal table,
    the C++ detector over the whole abnormal table. Returns (ok, mask,
    nrm, abn, row_range), the compat partition swap applied."""
    vocab, baseline = compute_slo_from_table(normal_table, stat=config.detector.slo_stat)
    w0, w1 = int(table.start_us.min()), int(table.end_us.max())
    mask, nrm, abn, _, row_range = detect_window_partition(
        table, w0, w1, vocab, baseline, config.detector, with_range=True)
    flag = len(abn) >= config.detector.min_abnormal_traces
    ok = bool(flag) and len(nrm) > 0 and len(abn) > 0
    if ok and config.compat.partition_swap:
        nrm, abn = abn, nrm
    return ok, mask, nrm, abn, row_range


def _rank(table, mask, nrm, abn, row_range, config: MicroRankConfig, device, clock,
          all_methods: bool = False):
    """The rank half of a case: the C++ build, ``choose_kernel``, the
    staged program and its one fetch. Returns (names [n], scores [n]),
    or with ``all_methods`` {method: (names, scores)}."""
    rt = config.runtime
    graph, op_names, _, _ = build_window_graph_from_table(
        table, mask, nrm, abn, pad_policy=rt.pad_policy, min_pad=rt.min_pad,
        aux=aux_for_kernel(rt.kernel), dense_budget_bytes=rt.dense_budget_bytes,
        collapse=rt.collapse_kinds, row_range=row_range,
        kind_dedup_threshold=rt.kind_dedup_threshold)
    kernel = rt.kernel
    if kernel == "auto":
        kernel = choose_kernel(graph, rt.dense_budget_bytes, rt.prefer_bf16)
    clock.spent["kernel"] = kernel
    clock.lap("build")
    checked = bool(rt.device_checks) and not all_methods
    claim_device_owner("evaluation")
    outs, staged = stage_rank_window(
        host_subset(graph, kernel), config.pagerank, config.spectrum, kernel, device,
        rt.blob_staging, checked=checked, all_methods=all_methods)
    top_idx, top_scores, n = unpack_rank_outputs(
        pack_rank_outputs(outs, staged, checked=checked))
    clock.lap("rank")

    def ranking(idx, scores):
        return [op_names[int(i)] for i in idx[:n]], [float(x) for x in scores[:n]]

    if all_methods:
        return {m: ranking(top_idx[i], top_scores[i]) for i, m in enumerate(METHODS)}
    names, scores = ranking(top_idx, top_scores)
    if rt.validate_numerics:
        from .pipeline.table_runner import assert_finite_scores

        assert_finite_scores(scores, "evaluation.evaluate")
    return names, scores


def _run_case(case, config: MicroRankConfig, device, workdir: Path, clock,
              all_methods: bool = False):
    """(detected, ranking or None) of one generated case."""
    normal_table, table = _load(case, workdir)
    clock.lap("load")
    ok, mask, nrm, abn, row_range = _detect_partition(normal_table, table, config)
    clock.lap("detect")
    if not ok:
        return False, None
    return True, _rank(table, mask, nrm, abn, row_range, config, device, clock, all_methods)


def _ranks(names, faults) -> List[Optional[int]]:
    pos = {name: i + 1 for i, name in enumerate(names)}
    return [pos.get(f) for f in faults]


def evaluate(config: MicroRankConfig = MicroRankConfig(),
             eval_cfg: EvalConfig = EvalConfig(), device=None,
             timings: Optional[list] = None) -> EvalReport:
    """The accuracy experiment, rankings full depth so that the Exam
    Score is exact. ``device``: "cuda" or "cpu" (None: the config's).
    ``timings``: where given, a dict a case is appended to, its host
    seconds by stage (generate, load: the CSVs written and parsed,
    detect, build, rank: staging, program and fetch) and, for a
    detected case, the kernel its program ran."""
    _check_backend(config)
    device = resolve_device(config.runtime.device if device is None else device)
    config = _widen_spectrum(config, eval_cfg)
    report = EvalReport()
    all_ranks: List[Tuple[Optional[int], int]] = []
    detected = 0
    with tempfile.TemporaryDirectory(prefix="mr-eval-") as tmp:
        for i in range(eval_cfg.n_cases):
            seed = eval_cfg.seed0 + i
            clock = _Clock(seed)
            case = generate_case(_case_config(eval_cfg, seed))
            clock.lap("generate")
            faults = case.fault_pod_ops
            ok, ranking = _run_case(case, config, device, Path(tmp), clock)
            names = ranking[0] if ok else []
            result = CaseResult(seed=seed, faults=faults,
                                ranks=_ranks(names, faults) if ok else [None] * len(faults),
                                n_ranked_ops=len(names), detected=ok)
            report.cases.append(result)
            detected += result.detected
            all_ranks.extend((r, result.n_ranked_ops) for r in result.ranks)
            if timings is not None:
                timings.append(clock.spent)
            log.info("case %d: detected=%s faults=%s ranks=%s", seed, result.detected,
                     result.faults, result.ranks)
    return _finalize_report(report, all_ranks, detected, eval_cfg)


def evaluate_detection(config: MicroRankConfig = MicroRankConfig(),
                       eval_cfg: EvalConfig = EvalConfig(), n_windows: int = 10,
                       device=None) -> DetectionReport:
    """Window-level detection precision / recall / F1 over synthetic
    timelines (the paper's Fig. 9): each case a continuous
    ``n_windows``-window stream with a random half of the windows
    faulted, loaded once; every window classified by the C++ detector
    at a fixed stride (startTime >= w0 and endTime <= w1, JAX's
    ``io.loader.window_spans``; no +skip shortcut, so every window is
    scored). Detection runs on the host; ``device`` is resolved as for
    the other entry points."""
    _check_backend(config)
    resolve_device(config.runtime.device if device is None else device)
    report = DetectionReport()
    with tempfile.TemporaryDirectory(prefix="mr-eval-") as tmp:
        for i in range(eval_cfg.n_cases):
            seed = eval_cfg.seed0 + i
            rng = np.random.default_rng(seed)
            faulted = sorted(rng.choice(n_windows, size=max(1, n_windows // 2),
                                        replace=False))
            tl = generate_timeline(_case_config(eval_cfg, seed), n_windows,
                                   [int(f) for f in faulted])
            normal_table, table = _load(tl, Path(tmp))
            vocab, baseline = compute_slo_from_table(normal_table,
                                                     stat=config.detector.slo_stat)
            start = int(tl.start.astype(np.int64))
            width = int(round(tl.window_minutes * 60e6))
            for w in range(n_windows):
                w0 = start + w * width
                _, _, abn, n_window = detect_window_partition(
                    table, w0, w0 + width, vocab, baseline, config.detector)
                flag = n_window > 0 and len(abn) >= config.detector.min_abnormal_traces
                truth = tl.window_faulted[w]
                if flag and truth:
                    report.tp += 1
                elif flag:
                    report.fp += 1
                elif truth:
                    report.fn += 1
                else:
                    report.tn += 1
            log.info("timeline %d: faulted=%s tp=%d fp=%d fn=%d tn=%d", seed,
                     [int(f) for f in faulted], report.tp, report.fp, report.fn, report.tn)
    return report


def evaluate_overlap_ablation(config: MicroRankConfig = MicroRankConfig(),
                              eval_cfg: EvalConfig = EvalConfig(n_faults=2),
                              overlaps: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0),
                              device=None) -> Dict[float, EvalReport]:
    """Two-fault accuracy against fault-path separation: ``evaluate``
    once per target overlap, the placement constrained by
    ``SyntheticConfig.fault_path_overlap`` (0: disjoint call paths; 1:
    one fault an ancestor of the other, its counters masked by the
    propagated latency). Returns {target overlap: EvalReport}."""
    out: Dict[float, EvalReport] = {}
    for ov in overlaps:
        ecfg = dataclasses.replace(eval_cfg, n_faults=max(2, eval_cfg.n_faults),
                                   fault_path_overlap=float(ov))
        out[float(ov)] = evaluate(config, ecfg, device=device)
        log.info("overlap %.2f: %s", ov, out[float(ov)].summary())
    return out


def evaluate_all_methods(config: MicroRankConfig = MicroRankConfig(),
                         eval_cfg: EvalConfig = EvalConfig(), device=None,
                         timings: Optional[list] = None) -> Dict[str, EvalReport]:
    """The per-formula comparison (the paper's Tables 4-6 axis) in one
    sweep: each case detects and partitions once and runs one program
    for every formula (K13: the power iterations and the counters are
    the formulas' common part). Returns {method: EvalReport} in
    ``METHODS`` order, scored as ``evaluate``; ``timings`` as there."""
    _check_backend(config)
    device = resolve_device(config.runtime.device if device is None else device)
    config = _widen_spectrum(config, eval_cfg)
    reports = {m: EvalReport() for m in METHODS}
    all_ranks: Dict[str, List[Tuple[Optional[int], int]]] = {m: [] for m in METHODS}
    detected = 0
    with tempfile.TemporaryDirectory(prefix="mr-eval-") as tmp:
        for i in range(eval_cfg.n_cases):
            seed = eval_cfg.seed0 + i
            clock = _Clock(seed)
            case = generate_case(_case_config(eval_cfg, seed))
            clock.lap("generate")
            faults = case.fault_pod_ops
            ok, per_method = _run_case(case, config, device, Path(tmp), clock,
                                       all_methods=True)
            detected += ok
            for m in METHODS:
                names = per_method[m][0] if ok else []
                ranks = _ranks(names, faults)
                reports[m].cases.append(CaseResult(seed=seed, faults=faults, ranks=ranks,
                                                   n_ranked_ops=len(names), detected=ok))
                all_ranks[m].extend((r, len(names)) for r in ranks)
            if timings is not None:
                timings.append(clock.spent)
            log.info("case %d: detected=%s faults=%s", seed, ok, faults)
    for m in METHODS:
        _finalize_report(reports[m], all_ranks[m], detected, eval_cfg)
    return reports


__all__ = [
    "DEFAULT_TIE_RTOL",
    "CaseResult",
    "DetectionReport",
    "EvalConfig",
    "EvalReport",
    "average_precision",
    "evaluate",
    "evaluate_all_methods",
    "evaluate_detection",
    "evaluate_overlap_ablation",
    "rank_of_culprit",
    "ranking_metrics",
    "reciprocal_rank",
    "tie_aware_ranks",
    "topk_exact",
]
