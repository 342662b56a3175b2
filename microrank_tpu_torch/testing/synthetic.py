"""Synthetic microservice trace generator with fault injection, numpy
only (counterpart of ``microrank_tpu/testing/synthetic.py``'s
``generate_case`` / ``generate_case_with_spans`` and the timelines
``generate_timeline`` / ``generate_timeline_with_spans``).

A random service call tree, a small set of trace kinds (pruned
subtrees), lognormal per-operation own times, inclusive span durations
(a parent span covers its children), and a latency fault on one
(operation, pod) in the abnormal window. The random draws are the JAX
module's, in the same order, so one config and seed give the same spans
in both packages; where that module returns pandas frames, this one
returns column arrays and writes the CSV itself (canonical span schema,
the columns the native loader reads).

Only the latency fault family is ported, with the fault placement's
overlap control (``fault_path_overlap``, which the accuracy harness's
two-fault ablation sets); the error / cascade / drift knobs serve lanes
this package does not have yet.

``giant_window`` is bench.py's giant-window tier (its
``_synthesize_giant_partition``) lifted to an in-memory span table: the
window past the dense budget, where kernel="auto" picks packed_blocked
or pcsr.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# Epoch of the normal window, as in the JAX generator.
T0 = np.datetime64("2025-02-14T12:00:00", "us")

CSV_COLUMNS = (
    "traceID", "spanID", "ParentSpanId", "operationName", "serviceName",
    "podName", "duration", "startTime", "endTime",
)


@dataclass(frozen=True)
class SyntheticConfig:
    n_operations: int = 40
    n_pods: int = 1            # pods per service (instance-level RCA when >1)
    n_kinds: int = 8           # distinct trace shapes
    child_keep_prob: float = 0.8
    n_traces: int = 200
    mean_own_ms_range: Tuple[float, float] = (1.0, 20.0)
    sigma_log: float = 0.3
    # The detector's expected duration sums inclusive per-span SLOs, so
    # the injected latency must clear a wide margin.
    fault_latency_ms: float = 2000.0
    n_faults: int = 1
    # Target root-path overlap between the injected faults (the
    # multi-fault hardness control): the overlap coefficient |Pa & Pb| /
    # min(|Pa|, |Pb|) of their root-to-op paths, root excluded. 0 puts
    # the faults on disjoint call paths, 1 makes one an ancestor of the
    # other; None keeps the unconstrained random choice.
    fault_path_overlap: Optional[float] = None
    window_minutes: float = 5.0
    seed: int = 0


def _op_id_width(n_operations: int) -> int:
    return max(3, len(str(max(n_operations - 1, 0))))


def _pod_op_name(op: int, pod: int, n_operations: int) -> str:
    """The instance-level (PageRank vocab) name of a (service op, pod)."""
    w = _op_id_width(n_operations)
    return f"svc{op:0{w}d}-{pod}_op{op:0{w}d}"


@dataclass
class Topology:
    parent: np.ndarray          # int [n_ops], parent[0] = -1
    mean_own_ms: np.ndarray     # float [n_ops]
    kinds: List[np.ndarray]     # each: topo-ordered op ids forming a subtree
    kind_parent_pos: List[np.ndarray]  # position of op's parent within kind


def _make_topology(cfg: SyntheticConfig, rng: np.random.Generator) -> Topology:
    n = cfg.n_operations
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        parent[i] = rng.integers(0, i)
    mean_own = rng.uniform(*cfg.mean_own_ms_range, size=n)

    kinds = []
    kind_parent_pos = []
    for _ in range(cfg.n_kinds):
        keep = np.zeros(n, dtype=bool)
        keep[0] = True
        for i in range(1, n):
            keep[i] = keep[parent[i]] and (rng.random() < cfg.child_keep_prob)
        ops = np.flatnonzero(keep)  # ascending == topological (parent < child)
        pos = {int(o): j for j, o in enumerate(ops)}
        ppos = np.array(
            [pos[int(parent[o])] if parent[o] >= 0 else -1 for o in ops],
            dtype=np.int64,
        )
        kinds.append(ops)
        kind_parent_pos.append(ppos)
    return Topology(parent, mean_own, kinds, kind_parent_pos)


def _root_path(parent: np.ndarray, op: int) -> frozenset:
    """Ops on the root-to-op call path, the root itself excluded (every
    path shares the root, so including it would floor the overlap)."""
    out = []
    o = int(op)
    while o > 0:
        out.append(o)
        o = int(parent[o])
    return frozenset(out)


def path_overlap(parent: np.ndarray, a: int, b: int) -> float:
    """Overlap coefficient of two ops' root paths: |Pa & Pb| / min(|Pa|,
    |Pb|). 0 = disjoint paths (they share only the root); 1 = one op
    lies on the other's path."""
    return _paths_overlap(_root_path(parent, a), _root_path(parent, b))


def _paths_overlap(pa: frozenset, pb: frozenset) -> float:
    return len(pa & pb) / max(min(len(pa), len(pb)), 1)


def _pick_faults(topo: Topology, rng, n_pods: int, n_faults: int,
                 target_overlap: Optional[float] = None):
    """Fault candidates: ops covered by >= 1 kind, the root excluded.

    With ``target_overlap`` and >= 2 faults, the best pair of candidates
    (least deviation of its ``path_overlap`` from the target, ties drawn
    at random) seeds the set, then greedy additions keep the mean
    pairwise overlap nearest the target. Past 512 candidates a random
    pool of 512 is drawn first (the only extra draw). ``None`` keeps the
    unconstrained choice."""
    covered = np.unique(np.concatenate(topo.kinds))
    candidates = covered[covered != 0]
    if len(candidates) == 0:
        candidates = covered
    n_faults = min(n_faults, len(candidates))
    if target_overlap is None or n_faults < 2:
        fault_ops = rng.choice(candidates, size=n_faults, replace=False)
        return [(int(op), int(rng.integers(0, n_pods))) for op in fault_ops]

    cand = [int(c) for c in candidates]
    pool_cap = max(512, n_faults)
    if len(cand) > pool_cap:
        cand = sorted(int(c) for c in rng.choice(cand, size=pool_cap, replace=False))
    paths = {c: _root_path(topo.parent, c) for c in cand}

    def overlap(a: int, b: int) -> float:
        return _paths_overlap(paths[a], paths[b])

    pairs = [(a, b) for i, a in enumerate(cand) for b in cand[i + 1:]]
    dev = np.array([abs(overlap(a, b) - target_overlap) for a, b in pairs])
    best = np.flatnonzero(dev == dev.min())
    chosen = list(pairs[int(rng.choice(best))])
    remaining = [c for c in cand if c not in chosen]
    while len(chosen) < n_faults and remaining:
        devs = np.array([
            abs(float(np.mean([overlap(c, x) for x in chosen])) - target_overlap)
            for c in remaining
        ])
        best = np.flatnonzero(devs == devs.min())
        pick = remaining[int(rng.choice(best))]
        chosen.append(pick)
        remaining.remove(pick)
    return [(int(op), int(rng.integers(0, n_pods))) for op in chosen]


def achieved_overlap(parent: np.ndarray, faults: List[Tuple[int, int]]) -> Optional[float]:
    """Mean pairwise root-path overlap of the injected fault ops (None
    for a single fault)."""
    ops = [op for op, _ in faults]
    if len(ops) < 2:
        return None
    vals = [path_overlap(parent, a, b) for i, a in enumerate(ops) for b in ops[i + 1:]]
    return float(np.mean(vals))


def _render_spans(
    topo: Topology,
    cfg: SyntheticConfig,
    rng: np.random.Generator,
    n_traces: int,
    t0: np.datetime64,
    faults: Optional[List[Tuple[int, int]]],
    trace_prefix: str,
) -> Dict[str, object]:
    """One window's spans as column arrays — trace index, op, pod,
    parent op, duration (us), per-row start / end (epoch us) — plus the
    trace-id prefix."""
    kind_of_trace = rng.integers(0, len(topo.kinds), size=n_traces)
    start_offsets_us = np.sort(
        rng.uniform(0, cfg.window_minutes * 60e6, size=n_traces)
    ).astype(np.int64)

    blocks = []
    for k, ops in enumerate(topo.kinds):
        t_idx = np.flatnonzero(kind_of_trace == k)
        if len(t_idx) == 0:
            continue
        m = len(ops)
        mu = np.log(topo.mean_own_ms[ops])
        own_ms = rng.lognormal(
            mean=mu[None, :], sigma=cfg.sigma_log, size=(len(t_idx), m)
        )
        pods = rng.integers(0, cfg.n_pods, size=(len(t_idx), m))
        if faults:
            pos = {int(o): j for j, o in enumerate(ops)}
            for fault_op, fault_pod in faults:
                j = pos.get(int(fault_op))
                if j is not None:
                    hit = pods[:, j] == fault_pod
                    own_ms[:, j] += np.where(hit, cfg.fault_latency_ms, 0.0)
        # Inclusive durations: add each op's total into its parent,
        # deepest first (ops are topo-ordered).
        dur_ms = own_ms.copy()
        ppos = topo.kind_parent_pos[k]
        for j in range(m - 1, 0, -1):
            dur_ms[:, ppos[j]] += dur_ms[:, j]
        nt = len(t_idx)
        blocks.append(
            (
                np.repeat(t_idx, m),
                np.tile(ops, nt),
                pods.reshape(-1),
                (dur_ms.reshape(-1) * 1000.0).astype(np.int64),
                np.repeat((dur_ms[:, 0] * 1000.0).astype(np.int64), m),
                np.tile(topo.parent[ops], nt),
            )
        )
    trace, op, pod, dur, root_dur, parent = (
        np.concatenate([b[i] for b in blocks]) for i in range(6)
    )
    start = t0.astype(np.int64) + start_offsets_us[trace]
    return {
        "trace": trace,
        "op": op,
        "pod": pod,
        "parent": parent,
        "duration_us": dur,
        "start_us": start,
        "end_us": start + root_dur,
        "trace_prefix": trace_prefix,
    }


def write_spans_csv(spans, path, n_operations: int, append: bool = False) -> None:
    """Write spans as a canonical-schema traces CSV (the row order and
    values pandas' ``to_csv`` gives the JAX generator's frame;
    timestamps with microseconds). ``spans`` is one window's span
    columns, or a list of windows' written one after another under one
    header, as the JAX generator concatenates a timeline's frames.
    ``append``: add the rows to the end of an existing file, without a
    header (a collector growing a dump that is followed)."""
    with open(path, "a" if append else "w") as f:
        if not append:
            f.write(",".join(CSV_COLUMNS) + "\n")
        for part in spans if isinstance(spans, list) else [spans]:
            _write_span_rows(f, part, n_operations)


def _write_span_rows(f, spans: Dict[str, object], n_operations: int) -> None:
    w = _op_id_width(n_operations)
    prefix = spans["trace_prefix"]
    start_us, end_us = spans["start_us"], spans["end_us"]
    n = len(start_us)
    if not n:
        return
    # One formatted string per distinct instant, trace and op, not per
    # row.
    stamps, inv = np.unique(np.concatenate([start_us, end_us]), return_inverse=True)
    text = np.char.replace(
        np.datetime_as_string(stamps.astype("datetime64[us]"), unit="us"), "T", " "
    ).tolist()
    trace_names = [prefix + str(t) for t in range(int(spans["trace"].max()) + 1)]
    op_cols = [
        f"op{o:0{w}d},svc{o:0{w}d},svc{o:0{w}d}-" for o in range(int(spans["op"].max()) + 1)
    ]
    step = 100_000
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        rows = zip(
            spans["trace"][lo:hi].tolist(), spans["op"][lo:hi].tolist(),
            spans["parent"][lo:hi].tolist(), spans["pod"][lo:hi].tolist(),
            spans["duration_us"][lo:hi].tolist(), inv[lo:hi].tolist(),
            inv[n + lo: n + hi].tolist(),
        )
        lines = []
        for t, o, par, pod, dur, s_i, e_i in rows:
            tr = trace_names[t]
            lines.append(
                f"{tr},{tr}-s{o},{tr + '-s' + str(par) if par >= 0 else ''},"
                f"{op_cols[o]}{pod},{dur},{text[s_i]},{text[e_i]}\n"
            )
        f.write("".join(lines))


def spans_table(spans, n_operations: int):
    """The ``SpanTable`` that ``load_span_table`` reads from
    ``write_spans_csv(spans, ...)``, built from the span columns without
    the CSV (one window's columns or a list of windows'): the loader's
    names (``svc_op`` "svcNN_opNN", ``pod_op`` "svcNN-P_opNN", trace ids
    prefix + index) interned in first appearance, a span's parent the
    row of its trace's span of the parent op, rows then sorted by start
    (``sort_table_by_time``)."""
    from ..native import SpanTable, sort_table_by_time

    parts = [p for p in (spans if isinstance(spans, list) else [spans])
             if len(p["start_us"])]
    w = _op_id_width(n_operations)
    if not parts:
        empty = np.zeros(0, np.int64)
        return SpanTable(empty.astype(np.int32), empty.astype(np.int32),
                         empty.astype(np.int32), empty, empty, empty, empty, [], [], [],
                         time_sorted=True)
    # A span's trace across windows: (window, trace index).
    trace_base = np.cumsum([0] + [int(p["trace"].max()) + 1 for p in parts])
    gtrace = np.concatenate([p["trace"].astype(np.int64) + b for p, b in zip(parts, trace_base)])
    op = np.concatenate([p["op"] for p in parts]).astype(np.int64)
    pod = np.concatenate([p["pod"] for p in parts]).astype(np.int64)
    parent_op = np.concatenate([p["parent"] for p in parts]).astype(np.int64)

    def first_seen(keys):
        uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
        rank = np.empty(uniq.size, np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(uniq.size)
        return uniq[np.argsort(rank)], rank[inv]

    traces, trace_id = first_seen(gtrace)
    window_of = np.searchsorted(trace_base, traces, side="right") - 1
    trace_names = [parts[wi]["trace_prefix"] + str(int(t - trace_base[wi]))
                   for wi, t in zip(window_of.tolist(), traces.tolist())]
    def by_name(keys, name_of):
        uniq, inv = np.unique(keys, return_inverse=True)
        names = [name_of(int(k)) for k in uniq.tolist()]
        order = sorted(range(len(names)), key=names.__getitem__)
        rank = np.empty(len(names), np.int64)
        rank[order] = np.arange(len(names))
        return [names[i] for i in order], rank[inv]

    svc_names, svc_op = by_name(op, lambda o: f"svc{o:0{w}d}_op{o:0{w}d}")
    n_pods = int(pod.max()) + 1
    pod_names, pod_op = by_name(
        op * n_pods + pod,
        lambda k: f"svc{k // n_pods:0{w}d}-{k % n_pods}_op{k // n_pods:0{w}d}")
    # Parents: the row of (trace, parent op); span ids are unique per
    # (trace, op), and the loader keeps the last row of a repeated id.
    n_ops = int(max(op.max(), parent_op.max())) + 1
    key = gtrace * n_ops + op
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    # Last occurrence of each key (the loader's map overwrite).
    last = np.r_[sorted_key[1:] != sorted_key[:-1], True]
    keys_last, rows_last = sorted_key[last], order[last]
    want = gtrace * n_ops + parent_op
    at = np.clip(np.searchsorted(keys_last, want), 0, keys_last.size - 1)
    parent_row = np.where((parent_op >= 0) & (keys_last[at] == want), rows_last[at], -1)
    table = SpanTable(
        trace_id=trace_id.astype(np.int32),
        svc_op=svc_op.astype(np.int32),
        pod_op=pod_op.astype(np.int32),
        duration_us=np.concatenate([p["duration_us"] for p in parts]).astype(np.int64),
        start_us=np.concatenate([p["start_us"] for p in parts]).astype(np.int64),
        end_us=np.concatenate([p["end_us"] for p in parts]).astype(np.int64),
        parent_row=parent_row.astype(np.int64),
        trace_names=trace_names,
        svc_op_names=svc_names,
        pod_op_names=pod_names,
    )
    return sort_table_by_time(table)


@dataclass
class SyntheticCase:
    normal: Dict[str, object]
    abnormal: Dict[str, object]
    fault_service_op: str     # service-level name of the (first) root cause
    fault_pod_op: str         # instance-level (PageRank vocab) name
    fault_op: int
    fault_pod: int
    topology: Topology
    faults: List[Tuple[int, int]] = field(default_factory=list)
    # Mean pairwise root-path overlap of the injected faults (None for a
    # single fault): the hardness the two-fault ablation conditions on.
    fault_overlap: Optional[float] = None

    @property
    def n_operations(self) -> int:
        return int(self.topology.parent.shape[0])

    @property
    def fault_pod_ops(self) -> List[str]:
        """Instance-level names of every injected root cause."""
        return [_pod_op_name(op, pod, self.n_operations) for op, pod in self.faults]

    @property
    def n_abnormal_spans(self) -> int:
        return int(self.abnormal["trace"].shape[0])

    def write_csvs(self, out_dir) -> Tuple[Path, Path]:
        """Write normal.csv and abnormal.csv into ``out_dir``; returns
        their paths."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths = (out / "normal.csv", out / "abnormal.csv")
        for spans, path in zip((self.normal, self.abnormal), paths):
            write_spans_csv(spans, path, self.n_operations)
        return paths


def _traces_for_spans(cfg: SyntheticConfig, target_spans: int) -> int:
    """Trace count whose expected span total is ~``target_spans``."""
    rng = np.random.default_rng(cfg.seed)
    topo = _make_topology(cfg, rng)
    mean_kind = float(np.mean([len(k) for k in topo.kinds]))
    return max(1, int(round(target_spans / max(mean_kind, 1.0))))


def generate_case(cfg: SyntheticConfig) -> SyntheticCase:
    """One chaos case: a normal window and an abnormal window with the
    injected latency fault(s)."""
    rng = np.random.default_rng(cfg.seed)
    topo = _make_topology(cfg, rng)
    faults = _pick_faults(topo, rng, cfg.n_pods, cfg.n_faults, cfg.fault_path_overlap)
    t1 = T0 + np.timedelta64(int(cfg.window_minutes * 60e6), "us")
    normal = _render_spans(topo, cfg, rng, cfg.n_traces, T0, None, "n")
    abnormal = _render_spans(topo, cfg, rng, cfg.n_traces, t1, faults, "a")
    fault_op, fault_pod = faults[0]
    w = _op_id_width(cfg.n_operations)
    return SyntheticCase(
        normal=normal,
        abnormal=abnormal,
        fault_service_op=f"svc{fault_op:0{w}d}_op{fault_op:0{w}d}",
        fault_pod_op=_pod_op_name(fault_op, fault_pod, cfg.n_operations),
        fault_op=fault_op,
        fault_pod=fault_pod,
        topology=topo,
        faults=faults,
        fault_overlap=achieved_overlap(topo.parent, faults),
    )


def generate_case_with_spans(cfg: SyntheticConfig, target_spans: int) -> SyntheticCase:
    """A case whose windows hold ~``target_spans`` spans each."""
    n_traces = _traces_for_spans(cfg, target_spans)
    return generate_case(SyntheticConfig(**{**cfg.__dict__, "n_traces": n_traces}))


@dataclass
class SyntheticTimeline:
    """A multi-window replay: one normal baseline window plus
    consecutive windows, a subset of which carry the fault(s)."""

    normal: Dict[str, object]
    windows: List[Dict[str, object]]  # one window's span columns each
    window_faulted: List[bool]
    window_minutes: float
    start: np.datetime64              # first timeline window's start
    fault_pod_op: str
    fault_pod_ops: List[str]          # every injected culprit
    n_operations: int

    @property
    def n_timeline_spans(self) -> int:
        return sum(int(w["trace"].shape[0]) for w in self.windows)

    def write_csvs(self, out_dir) -> Tuple[Path, Path]:
        """Write normal.csv and abnormal.csv (the whole timeline) into
        ``out_dir``; returns their paths."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths = (out / "normal.csv", out / "abnormal.csv")
        write_spans_csv(self.normal, paths[0], self.n_operations)
        write_spans_csv(self.windows, paths[1], self.n_operations)
        return paths


def generate_timeline(
    cfg: SyntheticConfig, n_windows: int, faulted: List[int]
) -> SyntheticTimeline:
    """A continuous ``n_windows``-window trace stream in which the
    windows listed in ``faulted`` carry the injected fault(s) and the
    rest are clean; ``cfg.n_traces`` applies per window. The JAX
    generator's draws in its order, so one config and seed give the
    same spans in both packages. The JAX config's ``drift_per_window``
    (own times scaled per window) is not ported: this package's
    SyntheticConfig has no drift, and every window renders at scale 1."""
    rng = np.random.default_rng(cfg.seed)
    topo = _make_topology(cfg, rng)
    faults = _pick_faults(topo, rng, cfg.n_pods, cfg.n_faults, cfg.fault_path_overlap)
    window_us = np.timedelta64(int(cfg.window_minutes * 60e6), "us")
    normal = _render_spans(topo, cfg, rng, cfg.n_traces, T0, None, "n")
    fault_set = set(faulted)
    windows = [
        _render_spans(
            topo, cfg, rng, cfg.n_traces, T0 + (i + 1) * window_us,
            faults if i in fault_set else None, f"w{i}x",
        )
        for i in range(n_windows)
    ]
    names = [_pod_op_name(op, pod, cfg.n_operations) for op, pod in faults]
    return SyntheticTimeline(
        normal=normal,
        windows=windows,
        window_faulted=[i in fault_set for i in range(n_windows)],
        window_minutes=cfg.window_minutes,
        start=T0 + window_us,
        fault_pod_op=names[0],
        fault_pod_ops=names,
        n_operations=cfg.n_operations,
    )


def generate_timeline_with_spans(
    cfg: SyntheticConfig,
    target_spans_per_window: int,
    n_windows: int,
    faulted: List[int],
) -> SyntheticTimeline:
    """generate_timeline with the per-window trace count derived from a
    spans target (as generate_case_with_spans)."""
    n_traces = _traces_for_spans(cfg, target_spans_per_window)
    return generate_timeline(
        SyntheticConfig(**{**cfg.__dict__, "n_traces": n_traces}),
        n_windows,
        faulted,
    )


@dataclass
class GiantWindow:
    """One giant detection window as an in-memory span table with its
    partition given (``giant_window``)."""

    table: object               # native.SpanTable, rows time-sorted
    normal_codes: np.ndarray    # int64 trace codes of the normal partition
    abnormal_codes: np.ndarray  # int64 trace codes of the abnormal partition


def giant_window(
    n_spans: int = 10_485_760,
    n_ops: int = 2048,
    spans_per_trace: int = 4,
    seed: int = 12,
) -> GiantWindow:
    """bench.py's giant-window tier (``_synthesize_giant_partition``)
    lifted to spans, so that it feeds the C++ graph build. Per partition,
    ``n_spans / (2 * spans_per_trace)`` traces each draw
    ``spans_per_trace`` ops uniformly from an ``n_ops`` vocab (nearly
    every trace is a kind of its own, so the kind collapse cannot shrink
    the window), and ``4 * n_ops`` spans at random non-root positions
    get a parent, an earlier span of the same trace: a small random
    call-edge set, as bench.py's. The op codes are bench.py's first draw
    from the same seed. Normal traces come first, then abnormal ones;
    names are ``op00000`` .. (the vocab in name order) and ``g<code>``.
    Seeded, no CSV. Durations and times are constant: the partition is
    given, and nothing detects on this table."""
    from ..native import SpanTable

    rng = np.random.default_rng(seed)
    n_traces = n_spans // (2 * spans_per_trace)  # per partition
    per_part = n_traces * spans_per_trace
    ops, parents = [], []
    for part in range(2):
        ops.append(rng.integers(0, n_ops, size=per_part, dtype=np.int64))
        n_edges = 4 * n_ops
        trace = rng.integers(0, n_traces, size=n_edges)
        pos = rng.integers(1, spans_per_trace, size=n_edges)
        parent_pos = rng.integers(0, pos)
        first = trace * spans_per_trace  # the trace's first row in its partition
        parent = np.full(per_part, -1, dtype=np.int64)
        parent[first + pos] = part * per_part + first + parent_pos
        parents.append(parent)
    n_rows = 2 * per_part
    pod_op = np.concatenate(ops).astype(np.int32)
    t0 = int(T0.astype(np.int64))
    names = [f"op{i:05d}" for i in range(n_ops)]
    table = SpanTable(
        trace_id=np.repeat(np.arange(2 * n_traces, dtype=np.int32), spans_per_trace),
        svc_op=pod_op,
        pod_op=pod_op,
        duration_us=np.full(n_rows, 1000, dtype=np.int64),
        start_us=np.full(n_rows, t0, dtype=np.int64),
        end_us=np.full(n_rows, t0 + 1000, dtype=np.int64),
        parent_row=np.concatenate(parents),
        trace_names=[f"g{i}" for i in range(2 * n_traces)],
        svc_op_names=names,
        pod_op_names=list(names),
        time_sorted=True,
    )
    return GiantWindow(
        table=table,
        normal_codes=np.arange(n_traces, dtype=np.int64),
        abnormal_codes=np.arange(n_traces, 2 * n_traces, dtype=np.int64),
    )
