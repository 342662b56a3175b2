"""Time-travel replay: re-rank stored windows through the live lane
(counterpart of ``microrank_tpu/warehouse/replay.py``).

``cli replay --at START..END`` loads the stored rank blobs of the range,
views each as its host window graph (``segment.unpack_graph_blob_host``:
no parse, no build), ranks them through the same ``DispatchRouter`` the
stream engine uses (coalesced into same-bucket stacked programs, staged
as one blob each: the card when the config's device is CUDA) and checks
every window's new ranking against its stored verdict with the
tie-aware comparator. A mismatch means history does not reproduce: the
CLI exits nonzero.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional, Tuple

from ..utils.ranking_compare import tie_aware_topk_agreement

_INT = re.compile(r"^[+-]?\d+$")
_FORMS = ("'all' (or empty, or '*'), 'START..END' or a single instant, each bound an "
          "epoch-microsecond integer, 'YYYY-MM-DD', 'YYYY-MM-DD HH:MM[:SS[.f]]' or ISO 8601 "
          "'YYYY-MM-DDTHH:MM[:SS[.f]]' (UTC), either side of '..' empty for an open bound")


def parse_time_range(spec: str) -> Tuple[Optional[int], Optional[int]]:
    """``"all"`` -> an open range; ``"START..END"``, each side an epoch
    microsecond integer, a date or date-time (``stamp_to_us``), or empty
    (open); a single instant selects the window(s) holding it. JAX takes
    anything pandas parses; other forms raise ValueError here, naming
    the accepted ones."""
    from .store import stamp_to_us

    spec = (spec or "").strip()
    if spec in ("", "all", "*"):
        return None, None

    def _bound(s: str) -> Optional[int]:
        s = s.strip()
        if not s:
            return None
        if _INT.match(s):
            return int(s)
        try:
            return stamp_to_us(s)
        except ValueError:
            raise ValueError(f"bad time bound {s!r}: accepted forms are {_FORMS}") from None

    if ".." in spec:
        left, right = spec.split("..", 1)
        return _bound(left), _bound(right)
    point = _bound(spec)
    return point, point


def replay_range(path, t0_us: Optional[int] = None, t1_us: Optional[int] = None, config=None,
                 k: int = 5, sched=None) -> dict:
    """Replay the stored ranked windows of ``[t0_us, t1_us]``; returns
    JAX's report (``report["verdict"]``: "match" / "mismatch").

    ``sched`` (co-deploy): the DeviceScheduler; each coalesced group then
    runs as a backfill-lane thunk on its thread, behind serve and stream.
    Solo, this thread claims the card."""
    from ..config import MicroRankConfig
    from ..dispatch.router import DispatchRouter, bucket_key
    from ..utils.guards import claim_device_owner
    from .store import TraceWarehouse

    if config is None:
        config = MicroRankConfig()
    if sched is None:
        claim_device_owner("warehouse-replay")
    store = TraceWarehouse(path, config.warehouse)
    windows = store.query(t0_us, t1_us)
    ranked = []
    skipped_no_blob = 0
    for w in windows:
        if w.outcome != "ranked" or not w.ranking:
            continue
        g = w.graph()
        if g is None:
            skipped_no_blob += 1
            continue
        ranked.append((w, g))

    router = DispatchRouter(config)
    coalesce = max(1, int(getattr(config.dispatch, "coalesce_windows", 1)))
    mismatches: List[dict] = []
    matched = 0
    spans = sum(w.meta.get("spans", 0) for w, _ in ranked)
    t_start = time.perf_counter()
    i = 0
    while i < len(ranked):
        w0, g0 = ranked[i]
        kernel = w0.kernel or "coo"
        key = bucket_key(g0, kernel)
        group = [(w0, g0)]
        j = i + 1
        while (j < len(ranked) and len(group) < coalesce
               and (ranked[j][0].kernel or "coo") == kernel
               and bucket_key(ranked[j][1], kernel) == key):
            group.append(ranked[j])
            j += 1
        i = j
        graphs = [g for _, g in group]
        if sched is None:
            outs, _info = router.rank_batch(graphs, kernel)
        else:
            from ..sched import LANE_BACKFILL

            outs, _info = sched.run_on(LANE_BACKFILL, config.sched.backfill_tenant,
                                       lambda: router.rank_batch(graphs, kernel),
                                       cost=float(len(graphs)))
        top_idx, top_scores, n_valid = outs[:3]
        for b, (w, _g) in enumerate(group):
            op_names = w.op_names or []
            n = int(n_valid[b])
            new_names = [op_names[int(x)] for x in top_idx[b][:n]]
            new_scores = [float(s) for s in top_scores[b][:n]]
            stored = w.ranking
            kk = min(k, len(stored), len(new_names)) or 1
            ok, reason = tie_aware_topk_agreement([n_ for n_, _ in stored],
                                                  [s for _, s in stored], new_names,
                                                  new_scores, kk)
            _record("match" if ok else "mismatch")
            if ok:
                matched += 1
            else:
                mismatches.append({
                    "start": w.meta.get("start"), "end": w.meta.get("end"), "reason": reason,
                    "stored_top": stored[:kk],
                    "replayed_top": list(zip(new_names[:kk], new_scores[:kk])),
                })
    elapsed = time.perf_counter() - t_start
    return {
        "range": [t0_us, t1_us],
        "windows": len(windows),
        "ranked": len(ranked),
        "matched": matched,
        "mismatched": mismatches,
        "skipped_no_blob": skipped_no_blob,
        "spans": int(spans),
        "elapsed_s": round(elapsed, 4),
        "spans_per_sec": round(spans / elapsed, 1) if elapsed > 0 else None,
        "windows_per_sec": round(len(ranked) / elapsed, 2) if elapsed > 0 else None,
        "k": k,
        "verdict": "match" if not mismatches else "mismatch",
    }


def _record(verdict: str) -> None:
    from ..obs.metrics import record_warehouse_replay

    record_warehouse_replay(verdict)
