"""Incident lifecycle: fingerprint, dedup, open/update/resolve, sinks
(counterpart of ``microrank_tpu/stream/incidents.py``, host only).

A continuous engine that emits one ranked suspect list per abnormal
window buries the operator in duplicates — a 40-minute fault at
5-minute windows is ONE incident, not eight alerts. Here every ranked
window is fingerprinted by its tie-aware top-k suspect set (exact score
ties at the cut expand the set, so a legally permuted tie cannot split
an incident); consecutive windows whose fingerprints match — exactly or
by Jaccard overlap >= ``fingerprint_jaccard``, absorbing top-k tail
wobble across windows of the same fault — dedup into one OPEN incident
that UPDATEs per window and RESOLVEs after ``resolve_after_windows``
consecutive healthy windows. Dedup is DRIFT-AWARE: fingerprints
carry the suspects' max-normalized score vector, and an update whose
vector moved by more than ``score_drift`` (L-inf) flags
``drifted: true`` — the suspect set looks the same but the fault is
evolving (dominant suspect changing, a second cause joining), which an
operator wants to see rather than have silently absorbed. A resolved fingerprint enters a cooldown:
re-flagging within ``cooldown_windows`` windows is suppressed (counted,
not alerted) — flap damping for faults straddling the detector's edge.

Transitions emit structured events to pluggable sinks: a JSONL incident
log (``incidents.jsonl``), stdout one-liners, and a best-effort webhook
POST (2 s timeout; failures counted, never raised into the engine).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import logging
import random

log = logging.getLogger("microrank_tpu_torch.stream.incidents")


def ranking_fingerprint(
    ranking: Sequence[Tuple[str, float]], k: int, rtol: float = 1e-6
) -> FrozenSet[str]:
    """Tie-aware top-k suspect set of one ranked window.

    Takes the top-k names plus every name whose score ties the k-th
    score within ``rtol`` — two windows whose rankings differ only by a
    permuted exact tie (different kernels/summation trees legally do
    this, see utils.ranking_compare) produce the SAME fingerprint.
    """
    if not ranking:
        return frozenset()
    k = min(max(1, int(k)), len(ranking))
    cut = float(ranking[k - 1][1])
    tol = rtol * max(abs(cut), 1e-12)
    return frozenset(
        name
        for i, (name, score) in enumerate(ranking)
        if i < k or float(score) >= cut - tol
    )


def _jaccard(a: FrozenSet[str], b: FrozenSet[str]) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


def suspect_scores(
    ranking: Sequence[Tuple[str, float]], fingerprint: FrozenSet[str]
) -> Dict[str, float]:
    """The fingerprint members' scores, max-normalized so drift compares
    score SHAPE (which suspect dominates) rather than absolute scale —
    spectrum scores are only meaningful relative to the window."""
    scores = {
        str(n): float(s) for n, s in ranking if str(n) in fingerprint
    }
    peak = max((abs(s) for s in scores.values()), default=0.0)
    if peak <= 0:
        return {n: 0.0 for n in scores}
    return {n: s / peak for n, s in scores.items()}


def score_drift(a: Dict[str, float], b: Dict[str, float]) -> float:
    """L-inf distance between two normalized suspect-score vectors over
    the union of their supports (a missing suspect scores 0)."""
    if not a and not b:
        return 0.0
    return max(
        abs(a.get(n, 0.0) - b.get(n, 0.0)) for n in set(a) | set(b)
    )


@dataclass
class Incident:
    incident_id: str
    fingerprint: FrozenSet[str]
    opened_at: str                 # window start (event time)
    last_seen: str
    windows: int = 1
    healthy_streak: int = 0
    top: List[Tuple[str, float]] = field(default_factory=list)
    status: str = "open"           # open | resolved
    # Normalized suspect-score vector at the last observation: the
    # drift-aware dedup baseline (same top-k SET but a moved score
    # vector -> update carries drifted:true instead of silent dedup).
    scores: Dict[str, float] = field(default_factory=dict)
    drift_events: int = 0

    def to_event(self, transition: str, **extra) -> dict:
        return {
            "event": f"incident_{transition}",
            "incident_id": self.incident_id,
            "fingerprint": sorted(self.fingerprint),
            "opened_at": self.opened_at,
            "last_seen": self.last_seen,
            "windows": self.windows,
            "top": [[n, float(s)] for n, s in self.top[:10]],
            **extra,
        }

    # ------------------------------------------------------- durability
    def to_state(self) -> dict:
        return {
            "incident_id": self.incident_id,
            "fingerprint": sorted(self.fingerprint),
            "opened_at": self.opened_at,
            "last_seen": self.last_seen,
            "windows": self.windows,
            "healthy_streak": self.healthy_streak,
            "top": [[str(n), float(s)] for n, s in self.top],
            "status": self.status,
            "scores": {str(k): float(v) for k, v in self.scores.items()},
            "drift_events": self.drift_events,
        }

    @classmethod
    def from_state(cls, state: dict) -> "Incident":
        return cls(
            incident_id=str(state["incident_id"]),
            fingerprint=frozenset(state["fingerprint"]),
            opened_at=state["opened_at"],
            last_seen=state["last_seen"],
            windows=int(state.get("windows", 1)),
            healthy_streak=int(state.get("healthy_streak", 0)),
            top=[(str(n), float(s)) for n, s in state.get("top", [])],
            status=state.get("status", "open"),
            scores=dict(state.get("scores", {})),
            drift_events=int(state.get("drift_events", 0)),
        )


class JsonlIncidentSink:
    """Append one JSON line per lifecycle transition."""

    def __init__(self, path):
        from pathlib import Path

        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, event: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **event}) + "\n")


class StdoutIncidentSink:
    def emit(self, event: dict) -> None:
        top1 = event["top"][0][0] if event.get("top") else "-"
        print(
            f"[incident] {event['event']} {event['incident_id']} "
            f"windows={event['windows']} top1={top1} "
            f"at={event['last_seen']}"
        )


class WebhookIncidentSink:
    """JSON POST per transition with a bounded retry queue, never raises.

    The sink runs ON the engine thread, so every POST is bounded by an
    EXPLICIT timeout (``StreamConfig.webhook_timeout_seconds``) applied
    to connect AND read — a hung endpoint costs at most ``timeout``
    per transition, it cannot stall windowing/ranking indefinitely.

    Delivery is no longer fire-and-forget: a failed POST parks the
    event in a bounded FIFO with a per-event backoff schedule (the
    unified WEBHOOK_POLICY from chaos.retry — exponential, jittered)
    and re-sends due entries on later ``emit``/``flush`` calls, WITHOUT
    ever sleeping on the engine thread. An event is dropped — and
    counted in ``microrank_webhook_dropped_total`` — only after
    ``max_attempts`` failed sends, or when the full queue evicts its
    oldest entry. The payload enriches the raw lifecycle event with the
    top-k ``suspects``. Each send passes the ``webhook`` chaos seam.
    """

    def __init__(
        self,
        url: str,
        timeout: float = 2.0,
        max_attempts: int = 4,
        max_queue: int = 64,
        clock=time.monotonic,
    ):
        from collections import deque

        self.url = url
        self.timeout = max(0.1, float(timeout))
        self.max_attempts = max(1, int(max_attempts))
        self.max_queue = max(1, int(max_queue))
        self.clock = clock
        from ..chaos.retry import WEBHOOK_POLICY

        self.policy = WEBHOOK_POLICY
        self.failures = 0   # failed POST attempts (cumulative)
        self.delivered = 0
        self.dropped = 0
        self._queue = deque()   # entries: [event, attempts, next_due]

    def emit(self, event: dict) -> None:
        self.flush()
        self._attempt(event, attempts=0)

    def flush(self) -> None:
        """Re-send every queued event whose backoff elapsed (called on
        each lifecycle transition and at engine drain; one pass, no
        sleeping — not-yet-due entries keep waiting)."""
        now = self.clock()
        for _ in range(len(self._queue)):
            entry = self._queue.popleft()
            event, attempts, due = entry
            if due > now:
                self._queue.append(entry)
                continue
            self._attempt(event, attempts)

    def pending(self) -> int:
        return len(self._queue)

    def _attempt(self, event: dict, attempts: int) -> None:
        from ..chaos.retry import record_attempt

        if attempts > 0:
            record_attempt("webhook")
        if self._send(event):
            self.delivered += 1
            return
        self.failures += 1
        attempts += 1
        if attempts >= self.max_attempts:
            self._drop(event, f"{attempts} failed attempts")
            return
        due = self.clock() + self.policy.delay(attempts, random)
        if len(self._queue) >= self.max_queue:
            oldest = self._queue.popleft()
            self._drop(oldest[0], "retry queue full")
        self._queue.append([event, attempts, due])

    def _drop(self, event: dict, why: str) -> None:
        from ..obs.metrics import record_webhook_dropped

        self.dropped += 1
        record_webhook_dropped()
        log.warning(
            "incident webhook event %s dropped (%s): %s",
            event.get("event"), why, self.url,
        )

    def _send(self, event: dict) -> bool:
        import urllib.request

        from ..chaos.faults import maybe_inject

        req = urllib.request.Request(
            self.url,
            data=json.dumps(event).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            # Chaos seam: hang sleeps (bounded by the plan's value),
            # http_5xx / fail raise; both exercise the retry queue.
            maybe_inject("webhook")
            # The explicit timeout bounds the blocking socket ops
            # (connect + response read) — urlopen with no timeout would
            # inherit the global default of None and hang forever on a
            # wedged endpoint.
            urllib.request.urlopen(req, timeout=self.timeout).close()
            return True
        except Exception as e:  # noqa: BLE001 - alerting must not kill RCA
            log.warning("incident webhook failed (%s): %s", self.url, e)
            return False


class IncidentTracker:
    """Window-ordered incident state machine over ranked/healthy windows."""

    def __init__(
        self,
        top_k: int = 5,
        resolve_after: int = 2,
        cooldown_windows: int = 2,
        jaccard: float = 0.5,
        score_drift: float = 0.25,
        sinks: Optional[List] = None,
    ):
        self.top_k = int(top_k)
        self.resolve_after = max(1, int(resolve_after))
        self.cooldown_windows = max(0, int(cooldown_windows))
        self.jaccard = float(jaccard)
        # Drift-aware dedup threshold (L-inf over normalized suspect
        # scores); <= 0 disables drift flagging.
        self.score_drift = float(score_drift)
        self.sinks = list(sinks or [])
        self._open: Dict[FrozenSet[str], Incident] = {}
        self._cooldown: Dict[FrozenSet[str], int] = {}  # fp -> window#
        self._window_no = 0
        self._ids = 0
        self.opened = 0
        self.resolved = 0
        self.suppressed = 0

    # ------------------------------------------------------------- state
    @property
    def has_open(self) -> bool:
        return bool(self._open)

    def open_incidents(self) -> List[Incident]:
        return list(self._open.values())

    # ------------------------------------------------------- durability
    def to_state(self) -> dict:
        """JSON-serializable tracker state (chaos.checkpoint): open
        incidents, cooldown table, and the id/window counters — a
        restored tracker dedups the restarted run's abnormal windows
        into the SAME incidents instead of re-opening them."""
        return {
            "open": [inc.to_state() for inc in self._open.values()],
            "cooldown": [
                [sorted(fp), int(n)] for fp, n in self._cooldown.items()
            ],
            "window_no": self._window_no,
            "ids": self._ids,
            "opened": self.opened,
            "resolved": self.resolved,
            "suppressed": self.suppressed,
        }

    def restore(self, state: dict) -> None:
        """Overwrite lifecycle state from a checkpoint. No events are
        emitted — the sinks already saw these transitions in the run
        that wrote the checkpoint. Parse-then-commit: every field is
        decoded (and may raise) BEFORE any tracker state mutates, so a
        malformed checkpoint can never leave a half-restored
        lifecycle."""
        if not isinstance(state, dict) or "open" not in state:
            raise ValueError(
                f"not an incident-tracker state (keys "
                f"{sorted(state) if isinstance(state, dict) else state})"
            )
        open_incidents = [
            Incident.from_state(s) for s in state.get("open", [])
        ]
        cooldown = {
            frozenset(fp): int(n)
            for fp, n in state.get("cooldown", [])
        }
        window_no = int(state.get("window_no", 0))
        ids = int(state.get("ids", 0))
        opened = int(state.get("opened", 0))
        resolved = int(state.get("resolved", 0))
        suppressed = int(state.get("suppressed", 0))
        self._open = {inc.fingerprint: inc for inc in open_incidents}
        self._cooldown = cooldown
        self._window_no = window_no
        self._ids = ids
        self.opened = opened
        self.resolved = resolved
        self.suppressed = suppressed

    def reset(self) -> None:
        """Back to a cold lifecycle (the engine's whole-checkpoint
        rejection path); sinks and thresholds stay."""
        self._open = {}
        self._cooldown = {}
        self._window_no = 0
        self._ids = 0
        self.opened = 0
        self.resolved = 0
        self.suppressed = 0

    # ------------------------------------------------------------ intake
    def observe_ranked(
        self,
        window_start: str,
        ranking: Sequence[Tuple[str, float]],
        on_open=None,
    ) -> Optional[Incident]:
        """One abnormal RANKED window; returns the incident it mapped to
        (None when suppressed by cooldown).

        ``on_open(incident) -> dict``: called once when a NEW incident
        is about to open, BEFORE its ``incident_open`` event is emitted;
        the returned fields merge into that event (the stream engine
        attaches the explain-bundle path this way, so webhooks see it in
        the open payload itself). A failing hook is contained."""
        self._window_no += 1
        fp = ranking_fingerprint(ranking, self.top_k)
        from ..obs.metrics import record_incident

        # Dedup against open incidents: exact match, else best overlap.
        match = self._open.get(fp)
        if match is None and self._open:
            best = max(
                self._open.values(),
                key=lambda inc: _jaccard(fp, inc.fingerprint),
            )
            if _jaccard(fp, best.fingerprint) >= self.jaccard:
                match = best
        if match is not None:
            # Drift-aware dedup: same (or overlapping) suspect SET, but
            # the normalized score vector moved past the threshold —
            # the fault is evolving (a second root cause joining, the
            # dominant suspect changing); the update says so instead of
            # silently absorbing the window.
            new_scores = suspect_scores(ranking, match.fingerprint | fp)
            drift = score_drift(match.scores, new_scores)
            drifted = bool(
                self.score_drift > 0 and drift >= self.score_drift
            )
            match.windows += 1
            match.healthy_streak = 0
            match.last_seen = window_start
            match.top = list(ranking)
            match.scores = new_scores
            if drifted:
                match.drift_events += 1
            record_incident("update")
            self._emit(
                match.to_event(
                    "update", drifted=drifted, score_drift=round(drift, 4)
                )
            )
            return match
        # Cooldown: the same (or overlapping) fingerprint resolved
        # within the last cooldown_windows windows — suppress, count.
        for cfp, resolved_no in list(self._cooldown.items()):
            if self._window_no - resolved_no > self.cooldown_windows:
                del self._cooldown[cfp]
            elif cfp == fp or _jaccard(fp, cfp) >= self.jaccard:
                self.suppressed += 1
                record_incident("suppressed")
                log.info(
                    "incident suppressed (cooldown): %s", sorted(fp)
                )
                return None
        self._ids += 1
        inc = Incident(
            incident_id=f"inc-{self._ids}",
            fingerprint=fp,
            opened_at=window_start,
            last_seen=window_start,
            top=list(ranking),
            scores=suspect_scores(ranking, fp),
        )
        self._open[fp] = inc
        self.opened += 1
        extra = {}
        if on_open is not None:
            try:
                extra = on_open(inc) or {}
            except Exception as e:  # noqa: BLE001 - provenance must not
                # block alerting; the open event just lacks the extras.
                log.warning("incident on_open hook failed: %s", e)
        record_incident("open", open_now=len(self._open))
        # Enrichment: the tie-aware top-k suspects WITH scores at the
        # fingerprint cut, explicit in every open payload (the full
        # ``top`` list stays for context).
        self._emit(
            inc.to_event(
                "open",
                suspects=[
                    [str(n), float(s)]
                    for n, s in inc.top[: self.top_k]
                ],
                **extra,
            )
        )
        return inc

    def observe_healthy(self, window_start: str) -> List[Incident]:
        """One healthy (clean/empty/skipped) window; returns incidents
        it resolved."""
        self._window_no += 1
        resolved: List[Incident] = []
        from ..obs.metrics import record_incident

        for fp, inc in list(self._open.items()):
            inc.healthy_streak += 1
            if inc.healthy_streak >= self.resolve_after:
                inc.status = "resolved"
                del self._open[fp]
                self._cooldown[fp] = self._window_no
                self.resolved += 1
                resolved.append(inc)
                record_incident("resolve", open_now=len(self._open))
                self._emit(
                    inc.to_event("resolve", resolved_at=window_start)
                )
        return resolved

    # ------------------------------------------------------------- sinks
    def _emit(self, event: dict) -> None:
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception as e:  # noqa: BLE001 - sink faults stay local
                log.warning(
                    "incident sink %s failed: %s", type(sink).__name__, e
                )
