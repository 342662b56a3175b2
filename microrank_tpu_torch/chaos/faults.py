"""The fault-injection registry: one seeded, deterministic surface
(counterpart of ``microrank_tpu/chaos/faults.py``).

A chaos scenario is one JSON document every seam consults::

    {"seed": 7, "faults": [
        {"seam": "dispatch",    "kind": "fail",    "count": 2},
        {"seam": "build",       "kind": "fail",    "after": 1, "count": 1},
        {"seam": "source_stall","kind": "stall",   "value": 200, "count": 1},
        {"seam": "webhook",     "kind": "hang",    "value": 500, "count": 1},
        {"seam": "checkpoint",  "kind": "crash",   "after": 2, "count": 1}
    ]}

Seams:

* ``dispatch`` / ``serve_dispatch``: the rank dispatch (stream /
  serve); ``fail`` raises before the router call and is retried under
  the seam's policy (``chaos.retry``) on the same device.
* ``build``: the build pool's graph preparation; ``fail`` raises in the
  worker and is retried there.
* ``fetch``: after the result fetch; ``nan`` poisons the attempt, which
  is retried on the card.
* ``source_stall`` / ``source_torn`` / ``source_rotation``: the span
  source: an extra stall, a torn tail line (the parse fails this poll,
  the data arrives whole the next), a forced cursor reset.
* ``webhook``: the incident webhook POST: ``hang`` (a bounded sleep) or
  ``http_5xx`` / ``fail`` (raised, the event parks in the retry queue).
* ``checkpoint``: the ``state.ckpt`` writer, between the durable tmp
  write and the rename; ``kill`` exits the process there.
* ``warehouse_seal``: between a flush's segment files and its manifest;
  ``kill`` exits the process there.
* ``stage:<name>``: a latency injection inside any traced span.

``source_data`` (JAX's corrupted-row kinds, generated by its pandas
``ingest.hostile.corrupt_frame``) is not ported: a plan naming it is
refused when it is loaded (ROADMAP.md, port queue item 9). The fleet's
seams (``host_kill``, ``heartbeat_drop``, ``coordinator_unreachable``)
come with the fleet.

Determinism: matching is pure event counting per seam (``after`` /
``count`` / ``every``); specs with ``prob`` < 1 draw from
``random.Random(seed)``, so one plan over one run replays the same
faults. The legacy knobs (``ServeConfig.inject_dispatch_failures``,
``ObsConfig.inject_stage_sleep_ms``) record their firings through
:func:`record_injection` too: every injected fault lands in
``microrank_fault_injections_total{seam,kind}`` and the run journal.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

log = logging.getLogger("microrank_tpu_torch.chaos")

# Kinds that unwind the seam with an InjectedFault when they fire; the
# sleeping kinds sleep here; the rest are returned to the caller to
# interpret (nan, torn_line, rotation, kill).
_RAISING_KINDS = frozenset({"fail", "crash", "http_5xx", "exception"})
_SLEEPING_KINDS = frozenset({"latency", "stall", "hang"})
# Seams whose injection is not ported, and the item that brings each.
_UNPORTED_SEAMS = {
    "source_data": "its corrupted rows come from JAX's pandas ingest.hostile.corrupt_frame: "
                   "ROADMAP.md, port queue item 9",
}


class InjectedFault(RuntimeError):
    """A fault the chaos plan injected at a seam (never a real error)."""

    def __init__(self, seam: str, kind: str = "fail"):
        super().__init__(f"chaos: injected {kind} at seam {seam!r}")
        self.seam = seam
        self.kind = kind


@dataclass
class FaultSpec:
    """One deterministic fault rule at one seam."""

    seam: str
    kind: str = "fail"
    after: int = 0          # skip this many events at the seam first
    count: int = 1          # events affected once active (-1: forever)
    every: int = 1          # affect every k-th active event
    value: float = 0.0      # milliseconds for the sleeping kinds
    prob: float = 1.0       # firing probability (seeded RNG)
    host: Optional[str] = None  # fleet scoping: fire only in this host
    _fired: int = field(default=0, repr=False)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        known = {k: d[k] for k in ("seam", "kind", "after", "count", "every", "value", "prob",
                                   "host") if k in d}
        if "seam" not in known:
            raise ValueError(f"fault spec missing 'seam': {d}")
        why = _UNPORTED_SEAMS.get(known["seam"])
        if why is not None:
            raise NotImplementedError(f"chaos seam {known['seam']!r} is not ported: {why}")
        return cls(**known)

    def decide(self, event_no: int, rng: random.Random) -> bool:
        """Does this spec fire for the seam's ``event_no``-th event
        (0-based)? Counts its firing: call once per event."""
        if event_no < self.after:
            return False
        if self.count >= 0 and self._fired >= self.count:
            return False
        if (event_no - self.after) % max(1, self.every) != 0:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self._fired += 1
        return True


class FaultPlan:
    """Seeded, deterministic fault schedule over named seams."""

    def __init__(self, specs: List[FaultSpec] = None, seed: int = 0):
        self.specs = list(specs or [])
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._events: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.injected: List[dict] = []  # what fired (tests)

    @classmethod
    def from_config(cls, chaos_config) -> Optional["FaultPlan"]:
        """The plan a ChaosConfig describes (inline ``faults`` plus an
        optional ``plan_path`` JSON file); None when disabled."""
        if chaos_config is None or not getattr(chaos_config, "enabled", False):
            return None
        specs = [FaultSpec.from_dict(dict(f)) for f in chaos_config.faults]
        seed = int(chaos_config.seed)
        if chaos_config.plan_path:
            data = json.loads(Path(chaos_config.plan_path).read_text())
            seed = int(data.get("seed", seed))
            specs.extend(FaultSpec.from_dict(f) for f in data.get("faults", []))
        return cls(specs, seed=seed)

    def fire(self, seam: str) -> Optional[dict]:
        """Count one event at ``seam``; return the firing spec's action,
        or None. At most one spec fires per event (the first in plan
        order)."""
        with self._lock:
            n = self._events.get(seam, 0)
            self._events[seam] = n + 1
            for spec in self.specs:
                if spec.host is not None and spec.host != _chaos_host:
                    continue
                if spec.seam == seam and spec.decide(n, self._rng):
                    action = {"seam": seam, "kind": spec.kind, "value": spec.value, "event": n}
                    self.injected.append(action)
                    return action
        return None


# ------------------------------------------------------- process state

_plan: Optional[FaultPlan] = None
_journal = None
_journal_lock = threading.Lock()
_chaos_host: Optional[str] = None


def set_chaos_host(host_id: Optional[str]) -> None:
    """Declare which fleet host this process is, so host-scoped specs
    (``"host": "host1"``) fire only there. Set at process start."""
    global _chaos_host
    _chaos_host = host_id


def configure_chaos(config) -> Optional[FaultPlan]:
    """Install the process fault plan from a MicroRankConfig (fresh
    counters each call: one plan per run). The stream engine and the
    serve service call it at start; a config without chaos clears it.
    A plan naming an unported seam raises here, never at the seam."""
    global _plan
    _plan = FaultPlan.from_config(getattr(config, "chaos", None))
    if _plan is not None and _plan.specs:
        log.warning("chaos armed: %d fault spec(s), seed %d: this run WILL misbehave on "
                    "purpose", len(_plan.specs), _plan.seed)
    return _plan


def get_fault_plan() -> Optional[FaultPlan]:
    return _plan


def set_chaos_journal(journal) -> None:
    """Attach a RunJournal: every injected fault becomes a
    ``fault_injected`` event beside the windows it disturbed."""
    global _journal
    with _journal_lock:
        _journal = journal


def record_injection(seam: str, kind: str, value: float = 0.0) -> None:
    """Count one injected fault (metrics and journal): the one recording
    surface of planned faults and the legacy knobs."""
    from ..obs.metrics import record_fault_injection

    record_fault_injection(seam, kind)
    with _journal_lock:
        j = _journal
    if j is not None:
        try:
            j.emit("fault_injected", seam=seam, kind=kind, value=value)
        except Exception:  # noqa: BLE001 - chaos must not add real faults
            pass


def maybe_inject(seam: str, sleep: Callable[[float], None] = time.sleep) -> Optional[dict]:
    """The one call every seam makes. Counts one event at ``seam``
    against the installed plan; a firing spec is recorded (metrics and
    journal) and then, by kind:

    * ``fail`` / ``crash`` / ``http_5xx``: raise :class:`InjectedFault`;
    * ``latency`` / ``stall`` / ``hang``: sleep ``value`` ms, return
      the action;
    * ``kill``: exit the process at once (``os._exit(137)``, SIGKILL's
      code: no drain, no final checkpoint);
    * anything else (``nan``, ``torn_line``, ``rotation``): return the
      action for the caller to interpret.

    No plan installed: one global read and return.
    """
    plan = _plan
    if plan is None:
        return None
    action = plan.fire(seam)
    if action is None:
        return None
    kind = action["kind"]
    record_injection(seam, kind, value=action.get("value", 0.0))
    log.warning("chaos: injecting %s at %s (event %d)", kind, seam, action["event"])
    if kind in _RAISING_KINDS:
        raise InjectedFault(seam, kind)
    if kind == "kill":
        os._exit(137)
    if kind in _SLEEPING_KINDS and action.get("value", 0.0) > 0:
        sleep(float(action["value"]) / 1e3)
    return action
