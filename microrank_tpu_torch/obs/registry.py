"""Low-overhead, thread-safe metrics registry (counterpart of
``microrank_tpu/obs/registry.py``, with the same Prometheus text and the
same JSON snapshot schema, so either package's ``cli stats`` reads the
other's ``metrics.json``).

Every subsystem records into process-global Counter / Gauge / Histogram
metrics, exposed two ways:

* Prometheus text exposition (``MetricsRegistry.to_prometheus``), served
  live by ``obs.server`` behind the CLI's ``--metrics-port`` and
  re-emitted offline by ``cli stats``;
* a JSON snapshot (``to_json`` / ``registry_from_json``), written to the
  run's output directory so a finished run's metrics survive the
  process (``cli stats out_dir/`` round-trips it back to text form).

Design constraints: one ``threading.Lock`` per metric, held only for a
dict update (the window loop's stage and fetch workers and the main
thread record concurrently); label values are joined into a tuple key
at call time, and no string is formatted until exposition; registration
is idempotent (``registry.counter(name, ...)`` returns the existing
metric), so call sites look metrics up by name.
"""

from __future__ import annotations

import json
import math
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.atomic import atomic_write_text

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "registry_from_json",
    "diff_registries",
    "merge_registries",
]

# Latency-shaped default buckets (seconds): 100 us .. ~100 s.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
)

_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(value: str) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(value))


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers bare, +Inf spelled out."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Metric:
    """Shared label-keyed storage. Subclasses define the sample shape."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [
            f'{n}="{_escape_label(v)}"'
            for n, v in zip(self.labelnames, key)
        ]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    # -- serialization ---------------------------------------------------
    def samples(self) -> List[dict]:
        with self._lock:
            items = list(self._values.items())
        return [
            {"labels": dict(zip(self.labelnames, key)), "value": val}
            for key, val in items
        ]

    def to_json(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "samples": self.samples(),
        }

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items:
            lines.append(f"{self.name}{self._label_str(key)} {_fmt(val)}")
        return lines


class Counter(_Metric):
    """Monotonically increasing count (increments may be fractional)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """A value that goes up and down (queue depth, load average)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs  # +Inf is implicit

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = self._values[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            # First bucket whose bound >= v (linear scan: bucket lists
            # are short and this stays allocation-free).
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            state["counts"][i] += 1
            state["sum"] += v
            state["count"] += 1

    def snapshot(self, **labels: str) -> Optional[dict]:
        with self._lock:
            state = self._values.get(self._key(labels))
            if state is None:
                return None
            return {
                "counts": list(state["counts"]),
                "sum": state["sum"],
                "count": state["count"],
            }

    def samples(self) -> List[dict]:
        with self._lock:
            items = list(self._values.items())
        out = []
        for key, st in items:
            out.append(
                {
                    "labels": dict(zip(self.labelnames, key)),
                    "buckets": list(st["counts"]),
                    "sum": st["sum"],
                    "count": st["count"],
                }
            )
        return out

    def to_json(self) -> dict:
        d = super().to_json()
        d["bucket_bounds"] = list(self.buckets)
        return d

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            items = sorted(self._values.items())
        for key, st in items:
            cum = 0
            for bound, n in zip(
                list(self.buckets) + [math.inf], st["counts"]
            ):
                cum += n
                extra = f'le="{_fmt(bound)}"'
                lines.append(
                    f"{self.name}_bucket{self._label_str(key, extra)} {cum}"
                )
            lines.append(
                f"{self.name}_sum{self._label_str(key)} {_fmt(st['sum'])}"
            )
            lines.append(
                f"{self.name}_count{self._label_str(key)} {st['count']}"
            )
        return lines


class MetricsRegistry:
    """Process-global (or test-local) collection of named metrics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # -- exposition ------------------------------------------------------
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self.metrics():
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        return {
            "ts": time.time(),
            "metrics": {m.name: m.to_json() for m in self.metrics()},
        }

    def write_snapshot(self, out_dir) -> None:
        """Persist both exposition forms into a run's output directory
        (``metrics.json`` + ``metrics.prom``) for offline ``cli stats``.
        Atomic (tmp + fsync + rename): a kill mid-write must not leave a
        torn snapshot that poisons the next ``cli stats``."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        atomic_write_text(
            out / "metrics.json", json.dumps(self.to_json(), indent=2)
        )
        atomic_write_text(out / "metrics.prom", self.to_prometheus())


def registry_from_json(data: dict) -> MetricsRegistry:
    """Rebuild a registry from a ``to_json`` snapshot (``cli stats``)."""
    reg = MetricsRegistry()
    for name, md in data.get("metrics", {}).items():
        labelnames = tuple(md.get("labelnames", ()))
        kind = md.get("type")
        if kind == "counter":
            c = reg.counter(name, md.get("help", ""), labelnames)
            for s in md.get("samples", ()):
                c.inc(float(s["value"]), **s.get("labels", {}))
        elif kind == "gauge":
            g = reg.gauge(name, md.get("help", ""), labelnames)
            for s in md.get("samples", ()):
                g.set(float(s["value"]), **s.get("labels", {}))
        elif kind == "histogram":
            h = reg.histogram(
                name,
                md.get("help", ""),
                labelnames,
                buckets=md.get("bucket_bounds", DEFAULT_BUCKETS),
            )
            for s in md.get("samples", ()):
                key = h._key(s.get("labels", {}))
                with h._lock:
                    h._values[key] = {
                        "counts": list(s["buckets"]),
                        "sum": float(s["sum"]),
                        "count": int(s["count"]),
                    }
        else:  # unknown kinds round-trip as gauges of their raw samples
            g = reg.gauge(name, md.get("help", ""), labelnames)
            for s in md.get("samples", ()):
                if isinstance(s.get("value"), (int, float)):
                    g.set(float(s["value"]), **s.get("labels", {}))
    return reg


def diff_registries(
    before: MetricsRegistry, after: MetricsRegistry
) -> MetricsRegistry:
    """``after - before`` as a new registry (``cli stats --diff``).

    Counters and histogram bucket counts/sums subtract per label set
    (clamped at zero — a counter that went DOWN means the process
    restarted between snapshots, and a negative "delta" would be
    noise, not information). Gauges are point-in-time readings, so the
    diff keeps the ``after`` value. Metrics present only in ``after``
    diff against zero; metrics that disappeared are dropped.
    """
    out = MetricsRegistry()
    for m in after.metrics():
        prev = before.get(m.name)
        prev_ok = prev is not None and type(prev) is type(m)
        if isinstance(m, Counter):
            c = out.counter(m.name, m.help, m.labelnames)
            for s in m.samples():
                base = prev.value(**s["labels"]) if prev_ok else 0.0
                c.inc(max(0.0, float(s["value"]) - base), **s["labels"])
        elif isinstance(m, Histogram):
            same_bounds = prev_ok and prev.buckets == m.buckets
            h = out.histogram(m.name, m.help, m.labelnames, m.buckets)
            for s in m.samples():
                p = prev.snapshot(**s["labels"]) if same_bounds else None
                if p is None:
                    p = {"counts": [0] * len(s["buckets"]), "sum": 0.0,
                         "count": 0}
                key = h._key(s["labels"])
                with h._lock:
                    h._values[key] = {
                        "counts": [
                            max(0, a - b)
                            for a, b in zip(s["buckets"], p["counts"])
                        ],
                        "sum": max(0.0, s["sum"] - p["sum"]),
                        "count": max(0, s["count"] - p["count"]),
                    }
        else:  # gauges (and unknown kinds): the after reading stands
            g = out.gauge(m.name, m.help, m.labelnames)
            for s in m.samples():
                if isinstance(s.get("value"), (int, float)):
                    g.set(float(s["value"]), **s["labels"])
    return out


def merge_registries(
    sources: Sequence[Tuple[str, MetricsRegistry]],
) -> MetricsRegistry:
    """Federate named per-host registries into one registry
    (``diff_registries``'s sibling; ``cli stats --merge``, and the JAX
    package's fleet plane's merge law).

    ``sources`` is an ordered ``(host_name, registry)`` sequence. The
    laws, chosen so merging K event-stream shards reproduces the
    single-registry run exactly:

    * **counters** sum per label set — increments are increments no
      matter which host recorded them;
    * **histograms** sum bucket-wise per label set (identical bucket
      bounds required — every host runs the same catalog; a source
      whose bounds differ is skipped rather than mis-binned);
    * **gauges** are point-in-time per-host readings that do NOT sum:
      each source's reading is kept under a prepended ``host`` label
      (last writer per (host, labels) wins in source order). A gauge
      already host-labeled (the coordinator's per-host breakdowns)
      keeps its shape, samples unioned.

    A source whose metric shape conflicts (same name, different kind or
    labelnames) is skipped for that metric: torn telemetry must never
    crash the merge.
    """
    out = MetricsRegistry()
    for host, reg in sources:
        for m in reg.metrics():
            try:
                if isinstance(m, Counter):
                    c = out.counter(m.name, m.help, m.labelnames)
                    for s in m.samples():
                        v = float(s["value"])
                        if v > 0:
                            c.inc(v, **s["labels"])
                elif isinstance(m, Histogram):
                    h = out.histogram(
                        m.name, m.help, m.labelnames, m.buckets
                    )
                    if h.buckets != m.buckets:
                        continue
                    for s in m.samples():
                        key = h._key(s["labels"])
                        with h._lock:
                            st = h._values.get(key)
                            if st is None:
                                st = h._values[key] = {
                                    "counts": [0] * len(s["buckets"]),
                                    "sum": 0.0,
                                    "count": 0,
                                }
                            st["counts"] = [
                                a + b
                                for a, b in zip(st["counts"], s["buckets"])
                            ]
                            st["sum"] += float(s["sum"])
                            st["count"] += int(s["count"])
                elif isinstance(m, Gauge):
                    if "host" in m.labelnames:
                        g = out.gauge(m.name, m.help, m.labelnames)
                        for s in m.samples():
                            g.set(float(s["value"]), **s["labels"])
                    else:
                        g = out.gauge(
                            m.name, m.help, ("host",) + m.labelnames
                        )
                        for s in m.samples():
                            g.set(
                                float(s["value"]),
                                host=host,
                                **s["labels"],
                            )
            except (ValueError, TypeError):
                # Shape conflict or torn sample: skip this source's
                # metric, keep merging the rest.
                continue
    return out


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-global registry every subsystem records into."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swap the process-global registry (tests install a fresh one)."""
    global _default
    with _default_lock:
        _default = registry
