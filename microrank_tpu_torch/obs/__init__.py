"""Run telemetry (counterpart of part of ``microrank_tpu/obs``): the
metrics registry and the ported lanes' metric set, the per-run JSONL
journal, the host-contention sentinel it samples, and the HTTP metrics
endpoint (``server``, imported where it is started).

The JAX package's span tracer, flight recorder, profiler sessions and
fleet plane are not ported (ROADMAP.md 'Port queue' item 11).
"""

from .host import ContentionSentinel
from .journal import JOURNAL_NAME, RunJournal, read_journal
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    diff_registries,
    get_registry,
    merge_registries,
    registry_from_json,
    set_registry,
)

__all__ = [
    "ContentionSentinel",
    "Counter",
    "Gauge",
    "Histogram",
    "JOURNAL_NAME",
    "MetricsRegistry",
    "RunJournal",
    "diff_registries",
    "get_registry",
    "merge_registries",
    "read_journal",
    "registry_from_json",
    "set_registry",
]
