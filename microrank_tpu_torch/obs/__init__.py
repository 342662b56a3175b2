"""Run telemetry (counterpart of part of ``microrank_tpu/obs``): the
per-run JSONL journal and the host-contention sentinel it samples.

The JAX package's metrics registry, span tracer, flight recorder and
metrics server are not ported (ROADMAP.md 'Port queue' item 5), so the
journal's ``run_end`` event carries no ``telemetry`` snapshot.
"""

from .host import ContentionSentinel
from .journal import JOURNAL_NAME, RunJournal, read_journal

__all__ = [
    "ContentionSentinel",
    "JOURNAL_NAME",
    "RunJournal",
    "read_journal",
]
