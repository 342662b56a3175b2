"""The stream lane (counterpart of ``microrank_tpu/stream/``): span
sources, the event-time windower, online SLO baselines, the incident
lifecycle, the build pool and the continuous engine, over span tables."""

from .baseline import OnlineBaseline, P2Quantile
from .engine import INCIDENT_LOG_NAME, StreamEngine, StreamSummary, run_stream
from .incidents import (
    Incident,
    IncidentTracker,
    JsonlIncidentSink,
    StdoutIncidentSink,
    WebhookIncidentSink,
    ranking_fingerprint,
)
from .pool import BuildWorkerPool
from .sources import FileTailSource, ReplaySource, SyntheticSource
from .window import ClosedWindow, SpanBatch, StreamWindower

__all__ = [
    "BuildWorkerPool",
    "ClosedWindow",
    "FileTailSource",
    "INCIDENT_LOG_NAME",
    "Incident",
    "IncidentTracker",
    "JsonlIncidentSink",
    "OnlineBaseline",
    "P2Quantile",
    "ReplaySource",
    "SpanBatch",
    "StdoutIncidentSink",
    "StreamEngine",
    "StreamSummary",
    "StreamWindower",
    "SyntheticSource",
    "WebhookIncidentSink",
    "ranking_fingerprint",
    "run_stream",
]
