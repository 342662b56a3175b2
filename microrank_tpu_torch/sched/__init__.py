"""The device scheduler (counterpart of ``microrank_tpu/sched/``): one
parked-window store for every lane (serve, stream, and the warehouse's
backfill replay) and the consumer thread that owns the card when lanes
are co-deployed."""

from .scheduler import DeviceScheduler
from .store import (
    LANE_BACKFILL,
    LANE_INCIDENT,
    LANE_NAMES,
    LANE_SERVE,
    ParkedEntry,
    ParkedWindowStore,
    TokenBucket,
    WeightedFairQueue,
)

__all__ = [
    "DeviceScheduler",
    "LANE_BACKFILL",
    "LANE_INCIDENT",
    "LANE_NAMES",
    "LANE_SERVE",
    "ParkedEntry",
    "ParkedWindowStore",
    "TokenBucket",
    "WeightedFairQueue",
]
