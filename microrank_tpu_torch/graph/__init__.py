from .structures import (
    DetectBatch,
    PartitionGraph,
    SloBaseline,
    WindowGraph,
    pad1d,
    pad_to,
)

__all__ = [
    "DetectBatch",
    "PartitionGraph",
    "SloBaseline",
    "WindowGraph",
    "pad1d",
    "pad_to",
]
