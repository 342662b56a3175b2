from .synthetic import (
    GiantWindow,
    SyntheticConfig,
    SyntheticTimeline,
    generate_case,
    generate_case_with_spans,
    generate_timeline,
    generate_timeline_with_spans,
    giant_window,
)

__all__ = [
    "GiantWindow",
    "SyntheticConfig",
    "SyntheticTimeline",
    "generate_case",
    "generate_case_with_spans",
    "generate_timeline",
    "generate_timeline_with_spans",
    "giant_window",
]
