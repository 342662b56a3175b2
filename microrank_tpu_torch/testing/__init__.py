from .synthetic import (
    GiantWindow,
    SyntheticConfig,
    generate_case,
    generate_case_with_spans,
    giant_window,
)

__all__ = [
    "GiantWindow",
    "SyntheticConfig",
    "generate_case",
    "generate_case_with_spans",
    "giant_window",
]
