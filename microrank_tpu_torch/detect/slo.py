"""SLO statistic parsing (the pandas-free part of
``microrank_tpu/detect/slo.py``; the native lane fits its baseline in
``graph.table_ops.compute_slo_from_table``)."""

from __future__ import annotations


def slo_quantile(stat: str) -> float:
    """Parse a percentile SLO statistic: "p90" -> 0.9, "p99.9" -> 0.999.

    Raises ValueError for anything that is not p<number> in (0, 100].
    """
    if not stat.startswith("p"):
        raise ValueError(f"unknown SLO statistic {stat!r}")
    try:
        pct = float(stat[1:])
    except ValueError:
        raise ValueError(f"unknown SLO statistic {stat!r}") from None
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"SLO percentile out of range: {stat!r}")
    return pct / 100.0
