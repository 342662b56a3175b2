"""Host-contention sentinel: loadavg + CPU-steal sampling (counterpart
of ``microrank_tpu/obs/host.py``).

A replay timed on a busy host reads slower than the pipeline is; the
run journal samples this sentinel per window, so such a number carries
its own flag. Two signals:

* **normalized load**: 1-minute loadavg / CPU count; above ~1.2,
  runnable threads queue behind the pipeline's own (one process, a main
  thread and two workers);
* **steal fraction**: the delta of /proc/stat's ``steal`` jiffies over
  total jiffies since the previous sample, time the hypervisor ran
  someone else while this VM wanted the CPU.

Without /proc it reports loadavg only; without ``os.getloadavg`` zeros:
telemetry never takes down the pipeline. The JAX module also mirrors
each sample into the metrics registry's gauges, which this package does
not have.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

DEFAULT_LOAD_THRESHOLD = 1.2   # normalized 1-min load
DEFAULT_STEAL_THRESHOLD = 0.05  # 5% of CPU time stolen


def _read_proc_stat() -> Optional[Tuple[int, int]]:
    """(steal_jiffies, total_jiffies) from /proc/stat's cpu line."""
    try:
        with open("/proc/stat") as f:
            line = f.readline()
    except OSError:
        return None
    parts = line.split()
    if not parts or parts[0] != "cpu":
        return None
    try:
        vals = [int(x) for x in parts[1:]]
    except ValueError:
        return None
    # user nice system idle iowait irq softirq steal guest guest_nice
    steal = vals[7] if len(vals) > 7 else 0
    return steal, sum(vals)


class ContentionSentinel:
    """Stateful sampler: steal needs a previous sample to difference."""

    def __init__(
        self,
        load_threshold: float = DEFAULT_LOAD_THRESHOLD,
        steal_threshold: float = DEFAULT_STEAL_THRESHOLD,
    ):
        self.load_threshold = float(load_threshold)
        self.steal_threshold = float(steal_threshold)
        self._prev_stat = _read_proc_stat()

    def sample(self) -> Dict[str, float]:
        """One contention sample (two syscalls and one /proc read)."""
        try:
            load1, load5, _ = os.getloadavg()
        except (OSError, AttributeError):
            load1 = load5 = 0.0
        cpus = os.cpu_count() or 1
        norm = load1 / cpus

        steal_ratio = 0.0
        cur = _read_proc_stat()
        if cur is not None and self._prev_stat is not None:
            d_steal = cur[0] - self._prev_stat[0]
            d_total = cur[1] - self._prev_stat[1]
            if d_total > 0:
                steal_ratio = max(0.0, d_steal / d_total)
        self._prev_stat = cur

        contended = (
            norm > self.load_threshold
            or steal_ratio > self.steal_threshold
        )
        return {
            "load1": round(load1, 3),
            "load5": round(load5, 3),
            "cpus": cpus,
            "norm_load": round(norm, 4),
            "steal_ratio": round(steal_ratio, 5),
            "contended": bool(contended),
        }
