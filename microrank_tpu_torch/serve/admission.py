"""Admission control: a bounded count of requests in the service
(counterpart of ``microrank_tpu/serve/admission.py``).

One counter covers a request's whole residency: admitted at the
frontend, released when its response future resolves. Past
``max_depth`` the frontend answers 429 with a Retry-After priced by the
measured per-window cost; a draining service (SIGTERM) admits nothing.
"""

from __future__ import annotations

import threading


class AdmissionController:
    def __init__(self, max_depth: int, retry_after_seconds: float = 1.0):
        self.max_depth = int(max_depth)
        self.retry_after_seconds = float(retry_after_seconds)
        # HTTP threads admit, the scheduler thread releases.
        self._lock = threading.Lock()
        self._depth = 0
        self._closed = False
        # EWMA of the measured per-window service cost (seconds), fed by
        # the batcher after each device dispatch; None until the first.
        self._cost_ewma = None

    def observe_window_cost(self, seconds: float) -> None:
        """One dispatched window's measured cost, smoothed into the EWMA
        that prices Retry-After."""
        s = max(0.0, float(seconds))
        with self._lock:
            if self._cost_ewma is None:
                self._cost_ewma = s
            else:
                self._cost_ewma = 0.2 * s + 0.8 * self._cost_ewma

    def retry_after(self) -> float:
        """Seconds a 429 / 503 caller should back off: queue depth x
        measured per-window cost, floored at the configured constant
        (which is the answer until a window has been measured)."""
        with self._lock:
            if self._cost_ewma is None:
                return self.retry_after_seconds
            return max(self.retry_after_seconds, self._depth * self._cost_ewma)

    def try_admit(self) -> bool:
        """One admission slot, or False (429 / 503 at the caller)."""
        from ..obs.metrics import serve_queue_depth

        with self._lock:
            if self._closed or self._depth >= self.max_depth:
                return False
            self._depth += 1
            depth = self._depth
        serve_queue_depth().set(float(depth))
        return True

    def release(self) -> None:
        from ..obs.metrics import serve_queue_depth

        with self._lock:
            self._depth = max(0, self._depth - 1)
            depth = self._depth
        serve_queue_depth().set(float(depth))

    def close(self) -> None:
        """Stop admitting (drain); admitted requests still release."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth
