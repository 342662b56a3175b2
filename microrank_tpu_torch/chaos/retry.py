"""One retry policy for every seam: backoff, jitter and a circuit
breaker (counterpart of ``microrank_tpu/chaos/retry.py``, the same
policies, delays and breaker; a plain ``threading.Lock`` where JAX's
sanitizer tracks its locks).

* exponential backoff with jitter: ``base * 2^(attempt-1)`` capped at
  ``max_delay``, scaled by ``1 + U(0, jitter)`` drawn from the ``rng``
  the caller passes (the module's ``random`` by default, as in JAX), so
  a test that seeds one ``random.Random`` for both packages gets the
  same delays;
* a per-seam circuit breaker: ``breaker_threshold`` consecutive
  failures open it; calls then fail fast (``BreakerOpen``) until
  ``breaker_reset_s`` elapses, when one half-open probe closes it
  (success) or re-opens it (failure);
* telemetry: ``microrank_retry_attempts_total{seam}`` counts second and
  later attempts, ``microrank_retry_exhausted_total{seam}`` the calls
  that gave up, ``microrank_breaker_state{seam}`` 0 closed / 1 open /
  2 half-open.

A retry runs ``fn`` again where it ran: on the card for a dispatch. No
policy here ranks anywhere else.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

log = logging.getLogger("microrank_tpu_torch.chaos.retry")


class BreakerOpen(RuntimeError):
    """Fast fail: the seam's circuit breaker is open."""

    def __init__(self, seam: str, retry_in: float):
        super().__init__(f"circuit breaker open for seam {seam!r} "
                         f"(half-open probe in {retry_in:.1f}s)")
        self.seam = seam
        self.retry_in = retry_in


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff and breaker knobs of one seam."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5            # delay *= 1 + U(0, jitter)
    breaker_threshold: int = 8     # consecutive failures that open it
    breaker_reset_s: float = 30.0  # open -> half-open after this long
    half_open_probes: int = 1      # probes admitted half-open

    def delay(self, attempt: int, rng) -> float:
        """Backoff before the retry that follows failed ``attempt``
        (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** max(0, attempt - 1)))
        return d * (1.0 + self.jitter * rng.random())


# JAX's per-seam defaults: serve's dispatch keeps two attempts; the
# stream's dispatch has no other answer for its window, so it retries
# harder; host-side seams are cheap and retry harder still.
DISPATCH_POLICY = RetryPolicy(max_attempts=2, base_delay_s=0.02, breaker_threshold=16)
STREAM_DISPATCH_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.02, breaker_threshold=16)
BUILD_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.01)
WEBHOOK_POLICY = RetryPolicy(max_attempts=4, base_delay_s=0.25, max_delay_s=10.0,
                             breaker_threshold=6, breaker_reset_s=15.0)
DEFAULT_POLICY = RetryPolicy()

_BREAKER_STATES = {"closed": 0.0, "open": 1.0, "half_open": 2.0}


class CircuitBreaker:
    """Closed -> open after N consecutive failures -> half-open probe
    after the reset window -> closed on the probe's success."""

    def __init__(self, seam: str, policy: RetryPolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.seam = seam
        self.policy = policy
        self.clock = clock
        self.state = "closed"
        self.failures = 0              # consecutive
        self.opened_at = 0.0
        self._probes = 0
        self._lock = threading.Lock()
        self._gauge()

    def _gauge(self) -> None:
        from ..obs.metrics import record_breaker_state

        record_breaker_state(self.seam, _BREAKER_STATES[self.state])

    def allow(self) -> bool:
        """May a call proceed now? Open turns half-open once the reset
        window elapsed (the caller becomes the probe)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self.clock() - self.opened_at < self.policy.breaker_reset_s:
                    return False
                self.state = "half_open"
                self._probes = 0
                self._gauge()
                log.info("breaker %s: open -> half-open", self.seam)
            if self._probes < max(1, self.policy.half_open_probes):
                self._probes += 1
                return True
            return False

    def retry_in(self) -> float:
        with self._lock:
            if self.state != "open":
                return 0.0
            return max(0.0, self.policy.breaker_reset_s - (self.clock() - self.opened_at))

    def record_success(self) -> None:
        with self._lock:
            if self.state != "closed":
                log.info("breaker %s: %s -> closed", self.seam, self.state)
            self.state = "closed"
            self.failures = 0
            self._gauge()

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half_open" or (
                    self.state == "closed" and self.failures >= self.policy.breaker_threshold):
                self.state = "open"
                self.opened_at = self.clock()
                self._gauge()
                log.warning("breaker %s: OPEN after %d consecutive failures (half-open probe "
                            "in %.1fs)", self.seam, self.failures, self.policy.breaker_reset_s)


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(seam: str, policy: RetryPolicy = DEFAULT_POLICY) -> CircuitBreaker:
    with _breakers_lock:
        br = _breakers.get(seam)
        if br is None:
            br = _breakers[seam] = CircuitBreaker(seam, policy)
        return br


def reset_breakers() -> None:
    """Drop every breaker (tests; a fresh run starts closed)."""
    with _breakers_lock:
        _breakers.clear()


def record_attempt(seam: str) -> None:
    """Count one retry at a seam that runs its own loop (the tail
    source's re-parse, the webhook's queue)."""
    from ..obs.metrics import record_retry

    record_retry(seam)


def retry_call(seam: str, fn: Callable, policy: Optional[RetryPolicy] = None,
               sleep: Callable[[float], None] = time.sleep, rng=None,
               on_retry: Optional[Callable] = None):
    """Run ``fn()`` under the seam's retry policy.

    Raises ``BreakerOpen`` without calling ``fn`` when the breaker is
    open; otherwise up to ``max_attempts`` attempts with jittered
    backoff, each feeding the breaker a success or a failure. The last
    failure re-raises after ``microrank_retry_exhausted_total{seam}``
    is counted.
    """
    from ..obs.metrics import record_retry, record_retry_exhausted

    policy = policy or DEFAULT_POLICY
    rng = rng or random
    breaker = get_breaker(seam, policy)
    if not breaker.allow():
        raise BreakerOpen(seam, breaker.retry_in())
    attempts = max(1, int(policy.max_attempts))
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            record_retry(seam)
        try:
            out = fn()
        except BreakerOpen:
            raise
        except Exception as e:  # noqa: BLE001 - the policy decides
            breaker.record_failure()
            if attempt >= attempts or not breaker.allow():
                record_retry_exhausted(seam)
                raise
            delay = policy.delay(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            log.warning("%s attempt %d/%d failed (%s); retrying in %.0f ms", seam, attempt,
                        attempts, e, delay * 1e3)
            if delay > 0:
                sleep(delay)
            continue
        breaker.record_success()
        return out
    raise AssertionError("unreachable")  # pragma: no cover
