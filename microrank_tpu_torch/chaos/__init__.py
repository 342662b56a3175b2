"""Crash-only machinery (counterpart of ``microrank_tpu/chaos/``):
durable checkpoints, fault injection, retries.

* ``checkpoint``: the versioned, checksummed, atomically written
  ``state.ckpt`` that makes ``cli stream --resume`` continue a killed
  run;
* ``faults``: the seeded deterministic ``FaultPlan`` every seam
  consults (``--chaos PLAN.json``);
* ``retry``: the retry policy (backoff, jitter, a per-seam circuit
  breaker) behind every retried seam.
"""

from .checkpoint import CHECKPOINT_NAME, CheckpointError, load_checkpoint, save_checkpoint
from .faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    configure_chaos,
    get_fault_plan,
    maybe_inject,
    record_injection,
    set_chaos_host,
    set_chaos_journal,
)
from .retry import (
    BUILD_POLICY,
    DEFAULT_POLICY,
    DISPATCH_POLICY,
    STREAM_DISPATCH_POLICY,
    WEBHOOK_POLICY,
    BreakerOpen,
    CircuitBreaker,
    RetryPolicy,
    get_breaker,
    record_attempt,
    reset_breakers,
    retry_call,
)

__all__ = [
    "BUILD_POLICY",
    "BreakerOpen",
    "CHECKPOINT_NAME",
    "CheckpointError",
    "CircuitBreaker",
    "DEFAULT_POLICY",
    "DISPATCH_POLICY",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "RetryPolicy",
    "STREAM_DISPATCH_POLICY",
    "WEBHOOK_POLICY",
    "configure_chaos",
    "get_breaker",
    "get_fault_plan",
    "load_checkpoint",
    "maybe_inject",
    "record_attempt",
    "record_injection",
    "reset_breakers",
    "retry_call",
    "save_checkpoint",
    "set_chaos_host",
    "set_chaos_journal",
]
