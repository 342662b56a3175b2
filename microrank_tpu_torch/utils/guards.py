"""Device ownership: the one thread that issues work to the card
(counterpart of the owner check in ``microrank_tpu/utils/guards.py``).

Serve's batch scheduler, a solo stream engine and a co-deployed
``sched.DeviceScheduler`` each claim the card for their thread when
they start. The seams that launch work on the card assert it: the
router's ``rank_batch`` and ``rank_fused`` (every serve, stream and
warmup dispatch) and serve's explained program. Ownership is
process-wide and re-claimable: the latest claim wins, so it follows the
active lane, and an owner whose thread has ended holds nothing (a
finished service leaves the card to whoever calls next). Unlike the
JAX package's sanitizer-armed check, this one is always on.
"""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_owner: Optional[threading.Thread] = None
_owner_role: Optional[str] = None


class DeviceOwnershipError(RuntimeError):
    """A device seam ran on a thread other than the card's owner."""


def claim_device_owner(role: str) -> None:
    """Declare the current thread the card's owner."""
    global _owner, _owner_role
    with _lock:
        _owner = threading.current_thread()
        _owner_role = role


def release_device_owner() -> None:
    global _owner, _owner_role
    with _lock:
        _owner = None
        _owner_role = None


def assert_device_owner(seam: str) -> None:
    """Raise unless no live owner is claimed or the current thread is it."""
    with _lock:
        owner, role = _owner, _owner_role
    if owner is not None and owner.is_alive() and threading.current_thread() is not owner:
        raise DeviceOwnershipError(
            f"device seam `{seam}` entered on thread "
            f"{threading.current_thread().name!r} but the card's owner is {role!r}: "
            "work for the card must run on the owner's thread"
        )
