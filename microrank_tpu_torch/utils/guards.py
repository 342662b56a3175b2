"""Device ownership: the one thread that issues work to the card
(counterpart of the owner check in ``microrank_tpu/utils/guards.py``).

Every thread that dispatches claims the card when it starts: serve's
batch scheduler, a solo stream engine, a co-deployed
``sched.DeviceScheduler``, the table lane's run (its stage worker
authorized as its delegate), the accuracy harness, and a solo
warehouse replay or retro. The seams that launch rank programs assert
it: the router's ``rank_batch`` and ``rank_fused`` (every serve,
stream, replay and warmup dispatch) and ``blob.stage_rank_window`` (the
checked, explained, all-methods and table-lane programs). Ownership is
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
_authorized: set = set()   # delegate threads of the current owner


class DeviceOwnershipError(RuntimeError):
    """A device seam ran on a thread other than the card's owner."""


def claim_device_owner(role: str) -> None:
    """Declare the current thread the card's owner."""
    global _owner, _owner_role
    with _lock:
        _owner = threading.current_thread()
        _owner_role = role
        _authorized.clear()


def authorize_device_thread() -> None:
    """Register the current thread as the owner's delegate (the table
    lane's stage worker, which issues the owner's windows on a stream of
    its own), until the next claim."""
    with _lock:
        _authorized.add(threading.current_thread())


def release_device_owner() -> None:
    global _owner, _owner_role
    with _lock:
        _owner = None
        _owner_role = None
        _authorized.clear()


def assert_device_owner(seam: str) -> None:
    """Raise unless no live owner is claimed or the current thread is it."""
    me = threading.current_thread()
    with _lock:
        owner, role = _owner, _owner_role
        delegate = me in _authorized
    if owner is not None and owner.is_alive() and me is not owner and not delegate:
        raise DeviceOwnershipError(
            f"device seam `{seam}` entered on thread "
            f"{threading.current_thread().name!r} but the card's owner is {role!r}: "
            "work for the card must run on the owner's thread"
        )
