"""Atomic file writes: tmp + fsync + rename (counterpart of
``microrank_tpu/utils/atomic.py``).

A kill between ``open()`` and ``close()`` of a plain ``write_text``
leaves a torn file, half a JSON object where ``metrics.json`` used to
be. Files a later process reads back go through here instead:

1. write the payload to ``<name>.tmp.<pid>`` in the same directory
   (``os.replace`` is atomic only within a filesystem);
2. flush + fsync the tmp file;
3. ``os.replace`` onto the final name (readers see the old complete
   file or the new complete file, never a mix);
4. best-effort fsync of the parent directory.

``fault_seam`` names a chaos seam (``chaos.faults``) fired between
steps 2 and 3: an injected crash there leaves the previous file intact.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional


def atomic_write_bytes(path, data: bytes, fault_seam: Optional[str] = None) -> Path:
    """Atomically replace ``path`` with ``data``; ``fault_seam``: the
    chaos seam fired between the durable tmp write and the rename (an
    injected fault there leaves the tmp and the old file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.name}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    if fault_seam is not None:
        from ..chaos.faults import maybe_inject

        maybe_inject(fault_seam)  # may raise or exit: the target is intact
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return path


def atomic_write_text(path, text: str, fault_seam: Optional[str] = None) -> Path:
    return atomic_write_bytes(path, text.encode("utf-8"), fault_seam=fault_seam)


def atomic_write_json(path, obj, indent: int = 2, fault_seam: Optional[str] = None) -> Path:
    return atomic_write_text(path, json.dumps(obj, indent=indent), fault_seam=fault_seam)


def _fsync_dir(dirpath) -> None:
    """Durability of the rename itself; best-effort (some filesystems
    refuse O_RDONLY directory fds)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)
