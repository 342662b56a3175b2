"""Atomic file writes: tmp + fsync + rename (counterpart of
``microrank_tpu/utils/atomic.py``, without its fault-injection seam).

A kill between ``open()`` and ``close()`` of a plain ``write_text``
leaves a torn file, half a JSON object where ``metrics.json`` used to
be. Files a later process reads back go through here instead:

1. write the payload to ``<name>.tmp.<pid>`` in the same directory
   (``os.replace`` is atomic only within a filesystem);
2. flush + fsync the tmp file;
3. ``os.replace`` onto the final name (readers see the old complete
   file or the new complete file, never a mix);
4. best-effort fsync of the parent directory.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def atomic_write_bytes(path, data: bytes) -> Path:
    """Atomically replace ``path`` with ``data``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.name}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return path


def atomic_write_text(path, text: str) -> Path:
    return atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path, obj, indent: int = 2) -> Path:
    return atomic_write_text(path, json.dumps(obj, indent=indent))


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
