"""Durable engine state: the versioned, checksummed ``state.ckpt``
(counterpart of ``microrank_tpu/chaos/checkpoint.py``, same file name
and envelope, so either package's ``load_checkpoint`` reads the
other's file).

A restarted ``cli stream`` without it loses the online SLO baselines,
the incident lifecycle, the windower's watermark and open buffers and
the source cursor: it re-enters cold start and re-opens the incidents
it already reported. The engine rewrites one small JSON file under the
run dir at every drained window boundary, and ``cli stream --resume``
restores it.

File format (version 1)::

    {"version": 1, "ts": ..., "sha256": "<payload digest>",
     "payload": {"baseline": ..., "tracker": ..., "windower": ...,
                 "source": ..., "summary": ..., "warehouse": ...}}

The digest is over the canonical (sorted-keys) JSON of ``payload``; a
torn, bit-flipped or hand-edited file is rejected whole
(:class:`CheckpointError`) and the engine cold-starts.

Writes go through ``utils.atomic`` (tmp, fsync, rename) with the
``checkpoint`` chaos seam fired between the durable tmp write and the
rename: a kill there leaves the previous checkpoint intact.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

CHECKPOINT_VERSION = 1
CHECKPOINT_NAME = "state.ckpt"


class CheckpointError(RuntimeError):
    """Unreadable, corrupt or incompatible checkpoint: never half-loaded."""


def _digest(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def save_checkpoint(path, payload: dict) -> Path:
    """Atomically write ``payload`` as the engine checkpoint. May raise
    ``InjectedFault`` (the ``checkpoint`` seam) after the tmp write and
    before the rename; the previous checkpoint is then untouched."""
    from ..utils.atomic import atomic_write_json

    doc = {
        "version": CHECKPOINT_VERSION,
        "ts": time.time(),
        "sha256": _digest(payload),
        "payload": payload,
    }
    return atomic_write_json(path, doc, fault_seam="checkpoint")


def load_checkpoint(path) -> dict:
    """Read and verify a checkpoint; returns its payload. Raises
    :class:`CheckpointError` on any defect (missing file, torn JSON,
    wrong version, checksum mismatch)."""
    path = Path(path)
    try:
        raw = path.read_text()
    except OSError as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise CheckpointError(f"corrupt checkpoint {path} (torn JSON): {e}") from e
    if not isinstance(doc, dict) or "payload" not in doc:
        raise CheckpointError(f"malformed checkpoint {path}")
    version = doc.get("version")
    if version != CHECKPOINT_VERSION:
        raise CheckpointError(f"checkpoint {path} has version {version!r}; this build reads "
                              f"version {CHECKPOINT_VERSION}")
    payload = doc["payload"]
    if _digest(payload) != doc.get("sha256"):
        raise CheckpointError(f"checkpoint {path} failed its checksum (bit rot or a "
                              "non-atomic writer)")
    return payload
