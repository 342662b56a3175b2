"""Warehouse manifest: a checkpoint-style atomic seal, rejected whole on
any defect (counterpart of ``microrank_tpu/warehouse/manifest.py``, the
same envelope and file name).

The manifest is the warehouse's commit record: a segment exists once
it is listed here, whatever files sit in the directory. A torn,
truncated, version-skewed or bit-flipped manifest is rejected whole and
the store rebuilds it by re-scanning the segment files (each segment's
meta member carries its manifest row).
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import List, Optional

WAREHOUSE_VERSION = 1
WAREHOUSE_DIR = "warehouse"
MANIFEST_NAME = "manifest.json"


class WarehouseError(Exception):
    """A warehouse artifact failed validation (torn, corrupt, skewed)."""


def _digest(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def seal_manifest(warehouse_dir, payload: dict) -> Path:
    """Atomically write the manifest envelope; the caller orders this
    after the segment files (data first, the commit record last)."""
    from ..utils.atomic import atomic_write_json

    path = Path(warehouse_dir) / MANIFEST_NAME
    doc = {"version": WAREHOUSE_VERSION, "ts": time.time(), "sha256": _digest(payload),
           "payload": payload}
    atomic_write_json(path, doc)
    return path


def load_manifest(warehouse_dir) -> Optional[dict]:
    """The manifest payload, or None when none exists yet. Raises
    :class:`WarehouseError` on any defect: a manifest that cannot be
    proven intact indexes nothing."""
    path = Path(warehouse_dir) / MANIFEST_NAME
    if not path.exists():
        return None
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise WarehouseError(f"manifest unreadable: {exc}") from exc
    if not isinstance(doc, dict):
        raise WarehouseError("manifest: not an object")
    if doc.get("version") != WAREHOUSE_VERSION:
        raise WarehouseError(f"manifest: version {doc.get('version')!r} != {WAREHOUSE_VERSION}")
    payload = doc.get("payload")
    if not isinstance(payload, dict):
        raise WarehouseError("manifest: missing payload")
    if doc.get("sha256") != _digest(payload):
        raise WarehouseError("manifest: checksum mismatch")
    return payload


def rescan_segments(warehouse_dir) -> List[dict]:
    """Manifest rows rebuilt from every segment file's meta member
    (corruption recovery, adoption of orphan seals). Unreadable files
    are skipped (a torn tmp never carries a final name). Where a cold
    segment and the warm ones it compacted both survive, the cold range
    wins: listing both would count their spans twice."""
    from .segment import read_segment_meta

    root = Path(warehouse_dir)
    rows: List[dict] = []
    for path in sorted(root.glob("*.npz")):
        if ".tmp." in path.name:
            continue
        try:
            windows = read_segment_meta(path)["windows"]
        except Exception:  # noqa: BLE001 - damage, not a crash artifact
            continue
        if not windows:
            continue
        outcomes: dict = {}
        spans = 0
        for w in windows:
            outcomes[w.get("outcome", "")] = outcomes.get(w.get("outcome", ""), 0) + 1
            spans += int(w.get("spans", 0))
        rows.append({
            "file": path.name,
            "tier": "cold" if path.name.startswith("cold-") else "warm",
            "start_us": min(int(w["start_us"]) for w in windows),
            "end_us": max(int(w["end_us"]) for w in windows),
            "windows": len(windows),
            "spans": spans,
            "bytes": path.stat().st_size,
            "outcomes": outcomes,
        })
    cold = [r for r in rows if r["tier"] == "cold"]
    kept = [r for r in rows if not (r["tier"] == "warm" and any(
        c["start_us"] <= r["start_us"] and r["end_us"] <= c["end_us"] for c in cold))]
    kept.sort(key=lambda r: (r["start_us"], r["end_us"], r["file"]))
    return kept
