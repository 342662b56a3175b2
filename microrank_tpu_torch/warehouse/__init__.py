"""Trace warehouse: a tiered columnar span store and time-travel RCA
(counterpart of ``microrank_tpu/warehouse/``).

The stream engine feeds it when a window seals; every stored window
carries its own detection context (the op vocab and SLO baseline
snapshot, the admission counters), so any time range re-ranks later
with that context.

Tiers:

* **hot**: sealed windows in memory, flushed at every drained
  checkpoint boundary;
* **warm**: one dictionary-compressed ``seg-<start>-<end>.npz`` a
  window: the admitted span table plus, for ranked windows, the packed
  rank blob (``rank_backends.blob``): replay is a blob load and a
  router dispatch, no parse and no build;
* **cold**: compacted multi-window ``cold-<start>-<end>.npz`` segments,
  with optional retention.

A checkpoint-style manifest (version, sha256, atomic seal) indexes the
segments; a corrupt one is rejected whole and rebuilt by re-scanning
the segment files. The seal order is segment data, then the
``warehouse_seal`` chaos seam, then the manifest: a crash between the
segment flush and the checkpoint neither loses nor duplicates spans on
``--resume``.
"""

from .manifest import (
    MANIFEST_NAME,
    WAREHOUSE_DIR,
    WAREHOUSE_VERSION,
    WarehouseError,
    load_manifest,
    rescan_segments,
    seal_manifest,
)
from .replay import parse_time_range, replay_range
from .retro import RETRO_MATRIX_NAME, render_retro_table, run_retro
from .segment import (
    StoredWindow,
    decode_table,
    encode_table,
    load_segment,
    unpack_graph_blob_host,
    write_segment,
)
from .store import TraceWarehouse, load_warehouse_table, resolve_warehouse_dir

__all__ = [
    "MANIFEST_NAME",
    "RETRO_MATRIX_NAME",
    "StoredWindow",
    "TraceWarehouse",
    "WAREHOUSE_DIR",
    "WAREHOUSE_VERSION",
    "WarehouseError",
    "decode_table",
    "encode_table",
    "load_manifest",
    "load_segment",
    "load_warehouse_table",
    "parse_time_range",
    "render_retro_table",
    "replay_range",
    "rescan_segments",
    "resolve_warehouse_dir",
    "run_retro",
    "seal_manifest",
    "unpack_graph_blob_host",
    "write_segment",
]
