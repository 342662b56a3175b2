"""Checkpoint / resume (counterpart of
``microrank_tpu/pipeline/checkpoint.py``).

The window analysis is stateless per window, so the state worth keeping
is the SLO baseline (an npz of the vocab and the per-op stats) and the
sliding-window loop's cursor, which lets a long replay resume where its
last emitted window left off after a restart.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..graph.structures import SloBaseline
from ..io.interning import Vocab


def save_slo(path, vocab: Vocab, baseline: SloBaseline) -> None:
    np.savez_compressed(
        path,
        names=np.asarray(vocab.names, dtype=object),
        mean_ms=baseline.mean_ms,
        std_ms=baseline.std_ms,
    )


def load_slo(path) -> Tuple[Vocab, SloBaseline]:
    with np.load(path, allow_pickle=True) as z:
        vocab = Vocab([str(n) for n in z["names"]])
        baseline = SloBaseline(
            mean_ms=z["mean_ms"].astype(np.float32),
            std_ms=z["std_ms"].astype(np.float32),
        )
    return vocab, baseline


class WindowCursor:
    """Persisted position of the sliding-window loop (ISO-8601 string)."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self) -> Optional[str]:
        if not self.path.exists():
            return None
        try:
            return json.loads(self.path.read_text()).get("current_time")
        except (json.JSONDecodeError, OSError):
            return None

    def save(self, current_time: str) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({"current_time": current_time}))

    def clear(self) -> None:
        if self.path.exists():
            self.path.unlink()
