"""String interning (counterpart of ``microrank_tpu/io/interning.py``).

Operations and trace ids are interned to dense int32 ids host-side; the
device only ever sees ids. numpy-only: the pandas helpers of the JAX
module (``encode_series``, ``grow_encode``, ``factorize_local``) serve
the pandas lane, which this package does not have.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class Vocab:
    """Append-only string <-> int32 interner."""

    __slots__ = ("_index", "_names")

    def __init__(self, names: Optional[Iterable[str]] = None):
        self._index: Dict[str, int] = {}
        self._names: List[str] = []
        if names is not None:
            for n in names:
                self.add(n)

    def add(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            idx = len(self._names)
            self._index[name] = idx
            self._names.append(name)
        return idx

    def update(self, names: Iterable[str]) -> None:
        for n in names:
            self.add(n)

    def encode(self, names: Sequence[str], missing: int = -1) -> np.ndarray:
        """int32 ids; unseen names map to ``missing`` (no mutation)."""
        return np.asarray(
            [self._index.get(n, missing) for n in names], dtype=np.int32
        )

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self._names[int(i)] for i in ids]

    def name(self, idx: int) -> str:
        return self._names[int(idx)]

    @property
    def names(self) -> List[str]:
        return list(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name: str) -> bool:
        return name in self._index
