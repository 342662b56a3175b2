"""Tie-aware ranked-list agreement (a copy of
``microrank_tpu/utils/ranking_compare.py``; the port imports nothing of
the JAX package).

Two rankings from different compute paths may legally permute EXACT
ties and wobble scores by reassociation, but any non-tied positional
difference is a real disagreement:

* lengths (clamped to k) must match;
* scores must agree rank by rank within ``rtol``;
* an id mismatch at a rank is forgiven only when BOTH ids appear in the
  other list's top-k with a score tied to this rank's;
* with ``exempt_last``, the final kept rank is exempt from the
  membership rule (a near-tie straddling the cut may swap across it).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def scores_tied(a: float, b: float, rtol: float = 1e-3) -> bool:
    """Two scores tie when they agree within ``rtol`` (1e-12 floor)."""
    a, b = float(a), float(b)
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12)


def tie_aware_topk_agreement(
    ids_a: Sequence,
    scores_a: Sequence[float],
    ids_b: Sequence,
    scores_b: Sequence[float],
    k: int,
    rtol: float = 1e-3,
    exempt_last: bool = False,
) -> Tuple[bool, str]:
    """Returns (agree, reason); ``reason`` names the first failure."""
    n = min(k, len(ids_a), len(ids_b))
    if n < min(k, max(len(ids_a), len(ids_b))):
        return False, (
            f"length mismatch: {len(ids_a)} vs {len(ids_b)} entries "
            f"within top-{k}"
        )
    ids_a, ids_b = list(ids_a[:k]), list(ids_b[:k])
    for r in range(n):
        sa, sb = float(scores_a[r]), float(scores_b[r])
        if not scores_tied(sa, sb, rtol):
            return False, f"score mismatch at rank {r}: {sa} vs {sb}"
        if ids_a[r] == ids_b[r]:
            continue
        if exempt_last and r == n - 1:
            continue
        if ids_a[r] not in ids_b or ids_b[r] not in ids_a:
            return False, (
                f"id mismatch at rank {r}: {ids_a[r]!r} vs {ids_b[r]!r}"
            )
        sb_of_a = float(scores_b[ids_b.index(ids_a[r])])
        sa_of_b = float(scores_a[ids_a.index(ids_b[r])])
        for cross in (sb_of_a, sa_of_b):
            if not scores_tied(cross, sa, rtol):
                return False, f"non-tied id swap at rank {r}"
    return True, "ok"
