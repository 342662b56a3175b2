"""Online SLO baselines: exponential-decay mean/std + P^2 quantiles
(counterpart of ``microrank_tpu/stream/baseline.py``, over span tables:
an op's samples are the durations of its rows, grouped by the table's
service-level op codes and keyed by name).

The batch pipelines fit the SLO baseline ONCE from a normal-period dump
(``detect.slo.compute_slo``) and never revisit it; a continuous engine
cannot — operations appear, latencies drift, and a baseline frozen at
deploy time slowly turns every window anomalous (or none). Here each
operation carries:

* exponential-decay first/second moments (``m1``/``m2``) updated from
  every HEALTHY window's per-op sample mean — mean and population std
  fall out as ``m1`` and ``sqrt(m2 - m1^2)``, matching the batch
  baseline's shape while forgetting old traffic at ``decay`` per window;
* a P^2 streaming quantile estimator (Jain & Chlamtac 1985: five
  markers, O(1) state and O(1) per sample, no sample buffer) so the
  percentile SLO statistics (``DetectorConfig.slo_stat="p99"`` etc.)
  work online too.

The estimators update ONLY on healthy windows and FREEZE while an
incident is open — otherwise the fault's own latencies would absorb
into the baseline and the detector would declare recovery by drift
rather than by the system actually recovering (the classic
self-poisoning failure of online anomaly detection).

``snapshot()`` renders the current state as the ``(Vocab, SloBaseline)``
pair the C++ detector takes (``graph.table_ops.detect_window_partition``
maps each window's svc-op codes onto the vocab by name) — streaming mode
swaps the baseline's PRODUCER, not the detector.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..detect.slo import slo_quantile
from ..graph.structures import SloBaseline
from ..io.interning import Vocab

US_PER_MS = 1000.0


class P2Quantile:
    """Jain & Chlamtac's P^2 algorithm: one quantile, five markers.

    Exact over the first five samples; afterwards the three interior
    markers track the q-, q/2- and (1+q)/2-quantile positions via
    piecewise-parabolic height adjustment. State is 15 floats per
    (operation, quantile) — the whole point next to a sample buffer.
    """

    __slots__ = ("q", "n", "heights", "pos", "desired", "incr")

    def __init__(self, q: float):
        self.q = float(q)
        self.n = 0
        self.heights: List[float] = []
        self.pos = np.arange(1.0, 6.0)
        self.desired = np.array(
            [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        )
        self.incr = np.array([0.0, q / 2, q, (1 + q) / 2, 1.0])

    def _adjust_marker(self, i: int) -> bool:
        """One P^2 marker-adjustment step for interior marker ``i``
        (the parabolic/linear height move); returns whether it moved.
        Shared verbatim by the scalar and batch update paths."""
        h = self.heights
        d = self.desired[i] - self.pos[i]
        step_up = self.pos[i + 1] - self.pos[i]
        step_dn = self.pos[i - 1] - self.pos[i]
        if not ((d >= 1 and step_up > 1) or (d <= -1 and step_dn < -1)):
            return False
        s = 1.0 if d >= 1 else -1.0
        cand = h[i] + s / (step_up - step_dn) * (
            (self.pos[i] - self.pos[i - 1] + s)
            * (h[i + 1] - h[i])
            / step_up
            + (self.pos[i + 1] - self.pos[i] - s)
            * (h[i] - h[i - 1])
            / step_dn
        )
        if not h[i - 1] < cand < h[i + 1]:
            # Parabolic estimate left the bracket: linear step.
            j = i + (1 if s > 0 else -1)
            cand = h[i] + s * (h[j] - h[i]) / (self.pos[j] - self.pos[i])
        h[i] = cand
        self.pos[i] += s
        return True

    def update(self, x: float) -> None:
        x = float(x)
        if self.n < 5:
            self.heights.append(x)
            self.heights.sort()
            self.n += 1
            return
        h = self.heights
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        self.pos[k + 1 :] += 1.0
        self.desired += self.incr
        self.n += 1
        for i in (1, 2, 3):
            self._adjust_marker(i)

    def update_batch(self, xs) -> None:
        """Absorb a whole window's samples in vectorized chunks (the
        ROADMAP stream follow-up): each chunk bins its samples against
        the CURRENT marker heights with one ``searchsorted``,
        bulk-updates the marker positions from the cumulative cell
        counts, then runs the marker-adjustment steps until the markers
        reach their desired positions.

        Numerics: the scalar path re-bins after every height
        adjustment; freezing the heights for a whole chunk is the
        standard batched-P^2 trade, SAFE only while the chunk is small
        next to the state the estimator already holds — so the chunk
        size scales with ``n`` (the estimator's adaptation timescale is
        O(n)): early samples absorb in small chunks while the markers
        are immature, mature state takes whole windows at once. Parity
        vs the scalar implementation is pinned by
        test_stream.test_p2_batch_update_matches_scalar. Cost per
        window drops from O(samples) Python iterations to O(chunks)
        searchsorted passes + O(marker moves) scalar steps.
        """
        xs = np.asarray(xs, dtype=float).ravel()
        if xs.size == 0:
            return
        if self.n < 5:
            # Seed phase is exact: fill to the five markers scalar-wise.
            take = min(5 - self.n, xs.size)
            self.heights.extend(float(x) for x in xs[:take])
            self.heights.sort()
            self.n += take
            xs = xs[take:]
        start = 0
        while start < xs.size:
            chunk = max(16, self.n // 2)
            self._absorb_chunk(xs[start : start + chunk])
            start += chunk

    def _absorb_chunk(self, xs: np.ndarray) -> None:
        h = self.heights
        h[0] = min(h[0], float(xs.min()))
        h[4] = max(h[4], float(xs.max()))
        # Cell of each sample: k = #{j in 1..3 : h[j] <= x} — identical
        # to the scalar walk (x < h[0] lands in cell 0, x >= h[4] in 3).
        cells = np.searchsorted(np.asarray(h[1:4]), xs, side="right")
        counts = np.bincount(cells, minlength=4)[:4]
        below = np.cumsum(counts)          # samples with cell < j
        self.pos[1:4] += below[:3].astype(float)
        self.pos[4] += float(xs.size)
        self.desired += self.incr * xs.size
        self.n += int(xs.size)
        # Marker heights chase the bulk-advanced desired positions: each
        # adjustment moves a marker one position, so the loop is bounded
        # by the total displacement (<= q-weighted chunk size).
        for _ in range(int(xs.size) + 5):
            moved = False
            for i in (1, 2, 3):
                moved = self._adjust_marker(i) or moved
            if not moved:
                break

    def value(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n <= 5:
            h = sorted(self.heights)
            # Exact quantile over the few samples held so far.
            return float(np.quantile(h, self.q))
        return float(self.heights[2])

    # ------------------------------------------------------- durability
    def to_state(self) -> dict:
        """JSON-serializable estimator state (chaos.checkpoint): the
        five marker heights/positions ARE the whole estimator, so a
        restore is bit-faithful."""
        return {
            "q": self.q,
            "n": self.n,
            "heights": [float(h) for h in self.heights],
            "pos": [float(p) for p in self.pos],
            "desired": [float(d) for d in self.desired],
        }

    @classmethod
    def from_state(cls, state: dict) -> "P2Quantile":
        p2 = cls(float(state["q"]))
        p2.n = int(state["n"])
        p2.heights = [float(h) for h in state["heights"]]
        p2.pos = np.asarray(state["pos"], dtype=float)
        p2.desired = np.asarray(state["desired"], dtype=float)
        return p2


class _OpState:
    """One operation's online baseline state (durations in ms)."""

    __slots__ = ("m1", "m2", "windows", "p2")

    def __init__(self, quantile: Optional[float]):
        self.m1 = 0.0
        self.m2 = 0.0
        self.windows = 0
        self.p2 = P2Quantile(quantile) if quantile is not None else None


class OnlineBaseline:
    """Per-operation streaming SLO state behind the batch detector's
    ``(Vocab, SloBaseline)`` interface."""

    def __init__(
        self,
        decay: float = 0.1,
        slo_stat: str = "mean",
        min_windows: int = 1,
        p2_seed_cap: int = 2048,
    ):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = float(decay)
        self.slo_stat = slo_stat
        self.quantile = (
            None if slo_stat == "mean" else slo_quantile(slo_stat)
        )
        self.min_windows = int(min_windows)
        self.p2_seed_cap = int(p2_seed_cap)
        self._ops: Dict[str, _OpState] = {}
        self.frozen = False
        self.seeded = False
        self.n_updates = 0      # healthy windows absorbed
        self.n_frozen_skips = 0

    # ------------------------------------------------------------- state
    @property
    def ready(self) -> bool:
        """Detection arms once seeded or fed ``min_windows`` windows."""
        return bool(self._ops) and (
            self.seeded or self.n_updates >= self.min_windows
        )

    def freeze(self) -> None:
        self.frozen = True

    def thaw(self) -> None:
        self.frozen = False

    def known_ops(self) -> frozenset:
        """The operations this baseline has SLO state for — the
        reference set of JAX's admission vocab-growth guard (its
        ``admit_frame`` ladder; the port's ``admit_table`` has no such
        rung)."""
        return frozenset(self._ops)

    # ------------------------------------------------------------ intake
    @staticmethod
    def _grouped_ms(table):
        """(name, durations in ms) of each service-level op of ``table``
        with a row, in name order, each op's samples in row order (what
        JAX's pandas groupby gives)."""
        codes = np.asarray(table.svc_op, dtype=np.int64)
        dur_ms = np.asarray(table.duration_us).astype(float) / US_PER_MS
        if not codes.size:
            return []
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        cuts = np.flatnonzero(np.diff(sorted_codes)) + 1
        names = table.svc_op_names
        groups = [(names[int(c[0])], dur_ms[rows]) for c, rows in
                  zip(np.split(sorted_codes, cuts), np.split(order, cuts))]
        return sorted(groups, key=lambda g: g[0])

    def seed(self, normal_table) -> None:
        """Initialize from a normal-period dump (the batch baseline's
        input) so detection arms immediately; the P^2 markers absorb at
        most ``p2_seed_cap`` strided samples per op (seeding is one-time
        but a multi-GB dump should not cost a per-span Python loop)."""
        for name, vals in self._grouped_ms(normal_table):
            st = self._ops.setdefault(str(name), _OpState(self.quantile))
            st.m1 = float(vals.mean())
            st.m2 = float((vals**2).mean())
            st.windows += 1
            if st.p2 is not None:
                stride = max(1, len(vals) // self.p2_seed_cap)
                st.p2.update_batch(vals[::stride])
        self.seeded = True

    def update(self, window_table) -> bool:
        """Absorb one HEALTHY window; no-op (False) while frozen."""
        if self.frozen:
            self.n_frozen_skips += 1
            return False
        a = self.decay
        for name, vals in self._grouped_ms(window_table):
            st = self._ops.get(str(name))
            w_m1 = float(vals.mean())
            w_m2 = float((vals**2).mean())
            if st is None:
                st = self._ops[str(name)] = _OpState(self.quantile)
                st.m1, st.m2 = w_m1, w_m2
            else:
                st.m1 = (1 - a) * st.m1 + a * w_m1
                st.m2 = (1 - a) * st.m2 + a * w_m2
            st.windows += 1
            if st.p2 is not None:
                st.p2.update_batch(vals)
        self.n_updates += 1
        return True

    # ------------------------------------------------------- durability
    def to_state(self) -> dict:
        """The full baseline as JSON-serializable checkpoint state: the
        exp-decay moments and P^2 markers per op, plus the arming/freeze
        flags — a restore resumes detection exactly where the crashed
        process left it (no cold-start window gating)."""
        return {
            "decay": self.decay,
            "slo_stat": self.slo_stat,
            "min_windows": self.min_windows,
            "frozen": self.frozen,
            "seeded": self.seeded,
            "n_updates": self.n_updates,
            "n_frozen_skips": self.n_frozen_skips,
            "ops": {
                name: {
                    "m1": st.m1,
                    "m2": st.m2,
                    "windows": st.windows,
                    "p2": None if st.p2 is None else st.p2.to_state(),
                }
                for name, st in self._ops.items()
            },
        }

    def restore(self, state: dict) -> None:
        """Overwrite this baseline with checkpointed state. The SLO
        statistic must match — a p99 marker array is meaningless under a
        mean-configured detector (raises ValueError; the engine treats
        that as an unusable checkpoint)."""
        if state.get("slo_stat") != self.slo_stat:
            raise ValueError(
                f"checkpoint baseline slo_stat {state.get('slo_stat')!r} "
                f"!= configured {self.slo_stat!r}"
            )
        self.frozen = bool(state.get("frozen", False))
        self.seeded = bool(state.get("seeded", False))
        self.n_updates = int(state.get("n_updates", 0))
        self.n_frozen_skips = int(state.get("n_frozen_skips", 0))
        self._ops = {}
        for name, op in state.get("ops", {}).items():
            st = _OpState(self.quantile)
            st.m1 = float(op["m1"])
            st.m2 = float(op["m2"])
            st.windows = int(op.get("windows", 0))
            if op.get("p2") is not None and self.quantile is not None:
                st.p2 = P2Quantile.from_state(op["p2"])
            self._ops[str(name)] = st

    # ----------------------------------------------------------- egress
    def snapshot(self) -> Tuple[Vocab, SloBaseline]:
        """The detector-facing view: name-sorted vocab + dense arrays
        (center per ``slo_stat``, population-style std)."""
        names = sorted(self._ops)
        center = np.empty(len(names), np.float32)
        std = np.empty(len(names), np.float32)
        for i, n in enumerate(names):
            st = self._ops[n]
            var = max(0.0, st.m2 - st.m1 * st.m1)
            std[i] = np.float32(var**0.5)
            center[i] = np.float32(
                st.m1 if st.p2 is None else st.p2.value()
            )
        return Vocab(names), SloBaseline(mean_ms=center, std_ms=std)
