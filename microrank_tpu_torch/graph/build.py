"""Build-policy helpers (the numpy subset of ``microrank_tpu/graph/build.py``).

The JAX module also holds the pandas graph builder, which this package
does not port: the native lane builds in C++ (``native/``). What the
native lane needs from it is the auxiliary-view policy and the dedup
measurement.
"""

from __future__ import annotations

from .structures import WindowGraph

# Device budget of the packed kernels' unpacked f32 matrices, summed
# over both partitions (RuntimeConfig.dense_budget_bytes's default).
DEFAULT_DENSE_BUDGET_BYTES = 2 << 30

# Dedup factor (true traces / kind columns) at which an auto-resolved
# collapsed build would construct the kind views.
DEFAULT_KIND_DEDUP_THRESHOLD = 4.0


def packed_bits_bytes(v_pad: int, t_pads) -> int:
    """Resident bytes of the packed bitmaps ([V, T/8] + [V, V/8] per
    partition)."""
    return sum(
        v_pad * ((t + 7) // 8) + v_pad * ((v_pad + 7) // 8) for t in t_pads
    )


def kind_bytes(v_pad: int, t_pads) -> int:
    """Resident bytes of the kind views (int8 [V, K] + its bitmap twin)."""
    return sum(v_pad * t + v_pad * ((t + 7) // 8) for t in t_pads)


def resolve_aux(
    aux: str,
    v_pad: int,
    t_pads,
    dense_budget_bytes: int = DEFAULT_DENSE_BUDGET_BYTES,
    dedup: float | None = None,
    kind_dedup_threshold: float = DEFAULT_KIND_DEDUP_THRESHOLD,
) -> str:
    """Window-level auxiliary-view policy, one decision for both
    partitions: "auto" -> "pcsr" past a quarter of the budget in
    bitmaps, "kind" when the measured dedup clears the threshold and
    the kind views fit, else "packed"; "auto_all" -> "all" / "pcsr".
    Explicit modes pass through."""
    if aux not in ("auto", "auto_all"):
        return aux
    bits_total = packed_bits_bytes(v_pad, t_pads)
    if bits_total > dense_budget_bytes // 4:
        return "pcsr"
    if (
        aux == "auto"
        and dedup is not None
        and dedup >= kind_dedup_threshold
        and kind_bytes(v_pad, t_pads) <= dense_budget_bytes // 4
    ):
        return "kind"
    return "all" if aux == "auto_all" else "packed"


def aux_for_kernel(kernel: str, sharded: bool = False) -> str:
    """The build aux mode a forced RuntimeConfig.kernel needs
    ("pallas" reads only the COO arrays: "none")."""
    mode = {
        "auto": "auto",
        "csr": "csr",
        "pcsr": "pcsr",
        "packed": "packed",
        "packed_bf16": "packed",
        "packed_blocked": "packed",
        "kind": "kind",
    }.get(kernel, "none")
    if sharded and mode == "auto":
        return "auto_all"
    return mode


def kind_dedup_ratio(graph: WindowGraph) -> float:
    """True traces / distinct kind columns over both partitions (1.0 on
    an uncollapsed build)."""
    total_t = total_c = 0
    for p in (graph.normal, graph.abnormal):
        n_tr = int(p.n_traces)
        n_co = int(p.n_cols)
        total_t += n_tr
        total_c += n_tr if n_co < 0 else n_co
    return float(total_t) / float(max(total_c, 1))
