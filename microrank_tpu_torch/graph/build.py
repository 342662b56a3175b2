"""Build-policy helpers (the numpy subset of ``microrank_tpu/graph/build.py``).

The JAX module also holds the pandas graph builder, which this package
does not port: the native lane builds in C++ (``native/``). What the
native lane needs from it is the auxiliary-view policy, the kind view
constructor, the partition-centric (pcsr) view constructor and the
dedup measurement.
"""

from __future__ import annotations

import numpy as np

from .structures import WindowGraph, pad_to

# Device budget of the packed kernels' unpacked f32 matrices, summed
# over both partitions (RuntimeConfig.dense_budget_bytes's default).
DEFAULT_DENSE_BUDGET_BYTES = 2 << 30

# Dedup factor (true traces / kind columns) at which an auto-resolved
# collapsed build would construct the kind views.
DEFAULT_KIND_DEDUP_THRESHOLD = 4.0


def packed_unpacked_bytes(v_pad: int, t_pads) -> int:
    """Resident f32 bytes of the packed kernel's matrices had they been
    unpacked ([V, T] coverage + [V, V] call graph per partition): the
    footprint ``choose_kernel`` holds to the dense budget, as the JAX
    package does (its packed kernel unpacks them; this package's never
    does)."""
    return sum((v_pad * t + v_pad * v_pad) * 4 for t in t_pads)


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
    the kind views fit, else "packed" (``choose_kernel`` then picks
    "packed_blocked" where the unpacked matrices exceed the budget);
    "auto_all" -> "all" / "pcsr". Explicit modes pass through."""
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


def kind_aux(cov_bits: np.ndarray, ss_child: np.ndarray, n_ss: int,
             v_pad: int, t_pad: int):
    """The kind views from an already-built coverage bitmap: the int8
    [V, K] 0/1 pattern (np.unpackbits; a change of representation, not
    a rounding) and the call-edge row offsets over the child-sorted
    edge list. Returns (cov_i8 int8[v_pad, t_pad], ss_indptr
    int32[v_pad + 1])."""
    cov_i8 = (
        np.unpackbits(cov_bits, axis=1)[:, :t_pad].astype(np.int8)
        if cov_bits.shape[1]
        else np.zeros((v_pad, t_pad), np.int8)
    )
    ss_indptr = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(
        np.bincount(ss_child[:n_ss], minlength=v_pad), out=ss_indptr[1:]
    )
    return cov_i8, ss_indptr.astype(np.int32)


# Source-partition width (traces per partition) of the partition-centric
# views (kernel="pcsr"), and the entries per reduction block of their
# forward tables: the JAX package's constants, so the views come out
# array-identical.
PCSR_PART_TRACES = 4096
PCSR_BLOCK = 8


def pcsr_partitions(t_pad: int) -> int:
    """Number of source partitions the pcsr views bin a t_pad-trace axis
    into (ceil division; >= 1 even for empty partitions)."""
    return max(1, -(-int(t_pad) // PCSR_PART_TRACES))


def pcsr_auxiliary(
    inc_op: np.ndarray,
    inc_trace: np.ndarray,
    sr_val: np.ndarray,
    rs_val: np.ndarray,
    n_inc: int,
    v_pad: int,
    t_pad: int,
):
    """Partition-centric binning of the (trace, op)-sorted incidence
    entries (the JAX package's ``pcsr_auxiliary``, the same arrays).

    Forward tables: the entries re-sorted (stable) to (trace-partition,
    op, trace) order, every (partition, op) run padded to whole
    PCSR_BLOCK-entry blocks; ``pc_blk_indptr[p, o]`` is the block offset
    of op ``o``'s run inside partition ``p``, and trace ids are stored
    partition-local (trace - p * PCSR_PART_TRACES). Backward slab: each
    trace's entries as one fixed-width row of [t_pad, W] (W = max unique
    ops per trace, a power of two). Padding carries value 0 / index 0.

    Returns (pc_trace[P, Epb], pc_sr_val[P, Epb], pc_blk_indptr[P,
    v_pad+1], pc_ell_op[t_pad, W], pc_ell_rs[t_pad, W]).
    """
    s = PCSR_PART_TRACES
    bsz = PCSR_BLOCK
    n_parts = pcsr_partitions(t_pad)
    tr = np.asarray(inc_trace[:n_inc]).astype(np.int64)
    op = np.asarray(inc_op[:n_inc]).astype(np.int64)

    # Backward ELL slab (the storage order is trace-major already).
    cnt_t = np.bincount(tr, minlength=t_pad).astype(np.int64)
    w = pad_to(int(cnt_t.max()) if n_inc else 1, "pow2", 1)
    ell_op = np.zeros((t_pad, w), np.int32)
    ell_rs = np.zeros((t_pad, w), np.float32)
    if n_inc:
        starts_t = np.concatenate(([0], np.cumsum(cnt_t)[:-1]))
        pos_t = np.arange(n_inc, dtype=np.int64) - starts_t[tr]
        ell_op[tr, pos_t] = op
        ell_rs[tr, pos_t] = np.asarray(rs_val[:n_inc])

    # Forward block tables.
    part = tr // s
    pair = part * v_pad + op
    order = np.argsort(pair, kind="stable")  # traces stay ascending
    pair_s = pair[order]
    cnt_pair = np.bincount(pair_s, minlength=n_parts * v_pad).astype(np.int64)
    blocks_2d = (-(-cnt_pair // bsz)).reshape(n_parts, v_pad)
    blk_indptr = np.zeros((n_parts, v_pad + 1), np.int32)
    blk_indptr[:, 1:] = np.cumsum(blocks_2d, axis=1).astype(np.int32)
    blocks_per_part = blocks_2d.sum(axis=1)
    e_blk = pad_to(int(blocks_per_part.max()) * bsz if n_inc else bsz, "pow2", bsz)
    pc_trace = np.zeros((n_parts, e_blk), np.int32)
    pc_sr = np.zeros((n_parts, e_blk), np.float32)
    if n_inc:
        # Destination: the pair's block offset * bsz + the position in
        # its (sorted, contiguous) run.
        starts_pair = np.zeros(n_parts * v_pad + 1, dtype=np.int64)
        np.cumsum(cnt_pair, out=starts_pair[1:])
        pos_in_pair = np.arange(n_inc, dtype=np.int64) - starts_pair[pair_s]
        dest = blk_indptr[:, :-1].reshape(-1)[pair_s].astype(np.int64) * bsz
        dest += pos_in_pair
        part_s = pair_s // v_pad
        pc_trace[part_s, dest] = (tr[order] - part_s * s).astype(np.int32)
        pc_sr[part_s, dest] = np.asarray(sr_val[:n_inc])[order]
    return pc_trace, pc_sr, blk_indptr, ell_op, ell_rs


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
