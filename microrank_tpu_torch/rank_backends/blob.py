"""Single-buffer host-to-device staging for window graphs (counterpart
of ``microrank_tpu/rank_backends/blob.py``).

A ``WindowGraph`` is about 60 leaf arrays. Staged leaf by leaf (the
"tree" path, ``convert.graph_from_numpy``) each is a copy from pageable
host memory, and CUDA starts such a copy only after all the work queued
before it on the stream: in the pipelined window loop, window n + 1's
copies wait for window n's rank program to finish. Here the whole graph
is packed on the host into ONE pinned buffer (written in place, one
memcpy a leaf), sent in ONE ``non_blocking`` copy on the current
stream, and decoded on the card into the graph's leaves as typed views
of the one device buffer (K7, the counterpart of JAX's
``_decode_leaf`` / ``unpack_graph_blob``): no kernel, no byte copied
again. The pinned buffer is held with the window's outputs until they
are fetched (``torch_cuda.PackedOutputs.staged``).

Word format: JAX's. Little-endian bytes in uint32 words, the leaves in
``PartitionGraph._fields`` order, normal partition then abnormal, each
at a word offset given by the layout; 0-d leaves take one word and the
0-width leaves ``host_subset`` strips none. The port rounds every
leaf's offset up to ``ALIGN_BYTES`` (JAX: to a word), because its
kernels load 16 bytes at a time (``csrc/coo_spmv.cu``'s ``int4`` /
``float4`` loads, ``csrc/pattern_pair.cu``'s ``cp.async``) and the pcsr
wrapper refuses an ELL slab that is not 16-byte aligned; so the bytes
differ from JAX's blob by that padding only. The card and the x86 host
are both little-endian, so a byte view reads what JAX's shift / mask
decode extracts, and a bool leaf, packed as 0 / 1 bytes, views as
JAX's ``a != 0``. The decoder takes any word offsets: it reads JAX's
own blob with JAX's own layout.

On CPU tensors (the tests) the blob is a plain host tensor and the
same decode runs over it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph.structures import PartitionGraph, WindowGraph

# (field, dtype str, shape, word offset, word count) per leaf, one tuple
# per partition, normal first: JAX's BlobLayout.
BlobLayout = Tuple[Tuple[Tuple[str, str, Tuple[int, ...], int, int], ...], ...]

_WORD = 4
ALIGN_BYTES = 256
_DTYPES = {
    "float32": torch.float32,
    "int32": torch.int32,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "bool": torch.bool,
}
_ITEMSIZE = {"float32": 4, "int32": 4, "uint8": 1, "int8": 1, "bool": 1}


def _leaf(part, f: str) -> np.ndarray:
    # By name, as convert.graph_from_numpy reads it: the JAX package's
    # graphs pack as well.
    return np.asarray(getattr(part, f, PartitionGraph._field_defaults.get(f)))


def _leaf_entries(part, off: int):
    align = ALIGN_BYTES // _WORD
    entries = []
    for f in PartitionGraph._fields:
        arr = _leaf(part, f)
        off = -(-off // align) * align
        n_words = (arr.nbytes + _WORD - 1) // _WORD
        entries.append((f, str(arr.dtype), tuple(arr.shape), off, n_words))
        off += n_words
    return tuple(entries), off


def pack_graph_blob(graph, pin: bool = False) -> Tuple[torch.Tensor, BlobLayout]:
    """Host side: the graph's leaves written straight into one uint8
    buffer (pinned with ``pin``; the gaps between leaves zeroed), and
    the layout describing it. Raises where pinning fails: there is no
    fallback to the per-leaf path."""
    n_entries, off = _leaf_entries(graph.normal, 0)
    a_entries, off = _leaf_entries(graph.abnormal, off)
    buf = torch.empty(max(off, 1) * _WORD, dtype=torch.uint8, pin_memory=pin)
    u8 = buf.numpy()
    at = 0
    for part, entries in ((graph.normal, n_entries), (graph.abnormal, a_entries)):
        for f, _, _, o, _ in entries:
            b = np.ascontiguousarray(_leaf(part, f)).view(np.uint8).reshape(-1)
            start = o * _WORD
            u8[at:start] = 0
            u8[start:start + b.size] = b
            at = start + b.size
    u8[at:] = 0
    return buf, (n_entries, a_entries)


def _decode_leaf(buf: torch.Tensor, dtype_str: str, shape: Tuple[int, ...], off: int,
                 n_words: int) -> torch.Tensor:
    """K7: one leaf as a typed view of the blob's bytes (no copy)."""
    if dtype_str not in _DTYPES:
        raise TypeError(f"blob staging: unsupported leaf dtype {dtype_str!r}")
    n_bytes = math.prod(shape) * _ITEMSIZE[dtype_str]
    if n_bytes > n_words * _WORD:
        raise ValueError(f"blob staging: a {dtype_str}{list(shape)} leaf in {n_words} words")
    start = off * _WORD
    return buf[start:start + n_bytes].view(_DTYPES[dtype_str]).reshape(shape)


def unpack_leaves(buf: torch.Tensor, layout: BlobLayout) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Every leaf of ``layout`` (any layout, JAX's too) decoded from the
    uint8 blob ``buf``, by field name, one dict per partition."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError("blob staging: the blob is a 1-d uint8 tensor")
    return tuple({e[0]: _decode_leaf(buf, *e[1:]) for e in entries} for entries in layout)


def unpack_graph_blob(buf: torch.Tensor, layout: BlobLayout) -> WindowGraph:
    """Device side: the WindowGraph whose every leaf is a view of
    ``buf`` (on ``buf``'s device)."""
    parts = [PartitionGraph(**leaves) for leaves in unpack_leaves(buf, layout)]
    return WindowGraph(normal=parts[0], abnormal=parts[1])


def _account_staging(graph, path: str, n_transfers: int) -> None:
    """Staging telemetry, as JAX records it: bytes, transfers and pad
    waste audited on the host graph (``graph_staging_audit``), not on
    the blob, so the blob's alignment never counts as staged bytes."""
    from ..obs.metrics import graph_staging_audit, record_staging

    total, pad = graph_staging_audit(graph)
    record_staging(path, total, n_transfers, pad)


def stage_graph(graph, device, blob: bool) -> Tuple[WindowGraph, Optional[torch.Tensor]]:
    """The host graph on ``device``: blob-staged (one buffer, one copy,
    typed views; on CUDA the pinned host buffer is returned beside the
    graph, to be held until the program's outputs are fetched), or leaf
    by leaf (``blob=False``: one copy per field of each partition).
    Returns (graph, pinned blob or None)."""
    from .convert import graph_from_numpy

    device = torch.device(device)
    if not blob:
        _account_staging(graph, "tree", 2 * len(PartitionGraph._fields))
        return graph_from_numpy(graph, device), None
    on_card = device.type == "cuda"
    host, layout = pack_graph_blob(graph, pin=on_card)
    _account_staging(graph, "blob", 1)
    if not on_card:
        return unpack_graph_blob(host, layout), None
    return unpack_graph_blob(host.to(device, non_blocking=True), layout), host


def stage_rank_window(
    graph,
    pagerank_cfg,
    spectrum_cfg,
    kernel: str,
    device,
    blob: bool,
    checked: bool = False,
    conv_trace: bool = False,
    explain=None,
    all_methods: bool = False,
):
    """Stage one window's host graph (``host_subset``-stripped for
    ``kernel``), or a stacked group's, and issue its rank program, all
    on the current stream: ``stage_graph``, the kernels' layouts
    (``device_subset``) and ``rank_window_traced_core``. On every route
    the layouts take their counts from the host graph (``host_counts``),
    so that nothing between the blob's copy and the program waits on the
    device. Returns (outputs, the pinned blob
    or None): (top_idx, top_scores, n_valid), with ``conv_trace`` also
    (residuals, n_iters), all still on the device.

    ``checked`` (``RuntimeConfig.device_checks``, K14): the checked
    program instead (``rank_window_checked_core``, with ``conv_trace``
    ``rank_window_checked_traced_core``), blob-staged as the unchecked
    one: its check word is a last output, to be packed with
    ``pack_rank_outputs(..., checked=True)``, whose fetch raises
    ``DeviceCheckError`` where JAX's call raises. ``all_methods`` (K13):
    the program under every formula instead
    (``rank_window_all_methods_core``: top_idx and top_scores [M, k],
    n_valid; one window). JAX's explained program is not ported
    (ROADMAP.md, port queue items 10-11)."""
    from . import torch_cuda

    if explain is not None and getattr(explain, "enabled", False):
        raise NotImplementedError(
            "stage_rank_window: the explained program (K15) is not ported "
            "(ROADMAP.md, port queue items 10-11)"
        )
    counts = torch_cuda.host_counts(graph, kernel)
    dgraph, staged = stage_graph(graph, device, blob)
    dgraph = torch_cuda.device_subset(dgraph, kernel, pagerank_cfg.packed_block_bytes, counts)
    if all_methods:
        return torch_cuda.rank_window_all_methods_core(
            dgraph, pagerank_cfg, spectrum_cfg, kernel), staged
    if checked:
        program = (torch_cuda.rank_window_checked_traced_core if conv_trace
                   else torch_cuda.rank_window_checked_core)
        return program(dgraph, pagerank_cfg, spectrum_cfg, kernel), staged
    outs = torch_cuda.rank_window_traced_core(dgraph, pagerank_cfg, spectrum_cfg, kernel)
    return (outs if conv_trace else outs[:3]), staged


def stage_rank_windows_batched(
    batched,
    pagerank_cfg,
    spectrum_cfg,
    kernel: str,
    device,
    blob: bool,
    conv_trace: bool = False,
):
    """Batched twin of ``stage_rank_window``: one stacked group
    (``parallel.stack_window_graphs``, already ``host_subset``-stripped)
    staged as one blob and ranked as one program, packed_blocked's block
    budget divided by B as JAX's batched program divides it. Outputs
    carry a leading [B] axis."""
    from .torch_cuda import divide_block_budget

    pagerank_cfg = divide_block_budget(pagerank_cfg, kernel, batched.normal.kind.shape[0])
    return stage_rank_window(
        batched, pagerank_cfg, spectrum_cfg, kernel, device, blob, conv_trace=conv_trace
    )
