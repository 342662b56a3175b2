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
from typing import Dict, NamedTuple, Optional, Tuple

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


def _extra_entries(extra, off: int):
    """Entries of arrays riding after the graph (``init0``, ``init1``,
    ...: K19's mapped init), each at an aligned offset."""
    align = ALIGN_BYTES // _WORD
    entries = []
    for i, arr in enumerate(extra):
        off = -(-off // align) * align
        n_words = (arr.nbytes + _WORD - 1) // _WORD
        entries.append((f"init{i}", str(arr.dtype), tuple(arr.shape), off, n_words))
        off += n_words
    return tuple(entries), off


def pack_graph_blob(graph, pin: bool = False, extra=()) -> Tuple[torch.Tensor, BlobLayout]:
    """Host side: the graph's leaves written straight into one uint8
    buffer (pinned with ``pin``; the gaps between leaves zeroed), and
    the layout describing it. ``extra``: host arrays packed after the
    graph (a third entry of the layout; the warm program's init). Raises
    where pinning fails: there is no fallback to the per-leaf path."""
    n_entries, off = _leaf_entries(graph.normal, 0)
    a_entries, off = _leaf_entries(graph.abnormal, off)
    extra = [np.ascontiguousarray(x) for x in extra]
    x_entries, off = _extra_entries(extra, off)
    buf = torch.empty(max(off, 1) * _WORD, dtype=torch.uint8, pin_memory=pin)
    u8 = buf.numpy()
    at = 0
    sources = [(entries, lambda f, part=part: _leaf(part, f))
               for part, entries in ((graph.normal, n_entries), (graph.abnormal, a_entries))]
    if extra:
        sources.append((x_entries, lambda f: extra[int(f[4:])]))
    for entries, leaf in sources:
        for f, _, _, o, _ in entries:
            b = np.ascontiguousarray(leaf(f)).view(np.uint8).reshape(-1)
            start = o * _WORD
            u8[at:start] = 0
            u8[start:start + b.size] = b
            at = start + b.size
    u8[at:] = 0
    layout = (n_entries, a_entries) + ((x_entries,) if extra else ())
    return buf, layout


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
    ``buf`` (on ``buf``'s device); a layout's extra arrays are left out
    (``unpack_extra``)."""
    parts = [PartitionGraph(**leaves) for leaves in unpack_leaves(buf, layout[:2])]
    return WindowGraph(normal=parts[0], abnormal=parts[1])


def unpack_extra(buf: torch.Tensor, layout: BlobLayout) -> Tuple[torch.Tensor, ...]:
    """The extra arrays packed after the graph (``pack_graph_blob(...,
    extra=...)``), as views of ``buf`` in their order."""
    if len(layout) < 3:
        return ()
    leaves = unpack_leaves(buf, layout[2:])[0]
    return tuple(leaves[f"init{i}"] for i in range(len(leaves)))


def _account_staging(graph, path: str, n_transfers: int) -> None:
    """Staging telemetry, as JAX records it: bytes, transfers and pad
    waste audited on the host graph (``graph_staging_audit``), not on
    the blob, so the blob's alignment never counts as staged bytes."""
    from ..obs.metrics import graph_staging_audit, record_staging

    total, pad = graph_staging_audit(graph)
    record_staging(path, total, n_transfers, pad)


def stage_graph(graph, device, blob: bool, extra=()
                ) -> Tuple[WindowGraph, Optional[torch.Tensor]]:
    """The host graph on ``device``: blob-staged (one buffer, one copy,
    typed views; on CUDA the pinned host buffer is returned beside the
    graph, to be held until the program's outputs are fetched), or leaf
    by leaf (``blob=False``: one copy per field of each partition).
    ``extra`` (host arrays, the warm program's init) rides the same
    blob; the graph then comes back as (graph, extra tensors). Returns
    (graph, pinned blob or None)."""
    from .convert import graph_from_numpy

    device = torch.device(device)
    on_card = device.type == "cuda"
    if not blob:
        _account_staging(graph, "tree", 2 * len(PartitionGraph._fields))
        dgraph = graph_from_numpy(graph, device)
        if not extra:
            return dgraph, None
        from .torch_cuda import warm_init_on

        return (dgraph, warm_init_on(dgraph, extra)), None
    host, layout = pack_graph_blob(graph, pin=on_card, extra=extra)
    _account_staging(graph, "blob", 1)
    dev_buf = host.to(device, non_blocking=True) if on_card else host
    dgraph = unpack_graph_blob(dev_buf, layout)
    if extra:
        dgraph = (dgraph, unpack_extra(dev_buf, layout))
    return dgraph, (host if on_card else None)


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
    n_valid; one window).

    ``explain`` (an ``ExplainConfig``, or None): with ``enabled``, the
    explained program instead (K15, ``rank_window_explained_core``, as
    JAX's ``blob.stage_rank_window`` dispatches it): its ten outputs, the
    residual trace always among them; it has no check word, so
    ``checked`` is not read. One window.

    Asserts the calling thread owns the card (``utils.guards``)."""
    from ..utils.guards import assert_device_owner
    from . import torch_cuda

    assert_device_owner("blob.stage_rank_window")
    counts = torch_cuda.host_counts(graph, kernel)
    dgraph, staged = stage_graph(graph, device, blob)
    dgraph = torch_cuda.device_subset(dgraph, kernel, pagerank_cfg.packed_block_bytes, counts)
    if explain is not None and getattr(explain, "enabled", False):
        return torch_cuda.rank_window_explained_core(
            dgraph, pagerank_cfg, spectrum_cfg, explain, kernel), staged
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


def stage_rank_window_warm(graph, init, pagerank_cfg, spectrum_cfg, kernel: str, device,
                           blob: bool):
    """The fused pair program (JAX's ``blob.stage_rank_window_warm``,
    K19): stage ONE window's host graph (``host_subset``-stripped) and
    its mapped ``init`` (the previous window's state, or None for a cold
    seed that still exports its state) as one blob in one copy, and
    issue ``rank_window_warm_core`` over it. Returns (the nine outputs,
    still on the device; the pinned blob or None): fetch them with one
    ``pack_rank_outputs`` / ``unpack_rank_outputs``; entries [5:9] are
    the state the next window maps."""
    from . import torch_cuda

    counts = torch_cuda.host_counts(graph, kernel)
    extra = () if init is None else tuple(np.asarray(x, np.float32) for x in init)
    staged_graph, pinned = stage_graph(graph, device, blob, extra)
    dgraph, dinit = staged_graph if extra else (staged_graph, None)
    dgraph = torch_cuda.device_subset(dgraph, kernel, pagerank_cfg.packed_block_bytes, counts)
    return torch_cuda.rank_window_warm_core(dgraph, dinit, pagerank_cfg, spectrum_cfg,
                                            kernel), pinned


class StagedWindows(NamedTuple):
    """The staging half's handle (``stage_windows_batched``): the graph
    on the device (a stacked group, or one window), the pinned blob it
    was copied from, and the host counts its layouts take on trust."""

    graph: WindowGraph
    pinned: Optional[torch.Tensor]
    counts: object
    kernel: str


def stage_windows_batched(batched, kernel: str, device, blob: bool) -> StagedWindows:
    """Staging half of ``stage_rank_windows_batched`` (JAX's
    ``stage_windows_batched``): the host counts, the pack and the
    ``non_blocking`` copy to the card, issued on the current stream and
    not waited for. ``batched``: a stacked group
    (``stack_window_graphs``) or one window, ``host_subset``-stripped.
    The dispatch router issues the next batch's staging here behind the
    current batch's program."""
    from . import torch_cuda

    counts = torch_cuda.host_counts(batched, kernel)
    dgraph, pinned = stage_graph(batched, device, blob)
    return StagedWindows(dgraph, pinned, counts, kernel)


def dispatch_windows_staged(staged: StagedWindows, pagerank_cfg, spectrum_cfg,
                            conv_trace: bool = False):
    """Dispatch half (JAX's ``dispatch_windows_staged``): the layouts
    (``device_subset``) and the rank program over a staged handle, the
    stacked program (K18) for a group, the one-window program for one
    window, packed_blocked's block budget divided by B as JAX's batched
    program divides it. Returns the device outputs (top_idx,
    top_scores, n_valid, and with ``conv_trace`` residuals, n_iters).
    JAX's donation of the staged blob has no counterpart: the
    program's leaves are views of the staged buffer."""
    from . import torch_cuda

    windows = torch_cuda.stacked_windows(staged.graph)
    cfg = torch_cuda.divide_block_budget(pagerank_cfg, staged.kernel, windows or 1)
    dgraph = torch_cuda.device_subset(staged.graph, staged.kernel, cfg.packed_block_bytes,
                                      staged.counts)
    outs = torch_cuda.rank_window_traced_core(dgraph, cfg, spectrum_cfg, staged.kernel)
    return outs if conv_trace else outs[:3]
