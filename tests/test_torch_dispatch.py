"""The dispatch router (``dispatch/router.py``) on the CPU:

* ``bucket_key``: windows of one pad bucket share a key, and the keys
  partition a set of windows as JAX's ``bucket_key`` partitions the
  same windows;
* ``rank_batch``: a stacked group's rankings bitwise each window's own
  one-window program; the outputs carry a leading [B] axis at B = 1 too;
* the double buffer: a prestaged batch is consumed by the next call with
  the same graphs, dropped by a call with others and by
  ``drop_prestaged``, and nothing is prestaged with ``double_buffer``
  off;
* ``rank_fused``: the nine outputs of ``rank_window_warm`` on the same
  graph and init, bitwise;
* a configured mesh raises, naming item 12;
* the stream's coalescing: a burst of abnormal windows coalesces into
  one dispatch, or into dispatches of at most ``coalesce_windows``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig, StreamConfig
from microrank_tpu_torch.dispatch import DispatchRouter, bucket_key
from microrank_tpu_torch.graph.table_ops import build_window_graph_from_table
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import (
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
    rank_window_warm,
)
from microrank_tpu_torch.stream import SyntheticSource, run_stream
from microrank_tpu_torch.testing import SyntheticConfig

SYNTH = dict(n_operations=24, n_traces=200, n_kinds=16, seed=5)
CFG = MicroRankConfig().replace(runtime=RuntimeConfig(device="cpu"))


@pytest.fixture(scope="module")
def windows():
    """The abnormal windows of a timeline (faults in 1, 2, 4), each built
    as the stream builds it: (host graph, kernel)."""
    from microrank_tpu_torch.config import DetectorConfig
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table, detect_window_partition
    from microrank_tpu_torch.rank_backends.torch_cuda import choose_kernel
    from microrank_tpu_torch.stream.window import StreamWindower

    src = SyntheticSource(6, [1, 2, 4], SyntheticConfig(**SYNTH), chunk_spans=100_000)
    vocab, base = compute_slo_from_table(src.normal)
    w = StreamWindower(width_us=300_000_000)
    closed = []
    for batch in src:
        closed += w.add(batch)
    closed += w.flush()
    out = []
    for c in closed:
        t = c.table
        mask, nrm, abn, _, rng = detect_window_partition(
            t, int(t.start_us.min()), int(t.end_us.max()), vocab, base, DetectorConfig(),
            with_range=True)
        if len(abn):
            g = build_window_graph_from_table(t, mask, nrm, abn, aux="auto", collapse="auto",
                                              row_range=rng)[0]
            kernel = choose_kernel(g)
            out.append((host_subset(g, kernel), kernel))
    return out


def test_bucket_keys_group_windows_as_jaxs(windows):
    import jax

    from microrank_tpu.dispatch import bucket_key as jax_bucket_key

    keys = [bucket_key(g, k) for g, k in windows]
    jkeys = [jax_bucket_key(jax.tree.map(np.asarray, g), k) for g, k in windows]
    for a in range(len(windows)):
        for b in range(len(windows)):
            assert (keys[a] == keys[b]) == (jkeys[a] == jkeys[b])
    assert len(set(keys)) < len(keys)  # some windows share a bucket
    g, k = windows[0]
    assert bucket_key(g, "pallas") != bucket_key(g, k)


def one_window(graph, kernel, conv=True):
    dg = device_subset(graph_from_numpy(graph, "cpu"), kernel)
    return fetch_rank_outputs(rank_window_traced_core(dg, CFG.pagerank, CFG.spectrum, kernel))


def test_a_stacked_group_is_bitwise_each_windows_program(windows):
    router = DispatchRouter(CFG)
    g0, k0 = windows[0]
    same = [g for g, k in windows if bucket_key(g, k) == bucket_key(g0, k0)]
    assert len(same) >= 2
    outs, info = router.rank_batch(same, k0, conv_trace=True)
    assert info.route == "vmapped" and info.windows == len(same) and not info.prestaged
    for b, g in enumerate(same):
        own = one_window(g, k0)
        for got, want in zip(outs, own):
            got = np.asarray(got[b])
            assert got.tobytes() == np.asarray(want, dtype=got.dtype).tobytes()
    single, _ = router.rank_batch([g0], k0)
    assert [np.asarray(o).shape[0] for o in single] == [1, 1, 1]


def test_the_double_buffer_is_consumed_and_dropped(windows):
    (g0, k0), (g1, k1) = windows[0], windows[1]
    router = DispatchRouter(CFG)
    _, info = router.rank_batch([g0], k0, next_batch=([g1], k1))
    assert router._prestaged is not None and not info.prestaged
    _, info = router.rank_batch([g1], k1)
    assert info.prestaged and router._prestaged is None
    # A prestaged batch that is not the next call's is dropped unused.
    router.rank_batch([g0], k0, next_batch=([g1], k1))
    _, info = router.rank_batch([g0], k0)
    assert not info.prestaged and router._prestaged is None
    router.rank_batch([g0], k0, next_batch=([g1], k1))
    router.drop_prestaged()
    assert router._prestaged is None
    off = DispatchRouter(CFG.replace(dispatch=dataclasses.replace(CFG.dispatch,
                                                                  double_buffer=False)))
    off.rank_batch([g0], k0, next_batch=([g1], k1))
    assert off._prestaged is None


def test_rank_fused_is_the_warm_program(windows):
    g, k = windows[0]
    router = DispatchRouter(CFG)
    gen = np.random.default_rng(0)
    init = tuple(gen.random(n).astype(np.float32) for n in (
        g.normal.cov_unique.shape[-1], g.normal.kind.shape[-1],
        g.abnormal.cov_unique.shape[-1], g.abnormal.kind.shape[-1]))
    for seed in (None, init):
        outs, info = router.rank_fused(g, k, seed)
        want = rank_window_warm(device_subset(graph_from_numpy(g, "cpu"), k), seed,
                                CFG.pagerank, CFG.spectrum, k)
        assert info.route == "fused" and len(outs) == 9
        for a, b in zip(outs, want):
            a = np.asarray(a)
            assert a.tobytes() == np.asarray(b, dtype=a.dtype).tobytes()


def test_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 12"):
        DispatchRouter(CFG, mesh=object())


@pytest.mark.parametrize("cap,dispatches", [(8, 1), (2, 2)])
def test_a_burst_coalesces_up_to_the_cap(cap, dispatches):
    """Four abnormal windows in a row with four in flight: one dispatch
    of four windows, or dispatches of at most ``cap``."""
    cfg = CFG.replace(stream=StreamConfig(allowed_lateness_seconds=0.0, pipeline_windows=4),
                      pagerank=PageRankConfig())
    cfg = cfg.replace(dispatch=dataclasses.replace(cfg.dispatch, coalesce_windows=cap))
    src = SyntheticSource(8, [2, 3, 4, 5], SyntheticConfig(**SYNTH), chunk_spans=4000)
    s = run_stream(cfg, src, device="cpu")
    assert s.ranked == 4 and s.dispatches == dispatches
    assert [r.batch_windows for r in s.results if r.ranking] == [min(cap, 4)] * 4
