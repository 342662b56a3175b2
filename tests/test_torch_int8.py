"""kind_precision="int8" (K2-int8) held to the JAX package on the CPU,
and its two kernels (the scale launch ``quantize_amax`` and the int8
pattern pair) held to their plain versions on the card.

* quantization: the port's ``quantize_i8`` is bitwise JAX's over random
  and adversarial vectors (all zero, one nonzero, exact half steps,
  values at +-amax, subnormals): XLA's CPU flushes subnormals to zero
  (an all-subnormal vector: amax 0, scale 1, q 0), and the port flushes
  the operand products by the same compare in both versions;
* the pair: the plain int8 pair is bitwise JAX's int8 ``cov_pair``
  (the expression of ``jax_tpu._partition_setup``, with JAX's own
  ``quantize_i8``) on the same operands, and the products of a kind
  window bitwise / rtol 1e-6 (the f32 call-graph term) JAX's
  ``_partition_setup`` matvecs;
* the rank program and the lane, collapse on and off: tie-aware top-k
  equal to JAX's int8 at rtol 5e-3 with the same top-1 and ``n_iters``,
  and to the float64 oracle at JAX's own int8 gate, rtol 5e-2
  (tests/test_kind_kernel.py::test_kind_parity_vs_f64_oracle);
* on the card (``cuda`` marker, skipped here): the scales and the pair
  bitwise their plain versions computed on the CPU (the scales also on
  all-subnormal and mixed operands), repeatable over 50 launches, the
  scratch reset, and the lane's launches counted.

The JAX package is imported inside the tests that use it, so the card's
machine (no JAX) can run the card tests alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_int8.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from microrank_tpu_torch.config import MicroRankConfig, PageRankConfig, RuntimeConfig
from microrank_tpu_torch.ops import pattern, setup, spmv, step
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

CASE = SyntheticConfig(n_operations=60, n_traces=800, n_kinds=24, child_keep_prob=0.6, seed=5)


def adversarial(name, n, rng):
    """An operand vector of length n (float32)."""
    if name == "random":
        return (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6)).astype(np.float32)
    if name == "all_zero":
        return np.zeros(n, np.float32)
    if name == "one_nonzero":
        x = np.zeros(n, np.float32)
        x[n // 2] = -3.25
        return x
    if name == "half_steps":
        # Values exactly halfway between two quantization steps: round
        # half to even decides each one.
        amax = np.float32(5.0)
        scale = np.float32(amax / np.float32(127.0))
        x = ((rng.integers(-126, 126, n) + 0.5) * scale).astype(np.float32)
        x[0] = amax
        return x
    if name == "at_amax":
        x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
        x[: n // 3] = 1.0
        x[n // 3: 2 * n // 3] = -1.0
        return x
    if name == "subnormal":
        return (rng.uniform(-1.0, 1.0, n) * 1e-39).astype(np.float32)
    if name == "subnormal_scale":
        # Normal values whose amax / 127 is subnormal (amax below
        # 127 * FLT_MIN), beside zeros and subnormals: XLA's CPU flushes
        # the scale to 0, so q is +-127, or 0 where the operand is 0.
        x = (rng.uniform(-1.0, 1.0, n) * 1e-37).astype(np.float32)
        x[::5] = 0.0
        x[1::7] = 1e-40
        x[0] = -1.2e-37
        return x
    raise ValueError(name)


VECTORS = ["random", "all_zero", "one_nonzero", "half_steps", "at_amax", "subnormal_scale"]


@pytest.mark.parametrize("name", VECTORS)
def test_quantize_i8_is_bitwise_jax(name):
    import jax.numpy as jnp
    from microrank_tpu.rank_backends import jax_tpu

    rng = np.random.default_rng(len(name))
    for n in (1, 7, 300):
        x = adversarial(name, n, rng)
        qj, sj = jax_tpu.quantize_i8(jnp.asarray(x))
        qt, st = pattern.quantize_i8(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def test_quantize_i8_matches_jax_over_many_random_vectors():
    import jax.numpy as jnp
    from microrank_tpu.rank_backends import jax_tpu

    rng = np.random.default_rng(0)
    for i in range(300):
        n = (1, 64, 199)[i % 3]  # few shapes: one jit compile each
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8)).astype(np.float32)
        qj, sj = jax_tpu.quantize_i8(jnp.asarray(x))
        qt, st = pattern.quantize_i8(torch.from_numpy(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def test_subnormal_operands_are_bitwise_jax():
    # XLA's CPU flushes subnormals to zero: JAX quantizes an all-
    # subnormal vector to q = 0 with scale 1, and a subnormal beside a
    # normal amax to q = 0. The port flushes them by the same compare
    # (pattern.flush_subnormal), so both give the same bits.
    import jax.numpy as jnp
    from microrank_tpu.rank_backends import jax_tpu

    rng = np.random.default_rng(7)
    for x in (
        adversarial("subnormal", 300, rng),
        np.concatenate([adversarial("subnormal", 150, rng), adversarial("random", 150, rng)]),
    ):
        qj, sj = jax_tpu.quantize_i8(jnp.asarray(x))
        qt, st = pattern.quantize_i8(torch.from_numpy(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    assert float(sj) != 1.0  # the mixed vector's scale comes from its normal values


def test_subnormal_scale_is_bitwise_jax():
    # amax / 127 below FLT_MIN: XLA's CPU flushes the quotient, so JAX's
    # scale is 0 and its q +-127, 0 where the operand is 0 (or a flushed
    # subnormal); the port's quantize_scale flushes it by the same
    # compare, eagerly and under jit alike.
    import jax
    import jax.numpy as jnp
    from microrank_tpu.rank_backends import jax_tpu

    rng = np.random.default_rng(16)
    for n in (1, 7, 300):
        x = adversarial("subnormal_scale", n, rng)
        qt, st = pattern.quantize_i8(torch.from_numpy(x))
        assert float(st) == 0.0
        for qj, sj in (jax_tpu.quantize_i8(jnp.asarray(x)),
                       jax.jit(jax_tpu.quantize_i8)(jnp.asarray(x))):
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        assert set(np.unique(qt.numpy())) <= {-127, 0, 127}
    # Stacked rows: each window's own scale, flushed or not.
    rows = np.stack([adversarial("subnormal_scale", 64, rng),
                     adversarial("random", 64, rng)])
    st = pattern.quantize_scale(torch.from_numpy(rows))
    for row, s in zip(rows, st):
        assert s.numpy().tobytes() == np.asarray(jax_tpu.quantize_i8(jnp.asarray(row))[1]).tobytes()


def int8_group(rng, v, k, m=None):
    """A one-partition group over a random (or given) 0/1 pattern, its
    weights and its dense pattern."""
    if m is None:
        m = (rng.random((v, k)) < 0.35).astype(np.uint8)
    w_len = rng.uniform(0.0, 1.0, k).astype(np.float32)
    w_cov = rng.uniform(0.0, 1.0, v).astype(np.float32)
    group = pattern.pattern_group(
        [torch.from_numpy(np.packbits(m, axis=1))], [torch.from_numpy(w_len)],
        [torch.from_numpy(w_cov)], [None], [k],
    )
    return group, m, w_len, w_cov


def jax_int8_cov_pair(m, x_col, x_row):
    """JAX's int8 ``cov_pair`` (jax_tpu._partition_setup), as written
    there, on its own ``quantize_i8``."""
    import jax.numpy as jnp
    from microrank_tpu.rank_backends.jax_tpu import quantize_i8

    q_mat = jnp.asarray(m.astype(np.int8))
    qc, sc = quantize_i8(jnp.asarray(x_col))
    qr, sr = quantize_i8(jnp.asarray(x_row))
    y_fwd = sc * jnp.dot(q_mat, qc, preferred_element_type=jnp.int32).astype(jnp.float32)
    y_bwd = sr * jnp.dot(qr, q_mat, preferred_element_type=jnp.int32).astype(jnp.float32)
    return np.asarray(y_fwd), np.asarray(y_bwd)


@pytest.mark.parametrize("name", VECTORS)
@pytest.mark.parametrize("v,k", [(37, 13), (300, 1100)])
def test_plain_int8_pair_is_bitwise_jax_cov_pair(name, v, k):
    rng = np.random.default_rng(v * k + len(name))
    group, m, w_len, w_cov = int8_group(rng, v, k)
    # Operands chosen so that rv * w_len and sv * w_cov are the named
    # vectors' values (w = 1 where they must be exact).
    a, b = adversarial(name, k, rng), adversarial(name, v, rng)
    p = group.parts[0]
    p.w_len.fill_(1.0)
    p.w_cov.fill_(1.0)
    rv, sv = torch.from_numpy(a), torch.from_numpy(b)
    scales = pattern.quantize_scales(group, [rv], [sv])
    (y_fwd, y_bwd, x_ss), = pattern.pattern_pair_group(group, [rv], [sv], "int8", scales)
    assert x_ss is None
    j_fwd, j_bwd = jax_int8_cov_pair(m, a, b)
    assert y_fwd.numpy().tobytes() == j_fwd.tobytes()
    assert y_bwd.numpy().tobytes() == j_bwd.tobytes()


@pytest.mark.parametrize("v,k", [(37, 13), (300, 1100)])
def test_plain_int8_pair_on_subnormal_operands_is_bitwise_jax(v, k):
    # The flush, through the pair: all-subnormal operands give JAX's
    # zeros, and products x * w that fall below FLT_MIN (normal x and w)
    # are flushed before the amax and the quantization, as XLA's CPU
    # flushes them.
    rng = np.random.default_rng(v + k)
    group, m, _, _ = int8_group(rng, v, k)
    group.parts[0].w_len.fill_(1.0)
    group.parts[0].w_cov.fill_(1.0)
    a, b = adversarial("subnormal", k, rng), adversarial("subnormal", v, rng)
    rv, sv = torch.from_numpy(a), torch.from_numpy(b)
    scales = pattern.quantize_scales(group, [rv], [sv])
    (y_fwd, y_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv], "int8", scales)
    j_fwd, j_bwd = jax_int8_cov_pair(m, a, b)
    assert not j_fwd.any() and not j_bwd.any()
    assert y_fwd.numpy().tobytes() == j_fwd.tobytes()
    assert y_bwd.numpy().tobytes() == j_bwd.tobytes()
    # Mixed: weights of 1e-30 turn half the products subnormal.
    w_len = np.where(rng.random(k) < 0.5, 1e-30, 1.0).astype(np.float32)
    w_cov = np.where(rng.random(v) < 0.5, 1e-30, 1.0).astype(np.float32)
    group.parts[0].w_len.copy_(torch.from_numpy(w_len))
    group.parts[0].w_cov.copy_(torch.from_numpy(w_cov))
    a = rng.uniform(1e-12, 1e-9, k).astype(np.float32)
    b = rng.uniform(1e-12, 1e-9, v).astype(np.float32)
    rv, sv = torch.from_numpy(a), torch.from_numpy(b)
    scales = pattern.quantize_scales(group, [rv], [sv])
    (y_fwd, y_bwd, _), = pattern.pattern_pair_group(group, [rv], [sv], "int8", scales)
    j_fwd, j_bwd = jax_jit_int8_cov_pair(m, a, w_len, b, w_cov)
    assert y_fwd.numpy().tobytes() == j_fwd.tobytes()
    assert y_bwd.numpy().tobytes() == j_bwd.tobytes()


def jax_jit_int8_cov_pair(m, a, w_len, b, w_cov):
    """JAX's int8 ``cov_pair`` on the operands a * w_len and b * w_cov,
    the products taken inside one jitted program, as the kind kernel
    takes them."""
    import jax
    import jax.numpy as jnp
    from microrank_tpu.rank_backends.jax_tpu import quantize_i8

    @jax.jit
    def pair(q_mat, a, w_len, b, w_cov):
        qc, sc = quantize_i8(a * w_len)
        qr, sr = quantize_i8(b * w_cov)
        y_fwd = sc * jnp.dot(q_mat, qc, preferred_element_type=jnp.int32).astype(jnp.float32)
        y_bwd = sr * jnp.dot(qr, q_mat, preferred_element_type=jnp.int32).astype(jnp.float32)
        return y_fwd, y_bwd

    y_fwd, y_bwd = pair(jnp.asarray(m.astype(np.int8)), a, w_len, b, w_cov)
    return np.asarray(y_fwd), np.asarray(y_bwd)


def test_scales_are_per_operand_like_jax():
    import jax.numpy as jnp
    from microrank_tpu.rank_backends.jax_tpu import quantize_i8

    rng = np.random.default_rng(4)
    groups = [int8_group(rng, 40, 20), int8_group(rng, 40, 9)]
    group = pattern.PatternGroup(
        parts=tuple(g.parts[0] for g, *_ in groups), amax_scratch=groups[0][0].amax_scratch
    )
    rvs = [torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32)) for n in (20, 9)]
    svs = [torch.from_numpy(rng.uniform(-2, 2, 40).astype(np.float32)) for _ in range(2)]
    got = pattern.quantize_scales(group, rvs, svs)
    want = [
        np.asarray(quantize_i8(jnp.asarray((x * w).numpy()))[1])
        for p, rv, sv in zip(group.parts, rvs, svs)
        for x, w in ((rv, p.w_len), (sv, p.w_cov))
    ]
    assert got.shape == (4,)
    assert got.numpy().tobytes() == np.stack(want).astype(np.float32).tobytes()


def test_int8_pair_checks_its_inputs():
    rng = np.random.default_rng(1)
    group, _, _, _ = int8_group(rng, 10, 12)
    rv, sv = torch.ones(12), torch.ones(10)
    with pytest.raises(ValueError, match="scales"):
        pattern.pattern_pair_group(group, [rv], [sv], "int8")
    with pytest.raises(ValueError, match="precision"):
        pattern.pattern_pair_group(group, [rv], [sv], "fp8")
    packed = pattern.pattern_group(
        [group.parts[0].pattern], [torch.ones(12)], [torch.ones(10)], [torch.ones(10)], [12]
    )
    with pytest.raises(ValueError, match="kind pattern only"):
        pattern.pattern_pair_group(packed, [rv], [sv], "int8", torch.ones(2))


def jax_kind_graph(collapse, case=None):
    from conftest import partition_case
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.testing import SyntheticConfig as JaxSynthetic
    from microrank_tpu.testing import generate_case as jax_generate_case

    case = case or jax_generate_case(
        JaxSynthetic(n_operations=30, n_kinds=6, n_traces=200, seed=3)
    )
    nrm, abn = partition_case(case)
    graph, names, _, _ = build_window_graph(case.abnormal, nrm, abn, aux="kind", collapse=collapse)
    return case, nrm, abn, graph, names


@pytest.mark.parametrize("collapse", ["on", "off"])
def test_int8_products_match_jax_partition_setup(collapse):
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.rank_backends import jax_tpu
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import device_subset, host_subset

    *_, graph, _ = jax_kind_graph(collapse)
    tg = device_subset(graph_from_numpy(host_subset(graph, "kind"), "cpu"), "kind")
    rng = np.random.default_rng(0)
    rvs, svs, want = [], [], []
    for part, anomaly in (("normal", False), ("abnormal", True)):
        g = getattr(graph, part)
        mv = jax_tpu._partition_setup(
            jax.tree.map(jnp.asarray, g), anomaly, JaxPageRank(kind_precision="int8"), None, "kind"
        )[0]
        sv = rng.uniform(0.0, 1.0, g.cov_unique.shape[0]).astype(np.float32)
        rv = rng.uniform(0.0, 1.0, g.kind.shape[0]).astype(np.float32)
        want.append([np.asarray(y) for y in mv(jnp.asarray(sv), jnp.asarray(rv))])
        rvs.append(torch.from_numpy(rv))
        svs.append(torch.from_numpy(sv))
    scales = pattern.quantize_scales(tg.pattern_group, rvs, svs)
    pairs = pattern.pattern_pair_group(tg.pattern_group, rvs, svs, "int8", scales)
    ss = spmv.coo_spmv_group(tg.spmv_group, svs)
    alpha = torch.tensor(PageRankConfig().call_weight, dtype=torch.float32)
    for (y_fwd, y_bwd, _), y_ss, (j_s, j_r) in zip(pairs, ss, want):
        # The int8 half is exact; the f32 call-graph term differs from
        # JAX's compensated row sums in the last bits.
        assert y_bwd.numpy().tobytes() == j_r.tobytes()
        np.testing.assert_allclose((y_fwd + alpha * y_ss).numpy(), j_s, rtol=1e-6)


def rank_int8_both(graph):
    import jax
    import jax.numpy as jnp
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import SpectrumConfig as JaxSpectrum
    from microrank_tpu.rank_backends import jax_tpu
    from microrank_tpu_torch.config import SpectrumConfig
    from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
    from microrank_tpu_torch.rank_backends.torch_cuda import (
        device_subset,
        fetch_rank_outputs,
        host_subset,
        rank_window_traced_core,
    )

    j = jax_tpu.rank_window_traced_device(
        jax.tree.map(jnp.asarray, graph), JaxPageRank(kind_precision="int8"), JaxSpectrum(),
        None, "kind",
    )
    tg = device_subset(graph_from_numpy(host_subset(graph, "kind"), "cpu"), "kind")
    t = fetch_rank_outputs(rank_window_traced_core(
        tg, PageRankConfig(kind_precision="int8"), SpectrumConfig(), "kind"
    ))
    return tuple(np.asarray(a) for a in j), t


@pytest.mark.parametrize("collapse", ["on", "off"])
def test_int8_rank_program_matches_jax_and_the_f64_oracle(collapse):
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.graph import build_window_graph
    from microrank_tpu.rank_backends.sparse_oracle import rank_window_sparse

    case, nrm, abn, graph, names = jax_kind_graph(collapse)
    (j_idx, j_sc, j_nv, j_res, j_it), (t_idx, t_sc, t_nv, t_res, t_it) = rank_int8_both(graph)
    assert (int(j_nv), int(j_it)) == (t_nv, t_it)
    assert int(j_idx[0]) == int(t_idx[0])
    n = t_nv
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:n]), list(j_sc[:n]), list(t_idx[:n]), list(t_sc[:n]), k=n, rtol=5e-3,
    )
    assert ok, why
    # JAX's own int8 gate against the float64 oracle on an uncollapsed
    # build.
    cfg = JaxConfig()
    g_o, names_o, _, _ = build_window_graph(case.abnormal, nrm, abn, aux="none", collapse="off")
    top_o, sc_o = rank_window_sparse(g_o, names_o, cfg.pagerank, cfg.spectrum)
    ok, why = tie_aware_topk_agreement(
        [names[int(i)] for i in t_idx[:n]], [float(s) for s in t_sc[:n]], top_o, sc_o,
        k=5, rtol=5e-2, exempt_last=True,
    )
    assert ok, why


@pytest.mark.parametrize("case_name", ["small_case", "pod_case"])
def test_int8_rank_program_matches_jax_on_shared_cases(case_name, request):
    case = request.getfixturevalue(case_name)
    _, _, _, graph, names = jax_kind_graph("on", case)
    (j_idx, j_sc, j_nv, _, j_it), (t_idx, t_sc, t_nv, _, t_it) = rank_int8_both(graph)
    assert (int(j_nv), int(j_it)) == (t_nv, t_it)
    assert int(j_idx[0]) == int(t_idx[0]) and names[t_idx[0]] == case.fault_pod_op
    ok, why = tie_aware_topk_agreement(
        list(j_idx[:t_nv]), list(j_sc[:t_nv]), list(t_idx[:t_nv]), list(t_sc[:t_nv]),
        k=t_nv, rtol=5e-3,
    )
    assert ok, why


@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_int8_lane_matches_jax(tmp_path, collapse):
    from microrank_tpu.config import IngestConfig as JaxIngest
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import RuntimeConfig as JaxRuntime
    from microrank_tpu.pipeline.table_runner import run_rca_native as jax_run
    from microrank_tpu_torch.config import IngestConfig
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(SyntheticConfig(
        n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5
    ))
    normal, abnormal = case.write_csvs(tmp_path)
    jres = jax_run(normal, abnormal, JaxConfig(
        pagerank=JaxPageRank(kind_precision="int8"),
        runtime=JaxRuntime(kernel="kind", collapse_kinds=collapse, tuned_policy="off"),
        ingest=JaxIngest(enabled=False),
    ))
    tres = run_rca_native(normal, abnormal, MicroRankConfig(
        pagerank=PageRankConfig(kind_precision="int8"),
        runtime=RuntimeConfig(kernel="kind", collapse_kinds=collapse),
        ingest=IngestConfig(enabled=False),
    ), device="cpu")
    ranked = [r for r in tres if r.ranking]
    assert ranked and ranked[0].ranking[0][0] == case.fault_pod_op
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert (j.start, j.kernel, j.rank_iterations) == (t.start, t.kernel, t.rank_iterations)
        if not j.ranking:
            assert not t.ranking
            continue
        assert j.ranking[0][0] == t.ranking[0][0]
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in j.ranking], [s for _, s in j.ranking],
            [n for n, _ in t.ranking], [s for _, s in t.ranking],
            k=len(j.ranking), rtol=5e-3,
        )
        assert ok, why


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def two_part_case(seed, v, k, device):
    """A two-partition int8 group (equal rows and columns inside) on
    ``device`` and on the CPU, with rv / sv on both."""
    rng = np.random.default_rng(seed)
    host, vecs, ks = [], [], []
    for part in range(2):
        kk = k if part == 0 else k // 7 + 3
        m = (rng.random((v, kk)) < 0.3).astype(np.uint8)
        m[v // 2] = m[0]
        m[:, kk - 1] = m[:, 1]
        host.append([torch.from_numpy(np.packbits(m, axis=1))] + [
            torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32)) for n in (kk, v)
        ])
        vecs.append([torch.from_numpy(rng.uniform(-1.0, 1.0, n).astype(np.float32))
                     for n in (kk, v)])
        ks.append(kk)

    def build(dev):
        group = pattern.pattern_group(
            [h[0].to(dev) for h in host], [h[1].to(dev) for h in host],
            [h[2].to(dev) for h in host], [None, None], ks,
        )
        return group, [x[0].to(dev) for x in vecs], [x[1].to(dev) for x in vecs]

    return build(device), build("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("v,k", [(3000, 7000), (300, 1100), (5120, 256)])
def test_int8_kernels_match_cpu_plain_bitwise(cuda_device, v, k):
    (group, rvs, svs), (cg, crvs, csvs) = two_part_case(9, v, k, cuda_device)
    before = (pattern.quantize_scales.launches, pattern.pattern_pair_group.launches)
    scales = pattern.quantize_scales(group, rvs, svs)
    outs = pattern.pattern_pair_group(group, rvs, svs, "int8", scales)
    torch.cuda.synchronize()
    assert (pattern.quantize_scales.launches, pattern.pattern_pair_group.launches) == (
        before[0] + 1, before[1] + 1
    )
    want_scales = pattern.quantize_scales_plain(cg, crvs, csvs)
    assert torch.equal(scales.cpu(), want_scales)
    ref = pattern.pattern_pair_plain(cg, crvs, csvs, "int8", want_scales)
    for got, want in zip(outs, ref):
        assert got[2] is None and want[2] is None
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    for (y_fwd, y_bwd, _), p in zip(outs, group.parts):
        assert y_fwd[0] == y_fwd[v // 2] and y_bwd[1] == y_bwd[p.n_cols - 1]
        assert not p.counters.any()
    assert not group.amax_scratch.any()  # the maxima and the count reset


@pytest.mark.cuda
def test_quantize_amax_on_subnormal_operands_is_bitwise_plain(cuda_device):
    # The card's scale launch flushes subnormal products by the plain
    # version's compare: all-subnormal operands give scale 1, mixed ones
    # the normal products' amax.
    rng = np.random.default_rng(12)
    v, k = 300, 1100
    group, _, _, _ = int8_group(rng, v, k)
    sub = [torch.from_numpy(adversarial("subnormal", n, rng)) for n in (k, v)]
    mixed = [torch.from_numpy(rng.uniform(1e-12, 1e-9, n).astype(np.float32)) for n in (k, v)]
    weights = [torch.from_numpy(np.where(rng.random(n) < 0.5, 1e-30, 1.0).astype(np.float32))
               for n in (k, v)]
    on_dev = pattern.pattern_group(
        [group.parts[0].pattern.to(cuda_device)],
        [weights[0].to(cuda_device)], [weights[1].to(cuda_device)], [None], [k],
    )
    host = pattern.pattern_group(
        [group.parts[0].pattern], [weights[0]], [weights[1]], [None], [k],
    )
    for rv, sv in (sub, mixed, (sub[0], mixed[1])):
        want = pattern.quantize_scales_plain(host, [rv], [sv])
        got = pattern.quantize_scales(on_dev, [rv.to(cuda_device)], [sv.to(cuda_device)])
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    assert float(pattern.quantize_scales_plain(host, sub[:1], sub[1:])[0]) == 1.0
    torch.cuda.synchronize()
    assert not on_dev.amax_scratch.any()


@pytest.mark.cuda
def test_int8_kernels_on_a_subnormal_scale_are_bitwise_plain(cuda_device):
    # Operands whose amax / 127 is subnormal: the scale launch flushes
    # it to 0 as the plain version (and XLA's CPU) does, and the pair
    # quantizes to +-127, 0 where the operand is 0, as the plain version.
    rng = np.random.default_rng(13)
    v, k = 300, 1100
    group, _, _, _ = int8_group(rng, v, k)
    bits = group.parts[0].pattern

    def ones_group(dev):
        return pattern.pattern_group([bits.to(dev)], [torch.ones(k, device=dev)],
                                     [torch.ones(v, device=dev)], [None], [k])

    host, on_dev = ones_group("cpu"), ones_group(cuda_device)
    rv, sv = (torch.from_numpy(adversarial("subnormal_scale", n, rng)) for n in (k, v))
    want = pattern.quantize_scales_plain(host, [rv], [sv])
    assert not want.any()
    got = pattern.quantize_scales(on_dev, [rv.to(cuda_device)], [sv.to(cuda_device)])
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    ref = pattern.pattern_pair_plain(host, [rv], [sv], "int8", want)
    outs = pattern.pattern_pair_group(on_dev, [rv.to(cuda_device)], [sv.to(cuda_device)],
                                      "int8", got)
    torch.cuda.synchronize()
    for (g_fwd, g_bwd, _), (w_fwd, w_bwd, _) in zip(outs, ref):
        assert g_fwd.cpu().numpy().tobytes() == w_fwd.numpy().tobytes()
        assert g_bwd.cpu().numpy().tobytes() == w_bwd.numpy().tobytes()
    assert not on_dev.amax_scratch.any()


@pytest.mark.cuda
def test_int8_kernels_repeatable_over_50_launches(cuda_device):
    (group, rvs, svs), _ = two_part_case(10, 3072, 7168, cuda_device)

    def once():
        s = pattern.quantize_scales(group, rvs, svs)
        outs = pattern.pattern_pair_group(group, rvs, svs, "int8", s)
        return torch.cat([s] + [t for o in outs for t in o if t is not None])

    first = once()
    for _ in range(50):
        assert torch.equal(once(), first)
    torch.cuda.synchronize()
    assert not group.amax_scratch.any()


@pytest.mark.cuda
@pytest.mark.parametrize("collapse", ["auto", "off"])
def test_int8_lane_on_cuda_matches_cpu(cuda_device, tmp_path, collapse):
    from microrank_tpu_torch.pipeline import run_rca_native

    case = generate_case(CASE)
    normal, abnormal = case.write_csvs(tmp_path)
    cfg = MicroRankConfig(
        pagerank=PageRankConfig(kind_precision="int8"),
        runtime=RuntimeConfig(kernel="kind", collapse_kinds=collapse),
    )
    pattern.quantize_scales.launches = pattern.pattern_pair_group.launches = 0
    step.power_step.launches = setup.rank_setup.scale_launches = 0
    gpu = [r for r in run_rca_native(normal, abnormal, cfg, device="cuda") if r.ranking]
    cpu = [r for r in run_rca_native(normal, abnormal, cfg, device="cpu") if r.ranking]
    assert gpu and gpu[0].ranking[0][0] == case.fault_pod_op
    # No scale launch: the set-up's launch gives the first step's scales
    # (one a window) and the step kernel every later step's; one int8
    # pair launch and one step launch per step.
    assert pattern.quantize_scales.launches == 0
    assert setup.rank_setup.scale_launches == len(gpu)
    assert pattern.pattern_pair_group.launches == 25 * len(gpu)
    assert step.power_step.launches == 25 * len(gpu)
    # The kernels are bitwise their plain versions; the rest of the rank
    # program reduces in the card's order, and a last-bit difference in
    # an operand can move its int8 step: JAX's int8 tolerance.
    assert len(gpu) == len(cpu)
    for g, c in zip(gpu, cpu):
        assert g.rank_iterations == c.rank_iterations and g.ranking[0][0] == c.ranking[0][0]
        ok, why = tie_aware_topk_agreement(
            [n for n, _ in c.ranking], [s for _, s in c.ranking],
            [n for n, _ in g.ranking], [s for _, s in g.ranking],
            k=len(c.ranking), rtol=5e-3,
        )
        assert ok, why


def test_int8_config_runs_where_jax_runs_it():
    from microrank_tpu.config import PageRankConfig as JaxPageRank

    assert PageRankConfig(kind_precision="int8") == dataclasses.replace(
        PageRankConfig(), kind_precision=JaxPageRank(kind_precision="int8").kind_precision
    )
