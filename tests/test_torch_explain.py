"""K15, the explained program, held to the JAX package on the CPU (where
the attribution epilogue's wrapper runs its plain version,
``ops.explain.explain_plain``), on JAX's own explain inputs
(tests/test_explain.py ``kind_case``: 60 ops, 6 kinds, 400 traces, seed
3, each route's views built by JAX's ``build_window_graph`` and carried
over by ``graph_from_numpy``):

* every route, collapse off and on: the port's ``rank_window_explained``
  against JAX's ``rank_window_explained_core`` — top_idx, n_valid and
  n_iters exact; counters, mass, terms and trace_val within rtol 1e-5
  (goodman's and hamann's terms, differences of the counters in
  [-1, 1], relative to max(|term|, 1), as tests/test_torch_all_methods.py
  holds their scores); trace_idx tie-aware, the -inf slots equal;
* ``top_suspects`` truncating, ``top_traces`` past the columns padding
  with (0, -inf), explain off giving the unchanged program's bits, the
  explained program's first five outputs bitwise the traced program's,
  blob and per-leaf staging bitwise each other and JAX's blob twin's;
* the bundle against the float64 oracle (the port's twin of JAX's,
  itself held to JAX's), the bundle's round trip, table and journal
  record, the store's ring and ``GET /explainz`` (JAX's unit tests);
* ``explain_plan``, the card's launch plan.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import partition_case
from microrank_tpu.config import ExplainConfig as JaxExplain
from microrank_tpu.config import PageRankConfig as JaxPageRank
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.explain.extract import rank_window_explained_device
from microrank_tpu.explain.oracle import explain_window_oracle as jax_oracle
from microrank_tpu.graph.build import build_window_graph
from microrank_tpu.rank_backends import jax_tpu
from microrank_tpu.rank_backends.blob import stage_rank_window as jax_stage
from microrank_tpu.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.config import (
    ExplainConfig,
    MicroRankConfig,
    PageRankConfig,
    SpectrumConfig,
)
from microrank_tpu_torch.explain import build_bundle, get_explain_store
from microrank_tpu_torch.explain.bundle import (
    BUNDLE_JSON,
    BUNDLE_TXT,
    ExplainBundle,
    ExplainContext,
)
from microrank_tpu_torch.explain.oracle import explain_window_oracle
from microrank_tpu_torch.explain.store import ExplainStore
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.ops import explain as kx
from microrank_tpu_torch.rank_backends import torch_cuda as tc
from microrank_tpu_torch.rank_backends.blob import stage_rank_window
from microrank_tpu_torch.rank_backends.convert import graph_from_numpy
from microrank_tpu_torch.rank_backends.torch_cuda import fetch_rank_outputs
from microrank_tpu_torch.spectrum.formulas import METHODS
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

EXPLAIN = ExplainConfig(enabled=True, top_traces=5)
KERNELS = ("kind", "packed", "packed_bf16", "packed_blocked", "pcsr", "csr", "coo", "pallas",
           "dense", "dense_bf16")
AUX = {"kind": "kind", "pcsr": "pcsr"}  # every other route reads an "all" build
RTOL = 1e-5
DIFFERENCE_FORMULAS = ("goodman", "hamann")


@pytest.fixture
def registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


@pytest.fixture(scope="module")
def kind_case():
    return generate_case(SyntheticConfig(n_operations=60, n_kinds=6, n_traces=400, seed=3))


@pytest.fixture(scope="module")
def parts(kind_case):
    return partition_case(kind_case)


def host_graph(case, parts, kernel, collapse, retain=False):
    nrm, abn = parts
    return build_window_graph(case.abnormal, nrm, abn, aux=AUX.get(kernel, "all"),
                              collapse=collapse, retain_columns=retain)


def port_graph(graph, kernel):
    return tc.device_subset(graph_from_numpy(tc.host_subset(graph, kernel), "cpu"), kernel)


def jax_explained(graph, kernel, ex=JaxExplain(enabled=True, top_traces=5)):
    out = rank_window_explained_device(
        jax.tree.map(jnp.asarray, jax_tpu.device_subset(graph, kernel)), JaxPageRank(),
        JaxSpectrum(), ex, None, kernel)
    return [np.asarray(a) for a in out]


def port_explained(graph, kernel, ex=EXPLAIN):
    return tc.rank_window_explained(port_graph(graph, kernel), PageRankConfig(),
                                    SpectrumConfig(), ex, kernel)


def close(a, b, rtol=RTOL, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                                          floor)))


def rows_agree(idx_a, val_a, idx_b, val_b, rtol=RTOL):
    """One suspect's top-J of one partition, tie-aware: the -inf slots
    equal, the values rank by rank within ``rtol``, and where the columns
    differ both are in the other list at a tied value."""
    if not np.array_equal(np.isneginf(val_a), np.isneginf(val_b)):
        return False, "-inf slots differ"
    live = ~np.isneginf(val_a)
    ia, ib = [int(i) for i in idx_a[live]], [int(i) for i in idx_b[live]]
    va, vb = val_a[live], val_b[live]
    if not close(va, vb, rtol):
        return False, f"values {va} vs {vb}"
    for r in range(len(ia)):
        if ia[r] == ib[r]:
            continue
        if ia[r] not in ib or ib[r] not in ia:
            # A column at the cut may trade with a tied one outside it.
            if r == len(ia) - 1 or np.isclose(va[r], va[-1], rtol=rtol):
                continue
            return False, f"column {ia[r]} vs {ib[r]} at slot {r}"
        if not close(vb[ib.index(ia[r])], va[r], rtol):
            return False, f"untied swap at slot {r}"
    return True, "ok"


def assert_explained_match(j, t, ke):
    assert int(t[2]) == int(j[2]) and int(t[4]) == int(j[4])
    np.testing.assert_array_equal(t[0], j[0])
    counters, terms, mass, tidx, tval = t[5:]
    assert counters.shape == (4, ke) and terms.shape == (13, ke) and mass.shape == (2, ke)
    assert tidx.dtype == np.int32 and tval.dtype == np.float32
    assert close(counters, j[5]) and close(mass, j[7])
    for m, method in enumerate(METHODS):
        floor = 1.0 if method in DIFFERENCE_FORMULAS else 0.0
        assert close(terms[m], j[6][m], RTOL, floor), (method, terms[m], j[6][m])
    assert tidx.shape == j[8].shape
    for p in range(2):
        for i in range(ke):
            ok, why = rows_agree(j[8][p, i], j[9][p, i], tidx[p, i], tval[p, i])
            assert ok, (p, i, why)


@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_explained_program_matches_jax(kind_case, parts, kernel, collapse):
    graph, *_ = host_graph(kind_case, parts, kernel, collapse)
    j = jax_explained(graph, kernel)
    t = port_explained(graph, kernel)
    assert len(t) == 10
    assert_explained_match(j, t, ke=len(j[0]))


def test_top_suspects_truncates(kind_case, parts):
    graph, *_ = host_graph(kind_case, parts, "coo", "off")
    ex = ExplainConfig(enabled=True, top_traces=3, top_suspects=2)
    j = jax_explained(graph, "coo", JaxExplain(enabled=True, top_traces=3, top_suspects=2))
    t = port_explained(graph, "coo", ex)
    assert t[5].shape == (4, 2) and t[8].shape == (2, 2, 3)
    assert_explained_match(j, t, ke=2)


@pytest.mark.parametrize("kernel", ["kind", "pcsr", "csr"])
def test_top_traces_past_the_columns_pads(kind_case, parts, kernel):
    """J past the padded columns (the collapsed kind axis): the columns,
    then (0, -inf), as JAX pads."""
    graph, *_ = host_graph(kind_case, parts, kernel, "on")
    t_pad = max(int(graph.normal.kind.shape[0]), int(graph.abnormal.kind.shape[0]))
    j_want = t_pad + 3
    j = jax_explained(graph, kernel, JaxExplain(enabled=True, top_traces=j_want))
    t = port_explained(graph, kernel, ExplainConfig(enabled=True, top_traces=j_want))
    assert t[8].shape[-1] == j_want
    assert_explained_match(j, t, ke=len(j[0]))
    for p, g in enumerate((graph.normal, graph.abnormal)):
        pad = t[8][p, :, int(g.kind.shape[0]):]
        assert np.all(pad == 0) and np.all(np.isneginf(t[9][p, :, int(g.kind.shape[0]):]))


def test_explain_off_runs_the_unchanged_program(kind_case, parts):
    graph, *_ = host_graph(kind_case, parts, "kind", "on")
    host = tc.host_subset(graph, "kind")
    cfgs = (PageRankConfig(), SpectrumConfig())
    plain = fetch_rank_outputs(stage_rank_window(host, *cfgs, "kind", "cpu", True,
                                                 conv_trace=True)[0])
    for ex in (None, ExplainConfig(enabled=False)):
        off = fetch_rank_outputs(stage_rank_window(host, *cfgs, "kind", "cpu", True,
                                                   conv_trace=True, explain=ex)[0])
        assert len(off) == 5
        for a, b in zip(plain, off):
            np.testing.assert_array_equal(a, b)
    on = fetch_rank_outputs(stage_rank_window(host, *cfgs, "kind", "cpu", True,
                                              explain=EXPLAIN)[0])
    assert len(on) == 10
    for a, b in zip(plain, on[:5]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel", ["coo", "kind", "pcsr"])
def test_blob_and_leaf_staging(kind_case, parts, kernel):
    """The blob-staged explained program bitwise the per-leaf one, both
    JAX's blob twin's at the stated tolerances."""
    graph, *_ = host_graph(kind_case, parts, kernel, "on")
    host = tc.host_subset(graph, kernel)
    cfgs = (PageRankConfig(), SpectrumConfig())
    blob = fetch_rank_outputs(stage_rank_window(host, *cfgs, kernel, "cpu", True,
                                                explain=EXPLAIN)[0])
    tree = fetch_rank_outputs(stage_rank_window(host, *cfgs, kernel, "cpu", False,
                                                explain=EXPLAIN)[0])
    for a, b in zip(blob, tree):
        np.testing.assert_array_equal(a, b)
    j = [np.asarray(a) for a in jax.device_get(jax_stage(
        jax_tpu.device_subset(graph, kernel), JaxPageRank(), JaxSpectrum(), kernel, True,
        explain=JaxExplain(enabled=True, top_traces=5)))]
    assert_explained_match(j, blob, ke=len(j[0]))


def test_stacked_group_refuses_the_explained_program(kind_case, parts):
    from microrank_tpu_torch.parallel import stack_window_graphs

    graph, *_ = host_graph(kind_case, parts, "pallas", "off")
    stacked = graph_from_numpy(stack_window_graphs([graph, graph]), "cpu")
    with pytest.raises(ValueError, match="one window"):
        tc.rank_window_explained_core(stacked, PageRankConfig(), SpectrumConfig(), EXPLAIN,
                                      "pallas")


# --------------------------------------------------------------- oracle


@pytest.fixture(scope="module")
def oracle_inputs(kind_case, parts):
    nrm, abn = parts
    return build_window_graph(kind_case.abnormal, nrm, abn, aux="all", collapse="off")


@pytest.mark.parametrize("aggregate", [False, True])
def test_oracle_is_jaxs(oracle_inputs, aggregate):
    g, names, ids_n, ids_a = oracle_inputs
    ours = explain_window_oracle(g, names, ids_n, ids_a, aggregate_kinds=aggregate)
    theirs = jax_oracle(g, names, ids_n, ids_a, aggregate_kinds=aggregate)
    assert [s["op"] for s in ours["suspects"]] == [s["op"] for s in theirs["suspects"]]
    for a, b in zip(ours["suspects"], theirs["suspects"]):
        assert a["top_traces"] == b["top_traces"]
        for key in ("counters", "terms", "mass"):
            for name, val in a[key].items():
                assert val == pytest.approx(b[key][name], rel=1e-12, abs=1e-300), (key, name)


@pytest.mark.parametrize("collapse", ["off", "on"])
@pytest.mark.parametrize("kernel", ["kind", "pcsr", "csr", "coo"])
def test_bundle_matches_the_oracle(kind_case, parts, oracle_inputs, kernel, collapse):
    """The bundle against the f64 oracle, tie-aware (JAX's
    ``_assert_bundle_matches_oracle``, its tolerances)."""
    graph, names, ids_n, ids_a, (mn, ma) = host_graph(kind_case, parts, kernel, collapse,
                                                      retain=True)
    ectx = ExplainContext.from_build(graph, ids_n, ids_a, mn, ma)
    bundle = build_bundle(port_explained(graph, kernel), names, ectx, method="dstar2",
                          kernel=kernel)
    g_un, names_u, idsn, idsa = oracle_inputs
    oracle = explain_window_oracle(g_un, names_u, idsn, idsa, top_traces=None,
                                   aggregate_kinds=collapse == "on")
    dev, orc = bundle.suspects, oracle["suspects"]
    assert len(dev) == len(orc)
    agree, reason = tie_aware_topk_agreement(
        [s["op"] for s in dev], [s["score"] for s in dev], [s["op"] for s in orc],
        [s["score"] for s in orc], k=len(dev), rtol=1e-4, exempt_last=True)
    assert agree, reason
    by_op = {s["op"]: s for s in orc}
    for s in dev:
        o = by_op.get(s["op"])
        if o is None:
            continue
        for c in ("ef", "nf", "ep", "np"):
            assert np.isclose(s["counters"][c], o["counters"][c], rtol=2e-5), (s["op"], c)
        for side in ("normal_weight", "abnormal_weight"):
            assert np.isclose(s["mass"][side], o["mass"][side], rtol=2e-5, atol=1e-12)
        for m, val in s["terms"].items():
            assert np.isclose(val, o["terms"][m], rtol=5e-4, atol=1e-9), (s["op"], m)
        for p in ("normal", "abnormal"):
            omap = dict(o["top_traces"][p])
            entries = s["top_traces"][p]
            for e in entries:
                assert e["trace"] in omap, (s["op"], p, e)
                assert np.isclose(e["contribution"], omap[e["trace"]], rtol=5e-4)
            if entries:
                cut = min(e["contribution"] for e in entries)
                kept = {e["trace"] for e in entries}
                beat = {t for t, v in omap.items() if v > cut * (1 + 1e-3)}
                assert beat <= kept, (s["op"], p, beat - kept)


# ------------------------------------------------- bundle + store + API


def test_bundle_roundtrip_table_and_journal_record(kind_case, parts, tmp_path):
    graph, names, ids_n, ids_a, (mn, ma) = host_graph(kind_case, parts, "coo", "off",
                                                      retain=True)
    ectx = ExplainContext.from_build(graph, ids_n, ids_a, mn, ma)
    bundle = build_bundle(port_explained(graph, "coo"), names, ectx, method="dstar2",
                          kernel="coo")
    bundle.data["window"] = {"start": "w0", "end": "w1"}
    path = bundle.write(tmp_path / "b")
    assert path.name == BUNDLE_JSON
    assert (tmp_path / "b" / BUNDLE_TXT).exists()
    loaded = ExplainBundle.load(path)
    assert loaded.data == bundle.data
    assert loaded.top1() == bundle.suspects[0]["op"]
    table = loaded.to_table()
    assert bundle.suspects[0]["op"] in table
    assert "counters ef=" in table and "formulas" in table
    rec = loaded.journal_record()
    assert rec["top1"] == bundle.suspects[0]["op"]
    assert rec["ef_top1"] == pytest.approx(bundle.suspects[0]["counters"]["ef"])
    assert rec["start"] == "w0" and rec["suspects"] == len(bundle.suspects)
    # JAX's bundle of the same window has the same suspects, counters to
    # rtol 1e-5 and the same rendering's lines per suspect.
    from microrank_tpu.explain import build_bundle as jax_build
    from microrank_tpu.explain.bundle import ExplainContext as JaxContext

    jb = jax_build(jax_explained(graph, "coo"), names,
                   JaxContext.from_build(graph, ids_n, ids_a, mn, ma), method="dstar2",
                   kernel="coo")
    assert [s["op"] for s in jb.suspects] == [s["op"] for s in bundle.suspects]
    for a, b in zip(jb.suspects, bundle.suspects):
        for c in ("ef", "nf", "ep", "np"):
            assert b["counters"][c] == pytest.approx(a["counters"][c], rel=RTOL)
        for p in ("normal", "abnormal"):
            assert {e["trace"] for e in b["top_traces"][p]} == {
                e["trace"] for e in a["top_traces"][p]}


def test_explain_store_ring_evicts_oldest():
    store = ExplainStore(capacity=2)
    for i in range(3):
        store.publish(f"w{i}", {"n": i})
    assert store.windows() == ["w1", "w2"]
    assert store.get("w0") is None
    assert store.get("w1") == {"n": 1}
    assert store.latest() == {"n": 2}
    store.configure(capacity=1)
    assert store.windows() == ["w2"]
    # Republishing moves a window to the back instead of duplicating it.
    store.publish("w2", {"n": 9})
    assert len(store) == 1 and store.latest() == {"n": 9}


def test_explainz_endpoint_serves_store(registry):
    from microrank_tpu_torch.obs.server import start_metrics_server

    get_explain_store().publish("2020-01-01 00:00:00", {"schema": 1})
    server = start_metrics_server(0, registry)
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/explainz", timeout=30) as r:
            listing = json.loads(r.read())
        assert "2020-01-01 00:00:00" in listing["windows"]
        assert listing["latest"]["schema"] == 1
        with urllib.request.urlopen(f"{base}/explainz?window=2020-01-01%2000:00:00",
                                    timeout=30) as r:
            assert json.loads(r.read()) == {"schema": 1}
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/explainz?window=nope", timeout=30)
        assert err.value.code == 404
        assert "2020-01-01 00:00:00" in json.loads(err.value.read())["windows"]
    finally:
        server.close()


def test_config_defaults_are_jaxs():
    from microrank_tpu.config import ObsConfig as JaxObs

    ours, theirs = ExplainConfig(), JaxExplain()
    for name in ("enabled", "top_traces", "top_suspects", "on_incident", "store_windows",
                 "journal"):
        assert getattr(ours, name) == getattr(theirs, name), name
    obs = MicroRankConfig().obs
    assert (obs.flight, obs.flight_min_interval_seconds) == (
        JaxObs().flight, JaxObs().flight_min_interval_seconds)
    assert MicroRankConfig().explain == ExplainConfig()


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("t_n,t_a,j,ke,select,tile,lists,passes", [
    (96, 8, 5, 11, "warp", 256, 1, ()),
    (7_168, 448, 5, 11, "warp", 256, 28, (1,)),
    (7_168, 448, 40, 11, "bitonic", 256, 28, (5, 1)),
    (65_536, 100, 5, 11, "warp", 1024, 64, (1,)),
    (262_144, 262_144, 5, 11, "warp", 2048, 128, (1,)),
    (1_310_720, 1_310_720, 5, 11, "warp", 2048, 640, (2, 1)),
    (1_310_720, 1_310_720, 32, 2, "warp", 2048, 640, (10, 1)),
    (300_000, 10, 40, 11, "bitonic", 2048, 147, (3, 1)),
    (10_000, 10, 2048, 1, "bitonic", 4096, 3, (2, 1)),
])
def test_explain_plan(t_n, t_a, j, ke, select, tile, lists, passes):
    plan = kx.explain_plan(t_n, t_a, j, ke)
    assert (plan.select, plan.tile, plan.lists, plan.passes) == (select, tile, lists, passes)
    assert plan.group == tile // j and plan.kernel_launches == 1 + len(passes)
    assert plan.fill_smem == kx.ROWS * tile * 4 + (0 if select == "warp" else tile * 8)
    assert plan.fill_smem <= 227 * 1024 and tile >= 2 * j


@pytest.mark.parametrize("t_n,t_a,j,ke", [(8, 8, 0, 11), (8, 8, kx.J_MAX + 1, 11),
                                          (0, 8, 5, 11), (8, 8, 5, 0),
                                          (2048 * 65536, 8, 5, 11)])
def test_explain_plan_refuses(t_n, t_a, j, ke):
    with pytest.raises(ValueError):
        kx.explain_plan(t_n, t_a, j, ke)


def test_every_route_has_a_view():
    from microrank_tpu_torch.config import KERNELS as ALL

    assert set(kx.ROUTES) == set(ALL) - {"auto"}
    # None of the views a route reads is stripped from it before staging.
    views = {kx.BITMAP: ("cov_bits", "inv_tracelen"), kx.ELL: ("pc_ell_op", "pc_ell_rs", "kind",
                                                               "tracelen"),
             kx.OP_MAJOR: ("inc_indptr_op", "inc_trace_opmajor", "sr_val_opmajor"),
             kx.TRACE_MAJOR: ("inc_op", "inc_trace", "sr_val", "n_inc")}
    for kernel, route in kx.ROUTES.items():
        stripped = set(tc.KERNEL_UNUSED_FIELDS.get(kernel, ()))
        assert not stripped & set(views[route]), kernel
