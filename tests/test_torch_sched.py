"""The device scheduler (``microrank_tpu_torch.sched``), the stream
engine's co-deploy hook and the warm restart on the CPU, mirroring the
JAX package's tests/test_sched.py.

* The store's policy (token buckets, weighted fair share, soft quotas,
  deadline expiry at dequeue, lane priority under adversarial mixes) is
  driven directly, with time passed in; the same sequences run through
  JAX's store give the same dispatch order.
* Co-deploy: serve through a ``DeviceScheduler`` is bitwise serve solo
  (and tie-aware JAX's solo serve, rtol 1e-5); the stream engine through
  the same scheduler beside serve gives the solo engine's windows,
  rankings (bitwise) and incidents, and JAX's solo engine's counts on the
  same timeline (JAX's frames in ``datetime64[ns]``, as
  tests/test_torch_stream_engine.py casts them: JAX's own co-deploy test
  sees one window under pandas 3's microsecond parse).
* Warm restart: shapes a serve (or stream) process dispatched reach the
  manifest; a restarted process dispatches them before its first window.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import pytest

from microrank_tpu_torch.config import (
    MicroRankConfig,
    RuntimeConfig,
    SchedConfig,
    ServeConfig,
    StreamConfig,
)
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.sched import (
    LANE_BACKFILL,
    LANE_INCIDENT,
    LANE_SERVE,
    DeviceScheduler,
    ParkedEntry,
    ParkedWindowStore,
    TokenBucket,
    WeightedFairQueue,
)
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.testing.synthetic import spans_table
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

SYNTH = dict(n_operations=24, n_traces=120, seed=7)
STREAM_SYNTH = dict(n_operations=12, n_traces=50, seed=11)


@pytest.fixture
def registry():
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


@pytest.fixture(autouse=True)
def manifest_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MICRORANK_JIT_CACHE", str(tmp_path / "jit"))


@pytest.fixture(scope="module")
def tables():
    case = generate_case(SyntheticConfig(**SYNTH))
    return (spans_table(case.normal, case.n_operations),
            spans_table(case.abnormal, case.n_operations))


@pytest.fixture(scope="module")
def records():
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing import generate_case as jax_generate

    df = jax_generate(JaxSynth(**SYNTH)).abnormal.copy()
    df["startTime"] = df["startTime"].astype(str)
    df["endTime"] = df["endTime"].astype(str)
    return df.to_dict("records")


def _store(**sched_kw):
    serve_cfg = sched_kw.pop("serve_cfg", None)
    return ParkedWindowStore(SchedConfig(**sched_kw), serve_cfg=serve_cfg)


def _entry(lane, tenant, key=None, deadline=None, cost=1.0):
    return ParkedEntry(lane, tenant, key if key is not None else ("k", object()),
                       payload=tenant, runner=lambda p: None, deadline=deadline, cost=cost)


# ------------------------------------------------------------ token bucket


def test_token_bucket_refills_and_carries_debt():
    b = TokenBucket(rate=2.0, burst=4.0, now=100.0)
    assert b.tokens == 4.0
    b.take(6.0)
    assert b.tokens == -2.0
    b.refill(101.0)
    assert b.tokens == 0.0
    b.refill(200.0)
    assert b.tokens == 4.0
    z = TokenBucket(rate=0.0, burst=4.0, now=0.0)
    z.refill(1e9)
    assert z.tokens == 0.0


# -------------------------------------------------- weighted fair share


def test_fair_share_converges_to_configured_weights():
    store = _store(tenant_weights=(("a", 1.0), ("b", 2.0), ("c", 4.0)))
    for _ in range(80):
        for t in "abc":
            store.park(_entry(LANE_BACKFILL, t))
    order = [b[0].tenant for b in store.take_ready(force=True)]
    assert len(order) == 240
    for n in (35, 70, 140):
        for t, w in (("a", 1.0), ("b", 2.0), ("c", 4.0)):
            expected = n * w / 7.0
            assert abs(order[:n].count(t) - expected) <= max(1.0, 0.1 * expected)


def test_weighted_fair_queue_shares_and_round_robin_default():
    q = WeightedFairQueue({"a": 1.0, "b": 3.0})
    for i in range(40):
        q.push("a", ("a", i))
        q.push("b", ("b", i))
    first = [q.pop()[0] for _ in range(40)]
    assert abs(first.count("b") - 30) <= 3
    q2 = WeightedFairQueue()
    for i in range(3):
        q2.push("x", f"x{i}")
        q2.push("y", f"y{i}")
    assert [q2.pop() for _ in range(6)] == ["x0", "y0", "x1", "y1", "x2", "y2"]
    assert q2.pop() is None and not q2


# --------------------------------------------------------- quotas


def test_zero_quota_tenant_sorts_last_but_nothing_starves():
    store = _store(tenant_rates=(("bg", 0.0),))
    for _ in range(20):
        store.park(_entry(LANE_BACKFILL, "bg"))
        store.park(_entry(LANE_BACKFILL, "fg"))
    order = [b[0].tenant for b in store.take_ready(force=True)]
    assert order == ["fg"] * 20 + ["bg"] * 20
    assert store.tenant_shares() == {"fg": 20, "bg": 20}


def test_quota_throttle_is_temporary_and_metered(registry):
    store = _store(tenant_rates=(("meter", 1.0),), burst=2.0)
    t0 = time.monotonic()
    for _ in range(4):
        store.park(_entry(LANE_BACKFILL, "meter"))
        store.park(_entry(LANE_BACKFILL, "free"))
    order = [b[0].tenant for b in store.take_ready(force=True, now=t0)]
    assert sorted(order[:2]) == ["free", "meter"]
    assert order.count("meter") == 4
    assert registry.get("microrank_sched_throttled_total").value(tenant="meter") >= 1
    for _ in range(2):
        store.park(_entry(LANE_BACKFILL, "meter"))
        store.park(_entry(LANE_BACKFILL, "free"))
    order2 = [b[0].tenant for b in store.take_ready(force=True, now=t0 + 3600.0)]
    assert "meter" in order2[:2]


def test_store_order_is_jax(registry):
    """The same parks, weights, rates and clock through JAX's store and
    the port's give the same dispatch order (tenant, lane, key)."""
    from microrank_tpu.config import SchedConfig as JaxSched
    from microrank_tpu.config import ServeConfig as JaxServe
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import set_registry as jax_set_registry
    from microrank_tpu.sched import ParkedEntry as JaxEntry
    from microrank_tpu.sched import ParkedWindowStore as JaxStore

    jax_set_registry(JaxRegistry())
    rng = random.Random(3)
    kw = dict(tenant_weights=(("a", 2.0), ("c", 0.5)), tenant_rates=(("b", 1.0),), burst=2.0)
    ours = ParkedWindowStore(SchedConfig(**kw), serve_cfg=ServeConfig(max_batch_windows=3,
                                                                      max_wait_ms=0.0))
    theirs = JaxStore(JaxSched(**kw), serve_cfg=JaxServe(max_batch_windows=3, max_wait_ms=0.0))
    now = time.monotonic()
    for i in range(60):
        lane = rng.choice([LANE_INCIDENT, LANE_SERVE, LANE_BACKFILL])
        tenant = rng.choice("abc")
        key = ("k", rng.randint(0, 2)) if lane == LANE_SERVE else ("u", i)
        cost = rng.choice([0.5, 1.0, 2.0])
        ours.park(ParkedEntry(lane, tenant, key, i, runner=None, cost=cost))
        theirs.park(JaxEntry(lane, tenant, key, i, runner=None, cost=cost))
    for e in ours._buckets.values():
        for x in e:
            x.parked = now
    for e in theirs._buckets.values():
        for x in e:
            x.parked = now
    got = [[e.payload for e in b] for b in ours.take_ready(force=True, now=now + 1.0)]
    want = [[e.payload for e in b] for b in theirs.take_ready(force=True, now=now + 1.0)]
    assert got == want


# ----------------------------------------------------- deadline expiry


def test_deadline_expired_entries_expire_at_dequeue_under_contention(registry):
    expired = []
    store = _store(serve_cfg=ServeConfig(max_batch_windows=8))
    now = time.monotonic()
    live = ParkedEntry(LANE_SERVE, "t", ("bucket",), "live", runner=lambda p: None,
                       deadline=now + 60.0)
    dead = [ParkedEntry(LANE_SERVE, "t", ("bucket",), f"dead{i}", runner=lambda p: None,
                        expire=expired.append, deadline=now - 0.001) for i in range(3)]
    for e in (dead[0], live, dead[1], dead[2]):
        store.park(e)
    store.park(_entry(LANE_INCIDENT, "hot"))
    store.park(_entry(LANE_BACKFILL, "cold"))
    dispatched = [e.payload for b in store.take_ready(force=True, now=now) for e in b]
    assert sorted(expired) == ["dead0", "dead1", "dead2"]
    assert "live" in dispatched and not any(p.startswith("dead") for p in dispatched)
    assert store.expired == 3
    assert registry.get("microrank_sched_expired_total").value() == 3
    assert store.pending() == 0


# --------------------------------------------------- priority lanes


def test_priority_inversion_impossible_under_adversarial_mixes():
    rng = random.Random(0)
    for trial in range(25):
        store = _store(
            tenant_weights=(("a", rng.choice([0.5, 1, 8])),),
            tenant_rates=(("b", rng.choice([0.0, 0.5])),),
            serve_cfg=ServeConfig(max_batch_windows=rng.choice([1, 2, 4]), max_wait_ms=0.0),
        )
        for _ in range(rng.randint(5, 30)):
            lane = rng.choice([LANE_INCIDENT, LANE_SERVE, LANE_BACKFILL])
            store.park(_entry(lane, rng.choice("abc"),
                              key=("k", rng.randint(0, 3)) if lane == LANE_SERVE else None,
                              cost=rng.choice([0.5, 1.0, 3.0])))
        lanes_out = [b[0].lane for b in store.take_ready(force=True)]
        assert lanes_out == sorted(lanes_out), trial
        assert store.pending() == 0


def test_open_incident_work_preempts_parked_backfill():
    store = _store()
    for _ in range(5):
        store.park(_entry(LANE_BACKFILL, "backfill"))
    store.park(_entry(LANE_INCIDENT, "stream"))
    order = [b[0].lane for b in store.take_ready(force=True)]
    assert order == [LANE_INCIDENT] + [LANE_BACKFILL] * 5


# ------------------------------------------------- DeviceScheduler thread


def test_device_scheduler_runs_thunks_and_reenters(registry):
    sched = DeviceScheduler(_store(), name="mr-sched-test")
    sched.start()
    try:
        assert sched.submit_thunk(LANE_BACKFILL, "t", lambda: 41 + 1).result(timeout=30) == 42
        nested = sched.run_on(LANE_SERVE, "t",
                              lambda: sched.run_on(LANE_INCIDENT, "t", lambda: "inner"))
        assert nested == "inner"
        with pytest.raises(ValueError, match="boom"):
            sched.run_on(LANE_BACKFILL, "t",
                         lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert sched.is_alive() and sched.wait_idle(timeout=30)
        reg = registry.get("microrank_sched_dispatch_windows_total")
        assert sum(s["value"] for s in reg.samples()) >= 3
    finally:
        sched.stop(drain=True, timeout=30)
    assert not sched.is_alive()


def test_device_scheduler_drain_stop_flushes_everything():
    store = _store(serve_cfg=ServeConfig(max_wait_ms=60_000.0))
    sched = DeviceScheduler(store, name="mr-sched-drain")
    sched.start()
    done = []
    store.park(ParkedEntry(LANE_SERVE, "t", ("b",), "w1", runner=lambda p: done.extend(p)))
    time.sleep(0.05)
    assert done == []
    sched.stop(drain=True, timeout=30)
    assert done == ["w1"]
    assert store.pending() == 0


def test_device_scheduler_owns_the_card():
    """The scheduler's thread claims the card; a device seam asserts
    it (utils.guards)."""
    from microrank_tpu_torch.utils.guards import DeviceOwnershipError, assert_device_owner

    sched = DeviceScheduler(_store(), name="mr-sched-owner")
    sched.start()
    try:
        sched.run_on(LANE_SERVE, "t", lambda: assert_device_owner("test"))
        with pytest.raises(DeviceOwnershipError, match="'device-scheduler'"):
            assert_device_owner("test")
    finally:
        sched.stop(drain=True, timeout=30)
        from microrank_tpu_torch.utils.guards import release_device_owner

        release_device_owner()


def test_router_asserts_the_card_owner(registry):
    """The router's dispatch seams refuse a thread other than a live
    owner's; once the owner's thread has ended, the card is free."""
    from microrank_tpu_torch.dispatch import DispatchRouter
    from microrank_tpu_torch.utils.guards import DeviceOwnershipError, assert_device_owner

    router = DispatchRouter(MicroRankConfig(runtime=RuntimeConfig(device="cpu")))
    sched = DeviceScheduler(_store(), name="mr-sched-router")
    sched.start()
    try:
        sched.run_on(LANE_SERVE, "t", lambda: None)  # the thread has claimed
        with pytest.raises(DeviceOwnershipError, match="dispatch.rank_batch"):
            router.rank_batch([], "kind")
        with pytest.raises(DeviceOwnershipError, match="dispatch.rank_fused"):
            router.rank_fused(None, "kind")
    finally:
        sched.stop(drain=True, timeout=30)
    assert not sched.is_alive()
    assert_device_owner("after")  # a dead owner holds nothing


# --------------------------------------- co-deploy: one card


def _serve_config(**serve_kw):
    serve_kw.setdefault("warmup", False)
    serve_kw.setdefault("max_batch_windows", 2)
    serve_kw.setdefault("max_wait_ms", 2000.0)
    return MicroRankConfig(serve=ServeConfig(**serve_kw), runtime=RuntimeConfig(device="cpu"))


def _rank_once(svc, records, request_id, tenant="default"):
    from microrank_tpu_torch.serve import RankRequest

    return svc.submit(RankRequest(request_id=request_id, tenant=tenant,
                                  spans=records)).result(timeout=120)


def _stream_cfg():
    return MicroRankConfig(
        stream=StreamConfig(allowed_lateness_seconds=5.0),
        sched=SchedConfig(tenant_weights=(("serve", 2.0), ("stream", 2.0))),
        runtime=RuntimeConfig(device="cpu"),
    )


def _source():
    from microrank_tpu_torch.stream import SyntheticSource

    return SyntheticSource(n_windows=6, faulted=[3],
                           synth_config=SyntheticConfig(**STREAM_SYNTH))


def test_serve_codeploy_minimal_parity(tables, records, registry):
    """Serve through a DeviceScheduler: bitwise serve solo, tie-aware
    JAX's solo serve; the serve lane's dispatch is charged to its
    tenant."""
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import ServeConfig as JaxServe
    from microrank_tpu.serve import RankRequest as JaxRequest
    from microrank_tpu.serve import ServeService as JaxService
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing import generate_case as jax_generate
    from microrank_tpu_torch.serve import ServeService

    svc = ServeService(_serve_config(max_batch_windows=1))
    svc.fit_baseline(tables[0])
    svc.start()
    solo = _rank_once(svc, records, "solo")
    svc.shutdown(drain=True)

    cfg = _serve_config(max_batch_windows=1)
    store = ParkedWindowStore(cfg.sched, serve_cfg=cfg.serve)
    sched = DeviceScheduler(store)
    sched.start()
    try:
        svc2 = ServeService(cfg, sched=sched)
        svc2.fit_baseline(tables[0])
        svc2.start()
        co = _rank_once(svc2, records, "co", tenant="t1")
        svc2.shutdown(drain=True)
    finally:
        sched.stop(drain=True, timeout=60)
    assert co.ranking == solo.ranking and co.rank_iterations == solo.rank_iterations
    assert store.tenant_shares().get("t1") == 1
    assert sched.errors == 0

    jsvc = JaxService(JaxConfig(serve=JaxServe(warmup=False, max_wait_ms=0.0)))
    jsvc.fit_baseline(jax_generate(JaxSynth(**SYNTH)).normal)
    jsvc.start()
    try:
        theirs = jsvc.submit(JaxRequest(request_id="jax", spans=records)).result(120)
    finally:
        jsvc.shutdown()
    k = min(5, len(theirs.ranking))
    ok, why = tie_aware_topk_agreement([n for n, _ in theirs.ranking],
                                       [s for _, s in theirs.ranking],
                                       [n for n, _ in co.ranking], [s for _, s in co.ranking],
                                       k, rtol=1e-5)
    assert ok, why


def test_codeploy_serve_and_stream_share_one_card(tables, records, registry, tmp_path):
    """Serve and the stream engine through one DeviceScheduler: the
    stream's windows, rankings and incidents are its solo run's, serve's
    answer its solo answer, both lanes charged, nothing dropped; JAX's
    solo engine counts the same windows and incidents."""
    from microrank_tpu_torch.serve import ServeService
    from microrank_tpu_torch.stream import StreamEngine

    svc = ServeService(_serve_config())
    svc.fit_baseline(tables[0])
    svc.start()
    solo_serve = _rank_once(svc, records, "solo")
    svc.shutdown(drain=True)
    solo = StreamEngine(_stream_cfg(), _source(), out_dir=tmp_path / "solo",
                        device="cpu").run()
    assert solo.incidents_opened == 1 and solo.incidents_resolved == 1

    cfg = _stream_cfg()
    serve_cfg = _serve_config()
    store = ParkedWindowStore(cfg.sched, serve_cfg=serve_cfg.serve)
    sched = DeviceScheduler(store)
    sched.start()
    try:
        svc2 = ServeService(serve_cfg, sched=sched)
        svc2.fit_baseline(tables[0])
        svc2.start()
        eng = StreamEngine(cfg, _source(), out_dir=tmp_path / "co", device="cpu", sched=sched)
        out = {}
        t = threading.Thread(target=lambda: out.update(s=eng.run()), name="co-stream")
        t.start()
        co_serve = _rank_once(svc2, records, "co")
        t.join(timeout=300)
        assert not t.is_alive()
        svc2.shutdown(drain=True)
    finally:
        sched.stop(drain=True, timeout=60)
    co = out["s"]
    assert co_serve.ranking == solo_serve.ranking
    for k in ("windows", "ranked", "clean", "skipped", "dispatches", "incidents_opened",
              "incidents_resolved"):
        assert getattr(co, k) == getattr(solo, k), k
    assert [(r.start, r.ranking, r.rank_iterations) for r in co.results] == [
        (r.start, r.ranking, r.rank_iterations) for r in solo.results]
    assert sched.errors == 0
    shares = store.tenant_shares()
    assert shares.get("stream", 0) > 0 and shares.get("default", 0) > 0
    assert store.pending() == 0
    j = _jax_solo_stream(tmp_path / "jax")
    for k in ("windows", "ranked", "incidents_opened", "incidents_resolved"):
        assert getattr(j, k) == getattr(solo, k), k


def _jax_solo_stream(out_dir):
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.stream import StreamEngine as JaxEngine
    from microrank_tpu.stream.sources import ReplaySource
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    def ns(frame):
        frame = frame.copy()
        for col in ("startTime", "endTime"):
            frame[col] = frame[col].astype("datetime64[ns]")
        return frame

    tl = generate_timeline(JaxSynth(**STREAM_SYNTH), 6, [3])
    cfg = JaxConfig(stream=JaxStream(allowed_lateness_seconds=5.0, checkpoint=False),
                    dispatch=JaxDispatch(warmup_manifest=False))
    return JaxEngine(cfg, ReplaySource(ns(tl.timeline), chunk_spans=4000), out_dir=out_dir,
                     normal_df=ns(tl.normal)).run()


# ------------------------------------ shape-faithful warm restart


def test_warm_restart_first_window_latency_near_steady_state(tables, records, registry,
                                                             tmp_path):
    """A first process's production shapes reach the manifest; a warmed
    second process dispatches them at startup, so its first request
    lands within 2x the steady-state p99 (+50 ms)."""
    import os

    from microrank_tpu_torch.dispatch import manifest_shapes
    from microrank_tpu_torch.serve import ServeService

    svc1 = ServeService(_serve_config(max_batch_windows=1))
    svc1.fit_baseline(tables[0])
    svc1.start()
    for i in range(2):
        assert _rank_once(svc1, records, f"p{i}").ranking
    svc1.shutdown(drain=True)
    shapes = manifest_shapes(os.environ["MICRORANK_JIT_CACHE"], "serve")
    assert shapes, "production shapes never reached the manifest"

    svc2 = ServeService(_serve_config(warmup=True, warmup_occupancies=(1,), max_batch_windows=1))
    svc2.fit_baseline(tables[0])
    svc2.start()
    assert registry.get("microrank_warm_shapes_total").value(outcome="warmed") >= 1
    assert registry.get("microrank_compile_cache_events_total").value(event="warm_start") == 1
    t0 = time.monotonic()
    assert _rank_once(svc2, records, "first").ranking
    first_s = time.monotonic() - t0
    steady = []
    for i in range(6):
        t0 = time.monotonic()
        assert _rank_once(svc2, records, f"s{i}").ranking
        steady.append(time.monotonic() - t0)
    svc2.shutdown(drain=True)
    assert first_s <= 2.0 * max(steady) + 0.05


def test_stream_warm_restart_replays_the_manifest(registry, tmp_path):
    """The stream engine records its dispatched occupancies and shapes
    when its run ends; a second engine over the same manifest dispatches
    them before its first window, and ranks as the first did."""
    import os

    from microrank_tpu_torch.dispatch import manifest_occupancies
    from microrank_tpu_torch.stream import StreamEngine

    first = StreamEngine(_stream_cfg(), _source(), out_dir=tmp_path / "a", device="cpu")
    a = first.run()
    assert manifest_occupancies(os.environ["MICRORANK_JIT_CACHE"], "stream")
    assert registry.get("microrank_compile_cache_events_total").value(event="warm_start") == 0
    second = StreamEngine(_stream_cfg(), _source(), out_dir=tmp_path / "b", device="cpu")
    b = second.run()
    assert registry.get("microrank_compile_cache_events_total").value(event="warm_start") == 1
    assert registry.get("microrank_warm_shapes_total").value(outcome="warmed") >= 1
    assert second.router.dispatches > b.dispatches  # the replay went through its router
    assert [(r.start, r.ranking) for r in b.results] == [(r.start, r.ranking) for r in a.results]
    off = dataclasses.replace(_stream_cfg(), dispatch=dataclasses.replace(
        _stream_cfg().dispatch, warmup_manifest=False))
    third = StreamEngine(off, _source(), out_dir=tmp_path / "c", device="cpu")
    c = third.run()
    assert third.router.dispatches == c.dispatches


@pytest.mark.parametrize("lane", ["serve", "stream"])
def test_failed_recorded_shape_warmup_raises(lane, tables, records, registry, tmp_path,
                                             monkeypatch):
    """A recorded shape whose replay dispatch fails raises out of a
    restarted service's ``start()`` and a restarted engine's ``run()``:
    it is counted ``failed``, never skipped, and nothing degrades."""
    import os

    from microrank_tpu_torch.dispatch import manifest_shapes, warmup
    from microrank_tpu_torch.serve import ServeService
    from microrank_tpu_torch.stream import StreamEngine

    if lane == "serve":
        first = ServeService(_serve_config(max_batch_windows=1))
        first.fit_baseline(tables[0])
        first.start()
        assert _rank_once(first, records, "p").ranking
        first.shutdown(drain=True)
        second = ServeService(_serve_config(warmup=True, warmup_occupancies=(1,),
                                            max_batch_windows=1))
        second.fit_baseline(tables[0])
        restart = second.start
    else:
        StreamEngine(_stream_cfg(), _source(), out_dir=tmp_path / "a", device="cpu").run()
        second = StreamEngine(_stream_cfg(), _source(), out_dir=tmp_path / "b", device="cpu")
        restart = second.run
    assert manifest_shapes(os.environ["MICRORANK_JIT_CACHE"], lane)
    replayed, like = set(), warmup.graph_like

    def recorded_like(*a, **k):
        graph = like(*a, **k)
        replayed.add(id(graph))
        return graph

    dispatch = second.router.rank_batch

    def broken(graphs, *a, **k):
        if id(graphs[0]) in replayed:
            raise RuntimeError("injected recorded-shape failure")
        return dispatch(graphs, *a, **k)

    monkeypatch.setattr(warmup, "graph_like", recorded_like)
    monkeypatch.setattr(second.router, "rank_batch", broken)
    with pytest.raises(RuntimeError, match="injected recorded-shape failure"):
        restart()
    assert registry.get("microrank_warm_shapes_total").value(outcome="failed") == 1
    assert registry.get("microrank_warm_shapes_total").value(outcome="skipped") == 0
    assert registry.get("microrank_serve_degraded_total").value() == 0
    if lane == "serve":
        assert not second.scheduler.is_alive()
        second.shutdown()
