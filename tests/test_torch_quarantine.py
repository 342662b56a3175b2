"""The dead-letter store (``ingest/quarantine.py``) and its table-lane
seams held to the JAX package on the CPU:

* the module: ``QUARANTINE_NAME`` and ``REASONS`` are JAX's; a reason's
  rows written in one call give the records (``ts`` apart), the bytes
  kept and the dropped count that JAX's store gives a row at a time,
  under caps that cut mid-batch, and a store appends to an existing
  file counting its bytes; with no directory the store only counts;
* ``cli run`` (the port with ``--device cpu``, JAX's with
  ``--engine native``) on a poisoned CSV pair (negative durations, end
  before start, a duration past the maximum) writes ``quarantine.jsonl``
  with JAX's records, field order and values apart from ``ts``, and
  ``--quarantine-dir`` moves it;
* ``TableRCA`` in both packages with the store configured before
  ``fit_baseline``: the normal dump's rows (``source="table:normal"``)
  then the run's (``"table"``), ``trace_too_long`` included, at the
  default cap and at caps that keep only some lines: the same lines
  kept and the same ``dropped`` (store and
  ``microrank_ingest_quarantine_dropped_total``).
"""

import json
import time

import numpy as np
import pytest

from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.ingest import quarantine as jax_quarantine
from microrank_tpu.native import load_span_table as jax_load
from microrank_tpu.obs import registry as jax_registry
from microrank_tpu.obs import spans as jax_spans
from microrank_tpu.pipeline import TableRCA as JaxTableRCA
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import IngestConfig, MicroRankConfig
from microrank_tpu_torch.ingest import (
    QUARANTINE_NAME,
    REASONS,
    QuarantineStore,
    admit_table,
    configure_quarantine,
    get_quarantine,
)
from microrank_tpu_torch.ingest import quarantine as port_quarantine
from microrank_tpu_torch.native import load_span_table
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.obs import spans as port_spans
from microrank_tpu_torch.pipeline import TableRCA
from microrank_tpu_torch.testing import SyntheticConfig, generate_case

SYNTH = dict(n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5)


def poison(spans, rng, n_neg, n_inverted, n_overflow):
    """Rows of a synthetic case's spans made hostile, in place: negative
    durations, an end before the start, durations past an hour."""
    n = len(spans["duration_us"])
    rows = rng.choice(n, n_neg + n_inverted + n_overflow, replace=False)
    dur = spans["duration_us"].copy()
    end = spans["end_us"].copy()
    dur[rows[:n_neg]] = -rng.integers(1, 10**6, n_neg)
    inv = rows[n_neg:n_neg + n_inverted]
    end[inv] = spans["start_us"][inv] - 1_000_000
    dur[rows[n_neg + n_inverted:]] = 3_600_000_001 + rng.integers(0, 10, n_overflow)
    spans["duration_us"], spans["end_us"] = dur, end


@pytest.fixture(scope="module")
def poisoned_pair(tmp_path_factory):
    case = generate_case(SyntheticConfig(**SYNTH))
    rng = np.random.default_rng(16)
    poison(case.normal, rng, 4, 3, 2)
    poison(case.abnormal, rng, 9, 5, 3)
    return case.write_csvs(tmp_path_factory.mktemp("quarantine"))


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """Each package's process dead-letter store and span tracer, as they
    were before the test (runs and CLIs install their own)."""
    for mod in (jax_quarantine, port_quarantine):
        monkeypatch.setattr(mod, "_store", mod._store)
    for mod in (jax_spans, port_spans):
        monkeypatch.setattr(mod, "_tracer", mod._tracer)


@pytest.fixture
def fixed_clock(monkeypatch):
    """One wall clock for both stores: a record's ``ts`` is part of its
    line's length, and so of each decision to keep or drop it."""
    monkeypatch.setattr(time, "time", lambda: 1_790_000_000.25)


@pytest.fixture
def registries():
    old_t, old_j = get_registry(), jax_registry.get_registry()
    t, j = MetricsRegistry(), jax_registry.MetricsRegistry()
    set_registry(t)
    jax_registry.set_registry(j)
    yield t, j
    set_registry(old_t)
    jax_registry.set_registry(old_j)


def records(path):
    """The store's records without their wall-clock ``ts``, in order,
    each with its keys in file order."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        assert list(rec) == ["reason", "source", "ts", "row", "offset"][:len(rec)]
        assert rec["reason"] in REASONS
        out.append([(k, v) for k, v in rec.items() if k != "ts"])
    return out


def dropped(reg):
    m = reg.get("microrank_ingest_quarantine_dropped_total")
    return 0 if m is None else sum(s["value"] for s in m.samples())


def test_names_and_reasons_are_jax():
    assert QUARANTINE_NAME == jax_quarantine.QUARANTINE_NAME
    assert REASONS == jax_quarantine.REASONS


@pytest.mark.parametrize("max_bytes", [16 << 20, 700, 1500, 90])
def test_batched_rows_equal_jax_one_row_at_a_time(tmp_path, registries, fixed_clock,
                                                  max_bytes):
    reg, jreg = registries
    rng = np.random.default_rng(max_bytes)
    payloads = [f"trace=t{i} op=op{int(rng.integers(0, 99))} " + "x" * int(rng.integers(0, 80))
                for i in range(40)]
    offsets = rng.integers(0, 10**6, len(payloads)).tolist()
    ours = QuarantineStore(tmp_path / "port" / QUARANTINE_NAME, max_bytes)
    theirs = jax_quarantine.QuarantineStore(tmp_path / "jax" / QUARANTINE_NAME, max_bytes)
    for reason, lo, hi in (("bad_duration", 0, 25), ("trace_too_long", 25, 40)):
        kept = ours.put_raws(payloads[lo:hi], reason, "table", offsets[lo:hi])
        kept_j = sum(theirs.put_raw(p, reason, source="table", offset=o)
                     for p, o in zip(payloads[lo:hi], offsets[lo:hi]))
        assert kept == kept_j
    assert (ours.records, ours.dropped, ours._bytes) == (
        theirs.records, theirs.dropped, theirs._bytes)
    if ours.records:
        assert records(ours.path) == records(theirs.path)
    else:
        assert not ours.path.exists() and not theirs.path.exists()
    assert dropped(reg) == dropped(jreg) == ours.dropped
    assert (max_bytes == 16 << 20) == (ours.dropped == 0)
    # A store on an existing file counts its bytes against the cap.
    again = QuarantineStore(ours.path, max_bytes)
    assert again._bytes == (ours.path.stat().st_size if ours.records else 0)


def test_without_a_directory_the_store_only_counts(tmp_path, poisoned_pair):
    _, abnormal = poisoned_pair
    store = configure_quarantine(IngestConfig(), default_dir=None)
    assert store.path is None and get_quarantine() is store
    _, counts = admit_table(load_span_table(abnormal, cache=False), IngestConfig())
    assert store.records == sum(counts.values()) > 0 and store.dropped == 0
    assert store.put_raw(b"raw line\n", "unparseable_line", offset=3) == 1
    port_quarantine._store = None
    assert get_quarantine().path is None


def test_cli_run_writes_jax_quarantine(poisoned_pair, tmp_path, registries):
    from microrank_tpu.cli.main import main as jax_main

    normal, abnormal = poisoned_pair
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    assert cli.main(base + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main(base + ["-o", str(tmp_path / "jax"), "--engine", "native"]) == 0
    ours = records(tmp_path / "port" / QUARANTINE_NAME)
    assert ours == records(tmp_path / "jax" / QUARANTINE_NAME)
    reasons = [dict(r)["reason"] for r in ours]
    assert set(reasons) == {"bad_duration", "bad_timestamp", "duration_overflow"}
    assert {dict(r)["source"] for r in ours} == {"table"}
    # --quarantine-dir moves the store, in both CLIs.
    qdirs = {pkg: tmp_path / f"q_{pkg}" for pkg in ("port", "jax")}
    assert cli.main(base + ["-o", str(tmp_path / "port2"), "--device", "cpu",
                            "--quarantine-dir", str(qdirs["port"])]) == 0
    assert jax_main(base + ["-o", str(tmp_path / "jax2"), "--engine", "native",
                            "--quarantine-dir", str(qdirs["jax"])]) == 0
    assert not (tmp_path / "port2" / QUARANTINE_NAME).exists()
    assert records(qdirs["port"] / QUARANTINE_NAME) == records(qdirs["jax"] / QUARANTINE_NAME)


@pytest.mark.parametrize("max_bytes", [16 << 20, 4000, 9000])
def test_table_lane_sources_and_cap_match_jax(poisoned_pair, tmp_path, registries,
                                              fixed_clock, max_bytes):
    reg, jreg = registries
    normal, abnormal = poisoned_pair
    outs = {}
    for pkg, rca_cls, cfg, ingest, configure, load in (
        ("port", TableRCA, MicroRankConfig, IngestConfig, configure_quarantine,
         load_span_table),
        ("jax", JaxTableRCA, JaxConfig, JaxIngest, jax_quarantine.configure_quarantine,
         jax_load),
    ):
        icfg = ingest(max_spans_per_trace=5, quarantine_max_bytes=max_bytes)
        out = tmp_path / pkg
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        rca = rca_cls(cfg(ingest=icfg), **kwargs)
        # The normal dump's rows go to the store current at fit time.
        configure(icfg, default_dir=out)
        rca.fit_baseline(load(normal, cache=False))
        rca.run(load(abnormal, cache=False), out_dir=out)
        store = (port_quarantine if pkg == "port" else jax_quarantine)._store
        outs[pkg] = (records(out / QUARANTINE_NAME), store.dropped, store.records)
    assert outs["port"] == outs["jax"]
    recs, n_dropped, n_kept = outs["port"]
    sources = [dict(r)["source"] for r in recs]
    assert sources == sorted(sources, key=lambda s: s != "table:normal")
    if max_bytes == 16 << 20:
        assert n_dropped == 0 and set(sources) == {"table:normal", "table"}
        assert "trace_too_long" in {dict(r)["reason"] for r in recs}
    else:
        # The run's store starts from the bytes the fit's rows left.
        assert n_dropped > 0 and n_kept <= len(recs)
        assert (tmp_path / "port" / QUARANTINE_NAME).stat().st_size <= max_bytes
    assert dropped(reg) == dropped(jreg)
    assert (dropped(reg) == 0) == (max_bytes == 16 << 20)


@pytest.mark.parametrize("payload", ["trace=t op=ü\"q\\\\x\n", b"raw \xff bytes\n", ""])
def test_a_line_is_json_dumps_of_jax_s_record(tmp_path, fixed_clock, payload):
    store = QuarantineStore(tmp_path / QUARANTINE_NAME)
    store.put_raws([payload, payload], "unparseable_line", "tail:a", [7, 1 << 40])
    store.put_raw(payload, "bad_duration")
    text = payload.decode("utf-8", errors="replace") if isinstance(payload, bytes) else payload
    want = []
    for reason, source, offset in (("unparseable_line", "tail:a", 7),
                                   ("unparseable_line", "tail:a", 1 << 40),
                                   ("bad_duration", "", None)):
        rec = jax_quarantine.QuarantineStore._record({"raw": text.rstrip("\n")}, reason, source)
        if offset is not None:
            rec["offset"] = offset
        want.append(json.dumps(rec, default=str) + "\n")
    assert (tmp_path / QUARANTINE_NAME).read_text() == "".join(want)
    theirs = jax_quarantine.QuarantineStore(tmp_path / "jax.jsonl")
    theirs.put_raw(payload, "bad_duration")
    assert (tmp_path / "jax.jsonl").read_text() == want[-1]
