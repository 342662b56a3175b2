"""Time-travel replay and retro scoring over a warehouse
(``microrank_tpu_torch.warehouse.replay`` / ``.retro``) against the JAX
package's, on the CPU:

* ``replay_range`` re-ranks the stored blobs and matches the live
  verdicts; its report equals JAX's report over JAX's run of the same
  timeline (every key but the timings);
* ``run_retro``'s 13 formula rows (MAP, MRR, top-k rates, mean rank)
  equal JAX's retro over JAX's run, exactly, with ``outcome_source ==
  "manifest"``; the policy it selects is persisted;
* ``cli replay`` (exit 0 on a match, 1 on a mismatch, 2 on a bad range)
  and ``cli scenarios --from-warehouse``;
* the card's owner (``utils.guards``): a thread that did not claim the
  card fails the assert at ``blob.stage_rank_window`` and at the
  router's ``rank_batch`` while the owner lives.

JAX's engine reads the port generator's timeline as ``datetime64[ns]``
frames (its window code assumes them).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from microrank_tpu_torch import cli
from microrank_tpu_torch.config import (
    DispatchConfig,
    MicroRankConfig,
    RuntimeConfig,
    StreamConfig,
    WarehouseConfig,
)
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.stream import StreamEngine, SyntheticSource
from microrank_tpu_torch.testing import SyntheticConfig
from microrank_tpu_torch.warehouse import (
    RETRO_MATRIX_NAME,
    TraceWarehouse,
    replay_range,
    run_retro,
)

SYNTH = dict(n_operations=12, n_traces=60, seed=11)
FAULTED = [3, 4, 5]
N_WINDOWS = 8
CPU = MicroRankConfig(runtime=RuntimeConfig(device="cpu"))
TIMING_KEYS = ("elapsed_s", "spans_per_sec", "windows_per_sec")


def _ns(frame):
    frame = frame.copy()
    for col in ("startTime", "endTime"):
        frame[col] = frame[col].astype("datetime64[ns]")
    return frame


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same timeline through the port's engine and JAX's, each
    sealing a warehouse (registries of their own)."""
    from microrank_tpu.config import DispatchConfig as JaxDispatch
    from microrank_tpu.config import MicroRankConfig as JaxConfig
    from microrank_tpu.config import StreamConfig as JaxStream
    from microrank_tpu.config import WarehouseConfig as JaxWarehouse
    from microrank_tpu.obs import MetricsRegistry as JaxRegistry
    from microrank_tpu.obs import get_registry as jax_get
    from microrank_tpu.obs import set_registry as jax_set
    from microrank_tpu.stream import StreamEngine as JaxEngine
    from microrank_tpu.stream.sources import ReplaySource as JaxReplay
    from microrank_tpu.testing import SyntheticConfig as JaxSynth
    from microrank_tpu.testing.synthetic import generate_timeline

    base = tmp_path_factory.mktemp("replay")
    old, jold = get_registry(), jax_get()
    set_registry(MetricsRegistry())
    jax_set(JaxRegistry())
    try:
        cfg = MicroRankConfig(stream=StreamConfig(allowed_lateness_seconds=5.0),
                              runtime=RuntimeConfig(device="cpu"),
                              dispatch=DispatchConfig(warmup_manifest=False),
                              warehouse=WarehouseConfig(enabled=True, compact_after=4))
        src = SyntheticSource(N_WINDOWS, FAULTED, SyntheticConfig(**SYNTH))
        port = StreamEngine(cfg, src, out_dir=base / "port").run()
        tl = generate_timeline(JaxSynth(**SYNTH), N_WINDOWS, FAULTED)
        jsrc = JaxReplay(_ns(tl.timeline), chunk_spans=4000)
        jsrc.fault_pod_ops = list(tl.fault_pod_ops)
        jcfg = JaxConfig(stream=JaxStream(allowed_lateness_seconds=5.0),
                         dispatch=JaxDispatch(warmup_manifest=False),
                         warehouse=JaxWarehouse(enabled=True, compact_after=4))
        jax = JaxEngine(jcfg, jsrc, out_dir=base / "jax", normal_df=_ns(tl.normal)).run()
    finally:
        set_registry(old)
        jax_set(jold)
    assert port.ranked == jax.ranked == len(FAULTED)
    return {"base": base, "port": port, "cfg": cfg, "jcfg": jcfg, "truth": src.fault_pod_ops}


def _untimed(report):
    return {k: v for k, v in report.items() if k not in TIMING_KEYS}


def test_replay_matches_live_and_equals_jax_report(runs):
    from microrank_tpu.warehouse import replay_range as jax_replay

    base = runs["base"]
    ours = replay_range(base / "port", config=CPU)
    theirs = jax_replay(base / "jax", config=runs["jcfg"])
    assert ours["verdict"] == "match" and ours["ranked"] == ours["matched"] == len(FAULTED)
    assert ours["skipped_no_blob"] == 0 and not ours["mismatched"]
    assert _untimed(ours) == _untimed(theirs)
    assert set(ours) == set(theirs)
    # A bounded range narrows to its window, as JAX's does.
    w0 = [w for w in TraceWarehouse(base / "port", WarehouseConfig()).query()
          if w.outcome == "ranked"][0]
    narrow = replay_range(base / "port", w0.start_us, w0.start_us + 1, config=CPU)
    jnarrow = jax_replay(base / "jax", w0.start_us, w0.start_us + 1, config=runs["jcfg"])
    assert narrow["ranked"] == narrow["matched"] == 1
    assert _untimed(narrow) == _untimed(jnarrow)


def test_replay_reports_a_tampered_verdict(runs, tmp_path):
    """A stored verdict that the blob does not reproduce is a mismatch
    (exit 1 from the CLI); a bad range exits 2."""
    import io

    whdir = tmp_path / "warehouse"
    shutil.copytree(runs["base"] / "port" / "warehouse", whdir)
    seg = sorted(whdir.glob("cold-*.npz"))[0]
    with np.load(seg, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    doc = json.loads(bytes(arrays["meta"]).decode())
    ranked = [w for w in doc["windows"] if w["outcome"] == "ranked"]
    assert ranked
    top = ranked[0]["ranking"]
    top[0], top[-1] = [top[-1][0], top[0][1]], [top[0][0], top[-1][1]]
    arrays["meta"] = np.frombuffer(json.dumps(doc).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    seg.write_bytes(buf.getvalue())
    report = replay_range(tmp_path, config=CPU)
    assert report["verdict"] == "mismatch" and len(report["mismatched"]) == 1
    assert cli.main(["replay", str(tmp_path), "--at", "all", "--device", "cpu"]) == 1
    assert cli.main(["replay", str(tmp_path), "--at", "yesterday..", "--device", "cpu"]) == 2


def test_cli_replay_and_scenarios_from_warehouse(runs, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(tmp_path / "policy"))
    out = runs["base"] / "port"
    assert cli.main(["replay", str(out), "--at", "all", "--device", "cpu", "--json",
                     str(tmp_path / "r.json")]) == 0
    assert "-> match" in capsys.readouterr().out
    assert json.loads((tmp_path / "r.json").read_text())["verdict"] == "match"
    whdir = tmp_path / "wh"
    shutil.copytree(out / "warehouse", whdir)
    assert cli.main(["scenarios", "--from-warehouse", str(whdir), "--device", "cpu",
                     "--json", str(tmp_path / "s.json")]) == 0
    printed = capsys.readouterr().out
    assert "warehouse retro-score: 3 windows" in printed and "policy:" in printed
    result = json.loads((tmp_path / "s.json").read_text())
    assert Path(result["policy_path"]).exists() and (whdir / RETRO_MATRIX_NAME).exists()


def test_retro_rows_equal_jax(runs, tmp_path, monkeypatch):
    """All 13 formulas over the stored incidents: MAP, MRR, the top-k
    rates, mean rank and unranked equal JAX's retro over JAX's run of
    the same timeline, exactly (the same graphs, the same tie-aware
    metrics); the truth comes from the manifest; the selected policy is
    JAX's and is written."""
    from microrank_tpu.warehouse import run_retro as jax_retro

    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(tmp_path / "policy"))
    base = runs["base"]
    for who in ("port", "jax"):
        shutil.copytree(base / who / "warehouse", tmp_path / who / "warehouse")
    ours = run_retro(tmp_path / "port", config=CPU, seed=0, name="run")
    theirs = jax_retro(tmp_path / "jax", config=runs["jcfg"], seed=0, persist_policy=False,
                       name="run")
    rec, jrec = ours["record"], theirs["record"]
    assert ours["outcome_source"] == theirs["outcome_source"] == "manifest"
    assert rec["truth"] == jrec["truth"] == runs["truth"]
    assert len(rec["formulas"]) == 13 and rec["windows"] == len(FAULTED)
    # JSON round trip: JAX's int top-k keys as the artifact carries them.
    assert json.loads(json.dumps(rec["formulas"])) == json.loads(json.dumps(jrec["formulas"]))
    assert (rec["profile"], rec["spans"]) == (jrec["profile"], jrec["spans"])
    assert ours["policy"] == theirs["policy"]
    assert Path(ours["policy_path"]).exists()
    assert json.loads(Path(ours["policy_path"]).read_text()) == ours["policy"]


# ------------------------------------------------------------ the owner


def test_unclaimed_thread_fails_the_owner_assert(runs):
    """While the owner's thread lives, a thread that did not claim the
    card fails at ``blob.stage_rank_window`` and at ``rank_batch``; a
    claimed one passes."""
    from microrank_tpu_torch.dispatch import DispatchRouter
    from microrank_tpu_torch.rank_backends.blob import stage_rank_window
    from microrank_tpu_torch.utils.guards import (
        DeviceOwnershipError,
        claim_device_owner,
        release_device_owner,
    )

    w = [w for w in TraceWarehouse(runs["base"] / "port", WarehouseConfig()).query()
         if w.outcome == "ranked"][0]
    graph = w.graph()
    cfg = CPU
    release = threading.Event()
    ready = threading.Event()

    def owner():
        claim_device_owner("test-owner")
        ready.set()
        release.wait(60)

    t = threading.Thread(target=owner, name="owner")
    t.start()
    ready.wait(30)
    try:
        with pytest.raises(DeviceOwnershipError, match="blob.stage_rank_window"):
            stage_rank_window(graph, cfg.pagerank, cfg.spectrum, w.kernel, "cpu", True)
        with pytest.raises(DeviceOwnershipError, match="dispatch.rank_batch"):
            DispatchRouter(cfg).rank_batch([graph], w.kernel)
        claim_device_owner("test-main")
        outs, _ = DispatchRouter(cfg).rank_batch([graph], w.kernel)
        assert int(outs[2][0]) > 0
    finally:
        release.set()
        t.join(30)
        release_device_owner()
