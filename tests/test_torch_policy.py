"""The tuned policy (``scenarios/policy.py``) held to the JAX package's:
the counterparts of tests/test_scenarios.py's policy cases, run through
both packages on the same ``policy.json`` (in ``MICRORANK_POLICY_DIR``,
a test's own tmp dir):

* explicit config wins field by field, the policy fills the rest, and
  ``tuned_policy="off"`` pins the defaults;
* a stale policy (schema version, profile-bucket schema, no entry for
  the run's profile, corrupt JSON) is rejected whole, with JAX's
  outcome and reason, and counted;
* the table lane consults it in ``fit_baseline`` (same resolution as
  JAX's lane, and the same rankings after it) and the CLI's
  ``--no-tuned-policy`` pins the defaults;
* a ``policy.json`` written by JAX's ``select_policy`` / ``save_policy``
  resolves the same in both packages;
* a policy naming any kernel JAX runs (csr, coo, dense and dense_bf16
  too) applies as in JAX; one naming a kernel no package runs raises,
  naming ``--no-tuned-policy``.
"""

import dataclasses
import json

import pytest

from microrank_tpu.config import IngestConfig as JaxIngest
from microrank_tpu.config import MicroRankConfig as JaxConfig
from microrank_tpu.config import RuntimeConfig as JaxRuntime
from microrank_tpu.config import SpectrumConfig as JaxSpectrum
from microrank_tpu.obs import registry as jax_registry
from microrank_tpu.scenarios import policy as jax_policy
from microrank_tpu_torch import cli
from microrank_tpu_torch.config import IngestConfig, MicroRankConfig, RuntimeConfig, SpectrumConfig
from microrank_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from microrank_tpu_torch.scenarios import policy
from microrank_tpu_torch.testing import SyntheticConfig, generate_case

COUNTS = (4000, 30, None)  # spans, ops, dedup unknown: the table lane's profile


@pytest.fixture
def policy_dir(tmp_path, monkeypatch):
    d = tmp_path / "policy"
    d.mkdir()
    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(d))
    return d


@pytest.fixture
def registries():
    old_t, old_j = get_registry(), jax_registry.get_registry()
    t, j = MetricsRegistry(), jax_registry.MetricsRegistry()
    set_registry(t)
    jax_registry.set_registry(j)
    yield t, j
    set_registry(old_t)
    jax_registry.set_registry(old_j)


def write_policy(policy_dir, profiles, version=policy.POLICY_VERSION, schema=None):
    (policy_dir / policy.POLICY_NAME).write_text(json.dumps({
        "version": version,
        "profile_schema": schema or policy.PROFILE_SCHEMA,
        "profiles": profiles,
    }))


def counter(reg):
    c = reg.get("microrank_policy_events_total")
    return {} if c is None else {
        (s["labels"]["lane"], s["labels"]["outcome"]): s["value"] for s in c.samples()
    }


def both(port_cfg, jax_cfg, counts=COUNTS, lane="table"):
    """(port config, port resolution, JAX config, JAX resolution)."""
    cfg, res = policy.apply_tuned_policy(port_cfg, lane=lane, counts=counts)
    jcfg, jres = jax_policy.apply_tuned_policy(jax_cfg, lane=lane, counts=counts)
    return cfg, res, jcfg, jres


def test_schema_and_buckets_are_jax():
    assert policy.PROFILE_SCHEMA == jax_policy.PROFILE_SCHEMA
    assert policy.POLICY_VERSION == jax_policy.POLICY_VERSION
    assert policy.TUNED_DEFAULTS == jax_policy.TUNED_DEFAULTS
    for spans in (0, 49_999, 50_000, 1_999_999, 2_000_000, 10**8):
        for ops in (0, 255, 256, 4095, 4096, 10**5):
            for dedup in (None, 7.99, 8.0, 100.0):
                assert policy.profile_from_counts(spans, ops, dedup).key() == (
                    jax_policy.profile_from_counts(spans, ops, dedup).key()
                )


def test_policy_dir_resolves_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("MICRORANK_POLICY_DIR", raising=False)
    monkeypatch.delenv("MICRORANK_JIT_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert policy.resolve_policy_dir() == jax_policy.resolve_policy_dir() == str(
        tmp_path / "home" / ".cache" / "microrank_tpu" / "jit"
    )
    monkeypatch.setenv("MICRORANK_JIT_CACHE", str(tmp_path / "jit"))
    assert policy.resolve_policy_dir() == jax_policy.resolve_policy_dir() == str(tmp_path / "jit")
    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(tmp_path / "pol"))
    assert policy.resolve_policy_dir() == jax_policy.resolve_policy_dir() == str(tmp_path / "pol")


def test_policy_precedence_explicit_config_wins(policy_dir, registries):
    key = policy.profile_from_counts(*COUNTS).key()
    write_policy(policy_dir, {key: {"method": "ochiai", "kernel": "packed", "pad_policy": "pow2"}})
    # No explicit overrides: all three fields come from the policy.
    cfg, res, jcfg, jres = both(MicroRankConfig(), JaxConfig())
    assert res.outcome == jres.outcome == "applied"
    assert res.journal() == jres.journal()
    assert (cfg.spectrum.method, cfg.runtime.kernel, cfg.runtime.pad_policy) == (
        "ochiai", "packed", "pow2"
    ) == (jcfg.spectrum.method, jcfg.runtime.kernel, jcfg.runtime.pad_policy)
    # Explicit method: config wins that field, the policy keeps the rest.
    cfg2, res2, _, jres2 = both(
        MicroRankConfig().replace(spectrum=SpectrumConfig(method="dice")),
        JaxConfig().replace(spectrum=JaxSpectrum(method="dice")),
    )
    assert cfg2.spectrum.method == "dice" and res2.fields["method"]["source"] == "config"
    assert cfg2.runtime.kernel == "packed" and res2.fields["kernel"]["source"] == "policy"
    assert res2.journal() == jres2.journal()
    # Every field explicit: "override".
    cfg3, res3, _, jres3 = both(
        MicroRankConfig(
            spectrum=SpectrumConfig(method="dice"),
            runtime=RuntimeConfig(kernel="kind", pad_policy="exact"),
        ),
        JaxConfig(
            spectrum=JaxSpectrum(method="dice"),
            runtime=JaxRuntime(kernel="kind", pad_policy="exact"),
        ),
    )
    assert res3.outcome == jres3.outcome == "override" and cfg3.runtime.kernel == "kind"
    # tuned_policy="off" pins the built-in defaults.
    cfg4, res4, _, jres4 = both(
        MicroRankConfig(runtime=RuntimeConfig(tuned_policy="off")),
        JaxConfig(runtime=JaxRuntime(tuned_policy="off")),
    )
    assert res4.outcome == jres4.outcome == "disabled"
    assert cfg4.spectrum.method == SpectrumConfig().method
    assert counter(registries[0]) == counter(registries[1]) == {
        ("table", "applied"): 2, ("table", "override"): 1, ("table", "disabled"): 1,
    }


def test_stale_policy_rejected_whole(policy_dir, registries):
    key = policy.profile_from_counts(*COUNTS).key()
    bad_schema = dict(policy.PROFILE_SCHEMA, span_volume=[1, 2])
    cases = [
        dict(profiles={}, version=policy.POLICY_VERSION + 1),           # schema version
        dict(profiles={key: {"method": "ochiai"}}, schema=bad_schema),  # bucket schema
        dict(profiles={"spans=large|ops=large|dedup=low": {"method": "ochiai"}}),  # profile
    ]
    for case in cases:
        write_policy(policy_dir, **case)
        cfg, res, _, jres = both(MicroRankConfig(), JaxConfig())
        assert res.outcome == jres.outcome == "rejected"
        assert res.reason == jres.reason and res.journal() == jres.journal()
        assert cfg == MicroRankConfig()  # nothing applied
    (policy_dir / policy.POLICY_NAME).write_text("{not json")
    _, res, _, jres = both(MicroRankConfig(), JaxConfig())
    assert res.outcome == jres.outcome == "rejected"
    assert res.reason.startswith("unreadable") and jres.reason.startswith("unreadable")
    # No file at all: the built-in defaults, counted as "default".
    (policy_dir / policy.POLICY_NAME).unlink()
    _, res, _, jres = both(MicroRankConfig(), JaxConfig())
    assert res.outcome == jres.outcome == "default" and res.policy_file is None
    assert counter(registries[0]) == counter(registries[1]) == {
        ("table", "rejected"): 4, ("table", "default"): 1,
    }


def test_policy_from_jax_select_policy_resolves_the_same(policy_dir, registries):
    key = policy.profile_from_counts(*COUNTS).key()
    records = [
        {"profile": key, "formulas": {
            "dstar2": {"map": 0.5, "top1_rate": 0.5, "mrr": 0.6},
            "ochiai": {"map": 0.9, "top1_rate": 0.8, "mrr": 0.9},
        }},
        {"profile": "spans=large|ops=small|dedup=high", "formulas": {
            "tarantula": {"map": 0.7, "top1_rate": 0.7, "mrr": 0.7},
        }},
    ]
    timings = {key: {"kernel": "packed_bf16", "pad_policy": "pow2", "rank_ms": 1.0,
                     "candidates": 2}}
    jax_policy.save_policy(policy_dir, jax_policy.select_policy(records, timings, matrix_seed=3))
    data, reject = policy.load_policy(policy_dir)
    assert reject is None and data == jax_policy.load_policy(policy_dir)[0]
    cfg, res, jcfg, jres = both(MicroRankConfig(), JaxConfig())
    assert res.outcome == jres.outcome == "applied"
    assert res.journal() == jres.journal()
    assert (cfg.spectrum.method, cfg.runtime.kernel, cfg.runtime.pad_policy) == (
        jcfg.spectrum.method, jcfg.runtime.kernel, jcfg.runtime.pad_policy
    ) == ("ochiai", "packed_bf16", "pow2")


def test_unported_kernel_in_policy_raises(policy_dir, registries):
    # Every kernel JAX runs is ported, csr, coo and dense too: a policy
    # naming one applies as in JAX; only a kernel no package runs raises.
    key = policy.profile_from_counts(*COUNTS).key()
    for kernel in ("csr", "coo", "dense", "dense_bf16", "bogus"):
        write_policy(policy_dir, {key: {"method": "ochiai", "kernel": kernel}})
        jcfg, jres = jax_policy.apply_tuned_policy(JaxConfig(), lane="table", counts=COUNTS)
        assert jres.outcome == "applied" and jcfg.runtime.kernel == kernel
        if kernel == "bogus":
            with pytest.raises(ValueError, match=r"unknown kernel.*--no-tuned-policy"):
                policy.apply_tuned_policy(MicroRankConfig(), lane="table", counts=COUNTS)
        else:
            cfg, res = policy.apply_tuned_policy(MicroRankConfig(), lane="table", counts=COUNTS)
            assert (res.outcome, cfg.runtime.kernel) == ("applied", kernel)
        # An explicit kernel wins over the policy's, so nothing is refused.
        cfg, res = policy.apply_tuned_policy(
            MicroRankConfig(runtime=RuntimeConfig(kernel="kind")), lane="table", counts=COUNTS
        )
        assert cfg.runtime.kernel == "kind" and cfg.spectrum.method == "ochiai"


@pytest.fixture(scope="module")
def csv_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("policy_case")
    case = generate_case(SyntheticConfig(
        n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5
    ))
    normal, abnormal = case.write_csvs(d)
    return case, normal, abnormal


def lane_profile(normal):
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table
    from microrank_tpu_torch.native import load_span_table

    table = load_span_table(normal, cache=False)
    vocab, _ = compute_slo_from_table(table)
    return policy.profile_from_counts(table.n_spans, len(vocab)).key()


def test_table_lane_consults_policy(policy_dir, registries, csv_pair):
    from microrank_tpu.native import load_span_table as jax_load
    from microrank_tpu.pipeline import TableRCA as JaxTableRCA
    from microrank_tpu.pipeline.table_runner import run_rca_native as jax_run
    from microrank_tpu_torch.native import load_span_table
    from microrank_tpu_torch.pipeline import TableRCA, run_rca_native
    from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

    case, normal, abnormal = csv_pair
    write_policy(policy_dir, {lane_profile(normal): {
        "method": "ochiai", "kernel": "auto", "pad_policy": "pow2q"}})
    rca = TableRCA(MicroRankConfig(), device="cpu")
    rca.fit_baseline(load_span_table(normal, cache=False))
    jrca = JaxTableRCA(JaxConfig())
    jrca.fit_baseline(jax_load(normal, cache=False))
    assert rca.config.spectrum.method == jrca.config.spectrum.method == "ochiai"
    assert rca.policy_resolution.outcome == "applied"
    assert rca.policy_resolution.journal() == jrca.policy_resolution.journal()
    assert counter(registries[0]) == counter(registries[1]) == {("table", "applied"): 1}
    # The lane ranks with the policy's formula, as JAX's does.
    tres = run_rca_native(normal, abnormal, MicroRankConfig(ingest=IngestConfig(enabled=False)),
                          device="cpu")
    jres = jax_run(normal, abnormal, JaxConfig(ingest=JaxIngest(enabled=False)))
    explicit = run_rca_native(normal, abnormal, MicroRankConfig(
        spectrum=SpectrumConfig(method="ochiai"), ingest=IngestConfig(enabled=False),
    ), device="cpu")
    assert [r.ranking for r in tres] == [r.ranking for r in explicit]
    for t, j in zip(tres, jres):
        assert t.start == j.start and bool(t.ranking) == bool(j.ranking)
        if t.ranking:
            ok, why = tie_aware_topk_agreement(
                [n for n, _ in j.ranking], [s for _, s in j.ranking],
                [n for n, _ in t.ranking], [s for _, s in t.ranking],
                k=len(j.ranking), rtol=1e-5,
            )
            assert ok, why


def test_no_tuned_policy_pins_the_defaults(policy_dir, registries, csv_pair, tmp_path):
    from microrank_tpu.cli.main import main as jax_main

    _, normal, abnormal = csv_pair
    write_policy(policy_dir, {lane_profile(normal): {"method": "ochiai"}})
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    outs = {}
    for name, flags in (("tuned", []), ("pinned", ["--no-tuned-policy"])):
        args = cli.build_parser().parse_args(base + flags)
        assert cli._config_from_args(args).runtime.tuned_policy == (
            "off" if flags else "auto"
        )
        for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                 ("jax", jax_main, ["--engine", "native"])):
            out = tmp_path / f"{pkg}_{name}"
            assert main(base + ["-o", str(out)] + flags + extra) == 0
            outs[pkg, name] = [
                json.loads(ln)["ranking"] for ln in (out / "windows.jsonl").read_text().splitlines()
            ]
    assert outs["port", "tuned"] != outs["port", "pinned"]
    assert [[n for n, _ in r] for r in outs["port", "tuned"]] == [
        [n for n, _ in r] for r in outs["jax", "tuned"]
    ]
    assert [[n for n, _ in r] for r in outs["port", "pinned"]] == [
        [n for n, _ in r] for r in outs["jax", "pinned"]
    ]
    assert counter(registries[0]) == {("table", "applied"): 1, ("table", "disabled"): 1}


def test_config_field_matches_jax():
    assert RuntimeConfig().tuned_policy == JaxRuntime().tuned_policy == "auto"
    assert dataclasses.replace(RuntimeConfig(), tuned_policy="off").tuned_policy == "off"
