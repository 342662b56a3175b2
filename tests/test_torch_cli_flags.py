"""``cli run``'s ranking and detection flags held to the JAX CLI's:

* the parser: every flag the port takes from the JAX CLI's
  ``_add_config_flags`` has its name, default, type and choices there,
  and ``--kind-dedup-threshold`` / ``--slo-cache`` those of JAX's
  ``run``;
* the run: both CLIs on one synthetic dump with ``--spectrum-method
  ochiai --iterations 30 --damping 0.8 --k-sigma 2.5 --top-max 7`` (the
  port on the CPU, JAX's ``--engine native``) write the same
  ``result.csv``: the same windows and rows, the same top-1, the
  rankings tie-aware equal with confidences within rtol 1e-5 (float32
  sums in another order, as tests/test_torch_obs_metrics.py's gate);
* an explicit flag beats a tuned ``policy.json`` (here tuning the
  window's profile to tarantula): the run equals one pinned with
  ``--no-tuned-policy`` and the flag, in both CLIs;
* ``--reference-compat`` (the partition swap and the overwritten
  result.csv) and ``--slo-cache`` (written on the first run, read on
  the next, in JAX's npz format) as JAX's.
"""

import argparse
import csv
import importlib
import json

import numpy as np
import pytest

from microrank_tpu_torch import cli
from microrank_tpu_torch.config import SpectrumConfig
from microrank_tpu_torch.scenarios import policy
from microrank_tpu_torch.testing import SyntheticConfig, generate_case
from microrank_tpu_torch.utils.ranking_compare import tie_aware_topk_agreement

FLAGS = ["--spectrum-method", "ochiai", "--iterations", "30", "--damping", "0.8",
         "--k-sigma", "2.5", "--top-max", "7"]
RANKING_FLAGS = ["spectrum_method", "top_max", "iterations", "damping", "call_weight",
                 "preference", "k_sigma", "slack_ms", "slo_stat", "detect_minutes",
                 "skip_minutes", "reference_compat"]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_flags")
    case = generate_case(SyntheticConfig(
        n_operations=30, n_traces=300, n_kinds=24, child_keep_prob=0.6, seed=5
    ))
    normal, abnormal = case.write_csvs(d)
    return case, normal, abnormal


@pytest.fixture
def policy_dir(tmp_path, monkeypatch):
    d = tmp_path / "policy"
    d.mkdir()
    monkeypatch.setenv("MICRORANK_POLICY_DIR", str(d))
    return d


def jax_parser():
    from microrank_tpu.cli.main import _add_config_flags

    p = argparse.ArgumentParser()
    _add_config_flags(p)
    return p


def port_run_parser():
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices["run"]


def actions(parser):
    return {a.dest: a for a in parser._actions}


@pytest.mark.parametrize("dest", RANKING_FLAGS)
def test_flag_has_jax_name_default_and_choices(dest):
    ours, theirs = actions(port_run_parser())[dest], actions(jax_parser())[dest]
    assert ours.option_strings == theirs.option_strings
    assert (ours.default, ours.type, ours.choices, ours.nargs, ours.const) == (
        theirs.default, theirs.type, theirs.choices, theirs.nargs, theirs.const
    )


@pytest.mark.parametrize("dest", ["explain", "explain_top_traces"])
def test_explain_flags_have_jax_names_defaults_and_types(dest):
    """``--explain`` and ``--explain-top-traces`` as JAX's
    ``_add_config_flags`` declares them: the name, default, action and,
    for the count, a positive-int type refusing 0 in both."""
    ours, theirs = actions(port_run_parser())[dest], actions(jax_parser())[dest]
    assert ours.option_strings == theirs.option_strings
    assert (ours.default, ours.choices, ours.nargs, ours.const, type(ours)) == (
        theirs.default, theirs.choices, theirs.nargs, theirs.const, type(theirs)
    )
    if theirs.type is not None:
        assert ours.type("7") == theirs.type("7") == 7
        for t in (ours.type, theirs.type):
            with pytest.raises(argparse.ArgumentTypeError):
                t("0")
    argv = ["--explain", "--explain-top-traces", "7"]
    jax_args = jax_parser().parse_args(argv)
    port_args = cli.build_parser().parse_args(["stream", *argv])
    assert getattr(port_args, dest) == getattr(jax_args, dest)
    cfg = cli._config_from_args(port_args)
    assert (cfg.explain.enabled, cfg.explain.top_traces) == (True, 7)
    assert cli._config_from_args(cli.build_parser().parse_args(["stream"])).explain == (
        type(cfg.explain)())


def test_run_only_flags_match_jax_run(dump):
    from microrank_tpu.cli.main import main as jax_main

    _, normal, abnormal = dump
    seen = {}

    class Stop(Exception):
        pass

    def grab(args):
        seen["jax"] = args
        raise Stop

    # JAX builds its parser inside main(): read its run parser's result
    # through the handler it dispatches to.
    jax_cli = importlib.import_module("microrank_tpu.cli.main")

    argv = ["run", "--normal", str(normal), "--abnormal", str(abnormal),
            "--kind-dedup-threshold", "2.5", "--slo-cache", "b.npz"]
    orig = jax_cli.cmd_run
    jax_cli.cmd_run = grab
    try:
        with pytest.raises(Stop):
            jax_main(argv)
    finally:
        jax_cli.cmd_run = orig
    ours = cli.build_parser().parse_args(argv)
    for dest in ("kind_dedup_threshold", "slo_cache", *RANKING_FLAGS):
        assert getattr(ours, dest) == getattr(seen["jax"], dest), dest
    cfg = cli._config_from_args(ours)
    assert cfg.runtime.kind_dedup_threshold == 2.5


def test_flags_reach_the_config():
    args = cli.build_parser().parse_args(
        ["run", "--normal", "n", "--abnormal", "a", *FLAGS, "--call-weight", "0.02",
         "--preference", "paper", "--slack-ms", "3", "--slo-stat", "p90",
         "--detect-minutes", "4", "--skip-minutes", "3", "--kind-precision", "bf16"]
    )
    cfg = cli._config_from_args(args)
    assert (cfg.spectrum.method, cfg.spectrum.top_max) == ("ochiai", 7)
    assert (cfg.pagerank.iterations, cfg.pagerank.damping, cfg.pagerank.call_weight,
            cfg.pagerank.preference, cfg.pagerank.kind_precision) == (30, 0.8, 0.02, "paper",
                                                                      "bf16")
    assert (cfg.detector.k_sigma, cfg.detector.slack_ms, cfg.detector.slo_stat) == (
        2.5, 3.0, "p90"
    )
    assert (cfg.window.detect_minutes, cfg.window.skip_minutes) == (4.0, 3.0)
    assert not cfg.compat.partition_swap
    compat = cli._config_from_args(cli.build_parser().parse_args(
        ["run", "--normal", "n", "--abnormal", "a", "--reference-compat"]
    )).compat
    assert compat.partition_swap and compat.overwrite_results


def read_results(out):
    with open(out / "result.csv") as f:
        rows = list(csv.DictReader(f))
    by_window = {}
    for r in rows:
        by_window.setdefault((r.get("level"), r.get("window_start")), []).append(r)
    return rows, by_window


def assert_same_results(port_out, jax_out):
    (rows, ours), (jrows, theirs) = read_results(port_out), read_results(jax_out)
    assert rows and list(ours) == list(theirs)
    for key, o in ours.items():
        t = theirs[key]
        assert [r["rank"] for r in o] == [r["rank"] for r in t]
        assert o[0]["result"] == t[0]["result"]
        ok, why = tie_aware_topk_agreement(
            [r["result"] for r in t], [float(r["confidence"]) for r in t],
            [r["result"] for r in o], [float(r["confidence"]) for r in o],
            k=len(o), rtol=1e-5,
        )
        assert ok, why


def run_both(tmp_path, normal, abnormal, flags, tag):
    from microrank_tpu.cli.main import main as jax_main

    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal)]
    outs = {}
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_main, ["--engine", "native"])):
        out = tmp_path / f"{pkg}_{tag}"
        assert main(base + ["-o", str(out)] + flags + extra) == 0
        outs[pkg] = out
    return outs


def test_ranking_flags_give_the_jax_cli_result_csv(dump, tmp_path):
    case, normal, abnormal = dump
    outs = run_both(tmp_path, normal, abnormal, FLAGS, "flags")
    assert_same_results(outs["port"], outs["jax"])
    rows, by_window = read_results(outs["port"])
    # The flags took effect: top_max 7 (plus the spectrum's extra rows)
    # rows a ranked window, other rankings than the defaults'.
    assert max(len(v) for v in by_window.values()) == SpectrumConfig(top_max=7).n_rows
    default = run_both(tmp_path, normal, abnormal, [], "default")
    assert read_results(default["port"])[0] != rows
    assert rows[0]["result"] == case.fault_pod_op


def lane_profile(normal):
    from microrank_tpu_torch.graph.table_ops import compute_slo_from_table
    from microrank_tpu_torch.native import load_span_table

    table = load_span_table(normal, cache=False)
    vocab, _ = compute_slo_from_table(table)
    return policy.profile_from_counts(table.n_spans, len(vocab)).key()


def test_explicit_flag_beats_tuned_policy(dump, tmp_path, policy_dir):
    _, normal, abnormal = dump
    (policy_dir / policy.POLICY_NAME).write_text(json.dumps({
        "version": policy.POLICY_VERSION,
        "profile_schema": policy.PROFILE_SCHEMA,
        "profiles": {lane_profile(normal): {"method": "tarantula"}},
    }))
    flagged = run_both(tmp_path, normal, abnormal, ["--spectrum-method", "ochiai"], "flag")
    pinned = run_both(tmp_path, normal, abnormal,
                      ["--spectrum-method", "ochiai", "--no-tuned-policy"], "pinned")
    tuned = run_both(tmp_path, normal, abnormal, [], "tuned")
    for pkg in ("port", "jax"):
        assert read_results(flagged[pkg])[0] == read_results(pinned[pkg])[0]
        assert read_results(flagged[pkg])[0] != read_results(tuned[pkg])[0]
    assert_same_results(flagged["port"], flagged["jax"])
    assert_same_results(tuned["port"], tuned["jax"])


def test_reference_compat_matches_jax_cli(dump, tmp_path):
    _, normal, abnormal = dump
    outs = run_both(tmp_path, normal, abnormal, ["--reference-compat"], "compat")
    assert_same_results(outs["port"], outs["jax"])


def test_slo_cache_is_written_then_read_in_jax_format(dump, tmp_path):
    from microrank_tpu.pipeline.checkpoint import load_slo as jax_load_slo
    from microrank_tpu_torch.pipeline.checkpoint import load_slo

    _, normal, abnormal = dump
    cache = tmp_path / "slo.npz"
    base = ["run", "--normal", str(normal), "--abnormal", str(abnormal), "--device", "cpu",
            "--slo-cache", str(cache)]
    assert cli.main(base + ["-o", str(tmp_path / "first")]) == 0
    assert cache.exists()
    (vocab, baseline), (j_vocab, j_baseline) = load_slo(cache), jax_load_slo(cache)
    assert list(vocab.names) == list(j_vocab.names)
    np.testing.assert_array_equal(baseline.mean_ms, j_baseline.mean_ms)
    np.testing.assert_array_equal(baseline.std_ms, j_baseline.std_ms)
    # The second run reads the cache: a baseline it could not have fit
    # from the normal dump (every op's SLO mean far above any duration)
    # detects nothing.
    from microrank_tpu_torch.pipeline.checkpoint import save_slo

    save_slo(cache, vocab, baseline._replace(mean_ms=baseline.mean_ms + 1e9))
    assert cli.main(base + ["-o", str(tmp_path / "second")]) == 0
    assert read_results(tmp_path / "first")[0]
    second = tmp_path / "second"
    assert not (second / "result.csv").exists() or not read_results(second)[0]
