"""Tuned-policy resolution: a persisted ``policy.json`` -> the run's
spectrum method, kernel and pad policy (counterpart of the read side of
``microrank_tpu/scenarios/policy.py``).

The JAX package's scenario matrix measures which spectrum formula wins
on which workload and writes the winners to ``policy.json``, next to
its compile cache; a lane that starts later inherits them. This module
reads that file, in the JAX package's schema, so a policy written by
the JAX package's ``select_policy`` / ``save_policy`` resolves here
unchanged. Resolution is one seam (:func:`apply_tuned_policy`) with
strict precedence:

    explicit config  >  persisted policy  >  built-in default

"Explicit" means the field differs from its built-in default: the policy
never overrides an operator. (``RuntimeConfig.tuned_policy="off"`` / the
CLI's ``--no-tuned-policy`` pins the defaults against any policy.)

Staleness: a ``policy.json`` whose schema version or profile-bucket
schema differs from this build's, or which has no entry for the run's
workload profile, is rejected whole: the run starts on the built-in
defaults and ``microrank_policy_events_total{outcome="rejected"}``
counts it. A policy may name any kernel the JAX package runs (csr,
coo, dense and dense_bf16 too); one that names an unknown kernel raises
``ValueError``: no other kernel stands in for it silently.

The write side: :func:`select_policy` distills scored scenario
records (the warehouse's retro lane, ``cli scenarios
--from-warehouse``) into the document and :func:`save_policy` persists
it. The synthetic scenario matrix is not ported (ROADMAP.md, port queue
item 11's scenarios remainder).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..config import KERNELS, MicroRankConfig, RuntimeConfig, SpectrumConfig
from ..obs.metrics import record_policy_event

log = logging.getLogger("microrank_tpu_torch.scenarios.policy")

POLICY_NAME = "policy.json"
POLICY_VERSION = 1

# Workload-profile bucket edges: part of the policy file's identity (a
# policy tuned under other edges is stale by definition). The JAX
# package's, value for value.
PROFILE_SCHEMA: Dict[str, object] = {
    "version": 1,
    # Spans per detection window.
    "span_volume": [50_000, 2_000_000],        # small | medium | large
    # Distinct (service, op) names.
    "op_cardinality": [256, 4096],             # small | medium | large
    # Trace-kind dedup factor (traces per distinct trace shape).
    "dedup_factor": [8.0],                     # low | high
}

_SIZE_NAMES = ("small", "medium", "large")

#: The tuned fields and their built-in defaults (the "explicit config"
#: test compares against these).
TUNED_DEFAULTS: Dict[str, str] = {
    "method": SpectrumConfig().method,
    "kernel": RuntimeConfig().kernel,
    "pad_policy": RuntimeConfig().pad_policy,
}


def _bucket(value: float, edges) -> str:
    for name, edge in zip(_SIZE_NAMES, edges):
        if value < edge:
            return name
    return _SIZE_NAMES[len(edges)]


@dataclass(frozen=True)
class WorkloadProfile:
    """A run's workload, bucketed: the policy lookup key."""

    span_volume: str
    op_cardinality: str
    dedup: str

    def key(self) -> str:
        return (
            f"spans={self.span_volume}|ops={self.op_cardinality}"
            f"|dedup={self.dedup}"
        )


def profile_from_counts(
    n_spans: int,
    n_ops: int,
    dedup_factor: Optional[float] = None,
) -> WorkloadProfile:
    """Profile from raw counts. ``dedup_factor=None`` (the native table
    lane cannot cheaply measure trace kinds before its first window)
    buckets as "low", the conservative bucket: no dedup assumed."""
    return WorkloadProfile(
        span_volume=_bucket(n_spans, PROFILE_SCHEMA["span_volume"]),
        op_cardinality=_bucket(n_ops, PROFILE_SCHEMA["op_cardinality"]),
        dedup=(
            "high"
            if dedup_factor is not None
            and dedup_factor >= PROFILE_SCHEMA["dedup_factor"][0]
            else "low"
        ),
    )


# ------------------------------------------------------------- persistence


def resolve_cache_dir() -> str:
    """The JAX package's compile-cache directory (its
    ``dispatch.resolve_cache_dir`` without a configured directory, a
    field this package's config does not have): ``MICRORANK_JIT_CACHE``
    env > ``~/.cache/microrank_tpu/jit``. The policy lives there by
    default, so both packages read the same file."""
    env = os.environ.get("MICRORANK_JIT_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "microrank_tpu", "jit"
    )


def resolve_policy_dir() -> str:
    """Directory holding ``policy.json``: ``MICRORANK_POLICY_DIR`` env
    (hermetic tests, split deployments) over the compile-cache dir."""
    env = os.environ.get("MICRORANK_POLICY_DIR")
    if env:
        return env
    return resolve_cache_dir()


def policy_path(cache_dir) -> Path:
    return Path(cache_dir) / POLICY_NAME


def load_policy(
    cache_dir,
) -> Tuple[Optional[dict], Optional[str]]:
    """(data, reject_reason): (None, None) when absent; (None, reason)
    when present but stale or corrupt (rejected whole); (data, None)
    when valid for this build."""
    path = policy_path(cache_dir) if cache_dir else None
    if path is None or not path.exists():
        return None, None
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        return None, f"unreadable ({exc})"
    if not isinstance(data, dict):
        return None, "not a JSON object"
    if data.get("version") != POLICY_VERSION:
        return None, (
            f"schema version {data.get('version')!r} != "
            f"{POLICY_VERSION}"
        )
    if data.get("profile_schema") != PROFILE_SCHEMA:
        return None, "profile-bucket schema mismatch"
    profiles = data.get("profiles")
    if not isinstance(profiles, dict):
        return None, "missing profiles table"
    return data, None


# -------------------------------------------------------------- resolution


@dataclass
class PolicyResolution:
    """What one lane's policy consultation decided (journal evidence)."""

    lane: str
    outcome: str                       # applied|override|default|rejected|disabled
    profile: Optional[str] = None
    reason: Optional[str] = None
    policy_file: Optional[str] = None
    # field -> {"value": ..., "source": "config"|"policy"|"default"}
    fields: Dict[str, Dict[str, str]] = field(default_factory=dict)

    def journal(self) -> dict:
        return {
            "lane": self.lane,
            "outcome": self.outcome,
            "profile": self.profile,
            "reason": self.reason,
            "policy_file": self.policy_file,
            **{
                f"{name}": d["value"]
                for name, d in self.fields.items()
            },
            **{
                f"{name}_source": d["source"]
                for name, d in self.fields.items()
            },
        }


def _apply_fields(
    config: MicroRankConfig, values: Dict[str, str]
) -> MicroRankConfig:
    return config.replace(
        spectrum=dataclasses.replace(
            config.spectrum, method=values["method"]
        ),
        runtime=dataclasses.replace(
            config.runtime,
            kernel=values["kernel"],
            pad_policy=values["pad_policy"],
        ),
    )


def resolve_policy(
    config: MicroRankConfig,
    profile: Optional[WorkloadProfile],
    lane: str,
    cache_dir: Optional[str] = None,
) -> Tuple[MicroRankConfig, PolicyResolution]:
    """The one resolver seam (the table lane calls it through
    :func:`apply_tuned_policy` before its first window). Returns the
    (possibly updated) config and the resolution record; every call
    lands one ``microrank_policy_events_total`` sample."""
    current = {
        "method": config.spectrum.method,
        "kernel": config.runtime.kernel,
        "pad_policy": config.runtime.pad_policy,
    }
    explicit = {
        name: current[name] != default
        for name, default in TUNED_DEFAULTS.items()
    }
    res = PolicyResolution(
        lane=lane,
        outcome="default",
        profile=profile.key() if profile is not None else None,
        fields={
            name: {
                "value": current[name],
                "source": "config" if explicit[name] else "default",
            }
            for name in TUNED_DEFAULTS
        },
    )
    if getattr(config.runtime, "tuned_policy", "auto") == "off":
        res.outcome = "disabled"
        record_policy_event("disabled", lane)
        return config, res

    if cache_dir is None:
        cache_dir = resolve_policy_dir()
    data, reject = load_policy(cache_dir)
    if data is None and reject is None:
        record_policy_event("default", lane)
        return config, res
    res.policy_file = str(policy_path(cache_dir))
    if reject is None:
        entry = (
            data["profiles"].get(profile.key())
            if profile is not None
            else None
        )
        if entry is None:
            reject = (
                f"no tuned entry for workload profile "
                f"{profile.key() if profile else None!r}"
            )
    if reject is not None:
        # Whole rejection: a stale or mismatched policy applies nothing.
        res.outcome = "rejected"
        res.reason = reject
        record_policy_event("rejected", lane)
        log.warning(
            "%s lane: policy.json rejected (%s); built-in defaults",
            lane, reject,
        )
        return config, res

    values = dict(current)
    applied = []
    for name in TUNED_DEFAULTS:
        tuned = entry.get(name)
        if tuned is None or explicit[name]:
            continue  # operator's explicit choice (or untuned field) wins
        values[name] = str(tuned)
        res.fields[name] = {"value": values[name], "source": "policy"}
        applied.append(name)
    if values["kernel"] not in KERNELS:
        raise ValueError(
            f"{res.policy_file} tunes profile {res.profile} to the unknown "
            f"kernel={values['kernel']!r}; no other kernel stands in for it. "
            "Run with --no-tuned-policy (RuntimeConfig.tuned_policy='off') or "
            "an explicit --kernel."
        )
    res.outcome = "applied" if applied else "override"
    record_policy_event(res.outcome, lane)
    log.info(
        "%s lane: tuned policy %s for profile %s (%s)",
        lane,
        res.outcome,
        res.profile,
        ", ".join(
            f"{n}={d['value']}({d['source']})"
            for n, d in res.fields.items()
        ),
    )
    return _apply_fields(config, values), res


def apply_tuned_policy(
    config: MicroRankConfig,
    lane: str,
    counts: Optional[Tuple[int, int, Optional[float]]] = None,
    cache_dir: Optional[str] = None,
) -> Tuple[MicroRankConfig, PolicyResolution]:
    """Lane entry point: the workload profile from raw ``(n_spans, n_ops,
    dedup_factor)`` counts (the native table lane; the JAX package's
    pandas lanes profile a span frame instead), then resolve."""
    profile = profile_from_counts(*counts) if counts is not None else None
    return resolve_policy(config, profile, lane, cache_dir=cache_dir)


# --------------------------------------------------------------- selection


def save_policy(cache_dir, data: dict) -> Path:
    """Atomic, durable write of ``policy.json`` into ``cache_dir``."""
    from ..utils.atomic import atomic_write_json

    return atomic_write_json(policy_path(cache_dir), data)


def select_policy(scenario_records: List[dict], timings: Optional[Dict[str, dict]] = None,
                  matrix_seed: Optional[int] = None) -> dict:
    """Scored scenario records -> the persisted policy document (JAX's
    ``select_policy``): per workload profile, the formula with the best
    mean MAP over that profile's records wins (ties: top-1 exact rate,
    then mean MRR, then name); kernel and pad policy come from a timing
    sweep of that profile when one ran, else stay at the defaults."""
    by_profile: Dict[str, List[dict]] = {}
    for rec in scenario_records:
        prof = rec.get("profile")
        formulas = rec.get("formulas") or {}
        if prof and formulas:
            by_profile.setdefault(prof, []).append(formulas)
    profiles: Dict[str, dict] = {}
    for prof, recs in sorted(by_profile.items()):
        scored = []
        for m in sorted({m for r in recs for m in r}):
            rows = [r[m] for r in recs if m in r]

            def mean(key, rows=rows):
                return sum(float(r.get(key) or 0.0) for r in rows) / max(len(rows), 1)

            scored.append((-mean("map"), -mean("top1_rate"), -mean("mrr"), m))
        scored.sort()
        best = scored[0]
        entry = {
            "method": best[3],
            "kernel": TUNED_DEFAULTS["kernel"],
            "pad_policy": TUNED_DEFAULTS["pad_policy"],
            "evidence": {"scenarios": len(recs), "map": round(-best[0], 4),
                         "top1_rate": round(-best[1], 4), "mrr": round(-best[2], 4)},
        }
        timing = (timings or {}).get(prof)
        if timing:
            entry["kernel"] = timing["kernel"]
            entry["pad_policy"] = timing["pad_policy"]
            entry["evidence"]["rank_ms"] = timing.get("rank_ms")
            entry["evidence"]["timed_candidates"] = timing.get("candidates")
        profiles[prof] = entry
    return {"version": POLICY_VERSION, "profile_schema": PROFILE_SCHEMA,
            "matrix_seed": matrix_seed, "profiles": profiles}
