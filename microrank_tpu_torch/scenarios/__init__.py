"""The read side of the tuned-policy engine (counterpart of part of
``microrank_tpu/scenarios``): the lanes resolve their spectrum method,
kernel and pad policy from a persisted ``policy.json``. The scenario
matrix that writes that file (``cli scenarios``, ``select_policy`` /
``save_policy``) is not ported (ROADMAP.md 'Port queue' item 11)."""

from .policy import PolicyResolution, apply_tuned_policy, resolve_policy

__all__ = ["PolicyResolution", "apply_tuned_policy", "resolve_policy"]
