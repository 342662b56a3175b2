"""The tuned-policy engine (counterpart of part of
``microrank_tpu/scenarios``): the lanes resolve their spectrum method,
kernel and pad policy from a persisted ``policy.json``; the warehouse's
retro lane (``cli scenarios --from-warehouse``) writes it through
``select_policy`` / ``save_policy``. The synthetic scenario matrix is not
ported (ROADMAP.md, port queue item 11's scenarios remainder)."""

from .policy import (
    PolicyResolution,
    apply_tuned_policy,
    resolve_policy,
    save_policy,
    select_policy,
)

__all__ = ["PolicyResolution", "apply_tuned_policy", "resolve_policy", "save_policy",
           "select_policy"]
