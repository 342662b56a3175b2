"""Rank provenance (counterpart of ``microrank_tpu/explain``):

* the explained program (K15): ``rank_backends.torch_cuda.
  rank_window_explained(_core)``, its attribution epilogue
  ``ops.explain.explain_epilogue`` (``csrc/explain_epilogue.cu``);
* ``bundle``: ``ExplainBundle`` (JSON + table), ``build_bundle``, and
  ``ExplainContext``, the build-side column identity the bundle and the
  warm start join on;
* ``oracle``: the float64 numpy twin the tests and ``chip_smoke.py`` hold
  the attributions to, tie-aware;
* ``store``: the bounded ring of recent bundles that the obs server's
  ``GET /explainz?window=...`` serves.

``ExplainConfig.enabled`` off (the default) runs the unchanged rank
programs.
"""

from .bundle import ExplainBundle, ExplainContext, build_bundle
from .store import get_explain_store

__all__ = ["ExplainBundle", "ExplainContext", "build_bundle", "get_explain_store"]
