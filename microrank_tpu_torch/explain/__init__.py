"""The build-side column identity the warm start joins on
(``bundle.ExplainContext``). The explained program (K15) and its bundle
are not ported: ROADMAP.md, port queue item 11's explain slice."""

from .bundle import ExplainContext

__all__ = ["ExplainContext"]
