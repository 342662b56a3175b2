"""The online RCA service (``cli serve``; counterpart of
``microrank_tpu/serve/``): the asyncio HTTP frontend (``server``),
per-tenant fair scheduling (``scheduler``), cross-request micro-batching
by shape bucket onto the stacked rank program (``batcher``), admission
control (``admission``) and the wire protocol (``protocol``). A device
fault degrades, visibly, to the numpy_ref oracle instead of dropping a
request."""

from .admission import AdmissionController
from .batcher import MicroBatcher, PendingWindow
from .protocol import (
    AdmissionError,
    DeadlineExceeded,
    ProtocolError,
    RankRequest,
    parse_rank_request,
    response_body,
    spans_to_table,
)
from .scheduler import BatchScheduler, ShutdownError
from .server import (
    HttpFrontend,
    ServeHandle,
    ServeService,
    ServiceDraining,
    ServiceOverloaded,
    run_serve,
)

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "BatchScheduler",
    "DeadlineExceeded",
    "HttpFrontend",
    "MicroBatcher",
    "PendingWindow",
    "ProtocolError",
    "RankRequest",
    "ServeHandle",
    "ServeService",
    "ServiceDraining",
    "ServiceOverloaded",
    "ShutdownError",
    "parse_rank_request",
    "response_body",
    "run_serve",
    "spans_to_table",
]
