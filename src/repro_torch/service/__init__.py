# Coreset-as-a-service layer: the paper's reuse guarantee (one (k, eps)-
# coreset answers EVERY <=k-leaf tree query) turned into a serving system —
# dominance-aware cache, continuous-batching build scheduler, streamed
# ingest via merge-reduce, a typed v1 wire protocol (JSON + binary npz
# frames) and a stdlib HTTP front.  See DESIGN.md.
from .admission import (AdmissionConfig, AdmissionController,
                        AdmissionRejected)
from .cache import CacheEntry, DominanceCache
from .engine import CoresetEngine, SignalState, UnknownSignalError
from .metrics import Histogram, ServiceMetrics
from .query_scheduler import DeadlineExceeded, QueryScheduler
from .scheduler import BuildScheduler
from . import protocol
from .api import ApiError, make_server, serve_forever_in_thread

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionRejected",
    "CacheEntry", "DominanceCache", "CoresetEngine", "SignalState",
    "UnknownSignalError", "Histogram", "ServiceMetrics", "BuildScheduler",
    "QueryScheduler", "DeadlineExceeded",
    "protocol", "ApiError", "make_server", "serve_forever_in_thread",
]
