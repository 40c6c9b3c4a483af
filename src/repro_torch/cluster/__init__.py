"""repro_torch.cluster — the distributed serving plane.

Row-band sharding over processes: :class:`ShardWorker` owns a band of
every signal and serves band coresets over the v1 wire protocol;
:class:`ClusterEngine` is a drop-in ``CoresetEngine`` whose dense builds
scatter to workers and gather only the tiny coresets back, bitwise
fingerprint-equal to the single-host thread-pool path.  See DESIGN.md
"Distributed serving plane".
"""
from .coordinator import ClusterEngine
from .rpc import (BandAck, BandAssignRequest, BandBuildRequest,
                  BandCoresetResponse, BandDeltaRequest, WorkerClient,
                  WorkerRPCError, WorkerTransportError, band_hash,
                  coreset_from_msg, coreset_to_msg)
from .worker import ShardWorker, make_worker_server

__all__ = [
    "ClusterEngine", "ShardWorker", "make_worker_server", "WorkerClient",
    "WorkerRPCError", "WorkerTransportError", "band_hash",
    "coreset_to_msg", "coreset_from_msg",
    "BandAssignRequest", "BandDeltaRequest", "BandBuildRequest", "BandAck",
    "BandCoresetResponse",
]
