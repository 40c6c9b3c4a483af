from .fault_tolerance import HeartbeatMonitor, WorkerState, supervise
from .elastic import plan_mesh, reshard_state

__all__ = ["HeartbeatMonitor", "WorkerState", "supervise", "plan_mesh",
           "reshard_state"]
