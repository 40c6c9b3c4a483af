from .fault_tolerance import HeartbeatMonitor, WorkerState, supervise

__all__ = ["HeartbeatMonitor", "WorkerState", "supervise"]
