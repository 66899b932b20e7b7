"""In-process distributed coded-inference executor.

Execution, not simulation: a :class:`WorkerPool` of threaded workers runs
real CUDA/torch subtask compute; the master decodes at the k-th arrival
(via the ``CodingScheme`` protocol), cancels stragglers, and re-dispatches
on injected failures.  ``FakeClock`` + ``DeterministicDelay`` make every
§V scenario a deterministic wall-clock-free test; ``RealClock`` makes the
k-of-n saving measurable.  ``MeshExecutor`` is the second backend: each
coded op as one device program (all n pieces in one launch), captured as a
CUDA graph on the card.
"""
from .backend import CodedOp, ExecBackend, run_coded_op
from .clock import (
    Clock,
    FakeClock,
    RealClock,
    pipelined_time,
    stream_chunk_count,
)
from .executor import CodedExecutor, ExecHandle, decodable_prefix
from .mesh_exec import MeshExecutor
from .faults import (
    ChurnEvent,
    ChurnSchedule,
    DelayModel,
    DeterministicDelay,
    FaultPlan,
    LayerSlowdown,
    SegmentDelay,
    ShiftExpDelay,
    StragglerDrift,
    per_layer_sizes,
)
from .pool import (
    Arrival,
    Piece,
    PieceTiming,
    RunHandle,
    RunReport,
    Undecodable,
    WorkerPool,
)

__all__ = [
    "Clock",
    "FakeClock",
    "RealClock",
    "pipelined_time",
    "stream_chunk_count",
    "CodedOp",
    "ExecBackend",
    "run_coded_op",
    "CodedExecutor",
    "ExecHandle",
    "decodable_prefix",
    "MeshExecutor",
    "ChurnEvent",
    "ChurnSchedule",
    "DelayModel",
    "DeterministicDelay",
    "FaultPlan",
    "LayerSlowdown",
    "StragglerDrift",
    "ShiftExpDelay",
    "SegmentDelay",
    "per_layer_sizes",
    "Arrival",
    "Piece",
    "PieceTiming",
    "RunHandle",
    "RunReport",
    "Undecodable",
    "WorkerPool",
]
