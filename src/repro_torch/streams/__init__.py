"""The streaming layer: Zipf traces, the pipelined ingest ring and standing
alerts (the names ``repro.streams`` exports)."""
from repro_torch.streams.alerts import AlertSet, AlertSpec, FiredBatch, PollOracle
from repro_torch.streams.ingest import IngestPipeline, IngestStats
from repro_torch.streams.traces import (
    Trace,
    batched_playback,
    generate_trace,
    shift_workload,
    zipf_frequencies,
)

__all__ = [
    "Trace",
    "zipf_frequencies",
    "generate_trace",
    "shift_workload",
    "batched_playback",
    "IngestPipeline",
    "IngestStats",
    "AlertSpec",
    "AlertSet",
    "FiredBatch",
    "PollOracle",
]
