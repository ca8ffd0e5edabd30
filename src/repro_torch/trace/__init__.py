"""Cluster-scale trace record/replay (the simulation substrate).

Record every scheduling decision from a live ``SimExecutor`` /
``UsfRuntime`` run to a versioned JSONL trace; replay recorded or
synthesized traces through the discrete-event engine at
hundreds-of-thousands of events per second; A/B one trace under two
arbiter/policy configurations.

Layers:

* ``schema``   — versioned JSONL encode/decode (decision + workload records)
* ``recorder`` — arm points, ring buffer, background flush
* ``replayer`` — workload model, decision→workload reconstruction, replay
* ``synth``    — arrival generators (Poisson/burst/diurnal), perturbations
* ``adapter``  — Google/Alibaba-style task-event CSV → workload
* ``ab``       — policy A/B runner + replayed SLO sweep
"""

from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.replayer import (
    ReplayConfig,
    Replayer,
    Workload,
    decision_stream,
    diff_streams,
    reconstruct,
)
from repro_torch.trace.schema import (
    SCHEMA_NAME,
    SCHEMA_VERSION,
    TraceSchemaError,
    load_trace,
    save_trace,
)

__all__ = [
    "TraceRecorder",
    "ReplayConfig",
    "Replayer",
    "Workload",
    "decision_stream",
    "diff_streams",
    "reconstruct",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "TraceSchemaError",
    "load_trace",
    "save_trace",
]
