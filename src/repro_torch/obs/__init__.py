"""Observability layer (counterpart of ``repro/obs``): structured
telemetry records, span tracing with Chrome-trace export, and comm-round
byte meters.

    from repro_torch import obs

    tel = obs.Telemetry(sinks=[obs.JsonlSink("run.jsonl"), obs.RingSink()])
    with obs.telemetry_scope(tel):
        ...                         # mixing rounds self-report comm_round
        tel.emit("step", step=k, phase="gossip", loss=0.7)
        with tel.span("comm/issue") as sp:
            sp.fence(mixing.start_round(...))
    tel.tracer.save("trace.json")   # load in Perfetto
"""
from repro_torch.obs import meters
from repro_torch.obs.telemetry import (RECORD_TYPES, SCHEMA_VERSION,
                                       JsonlSink, PrettySink, RingSink, Sink,
                                       Telemetry, get_telemetry,
                                       set_telemetry, telemetry_scope)
from repro_torch.obs.trace import Tracer, fenced_time, profiler_trace

__all__ = [
    "JsonlSink", "PrettySink", "RingSink", "RECORD_TYPES",
    "SCHEMA_VERSION", "Sink", "Telemetry", "Tracer", "fenced_time",
    "get_telemetry", "meters", "profiler_trace", "set_telemetry",
    "telemetry_scope",
]
