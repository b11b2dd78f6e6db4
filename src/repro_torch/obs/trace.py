"""Span tracing: timed host spans with optional device fencing and
Chrome-trace-event export (counterpart of ``repro/obs/trace.py``).

A :class:`Tracer` collects ``"X"`` (complete) events from ``with
tracer.span("comm/issue")`` blocks.  Spans measure *host* wall-clock by
default: with CUDA's asynchronous launches that is launch time, not
device time.  A span's handle takes ``fence(value)``: at span exit the
tracer records a CUDA event on the current stream and waits on it when
``value`` holds a CUDA tensor, either always (``mode="always"``) or only
when the tracer was built with ``fence=True`` (the ``--trace-fence``
flag; ``mode="auto"``, the default).  The span then ends when the device
has finished the work queued before it.  Unfenced spans cost no
synchronization; fenced ones serialize the pipeline they measure.

:meth:`Tracer.to_chrome` emits the Chrome trace-event JSON format
(``{"traceEvents": [{"ph": "X", "ts": µs, "dur": µs, ...}]}``), which
loads in Perfetto / ``chrome://tracing``; nesting is time containment
per (pid, tid) track.

:func:`fenced_time` is the one timing loop the telemetry layer shares
(the occupancy calibration): CUDA events on the card, ``perf_counter``
on the CPU.  :func:`profiler_trace` wraps ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.tree import tree_leaves

MAX_EVENTS = 1 << 16   # ring-bounded: long runs keep the newest spans


def _cuda_devices(value: Any) -> List[torch.device]:
    """The CUDA devices the tensors of ``value`` (a tree) sit on."""
    devs = []
    for lf in tree_leaves(value):
        if torch.is_tensor(lf) and lf.device.type == "cuda" \
                and lf.device not in devs:
            devs.append(lf.device)
    return devs


def wait_for(value: Any) -> None:
    """Wait until the device has finished the work queued (on each of
    ``value``'s devices' current streams) before this call: one CUDA
    event each, recorded and waited on.  A CPU value needs no wait."""
    for dev in _cuda_devices(value):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _SpanHandle:
    """Yielded by :meth:`Tracer.span`; lets the block attach a value to
    fence on and extra args recorded into the event."""

    __slots__ = ("value", "mode", "args")

    def __init__(self, args: Dict[str, Any]):
        self.value = None
        self.mode = "auto"
        self.args = args

    def fence(self, value: Any, mode: str = "auto") -> Any:
        """Register ``value`` to wait for at span exit.  ``mode``:
        "auto" fences only when the tracer has fencing on; "always"
        fences unconditionally; "never" drops a registered value.
        Returns ``value``."""
        self.value = value if mode != "never" else None
        self.mode = mode
        return value


class Tracer:
    """Collects timed span events; thread-safe; export via
    :meth:`to_chrome` / :meth:`save`."""

    def __init__(self, fence: bool = False, max_events: int = MAX_EVENTS):
        self.fence = fence
        self.events: deque = deque(maxlen=max_events)
        self._origin = time.perf_counter()
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[_SpanHandle]:
        """Time a block as one complete ("X") event; ``args`` become the
        event's ``args`` payload."""
        handle = _SpanHandle(dict(args))
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if handle.value is not None and (
                    handle.mode == "always" or self.fence):
                wait_for(handle.value)
            t1 = time.perf_counter()
            self.events.append({
                "name": name,
                "t0": t0 - self._origin,
                "dur": t1 - t0,
                "tid": self._tid(),
                "args": handle.args,
            })

    def add_event(self, name: str, t0: float, dur: float,
                  **args) -> None:
        """Record an externally timed span (``t0`` in perf_counter
        seconds, ``dur`` in seconds)."""
        self.events.append({"name": name, "t0": t0 - self._origin,
                            "dur": dur, "tid": self._tid(),
                            "args": dict(args)})

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto / about:tracing loadable)."""
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": e["name"], "ph": "X", "pid": 0, "tid": e["tid"],
                 "ts": round(e["t0"] * 1e6, 3),
                 "dur": round(e["dur"] * 1e6, 3),
                 "cat": e["name"].split("/", 1)[0],
                 "args": e["args"]}
                for e in self.events],
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------------
# The shared fenced timer
# ---------------------------------------------------------------------------
def fenced_time(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                name: Optional[str] = None,
                tracer: Optional[Tracer] = None, **kwargs) -> float:
    """Median **microseconds** per call of ``fn(*args, **kwargs)``.  When
    the arguments or a warm-up call's result hold CUDA tensors, each call
    is timed by CUDA events recorded around it on the current stream
    (the end event waited on): device time of the work the call queued;
    otherwise by ``perf_counter``.  No call's result outlives the call.
    With ``tracer`` (and ``name``) every timed call is also recorded as a
    span."""
    devs = _cuda_devices((list(args), kwargs))
    for _ in range(max(warmup, 0)):
        # no result is kept: a call's output may be as large as its inputs
        devs = devs or _cuda_devices(fn(*args, **kwargs))
    times: List[float] = []
    for i in range(max(iters, 1)):
        t0 = time.perf_counter()
        if devs:
            stream = torch.cuda.current_stream(devs[0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args, **kwargs)
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            fn(*args, **kwargs)
            dt = time.perf_counter() - t0
        times.append(dt)
        if tracer is not None and name is not None:
            tracer.add_event(name, t0, dt, iter=i)
    times.sort()
    return times[len(times) // 2] * 1e6


@contextlib.contextmanager
def profiler_trace(logdir: str) -> Iterator[None]:
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present), its Chrome trace written to ``<logdir>/profile.json``
    (the reference's ``jax_profiler_trace``).  Degrades to a warning and
    no profile when the profiler cannot start."""
    import os
    import warnings

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except RuntimeError as e:    # a second concurrent profiler, no CUPTI
        warnings.warn(f"obs.profiler_trace: profiler unavailable ({e}); "
                      f"continuing without a profile")
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "profile.json"))
