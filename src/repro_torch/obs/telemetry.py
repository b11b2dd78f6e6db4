"""Telemetry hub: typed records fanned out to pluggable sinks
(counterpart of ``repro/obs/telemetry.py``; the same record schema).

One :class:`Telemetry` object is the process's metric bus.  Producers —
the Trainer loop, ``simulate``, the mixing-round meters, the serving
engine — call ``tel.emit(<type>, **fields)``; every record is stamped
with the schema version and a wall-clock timestamp and forwarded to each
sink.  Record types and their required fields::

    step       {step, phase}    one training-step log point (loss, lr,
                                consensus, grad_norm, mass, ... ride as
                                free-form numeric fields)
    comm_round {phase, role}    one communication round's byte accounting
                                (obs.meters); role is "round" | "issue" |
                                "apply" | "flush" | "occupancy"
    flush      {step, phase}    an overlap pipeline flush at a period
                                boundary
    fault      {step, kind}     a FaultSchedule event (kind "drop" /
                                "rejoin", nodes=[...])
    ckpt       {step}           a checkpoint write
    serve_req  {uid, latency_s} one retired serving request

Sinks: :class:`JsonlSink` (one JSON object per line), :class:`RingSink`
(a bounded in-memory deque — ``Trainer.history`` is a view over it) and
:class:`PrettySink` (the Trainer's step line on stdout).

Host reads: the hub never reads a device value by itself.  Producers
hold device tensors and bring them to the host through
:meth:`Telemetry.fetch` — one explicit, counted copy per log boundary
(``tel.host_fetches`` counts them).

The ambient hub (:func:`set_telemetry` / :func:`get_telemetry` /
:func:`telemetry_scope`) is how the mixing-round meters find the active
hub without threading it through every call; with none installed they
do nothing.
"""
from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.obs.trace import Tracer
from repro_torch.tree import tree_flatten, tree_unflatten

SCHEMA_VERSION = 1

# record type -> required field names (extra numeric/str fields are free)
RECORD_TYPES: Dict[str, tuple] = {
    "step": ("step", "phase"),
    "comm_round": ("phase", "role"),
    "flush": ("step", "phase"),
    "fault": ("step", "kind"),
    "ckpt": ("step",),
    "serve_req": ("uid", "latency_s"),
}


def _jsonify(v: Any) -> Any:
    """JSON-safe coercion (numpy values and 0-d tensors -> Python)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item) and getattr(v, "ndim", None) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        return tolist()
    return repr(v)


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------
class Sink:
    def emit(self, rec: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """One JSON object per line; the format ``benchmarks/report.py``'s
    ``telemetry_table`` renders."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(_jsonify(rec)) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class RingSink(Sink):
    """Bounded in-memory record buffer (``Trainer.history`` reads it)."""

    def __init__(self, capacity: int = 4096):
        self.ring: deque = deque(maxlen=capacity)

    def emit(self, rec: Dict[str, Any]) -> None:
        self.ring.append(rec)

    def records(self, rtype: Optional[str] = None) -> List[Dict[str, Any]]:
        if rtype is None:
            return list(self.ring)
        return [r for r in self.ring if r.get("type") == rtype]


class PrettySink(Sink):
    """Human-readable stdout lines: the Trainer's ``[{algorithm}] step {k}
    loss=... phase=... consensus=...``.  Only ``step`` records print by
    default; pass ``types`` to widen."""

    def __init__(self, stream=None, types: Iterable[str] = ("step",)):
        self.stream = stream if stream is not None else sys.stdout
        self.types = frozenset(types)

    def emit(self, rec: Dict[str, Any]) -> None:
        if rec.get("type") not in self.types:
            return
        if rec["type"] == "step":
            alg = rec.get("algorithm", "train")
            line = f"[{alg:10s}] step {rec['step']:5d}"
            if "loss" in rec:
                line += f" loss={rec['loss']:.4f}"
            line += f" phase={rec.get('phase')}"
            if "consensus" in rec:
                line += f" consensus={rec['consensus']:.3e}"
        elif rec["type"] == "serve_req":
            line = (f"[serve     ] req {rec['uid']} "
                    f"latency={rec['latency_s'] * 1e3:.1f}ms "
                    f"tok/s={rec.get('tokens_per_s', 0.0):.1f}")
        else:
            body = {k: v for k, v in rec.items()
                    if k not in ("type", "ts", "schema")}
            line = f"[{rec['type']:10s}] {_jsonify(body)}"
        print(line, file=self.stream, flush=True)


# dtypes a fetched device tensor comes back in (others, bf16 among them,
# come back as float32: exact)
_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.float16: np.float16, torch.int64: np.int64,
                 torch.int32: np.int32, torch.bool: np.bool_}


def _host(tree: Any) -> Any:
    """``tree`` with every tensor leaf as a numpy array: the device
    tensors in ONE copy (flattened, widened to float64 — exact for the
    float32/int32/bool values of metrics — concatenated per device,
    brought back, split and cast back to each leaf's dtype); CPU tensors
    without a copy; other leaves as they are."""
    leaves, treedef = tree_flatten(tree)
    out = list(leaves)
    by_device: Dict[torch.device, List[int]] = {}
    for i, lf in enumerate(leaves):
        if torch.is_tensor(lf):
            if lf.device.type == "cpu":
                t = lf.detach()
                out[i] = (t if t.dtype in _NUMPY_DTYPES
                          else t.to(torch.float32)).numpy()
            else:
                by_device.setdefault(lf.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([leaves[i].detach().reshape(-1).to(torch.float64)
                          for i in idx]).cpu().numpy()
        pos = 0
        for i in idx:
            t = leaves[i]
            n = t.numel()
            out[i] = flat[pos:pos + n].reshape(tuple(t.shape)).astype(
                _NUMPY_DTYPES.get(t.dtype, np.float32))
            pos += n
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Hub
# ---------------------------------------------------------------------------
class Telemetry:
    """The metric bus: validates and stamps records, fans them out to the
    sinks, owns the span :class:`Tracer`, and counts explicit host
    fetches."""

    def __init__(self, sinks: Iterable[Sink] = (),
                 tags: Optional[Dict[str, Any]] = None,
                 tracer: Optional[Tracer] = None, fence: bool = False):
        self.sinks: List[Sink] = list(sinks)
        self.tags: Dict[str, Any] = dict(tags or {})
        self.tracer = tracer if tracer is not None else Tracer(fence=fence)
        self.host_fetches = 0
        self._lock = threading.Lock()

    # -- records -------------------------------------------------------
    def emit(self, rtype: str, **fields) -> Dict[str, Any]:
        required = RECORD_TYPES.get(rtype)
        if required is None:
            raise ValueError(
                f"Telemetry.emit: unknown record type {rtype!r} "
                f"(expected one of {sorted(RECORD_TYPES)})")
        missing = [f for f in required if f not in fields]
        if missing:
            raise ValueError(f"Telemetry.emit({rtype!r}): missing required "
                             f"fields {missing}")
        rec = {"type": rtype, "schema": SCHEMA_VERSION, "ts": time.time()}
        rec.update(self.tags)
        rec.update(fields)
        with self._lock:
            for sink in self.sinks:
                sink.emit(rec)
        return rec

    # -- spans ---------------------------------------------------------
    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    # -- host transfers ------------------------------------------------
    def fetch(self, tree: Any) -> Any:
        """The one sanctioned device-to-host read: every device tensor of
        ``tree`` in one counted copy (numpy arrays back; non-tensor leaves
        pass through).  Producers batch a log window's device scalars into
        one call here, never a per-step ``float()``."""
        self.host_fetches += 1
        return _host(tree)

    # -- sinks ---------------------------------------------------------
    def ring(self) -> Optional[RingSink]:
        """First RingSink, if any (the Trainer.history backing store)."""
        for s in self.sinks:
            if isinstance(s, RingSink):
                return s
        return None

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# ---------------------------------------------------------------------------
# Ambient hub
# ---------------------------------------------------------------------------
_AMBIENT: List[Optional[Telemetry]] = [None]


def set_telemetry(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install ``tel`` as the ambient hub; returns the previous one."""
    prev = _AMBIENT[0]
    _AMBIENT[0] = tel
    return prev


def get_telemetry() -> Optional[Telemetry]:
    """The ambient hub, or None when telemetry is off (the mixing meters
    then do nothing)."""
    return _AMBIENT[0]


@contextlib.contextmanager
def telemetry_scope(tel: Optional[Telemetry]) -> Iterator[Optional[Telemetry]]:
    """Ambient-hub scope: installs ``tel`` for the block and restores the
    previous hub on exit (nesting-safe)."""
    prev = set_telemetry(tel)
    try:
        yield tel
    finally:
        set_telemetry(prev)

