"""Request-scoped tracing, and the process's counters and gauges.

Port of ``ltx_video_gpupoor_tpu/utils/observability.py``'s ``Metrics`` (its
``jax.profiler`` trace context has no counterpart here: ``chip_smoke.py
--profile`` traces requests with ``torch.profiler``). In place of JAX's
stage timer the port keeps one tracer of requests:

- ``request(kind)``: the root span of one request (``"request"``, minted
  by ``serving/server.py``) or warm-up generation (``"warmup"``). Its
  spans form one tree; when it ends the tree becomes a record in a ring of
  the last ``RING_SIZE`` requests (``records()``), which ``GET /metrics``
  serves under ``"requests"`` and which outlives the service;
- ``stage(name)``: a span in the current request's tree (a no-op outside
  one). Each span records its name, its parent, the thread, host start
  and end (``time.perf_counter()`` seconds), the thread's CPU seconds over
  it (``time.thread_time()``) and, inside a span opened with ``anchor``,
  its device interval on the same host clock: CUDA events recorded on the
  current stream at its start and end, read after the request's frames
  have reached the host and mapped through the anchor, an event recorded
  just after the anchoring span synchronized the stream (the served path's
  one synchronize: the stream is idle there, since the last generation
  ended in a device-to-host fetch under the same lock). No span
  synchronizes at its end;
- ``locked(lock)``: acquire a lock inside a ``lock_wait`` span;
- ``Metrics``: process-wide counters and gauges.

The current span lives in a ``ContextVar``: every thread starts outside
any request, so concurrent requests and the warm-up thread each build
their own tree. ``LTXV_TPU_TRACE=0`` turns tracing off: no request opens,
and a span costs one ``ContextVar`` lookup.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import defaultdict, deque

RING_SIZE = 64

_current: contextvars.ContextVar = contextvars.ContextVar(
    "ltxv_span", default=None)
_ring: deque = deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Tracing is on unless ``LTXV_TPU_TRACE=0``."""
    return os.environ.get("LTXV_TPU_TRACE", "1") != "0"


class _CudaClock:
    """Timing events on the current stream of one CUDA device."""

    def __init__(self, device):
        import torch

        self.stream = torch.cuda.current_stream(device)

    def sync(self):
        self.stream.synchronize()

    def event(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev


def _device_clock(device):
    """The clock of ``device``'s timing events; None where it is not a
    CUDA device (nothing to time on the card)."""
    if getattr(device, "type", device) != "cuda":
        return None
    return _CudaClock(device)


class _Span:
    __slots__ = ("req", "id", "parent", "name", "attrs", "thread", "t0",
                 "t1", "c0", "c1", "events", "device")

    def __init__(self, req, parent, name, attrs):
        self.req, self.parent, self.name, self.attrs = req, parent, name, \
            attrs
        self.id = len(req.spans)
        self.thread = threading.current_thread().name
        self.t1 = self.c1 = self.events = self.device = None
        req.spans.append(self)
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time()

    def close(self):
        self.t1 = time.perf_counter()
        self.c1 = time.thread_time()

    def as_dict(self) -> dict:
        out = {"name": self.name, "id": self.id,
               "parent": None if self.parent is None else self.parent.id,
               "thread": self.thread, "start_s": self.t0, "end_s": self.t1,
               "cpu_s": None if self.c1 is None else self.c1 - self.c0,
               "device_s": self.device}
        out.update(self.attrs)
        return out


class _Request:
    """One request's tree of spans, its anchor and its device clock."""

    def __init__(self, kind, attrs):
        self.id = uuid.uuid4().hex[:16]
        self.kind = kind
        self.attrs = attrs
        self.spans: list[_Span] = []
        self.clock = None           # set while the anchoring span is open
        self.anchor = None          # (event, host seconds)
        self.anchor_sync_s = None
        self.error = None

    def set_anchor(self, device):
        clock = _device_clock(device)
        if clock is None:
            return
        t = time.perf_counter()
        clock.sync()
        self.anchor_sync_s = time.perf_counter() - t
        t_host = time.perf_counter()
        self.anchor = (clock.event(), t_host)
        self.clock = clock

    def resolve(self):
        """Each span's device interval, from its events through the
        anchor (called once the request's frames are on the host)."""
        if self.anchor is None:
            return
        ev0, t_host = self.anchor
        for span in self.spans:
            if span.events is None:
                continue
            a, b = span.events
            span.events = None
            try:
                if not b.query():
                    # recorded after the frames' fetch: done at once
                    b.synchronize()
                span.device = [t_host + ev0.elapsed_time(a) / 1e3,
                               t_host + ev0.elapsed_time(b) / 1e3]
            except RuntimeError:    # a failed generation's events
                span.device = None
        self.anchor = None

    def record(self) -> dict:
        out = {"id": self.id, "kind": self.kind}
        out.update(self.attrs)
        out.update(thread=self.spans[0].thread,
                   anchor_sync_s=self.anchor_sync_s, error=self.error,
                   spans=[s.as_dict() for s in self.spans])
        return out


class _Stage:
    """The context manager of one span."""

    __slots__ = ("parent", "name", "anchor", "attrs", "span", "token",
                 "anchored")

    def __init__(self, parent, name, anchor, attrs):
        self.parent, self.name, self.anchor, self.attrs = parent, name, \
            anchor, attrs

    def __enter__(self):
        req = self.parent.req
        span = self.span = _Span(req, self.parent, self.name, self.attrs)
        self.anchored = self.anchor is not None and req.clock is None
        if self.anchored:
            req.set_anchor(self.anchor)
        if req.clock is not None:
            span.events = (req.clock.event(), None)
        self.token = _current.set(span)
        return span

    def __exit__(self, *exc):
        _current.reset(self.token)
        span = self.span
        span.close()
        req = span.req
        if span.events is not None:
            span.events = (span.events[0], req.clock.event())
        if self.anchored:
            req.clock = None
        return False


def stage(name: str, anchor=None, **attrs):
    """A span named ``name`` in the current request's tree, with
    ``attrs`` (e.g. a step's ``index``) in its record; a no-op outside a
    request. ``anchor`` (a device): the span synchronizes that device's
    current stream once as it opens and anchors the request's device
    clock there; the spans opened inside it (and it) get device
    intervals."""
    parent = _current.get()
    if parent is None:
        return _NULL
    return _Stage(parent, name, anchor, attrs)


class _Root:
    __slots__ = ("kind", "attrs", "root", "token")

    def __init__(self, kind, attrs):
        self.kind, self.attrs = kind, attrs

    def __enter__(self):
        req = _Request(self.kind, self.attrs)
        self.root = _Span(req, None, self.kind, {})
        self.token = _current.set(self.root)
        return req

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self.token)
        self.root.close()
        req = self.root.req
        if exc_type is not None:
            req.error = f"{exc_type.__name__}: {exc}"
        req.resolve()
        rec = req.record()
        with _ring_lock:
            _ring.append(rec)
        return False


def request(kind: str = "request", **attrs):
    """Open a request's root span (named ``kind``), unless this context is
    inside one already (rank 0 of a serving mesh hands its request to
    ``_serve``, which opens one on the followers) or tracing is off.
    ``attrs`` (e.g. ``creation_id``) go into the record."""
    if _current.get() is not None or not enabled():
        return _NULL
    return _Root(kind, attrs)


@contextlib.contextmanager
def locked(lock):
    """Hold ``lock``; its acquisition is the span ``lock_wait``."""
    with stage("lock_wait"):
        lock.acquire()
    try:
        yield
    finally:
        lock.release()


def records() -> list[dict]:
    """The ring's records, oldest first: ``id``, ``kind``, the request's
    attributes, ``thread``, ``anchor_sync_s`` (seconds the anchor's
    synchronize took), ``error`` and ``spans``, each with ``name``,
    ``id``, ``parent`` (the parent's ``id``; None at the root),
    ``thread``, ``start_s``, ``end_s``, ``cpu_s``, ``device_s``
    (``[start, end]`` on the host clock, or None) and its attributes."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def stage_seconds(record: dict) -> dict:
    """Host seconds by slash-joined span path below the root
    (``"generate/pass1/denoise"``), summed over spans of one path."""
    spans = record["spans"]
    paths, out = {}, {}
    for s in spans:
        if s["parent"] is None:
            continue
        up = paths.get(s["parent"])
        paths[s["id"]] = s["name"] if up is None else f"{up}/{s['name']}"
        out[paths[s["id"]]] = out.get(paths[s["id"]], 0.0) + \
            s["end_s"] - s["start_s"]
    return out


def snapshot() -> dict:
    """What ``GET /metrics`` serves: the counters, the gauges and the
    ring's records under ``"requests"``."""
    return {**Metrics.snapshot(), "requests": records()}


class Metrics:
    """Process-wide counters and gauges (thread-safe)."""

    _lock = threading.Lock()
    _counters: dict[str, float] = defaultdict(float)
    _gauges: dict[str, float] = {}

    @classmethod
    def inc(cls, name: str, value: float = 1.0) -> None:
        with cls._lock:
            cls._counters[name] += value

    @classmethod
    def set(cls, name: str, value: float) -> None:
        with cls._lock:
            cls._gauges[name] = value

    @classmethod
    def snapshot(cls) -> dict:
        with cls._lock:
            return {
                "counters": dict(cls._counters),
                "gauges": dict(cls._gauges),
            }

    @classmethod
    def to_json(cls) -> str:
        return json.dumps(cls.snapshot())

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._counters.clear()
            cls._gauges.clear()
