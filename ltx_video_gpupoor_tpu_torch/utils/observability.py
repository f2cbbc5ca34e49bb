"""Profiling and metrics hooks.

Port of ``ltx_video_gpupoor_tpu/utils/observability.py`` (its
``jax.profiler`` trace context has no counterpart here: ``chip_smoke.py
--profile`` traces requests with ``torch.profiler``):

- ``StageTimer``: per-stage wall timers with a one-line report (the
  text-encode / denoise / vae-decode split of a request);
- ``collect_stages`` / ``stage``: ambient stage marks in the pipelines,
  no-ops unless a caller collects them. A stage that did device work ends
  with ``torch.cuda.synchronize()`` so its time is its own;
- ``Metrics``: process-wide counters/gauges with a JSON snapshot, served
  by the server's ``GET /metrics``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Iterator


# ---------------------------------------------------------------------------
# Ambient stage collection
#
# Pipelines mark their phases with ``stage("denoise")``; the marks are
# no-ops unless a caller wraps the request in ``collect_stages(timer)``
# (the serving stage-breakdown tool does). Nested stages record
# slash-joined names ("pass1/denoise").
# ---------------------------------------------------------------------------

_collect_lock = threading.Lock()
_active_timer: "StageTimer | None" = None
_collector_thread: int | None = None
_prefix: list[str] = []


@contextlib.contextmanager
def collect_stages(timer: "StageTimer") -> Iterator[None]:
    global _active_timer, _collector_thread
    with _collect_lock:  # one collector at a time
        _active_timer = timer
        _collector_thread = threading.get_ident()
        _prefix.clear()
        try:
            yield
        finally:
            _active_timer = None
            _collector_thread = None


@contextlib.contextmanager
def stage(name: str, sync=None) -> Iterator[None]:
    """Time a pipeline phase when a collector is active (no-op otherwise).

    Marks from threads OTHER than the one that entered ``collect_stages``
    are no-ops: the server's background warmup thread also calls
    ``generate()``, and its marks interleaving pops/pushes into the
    collecting request's ``_prefix`` stack would corrupt stage names.

    ``sync``: optional zero-arg callable returning a tensor; called on
    exit, and if the tensor lies on a CUDA device that device is
    synchronized, so the stage's asynchronous launches are attributed to
    it.
    """
    if _active_timer is None or threading.get_ident() != _collector_thread:
        yield
        return
    _prefix.append(name)
    full = "/".join(_prefix)
    t0 = time.perf_counter()
    body_ok = False
    try:
        yield
        body_ok = True
    finally:
        try:
            # sync only when the body completed: the callable typically
            # closes over variables assigned INSIDE the block, and running
            # it after an exception would raise NameError over the real
            # error
            if body_ok and sync is not None:
                arr = sync()
                if getattr(arr, "is_cuda", False):
                    import torch

                    torch.cuda.synchronize(arr.device)
        finally:
            # the pop + record must survive a failing sync, or the global
            # prefix stack stays corrupted for every later stage
            dt = time.perf_counter() - t0
            _prefix.pop()
            tm = _active_timer
            if tm is not None:
                # rows are inclusive; nested names ("pass1/denoise") let
                # the reader/tooling attribute parent time to children
                if full not in tm.stages:
                    tm._order.append(full)
                tm.stages[full] = tm.stages.get(full, 0.0) + dt


class StageTimer:
    """Wall-clock stage timing; blocks on device results per stage so the
    numbers mean what they say."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.stages:
                self._order.append(name)
            self.stages[name] = self.stages.get(name, 0.0) + dt

    def report(self) -> str:
        total = sum(self.stages.values())
        parts = [
            f"{name}={self.stages[name]:.3f}s" for name in self._order
        ]
        return f"total={total:.3f}s " + " ".join(parts)


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
