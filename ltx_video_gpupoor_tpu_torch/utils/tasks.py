"""Background task utilities for UI streaming.

A copy of ``ltx_video_gpupoor_tpu/utils/tasks.py`` (no JAX).

Parity target: ``wan/utils/thread_utils.py`` (FramePack
style): a daemon ``Listener`` task thread, ``async_run``, a lock-protected
``FIFOQueue``, and ``AsyncStream`` (input/output queue pair).
"""

from __future__ import annotations

import time
import traceback
from threading import Lock, Thread


class Listener:
    _queue: list = []
    _lock = Lock()
    _thread: Thread | None = None

    @classmethod
    def _run(cls):
        while True:
            task = None
            with cls._lock:
                if cls._queue:
                    task = cls._queue.pop(0)
            if task is None:
                time.sleep(0.001)
                continue
            fn, args, kwargs = task
            try:
                fn(*args, **kwargs)
            except Exception:
                traceback.print_exc()

    @classmethod
    def add_task(cls, fn, *args, **kwargs):
        with cls._lock:
            cls._queue.append((fn, args, kwargs))
        if cls._thread is None:
            cls._thread = Thread(target=cls._run, daemon=True)
            cls._thread.start()


def async_run(fn, *args, **kwargs):
    Listener.add_task(fn, *args, **kwargs)


class FIFOQueue:
    def __init__(self):
        self._queue: list = []
        self._lock = Lock()

    def push(self, cmd, data=None):
        with self._lock:
            self._queue.append((cmd, data))

    def pop(self):
        with self._lock:
            if self._queue:
                return self._queue.pop(0)
            return None, None

    def top(self):
        with self._lock:
            if self._queue:
                return self._queue[0]
            return None, None

    def next(self):
        while True:
            with self._lock:
                if self._queue:
                    return self._queue.pop(0)
            time.sleep(0.001)


class AsyncStream:
    def __init__(self):
        self.input_queue = FIFOQueue()
        self.output_queue = FIFOQueue()
