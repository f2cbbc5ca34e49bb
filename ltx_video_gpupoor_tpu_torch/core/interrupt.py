"""Cooperative cancellation for generation loops.

Pinned copy of ``ltx_video_gpupoor_tpu/core/interrupt.py`` (the JAX
package cannot be imported without jax; ``tests/test_torch_serving.py``
pins the two equal). Cancellation is step-granular: the denoise loop is a
host loop here, and it consults the flag between steps
(``pipelines/ltx_pipeline.py::denoise``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class InterruptFlag:
    """Thread-safe cancellation flag (the ``model._interrupt`` analogue)."""

    def __init__(self):
        self._event = threading.Event()

    def interrupt(self) -> None:
        self._event.set()

    def clear(self) -> None:
        self._event.clear()

    @property
    def interrupted(self) -> bool:
        return self._event.is_set()

    def __call__(self) -> bool:
        return self.interrupted


class Interrupted(Exception):
    """Raised by step loops when the flag fires mid-generation."""


def check(flag: Optional[Callable[[], bool]]) -> None:
    if flag is not None and flag():
        raise Interrupted()
