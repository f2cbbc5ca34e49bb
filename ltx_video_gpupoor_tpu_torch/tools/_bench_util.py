"""Timing helper of the micro-benchmark tools: CUDA events around each
call, the median of a few repeats after a warm-up. PyTorch returns before
the device finishes, so the events, not a host clock, take the time."""

from __future__ import annotations


def cuda_time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]
