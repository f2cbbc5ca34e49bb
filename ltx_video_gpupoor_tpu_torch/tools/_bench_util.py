"""Timing helpers of the micro-benchmark tools: CUDA events around each
call, the median of a few repeats after a warm-up. PyTorch returns before
the device finishes, so the events, not a host clock, take the time. One
call of a short kernel also holds the host's launch path; ``graph_ms``
takes the device time alone."""

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


def graph_ms(fn, calls: int = 20) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed between two events (median of 5), so that the
    host's time to launch them is not in it."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_ms(graph.replay) / calls
