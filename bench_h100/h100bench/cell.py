"""One run of one cell: set-up, the window, the readers, the comparison.

``run_cell`` returns the result line's object; ``run.py`` prints it.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import sys
import tempfile
import time

from . import catalog, check, stack, work
from . import traffic as traffic_gen
from .window import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "ltx_video_gpupoor_tpu")
TRACED_GENERATIONS = 3


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` (compared whole, up to the first
    dot) of JAX, Flax or the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Run:
    """What a metric reader reads: the window's requests, the device
    readings, the traced timeline and the work counted per request."""

    def __init__(self, cell, window, setup_s, peak_bytes, summary, per_request):
        self.cell = cell
        self.window = window
        self.requests = window.ok()
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = summary
        self.work = per_request

    def mean(self, values):
        values = [v for v in values if v is not None]
        return statistics.fmean(values) if values else None


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda", quantization=None,
             after_build=None) -> dict:
    """One run. ``quantization`` overrides the configuration's tier and
    ``after_build(generator)`` may change the program before the window
    (the control and the planted faults)."""
    import torch

    cuda = device == "cuda"
    mix = cell.traffic
    stack.clear_tier_env(cell.config)
    out_dir = tempfile.mkdtemp(prefix="h100bench_outputs_")
    try:
        gen = stack.build_generator(cell.config, seed, device, quantization)
        route = stack.codec_route()
        if route != "opencv jpeg":
            raise RuntimeError(f"the conditioning image takes the {route} "
                               "round trip here; the reference follows the "
                               "OpenCV JPEG one only")
        if after_build is not None:
            after_build(gen)
        service = stack.build_service(gen, out_dir, traffic_gen.bucket(mix))
        _log(f"set-up done at {time.perf_counter() - t_process:.3f} s")
        sync = torch.cuda.synchronize if cuda else None
        profiler = None
        if trace:
            from . import trace as tracing

            fd, trace_path = tempfile.mkstemp(prefix="h100bench_trace_",
                                              suffix=".json")
            os.close(fd)
            profiler = tracing.Profiler(TRACED_GENERATIONS, trace_path)
        window = Window(service, mix, seed, seconds, spans=trace,
                        sync=sync, on_generated=profiler and
                        profiler.on_generated)

        def before_open():
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if profiler is not None:
                profiler.start()

        window.run(before_open, profiler and profiler.watch)
        setup_s = window.t_open - t_process
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        _log(f"window {window.t_close - window.t_open:.3f} s, "
             f"{len(window.requests)} requests, {len(window.ok())} answered")
        summary = None
        if profiler is not None:
            profiler.export()
            summary = tracing.summarize(profiler.out_path, profiler,
                                        window.requests,
                                        catalog.kernel_families(
                                            cell.bench_dir))
            tracing.remove(profiler.out_path)
        from ltx_video_gpupoor_tpu_torch.utils import media

        if window.ok() and media.last_writer != "cv2 mp4v":
            raise RuntimeError(f"the mp4s took the {media.last_writer} writer "
                               "here; the comparison follows OpenCV's mp4v "
                               "only")
        jax_like = forbidden_modules()
        # free the program's state before the reference runs
        del service, gen
        window.service = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ex2, _ = work.ex2_per_s(
            torch.cuda.get_device_properties(0).multi_processor_count
            if cuda else 132)
        per_request = work.request_work(cell.config, mix, ex2)
        run = Run(cell, window, setup_s, peak, summary, per_request)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = cell.reader(m)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        ok = window.ok()
        attempted = len(window.requests)
        failed = attempted - len(ok)
        checks, readings = check.compare(cell.config, seed, ok, mix,
                                         cell.limits, device)
        jax_like = sorted(set(jax_like) | set(forbidden_modules()))
        if jax_like:
            raise ForbiddenModules(jax_like)
        result = {
            "correct": failed == 0 and check.passed(checks, cell.limits),
            "attempted": attempted,
            "failed": failed,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(peak),
            },
        }
        if summary is not None:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        check.report(checks, readings)
        result["readings"] = readings
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package were loaded: "
                         + ", ".join(names))
        self.names = names
