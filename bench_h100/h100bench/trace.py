"""The traced run's device timeline.

``torch.profiler`` with CUDA activity records every kernel, copy and set
the card runs, from whichever thread launched it, over whole generations:
from the window's first request to the end of the ``generations``-th
``generate`` (which then waits, holding the generation lock, until the
profiler has stopped, so that no later generation is cut). A marker kernel
launched just after the profiler starts, between two host clock readings,
ties the trace's clock to the host's, so that each idle gap on the device
is named by what the host spans (stage marks, the mp4 write) say the host
was doing then.

``summarize`` is a frozen copy of ``chip_smoke.py``'s ``summarize_trace``
arithmetic (busy time as the union of device intervals), with kernels
grouped into the families of ``kernels/<family>/*.txt``.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import catalog

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profiler:
    def __init__(self, generations: int, out_path: str):
        self.generations = generations
        self.out_path = out_path
        self.done = 0
        self.want_stop = threading.Event()
        self.stopped = threading.Event()
        self.prof = None
        self.marker = None      # (host seconds before, after the marker)
        self.t_start = self.t_stop = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.full((7,), 0.25, device="cuda").fill_(0.5)
        torch.cuda.synchronize()
        self.marker = (t0, time.perf_counter())
        self.t_start = time.perf_counter()

    def on_generated(self, req):
        """Called after each ``generate``, under the generation lock: the
        last traced one waits there until the profiler has stopped."""
        if self.prof is None or self.stopped.is_set():
            return
        self.done += 1
        if self.done >= self.generations:
            self.want_stop.set()
            self.stopped.wait()

    def watch(self, threads):
        """The main thread, while the window is open: stop the profiler
        when the last traced generation asks, or when the clients end."""
        while not self.want_stop.wait(0.05):
            if not any(t.is_alive() for t in threads):
                break
        self.stop()

    def stop(self):
        import torch

        if self.stopped.is_set():
            return
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self.stopped.set()

    def export(self):
        self.prof.export_chrome_trace(self.out_path)
        return self.out_path


def _merge(spans):
    spans = sorted(spans)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    arguments, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head[:120]


def summarize(path: str, profiler: Profiler, requests, families: dict):
    """Busy seconds, window seconds, device seconds by family, the device
    operations that took most time (by name) and the idle seconds by what
    the host was doing in each gap (summed over the gaps of one activity),
    over the traced window (host seconds ``t_start`` .. ``t_stop``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    dev.sort(key=lambda e: e["ts"])
    # the marker is the first device event; its midpoint is the marker's
    # host midpoint (microseconds in the trace, seconds on the host)
    m = dev[0]
    host_mid = sum(profiler.marker) / 2
    offset = (m["ts"] + m["dur"] / 2) / 1e6 - host_mid

    def host(ts_us):
        return ts_us / 1e6 - offset

    lo, hi = profiler.t_start, profiler.t_stop
    spans, by_name, by_family = [], {}, {}
    for e in dev[1:]:
        s, t = host(e["ts"]), host(e["ts"] + e["dur"])
        if t <= lo or s >= hi:
            continue
        s, t = max(s, lo), min(t, hi)
        spans.append((s, t))
        name = _short(e["name"])
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if e["cat"] == "kernel":
            fam = catalog.family_of(e["name"], families)
            if fam is not None:
                by_family[fam] = by_family.get(fam, 0.0) + (t - s)
    merged = _merge(spans)
    busy = sum(e - s for s, e in merged)
    window = hi - lo
    gaps = []
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = {}
    for a, b in gaps:
        label = host_activity((a + b) / 2, requests)
        idle[label] = idle.get(label, 0.0) + (b - a)
    idle = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window, "families": by_family,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": idle[:10],
            "generations": profiler.done}


STAGE_ORDER = ("denoise", "pass1", "upsample", "pass2", "decode",
               "postprocess")


def host_activity(t: float, requests) -> str:
    """What the host was doing at host time ``t``: the stage of the
    generation in flight (its last mark before ``t``), else the other
    spans that cover ``t``."""
    for r in requests:
        if r.gen_span and r.gen_span[0] <= t <= r.gen_span[1]:
            stage = "media prep and conditioning"
            for name in STAGE_ORDER:
                if name in r.marks and r.marks[name] <= t:
                    stage = name
            if stage == "postprocess":
                stage = "resize, quantize and fetch of the frames"
            return f"generate: {stage}"
    doing = []
    for r in requests:
        if r.save_span and r.save_span[0] <= t <= r.save_span[1]:
            doing.append("mp4 write")
        elif r.sent <= t <= (r.gen_span[0] if r.gen_span else r.done):
            doing.append("request decode, prompt hash, lock wait")
    return "between generations: " + (", ".join(sorted(set(doing)))
                                      or "no request in flight")


def remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
