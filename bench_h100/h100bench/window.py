"""The measured window: closed-loop clients driving ``POST /``.

Each client is a thread that calls ``InferenceService.run(body, url_root)``
(what both HTTP handlers of ``POST /`` call) and sends its next body when
the last one has been answered. The window opens at the first request; once
``seconds`` have passed no client sends again, and the requests in flight
run to their ends, so the window holds whole requests only.

While the window runs, ``generate`` of the service's generator is wrapped
on the instance (the pattern of ``chip_smoke.py``'s served requests): each
request's stage values (``on_stage``: the pass-1 latents, the upsampled
latents, the last pass's latents) are kept, cloned where they are produced,
with the frames ``generate`` returns, for the comparison after the window.
With ``spans`` on, each stage mark first synchronizes the device and
stamps the host clock, and ``utils.media.save_video`` is wrapped to time
the mp4 write; every span is kept per request, by thread.
"""

from __future__ import annotations

import threading
import time

from . import traffic as traffic_gen

KEEP = {"upsample": "pass1", "pass2": "upsampled", "decode": "latents"}


class Request:
    """One request of the window: its client, index, body and what it
    produced and took."""

    def __init__(self, client: int, index: int, body: dict):
        self.client, self.index, self.body = client, index, body
        self.sent = self.done = None
        self.status = None
        self.stages = {}        # name -> tensor (host)
        self.frames = None      # generate's output
        self.marks = {}         # on_stage name -> host seconds (spans on)
        self.gen_span = None    # (start, end) of generate
        self.save_span = None   # (start, end) of save_video
        self.mp4 = None


class Window:
    def __init__(self, service, mix: dict, seed: int, seconds: float, *,
                 spans: bool = False, on_generated=None, sync=None):
        self.service = service
        self.sync = sync or (lambda: None)
        self.mix = mix
        self.seed = seed
        self.seconds = seconds
        self.spans = spans
        self.on_generated = on_generated     # called after each generate
        self.requests: list[Request] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self.t_open = self.t_close = None

    # -- the wrappers -------------------------------------------------------

    def _generate_wrapper(self, real):
        def generate(*a, **k):
            req = self._local.request

            def on_stage(name, value):
                if self.spans:
                    self.sync()
                    req.marks[name] = time.perf_counter()
                if name in KEEP and value is not None:
                    req.stages[KEEP[name]] = value.detach().clone()

            t0 = time.perf_counter()
            out = real(*a, on_stage=on_stage, **k)
            t1 = time.perf_counter()
            req.gen_span = (t0, t1)
            req.frames = out
            req.stages = {n: v.cpu() for n, v in req.stages.items()}
            if self.on_generated is not None:
                self.on_generated(req)
            return out

        return generate

    def _save_wrapper(self, real):
        def save_video(frames, path, *a, **k):
            req = getattr(self._local, "request", None)
            t0 = time.perf_counter()
            out = real(frames, path, *a, **k)
            if req is not None:
                req.save_span = (t0, time.perf_counter())
                req.mp4 = path
            return out

        return save_video

    # -- the clients --------------------------------------------------------

    def _client(self, c: int, ready, start: threading.Event,
                deadline_box: list):
        i = 0
        body = traffic_gen.body(self.mix, self.seed, c, i)
        ready.wait()
        start.wait()
        while time.perf_counter() < deadline_box[0]:
            req = Request(c, i, body)
            self._local.request = req
            req.sent = time.perf_counter()
            req.status, _ = self.service.run(req.body, "http://localhost/")
            req.done = time.perf_counter()
            with self._lock:
                self.requests.append(req)
            i += 1
            body = traffic_gen.body(self.mix, self.seed, c, i)

    def run(self, before_open=None, while_open=None):
        """Open the window, run the clients, return when every request in
        flight has been answered. ``before_open()`` runs just before the
        first request (the traced run starts its profiler there),
        ``while_open(threads)`` on this thread while the clients run."""
        from ltx_video_gpupoor_tpu_torch.utils import media

        gen = self.service.model.generator
        real_save = media.save_video
        gen.generate = self._generate_wrapper(gen.generate)
        media.save_video = self._save_wrapper(real_save)
        start = threading.Event()
        deadline = [float("inf")]
        n = int(self.mix["clients"])
        ready = threading.Barrier(n + 1)
        threads = [threading.Thread(target=self._client,
                                    args=(c, ready, start, deadline),
                                    name=f"client-{c}")
                   for c in range(n)]
        for t in threads:
            t.start()
        try:
            ready.wait()
            if before_open is not None:
                before_open()
            self.t_open = time.perf_counter()
            deadline[0] = self.t_open + self.seconds
            start.set()
            if while_open is not None:
                while_open(threads)
            for t in threads:
                t.join()
        finally:
            ready.abort()
            deadline[0] = 0.0
            start.set()
            for t in threads:
                t.join()
            del gen.generate
            media.save_video = real_save
        self.t_close = max(r.done for r in self.requests)
        self.requests.sort(key=lambda r: r.sent)
        return self.requests

    def ok(self) -> list[Request]:
        return [r for r in self.requests
                if r.status == 200 and r.frames is not None]
