"""The closed-loop window's arithmetic on a stub service, and the traced
timeline's reduction on a synthetic trace."""

import json
import threading
import time
import types

import numpy as np
import torch

from h100bench import catalog, trace
from h100bench.window import Window

GEN_S, SAVE_S = 0.08, 0.05


class StubGenerator:
    def __init__(self):
        self.calls = 0

    def generate(self, on_stage=None):
        self.calls += 1
        on_stage("denoise", None)
        time.sleep(GEN_S / 2)
        on_stage("decode", torch.zeros(1, 2, 2, 2, 4))
        time.sleep(GEN_S / 2)
        on_stage("postprocess", torch.zeros(1, 9, 8, 8, 3))
        return np.zeros((9, 8, 8, 3), np.uint8)


class StubService:
    """One generation at a time, then the mp4 write outside the lock, as
    ``InferenceService.run`` orders them."""

    def __init__(self):
        self.model = types.SimpleNamespace(generator=StubGenerator())
        self.lock = threading.Lock()

    def run(self, body, url_root):
        from ltx_video_gpupoor_tpu_torch.utils import media

        with self.lock:
            frames = self.model.generator.generate()
        media.save_video(frames, "/nonexistent/video.mp4")
        return 200, [{"video": url_root + "download/video.mp4"}]


def test_window_runs_whole_requests_and_keeps_spans(monkeypatch):
    from ltx_video_gpupoor_tpu_torch.utils import media

    monkeypatch.setattr(media, "save_video",
                        lambda frames, path, **kw: time.sleep(SAVE_S) or path)
    service = StubService()
    mix = {"height": 32, "width": 32, "num_frames": 9, "frame_rate": 30,
           "num_inference_steps": 2, "clients": 2, "prompt_words": [2, 3],
           "negative_words": [1, 2]}
    seconds = 0.6
    w = Window(service, mix, 11, seconds, spans=True)
    reqs = w.run()
    assert reqs and len(w.ok()) == len(reqs)
    assert service.model.generator.calls == len(reqs)
    # no request is sent after the deadline, every one is answered
    assert all(w.t_open <= r.sent < w.t_open + seconds for r in reqs)
    assert w.t_close == max(r.done for r in reqs) >= w.t_open + seconds
    # the two clients alternate on the lock: generations never overlap
    spans = sorted(r.gen_span for r in reqs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert {r.client for r in reqs} == {0, 1}
    # closed loop: each client's next request follows its last answer
    for c in (0, 1):
        mine = [r for r in reqs if r.client == c]
        assert [r.index for r in mine] == list(range(len(mine)))
        assert all(a.done <= b.sent for a, b in zip(mine, mine[1:]))
    # the card's work bounds the rate: one generation at a time
    n = len(reqs)
    assert n <= (w.t_close - w.t_open) / GEN_S + 1
    for r in reqs:
        assert set(r.marks) == {"denoise", "decode", "postprocess"}
        assert r.save_span[1] - r.save_span[0] >= SAVE_S
        assert set(r.stages) == {"latents"}
    # the instance wrapper and the module patch are gone afterwards
    assert "generate" not in vars(service.model.generator)
    assert media.save_video(None, "x") == "x"
    run = types.SimpleNamespace(requests=w.ok(), window=w)
    bench = catalog.BENCH_DIR
    video_s = catalog.load_reader(bench, "video_s")(run)
    assert video_s == (w.t_close - w.t_open) / n
    run.mean = lambda v: sum(v) / len(v)
    gen_s = catalog.load_reader(bench, "generate_s")(run)
    assert GEN_S <= gen_s < GEN_S * 3
    assert catalog.load_reader(bench, "decode_s")(run) >= GEN_S / 2


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_a_synthetic_trace(tmp_path):
    # the marker at trace 1000 us, host 10.0 s; kernels at host 10.1-10.3
    # (attention) and 10.25-10.4 (linear, overlapping), 10.6-10.7 (other)
    events = [_event("void at::native::FillFunctor", 1000, 2)]
    events += [_event("void flash_wgmma_kernel<64>()", 101001, 200000),
               _event("void (anonymous namespace)::int8_gemm_wgmma_kernel"
                      "<1>(CUtensorMap)", 251001, 150000),
               _event("elementwise", 601001, 100000),
               _event("cudaLaunchKernel", 101001, 5, cat="cuda_runtime")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    prof = trace.Profiler(1, str(path))
    prof.marker = (10.0, 10.000002)
    prof.t_start, prof.t_stop, prof.done = 10.0, 11.0, 1
    req = types.SimpleNamespace(
        gen_span=(10.02, 10.9), marks={"denoise": 10.08, "decode": 10.45},
        save_span=None, sent=10.0, done=10.95)
    s = trace.summarize(str(path), prof, [req], catalog.kernel_families())
    # the marker ties trace and host clocks to a microsecond
    assert abs(s["busy_s"] - 0.4) < 1e-5        # 0.1-0.4 and 0.6-0.7
    assert s["window_s"] == 1.0
    assert abs(s["families"]["attention"] - 0.2) < 1e-5
    assert abs(s["families"]["linear"] - 0.15) < 1e-5
    assert s["device_ops"][0][0] == "flash_wgmma_kernel<64>"
    # idle seconds by the host's activity: 10.4-10.6 and 10.7-11.0 in the
    # decode, 10.0-10.1 before the first mark
    assert [[g[0], round(g[1], 4)] for g in s["idle_gaps"]] == [
        ["generate: decode", 0.5],
        ["generate: media prep and conditioning", 0.1]]
