"""The port's request-scoped tracer (``utils/observability.py``): the span
tree of a served request, concurrent requests and the warm-up each in a
record of their own, no synchronize in a span, the ring's bound, the
``LTXV_TPU_TRACE=0`` switch, and the device intervals' mapping through the
anchor, on a fake event clock."""

import base64
import io
import itertools
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
from ltx_video_gpupoor_tpu_torch.serving import server as tserver
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia
from ltx_video_gpupoor_tpu_torch.utils import observability as tobs

torch.set_num_threads(2)

SIZE = 64
GENERATE = ["media_prep", "pass1", "upsample_adain", "pass2", "vae_decode",
            "resize_quant_fetch"]


def _body(**over):
    image = np.random.default_rng(0).integers(0, 255, (SIZE, SIZE, 3))
    buf = io.BytesIO()
    Image.fromarray(image.astype(np.uint8)).save(buf, format="PNG")
    body = {"image": base64.b64encode(buf.getvalue()).decode(),
            "prompt": "a fox", "negative_prompt": "blurry", "height": SIZE,
            "width": SIZE, "num_frames": 9, "frame_rate": 8,
            "num_inference_steps": 2}
    body.update(over)
    return body


def _service(tmp_path, warmup="off"):
    svc = tserver.InferenceService(
        model=tzoo.build_demo_model(0, device="cpu"),
        outputs_dir=str(tmp_path), warmup_spec=warmup)
    if svc._warmup_thread is not None:
        svc._warmup_thread.join(timeout=120)
        assert not svc._warmup_thread.is_alive()
    return svc


def _children(record, span):
    return [s for s in record["spans"] if s["parent"] == span["id"]]


def _names(record, span):
    return [s["name"] for s in _children(record, span)]


def _only(record, name):
    found = [s for s in record["spans"] if s["name"] == name]
    assert len(found) == 1, (name, [s["name"] for s in record["spans"]])
    return found[0]


def _check_tree(record):
    """Ids are indices, every parent is an earlier span of the record that
    encloses it, and one thread recorded them all."""
    spans = record["spans"]
    assert [s["id"] for s in spans] == list(range(len(spans)))
    assert spans[0]["parent"] is None and spans[0]["name"] == record["kind"]
    for s in spans[1:]:
        p = spans[s["parent"]]
        assert p["id"] < s["id"]
        assert p["start_s"] <= s["start_s"] <= s["end_s"] <= p["end_s"]
        assert s["thread"] == record["thread"]
        assert 0 <= s["cpu_s"]


def test_span_tree_of_a_demo_request(tmp_path):
    tobs.clear()
    svc = _service(tmp_path)
    status, _ = svc.run(_body(creation_id="fox-1"), "http://x/")
    assert status == 200
    [rec] = tobs.records()
    assert rec["kind"] == "request" and rec["creation_id"] == "fox-1"
    assert len(rec["id"]) == 16 and rec["error"] is None
    _check_tree(rec)
    root = rec["spans"][0]
    assert _names(rec, root) == ["read_image", "encode_prompt", "lock_wait",
                                 "generate", "save_video"]
    gen = _only(rec, "generate")
    assert _names(rec, gen) == GENERATE
    for name in ("pass1", "pass2"):
        p = [s for s in _children(rec, gen) if s["name"] == name][0]
        assert _names(rec, p) == ["cond_encode", "denoise"]
        denoise = _children(rec, p)[1]
        steps = _children(rec, denoise)
        assert [s["name"] for s in steps] == ["step"] * len(steps)
        assert [s["index"] for s in steps] == list(range(len(steps)))
        assert len(steps) == (7 if name == "pass1" else 3)
    # on the CPU no span has a device interval, and no anchor was taken
    assert all(s["device_s"] is None for s in rec["spans"])
    assert rec["anchor_sync_s"] is None
    seconds = tobs.stage_seconds(rec)
    assert seconds["generate/pass1/denoise"] > 0
    assert seconds["save_video"] > 0


def test_concurrent_requests_keep_their_own_records(tmp_path, monkeypatch):
    tobs.clear()
    svc = _service(tmp_path, warmup="64x64x9")
    gen = svc.model.generator
    real = gen.generate

    def slow(*a, **k):
        time.sleep(0.3)           # the other request waits on the lock
        return real(*a, **k)

    monkeypatch.setattr(gen, "generate", slow)
    answers = {}

    def client(c):
        answers[c] = svc.run(_body(creation_id=f"c{c}"), "http://x/")

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [answers[c][0] for c in range(2)] == [200, 200]
    recs = tobs.records()
    assert [r["kind"] for r in recs] == ["warmup", "request", "request"]
    warm, *served = recs
    assert warm["bucket"] == [64, 64, 9] and warm["thread"] == "ltxv-warmup"
    assert _names(warm, warm["spans"][0]) == ["lock_wait", "generate"]
    assert len({r["id"] for r in recs}) == 3
    assert {r["creation_id"] for r in served} == {"c0", "c1"}
    assert {r["thread"] for r in served} == {"client-0", "client-1"}
    for rec in recs:
        _check_tree(rec)
    for rec in served:
        for name in ("lock_wait", "generate", "save_video"):
            _only(rec, name)
        assert rec["thread"] == f"client-{rec['creation_id'][1]}"
    # one generation at a time: the later request waited for the earlier
    # one's generation
    first, second = sorted(served, key=lambda r: _only(r, "generate")[
        "start_s"])
    wait = _only(second, "lock_wait")
    assert wait["end_s"] - wait["start_s"] > 0.1
    assert _only(first, "generate")["end_s"] <= \
        _only(second, "generate")["start_s"]


def test_tracer_keeps_threads_apart_under_stress():
    """More threads than cores open requests and nested spans with a short
    switch interval; no span lands in another thread's record."""
    tobs.clear()
    n_threads, per_thread = 12, 4

    def work(c):
        for i in range(per_thread):
            with tobs.request("request", creation_id=f"{c}.{i}"):
                for j in range(3):
                    with tobs.stage("outer", index=j):
                        with tobs.stage("inner"):
                            pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(c,), name=f"t{c}")
                   for c in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    recs = tobs.records()
    assert len(recs) == n_threads * per_thread
    for rec in recs:
        _check_tree(rec)
        c = rec["creation_id"].split(".")[0]
        assert rec["thread"] == f"t{c}"
        outer = _children(rec, rec["spans"][0])
        assert [s["index"] for s in outer] == [0, 1, 2]
        assert all(_names(rec, s) == ["inner"] for s in outer)


class _FakeEvent:
    def __init__(self, clock, t):
        self.clock, self.t, self.ready = clock, t, clock.ready

    def query(self):
        return self.ready or self.clock.drained

    def synchronize(self):
        self.clock.event_syncs += 1
        self.clock.drained = True

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return (other.t - self.t) * 1e3


class _FakeClock:
    """A card whose clock runs ``OFFSET`` seconds from the host's and
    trails it by ``lag`` seconds: an event recorded at host time ``t``
    runs at device time ``t + OFFSET + lag``."""

    OFFSET = 500.0

    def __init__(self, host):
        self.host = host
        self.lag = 0.0
        self.syncs = self.event_syncs = 0
        self.ready, self.drained = True, False

    def sync(self):
        self.syncs += 1

    def event(self):
        return _FakeEvent(self, self.host() + self.OFFSET + self.lag)


def test_anchor_arithmetic_on_a_fake_event_clock(monkeypatch):
    tobs.clear()
    now = [10.0]
    clock = _FakeClock(lambda: now[0])
    monkeypatch.setattr(tobs, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0], thread_time=time.thread_time))
    monkeypatch.setattr(tobs, "_device_clock",
                        lambda dev: clock if dev == "card" else None)
    with tobs.request("request"):
        with tobs.stage("before"):
            now[0] = 11.0
        with tobs.stage("generate", anchor="card"):
            now[0] = 12.0
            with tobs.stage("step", index=0):
                now[0] = 13.0
                clock.lag = 0.25            # the card 250 ms behind
            now[0] = 14.0
            clock.ready = False             # the last events still pending
            with tobs.stage("fetch"):
                clock.lag = 0.0             # the fetch drained the card
                now[0] = 15.0
        with tobs.stage("save_video"):
            now[0] = 16.0
    [rec] = tobs.records()
    spans = {s["name"]: s for s in rec["spans"]}
    assert clock.syncs == 1 and rec["anchor_sync_s"] == 0.0
    # host 11.0 anchors device 511.0: each event's device time minus
    # 500 s on the host clock
    assert spans["generate"]["device_s"] == [11.0, 15.0]
    assert spans["step"]["device_s"] == [12.0, 13.25]
    assert spans["step"]["end_s"] == 13.0
    assert spans["fetch"]["device_s"] == [14.25, 15.0]
    assert clock.event_syncs == 1           # not ready: waited at the read
    assert spans["before"]["device_s"] is None
    assert spans["save_video"]["device_s"] is None
    assert spans["request"]["device_s"] is None


def test_no_span_synchronizes(tmp_path, monkeypatch):
    """Every span of a served request on a (fake) card gets a device
    interval inside its host interval, and the request's one synchronize
    is the anchor's. The host clock ticks once a reading, so the nesting
    is exact whatever the machine's load."""
    tobs.clear()
    svc = _service(tmp_path)
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    ticks = itertools.count()

    def now():
        return 1024.0 + next(ticks) * 2.0 ** -20

    monkeypatch.setattr(tobs, "time", types.SimpleNamespace(
        perf_counter=now, thread_time=time.thread_time))
    clocks = []

    def device_clock(dev):
        clocks.append(_FakeClock(now))
        return clocks[-1]

    monkeypatch.setattr(tobs, "_device_clock", device_clock)
    for _ in range(2):
        assert svc.run(_body(), "http://x/")[0] == 200
    assert calls == []
    assert [c.syncs for c in clocks] == [1, 1]      # one anchor a request
    for rec in tobs.records():
        gen = _only(rec, "generate")
        inside = [s for s in rec["spans"] if gen["start_s"] <= s["start_s"]
                  and s["end_s"] <= gen["end_s"]]
        assert len(inside) > 20
        for s in inside:
            a, b = s["device_s"]
            # 1e-9: the rounding of the event's milliseconds, a thousandth
            # of a tick
            assert s["start_s"] - 1e-9 <= a <= b <= s["end_s"] + 1e-9
        assert all(s["device_s"] is None for s in rec["spans"]
                   if s not in inside)


def test_ring_keeps_the_last_requests():
    tobs.clear()
    ids = []
    for i in range(tobs.RING_SIZE + 5):
        with tobs.request("request", creation_id=i) as req:
            ids.append(req.id)
    recs = tobs.records()
    assert tobs.RING_SIZE >= 64 and len(recs) == tobs.RING_SIZE
    assert [r["id"] for r in recs] == ids[5:]
    assert [r["creation_id"] for r in recs] == list(range(5, len(ids)))


def test_trace_switch_records_nothing_and_changes_no_output(tmp_path,
                                                            monkeypatch):
    tobs.clear()
    svc = _service(tmp_path)
    frames = []
    real = tmedia.save_video
    monkeypatch.setattr(tmedia, "save_video", lambda f, path, **k: (
        frames.append([np.array(p) for p in (
            f if isinstance(f, tuple) else (f,))]), real(f, path, **k))[1])
    assert svc.run(_body(), "http://x/")[0] == 200
    assert len(tobs.records()) == 1
    monkeypatch.setenv("LTXV_TPU_TRACE", "0")
    assert not tobs.enabled()
    assert svc.run(_body(), "http://x/")[0] == 200
    with tobs.request("request"):
        assert tobs.stage("x") is tobs.stage("y")    # the shared no-op
    assert len(tobs.records()) == 1
    assert len(frames) == 2 and frames[0][0].size > 0
    assert all(np.array_equal(a, b) for a, b in zip(*frames))


@pytest.mark.parametrize("kind", ["request", "warmup"])
def test_a_failed_request_is_recorded_with_its_error(kind):
    tobs.clear()
    with pytest.raises(ValueError):
        with tobs.request(kind):
            with tobs.stage("generate"):
                raise ValueError("bad")
    [rec] = tobs.records()
    assert rec["kind"] == kind and rec["error"] == "ValueError: bad"
    assert [s["name"] for s in rec["spans"]] == [kind, "generate"]
    assert all(s["end_s"] is not None for s in rec["spans"])
    with tobs.stage("outside"):              # no request open: a no-op
        pass
    assert len(tobs.records()) == 1
