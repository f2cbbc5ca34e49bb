"""The readers of the port's own request records (``lock_wait_s``,
``pass1_s``, ``pass1_lead_ms``, ``pass1_offcpu_pct``) on hand-built ring
records: the warm-up and a request sent before the window are left out,
and a program without the ring gives no value."""

import types

import pytest

from h100bench import catalog, spans
from h100bench.cell import Run

from ltx_video_gpupoor_tpu_torch.utils import observability

T_OPEN = 100.0
READERS = ("lock_wait_s", "pass1_s", "pass1_lead_ms", "pass1_offcpu_pct")


def _span(i, parent, name, start, end, cpu=None, device=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "thread": "client-0",
            "start_s": start, "end_s": end,
            "cpu_s": (end - start) if cpu is None else cpu,
            "device_s": device, **attrs}


def _record(kind, t0, lock_waits, steps, pass2=True):
    """A served request's tree from host second ``t0``: its ``lock_wait``
    spans of the given seconds, then ``generate`` with pass 1 (a
    ``denoise`` span whose ``step`` spans are ``(host end, device end,
    cpu seconds)``, each a second long on the host) and pass 2."""
    out = [_span(0, None, kind, t0, t0 + 60)]
    t = t0
    for w in lock_waits:
        out.append(_span(len(out), 0, "lock_wait", t, t + w))
        t += w
    gen = len(out)
    out.append(_span(gen, 0, "generate", t, t0 + 50, device=[t, t0 + 50]))
    d1 = len(out)
    first = steps[0][0] - 1.0
    out.append(_span(d1, gen, "denoise", first, steps[-1][0],
                     device=[first + 0.001, steps[-1][1]]))
    for i, (end, dev_end, cpu) in enumerate(steps):
        out.append(_span(len(out), d1, "step", end - 1.0, end, cpu=cpu,
                         device=[end - 0.999, dev_end], index=i))
    if pass2:
        d2 = len(out)
        out.append(_span(d2, gen, "denoise", t0 + 40, t0 + 45,
                         device=[t0 + 40, t0 + 45.5]))
        out.append(_span(len(out), d2, "step", t0 + 40, t0 + 45, cpu=0.1,
                         device=[t0 + 40, t0 + 45.5], index=0))
    return {"id": f"{kind}{t0}", "kind": kind, "thread": "client-0",
            "anchor_sync_s": 1e-5, "error": None, "spans": out}


RECORDS = [
    # the warm-up and a request sent before the window: left out
    _record("warmup", 80.0, [0.0], [(85.0, 85.9, 0.0)], pass2=False),
    _record("request", 99.5, [30.0], [(110.0, 111.0, 0.0)]),
    # the window's two requests
    _record("request", 100.0, [0.5, 1.5], [(104.0, 104.002, 0.9),
                                           (105.0, 105.004, 0.8)]),
    _record("request", 120.0, [6.0], [(129.0, 129.010, 0.7),
                                      (130.0, 130.030, 1.0),
                                      (131.0, 131.050, 0.6)]),
]


class _Run:
    window = types.SimpleNamespace(t_open=T_OPEN)
    mean = Run.mean


def _read(name):
    return catalog.load_reader(catalog.BENCH_DIR, name)(_Run())


@pytest.fixture
def ring(monkeypatch):
    monkeypatch.setattr(observability, "records", lambda: list(RECORDS))


def test_the_window_holds_the_requests_sent_in_it(ring):
    got = spans.window_records(_Run())
    assert [r["spans"][0]["start_s"] for r in got] == [100.0, 120.0]
    first, steps = spans.first_pass(got[1])
    assert first["start_s"] == 128.0 and [s["index"] for s in steps] == \
        [0, 1, 2]


def test_lock_wait_s(ring):
    assert _read("lock_wait_s") == pytest.approx((2.0 + 6.0) / 2)


def test_pass1_s(ring):
    # device intervals of the first denoise spans: 103.001 .. 105.004 and
    # 128.001 .. 131.050
    assert _read("pass1_s") == pytest.approx((2.003 + 3.049) / 2)


def test_pass1_lead_ms(ring):
    # the five first-pass steps' leads: 2, 4, 10, 30, 50 ms
    assert _read("pass1_lead_ms") == pytest.approx(10.0)


def test_pass1_offcpu_pct(ring):
    # 4.0 CPU seconds over the five steps' 5.0 host seconds
    assert _read("pass1_offcpu_pct") == pytest.approx(20.0)


@pytest.mark.parametrize("name", READERS)
def test_no_value_without_the_programs_ring(monkeypatch, name):
    monkeypatch.delattr(observability, "records")
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_no_value_without_a_request_in_the_window(monkeypatch, name):
    monkeypatch.setattr(observability, "records", lambda: RECORDS[:2])
    assert _read(name) is None


def test_no_device_reading_off_the_card(monkeypatch):
    """Records of a run on the CPU carry no device intervals: the two
    device readers give no value, the host ones do."""
    cpu = [dict(r, spans=[dict(s, device_s=None) for s in r["spans"]])
           for r in RECORDS]
    monkeypatch.setattr(observability, "records", lambda: cpu)
    assert _read("pass1_s") is None and _read("pass1_lead_ms") is None
    assert _read("lock_wait_s") == pytest.approx(4.0)
    assert _read("pass1_offcpu_pct") == pytest.approx(20.0)
