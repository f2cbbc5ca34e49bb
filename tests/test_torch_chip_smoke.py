"""chip_smoke.py refuses to report a result it cannot have measured: it
exits nonzero and prints no ``"ok"`` line without a CUDA device, and in a
directory that holds the script but not the repository. Its --profile
phase reads device time from a torch.profiler trace, checked here on a
small synthetic one."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fails_alone(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_summarize_trace_counts_overlap_once(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        ev("kernel", "void flash_fwd_kernel<64, false>(...)", 0.0, 1000.0),
        ev("kernel", "void int8_gemm_kernel<1>(...)", 500.0, 1000.0),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 3000.0, 500.0),
        ev("gpu_memcpy", "Memcpy DtoH", 3500.0, 500.0),
        ev("cpu_op", "aten::mm", 0.0, 9000.0),       # host time: not counted
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    s = chip_smoke.summarize_trace(str(path))
    assert s["span_ms"] == 4.0                # 0 .. 4000 us
    assert s["busy_ms"] == 2.5                # 0-1500 and 3000-4000 us
    assert abs(s["idle_share"] - 0.375) < 1e-12
    assert s["groups"] == {"K1 / K6 exact flash attention": (1.0, 1),
                           "K2 / K5 int8 GEMM": (1.0, 1),
                           "cuDNN conv3d (VAE)": (0.5, 1),
                           "PyTorch elementwise and copies": (0.5, 1)}
    # the bounded tier and the prologue's row kernel have groups of their own
    trace["traceEvents"] += [
        ev("kernel", "void (anonymous namespace)::flash_fwd_kernel<128, true>"
           "(...)", 5000.0, 250.0),
        ev("kernel", "norm_mod_quantize_rows_kernel(...)", 6000.0, 125.0)]
    path.write_text(json.dumps(trace))
    groups = chip_smoke.summarize_trace(str(path))["groups"]
    assert groups["K3 bounded-score flash attention"] == (0.25, 1)
    assert groups["K5 prologue row kernel"] == (0.125, 1)
