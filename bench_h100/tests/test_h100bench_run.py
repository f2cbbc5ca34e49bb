"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped): the result line, the no-JAX check, and ``correct`` against the
lower-precision control and planted faults."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from h100bench import catalog
from h100bench import cell as cell_run

import control

SEEDS = (7, 2 ** 31 + 5)


def _cell(tiny_bench, workload):
    return catalog.Cell(catalog.load_spec(str(tiny_bench)), workload,
                        str(tiny_bench), str(tiny_bench / "bench_h100"))


@pytest.mark.parametrize("workload", ["t13", "t2"])
def test_a_sound_run_is_correct(tiny_bench, opencv_codec_route, workload):
    cell = _cell(tiny_bench, workload)
    r = cell_run.run_cell(cell, SEEDS[1], 0.5, False,
                          t_process=time.perf_counter(), device="cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "readings", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"video_s", "setup_s"}   # no card: no peak
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    json.loads(json.dumps(r))
    assert cell_run.forbidden_modules() == []


@pytest.mark.parametrize("kind", ["control", "frozen_step", "half_batch",
                                  "altered_frames", "swapped_channels",
                                  "reversed_frames"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_are_not_correct(tiny_bench, opencv_codec_route,
                                            monkeypatch, kind, seed):
    from ltx_video_gpupoor_tpu_torch.schedulers import rf
    from ltx_video_gpupoor_tpu_torch.utils import media

    monkeypatch.setattr(rf, "step", rf.step)      # restored afterwards
    monkeypatch.setattr(media, "save_video", media.save_video)
    r = control.readings(_cell(tiny_bench, "t13"), seed, 0.3, kind,
                         device="cpu")
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "ltx_video_gpupoor_tpu_torch_x",
                        object())
    assert cell_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "ltx_video_gpupoor_tpu.ops", object())
    assert cell_run.forbidden_modules() == ["jax", "ltx_video_gpupoor_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    ref = os.path.join(catalog.BENCH_DIR, "h100ref")
    allowed_local = {"h100bench.weights", "h100bench"}
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            for name in _imports(os.path.join(ref, fn)):
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax",
                                   "ltx_video_gpupoor_tpu",
                                   "ltx_video_gpupoor_tpu_torch"), (fn, name)
                if top == "h100bench":
                    assert name in allowed_local, (fn, name)
    # and the weights module it shares with the harness imports torch only
    names = set(_imports(os.path.join(catalog.BENCH_DIR, "h100bench",
                                      "weights.py")))
    assert {n.split(".")[0] for n in names} <= {"__future__", "hashlib",
                                                 "math", "torch"}


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(catalog.BENCH_DIR, "run.py"),
         "--workload", "ltx2b-i2v-704x480-c2", "--seed", str(2 ** 31 + 9),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        cwd=catalog.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, os.path.join(catalog.BENCH_DIR, "run.py"),
         "--workload", "ltx2b-i2v-704x480-c2", "--seed", str(2 ** 31 + 9),
         "--seconds", "3", "--trace", "1"], capture_output=True, text=True,
        cwd=catalog.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert list(r)[-1] == "checks"
