"""chip_smoke.py refuses to report a result it cannot have measured: it
exits nonzero and prints no ``"ok"`` line without a CUDA device, and in a
directory that holds the script but not the repository. Its --profile
phase reads device time from a torch.profiler trace, checked here on a
small synthetic one. ``--kernels-only`` stops after the kernel phases and
prints no result line; the default run drives every path and ends with
it."""

import collections

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
        ev("kernel", "void (anonymous namespace)::flash_wgmma_kernel<64, 0>"
           "(...)", 0.0, 1000.0),
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
    assert s["groups"] == {
        "K1 / K6 exact flash attention": (1.0, 1),
        "K2 / K5 int8 GEMM": (1.0, 1),
        "cuDNN conv3d (VAE)": (0.5, 1),
        "PyTorch elementwise and copies: casts and copies": (0.5, 1)}
    # the bounded tiers (the instances of K1's and K4's kernels whose last
    # template argument is true) and the prologue's row kernel have groups
    # of their own
    trace["traceEvents"] += [
        ev("kernel", "void (anonymous namespace)::flash_wgmma_kernel"
           "<128, 2, false, true>(...)", 5000.0, 250.0),
        ev("kernel", "void (anonymous namespace)::flash_int8_wgmma_kernel"
           "<128, false, 0, true>(...)", 5250.0, 50.0),
        ev("kernel", "norm_mod_quantize_rows_kernel(...)", 6000.0, 125.0)]
    path.write_text(json.dumps(trace))
    groups = chip_smoke.summarize_trace(str(path))["groups"]
    assert groups["K3 bounded-score flash attention"] == (0.25, 1)
    assert groups["K3q int8-QK bounded-score flash attention"] == (0.05, 1)
    assert groups["K5 prologue row kernel"] == (0.125, 1)
    assert groups["K1 / K6 exact flash attention"] == (1.0, 1)
    # PyTorch's own kernels go by the innermost record_function scope
    # around their launch (matched through the correlation id), the
    # redesigned kernels by their names
    def launched(name, ts, dur, corr, host_ts):
        k = ev("kernel", name, ts, dur)
        k["args"] = {"correlation": corr}
        r = ev("cuda_runtime", "cudaLaunchKernel", host_ts, 5.0)
        r["args"] = {"correlation": corr}
        return [k, r]

    scope = ev("user_annotation", "RoPE", 100.0, 50.0)
    inner = ev("user_annotation", "norms", 120.0, 10.0)
    for e in (scope, inner):
        e["tid"] = 7
    trace["traceEvents"] += [scope, inner]
    trace["traceEvents"] += launched("elementwise_kernel<mul>", 7000.0, 100.0,
                                     1, 110.0)
    trace["traceEvents"] += launched("elementwise_kernel<rsqrt>", 7100.0,
                                     50.0, 2, 125.0)
    trace["traceEvents"] += launched("elementwise_kernel<add>", 7200.0, 25.0,
                                     3, 900.0)
    for e in trace["traceEvents"]:
        if e["cat"] == "cuda_runtime":
            e["tid"] = 7
    trace["traceEvents"] += [
        ev("kernel", "void (anonymous namespace)::flash_int8_wgmma_kernel"
           "<128, true, 1, false>(...)", 8000.0, 500.0),
        ev("kernel", "void (anonymous namespace)::int8_gemm_wgmma_kernel<1>"
           "(...)", 9000.0, 250.0)]
    path.write_text(json.dumps(trace))
    groups = chip_smoke.summarize_trace(str(path))["groups"]
    assert groups["PyTorch elementwise and copies: RoPE"] == (0.1, 1)
    assert groups["PyTorch elementwise and copies: norms"] == (0.05, 1)
    assert groups["PyTorch elementwise and copies: other"] == (0.025, 1)
    assert groups["K4 int8 flash attention"] == (0.5, 1)
    assert groups["K2 / K5 int8 GEMM"] == (1.25, 2)


def test_profiled_ops_scope_only_the_ports_own_calls():
    """--profile's op scopes wrap the port's functions, GELU through each
    model module's own copy of torch.nn.functional, so that no other
    caller of torch.nn.functional.gelu lands in the DiT's GELU group;
    everything is restored on exit."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wan_model

    gelu, functional = torch.nn.functional.gelu, transformer3d.F
    rope = transformer3d.apply_rotary_emb
    x = torch.ones(4)
    with chip_smoke._ProfiledOps():
        assert torch.nn.functional.gelu is gelu
        for mod in (transformer3d, wan_model):
            assert mod.F is not functional and mod.F.gelu is not gelu
            assert mod.F.silu is torch.nn.functional.silu
        assert transformer3d.apply_rotary_emb is not rope
        with torch.profiler.profile() as prof:
            transformer3d.F.gelu(x)
            torch.nn.functional.gelu(x)
        names = [e.name for e in prof.events()]
        assert names.count("GELU / GEGLU") == 1
    assert transformer3d.F is functional and wan_model.F is functional
    assert transformer3d.apply_rotary_emb is rope
    assert torch.nn.functional.gelu is gelu


def _stubbed_main(monkeypatch, capsys, argv):
    """``chip_smoke.main`` with every phase replaced by a stub that records
    its name: (exit code, the phases in order, the printed lines)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    ran = []
    ones = collections.defaultdict(lambda: 1)
    timed = collections.defaultdict(lambda: (1.0, 1.0))
    info = collections.defaultdict(lambda: (1.0, "operations", None))
    results = {
        "phase_device": ("a card", 4.18e12),
        "phase_build": 1.0, "phase_k1": 0.0, "phase_k2": 0.0,
        "phase_k4": (0.0, 0.0), "phase_k3": 0.0, "phase_k3q": 0.0,
        "phase_k5": 0.0,
        "phase_k6": 0.0, "phase_k1f": 0.0, "phase_timing": (timed, info),
        "time_k1f": None,
        "phase_k8": (0.0, 1), "phase_k7": (0.0, 1),
        "phase_path": ([ones], object(), object()),
        "phase_teacache": None, "phase_fp32": ones,
        "phase_ltx13b": (collections.defaultdict(lambda: ones), object()),
        "phase_load": ones, "phase_cli": None,
        "phase_wan": ([ones] * len(chip_smoke.WAN_REQUESTS), object(),
                      object()),
    }
    for name, result in results.items():
        def stub(*args, _name=name, _result=result, **kwargs):
            ran.append(_name)
            return _result
        monkeypatch.setattr(chip_smoke, name, stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch, "Generator",
                        lambda device=None: torch._C.Generator("cpu"))
    code = chip_smoke.main(argv)
    return code, ran, capsys.readouterr().out.strip().splitlines()


KERNEL_PHASES = ["phase_device", "phase_build", "phase_k1", "phase_k2",
                 "phase_k4", "phase_k3", "phase_k3q", "phase_k5",
                 "phase_k6", "phase_k1f",
                 "phase_timing", "time_k1f", "phase_k8", "phase_k7"]


def test_kernels_only_stops_before_the_paths(monkeypatch, capsys):
    code, ran, lines = _stubbed_main(monkeypatch, capsys, ["--kernels-only"])
    assert code == 0
    assert ran == KERNEL_PHASES
    assert not any('"ok"' in ln or '"kernels"' in ln for ln in lines)


def test_default_run_drives_every_path_and_ends_with_the_result(
        monkeypatch, capsys):
    code, ran, lines = _stubbed_main(monkeypatch, capsys, [])
    assert code == 0
    assert ran == KERNEL_PHASES + ["phase_path", "phase_teacache",
                                   "phase_fp32", "phase_ltx13b",
                                   "phase_load", "phase_cli", "phase_wan"]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "a card", "count": 1}}
    kernels = json.loads(lines[-2])["kernels"]
    assert len(kernels) == 11
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in kernels)
    by_name = {k["name"].split(" (")[0]: k["source"] for k in kernels}
    assert by_name["flash_attention_hp"].endswith("flash_attention_wgmma.cu")
    bounded = {k["name"].split(" (")[0]: k["source"] for k in kernels
               if "bounded" in k["name"]}
    assert bounded["flash_attention"].endswith("csrc/flash_attention_wgmma.cu")
    assert bounded["flash_attention_int8"].endswith(
        "csrc/flash_attention_int8.cu")
    assert all(os.path.exists(os.path.join(REPO, k["source"]))
               for k in kernels)


def _ptxas_report(k1f_spill=0, serialized=False):
    """A ptxas -v report of one K1f instance and one of K5's row kernel,
    in the form nvcc prints it; ``k1f_spill`` bytes of spill stores and
    loads in the K1f instance."""
    k1f = ("_ZN56_GLOBAL__N__a364beb7_23_flash_attention_fp32_cu_664c2249"
           "23flash_fp32_wgmma_kernelILi64ELi1ELi0EEEvNS_6ParamsE")
    k5 = ("_ZN56_GLOBAL__N__0f0d6c2b_17_fused_prologue_cu_4c1f1c9b29norm_"
          "mod_quantize_rows_kernelI13__nv_bfloat16Li1EEEvPKT_S4_S4_iiifPaPf")
    lines = []
    for name, regs, spill in ((k1f, 168, k1f_spill), (k5, 102, 0)):
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {spill} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers"]
    if serialized:
        lines.insert(1, "ptxas info    : (C7520) Potential Performance Loss: "
                        "wgmma.mma_async instructions are serialized due to "
                        f"program dependence in the function '{k1f}'")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("spill,serialized", [(0, False), (8, False),
                                              (100, False), (0, True)])
def test_build_refuses_a_spill_or_serialized_wgmma_in_k1f(
        monkeypatch, capsys, spill, serialized):
    """phase_build parses nvcc's ptxas report: K1f (flash_fp32_wgmma_kernel)
    is a wgmma kernel, so any spill in one of its instances, 100 bytes as
    much as 8, or a serialized wgmma fails the build phase; a clean report
    gives each instance's registers."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from ltx_video_gpupoor_tpu_torch.ops import _lib

    report = _ptxas_report(spill, serialized)
    monkeypatch.setattr(_lib, "build", lambda force=False, parallel=True: (
        _lib.BUILD_DIR / "libltx_kernels_test.so", 1.0, report))
    monkeypatch.setattr(_lib, "library", lambda: None)
    if spill or serialized:
        with pytest.raises(AssertionError,
                           match="spills" if spill else "serialized"):
            chip_smoke.phase_build()
        return
    regs = chip_smoke.phase_build()
    assert regs == {"flash_fp32_wgmma_kernel<Li64ELi1ELi0E>": 168,
                    "norm_mod_quantize_rows_kernel<13__nv_bfloat16Li1E>": 102}
    out = capsys.readouterr().out
    assert "K1f (flash_fp32_wgmma_kernel), 1 instances" in out
    assert "K5's row kernel (norm_mod_quantize_rows_kernel)" in out
