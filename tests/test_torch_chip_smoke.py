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
    # the bounded tiers (K3: the instances of K1's kernel whose fourth
    # template argument is true; K3q: its own kernel), K5's row kernel and
    # the two instances of K2's row kernel (by its CONTRACT argument) have
    # groups of their own
    trace["traceEvents"] += [
        ev("kernel", "void (anonymous namespace)::flash_wgmma_kernel"
           "<128, 2, false, true, 128>(...)", 5000.0, 250.0),
        ev("kernel", "void (anonymous namespace)::k3q_wgmma_kernel"
           "<128, 0>(...)", 5250.0, 50.0),
        ev("kernel", "norm_mod_quantize_rows_kernel<__nv_bfloat16, 1, 8>"
           "(...)", 6000.0, 125.0),
        ev("kernel", "void (anonymous namespace)::quantize_rows_kernel"
           "<__nv_bfloat16, 1, 8, 1, true>(...)", 6125.0, 75.0),
        ev("kernel", "void (anonymous namespace)::quantize_rows_kernel"
           "<__nv_bfloat16, 0, 256, 1, true>(...)", 6200.0, 100.0)]
    path.write_text(json.dumps(trace))
    groups = chip_smoke.summarize_trace(str(path))["groups"]
    assert groups["K3 bounded-score flash attention"] == (0.25, 1)
    assert groups["K3q int8-QK bounded-score flash attention"] == (0.05, 1)
    assert groups["K5 prologue row kernel"] == (0.125, 1)
    assert groups["int8 attention prologue (K2's row kernel)"] == (0.075, 1)
    assert groups["K2 row quantize"] == (0.1, 1)
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


def test_profiled_ops_keep_the_prologue_launch_counter():
    """The prologue counts its kernel launches on ``int8_prologue``, which
    the profiled run wraps in a scope: the wrapper shares the counter, so
    a launch inside the scope counts and the count survives the exit."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    before = fa.int8_prologue.kernel_launches
    with chip_smoke._ProfiledOps():
        wrapped = fa.int8_prologue
        wrapped.kernel_launches += 1
    assert wrapped is not fa.int8_prologue
    assert fa.int8_prologue.kernel_launches == before + 1
    fa.int8_prologue.kernel_launches = before


# the requests the stubbed [wan_variants] returns counts for
VARIANT_STUBS = ("vace", "clip_fp32")


def _stubbed_main(monkeypatch, capsys, argv, k3q_d80=0):
    """``chip_smoke.main`` with every phase replaced by a stub that records
    its name: (exit code, the phases in order, the printed lines). Every
    request's stubbed counts read 1 for each kernel, ``k3q_d80`` for K3q
    at head dim 80."""
    sys.path.insert(0, REPO)
    import chip_smoke

    ran = []
    ones = collections.defaultdict(lambda: 1, K3qd80=k3q_d80)
    timed = collections.defaultdict(lambda: (1.0, 1.0))
    info = collections.defaultdict(lambda: (1.0, "operations", None))
    results = {
        "phase_device": ("a card", 4.18e12),
        "phase_build": 1.0, "phase_k1": 0.0, "phase_k2": (0.0, 0.0),
        "phase_prologue": 0.0,
        "phase_k4": (0.0, 0.0), "phase_k3": 0.0, "phase_k3q": 0.0,
        "phase_d80": (0.0, 0.0, 0.0, 0.0), "phase_k5": 0.0,
        "phase_k6": 0.0, "phase_k1f": 0.0, "phase_timing": (timed, info),
        "time_k1f": None,
        "phase_k8": (0.0, 1), "phase_k7": (0.0, 1),
        "phase_path": ([ones], object(), object()),
        "phase_teacache": None, "phase_fp32": ones,
        "phase_ltx13b": ({**{t[0]: ones for t in chip_smoke.LTX13B_TIERS},
                          chip_smoke.ENHANCED: ones}, object()),
        "phase_load": ones, "phase_cli": ones,
        "phase_wan": ([ones] * len(chip_smoke.WAN_REQUESTS), object(),
                      object()),
        "phase_wan_i2v": [ones] * len(chip_smoke.WAN_I2V_REQUESTS),
        "phase_wan_variants": dict.fromkeys(VARIANT_STUBS, ones),
        "phase_aux": ones,
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
                 "phase_prologue", "phase_k4", "phase_k3", "phase_k3q",
                 "phase_d80", "phase_k5", "phase_k6", "phase_k1f",
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
                                   "phase_load", "phase_cli", "phase_wan",
                                   "phase_wan_variants", "phase_wan_i2v",
                                   "phase_aux"]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "a card", "count": 1}}
    kernels = json.loads(lines[-2])["kernels"]
    assert len(kernels) == 17
    # CLIP's head dim of 80: the D=80 instances of K1, K4, K1f and K3q,
    # own entries (K3q's the one no request runs)
    d80 = [k for k in kernels if "d=80" in k["name"]]
    assert [k["source"].rsplit("/", 1)[1] for k in d80] == [
        "flash_attention_wgmma.cu", "flash_attention_int8.cu",
        "flash_attention_fp32.cu", "flash_attention_int8.cu"]
    assert d80[-1]["launches"] == 0 and "bounded" in d80[-1]["name"]
    # K1f's d=80 launches are summed over every request's counts
    assert d80[2]["launches"] == _stubbed_runs()
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


def _stubbed_runs():
    """How many count dicts the stubbed paths return: LTX-2B's one
    request, [fp32], the LTX-13B tiers and the enhanced request, [load],
    [cli], Wan's, the variants' and the i2v requests, [aux]'s CLI run."""
    import chip_smoke

    return 6 + len(chip_smoke.LTX13B_TIERS) + len(chip_smoke.WAN_REQUESTS) \
        + len(VARIANT_STUBS) + len(chip_smoke.WAN_I2V_REQUESTS)


def test_k3q_d80_launches_are_counted_not_assumed(monkeypatch, capsys):
    """The kernels line gives K3q's d=80 instance the launches the
    requests' counts hold at head dim 80: a request that ran it shows."""
    code, _, lines = _stubbed_main(monkeypatch, capsys, [], k3q_d80=2)
    assert code == 0
    kernels = json.loads(lines[-2])["kernels"]
    k3q = [k for k in kernels if "d=80" in k["name"] and "bounded" in
           k["name"]]
    assert len(k3q) == 1 and k3q[0]["launches"] == 2 * _stubbed_runs()


def _ptxas_report(k1f_spill=0, serialized=False):
    """A ptxas -v report of one K1f instance, one of K5's row kernel, one
    of K2's and one of K3q, in the form nvcc prints it; ``k1f_spill`` bytes
    of spill stores and loads in the K1f instance."""
    k1f = ("_ZN56_GLOBAL__N__a364beb7_23_flash_attention_fp32_cu_664c2249"
           "23flash_fp32_wgmma_kernelILi64ELi1ELi0EEEvNS_6ParamsE")
    k5 = ("_ZN56_GLOBAL__N__0f0d6c2b_17_fused_prologue_cu_4c1f1c9b29norm_"
          "mod_quantize_rows_kernelI13__nv_bfloat16Li1EEEvPKT_S4_S4_iiifPaPf")
    k2 = ("_ZN56_GLOBAL__N__5e7c0a11_14_int8_linear_cu_8f3e2d1a20quantize_"
          "rows_kernelI13__nv_bfloat16Li0ELi32ELi1ELb1EEEvNS_7RowArgsE")
    k3q = ("_ZN56_GLOBAL__N__6d8a1b22_22_flash_attention_int8_cu_1a2b3c4d16"
           "k3q_wgmma_kernelILi128ELi0EEEv14CUtensorMap_st")
    lines = []
    for name, regs, spill in ((k1f, 168, k1f_spill), (k5, 102, 0),
                              (k2, 32, 0), (k3q, 200, 0)):
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
                    "norm_mod_quantize_rows_kernel<13__nv_bfloat16Li1E>": 102,
                    "quantize_rows_kernel<13__nv_bfloat16Li0ELi32ELi1ELb1E>":
                    32, "k3q_wgmma_kernel<Li128ELi0E>": 200}
    out = capsys.readouterr().out
    assert "K1f (flash_fp32_wgmma_kernel), 1 instances" in out
    assert "K5's row kernel (norm_mod_quantize_rows_kernel)" in out


@pytest.mark.parametrize("variant", ["t2v", "vace", "recammaster", "df",
                                     "all"])
def test_variant_expect_counts_what_a_forward_runs(monkeypatch, variant):
    """``variant_expect`` (the launches [wan_variants] requires of each
    request) against the calls one forward of a small DiT with the same
    modules makes on the CPU: every ``Linear`` in the dynamic tier is a K2
    launch on the card, every attention at head dim 128 under ``auto`` a
    K4 launch."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops import quant
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

    flags = {"vace": dict(vace_layers=(0, 2), vace_in_dim=12),
             "recammaster": dict(recammaster=True),
             "df": dict(inject_sample_info=True)}
    kw = {} if variant == "t2v" else flags.get(variant) or {
        k: v for f in flags.values() for k, v in f.items()}
    cfg = wm.WanConfig(model_type="t2v", text_len=8, in_dim=4, dim=256,
                       ffn_dim=64, freq_dim=32, text_dim=16, out_dim=4,
                       num_heads=2, num_layers=3, **kw)
    model = wm.init_params(wm.WanModel(cfg, FP32_POLICY),
                           torch.Generator().manual_seed(0))
    quantize_params(model, mode="dynamic")
    calls = collections.Counter()
    linear_forward = quant.Linear.forward
    attention = wm.attention

    def count_linear(self, x):
        calls["K2"] += 1
        return linear_forward(self, x)

    def count_attention(q, *args, **kwargs):
        calls["K4"] += 1
        assert q.shape[-1] == 128
        return attention(q, *args, **kwargs)

    monkeypatch.setattr(quant.Linear, "forward", count_linear)
    monkeypatch.setattr(wm, "attention", count_attention)
    f = 4 if cfg.recammaster else 2
    x = torch.randn(2, f, 4, 4, 4)
    extra = {}
    if cfg.vace_layers:
        extra["vace_context"] = torch.randn(2, f, 4, 4, 12)
    if cfg.recammaster:
        extra["cam_emb"] = torch.randn(1, f // 2, 12)
    if cfg.inject_sample_info:
        extra["fps_idx"] = 1
    t = torch.full((2, f), 500.0) if cfg.inject_sample_info \
        else torch.full((2,), 500.0)
    with torch.no_grad():
        model(x, t, torch.randn(2, 8, 16), torch.ones(2, 8),
              wan_rope_freqs((f, 2, 2), 128), **extra)
    must, _ = chip_smoke.variant_expect(
        variant, cfg.num_layers, 1,
        vace_blocks=len(cfg.vace_layers or ()), cam=cfg.recammaster,
        fps=cfg.inject_sample_info)
    assert calls["K2"] == must["K2"]
    assert calls["K4"] == must["K4d128"] == must["K2p"]


def test_stand_in_tokenizers_need_no_tokenizer_package():
    """chip_smoke.py defines its word-level tokenizers without importing
    ``transformers`` or ``tokenizers``: the card's machine is not known to
    have them."""
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke\n"
            "for make in (chip_smoke.llama3_tokenizer, "
            "chip_smoke.qwen_tokenizer, chip_smoke.florence_tokenizer):\n"
            "    tok = make(); ids = tok('a b <|im_end|> </s>')['input_ids']\n"
            "    assert tok.decode(ids) and tok.eos_token_id in "
            "tok.special_ids\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'tokenizers', 'jax')]\n"
            "sys.exit(1 if bad else 0)\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_enhanced_request_expects_tier_b(monkeypatch):
    """The enhanced POST / must launch what tier (b) launches: the
    enhancer's models (here small ones on the CPU behind chip_smoke.py's
    stand-in tokenizers, at Llama-3's and Florence-2's vocabularies) call
    no kernel wrapper (their linears are dense, their attention plain
    torch ops); and the enhancer rewrites the prompt through them."""
    sys.path.insert(0, REPO)
    import chip_smoke
    import numpy as np
    from ltx_video_gpupoor_tpu_torch.models import florence2 as fl
    from ltx_video_gpupoor_tpu_torch.models import llm
    from ltx_video_gpupoor_tpu_torch.ops import attention as attn
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
    from ltx_video_gpupoor_tpu_torch.ops import quant
    from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as pe

    assert chip_smoke.ENHANCE_EXPECT == \
        chip_smoke.LTX13B_EXPECT[chip_smoke.LTX13B_SERVED]
    calls = []
    for mod, name in ((attn, "attention"), (fa, "flash_attention"),
                      (fa, "flash_attention_hp"), (fa, "flash_attention_int8"),
                      (fa, "flash_attention_fp32"), (im, "int8_linear"),
                      (fp, "norm_mod_int8_matmul")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(
            _n))
    g = torch.Generator().manual_seed(0)
    lm = llm.init_params(llm.LLM(llm.LLMConfig(
        vocab_size=128256, dim=16, num_layers=1, num_heads=2, num_kv_heads=1,
        ffn_dim=32, rope_scaling="llama3"), dtype=torch.float32), g)
    hf = dict(chip_smoke.FLORENCE2_LARGE_HF)
    hf["vision_config"] = dict(hf["vision_config"], depths=[1, 1],
                               embed_dim=[8, 16], num_heads=[1, 2],
                               num_groups=[1, 2], patch_size=[7, 3],
                               patch_stride=[4, 2], patch_padding=[3, 1],
                               patch_prenorm=[False, True],
                               projection_dim=16)
    hf["text_config"] = dict(hf["text_config"], d_model=16,
                             encoder_layers=1, decoder_layers=1,
                             encoder_attention_heads=2, encoder_ffn_dim=32)
    flo = fl.init_params(fl.Florence2(fl.config_from_hf(hf),
                                      dtype=torch.float32), g)
    # as build_enhancer draws it: a random BART copies its forced BOS else
    flo.text.final_logits_bias.copy_(torch.randn(51289, generator=g))
    for m in (lm, flo):
        assert not any(x.quantized for x in m.modules()
                       if isinstance(x, quant.Linear))
    enh = pe.PromptEnhancer(
        lm=pe.ChatLM(model=lm, tokenizer=chip_smoke.llama3_tokenizer(),
                     max_new_tokens=6),
        captioner=pe.FlorenceCaptioner(
            model=flo, tokenizer=chip_smoke.florence_tokenizer(),
            max_new_tokens=6, image_size=64))
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3)).astype(
        np.uint8)
    prompt = "a seeded synthetic gradient comes alive"
    out = enh.enhance(prompt, first_frames=[img])
    assert calls == []
    assert out != prompt and enh.lm.last_new_tokens > 0
    assert enh.captioner.last_new_tokens > 0
