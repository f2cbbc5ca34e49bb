"""The operation, byte and exponential counts behind ``denoise_mfu`` and
the roofline shares, against counts worked by hand."""

import pytest

from h100bench import work

EX2 = 4.0e12


def test_linear_least_by_hand():
    # M=4, K=8, N=16: 2*4*8*16 = 1024 ops; bytes: x 4*8*2 = 64, weights
    # 16*8 = 128, scale and bias 8*16 = 128, out 4*16*2 = 128 -> 448
    t, ops = work.linear_least(4, 8, 16)
    assert ops == 1024
    assert t == pytest.approx(max(1024 / 1979e12, 448 / 3.35e12))
    assert t == pytest.approx(448 / 3.35e12)      # bytes bound at this size


def test_attention_least_by_hand():
    # B=1, H=2, Sq=4, Skv=3, D=8: QK^T and PV 2*1*2*4*3*8 = 384 each;
    # bytes: q and out 2*8*4*(2+2) = 256, k and v 2*8*3*(2+2) = 192;
    # 24 exponentials
    t, ops = work.attention_least(1, 2, 4, 3, 8, "bf16", EX2)
    assert ops == 768
    assert t == pytest.approx(max(768 / 989e12, 448 / 3.35e12, 24 / EX2))
    # a large square call is bound by its operations in bf16, and by the
    # exponentials against int8's faster products at d=64
    t, ops = work.attention_least(1, 32, 15360, 15360, 128, "int8", EX2)
    assert t == pytest.approx(ops / 1979e12)
    t, _ = work.attention_least(3, 32, 5280, 5280, 64, "int8", EX2)
    assert t == pytest.approx(3 * 32 * 5280 * 5280 / EX2)


TINY = {"num_attention_heads": 2, "attention_head_dim": 4, "in_channels": 3,
        "out_channels": 3, "num_layers": 2, "caption_channels": 5,
        "ffn_mult": 4, "frequency_embedding_size": 6}


def test_linear_calls_by_hand():
    # d = 8, ffn = 32; b=2 streams, s=10 tokens, g=2 groups, sc=4
    calls = work.linear_calls(TINY, 2, 10, 2, 4)
    outer = [(20, 3, 8), (4, 6, 8), (4, 8, 8), (4, 8, 48), (8, 5, 8),
             (8, 8, 8), (20, 8, 3)]
    block = [(20, 8, 8)] * 4 + [(20, 8, 8), (8, 8, 8), (8, 8, 8),
                                (20, 8, 8), (20, 8, 32), (20, 32, 8)]
    assert calls == outer + block * 2
    ops = sum(2 * m * k * n for m, k, n in calls)
    assert ops == 2 * (20 * 24 + 4 * 48 + 4 * 64 + 4 * 384 + 8 * 40
                       + 8 * 64 + 20 * 24) + 2 * 2 * (
        4 * 20 * 64 + 2 * 8 * 64 + 2 * 20 * 64 + 2 * 20 * 256)


def _config(pipeline, heads=2, hd=64):
    return {"transformer": dict(TINY, num_attention_heads=heads,
                                attention_head_dim=hd),
            "attention": "auto", "prompt_tokens": 4, "pipeline": pipeline,
            "vae": {"blocks": [["res_x", 1], ["compress_all", 1],
                               ["compress_all", 1], ["compress_all", 1]],
                    "patch_size": 4}}


def test_passes_of_both_pipelines():
    mix = {"height": 608, "width": 992, "num_frames": 121,
           "num_inference_steps": 10}
    ms = {"pipeline_type": "multi-scale", "downscale_factor": 0.6666666,
          "first_pass": {"timesteps": [1, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4],
                         "guidance_scale": 1, "stg_scale": 0},
          "second_pass": {"timesteps": [0.9, 0.7, 0.4],
                          "guidance_scale": 1, "stg_scale": 0}}
    assert work.passes(_config(ms), mix) == [
        dict(steps=7, streams=1, tokens=16 * 12 * 20, groups=16),
        dict(steps=3, streams=1, tokens=16 * 24 * 40, groups=16)]
    base = {"pipeline_type": "base", "guidance_scale": 3, "stg_scale": 1}
    mix2 = dict(mix, height=480, width=704, num_inference_steps=8)
    assert work.passes(_config(base), mix2) == [
        dict(steps=8, streams=3, tokens=16 * 15 * 22, groups=16)]


def test_request_work_sums_the_calls():
    base = {"pipeline_type": "base", "guidance_scale": 3, "stg_scale": 1}
    mix = {"height": 64, "width": 96, "num_frames": 9,
           "num_inference_steps": 2}
    cfg = _config(base)
    w = work.request_work(cfg, mix, EX2)
    assert w["attention_precision"] == "bf16"
    # 2 steps of 3 streams over 2*2*3 = 12 tokens, 2 groups
    lin = sum(work.linear_least(*c)[0]
              for c in work.linear_calls(cfg["transformer"], 3, 12, 2, 4))
    att = sum(work.attention_least(*c, "bf16", EX2)[0]
              for c in work.attention_calls(cfg["transformer"], 3, 12, 4))
    assert w["linear_s"] == pytest.approx(2 * lin)
    assert w["attention_s"] == pytest.approx(2 * att)
    ops_l = sum(2 * m * k * n
                for m, k, n in work.linear_calls(cfg["transformer"], 3, 12,
                                                 2, 4))
    # a step: 2 layers x 4 x B=3 x H=2 x D=64 x (self 12*12 + cross 12*4)
    ops_a = 2 * 4 * 3 * 2 * 64 * (12 * 12 + 12 * 4)
    assert w["mfu_s"] == pytest.approx(2 * (ops_l / 1979e12
                                            + ops_a / 989e12))
    assert work.request_work(_config(base, hd=128), mix, EX2)[
        "attention_precision"] == "int8"
