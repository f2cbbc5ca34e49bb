"""CPU tests of the benchmark harness (``python -m pytest bench_h100/tests``);
tests marked ``cuda`` need the card and skip here."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

# the published layout (the configurations' ``vae``) at a few channels
TINY_VAE = {"dims": 3, "in_channels": 3, "out_channels": 3,
            "latent_channels": 16,
            "encoder_blocks": [["res_x", {"num_layers": 1}],
                               ["compress_space_res", {"multiplier": 2}],
                               ["compress_time_res", {"multiplier": 2}],
                               ["compress_all_res", {"multiplier": 2}],
                               ["res_x", {"num_layers": 1}],
                               ["compress_all_res", {"multiplier": 2}]],
            "decoder_blocks": [["res_x", {"num_layers": 1}],
                               ["compress_all", {"residual": True,
                                                 "multiplier": 2}],
                               ["res_x", {"num_layers": 1}],
                               ["compress_all", {"residual": True,
                                                 "multiplier": 2}],
                               ["compress_all", {"residual": True,
                                                 "multiplier": 2}],
                               ["res_x", {"num_layers": 1}]],
            "base_channels": 8, "norm_layer": "pixel_norm", "patch_size": 4,
            "latent_log_var": "uniform", "use_quant_conv": False,
            "causal_decoder": False, "timestep_conditioning": True}
TINY_MIX = {"kind": "i2v", "height": 64, "width": 96, "num_frames": 9,
            "frame_rate": 30, "num_inference_steps": 3, "clients": 2,
            "prompt_words": [3, 6], "negative_words": [1, 3]}
# readings of the sound program at this size lie under these (pass1_rel
# 0.004-0.010, latents_rel 0.007-0.042, frames_rms 0.9-4.4), the int4
# control's over them (0.11-0.23, 0.14-0.18, 10-16); the upsampled latents
# of a one-token-a-frame pass 1 do not separate the two at this size. The
# served mp4 reads back as the frames through OpenCV's writer exactly
# (mp4_write_rms 0), and 41-67 with its channels swapped or frames reversed
TINY_LIMITS = {"pass1_rel": 0.06, "latents_rel": 0.09, "frames_rms": 6.0,
               "mp4_frames_off": 0, "mp4_write_rms": 0}


def tiny_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["transformer"].update(
        num_attention_heads=2, attention_head_dim=32, in_channels=16,
        out_channels=16, num_layers=2, cross_attention_dim=64,
        caption_channels=48)
    cfg["vae"] = dict(TINY_VAE)
    if "latent_upsampler" in cfg:
        cfg["latent_upsampler"].update(in_channels=16, mid_channels=32,
                                       num_blocks_per_stage=1)
    return cfg


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout-like directory with the benchmark's readers and kernel
    patterns and two tiny cells, ``t13`` (the 13B's pipeline) and ``t2``
    (the 2B's), on a tiny mix."""
    bench = tmp_path / "bench_h100"
    for sub in ("metrics", "kernels"):
        shutil.copytree(os.path.join(BENCH, sub), bench / sub)
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    for cfg, name in (("ltxv-13b-0.9.7-distilled", "tiny13"),
                      ("ltxv-2b-0.9.6-distilled", "tiny2")):
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(cfg)))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    (bench / "limits" / "t13.json").write_text(json.dumps(TINY_LIMITS))
    (bench / "limits" / "t2.json").write_text(json.dumps(
        {k: v for k, v in TINY_LIMITS.items() if k != "pass1_rel"}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [
        {"name": "tiny13", "file": "bench_h100/configs/tiny13.json"},
        {"name": "tiny2", "file": "bench_h100/configs/tiny2.json"}]
    spec["workloads"] = [
        {"name": "t13", "config": "tiny13", "traffic": "tiny", "chips": 1},
        {"name": "t2", "config": "tiny2", "traffic": "tiny", "chips": 1}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture
def opencv_codec_route(monkeypatch):
    """The served path's codec as on the card's machine: no libavcodec,
    no ffmpeg binary (the conditioning image's round trip through
    OpenCV's JPEG, mp4s through OpenCV)."""
    from ltx_video_gpupoor_tpu_torch.utils import media, native_codec

    monkeypatch.setattr(native_codec, "available", lambda: False)
    monkeypatch.setattr(media, "_ffmpeg", lambda: None)
