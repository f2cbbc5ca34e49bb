"""LTX-Video generation orchestrator.

Port of ``ltx_video_gpupoor_tpu/serving/orchestrator.py``:
``pad_dimensions`` (:68), ``build_timesteps`` (:76) and
``LTXVideoGenerator.generate`` (:158) on the ``"base"`` pipeline branch
(:364-391), returning uint8 ``[F, H, W, 3]`` frames. The multi-scale
branch, i2v/v2v media, ``yuv420`` output, resolution bucketing and
TeaCache raise ``NotImplementedError`` (ROADMAP queue 1 steps 9-11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs import load_ltx_pipeline_config
from ..models.ltx.transformer3d import SkipLayerStrategy
from ..pipelines.ltx_pipeline import LTXPipeline
from ..schedulers import rf
from ..utils import media as media_utils

STG_MODES = {
    "attention_values": SkipLayerStrategy.AttentionValues,
    "stg_av": SkipLayerStrategy.AttentionValues,
    "attention_skip": SkipLayerStrategy.AttentionSkip,
    "stg_as": SkipLayerStrategy.AttentionSkip,
    "residual": SkipLayerStrategy.Residual,
    "stg_r": SkipLayerStrategy.Residual,
    "transformer_block": SkipLayerStrategy.TransformerBlock,
    "stg_t": SkipLayerStrategy.TransformerBlock,
}

MAX_HEIGHT, MAX_WIDTH, MAX_FRAMES = 720, 1280, 257


def pad_dimensions(height: int, width: int, frame_num: int):
    """H/W to /32, frames to N*8+1."""
    height_padded = ((height - 1) // 32 + 1) * 32
    width_padded = ((width - 1) // 32 + 1) * 32
    num_frames_padded = ((frame_num - 2) // 8 + 1) * 8 + 1
    return height_padded, width_padded, num_frames_padded


def build_timesteps(pass_cfg: dict, n_media_tokens: int,
                    sampler: str = "from_checkpoint",
                    max_timestep: float = 1.0) -> np.ndarray:
    """Timestep list for one pass, with skip_initial/final handling and
    the ``max_timestep`` truncation."""
    if "timesteps" in pass_cfg:
        ts = np.asarray(pass_cfg["timesteps"], np.float32)
    else:
        steps = pass_cfg.get("num_inference_steps", 30)
        sampler_name = {
            "from_checkpoint": "Uniform",
            "uniform": "Uniform",
            "linear-quadratic": "LinearQuadratic",
        }.get(sampler, "Uniform")
        sched = rf.make_schedule(steps, sampler=sampler_name, shifting="SD3",
                                 n_media_tokens=n_media_tokens,
                                 target_shift_terminal=0.1)
        ts = sched.timesteps.numpy()
    skip_i = pass_cfg.get("skip_initial_inference_steps", 0)
    skip_f = pass_cfg.get("skip_final_inference_steps", 0)
    if skip_i < 0 or skip_f < 0 or skip_i + skip_f >= len(ts):
        raise ValueError(
            "invalid skip inference step values: skip_initial="
            f"{skip_i}, skip_final={skip_f} with {len(ts)} steps")
    if skip_i or skip_f:
        ts = ts[skip_i: len(ts) - skip_f]
    if max_timestep < 1.0:
        if max_timestep < float(ts.min()):
            raise ValueError(
                f"max_timestep {max_timestep} is smaller than the "
                f"minimum timestep {float(ts.min())}")
        ts = ts[ts <= max_timestep]
    return ts


def _pass_kwargs(pass_cfg: dict, stg_strategy):
    return dict(
        guidance_scale=pass_cfg.get("guidance_scale", 1.0),
        stg_scale=pass_cfg.get("stg_scale", 0.0),
        rescaling_scale=pass_cfg.get("rescaling_scale", 1.0),
        skip_block_list=pass_cfg.get("skip_block_list"),
        guidance_timesteps=pass_cfg.get("guidance_timesteps"),
        skip_layer_strategy=stg_strategy,
    )


@dataclasses.dataclass
class LTXVideoGenerator:
    """End-to-end text-to-video generation with the reference's knobs."""

    pipeline: LTXPipeline
    pipeline_config: dict | str = "ltxv-2b-0.9.6-distilled"

    def __post_init__(self):
        if isinstance(self.pipeline_config, str):
            self.pipeline_config = load_ltx_pipeline_config(
                self.pipeline_config)

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: torch.Tensor,       # [2, S, D] (neg, pos)
        prompt_mask: torch.Tensor,
        height: int = 704,
        width: int = 1216,
        frame_num: int = 81,
        frame_rate: float = 30.0,
        seed: int = 42,
        image_start: Optional[np.ndarray] = None,
        image_end: Optional[np.ndarray] = None,
        input_video: Optional[np.ndarray] = None,
        sampling_steps: Optional[int] = None,
        output_type: str = "pixels",
        bucket_resolution: bool = False,
        teacache_multiplier: float = 0.0,
        noise: Optional[torch.Tensor] = None,
        on_stage=None,
    ):
        """Generate frames: uint8 ``[F, H, W, 3]`` numpy on the host
        (``output_type="pixels"``) or the latent grid (``"latent"``).

        ``seed`` seeds one ``torch.Generator`` on the model's device;
        ``noise`` ([1, tokens, C] fp32) replaces the initial noise draw.
        ``on_stage(name, value)``, if given, is called as each stage
        starts: ``("denoise", None)``, ``("decode", latent grid)`` and
        ``("postprocess", decoded pixels in [-1, 1])``."""
        for name, value, step in (
                ("image_start", image_start is not None, 9),
                ("image_end", image_end is not None, 9),
                ("input_video", input_video is not None, 9),
                ("bucket_resolution", bucket_resolution, 11),
                ("teacache_multiplier", teacache_multiplier > 0, 11)):
            if value:
                raise NotImplementedError(
                    f"{name}: ROADMAP queue 1 step {step}")
        if output_type not in ("pixels", "latent"):
            raise NotImplementedError(
                f"output_type={output_type!r}: ROADMAP queue 1 step 11")
        cfg = dict(self.pipeline_config)
        if cfg.get("pipeline_type") == "multi-scale":
            raise NotImplementedError(
                "multi-scale pipeline configs: ROADMAP queue 1 step 10")
        stg_strategy = STG_MODES[cfg.get("stg_mode", "attention_values")]
        dev = self.pipeline.transformer.proj_out.bias.device
        generator = torch.Generator(device=dev).manual_seed(seed)

        height = min(height, MAX_HEIGHT)
        width = min(width, MAX_WIDTH)
        frame_num = min(frame_num, MAX_FRAMES)
        hp, wp, fp = pad_dimensions(height, width, frame_num)
        padding = media_utils.calculate_padding(height, width, hp, wp)

        pass_cfg = {k: cfg[k] for k in (
            "guidance_scale", "stg_scale", "rescaling_scale",
            "skip_block_list", "guidance_timesteps", "num_inference_steps",
            "timesteps") if k in cfg}
        if sampling_steps is not None:
            pass_cfg["num_inference_steps"] = sampling_steps
        f_lat, h_lat, w_lat = self.pipeline.latent_shape(hp, wp, fp)
        ts = build_timesteps(pass_cfg, f_lat * h_lat * w_lat,
                             cfg.get("sampler"))
        if on_stage is not None:
            on_stage("denoise", None)
        latents = self.pipeline.generate(
            prompt_embeds, prompt_mask, height=hp, width=wp, num_frames=fp,
            timesteps=ts, generator=generator, output_type="latent",
            frame_rate=frame_rate,
            stochastic_sampling=cfg.get("stochastic_sampling", False),
            noise=noise, **_pass_kwargs(pass_cfg, stg_strategy))
        if output_type == "latent":
            return latents
        if on_stage is not None:
            on_stage("decode", latents)
        px = self.pipeline.decode(latents, cfg.get("decode_timestep", 0.0),
                                  cfg.get("decode_noise_scale"), generator)
        if on_stage is not None:
            on_stage("postprocess", px)
        frames = media_utils.crop_padding(px[0], padding, frame_num)
        frames = torch.clamp((frames.float() + 1.0) * 127.5, 0, 255)
        return frames.to(torch.uint8).cpu().numpy()
