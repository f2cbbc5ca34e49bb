"""LTX-Video generation orchestrator.

Port of ``ltx_video_gpupoor_tpu/serving/orchestrator.py``:
``pad_dimensions`` (:68), ``build_timesteps`` (:76) and
``LTXVideoGenerator.generate`` (:158): text-to-video, an image as first
and/or last frame, a video as conditioning or (``strength < 1``) as the
start of a video-to-video run (:198-275), the ``"base"`` branch
(:364-391) and the two-pass multi-scale branch (:312-363), the bilinear
resize back to the padded size (:395-405), uint8 ``[F, H, W, 3]`` frames
or planar YUV420 (``_rgb_to_yuv420``, :36), resolution bucketing (:198-212)
and the ambient stage marks (``utils/observability.py::stage``). TeaCache
raises ``NotImplementedError`` (ROADMAP queue 1 step 11).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..configs import load_ltx_pipeline_config
from ..models.ltx.transformer3d import SkipLayerStrategy
from ..pipelines.ltx_pipeline import (
    ConditioningItem,
    LTXPipeline,
    encode_media,
    resize_bilinear,
)
from ..pipelines.multiscale import MultiScalePipeline
from ..schedulers import rf
from ..utils import media as media_utils
from ..utils import resolution
from ..utils.observability import stage as _stage

logger = logging.getLogger(__name__)


def _rgb_to_yuv420(frames: torch.Tensor):
    """[F, H, W, 3] float in [-1, 1] -> planar YUV420 uint8 (BT.601
    limited range, swscale's default for RGB24->YUV420P), on the frames'
    device, so the host fetch moves 1.5 bytes a pixel instead of 3."""
    rgb = (frames.float() + 1.0) * 0.5
    m = torch.tensor(
        [[65.481, -37.797, 112.0],
         [128.553, -74.203, -93.786],
         [24.966, 112.0, -18.214]], dtype=torch.float32, device=rgb.device)
    yuv = rgb @ m + torch.tensor([16.0, 128.0, 128.0], dtype=torch.float32,
                                 device=rgb.device)
    y = torch.clamp(torch.round(yuv[..., 0]), 0, 255).to(torch.uint8)
    f, h, w = y.shape
    c = yuv[..., 1:].reshape(f, h // 2, 2, w // 2, 2, 2).mean(dim=(2, 4))
    c = torch.clamp(torch.round(c), 0, 255).to(torch.uint8)
    return y, c[..., 0], c[..., 1]


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
    """End-to-end t2v / i2v / v2v generation with the reference's knobs.
    ``pipeline_config`` names a registry entry or is the config itself
    (the JAX package defaults to ``"ltxv-13b-0.9.7-distilled"``, which
    needs ``multiscale``)."""

    pipeline: LTXPipeline
    multiscale: Optional[MultiScalePipeline] = None
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
        image_start: Optional[np.ndarray] = None,   # [H, W, 3]
        image_end: Optional[np.ndarray] = None,
        input_video: Optional[np.ndarray] = None,   # [F, H, W, 3]
        image_cond_noise_scale: float = 0.15,
        fit_into_canvas: bool = True,
        sampling_steps: Optional[int] = None,
        strength: float = 1.0,
        output_type: str = "pixels",
        bucket_resolution: bool = False,
        teacache_multiplier: float = 0.0,
        noise: Optional[torch.Tensor] = None,
        noise_pass1: Optional[torch.Tensor] = None,
        noise_pass2: Optional[torch.Tensor] = None,
        attn_mode: str = "auto",
        on_stage=None,
    ):
        """Generate frames: uint8 ``[F, H, W, 3]`` numpy on the host
        (``output_type="pixels"``), a tuple of host uint8 planes ``(y
        [F, H, W], u [F, H/2, W/2], v [F, H/2, W/2])`` (``"yuv420"``,
        BT.601; uint8 RGB instead when a target dim is odd) or the latent
        grid (``"latent"``). ``bucket_resolution`` snaps the size to the
        nearest aspect-ratio bin (``utils/resolution.py``).

        ``image_start`` / ``image_end`` (uint8, or float in [-1, 1])
        condition the first / last frame; ``input_video`` (float in
        [-1, 1]) conditions the leading frames or, with ``strength < 1``,
        is encoded, noised to ``strength`` and denoised from there.
        ``seed`` seeds one ``torch.Generator`` on the model's device;
        ``noise`` ([1, tokens, C] fp32) replaces the initial noise draw of
        the base pipeline, ``noise_pass1`` / ``noise_pass2`` those of the
        two multi-scale passes. ``attn_mode`` selects the attention tier
        (``ops.attention``). ``on_stage(name, value)``, if given, is
        called as each stage starts: ``("denoise", None)``, in the
        multi-scale branch also ``("pass1", None)``, ``("upsample",
        latents)`` and ``("pass2", latents)``, then ``("decode", latent
        grid)`` and ``("postprocess", decoded pixels in [-1, 1])``."""
        if teacache_multiplier > 0:
            raise NotImplementedError(
                "teacache_multiplier: ROADMAP queue 1 step 11")
        if output_type not in ("pixels", "yuv420", "latent"):
            raise ValueError(f"unknown output_type {output_type!r}")
        cfg = dict(self.pipeline_config)
        stg_strategy = STG_MODES[cfg.get("stg_mode", "attention_values")]
        dev = self.pipeline.transformer.proj_out.bias.device
        generator = torch.Generator(device=dev).manual_seed(seed)

        if input_video is not None:
            height, width = input_video.shape[1:3]
        elif image_start is not None:
            ih, iw = image_start.shape[:2]
            height, width = media_utils.calculate_new_dimensions(
                height, width, ih, iw, fit_into_canvas, 32)
        height = min(height, MAX_HEIGHT)
        width = min(width, MAX_WIDTH)
        frame_num = min(frame_num, MAX_FRAMES)
        if bucket_resolution:
            # arbitrary user sizes land on a bounded set of shapes
            req = (height, width, frame_num)
            height, width, frame_num = resolution.bucketed_dimensions(
                height, width, frame_num)
            if (height, width, frame_num) != req:
                logger.info(
                    "bucket_resolution: request %dx%dx%df -> %dx%dx%df",
                    req[0], req[1], req[2], height, width, frame_num)
        hp, wp, fp = pad_dimensions(height, width, frame_num)
        padding = media_utils.calculate_padding(height, width, hp, wp)

        conditioning = []
        media_video = None
        with _stage("media_prep"):
            if input_video is not None and (input_video.shape[1] != height
                                            or input_video.shape[2] != width):
                # the working dims moved off the video's own (the MAX clamp
                # or the bucketing): resize the frames before padding
                input_video = np.stack([
                    media_utils.resize_image(f, height, width)
                    for f in np.asarray(input_video)])
            if input_video is not None and strength < 1.0:
                # v2v: the whole video, trimmed to the padded frame count,
                # is encoded at each branch's working resolution
                media_video = media_utils.pad_media(input_video[:fp], padding)
            elif input_video is not None:
                # conditioning video: trimmed to N * temporal_factor + 1
                tsf = self.pipeline.vae.cfg.temporal_downscale_factor
                n = min(input_video.shape[0], frame_num)
                n = (n - 1) // tsf * tsf + 1
                item = media_utils.pad_media(input_video[:n], padding)
                conditioning.append(ConditioningItem(item, 0, 1.0))
            if image_start is not None:
                img = media_utils.prepare_conditioning_image(
                    image_start, height, width)
                conditioning.append(ConditioningItem(
                    media_utils.pad_media(img, padding), 0, 1.0))
            if image_end is not None:
                img = media_utils.prepare_conditioning_image(
                    image_end, height, width)
                conditioning.append(ConditioningItem(
                    media_utils.pad_media(img, padding), fp - 1, 1.0))

        common = dict(
            frame_rate=frame_rate,
            conditioning_items=conditioning,
            image_cond_noise_scale=(image_cond_noise_scale if conditioning
                                    else 0.0),
            stochastic_sampling=cfg.get("stochastic_sampling", False),
            attn_mode=attn_mode,
        )
        f_lat, h_lat, w_lat = self.pipeline.latent_shape(hp, wp, fp)
        n_tokens = f_lat * h_lat * w_lat

        def encode_video(video: np.ndarray, th: int, tw: int):
            if video.shape[1] != th or video.shape[2] != tw:
                video = np.stack([media_utils.resize_image(f, th, tw)
                                  for f in video])
            return encode_media(self.pipeline.vae, torch.as_tensor(
                video, dtype=torch.float32, device=dev)[None])

        max_t = strength if media_video is not None else 1.0
        if on_stage is not None:
            on_stage("denoise", None)
        if cfg.get("pipeline_type") == "multi-scale":
            if self.multiscale is None:
                raise ValueError(
                    "multi-scale config requires a latent upsampler "
                    "(LTXVideoGenerator(multiscale=MultiScalePipeline(...)))")
            first = dict(cfg["first_pass"])
            second = dict(cfg["second_pass"])
            if sampling_steps is not None:
                # the user's step count overrides both passes' counts;
                # explicit timestep lists still win in build_timesteps
                first["num_inference_steps"] = sampling_steps
                second["num_inference_steps"] = sampling_steps
            ms = self.multiscale
            df = cfg.get("downscale_factor")
            if df is not None and df != ms.downscale_factor:
                ms = dataclasses.replace(ms, downscale_factor=df)
            # pass-1 dims from the same computation the multi-scale
            # pipeline will run
            dh, dw = ms.downscaled_dims(hp, wp)
            fl, hl, wl = self.pipeline.latent_shape(dh, dw, fp)
            ts1 = build_timesteps(first, fl * hl * wl, cfg.get("sampler"),
                                  max_timestep=max_t)
            # strength truncates both passes' schedules
            ts2 = build_timesteps(second, n_tokens, cfg.get("sampler"),
                                  max_timestep=max_t)
            first_kw = dict(timesteps=ts1, **_pass_kwargs(first, stg_strategy))
            if media_video is not None:
                first_kw.update(
                    media_latents=encode_video(media_video, dh, dw),
                    initial_timestep=float(ts1[0]))
            latents = ms.generate(
                prompt_embeds, prompt_mask, height=hp, width=wp,
                num_frames=fp, first_pass=first_kw,
                second_pass=dict(timesteps=ts2,
                                 **_pass_kwargs(second, stg_strategy)),
                generator=generator, output_type="latent",
                noise_pass1=noise_pass1, noise_pass2=noise_pass2,
                on_stage=on_stage, **common)
        else:
            pass_cfg = {k: cfg[k] for k in (
                "guidance_scale", "stg_scale", "rescaling_scale",
                "skip_block_list", "guidance_timesteps",
                "num_inference_steps", "timesteps") if k in cfg}
            if sampling_steps is not None:
                pass_cfg["num_inference_steps"] = sampling_steps
            ts = build_timesteps(pass_cfg, n_tokens, cfg.get("sampler"),
                                 max_timestep=max_t)
            extra = {}
            if media_video is not None:
                extra = dict(media_latents=encode_video(media_video, hp, wp),
                             initial_timestep=float(ts[0]))
            latents = self.pipeline.generate(
                prompt_embeds, prompt_mask, height=hp, width=wp,
                num_frames=fp, timesteps=ts, generator=generator,
                output_type="latent", noise=noise,
                **_pass_kwargs(pass_cfg, stg_strategy), **common, **extra)
        if output_type == "latent":
            return latents
        if on_stage is not None:
            on_stage("decode", latents)
        with _stage("vae_decode", sync=lambda: px):
            px = self.pipeline.decode(
                latents, cfg.get("decode_timestep", 0.0),
                cfg.get("decode_noise_scale"), generator)
        if on_stage is not None:
            on_stage("postprocess", px)
        with _stage("resize_quant_fetch"):
            frames = px[0]
            if frames.shape[1] != hp or frames.shape[2] != wp:
                # multi-scale pass 2 decodes at twice the downscaled dims,
                # which can exceed the request: resize back to the padded
                # size
                frames = resize_bilinear(frames.float(), hp, wp)
            frames = media_utils.crop_padding(frames, padding, frame_num)
            if output_type == "yuv420" and height % 2 == 0 and width % 2 == 0:
                return tuple(p.cpu().numpy() for p in _rgb_to_yuv420(frames))
            frames = torch.clamp((frames.float() + 1.0) * 127.5, 0, 255)
            return frames.to(torch.uint8).cpu().numpy()
