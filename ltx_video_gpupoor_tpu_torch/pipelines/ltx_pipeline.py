"""LTX-Video text-to-video pipeline (single-scale pass).

Port of ``ltx_video_gpupoor_tpu/pipelines/ltx_pipeline.py``, t2v only:
``latent_to_pixel_coords`` (:64), ``GuidanceSchedule`` and
``build_guidance_schedule`` (:264-383), ``denoise`` (:418-655; its
``lax.scan`` is a host loop here) with CFG, CFG-star, STG and rescaling,
``_decode_full`` (:109) with decode-timestep noise, ``LTXPipeline.generate``
(:711, without conditioning items; ``noise=`` injection kept) and
``LTXPipeline.decode`` (:917, untiled).

Randomness comes from one explicit ``torch.Generator`` on the latents'
device: the initial noise (unless ``noise=`` is given), the stochastic
sampling noise of each step, and the decode noise, drawn in that order.
Not ported yet: conditioning items, TeaCache, tiling, sequence
parallelism and the interrupt hooks (ROADMAP queue 1 steps 9-11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.ltx import patchifier
from ..models.ltx import vae as ltx_vae
from ..models.ltx.transformer3d import (
    LTXTransformer3D,
    SkipLayerStrategy,
    compute_freqs,
)
from ..schedulers import rf


def latent_to_pixel_coords(latent_coords: torch.Tensor,
                           scale_factors: tuple[int, int, int],
                           causal_fix: bool = True) -> torch.Tensor:
    """``[B, 3, N]`` latent coords -> pixel coords; the causal first frame
    covers one pixel frame instead of ``temporal_factor``."""
    factors = torch.as_tensor(scale_factors, device=latent_coords.device)
    pixel = latent_coords * factors[None, :, None]
    if causal_fix:
        pixel = pixel.clone()
        pixel[:, 0] = torch.clamp(pixel[:, 0] + 1 - scale_factors[0], min=0)
    return pixel


@dataclasses.dataclass(frozen=True)
class GuidanceSchedule:
    guidance_scale: np.ndarray    # [steps]
    stg_scale: np.ndarray         # [steps]
    rescaling_scale: np.ndarray   # [steps]
    skip_layer_mask: np.ndarray   # [steps, num_layers, num_conds]
    num_conds: int
    skip_layer_strategy: Optional[str]
    cfg_star_rescale: bool = True
    do_rescaling: bool = True

    @property
    def do_cfg(self) -> bool:
        g = self.guidance_scale
        return self.num_conds >= 2 and bool(np.any((g != 0.0) & (g != 1.0)))

    @property
    def do_stg(self) -> bool:
        return bool(np.any(self.stg_scale > 0))


def _guidance_index(t, guidance_timesteps) -> int:
    """The first i with ``guidance_timesteps[i] <= t``, else the last."""
    for j, gt in enumerate(guidance_timesteps):
        if gt <= t:
            return j
    return len(guidance_timesteps) - 1


def _per_timestep(values, timesteps, guidance_timesteps):
    if not isinstance(values, (list, tuple)):
        return np.full(len(timesteps), float(values), np.float32)
    if guidance_timesteps is None:
        vals = list(values)
        if len(vals) < len(timesteps):
            vals = vals + [vals[-1]] * (len(timesteps) - len(vals))
        return np.asarray(vals[: len(timesteps)], np.float32)
    return np.asarray([values[_guidance_index(t, guidance_timesteps)]
                       for t in np.asarray(timesteps)], np.float32)


def build_guidance_schedule(
    timesteps: np.ndarray,
    num_layers: int,
    guidance_scale=1.0,
    stg_scale=0.0,
    rescaling_scale=1.0,
    skip_block_list=None,
    guidance_timesteps=None,
    skip_layer_strategy: Optional[str] = SkipLayerStrategy.AttentionValues,
    cfg_star_rescale: bool = True,
) -> GuidanceSchedule:
    steps = len(timesteps)
    g = _per_timestep(guidance_scale, timesteps, guidance_timesteps)
    s = _per_timestep(stg_scale, timesteps, guidance_timesteps)
    r = _per_timestep(rescaling_scale, timesteps, guidance_timesteps)
    g = np.where(g > 1.0, g, 0.0).astype(np.float32)
    do_cfg = bool(np.any((g != 0.0) & (g != 1.0)))
    do_stg = bool(np.any(s > 0))
    num_conds = 1 + (1 if do_cfg else 0) + (1 if do_stg else 0)

    mask = np.ones((steps, num_layers, num_conds), np.float32)
    if do_stg and skip_block_list is not None:
        ptb = num_conds - 1
        if len(skip_block_list) and isinstance(skip_block_list[0],
                                               (list, tuple)):
            if guidance_timesteps is not None:
                per_step = [skip_block_list[min(
                    _guidance_index(t, guidance_timesteps),
                    len(skip_block_list) - 1)] for t in np.asarray(timesteps)]
            else:
                per_step = [skip_block_list[min(i, len(skip_block_list) - 1)]
                            for i in range(steps)]
        else:
            per_step = [skip_block_list] * steps
        for i, blocks in enumerate(per_step):
            for blk in blocks:
                if blk < num_layers:
                    mask[i, blk, ptb] = 0.0
    return GuidanceSchedule(
        guidance_scale=g, stg_scale=s, rescaling_scale=r,
        skip_layer_mask=mask, num_conds=num_conds,
        skip_layer_strategy=skip_layer_strategy if do_stg else None,
        cfg_star_rescale=cfg_star_rescale,
        do_rescaling=bool(np.any(r != 1.0)),
    )


@torch.no_grad()
def denoise(
    transformer: LTXTransformer3D,
    latents: torch.Tensor,            # [1, N, C] patchified tokens (noised)
    conditioning_mask: torch.Tensor,  # [1, N] strength per token (0 = free)
    indices_grid: torch.Tensor,       # [1, 3, N] fractional coords
    timesteps,                        # [steps]
    schedule: GuidanceSchedule,
    prompt_embeds: torch.Tensor,      # [2 or 1, Sc, caption_dim] (neg, pos)
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    num_frame_groups: int,
    stochastic_sampling: bool = False,
    attn_mode: str = "auto",
) -> torch.Tensor:
    """The denoise loop; the guidance streams are batch rows
    ``[uncond, cond, perturbed]`` of one transformer call per step."""
    num_conds = schedule.num_conds
    n_tokens = latents.shape[1]
    if latents.shape[0] != 1:
        raise ValueError("guidance streams occupy the batch dim; batch=1")
    dev = latents.device

    if num_conds == 1:
        rows = [prompt_embeds.shape[0] - 1]
    else:
        if schedule.do_cfg:
            if prompt_embeds.shape[0] < 2:
                raise ValueError(
                    "CFG needs [negative, positive] prompt embeddings "
                    f"(got {prompt_embeds.shape[0]} row); pass "
                    "guidance_scale<=1 for single-prompt runs")
            rows = [0, 1]
        else:
            rows = [1] if prompt_embeds.shape[0] > 1 else [0]
        if schedule.do_stg:
            rows.append(rows[-1])
    ctx = prompt_embeds[rows].to(dev)
    ctx_mask = prompt_mask[rows].to(dev)

    ts_host = torch.as_tensor(timesteps, dtype=torch.float32).cpu()
    rf_sched = rf.RectifiedFlowSchedule(timesteps=ts_host)
    coords = indices_grid.expand(num_conds, -1, -1)
    # RoPE tables from the batch-1 grid broadcast over the streams
    freqs = compute_freqs(transformer.cfg, indices_grid)
    tokens_per_group = n_tokens // num_frame_groups
    skip_masks = torch.as_tensor(schedule.skip_layer_mask)

    for i in range(len(ts_host)):
        t = float(ts_host[i])
        t_tokens = torch.minimum(torch.tensor(t, device=dev),
                                 1.0 - conditioning_mask)          # [1, N]
        t_groups = t_tokens.reshape(1, num_frame_groups,
                                    tokens_per_group)[:, :, 0]     # [1, G]
        x = latents.expand(num_conds, -1, -1)
        tg = t_groups.expand(num_conds, -1)
        pred = transformer(
            x, coords, tg, ctx, ctx_mask,
            skip_layer_mask=skip_masks[i],
            skip_layer_strategy=schedule.skip_layer_strategy,
            attn_mode=attn_mode, freqs=freqs,
        ).float()

        streams = pred.split(1, dim=0)
        g = float(schedule.guidance_scale[i])
        stg = float(schedule.stg_scale[i])
        if schedule.do_stg:
            pred_text, pred_ptb = streams[-2], streams[-1]
        else:
            pred_text = streams[-1]
        if schedule.do_cfg:
            pred_uncond, pred_text = streams[0], streams[1]
            if g != 0.0 and g != 1.0:
                if schedule.cfg_star_rescale:
                    dot = torch.sum(pred_text * pred_uncond)
                    sq = torch.sum(pred_uncond ** 2) + 1e-8
                    pred_uncond = (dot / sq) * pred_uncond
                noise_pred = pred_uncond + g * (pred_text - pred_uncond)
            else:
                noise_pred = pred_text
        else:
            noise_pred = pred_text
        if schedule.do_stg:
            noise_pred = noise_pred + stg * (pred_text - pred_ptb)
            if schedule.do_rescaling and stg > 0.0:
                r = float(schedule.rescaling_scale[i])
                # population std (ddof 0), as jnp.std
                factor = pred_text.std(correction=0) / (
                    noise_pred.std(correction=0) + 1e-8)
                noise_pred = noise_pred * (r * factor + (1 - r))

        denoised = rf.step(rf_sched, noise_pred.to(latents.dtype), t_tokens,
                           latents, stochastic_sampling=stochastic_sampling,
                           generator=generator)
        to_denoise = (t - 1e-6 < (1.0 - conditioning_mask))[..., None]
        latents = torch.where(to_denoise, denoised, latents)
    return latents


@torch.no_grad()
def decode_full(vae: ltx_vae.CausalVAEDecoder, latent_grid: torch.Tensor,
                decode_timestep: float, decode_noise_scale: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Un-normalize, noise to the decode timestep (timestep-conditioned
    VAEs only), decode."""
    z = ltx_vae.un_normalize_latents(latent_grid, vae.per_channel_statistics)
    t = None
    gen = None
    if vae.cfg.timestep_conditioning:
        noise = torch.randn(z.shape, generator=generator, device=z.device,
                            dtype=z.dtype)
        s = torch.tensor(decode_noise_scale, dtype=torch.float32).to(z.dtype)
        z = z * (1 - s) + noise * s
        t = torch.tensor(decode_timestep, dtype=torch.float32,
                         device=z.device)
        gen = generator
    return ltx_vae.decode(vae, z, t, gen)


@dataclasses.dataclass
class LTXPipeline:
    """The DiT and the VAE decoder; methods drive them."""

    transformer: LTXTransformer3D
    vae: ltx_vae.CausalVAEDecoder

    def latent_shape(self, height: int, width: int, num_frames: int):
        sf = self.vae.cfg.spatial_downscale_factor
        tf = self.vae.cfg.temporal_downscale_factor
        return ((num_frames - 1) // tf + 1, height // sf, width // sf)

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: torch.Tensor,   # [2, S, D] (neg, pos) or [1, S, D]
        prompt_mask: torch.Tensor,
        height: int,
        width: int,
        num_frames: int,
        num_inference_steps: int = 30,
        timesteps: Optional[Sequence[float]] = None,
        frame_rate: float = 25.0,
        generator: Optional[torch.Generator] = None,
        guidance_scale=3.0,
        stg_scale=0.0,
        rescaling_scale=1.0,
        skip_block_list=None,
        guidance_timesteps=None,
        skip_layer_strategy=SkipLayerStrategy.AttentionValues,
        stochastic_sampling: bool = False,
        sampler: str = "Uniform",
        shifting: Optional[str] = "SD3",
        target_shift_terminal: Optional[float] = 0.1,
        output_type: str = "latent",
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        attn_mode: str = "auto",
        noise: Optional[torch.Tensor] = None,
    ):
        """Returns the latent grid ``[1, F', H', W', C]`` fp32
        (``output_type="latent"``) or pixels ``[1, F, H, W, 3]``."""
        dev = self.transformer.proj_out.bias.device
        f_lat, h_lat, w_lat = self.latent_shape(height, width, num_frames)
        c = self.transformer.cfg.in_channels
        sched = rf.make_schedule(
            num_inference_steps, sampler=sampler,
            shifting=shifting, n_media_tokens=f_lat * h_lat * w_lat,
            target_shift_terminal=target_shift_terminal, timesteps=timesteps)
        ts = sched.timesteps.numpy()

        if noise is None:
            noise = torch.randn((1, f_lat * h_lat * w_lat, c),
                                generator=generator, device=dev,
                                dtype=torch.float32)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        init = patchifier.unpatchify(noise, h_lat, w_lat, c)
        tokens, latent_coords = patchifier.patchify(init)
        cond_mask_tokens = torch.zeros((1, tokens.shape[1]),
                                       dtype=torch.float32, device=dev)
        vcfg = self.vae.cfg
        scale_factors = (vcfg.temporal_downscale_factor,
                         vcfg.spatial_downscale_factor,
                         vcfg.spatial_downscale_factor)
        pixel_coords = latent_to_pixel_coords(
            latent_coords, scale_factors, causal_fix=True).float()
        pixel_coords[:, 0] = pixel_coords[:, 0] * (1.0 / frame_rate)

        schedule = build_guidance_schedule(
            ts, self.transformer.cfg.num_layers,
            guidance_scale=guidance_scale, stg_scale=stg_scale,
            rescaling_scale=rescaling_scale, skip_block_list=skip_block_list,
            guidance_timesteps=guidance_timesteps,
            skip_layer_strategy=skip_layer_strategy)
        latents = denoise(
            self.transformer, tokens, cond_mask_tokens, pixel_coords, ts,
            schedule, prompt_embeds, prompt_mask, generator,
            num_frame_groups=f_lat, stochastic_sampling=stochastic_sampling,
            attn_mode=attn_mode)
        latent_grid = patchifier.unpatchify(latents, h_lat, w_lat, c)
        if output_type == "latent":
            return latent_grid
        return self.decode(latent_grid, decode_timestep, decode_noise_scale,
                           generator)

    def decode(self, latent_grid, decode_timestep=0.0,
               decode_noise_scale=None, generator=None):
        if decode_noise_scale is None:
            decode_noise_scale = decode_timestep
        return decode_full(self.vae, latent_grid, decode_timestep,
                           decode_noise_scale, generator)
