"""Two-pass multi-scale LTX pipeline.

Port of ``ltx_video_gpupoor_tpu/pipelines/multiscale.py``:
``adain_filter_latent`` (:27), ``upsample_latents`` (:44) and
``MultiScalePipeline`` (:56): pass 1 at ``downscale_factor`` of the
request, a 2x latent upsample in un-normalized latent space, AdaIN
against the pass-1 latents, pass 2 at twice the pass-1 size with its own
guidance config, then the decode. One ``torch.Generator`` serves both
passes in order (the JAX package splits a key three ways);
``noise_pass1`` / ``noise_pass2`` replace each pass's initial noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.ltx import latent_upsampler as lup
from ..models.ltx import vae as ltx_vae
from .ltx_pipeline import LTXPipeline


def adain_filter_latent(latents: torch.Tensor, reference: torch.Tensor,
                        factor: float = 1.0) -> torch.Tensor:
    """Per-(batch, channel) AdaIN over all (F, H, W) positions of
    channels-last ``[B, F, H, W, C]`` (population std, as ``jnp.std``)."""
    axes = (1, 2, 3)
    i_mean = latents.mean(dim=axes, keepdim=True)
    i_sd = latents.std(dim=axes, keepdim=True, correction=0)
    r_mean = reference.mean(dim=axes, keepdim=True)
    r_sd = reference.std(dim=axes, keepdim=True, correction=0)
    result = ((latents - i_mean) / (i_sd + 1e-8)) * r_sd + r_mean
    return latents + factor * (result - latents)


@torch.no_grad()
def upsample_latents(upsampler: lup.LatentUpsampler,
                     stats: ltx_vae.LatentStats,
                     latents: torch.Tensor) -> torch.Tensor:
    """Un-normalize -> upsample -> re-normalize, in the latents' dtype."""
    z = ltx_vae.un_normalize_latents(latents, stats)
    z = lup.forward(upsampler, z).to(latents.dtype)
    return ltx_vae.normalize_latents(z, stats)


@dataclasses.dataclass
class MultiScalePipeline:
    pipeline: LTXPipeline
    upsampler: lup.LatentUpsampler
    downscale_factor: float = 2 / 3

    def downscaled_dims(self, height: int, width: int) -> tuple[int, int]:
        """Pass-1 dims: ``int(dim * factor)`` snapped down to the VAE
        stride. The single source of truth: callers deriving pass-1
        latent grids must use THIS (the YAML factor 0.6666666 and float
        ``2/3`` differ by one unit in ``int()`` for dims divisible by 96,
        which the %32 snap then turns into a whole-block mismatch)."""
        sf = self.pipeline.vae.cfg.spatial_downscale_factor
        xh = int(height * self.downscale_factor)
        xw = int(width * self.downscale_factor)
        # floor at one VAE stride: a working dim under 1.5 strides would
        # otherwise snap to a zero-height pass-1 grid
        return max(sf, xh - (xh % sf)), max(sf, xw - (xw % sf))

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds,
        prompt_mask,
        height: int,
        width: int,
        num_frames: int,
        first_pass: dict,
        second_pass: dict,
        generator: Optional[torch.Generator] = None,
        output_type: str = "latent",
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        noise_pass1: Optional[torch.Tensor] = None,
        noise_pass2: Optional[torch.Tensor] = None,
        on_stage=None,
        **kwargs,
    ):
        """Both passes; returns what pass 2's ``generate`` returns.
        ``on_stage(name, value)``, if given, is called as ``("pass1",
        None)``, ``("upsample", pass-1 latents)`` and ``("pass2",
        upsampled latents)`` start."""
        from ..utils.observability import stage as _stage

        dh, dw = self.downscaled_dims(height, width)
        if on_stage is not None:
            on_stage("pass1", None)
        with _stage("pass1"):
            latents = self.pipeline.generate(
                prompt_embeds, prompt_mask, height=dh, width=dw,
                num_frames=num_frames, generator=generator,
                output_type="latent", noise=noise_pass1, **first_pass,
                **kwargs)
        if on_stage is not None:
            on_stage("upsample", latents)
        with _stage("upsample_adain"):
            up = upsample_latents(self.upsampler,
                                  self.pipeline.vae.per_channel_statistics,
                                  latents)
            up = adain_filter_latent(up, latents, factor=1.0)

        second = dict(second_pass)
        # pass 2 re-noises the upsampled latents to its first timestep
        ts2 = second.get("timesteps")
        t0 = float(ts2[0]) if ts2 is not None else None
        if on_stage is not None:
            on_stage("pass2", up)
        with _stage("pass2"):
            return self.pipeline.generate(
                prompt_embeds, prompt_mask, height=dh * 2, width=dw * 2,
                num_frames=num_frames, generator=generator,
                media_latents=up, initial_timestep=t0,
                output_type=output_type, decode_timestep=decode_timestep,
                decode_noise_scale=decode_noise_scale, noise=noise_pass2,
                **second, **kwargs)
