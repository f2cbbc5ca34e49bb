"""LTX-Video generation pipeline (single-scale pass): text-, image- and
video-to-video.

Port of ``ltx_video_gpupoor_tpu/pipelines/ltx_pipeline.py``:
``ConditioningItem`` (:54), ``latent_to_pixel_coords`` (:64),
``_decode_full`` (:109) with decode-timestep noise and the tiled decode,
``prepare_conditioning`` (:158: in-grid items and the extra-token prefix
of a non-first item) and ``apply_conditioning`` (:241),
``GuidanceSchedule`` and ``build_guidance_schedule`` (:264-383),
``denoise`` (:418-655; its ``lax.scan`` is a host loop here) with CFG,
CFG-star, STG, rescaling and the per-step noise refresh of conditioned
tokens (``image_cond_noise_scale``), ``LTXPipeline.generate`` (:711:
conditioning items, ``media_latents`` / ``initial_timestep``, the extra
frame groups; ``noise=`` injection kept), ``_decode_tiles`` (:885) and
``LTXPipeline.decode`` (:917).

Randomness comes from one explicit ``torch.Generator`` on the latents'
device: the initial noise (unless ``noise=`` is given), the noise of each
extra conditioning token block, then per step the conditioning-noise
refresh and the stochastic sampling noise, and last the decode noise,
drawn in that order. TeaCache: ``ltx_teacache_schedule`` (:384) and
``denoise``'s ``teacache_mask`` with the residual carried across steps
(:509-511, :548-574). Not ported yet: sequence parallelism and the
multi-chip tiled decode (ROADMAP queue 1 step 15).
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
    timestep_embedding,
)
from ..schedulers import rf
from . import teacache


@dataclasses.dataclass
class ConditioningItem:
    """In-grid conditioning media: pixels ``[F, H, W, C]`` in [-1, 1]
    placed at ``frame_number`` (which must map onto the latent grid)."""

    media: np.ndarray | torch.Tensor
    frame_number: int = 0
    strength: float = 1.0


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


def resize_bilinear(frames: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` frames with half-pixel
    centres, antialiased where it shrinks (what ``jax.image.resize(...,
    "bilinear")`` computes)."""
    lead = frames.shape[:-3]
    flat = frames.reshape(-1, *frames.shape[-3:]).permute(0, 3, 1, 2)
    flat = torch.nn.functional.interpolate(
        flat, size=(height, width), mode="bilinear", align_corners=False,
        antialias=True)
    return flat.permute(0, 2, 3, 1).reshape(*lead, height, width, -1)


def encode_media(vae: ltx_vae.CausalVAE, media: torch.Tensor) -> torch.Tensor:
    """Pixels ``[B, F, H, W, C]`` -> normalized latents (the posterior's
    mode) in fp32."""
    if not hasattr(vae, "encoder"):
        raise ValueError("conditioning media need a VAE with its encoder "
                         "(models.ltx.vae.CausalVAE)")
    z = ltx_vae.sample_posterior(ltx_vae.encode(vae, media)).float()
    return ltx_vae.normalize_latents(z, vae.per_channel_statistics)


@torch.no_grad()
def prepare_conditioning(
    init_latents: torch.Tensor,     # [B, F', H', W', C] noise-free latents
    items: Sequence[ConditioningItem],
    vae: ltx_vae.CausalVAE,
    num_prefix_latent_frames: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, list]:
    """Write conditioning latents into the grid. An item at frame 0 lands
    on the grid. Of an item at a later frame, the part beyond a prefix of
    ``num_prefix_latent_frames`` latent frames lands on the grid, and the
    prefix (or a lone frame) becomes extra tokens carried beside the
    sequence. Returns ``(latents, mask [B, F', H', W'], extras)``, each
    extra ``(z [B, fp, H', W', C], frame_number, strength)``."""
    b, f_lat, h_lat, w_lat, c = init_latents.shape
    dev = init_latents.device
    mask = torch.zeros((b, f_lat, h_lat, w_lat), dtype=init_latents.dtype,
                       device=dev)
    latents = init_latents.clone()
    t_factor = vae.cfg.temporal_downscale_factor
    sf = vae.cfg.spatial_downscale_factor
    height, width = h_lat * sf, w_lat * sf
    extras = []
    for item in items:
        media = torch.as_tensor(item.media, dtype=torch.float32, device=dev)
        if media.dim() == 4:
            media = media[None]
        if media.shape[2] != height or media.shape[3] != width:
            # items arrive at the request's size; each pass resizes to its
            # own
            media = resize_bilinear(media, height, width)
        z = encode_media(vae, media).to(latents.dtype)
        if item.frame_number % t_factor:
            raise ValueError(f"conditioning frame {item.frame_number} not "
                             "on the latent grid")
        fz = z.shape[1]
        if item.frame_number == 0:
            latents[:, :fz] = z
            mask[:, :fz] = item.strength
            continue
        fp = min(num_prefix_latent_frames, fz)
        if fz > fp:
            f_start = item.frame_number // t_factor + fp
            if f_start + (fz - fp) > f_lat:
                raise ValueError(
                    f"conditioning item at frame {item.frame_number} "
                    f"extends past the latent grid "
                    f"({f_start + fz - fp} > {f_lat})")
            latents[:, f_start:f_start + fz - fp] = z[:, fp:]
            mask[:, f_start:f_start + fz - fp] = item.strength
        extras.append((z[:, :fp], item.frame_number, item.strength))
    return latents, mask, extras


def apply_conditioning(init_latents, items, vae):
    """The in-grid view of :func:`prepare_conditioning`, for callers that
    carry no extra tokens."""
    latents, mask, extras = prepare_conditioning(init_latents, items, vae)
    if extras:
        raise ValueError("out-of-grid conditioning requires the extra-token "
                         "path (LTXPipeline.generate)")
    return latents, mask


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
@torch.no_grad()
def ltx_teacache_schedule(transformer: LTXTransformer3D, timesteps,
                          multiplier: float, start_step: int = 0
                          ) -> np.ndarray:
    """The per-step compute mask of the LTX DiT (JAX :384-411): the
    adaLN-single timestep embeddings of the schedule, through the model's
    own ``emb_linear_1`` / silu / ``emb_linear_2``, calibrated by
    :func:`.teacache.calibrate_mask`. Computed on the host side of the
    loop: the skip decisions depend only on the timestep list."""
    cfg = transformer.cfg
    dev = transformer.proj_out.bias.device
    t = torch.as_tensor(np.asarray(timesteps, np.float32)
                        * cfg.timestep_scale_multiplier, device=dev)
    emb = timestep_embedding(t, cfg.frequency_embedding_size)
    ada = transformer.adaln
    e = ada.emb_linear_2(torch.nn.functional.silu(ada.emb_linear_1(emb)))
    e_list = e.float().cpu().numpy()
    return teacache.calibrate_mask(e_list, multiplier, start_step=start_step)


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
    init_latents: Optional[torch.Tensor] = None,
    image_cond_noise_scale: float = 0.0,
    teacache_mask: Optional[np.ndarray] = None,   # [steps] bool compute
    interrupt_flag=None,
    progress_callback=None,
) -> torch.Tensor:
    """The denoise loop; the guidance streams are batch rows
    ``[uncond, cond, perturbed]`` of one transformer call per step.
    ``teacache_mask`` (:func:`ltx_teacache_schedule`): a step whose entry
    is False skips the block stack and reuses the residual carried from
    the last step (JAX :509-511, :562-574); step 0 always computes.
    With ``image_cond_noise_scale`` > 0, every step first re-noises the
    fully conditioned tokens around ``init_latents`` (the latents as they
    entered, by default) by ``scale * noise * t**2``. ``interrupt_flag``
    (a callable, ``core.interrupt.InterruptFlag``) is consulted before
    every step and raises ``Interrupted``; ``progress_callback(i,
    n_steps)`` is called after step ``i``."""
    from ..core.interrupt import check
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

    if init_latents is None:
        init_latents = latents
    residual = None
    if teacache_mask is not None:
        teacache_mask = np.asarray(teacache_mask, bool)
        if len(teacache_mask) != len(ts_host) or not teacache_mask[0]:
            raise ValueError("teacache_mask: one entry a step, the first "
                             "True")

    for i in range(len(ts_host)):
        check(interrupt_flag)
        t = float(ts_host[i])
        if image_cond_noise_scale > 0.0:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev, dtype=latents.dtype)
            need = (conditioning_mask > 1.0 - 1e-6)[..., None]
            noised = init_latents + image_cond_noise_scale * noise * (t ** 2)
            latents = torch.where(need, noised, latents)
        t_tokens = torch.minimum(torch.tensor(t, device=dev),
                                 1.0 - conditioning_mask)          # [1, N]
        t_groups = t_tokens.reshape(1, num_frame_groups,
                                    tokens_per_group)[:, :, 0]     # [1, G]
        x = latents.expand(num_conds, -1, -1)
        tg = t_groups.expand(num_conds, -1)
        kw = dict(skip_layer_mask=skip_masks[i],
                  skip_layer_strategy=schedule.skip_layer_strategy,
                  attn_mode=attn_mode, freqs=freqs)
        if teacache_mask is None:
            pred = transformer(x, coords, tg, ctx, ctx_mask, **kw)
        else:
            pred, residual = transformer(
                x, coords, tg, ctx, ctx_mask, previous_residual=residual,
                compute=bool(teacache_mask[i]), return_residual=True, **kw)
        pred = pred.float()

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
        if progress_callback is not None:
            progress_callback(i, len(ts_host))
    return latents


@torch.no_grad()
def decode_full(vae: ltx_vae.CausalVAEDecoder, latent_grid: torch.Tensor,
                decode_timestep: float, decode_noise_scale: float,
                generator: Optional[torch.Generator], z_tile: int = 0,
                hw_tile: int = 0) -> torch.Tensor:
    """Un-normalize, noise to the decode timestep (timestep-conditioned
    VAEs only), decode: tiled if ``z_tile`` or ``hw_tile`` is set."""
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
    if z_tile or hw_tile:
        from ..models.ltx.vae_tiling import tiled_decode

        return tiled_decode(vae, z, z_tile=z_tile, hw_tile=hw_tile,
                            timestep=t, generator=gen)
    return ltx_vae.decode(vae, z, t, gen)


@dataclasses.dataclass
class LTXPipeline:
    """The DiT and the VAE (its decoder; the encoder too where media
    condition the request); methods drive them."""

    transformer: LTXTransformer3D
    vae: ltx_vae.CausalVAEDecoder
    # (z_tile latent frames, hw_tile pixels) of the VAE decode; None =
    # by size: untiled up to 704x480x121 voxels, tiled above
    vae_tile_size: Optional[tuple] = None

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
        conditioning_items: Sequence[ConditioningItem] = (),
        media_latents: Optional[torch.Tensor] = None,
        initial_timestep: Optional[float] = None,
        guidance_scale=3.0,
        stg_scale=0.0,
        rescaling_scale=1.0,
        skip_block_list=None,
        guidance_timesteps=None,
        skip_layer_strategy=SkipLayerStrategy.AttentionValues,
        image_cond_noise_scale: float = 0.0,
        stochastic_sampling: bool = False,
        sampler: str = "Uniform",
        shift: Optional[float] = None,
        shifting: Optional[str] = "SD3",
        target_shift_terminal: Optional[float] = 0.1,
        output_type: str = "latent",
        decode_timestep: float = 0.0,
        decode_noise_scale: Optional[float] = None,
        attn_mode: str = "auto",
        teacache_multiplier: float = 0.0,
        noise: Optional[torch.Tensor] = None,
        interrupt_flag=None,
        progress_callback=None,
    ):
        """Returns the latent grid ``[1, F', H', W', C]`` fp32
        (``output_type="latent"``) or pixels ``[1, F, H, W, 3]``.
        ``teacache_multiplier`` above 1.0 skips steps by
        :func:`ltx_teacache_schedule` (JAX :850-866). ``interrupt_flag``
        and ``progress_callback`` go to :func:`denoise`."""
        from ..utils.observability import stage as _stage

        dev = self.transformer.proj_out.bias.device
        f_lat, h_lat, w_lat = self.latent_shape(height, width, num_frames)
        c = self.transformer.cfg.in_channels
        sched = rf.make_schedule(
            num_inference_steps, sampler=sampler, shift=shift,
            shifting=shifting, n_media_tokens=f_lat * h_lat * w_lat,
            target_shift_terminal=target_shift_terminal, timesteps=timesteps)
        ts = sched.timesteps.numpy()

        if noise is None:
            noise = torch.randn((1, f_lat * h_lat * w_lat, c),
                                generator=generator, device=dev,
                                dtype=torch.float32)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        noise_grid = patchifier.unpatchify(noise, h_lat, w_lat, c)

        if media_latents is not None:
            t0 = float(ts[0]) if initial_timestep is None else initial_timestep
            init = t0 * noise_grid + (1 - t0) * media_latents.to(
                device=dev, dtype=torch.float32)
        else:
            init = noise_grid

        cond_mask_grid = torch.zeros((1, f_lat, h_lat, w_lat),
                                     dtype=torch.float32, device=dev)
        extras = []
        if conditioning_items:
            with _stage("cond_encode", sync=lambda: cond_latents):
                cond_latents, cond_mask_grid, extras = prepare_conditioning(
                    torch.zeros((1, f_lat, h_lat, w_lat, c),
                                dtype=torch.float32, device=dev),
                    conditioning_items, self.vae)
            # lerp(noised init, clean conditioning latents, strength)
            init = init + cond_mask_grid[..., None] * (cond_latents - init)

        tokens, latent_coords = patchifier.patchify(init)
        cond_mask_tokens = cond_mask_grid.reshape(1, -1)
        vcfg = self.vae.cfg
        scale_factors = (vcfg.temporal_downscale_factor,
                         vcfg.spatial_downscale_factor,
                         vcfg.spatial_downscale_factor)
        pixel_coords = latent_to_pixel_coords(
            latent_coords, scale_factors, causal_fix=True).float()

        # out-of-grid conditioning: extra tokens prepended with their own
        # pixel coordinates (the frame axis offset by the media's frame
        # number), mask = strength, latents = lerp(noise, z, strength)
        num_extra_tokens = 0
        extra_frame_groups = 0
        if extras:
            ex_tokens, ex_coords, ex_masks = [], [], []
            for z, frame_number, strength_i in extras:
                zt, z_coords = patchifier.patchify(z.float())
                ex_noise = torch.randn(zt.shape, generator=generator,
                                       device=dev, dtype=torch.float32)
                zt = ex_noise + strength_i * (zt - ex_noise)
                pc = latent_to_pixel_coords(z_coords, scale_factors,
                                            causal_fix=True).float()
                pc[:, 0] = pc[:, 0] + float(frame_number)
                ex_tokens.append(zt)
                ex_coords.append(pc)
                ex_masks.append(torch.full((1, zt.shape[1]), strength_i,
                                           dtype=torch.float32, device=dev))
                extra_frame_groups += z.shape[1]
            tokens = torch.cat(ex_tokens + [tokens], dim=1)
            pixel_coords = torch.cat(ex_coords + [pixel_coords], dim=2)
            cond_mask_tokens = torch.cat(ex_masks + [cond_mask_tokens], dim=1)
            num_extra_tokens = sum(t.shape[1] for t in ex_tokens)

        pixel_coords[:, 0] = pixel_coords[:, 0] * (1.0 / frame_rate)

        schedule = build_guidance_schedule(
            ts, self.transformer.cfg.num_layers,
            guidance_scale=guidance_scale, stg_scale=stg_scale,
            rescaling_scale=rescaling_scale, skip_block_list=skip_block_list,
            guidance_timesteps=guidance_timesteps,
            skip_layer_strategy=skip_layer_strategy)
        tc_mask = None
        if teacache_multiplier and teacache_multiplier > 1.0:
            tc_mask = ltx_teacache_schedule(self.transformer, ts,
                                            teacache_multiplier)
        with _stage("denoise", sync=lambda: latents):
            latents = denoise(
                self.transformer, tokens, cond_mask_tokens, pixel_coords, ts,
                schedule, prompt_embeds, prompt_mask, generator,
                num_frame_groups=f_lat + extra_frame_groups,
                stochastic_sampling=stochastic_sampling, attn_mode=attn_mode,
                init_latents=tokens,
                image_cond_noise_scale=image_cond_noise_scale,
                teacache_mask=tc_mask,
                interrupt_flag=interrupt_flag,
                progress_callback=progress_callback)
        if num_extra_tokens:
            latents = latents[:, num_extra_tokens:]
        latent_grid = patchifier.unpatchify(latents, h_lat, w_lat, c)
        if output_type == "latent":
            return latent_grid
        with _stage("vae_decode", sync=lambda: px):
            px = self.decode(latent_grid, decode_timestep, decode_noise_scale,
                             generator)
        return px

    def _decode_tiles(self, z: torch.Tensor) -> tuple[int, int]:
        """(z_tile, hw_tile) for this latent shape, by a voxel budget:
        untiled up to 704x480x121, temporal tiles of 4 latent frames when
        one such tile fits that budget, else spatial tiles of 512 too."""
        if self.vae_tile_size is not None:
            return self.vae_tile_size
        sf = self.vae.cfg.spatial_downscale_factor
        tf = self.vae.cfg.temporal_downscale_factor
        h, w = z.shape[2] * sf, z.shape[3] * sf
        frames = (z.shape[1] - 1) * tf + 1
        envelope = 704 * 480 * 121
        if h * w * frames <= envelope:
            return (0, 0)
        if h * w * (4 * tf + 1) <= envelope:
            return (4, 0)
        return (4, 512)

    def decode(self, latent_grid, decode_timestep=0.0,
               decode_noise_scale=None, generator=None):
        if decode_noise_scale is None:
            decode_noise_scale = decode_timestep
        z_tile, hw_tile = self._decode_tiles(latent_grid)
        return decode_full(self.vae, latent_grid, decode_timestep,
                           decode_noise_scale, generator, z_tile=z_tile,
                           hw_tile=hw_tile)
