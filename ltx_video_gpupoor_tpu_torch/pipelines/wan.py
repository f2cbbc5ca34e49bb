"""Wan 2.1 text-to-video pipeline.

Port of ``ltx_video_gpupoor_tpu/pipelines/wan.py`` (:53-63, :98-505),
t2v only: ``optimized_scale`` (CFG-Zero-star), ``WanPipeline`` with
``latent_shape``, ``_solve_schedule`` (UniPC, Euler), ``_vae_decode``
(spatially tiled at ``vae_tile_size=256`` as in JAX), ``denoise`` (its
``lax.scan`` is a host loop here) in its 1- and 2-stream branches with
the SLG layer-skip window, and ``generate_t2v`` with ``noise=`` injection.

Guidance streams are batch rows: (cond, uncond) in one forward. The
initial noise, unless ``noise=`` is given, comes from an explicit
``torch.Generator``. Not ported (each raises ``NotImplementedError``
naming its ROADMAP entry): the DPM++ solver, i2v, Phantom, ReCamMaster
source latents, VACE, the sliding-window overlap, TeaCache and the
sequence-parallel mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.wan import vae as wan_vae
from ..models.wan.model import WanModel
from ..ops.rope import wan_rope_freqs
from ..schedulers import flowmatch, unipc

_STEP13 = "ROADMAP queue 1 step 13"


def optimized_scale(positive: torch.Tensor,
                    negative: torch.Tensor) -> torch.Tensor:
    """CFG-Zero-star alpha: the projection of cond onto uncond."""
    dot = torch.sum(positive * negative)
    sq = torch.sum(negative * negative) + 1e-8
    return dot / sq


@dataclasses.dataclass
class WanPipeline:
    model: WanModel
    vae: wan_vae.WanVAEDecoder
    vae_stride: tuple = (4, 8, 8)
    num_train_timesteps: int = 1000
    # pixel tile size for the VAE decode; 0 = untiled
    vae_tile_size: int = 256
    sp_mesh: object = None

    def _vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        if self.vae_tile_size:
            return wan_vae.spatial_tiled_decode(
                self.vae, latents, tile_size=self.vae_tile_size)
        return wan_vae.decode(self.vae, latents)

    def _solve_schedule(self, solver: str, steps: int,
                        shift: float) -> torch.Tensor:
        if solver == "unipc":
            return unipc.unipc_sigmas(steps, shift=shift)
        if solver == "dpm++":
            raise NotImplementedError(f"solver 'dpm++': {_STEP13}")
        if solver == "euler":
            sched = flowmatch.make_flowmatch_schedule(steps, shift=shift)
            return torch.cat([sched.sigmas, torch.zeros(1)])
        raise ValueError(f"unsupported solver {solver!r}")

    def latent_shape(self, height, width, frame_num, extra_frames=0):
        return ((frame_num - 1) // self.vae_stride[0] + 1 + extra_frames,
                height // self.vae_stride[1],
                width // self.vae_stride[2])

    @torch.no_grad()
    def denoise(
        self,
        latents: torch.Tensor,           # [1, F', H', W', z]
        context: torch.Tensor,           # [2, text_len, text_dim] (pos, neg)
        context_mask: torch.Tensor,      # [2, text_len]
        sigmas: torch.Tensor,            # [steps + 1]
        *,
        guide_scale: float = 5.0,
        solver: str = "unipc",
        cfg_star_switch: bool = True,
        cfg_zero_step: int = 5,
        slg_layers: Optional[Sequence[int]] = None,
        slg_start: float = 0.0,
        slg_end: float = 1.0,
        enable_riflex: bool = False,
        clip_features=None,
        y=None,
        ref_latents=None,
        ref_latents_neg=None,
        source_latents=None,
        cam_emb=None,
        vace_context=None,
        vace_scale: float = 1.0,
        teacache_mask=None,
        attn_mode: str = "auto",
        overlapped_latents=None,
        overlap_noise: float = 0.0,
    ) -> torch.Tensor:
        """The sampling loop; returns the latents in their dtype (fp32)."""
        cfg = self.model.cfg
        for name, val in (("clip_features (i2v)", clip_features),
                          ("y (i2v)", y),
                          ("ref_latents (Phantom)", ref_latents),
                          ("ref_latents_neg (Phantom)", ref_latents_neg),
                          ("source_latents (ReCamMaster)", source_latents),
                          ("cam_emb (ReCamMaster)", cam_emb),
                          ("vace_context", vace_context),
                          ("teacache_mask", teacache_mask),
                          ("overlapped_latents", overlapped_latents)):
            if val is not None:
                raise NotImplementedError(f"Wan denoise {name}: {_STEP13}")
        if self.sp_mesh is not None:
            raise NotImplementedError(
                "the sequence-parallel mesh is ROADMAP queue 1 step 15")
        if solver == "dpm++":
            raise NotImplementedError(f"solver 'dpm++': {_STEP13}")
        if solver not in ("unipc", "euler"):
            raise ValueError(f"unsupported solver {solver!r}")
        dev = next(self.model.parameters()).device
        num_steps = sigmas.shape[0] - 1
        sigmas = sigmas.to(device=dev, dtype=torch.float32)
        f_all = latents.shape[1]
        h_tok = latents.shape[2] // cfg.patch_size[1]
        w_tok = latents.shape[3] // cfg.patch_size[2]
        freqs = wan_rope_freqs((f_all, h_tok, w_tok), head_dim=cfg.head_dim,
                               enable_riflex=enable_riflex, device=dev)

        # SLG keep mask per step: the reference skips the slg layers of the
        # uncond stream only (stream 0 is cond)
        num_streams = 2 if guide_scale != 1 else 1
        keep_steps = np.ones((num_steps, cfg.num_layers, num_streams),
                             np.float32)
        if slg_layers is not None and num_streams > 1:
            lo, hi = int(slg_start * num_steps), int(slg_end * num_steps)
            for i in range(lo, min(hi, num_steps)):
                for layer in slg_layers:
                    keep_steps[i, layer, 1:] = 0.0
        keep_steps = torch.from_numpy(keep_steps)

        context = context.to(dev)
        context_mask = context_mask.to(dev)
        if num_streams == 1:
            context, context_mask = context[0:1], context_mask[0:1]
        x = latents.to(dev)
        state = (unipc.unipc_init(x.shape, device=dev)
                 if solver == "unipc" else None)
        for i in range(num_steps):
            t = (sigmas[i] * self.num_train_timesteps).expand(num_streams)
            xs = torch.cat([x] * num_streams) if num_streams > 1 else x
            out, _ = self.model(xs, t, context, context_mask, freqs,
                                slg_keep=keep_steps[i], attn_mode=attn_mode)
            out = out[:, :latents.shape[1]].float()
            if num_streams == 2:
                cond, uncond = out[0:1], out[1:2]
                if cfg_star_switch and i > cfg_zero_step:
                    # the reference's executed behaviour: early steps skip
                    # the alpha rescale of the uncond stream, then plain CFG
                    uncond = uncond * optimized_scale(cond, uncond)
                noise_pred = uncond + guide_scale * (cond - uncond)
            else:
                noise_pred = out
            if solver == "unipc":
                state, x = unipc.unipc_step(state, noise_pred, x, i, sigmas,
                                            num_steps)
            else:
                x = (x.float() + (sigmas[i + 1] - sigmas[i]) * noise_pred
                     ).to(x.dtype)
        return x

    def generate_t2v(
        self,
        context: torch.Tensor,
        context_mask: torch.Tensor,
        width: int = 832,
        height: int = 480,
        frame_num: int = 81,
        sampling_steps: int = 50,
        shift: float = 5.0,
        solver: str = "unipc",
        guide_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        enable_riflex: bool = False,
        output_type: str = "latent",
        teacache_multiplier: float = 0.0,
        return_latent_slice=None,
        noise: Optional[torch.Tensor] = None,
        on_stage=None,
        **denoise_kwargs,
    ) -> torch.Tensor:
        """Text-to-video: latents ``[1, F', H', W', z]`` (``output_type
        ="latent"``) or the decoded video ``[1, F, H, W, 3]`` in [-1, 1].
        ``on_stage(name, tensor)``, if given, is called as each stage
        starts: ``"denoise"`` with the noise, ``"decode"`` with the
        latents."""
        if teacache_multiplier > 0:
            raise NotImplementedError(f"TeaCache: {_STEP13}")
        if return_latent_slice is not None:
            raise NotImplementedError(
                f"return_latent_slice (sliding window): {_STEP13}")
        dev = next(self.model.parameters()).device
        f_lat, h_lat, w_lat = self.latent_shape(height, width, frame_num)
        if noise is None:
            noise = torch.randn((1, f_lat, h_lat, w_lat, self.vae.cfg.z_dim),
                                generator=generator, dtype=torch.float32,
                                device=dev if generator is None
                                else generator.device)
        sigmas = self._solve_schedule(solver, sampling_steps, shift)
        if on_stage is not None:
            on_stage("denoise", noise)
        latents = self.denoise(
            noise.to(device=dev, dtype=torch.float32), context, context_mask,
            sigmas, guide_scale=guide_scale, solver=solver,
            enable_riflex=enable_riflex, **denoise_kwargs)
        if output_type == "latent":
            return latents
        if on_stage is not None:
            on_stage("decode", latents)
        with torch.no_grad():
            return self._vae_decode(latents)
