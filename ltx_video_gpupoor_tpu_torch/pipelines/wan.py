"""Wan 2.1 pipelines: text-to-video, image-to-video, Phantom, VACE,
ReCamMaster and the sliding window.

Port of ``ltx_video_gpupoor_tpu/pipelines/wan.py``:
``TEACACHE_COEFFICIENTS`` (:41), ``optimized_scale`` (CFG-Zero-star),
``teacache_skip_schedule`` (:65, on ``pipelines/teacache.py``'s
``calibrate_mask``), ``WanPipeline`` with ``latent_shape``,
``_solve_schedule`` (UniPC, DPM++, Euler), ``_vae_decode`` (spatially
tiled at ``vae_tile_size=256`` as in JAX), ``denoise`` (its ``lax.scan``
is a host loop here) with the SLG layer-skip window, TeaCache's
precomputed skip mask, i2v's CLIP features and conditioning channels,
Phantom's three guidance streams over appended reference frames
(:204-260), ReCamMaster's source latents and poses, the VACE context and
the sliding window's overlapped latents with the VACE context's
overlap-noise floor (:328-383, the clean restore :440-443),
``generate_t2v`` (with TeaCache and ``return_latent_slice``, :499-503),
``prepare_i2v_conditioning`` (:507) and ``generate_i2v`` (:537), both
entry points with ``noise=`` injection.

Guidance streams are batch rows: (cond, uncond) in one forward. The
initial noise, unless ``noise=`` is given, comes from an explicit
``torch.Generator``, as do the sliding window's per-step noises unless
``overlap_noises=`` hands them over (JAX draws them from per-step keys).
A skipped TeaCache step runs no block and reuses the last computed
residual. Sequence parallelism (:106-133, :218-231, :295-299): with
``sp_mesh`` set every denoiser evaluation runs ``parallel/usp.py``'s
``usp_wan_forward`` on this rank's frames and the velocity shards are
joined; frames, heads or a temporal patch that do not divide over sp log
a warning and run the request unsharded. ``mesh`` (or ``sp_mesh``) of
several ranks spreads the tiled decode over them
(``models/wan/vae.py::parallel_spatial_tiled_decode``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.wan import model as wan_model
from ..models.wan import vae as wan_vae
from ..models.wan.model import WanModel
from ..ops.rope import wan_rope_freqs
from ..schedulers import dpm, flowmatch, unipc
from . import teacache

# The published TeaCache polynomial coefficients of the Wan 2.1 family
# (JAX :41-52).
TEACACHE_COEFFICIENTS = {
    "t2v_1.3B": [2.39676752e03, -1.31110545e03, 2.01331979e02,
                 -8.29855975e00, 1.37887774e-01],
    "t2v_14B": [-5784.54975374, 5449.50911966, -1811.16591783,
                256.27178429, -13.02252404],
    "i2v_480p": [-3.02331670e02, 2.23948934e02, -5.25463970e01,
                 5.87348440e00, -2.01973289e-01],
    "i2v_720p": [-114.36346466, 65.26524496, -18.82220707,
                 4.91518089, -0.23412683],
}


def randn(shape, generator, device) -> torch.Tensor:
    """fp32 normal noise on ``device``, drawn from ``generator`` (on its
    own device) if given."""
    gdev = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=gdev).to(device)


def optimized_scale(positive: torch.Tensor,
                    negative: torch.Tensor) -> torch.Tensor:
    """CFG-Zero-star alpha: the projection of cond onto uncond."""
    dot = torch.sum(positive * negative)
    sq = torch.sum(negative * negative) + 1e-8
    return dot / sq


@torch.no_grad()
def teacache_skip_schedule(model: WanModel, timesteps, coefficients,
                           multiplier: float, start_step: int = 0
                           ) -> np.ndarray:
    """The boolean compute mask of the steps: the time embedding of each
    timestep (through the model's own ``time_embedding``, in its tier)
    into ``teacache.calibrate_mask``, which computes about ``len /
    multiplier`` steps."""
    dev = next(model.parameters()).device
    t = torch.as_tensor(np.asarray(timesteps, np.float32), device=dev)
    emb = wan_model.sinusoidal_embedding_1d(model.cfg.freq_dim, t)
    te = model.time_embedding
    e = te.fc2(torch.nn.functional.silu(te.fc1(emb)))
    return teacache.calibrate_mask(e.float().cpu().numpy(), multiplier,
                                   coefficients, start_step)


def sp_fallback(sp_mesh, sp_axis: str, cfg, frames: int):
    """``sp_mesh``, or None (with a warning) where the frames, the heads or
    the temporal patch do not divide over its sp axis: the request then
    runs unsharded (a decision of shapes alone, so every rank takes it)."""
    if sp_mesh is None:
        return None
    from ..core.mesh import axis_size

    sp = axis_size(sp_mesh, sp_axis)
    if cfg.patch_size[0] != 1 or frames % sp or cfg.num_heads % sp:
        import logging

        logging.getLogger(__name__).warning(
            "sp-mesh fallback: frames=%d heads=%d patch_t=%d do not divide "
            "sp=%d; running this request single-device", frames,
            cfg.num_heads, cfg.patch_size[0], sp)
        return None
    return sp_mesh


@dataclasses.dataclass
class WanPipeline:
    model: WanModel
    # a WanVAE (with its encoder) for i2v, the decoder half for t2v
    vae: wan_vae.WanVAEDecoder
    vae_stride: tuple = (4, 8, 8)
    num_train_timesteps: int = 1000
    # pixel tile size for the VAE decode; 0 = untiled
    vae_tile_size: int = 256
    # sequence parallelism: every denoiser evaluation runs usp_wan_forward
    # over `sp_axis` of this mesh (frames sharded)
    sp_mesh: object = None
    sp_axis: str = "sp"
    # the whole serving mesh: the tiled decode spreads over every rank
    mesh: object = None
    # the encoders a loader found (serving/model_zoo.py::load_wan_model):
    # the pipeline takes UMT5 embeddings and CLIP features, which callers
    # compute with models/t5.py::encode and models/wan/clip.py::visual
    t5: object = None
    clip: object = None
    # a loader's readers and seconds by stage
    load_stats: dict = dataclasses.field(default_factory=dict)

    def _vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        if self.vae_tile_size:
            mesh = self.mesh if self.mesh is not None else self.sp_mesh
            if mesh is not None and mesh.size() > 1:
                return wan_vae.parallel_spatial_tiled_decode(
                    mesh, self.vae, latents, tile_size=self.vae_tile_size)
            return wan_vae.spatial_tiled_decode(
                self.vae, latents, tile_size=self.vae_tile_size)
        return wan_vae.decode(self.vae, latents)

    def _solve_schedule(self, solver: str, steps: int,
                        shift: float) -> torch.Tensor:
        if solver == "unipc":
            return unipc.unipc_sigmas(steps, shift=shift)
        if solver == "dpm++":
            return dpm.dpm_sigmas_from_custom(
                dpm.get_sampling_sigmas(steps, shift))
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
        clip_features: Optional[torch.Tensor] = None,   # [1, 257, 1280]
        y: Optional[torch.Tensor] = None,     # i2v cond [1, F', H', W', 20]
        ref_latents: Optional[torch.Tensor] = None,   # Phantom [1, R, H', W', z]
        ref_latents_neg: Optional[torch.Tensor] = None,
        source_latents: Optional[torch.Tensor] = None,  # ReCamMaster
        cam_emb: Optional[torch.Tensor] = None,          # [1, F'', 12]
        vace_context: Optional[torch.Tensor] = None,  # [1, F', H', W', C]
        vace_scale: float = 1.0,
        teacache_mask: Optional[np.ndarray] = None,    # [steps] bool
        attn_mode: str = "auto",
        overlapped_latents: Optional[torch.Tensor] = None,  # [1, n+1, ...]
        overlap_noise: float = 0.0,
        overlap_noises: Optional[Sequence] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The sampling loop; returns the latents in their dtype (fp32).
        ``teacache_mask[i]`` False skips step i's block stack (the last
        computed residual is reused); the first step must compute.

        Guidance streams are batch rows: (cond, uncond), or Phantom's
        three (text + reference images, reference images alone, the
        negative reference images) where ``ref_latents`` is given and
        ``guide_scale != 1``; the reference frames are appended after the
        latent frames and stripped from the output. ReCamMaster's
        ``source_latents`` are appended the same way (RoPE then runs over
        both), with the poses ``cam_emb``. ``vace_context`` feeds the VACE
        hint blocks. ``overlapped_latents`` (a sliding window's tail,
        boundary frame included) replaces the leading latent frames at
        every step, noised to the step's level, and is restored clean at
        the end; with a VACE context and ``overlap_noise > 0`` the
        context's leading frames and z channels are re-noised from their
        clean values at the fixed level ``overlap_noise / 1000`` each
        step. The noises of a step, ``(x_noise, vace_noise or None)``,
        are ``overlap_noises[i]`` where given (JAX draws them from
        per-step keys), else drawn from ``generator``."""
        cfg = self.model.cfg
        if solver not in ("unipc", "dpm++", "euler"):
            raise ValueError(f"unsupported solver {solver!r}")
        dev = next(self.model.parameters()).device
        num_steps = sigmas.shape[0] - 1
        sigmas = sigmas.to(device=dev, dtype=torch.float32)
        f_lat = latents.shape[1]
        # guide_scale 1 outranks Phantom, as in the reference: one cond
        # pass on the bare latents
        phantom = ref_latents is not None and guide_scale != 1
        f_all = f_lat + (ref_latents.shape[1] if phantom else 0)
        if source_latents is not None:
            f_all = f_lat + source_latents.shape[1]
        h_tok = latents.shape[2] // cfg.patch_size[1]
        w_tok = latents.shape[3] // cfg.patch_size[2]
        freqs = wan_rope_freqs((f_all, h_tok, w_tok), head_dim=cfg.head_dim,
                               enable_riflex=enable_riflex, device=dev)
        sp_mesh = sp_fallback(self.sp_mesh, self.sp_axis, cfg, f_all)

        # SLG keep mask per step: the reference skips the slg layers of the
        # unconditional streams (stream 0 is the conditional one)
        num_streams = 3 if phantom else (2 if guide_scale != 1 else 1)
        keep_steps = np.ones((num_steps, cfg.num_layers, num_streams),
                             np.float32)
        if slg_layers is not None and num_streams > 1:
            lo, hi = int(slg_start * num_steps), int(slg_end * num_steps)
            for i in range(lo, min(hi, num_steps)):
                for layer in slg_layers:
                    keep_steps[i, layer, 1:] = 0.0
        keep_steps = torch.from_numpy(keep_steps)

        tc_mask = (np.ones(num_steps, bool) if teacache_mask is None
                   else np.asarray(teacache_mask, bool))
        if not tc_mask[0]:
            raise ValueError("teacache_mask: the first step must compute")

        context = context.to(dev)
        context_mask = context_mask.to(dev)
        if phantom:   # (text, ref), (null, ref), (null, negative ref)
            context = context[[0, 1, 1]]
            context_mask = context_mask[[0, 1, 1]]
        elif num_streams == 1:
            context, context_mask = context[0:1], context_mask[0:1]

        def streams(t):
            return None if t is None else torch.cat(
                [t.to(dev, torch.float32)] * num_streams)

        clip = streams(clip_features)
        ys = streams(y)
        tail = streams(source_latents)
        refs = None
        if phantom:
            refs = torch.cat([ref_latents, ref_latents, ref_latents_neg]).to(
                dev, torch.float32)
        vctx = streams(vace_context)
        x = latents.to(dev)
        n_over = 0
        if overlapped_latents is not None:
            overlapped_latents = overlapped_latents.to(dev, x.dtype)
            n_over = overlapped_latents.shape[1]
            renoise_vace = vace_context is not None and overlap_noise > 0
            z = overlapped_latents.shape[-1]
        state = (unipc.unipc_init(x.shape, device=dev) if solver == "unipc"
                 else dpm.dpm_init(x.shape, device=dev)
                 if solver == "dpm++" else None)
        residual = None
        for i in range(num_steps):
            t_scalar = sigmas[i] * self.num_train_timesteps
            vctx_i = vctx
            if n_over:
                if overlap_noises is not None:
                    x_noise, v_noise = overlap_noises[i]
                else:
                    x_noise = randn(overlapped_latents.shape, generator, dev)
                    v_noise = (randn((1, n_over) + vace_context.shape[2:4]
                                     + (z,), generator, dev)
                               if renoise_vace else None)
                factor = t_scalar / self.num_train_timesteps
                x = x.clone()
                x[:, :n_over] = (overlapped_latents * (1 - factor)
                                 + x_noise.to(dev, x.dtype) * factor)
                if renoise_vace:
                    onf = overlap_noise / self.num_train_timesteps
                    v = vace_context.to(dev, torch.float32).clone()
                    snap = v[:, :n_over, :, :, :z]
                    v[:, :n_over, :, :, :z] = (
                        snap * (1 - onf) + v_noise.to(dev, v.dtype) * onf)
                    vctx_i = streams(v)
            xs = torch.cat([x] * num_streams) if num_streams > 1 else x
            if refs is not None:
                xs = torch.cat([xs, refs], dim=1)
            if tail is not None:
                xs = torch.cat([xs, tail], dim=1)
            if ys is not None:
                xs = torch.cat([xs, ys], dim=-1)
            fwd = dict(clip_features=clip, vace_context=vctx_i,
                       vace_scale=vace_scale, slg_keep=keep_steps[i],
                       cam_emb=cam_emb, previous_residual=residual,
                       compute=bool(tc_mask[i]), attn_mode=attn_mode)
            ts = t_scalar.expand(num_streams)
            if sp_mesh is not None:
                from ..parallel.usp import gather, usp_wan_forward

                out, residual = usp_wan_forward(
                    sp_mesh, self.model, xs, ts, context, context_mask,
                    freqs, axis_name=self.sp_axis, **fwd)
                out = gather(sp_mesh, out, 1, self.sp_axis)
            else:
                out, residual = self.model(xs, ts, context, context_mask,
                                           freqs, **fwd)
            del xs
            out = out[:, :f_lat].float()    # strip reference / source frames
            if phantom:
                pos_it, pos_i, neg = out[0:1], out[1:2], out[2:3]
                noise_pred = (neg + 5.0 * (pos_i - neg)
                              + guide_scale * (pos_it - pos_i))
            elif num_streams == 2:
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
            elif solver == "dpm++":
                state, x = dpm.dpm_step(state, noise_pred, x, i, sigmas,
                                        num_steps)
            else:
                x = (x.float() + (sigmas[i + 1] - sigmas[i]) * noise_pred
                     ).to(x.dtype)
        if n_over:   # the clean overlapped latents back in place
            x = x.clone()
            x[:, :n_over] = overlapped_latents
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
        teacache_model: str = "t2v_14B",
        return_latent_slice=None,
        noise: Optional[torch.Tensor] = None,
        on_stage=None,
        **denoise_kwargs,
    ) -> torch.Tensor:
        """Text-to-video: latents ``[1, F', H', W', z]`` (``output_type
        ="latent"``) or the decoded video ``[1, F, H, W, 3]`` in [-1, 1].
        ``teacache_multiplier > 0`` skips steps by TeaCache's schedule
        with ``TEACACHE_COEFFICIENTS[teacache_model]``.
        ``on_stage(name, tensor)``, if given, is called as each stage
        starts: ``"denoise"`` with the noise, ``"decode"`` with the
        latents. ``return_latent_slice`` (a sliding window's
        continuation) returns ``{"x": the result, "latent_slice": latents[:,
        return_latent_slice]}``. ``generator`` also draws the overlap
        noises of a sliding window (:meth:`denoise`)."""
        noise = self._noise(noise, generator, height, width, frame_num)
        sigmas = self._solve_schedule(solver, sampling_steps, shift)
        tc_mask = None
        if teacache_multiplier > 0:
            tc_mask = teacache_skip_schedule(
                self.model, sigmas[:-1].numpy() * self.num_train_timesteps,
                TEACACHE_COEFFICIENTS[teacache_model], teacache_multiplier)
        if on_stage is not None:
            on_stage("denoise", noise)
        latents = self.denoise(
            noise, context, context_mask, sigmas, guide_scale=guide_scale,
            solver=solver, enable_riflex=enable_riflex, teacache_mask=tc_mask,
            generator=generator, **denoise_kwargs)
        result = self._output(latents, output_type, on_stage)
        if return_latent_slice is not None:
            return {"x": result, "latent_slice": latents[:, return_latent_slice]}
        return result

    def _noise(self, noise, generator, height, width, frame_num):
        """The initial latents, fp32 on the model's device: ``noise`` or a
        draw from ``generator``."""
        dev = next(self.model.parameters()).device
        if noise is None:
            f_lat, h_lat, w_lat = self.latent_shape(height, width, frame_num)
            noise = randn((1, f_lat, h_lat, w_lat, self.vae.cfg.z_dim),
                          generator, dev)
        return noise.to(device=dev, dtype=torch.float32)

    def _output(self, latents, output_type, on_stage):
        if output_type == "latent":
            return latents
        if on_stage is not None:
            on_stage("decode", latents)
        with torch.no_grad():
            return self._vae_decode(latents)

    @torch.no_grad()
    def prepare_i2v_conditioning(
        self,
        first_frame: torch.Tensor,        # [H, W, 3] in [-1, 1]
        height: int,
        width: int,
        frame_num: int,
        last_frame: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The i2v ``y`` ``[1, F', H', W', 4 + z]``: the frame mask (1 on
        the given frames, each latent frame's 4 pixel frames as 4
        channels; the first pixel frame repeated 4 times) and the VAE
        latents of [first, zeros..., (last)], encoded as one clip (JAX
        encodes it untiled; :func:`~..models.wan.vae.encode` runs it a few
        frames at a time inside each layer, the same function)."""
        if not hasattr(self.vae, "encoder"):
            raise ValueError("i2v conditioning needs a VAE with its encoder "
                             "(models/wan/vae.py::WanVAE)")
        f_lat, h_lat, w_lat = self.latent_shape(height, width, frame_num)
        ts = self.vae_stride[0]
        msk = np.ones((frame_num, h_lat, w_lat, 1), np.float32)
        msk[1:] = 0.0
        if last_frame is not None:
            msk[-1] = 1.0
        msk = np.concatenate([np.repeat(msk[:1], ts, axis=0), msk[1:]], 0)
        msk = msk.reshape(msk.shape[0] // ts, ts, h_lat, w_lat, 1)
        msk = np.transpose(msk, (0, 4, 2, 3, 1))[:, 0]   # [F', H', W', ts]
        dev = next(self.model.parameters()).device
        video = torch.zeros(1, frame_num, height, width, 3, device=dev)
        video[0, 0] = first_frame.to(dev)
        if last_frame is not None:
            video[0, -1] = last_frame.to(dev)
        lat = wan_vae.encode(self.vae, video).float()
        del video
        return torch.cat([torch.from_numpy(msk)[None].to(dev), lat], dim=-1)

    def generate_i2v(
        self,
        context: torch.Tensor,
        context_mask: torch.Tensor,
        clip_features: torch.Tensor,      # [1, 257, 1280]
        first_frame: torch.Tensor,        # [H, W, 3] in [-1, 1]
        width: int = 832,
        height: int = 480,
        frame_num: int = 81,
        sampling_steps: int = 40,
        shift: float = 5.0,
        solver: str = "unipc",
        guide_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        last_frame: Optional[torch.Tensor] = None,
        output_type: str = "latent",
        noise: Optional[torch.Tensor] = None,
        on_stage=None,
        **denoise_kwargs,
    ) -> torch.Tensor:
        """Image-to-video: the first frame (and optionally the last)
        conditions the latents through ``y`` and the CLIP features through
        the DiT's image cross-attention. Returns as ``generate_t2v``;
        ``on_stage`` also sees ``"encode"`` (with the first frame) before
        the VAE encode."""
        noise = self._noise(noise, generator, height, width, frame_num)
        if on_stage is not None:
            on_stage("encode", first_frame)
        y = self.prepare_i2v_conditioning(first_frame, height, width,
                                          frame_num, last_frame)
        sigmas = self._solve_schedule(solver, sampling_steps, shift)
        if on_stage is not None:
            on_stage("denoise", noise)
        latents = self.denoise(
            noise, context, context_mask, sigmas, guide_scale=guide_scale,
            solver=solver, clip_features=clip_features, y=y,
            **denoise_kwargs)
        return self._output(latents, output_type, on_stage)
