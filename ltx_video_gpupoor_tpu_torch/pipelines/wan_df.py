"""Diffusion-forcing long-video generation (SkyReels-V2).

Port of ``ltx_video_gpupoor_tpu/pipelines/wan_df.py``: ``snap_frame_num``
(frames = 17 + 20k) and ``generate_timestep_matrix`` (:30-97, host numpy,
the port's own copy, held equal to JAX's by
``tests/test_torch_wan_df.py``), and ``WanDFPipeline.generate``
(:100-326): a staggered timestep per latent frame (the DiT's 2-D ``t``
``[B, F]``, one modulation group a frame), causal blocks with an
``ar_step`` lag, a prefix video through the Wan VAE encoder, the
``overlap_noise`` floor on the prefix frames, fps conditioning and an
untiled or spatially tiled decode.

Each latent frame has a UniPC state of its own and a step counter; a
row of the matrix steps the frames its update mask names (JAX vmaps one
step over every frame and merges where the mask is set). Here the
updated frames are grouped by their counter and each group takes one
``unipc_step`` over its frames (the step is elementwise, and a frame's
order follows its counter); a frame that is not updated keeps its
latents and state bit for bit. The per-row prefix noises come from
``generator`` unless ``prefix_noises=`` hands them over (JAX draws them
from per-row keys). ``sp_mesh`` raises naming its ROADMAP entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.wan import vae as wan_vae
from ..models.wan.model import WanModel
from ..ops.rope import wan_rope_freqs
from ..schedulers import unipc
from .wan import randn


def snap_frame_num(frame_num: int) -> int:
    """Frames = 17 + 20k, the nearest to ``frame_num`` (at least 17)."""
    frame_num = max(17, frame_num)
    return int(round((frame_num - 17) / 20) * 20 + 17)


def generate_timestep_matrix(
    num_frames: int,
    step_template: np.ndarray,
    base_num_frames: int,
    ar_step: int = 5,
    num_pre_ready: int = 0,
    causal_block_size: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[tuple[int, int]]]:
    """(step_matrix ``[rows, F]`` timesteps, step_index ``[rows, F]``,
    update_mask ``[rows, F]`` bool, valid_interval ``[(start, end)]``):
    each row advances a frame one step once the frame before it is
    ``ar_step`` steps ahead (whole causal blocks at a time); prefix frames
    start done."""
    num_iterations = len(step_template) + 1
    nfb = num_frames // causal_block_size
    bnfb = base_num_frames // causal_block_size
    if bnfb < nfb:
        min_ar_step = len(step_template) / bnfb
        assert ar_step >= min_ar_step, \
            f"ar_step should be at least {math.ceil(min_ar_step)}"
    template = np.concatenate([
        np.array([999], np.int64),
        np.asarray(step_template, np.int64),
        np.array([0], np.int64),
    ])
    pre_row = np.zeros(nfb, np.int64)
    if num_pre_ready > 0:
        pre_row[: num_pre_ready // causal_block_size] = num_iterations

    step_matrix, step_index, update_mask = [], [], []
    while not np.all(pre_row >= num_iterations - 1):
        new_row = np.zeros(nfb, np.int64)
        for i in range(nfb):
            if i == 0 or pre_row[i - 1] >= num_iterations - 1:
                new_row[i] = pre_row[i] + 1
            else:
                new_row[i] = new_row[i - 1] - ar_step
        new_row = np.clip(new_row, 0, num_iterations)
        update_mask.append((new_row != pre_row) & (new_row != num_iterations))
        step_index.append(new_row.copy())
        step_matrix.append(template[new_row])
        pre_row = new_row

    terminal_flag = bnfb
    valid_interval = []
    for mask in update_mask:
        if terminal_flag < nfb and mask[terminal_flag]:
            terminal_flag += 1
        valid_interval.append((max(terminal_flag - bnfb, 0), terminal_flag))

    sm = np.stack(step_matrix)
    si = np.stack(step_index)
    um = np.stack(update_mask)
    if causal_block_size > 1:
        def rep(a):
            return np.repeat(a[:, :, None], causal_block_size, 2).reshape(
                a.shape[0], -1)

        sm, si, um = rep(sm), rep(si), rep(um.astype(np.int64)).astype(bool)
        valid_interval = [(s * causal_block_size, e * causal_block_size)
                          for s, e in valid_interval]
    return sm, si, um, valid_interval


@dataclasses.dataclass
class WanDFPipeline:
    model: WanModel
    # a WanVAE (with its encoder) for a prefix video, else its decoder half
    vae: wan_vae.WanVAEDecoder
    vae_stride: tuple = (4, 8, 8)
    num_train_timesteps: int = 1000
    # pixel tile size for the decode; None = untiled
    vae_tile_size: Optional[int] = None
    sp_mesh: object = None

    @torch.no_grad()
    def generate(
        self,
        context: torch.Tensor,          # [2, text_len, text_dim] (pos, neg)
        context_mask: torch.Tensor,     # [2, text_len]
        height: int = 480,
        width: int = 832,
        frame_num: int = 97,
        sampling_steps: int = 50,
        shift: float = 1.0,
        guide_scale: float = 5.0,
        ar_step: int = 5,
        causal_block_size: int = 5,
        overlap_noise: int = 0,
        fps: int = 24,
        prefix_video: Optional[torch.Tensor] = None,    # [1, Fp, H, W, 3]
        prefix_latents: Optional[torch.Tensor] = None,  # [1, Fp', H', W', z]
        generator: Optional[torch.Generator] = None,
        output_type: str = "latent",
        attn_mode: str = "auto",
        noise: Optional[torch.Tensor] = None,
        prefix_noises: Optional[Sequence[torch.Tensor]] = None,
        on_stage=None,
    ) -> torch.Tensor:
        """Latents ``[1, F', H', W', z]`` (``output_type="latent"``) or
        the decoded video ``[1, F, H, W, 3]`` in [-1, 1]. ``prefix_video``
        (or its latents) continues a clip: its frames start done, and
        with ``overlap_noise > 0`` the DiT sees them noised at that
        floor each row (the noises ``prefix_noises[row]``, each of the
        latents' shape, else drawn from ``generator``). ``on_stage(name,
        tensor)`` is called as ``"encode"``, ``"denoise"`` and
        ``"decode"`` start."""
        if self.sp_mesh is not None:
            raise NotImplementedError(
                "the sequence-parallel mesh is ROADMAP queue 1 step 15")
        cfg = self.model.cfg
        dev = next(self.model.parameters()).device
        frame_num = snap_frame_num(frame_num)
        f_lat = (frame_num - 1) // self.vae_stride[0] + 1
        h_lat = height // self.vae_stride[1]
        w_lat = width // self.vae_stride[2]
        if ar_step == 0:
            causal_block_size = 1

        prefix_len = 0
        if prefix_latents is None and prefix_video is not None:
            if on_stage is not None:
                on_stage("encode", prefix_video)
            prefix_latents = wan_vae.encode(
                self.vae, prefix_video.to(dev, torch.float32)).float()
        if prefix_latents is not None:
            prefix_len = prefix_latents.shape[1]
            trunc = prefix_len % causal_block_size
            if trunc:
                if trunc == prefix_len:
                    causal_block_size, ar_step = 1, 0
                else:
                    prefix_len -= trunc
                    prefix_latents = prefix_latents[:, :prefix_len]

        sigmas = unipc.unipc_sigmas(sampling_steps, shift=shift)
        init_timesteps = (sigmas[:-1].numpy()          # fp32, as JAX's
                          * self.num_train_timesteps).astype(np.int64)
        sm, _, um, _ = generate_timestep_matrix(
            f_lat, init_timesteps, f_lat, ar_step, prefix_len,
            causal_block_size)
        sigmas = sigmas.to(dev)

        shape = (1, f_lat, h_lat, w_lat, self.vae.cfg.z_dim)
        if noise is None:
            noise = randn(shape, generator, dev)
        latents = noise.to(dev, torch.float32).clone()
        if prefix_latents is not None:
            latents[:, :prefix_len] = prefix_latents.to(dev, torch.float32)

        freqs = wan_rope_freqs(
            (f_lat, h_lat // cfg.patch_size[1], w_lat // cfg.patch_size[2]),
            head_dim=cfg.head_dim, device=dev)
        fps_idx = (0 if fps == 16 else 1) if cfg.inject_sample_info else None
        num_streams = 2 if guide_scale != 1 else 1
        if num_streams == 1:
            context, context_mask = context[0:1], context_mask[0:1]
        context = context.to(dev)
        context_mask = context_mask.to(dev)

        # one UniPC state a latent frame, and its step counter
        z = torch.zeros(shape[1:], device=dev)
        m_prev, m_prev2, last = z.clone(), z.clone(), z.clone()
        lower = np.zeros(f_lat, np.int64)
        counters = np.zeros(f_lat, np.int64)
        noised = overlap_noise > 0 and prefix_len > 0
        nf = 0.001 * overlap_noise
        if on_stage is not None:
            on_stage("denoise", latents)
        for row in range(sm.shape[0]):
            t_row = torch.from_numpy(sm[row].astype(np.float32)).to(dev)
            x = latents
            if noised:
                pn = (prefix_noises[row] if prefix_noises is not None
                      else randn(shape, generator, dev))
                pn = pn.to(dev, torch.float32)
                x = latents.clone()
                x[:, :prefix_len] = (latents[:, :prefix_len] * (1 - nf)
                                     + pn[:, :prefix_len] * nf)
                t_row[:prefix_len] = float(overlap_noise)
            xs = torch.cat([x] * num_streams) if num_streams > 1 else x
            out, _ = self.model(xs, t_row[None].expand(num_streams, -1),
                                context, context_mask, freqs, fps_idx=fps_idx,
                                attn_mode=attn_mode)
            del xs, x
            out = out.float()
            if num_streams == 2:
                noise_pred = out[1:2] + guide_scale * (out[0:1] - out[1:2])
            else:
                noise_pred = out
            del out
            # the frames this row updates, grouped by their step counter
            upd = np.nonzero(um[row])[0]
            for step in np.unique(counters[upd]):
                idx = upd[counters[upd] == step]
                orders = np.unique(lower[idx])
                assert len(orders) == 1, "one order a counter"
                it = torch.from_numpy(idx).to(dev)
                st = unipc.UniPCState(m_prev[it], m_prev2[it], last[it],
                                      int(orders[0]))
                new, frames = unipc.unipc_step(
                    st, noise_pred[0, it], latents[0, it], int(step), sigmas,
                    sampling_steps)
                latents[0, it] = frames
                m_prev[it], m_prev2[it] = new.m_prev, new.m_prev2
                last[it] = new.last_sample
                lower[idx] = new.lower_order_nums
            counters[upd] += 1
            del noise_pred

        if output_type == "latent":
            return latents
        if on_stage is not None:
            on_stage("decode", latents)
        if self.vae_tile_size:
            return wan_vae.spatial_tiled_decode(
                self.vae, latents, tile_size=self.vae_tile_size)
        return wan_vae.decode(self.vae, latents)
