"""VACE's media preprocessing and its encoders.

Port of ``ltx_video_gpupoor_tpu/utils/vace.py`` (:24-181): the host-side
numpy preprocessing is the port's own copy (``resize_crop``,
``VaceVideoProcessor`` with the frame resampling of
``utils/video_ops.py::resample``), held equal to the JAX package's by
``tests/test_torch_wan_vace.py``; ``vace_encode_frames`` runs over the
port's Wan VAE encoder (``models/wan/vae.py::encode``), and
``vace_encode_masks`` / ``vace_latent`` are tensor ops. Their output,
``vace_latent(z, m)``, is the ``vace_context`` that
``WanPipeline.denoise`` hands to the VACE hint blocks: the inactive and
reactive latents (2 x z channels) and the 8x8 mask phases (64 channels),
96 for the published VACE checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.wan import vae as wan_vae


def resize_crop(video: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``[T, H, W, C]`` uint8 or float -> ``[T, oh, ow, C]``: an
    aspect-preserving bicubic resize (OpenCV's) and a center crop; uint8
    frames come back float32 in [-1, 1]."""
    import cv2

    t, ih, iw, c = video.shape
    scale = max(ow / iw, oh / ih)
    rh, rw = round(scale * ih), round(scale * iw)
    # cv2.resize drops a trailing singleton channel (HxWx1 -> HxW); the
    # reshape keeps a mask video's [T, oh, ow, 1]
    frames = np.stack([
        cv2.resize(f, (rw, rh), interpolation=cv2.INTER_CUBIC)
        .reshape(rh, rw, c)
        for f in video
    ])
    y1 = (rh - oh) // 2
    x1 = (rw - ow) // 2
    frames = frames[:, y1:y1 + oh, x1:x1 + ow]
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 127.5 - 1.0
    return frames


def resample(video_fps: float, video_frames_count: int,
             max_target_frames_count: int, target_fps: float,
             start_target_frame: int = 0) -> list[int]:
    """Source frame indices for the slots of a ``target_fps`` clip, by
    timestamp binning: a slower source is taken at the target fps, slot
    offsets are rounded at 1e-5."""
    if video_fps < target_fps:
        video_fps = target_fps
    video_frame_duration = 1 / video_fps
    target_frame_duration = 1 / target_fps
    target_time = start_target_frame * target_frame_duration
    frame_no = math.ceil(target_time / video_frame_duration)
    cur_time = frame_no * video_frame_duration
    frame_ids: list[int] = []
    while True:
        if max_target_frames_count != 0 and \
                len(frame_ids) >= max_target_frames_count:
            break
        diff = round((target_time - cur_time) / video_frame_duration, 5)
        add_frames_count = math.ceil(diff)
        frame_no += add_frames_count
        if frame_no >= video_frames_count:
            break
        frame_ids.append(frame_no)
        cur_time += add_frames_count * video_frame_duration
        target_time += target_frame_duration
    return frame_ids[:max_target_frames_count] if max_target_frames_count \
        else frame_ids


@dataclasses.dataclass
class VaceVideoProcessor:
    """The fps and area budget of VACE's inputs."""

    downsample: tuple = (4, 8, 8)
    min_area: int = 480 * 832
    max_area: int = 480 * 832
    min_fps: int = 16
    max_fps: int = 24
    zero_start: bool = True
    seq_len: int = 32760
    keep_last: bool = True

    def select_frames(self, fps: float, num_frames: int, max_frames: int = 0,
                      start_frame: int = 0) -> tuple[list[int], float]:
        """Frame ids resampled to the fps budget: ``keep_last`` (the
        serving default) bins timestamps at ``max_fps``; otherwise a
        uniform pick from frame 0 at ``min(fps, max_fps)``."""
        if self.keep_last:
            target_fps = self.max_fps
            ids = resample(fps, num_frames, max_frames or num_frames,
                           target_fps, start_frame)
            return ids, target_fps
        target_fps = min(fps, self.max_fps)
        duration = num_frames / fps
        target_num = int(duration * target_fps)
        ids = [min(round(i * fps / target_fps), num_frames - 1)
               for i in range(target_num)]
        return ids, target_fps

    def budget_dimensions(self, h: int, w: int, num_frames: int):
        """(height, width) scaled down so that the token count fits
        ``seq_len``, floored to the latent stride (rounding could
        overshoot the budget)."""
        df, dh, dw = self.downsample
        lat_frames = (num_frames - 1) // df + 1
        max_area = min(self.max_area, self.seq_len * dh * dw // lat_frames)
        area = h * w
        scale = min(1.0, math.sqrt(max_area / area))
        oh = int(h * scale) // dh * dh
        ow = int(w * scale) // dw * dw
        assert (oh // dh) * (ow // dw) * lat_frames <= self.seq_len
        return oh, ow


@torch.no_grad()
def vace_encode_frames(
    vae: wan_vae.WanVAE,
    frames: torch.Tensor,                 # [1, F, H, W, 3]
    ref_images: Optional[Sequence[torch.Tensor]] = None,  # each [1, H, W, 3]
    masks: Optional[torch.Tensor] = None,  # [1, F, H, W, 1] in [0, 1]
) -> torch.Tensor:
    """The latents of the inactive (``frames * (1 - masks)``) and the
    reactive (``frames * masks``) parts, concatenated on channels (the
    whole clip and zeros without masks), with each reference image's
    latent frame (and zeros) before them on the frame axis."""
    dev = next(vae.parameters()).device

    def enc(video):
        return wan_vae.encode(vae, video.to(dev, torch.float32)).float()

    frames = frames.to(dev, torch.float32)
    if masks is None:
        latents = enc(frames)
        latents = torch.cat([latents, torch.zeros_like(latents)], dim=-1)
    else:
        masks = masks.to(dev, torch.float32)
        latents = torch.cat([enc(frames * (1 - masks)),
                             enc(frames * masks)], dim=-1)
    if ref_images:
        refs = []
        for ref in ref_images:
            z = enc(ref[:, None])
            refs.append(torch.cat([z, torch.zeros_like(z)], dim=-1))
        latents = torch.cat(refs + [latents], dim=1)
    return latents


def vace_encode_masks(masks: torch.Tensor, vae_stride: tuple = (4, 8, 8),
                      num_refs: int = 0) -> torch.Tensor:
    """``[B, F, H, W, 1]`` masks -> ``[B, F', H', W', dh * dw]``: the dh x
    dw spatial phases of each latent cell as channels (channel ``sh * dw
    + sw``), the frames resampled nearest-exact to the latent count,
    zeros for ``num_refs`` reference frames before them."""
    b, f, h, w, _ = masks.shape
    df, dh, dw = vae_stride
    new_depth = (f + df - 1) // df
    # the reference's floor of the grid (2 * (H // (stride * 2)))
    hl = 2 * (h // (dh * 2))
    wl = 2 * (w // (dw * 2))
    m = masks[..., 0][:, :, :hl * dh, :wl * dw]
    m = m.reshape(b, f, hl, dh, wl, dw).permute(0, 1, 2, 4, 3, 5).reshape(
        b, f, hl, wl, dh * dw)
    # nearest-exact: src = floor((dst + 0.5) * scale), in float32 as JAX
    idx = torch.floor((torch.arange(new_depth, dtype=torch.float32) + 0.5)
                      * np.float32(f / new_depth)).long().clamp(0, f - 1)
    m = m[:, idx.to(m.device)]
    if num_refs:
        zeros = m.new_zeros((b, num_refs) + tuple(m.shape[2:]))
        m = torch.cat([zeros, m], dim=1)
    return m


def vace_latent(z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The ``vace_context``: latents and masks concatenated on channels."""
    return torch.cat([z, m.to(z.device, z.dtype)], dim=-1)
