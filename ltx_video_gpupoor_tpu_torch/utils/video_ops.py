"""Misc host-side video/image helpers.

Port of ``ltx_video_gpupoor_tpu/utils/video_ops.py``: fps ``resample``
(:18, the one copy in the port: ``utils/vace.py`` imports it),
``remove_background`` (:61) on the port's U2-Net and closed-form matting,
``save_webp`` (:121), and the legacy sincos helpers
``get_timestep_embedding`` (:140) and ``get_3d_sincos_pos_embed`` (:169),
numpy copies. Parity target: the reference's ``wan/utils/utils.py``
(``:33-57``, ``:94-121``, ``:175-203``) and
``ltx_video/models/transformers/embeddings.py``.

One difference from the JAX module, on purpose: ``remove_background``
has no fallback. With ``LTXV_TPU_U2NET_PATH`` set, the port's U2-Net runs
on the card and an error it raises propagates; unset, the images come
back unchanged with one warning naming the variable. JAX falls through a
failed U2-Net to the ``rembg`` package and then to the identity, which on
the card would hide a device fault (ROADMAP, "Differences the port
carries on purpose").
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np

logger = logging.getLogger(__name__)


def resample(
    video_fps: float,
    video_frames_count: int,
    max_target_frames_count: int,
    target_fps: float,
    start_target_frame: int = 0,
) -> list[int]:
    """Map target-fps frame slots onto source frame indices via timestamp
    binning (semantics of ``utils.py:33-57``: slow sources are clamped up
    to the target fps, slot offsets rounded at 1e-5)."""
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


_u2net_cache: dict = {}
_warned: set = set()


def remove_background(images: list[np.ndarray], device=None
                      ) -> list[np.ndarray]:
    """Background removal (``utils.py:94-121``): the U2-Net salience of
    each ``[H, W, 3]`` uint8 image, refined by closed-form alpha matting
    (the reference's ``alpha_matting=True`` + ``erode_size=1``; skipped
    with ``LTXV_TPU_REMBG_MATTING=0``), composited onto white. The model
    is the official ``u2net.pth`` / ``u2netp.pth`` (or a safetensors
    export) at ``LTXV_TPU_U2NET_PATH``, on ``device`` (the card unless told
    the CPU); without the variable the images come back unchanged."""
    path = os.environ.get("LTXV_TPU_U2NET_PATH")
    if not path:
        if "u2net" not in _warned:
            _warned.add("u2net")
            logger.warning("remove_background: LTXV_TPU_U2NET_PATH is not "
                           "set; the images are returned unchanged")
        return images
    from ..models import u2net
    from . import matting

    key = (path, str(device))
    if _u2net_cache.get("key") != key:
        cfg = u2net.U2NETP if "u2netp" in os.path.basename(path) \
            else u2net.U2NET
        _u2net_cache.update(key=key, model=u2net.load_torch_checkpoint(
            path, cfg, device=device))
    model = _u2net_cache["model"]
    refine = os.environ.get("LTXV_TPU_REMBG_MATTING", "1") \
        .strip().lower() not in ("0", "off", "false")
    out = []
    for img in images:
        alpha = u2net.salience_map(model, img)
        if refine:
            alpha = matting.refine_alpha(img, alpha, erode_size=1)
        alpha = alpha[..., None]
        # white-composite, as the reference's bgcolor=[255, 255, 255, 0]
        # + convert('RGB')
        out.append(np.clip(
            img.astype(np.float32) * alpha + 255.0 * (1 - alpha),
            0, 255).astype(np.uint8))
    return out


def save_webp(frames: np.ndarray, path: str, fps: float = 16.0) -> str:
    """Animated webp writer (``utils.py:175-203``)."""
    from PIL import Image

    if frames.dtype != np.uint8:
        frames = np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)
    images = [Image.fromarray(f) for f in frames]
    images[0].save(
        path, save_all=True, append_images=images[1:],
        duration=int(1000 / fps), loop=0, lossless=False, quality=85,
    )
    return path


# ---------------------------------------------------------------------------
# Legacy sincos position embeddings (embeddings.py)
# ---------------------------------------------------------------------------

def get_timestep_embedding(
    timesteps: np.ndarray,
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: float = 10000.0,
) -> np.ndarray:
    """DDPM sinusoidal embedding (``embeddings.py:10-50``)."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * np.arange(half) / (
        half - downscale_freq_shift
    )
    emb = np.exp(exponent)[None, :] * np.asarray(timesteps, np.float32)[:, None]
    emb = scale * emb
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=-1)
    if flip_sin_to_cos:
        emb = np.concatenate([emb[:, half:], emb[:, :half]], axis=-1)
    if embedding_dim % 2 == 1:
        emb = np.pad(emb, [(0, 0), (0, 1)])
    return emb


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int, grid: np.ndarray, w: int, h: int, f: int
) -> np.ndarray:
    """Legacy 3D sincos table (``embeddings.py:53-74``): grid [3, N] of
    (f, h, w) coordinates -> [N, embed_dim] with dims split per axis."""
    assert embed_dim % 3 == 0 or embed_dim % 3 == 1
    d = embed_dim // 3
    d = d + (d % 2)  # even per-axis dims
    parts = [_sincos_1d(d, np.asarray(grid[i], np.float64)) for i in range(3)]
    # channel order [emb_h, emb_w, emb_f] (``embeddings.py:71-76``) —
    # grid rows are (f, h, w), so reorder before concat or a trained
    # checkpoint reads frame sinusoids in its height channels
    emb = np.concatenate([parts[1], parts[2], parts[0]], axis=1)
    if emb.shape[1] > embed_dim:
        emb = emb[:, :embed_dim]
    elif emb.shape[1] < embed_dim:
        emb = np.pad(emb, [(0, 0), (0, embed_dim - emb.shape[1])])
    return emb.astype(np.float32)
