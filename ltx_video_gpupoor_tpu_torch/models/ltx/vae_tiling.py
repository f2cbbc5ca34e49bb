"""Tiled VAE encode and decode with overlap blending.

Port of ``ltx_video_gpupoor_tpu/models/ltx/vae_tiling.py``:
``get_vae_tile_size`` (:58), ``_ramp`` (:79), ``blend`` (:83, the linear
crossfade that the Wan VAE's tiled decode also uses), ``tiled_spatial``
(:101), ``tiled_encode`` (:164) and ``tiled_decode`` (:221): temporal
tiles of ``z_tile`` latent frames with a quarter overlap, spatial tiles of
``hw_tile`` pixels, each neighbour blended into the next. The tile loops
run on the host, one tile's intermediates at a time (the JAX package's
sequencing tokens and concurrent compile warm-up have no counterpart
here). ``parallel_*`` (:323-496) wait for ROADMAP queue 1 step 15.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import vae as ltx_vae


def get_vae_tile_size(vae_config: int = 0, device_mem_mb: float = 16 * 1024,
                      mixed_precision: bool = False) -> tuple[int, int]:
    """(z_tile latent frames, hw_tile pixels); 0 = no spatial tiling."""
    z_tile = 4
    if vae_config == 0:
        if mixed_precision:
            device_mem_mb = device_mem_mb / 1.5
        if device_mem_mb >= 24000:
            vae_config = 1
        elif device_mem_mb >= 8000:
            vae_config = 2
        else:
            vae_config = 3
    hw_tile = {1: 0, 2: 512, 3: 256}[vae_config]
    return z_tile, hw_tile


def _ramp(extent: int, dtype, device=None) -> torch.Tensor:
    return (torch.arange(extent, dtype=torch.float32, device=device)
            / extent).to(dtype)


def blend(a: torch.Tensor, b: torch.Tensor, extent: int,
          axis: int) -> torch.Tensor:
    """Linear crossfade: b's leading ``extent`` slices along ``axis``
    blended with a's trailing ``extent`` slices."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent <= 0:
        return b
    shape = [1] * b.dim()
    shape[axis] = extent
    w = _ramp(extent, b.dtype, b.device).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent)
    b_head = b.narrow(axis, 0, extent)
    blended = a_tail * (1 - w) + b_head * w
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)],
                     dim=axis)


def tiled_spatial(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  tile_in: int, tile_out: int, overlap_factor: float = 0.25,
                  h_axis: int = 2, w_axis: int = 3) -> torch.Tensor:
    """Overlapping-tile spatial map over ``[B, F, H, W, C]``: ``tile_in``
    is the tile size on the input, ``tile_out`` the size it maps to. Each
    tile is blended with its already blended upper and left neighbours."""
    overlap_in = int(tile_in * (1 - overlap_factor))
    blend_extent = int(tile_out * overlap_factor)
    limit = tile_out - blend_extent
    rows = []
    for i in range(0, x.shape[h_axis], overlap_in):
        row = []
        for j in range(0, x.shape[w_axis], overlap_in):
            tile = x.narrow(h_axis, i, min(tile_in, x.shape[h_axis] - i))
            tile = tile.narrow(w_axis, j, min(tile_in, x.shape[w_axis] - j))
            row.append(fn(tile))
        rows.append(row)
    result_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend(rows[i - 1][j], tile, blend_extent, h_axis)
            if j > 0:
                tile = blend(row[j - 1], tile, blend_extent, w_axis)
            row[j] = tile
            result_row.append(
                tile.narrow(h_axis, 0, min(limit, tile.shape[h_axis]))
                .narrow(w_axis, 0, min(limit, tile.shape[w_axis])))
        result_rows.append(torch.cat(result_row, dim=w_axis))
    return torch.cat(result_rows, dim=h_axis)


def _tiled_temporal(run: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, tile_in: int, step: int,
                    blend_extent: int, t_limit: int) -> torch.Tensor:
    """Map temporal tiles of ``tile_in + 1`` frames, ``step`` apart; every
    tile but the first drops its first output frame, is blended with the
    one before it and keeps ``t_limit`` frames."""
    row = []
    for i in range(0, x.shape[1], step):
        out = run(x[:, i: i + tile_in + 1])
        row.append(out[:, 1:] if i > 0 else out)
    result = []
    for i, tile in enumerate(row):
        if i > 0:
            tile = blend(row[i - 1], tile, blend_extent, 1)
            result.append(tile[:, :t_limit])
        else:
            result.append(tile[:, : t_limit + 1])
    return torch.cat(result, dim=1)


@torch.no_grad()
def tiled_encode(vae: ltx_vae.CausalVAE, media: torch.Tensor, z_tile: int = 4,
                 hw_tile: int = 0, overlap_factor: float = 0.25
                 ) -> torch.Tensor:
    """Tiled causal encode of ``[B, F, H, W, 3]``."""
    cfg = vae.cfg
    sf = cfg.spatial_downscale_factor

    def encode_fn(x):
        return ltx_vae.encode(vae, x)

    def encode_maybe_hw(x):
        if hw_tile and (x.shape[2] > hw_tile or x.shape[3] > hw_tile):
            return tiled_spatial(encode_fn, x, hw_tile, hw_tile // sf,
                                 overlap_factor)
        return encode_fn(x)

    tile_sample_t = z_tile * cfg.temporal_downscale_factor
    if not (z_tile > 1 and media.shape[1] > tile_sample_t + 1):
        return encode_maybe_hw(media)
    blend_extent = int(z_tile * overlap_factor)
    return _tiled_temporal(encode_maybe_hw, media, tile_sample_t,
                           int(tile_sample_t * (1 - overlap_factor)),
                           blend_extent, z_tile - blend_extent)


@torch.no_grad()
def tiled_decode(vae: ltx_vae.CausalVAEDecoder, latents: torch.Tensor,
                 z_tile: int = 4, hw_tile: int = 0,
                 overlap_factor: float = 0.25,
                 timestep: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Tiled decode of ``[B, F', H', W', z]``."""
    cfg = vae.cfg
    sf = cfg.spatial_downscale_factor
    hw_tile_latent = hw_tile // sf if hw_tile else 0

    def decode_fn(z):
        return ltx_vae.decode(vae, z, timestep, generator)

    def decode_maybe_hw(z):
        if hw_tile_latent and (z.shape[2] > hw_tile_latent
                               or z.shape[3] > hw_tile_latent):
            return tiled_spatial(decode_fn, z, hw_tile_latent, hw_tile,
                                 overlap_factor)
        return decode_fn(z)

    if not (z_tile > 1 and latents.shape[1] > z_tile + 1):
        return decode_maybe_hw(latents)
    tile_sample_t = z_tile * cfg.temporal_downscale_factor
    blend_extent = int(tile_sample_t * overlap_factor)
    return _tiled_temporal(decode_maybe_hw, latents, z_tile,
                           int(z_tile * (1 - overlap_factor)), blend_extent,
                           tile_sample_t - blend_extent)
