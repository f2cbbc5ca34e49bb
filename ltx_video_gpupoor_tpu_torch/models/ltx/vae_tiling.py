"""Tiled VAE encode and decode with overlap blending.

Port of ``ltx_video_gpupoor_tpu/models/ltx/vae_tiling.py``:
``get_vae_tile_size`` (:58), ``_ramp`` (:79), ``blend`` (:83, the linear
crossfade that the Wan VAE's tiled decode also uses), ``tiled_spatial``
(:101), ``tiled_encode`` (:164) and ``tiled_decode`` (:221): temporal
tiles of ``z_tile`` latent frames with a quarter overlap, spatial tiles of
``hw_tile`` pixels, each neighbour blended into the next. The tile loops
run on the host, one tile's intermediates at a time (the JAX package's
sequencing tokens and concurrent compile warm-up have no counterpart
here). :func:`parallel_spatial_map`, :func:`_parallel_spatial_decode` and
:func:`parallel_tiled_decode` (:323-496) deal the spatial tile grid to
every rank of the mesh (contiguous blocks of the flat tile list, as JAX's
flat ``shard_map``), make tail tiles uniform by edge-replicate padding,
bring the decoded tiles back with one ``all_gather`` and blend them as
:func:`tiled_spatial` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

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


def parallel_spatial_map(mesh, tile_fn: Callable[[int, torch.Tensor],
                                                 torch.Tensor],
                         z: torch.Tensor, tile_in: int, tile_out: int,
                         overlap_factor: float) -> torch.Tensor:
    """Overlapping-tile spatial map of ``z [B, F, H, W, C]`` with the tile
    grid spread over every rank of ``mesh`` (the whole process group), then
    blended exactly like :func:`tiled_spatial`. ``tile_fn(index, tile)``
    maps tile ``index`` of the flat grid (row-major) ``[B, F, tile_in,
    tile_in, C]`` to ``[B, F', tile_out', tile_out', C']``. Tail tiles are
    made uniform by edge-replicate padding of the latent, and the tile list
    is padded to a multiple of the ranks with its last tile; each rank maps
    its contiguous block one tile at a time. Returns the blended output
    uncropped along H/W (callers crop to ``h * sf`` / ``w * sf``)."""
    import torch.distributed as dist

    from ...parallel import comm

    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"the mesh spans {mesh.size()} of {world} ranks")
    overlap_in = int(tile_in * (1 - overlap_factor))
    blend_extent = int(tile_out * overlap_factor)
    limit = tile_out - blend_extent
    h, w = z.shape[2], z.shape[3]
    starts_h = list(range(0, h, overlap_in))
    starts_w = list(range(0, w, overlap_in))
    pad_h = max(0, starts_h[-1] + tile_in - h)
    pad_w = max(0, starts_w[-1] + tile_in - w)
    # edge-replicate along H and W: [B, F, H, W, C] -> [B*F, C, H, W]
    b, f, _, _, c = z.shape
    zp = F.pad(z.permute(0, 1, 4, 2, 3).reshape(b * f, c, h, w),
               (0, pad_w, 0, pad_h), mode="replicate")
    zp = zp.reshape(b, f, c, h + pad_h, w + pad_w).permute(0, 1, 3, 4, 2)
    starts = [(i, j) for i in starts_h for j in starts_w]
    n_tiles = len(starts)
    per = -(-n_tiles // world)
    rank = dist.get_rank()
    mine = []
    for t in range(rank * per, (rank + 1) * per):
        i, j = starts[min(t, n_tiles - 1)]
        mine.append(tile_fn(min(t, n_tiles - 1),
                            zp[:, :, i:i + tile_in, j:j + tile_in]))
    out = comm.all_gather_cat(torch.stack(mine), None, 0)[:n_tiles]
    nw = len(starts_w)
    grid = [[out[r * nw + cix] for cix in range(nw)]
            for r in range(len(starts_h))]
    result_rows = []
    for i, row in enumerate(grid):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend(grid[i - 1][j], tile, blend_extent, 2)
            if j > 0:
                tile = blend(row[j - 1], tile, blend_extent, 3)
            row[j] = tile
            result_row.append(tile[:, :, :limit, :limit])
        result_rows.append(torch.cat(result_row, dim=3))
    return torch.cat(result_rows, dim=2)


def _tile_generators(generator: Optional[torch.Generator]):
    """Per-tile generators for the parallel decode's noise: one seed drawn
    from ``generator`` (whose state every rank holds alike), tile i seeded
    ``seed + i``, so that every rank draws a tile's noise alike wherever
    it is decoded (the noise is not the sequential decode's)."""
    if generator is None:
        return lambda i: None
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))

    def make(i):
        g = torch.Generator(device=generator.device)
        g.manual_seed(seed + i)
        return g
    return make


def _parallel_spatial_decode(mesh, vae: ltx_vae.CausalVAEDecoder,
                             z: torch.Tensor, tile_in: int, tile_out: int,
                             overlap_factor: float,
                             timestep: Optional[torch.Tensor],
                             generator: Optional[torch.Generator]
                             ) -> torch.Tensor:
    """The LTX decode over :func:`parallel_spatial_map`."""
    gen = _tile_generators(generator)
    full = parallel_spatial_map(
        mesh, lambda i, tile: ltx_vae.decode(vae, tile, timestep, gen(i)),
        z, tile_in, tile_out, overlap_factor)
    sf = vae.cfg.spatial_downscale_factor
    return full[:, :, :z.shape[2] * sf, :z.shape[3] * sf]


@torch.no_grad()
def parallel_tiled_decode(mesh, vae: ltx_vae.CausalVAEDecoder,
                          latents: torch.Tensor, z_tile: int = 4,
                          hw_tile: int = 0, overlap_factor: float = 0.25,
                          timestep: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """:func:`tiled_decode` with each temporal tile's spatial grid spread
    over every rank of ``mesh``; temporal tiles stay sequential. Without a
    mesh, on one rank, or without spatial tiling it is
    :func:`tiled_decode`."""
    sf = vae.cfg.spatial_downscale_factor
    tile_lat = hw_tile // sf if hw_tile else 0
    t, h, w = latents.shape[1:4]
    spatial = bool(tile_lat) and (h > tile_lat or w > tile_lat)
    if mesh is None or mesh.size() == 1 or not spatial:
        return tiled_decode(vae, latents, z_tile, hw_tile, overlap_factor,
                            timestep, generator)

    def decode_hw(zz):
        return _parallel_spatial_decode(mesh, vae, zz, tile_lat, hw_tile,
                                        overlap_factor, timestep, generator)

    if not (z_tile > 1 and t > z_tile + 1):
        return decode_hw(latents)
    tile_sample_t = z_tile * vae.cfg.temporal_downscale_factor
    blend_extent = int(tile_sample_t * overlap_factor)
    return _tiled_temporal(decode_hw, latents, z_tile,
                           int(z_tile * (1 - overlap_factor)), blend_extent,
                           tile_sample_t - blend_extent)
