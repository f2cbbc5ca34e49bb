"""Symmetric (de)patchification for the LTX DiT token space.

Port of ``ltx_video_gpupoor_tpu/models/ltx/patchifier.py``
(``get_latent_coords``, ``patchify``, ``unpatchify``). Latents keep the
JAX package's channels-last ``[B, F, H, W, C]``; tokens are in
frame-major ``(f, h, w)`` raster order.
"""

from __future__ import annotations

import torch
from einops import rearrange


def get_latent_coords(num_frames: int, height: int, width: int,
                      batch_size: int,
                      patch_size: tuple[int, int, int] = (1, 1, 1),
                      device=None) -> torch.Tensor:
    """Top-left latent coordinates per token: ``[B, 3, N]`` (f, y, x)."""
    pf, ph, pw = patch_size
    grid = torch.meshgrid(
        torch.arange(0, num_frames, pf, device=device),
        torch.arange(0, height, ph, device=device),
        torch.arange(0, width, pw, device=device),
        indexing="ij",
    )
    coords = torch.stack(grid, dim=0).reshape(3, -1)
    return coords[None].expand(batch_size, 3, coords.shape[1])


def patchify(latents: torch.Tensor,
             patch_size: tuple[int, int, int] = (1, 1, 1)
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, F, H, W, C] -> ([B, N, C*pf*ph*pw], [B, 3, N])``."""
    b, f, h, w, _ = latents.shape
    coords = get_latent_coords(f, h, w, b, patch_size, device=latents.device)
    tokens = rearrange(
        latents, "b (f p1) (h p2) (w p3) c -> b (f h w) (c p1 p2 p3)",
        p1=patch_size[0], p2=patch_size[1], p3=patch_size[2])
    return tokens, coords


def unpatchify(tokens: torch.Tensor, height: int, width: int,
               out_channels: int,
               patch_size: tuple[int, int, int] = (1, 1, 1)) -> torch.Tensor:
    """``[B, N, C*p...] -> [B, F, H, W, C]`` (height/width in latent pixels);
    temporal patch 1 only, as in every LTX config."""
    if patch_size[0] != 1:
        raise ValueError(f"unpatchify supports temporal patch 1, got {patch_size}")
    h = height // patch_size[1]
    w = width // patch_size[2]
    return rearrange(tokens, "b (f h w) (c p q) -> b f (h p) (w q) c",
                     h=h, w=w, p=patch_size[1], q=patch_size[2])
