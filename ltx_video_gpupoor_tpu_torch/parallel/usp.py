"""Model-level unified sequence parallelism (USP) for the LTX and Wan DiTs.

Port of ``ltx_video_gpupoor_tpu/parallel/usp.py`` (:46-244). JAX wraps the
whole forward in one ``shard_map`` over ``sp``; here every rank of the
``sp`` axis runs the forward on its own slice of the token axis (LTX) or
the frame axis (Wan: frames map to contiguous token ranges under the
row-major (f, h, w) patchify, and a temporal patch of 1 needs no halo)
with ``attn_mode="ulysses:<axis>:<mode>"``: the self-attention runs the
Ulysses exchange (``parallel/ulysses.py``), the cross-attention none, and
everything else of a block is per token. Each returns this rank's shard of
``(velocity, residual)``; :func:`gather` joins shards.

What is sharded: the latents, the per-frame / per-group timesteps
(``[B, F]`` or ``[B, G]``), ``previous_residual``, ``vace_context``, the
RoPE tables (so every rank applies its GLOBAL positions) and ``cam_emb``
after ``expand_cam_to_frames``. What is replicated: ``clip_features``,
``slg_keep``, the caption / context and its mask. A sharded input may be
given whole (the same on every rank; the rank cuts its slice) or as this
rank's slice already (a residual this function returned). TeaCache's
``compute`` is a host bool that every rank must hold alike: the pipelines
take it from a schedule computed before the loop, the same on all ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import mesh as _mesh
from ..models.ltx.transformer3d import LTXTransformer3D
from ..models.wan import model as wan_model
from . import comm


def _slice(x: Optional[torch.Tensor], dim: int, n_global: int, p: int,
           r: int) -> Optional[torch.Tensor]:
    """This rank's slice of ``x`` along ``dim`` (``n_global`` long in
    whole); ``x`` already that slice passes through."""
    if x is None or p == 1:
        return x
    if x.shape[dim] == n_global:
        return x.narrow(dim, r * (n_global // p), n_global // p)
    if x.shape[dim] == n_global // p:
        return x
    raise ValueError(f"a sharded input of length {x.shape[dim]} along dim "
                     f"{dim}: want {n_global} (whole) or {n_global // p}")


def gather(mesh, x: torch.Tensor, dim: int = 1,
           axis_name: str = "sp") -> torch.Tensor:
    """Join every rank's shard along ``dim`` (rank order)."""
    if _mesh.axis_size(mesh, axis_name) == 1:
        return x
    return comm.all_gather_cat(x, _mesh.axis_group(mesh, axis_name), dim)


def usp_wan_forward(
    mesh,
    model: wan_model.WanModel,
    x: torch.Tensor,                  # [B, F, H, W, C] latent video
    t: torch.Tensor,                  # [B] — or [B, F] (diffusion forcing)
    context: torch.Tensor,            # [B, Sc, text_dim]
    context_mask: torch.Tensor,       # [B, Sc]
    freqs: tuple,                     # (cos, sin) [L, head_dim] global RoPE
    axis_name: str = "sp",
    attn_mode: str = "auto",
    clip_features: Optional[torch.Tensor] = None,
    slg_keep: Optional[torch.Tensor] = None,       # [L, B] (replicated)
    previous_residual: Optional[torch.Tensor] = None,  # [B, N, D] rows
    compute: bool = True,
    fps_idx: Optional[int] = None,
    vace_context: Optional[torch.Tensor] = None,   # [B, F, H, W, vace_in]
    vace_scale: float = 1.0,
    cam_emb: Optional[torch.Tensor] = None,        # [B, F', 12]
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's shard of ``(velocity [B, F/p, H, W, C_out], residual
    [B, N/p, D])``. Frames and heads must divide over the sp size, and the
    temporal patch must be 1 (:46-100)."""
    cfg = model.cfg
    sp = _mesh.axis_size(mesh, axis_name)
    if cfg.patch_size[0] != 1:
        raise ValueError(
            f"usp_wan_forward requires patch_size[0] == 1, got "
            f"{cfg.patch_size}")
    f = x.shape[1]
    if f % sp:
        raise ValueError(f"frames ({f}) must divide over sp={sp}")
    if cfg.num_heads % sp:
        raise ValueError(f"heads ({cfg.num_heads}) must divide over sp={sp}")
    r = _mesh.axis_rank(mesh, axis_name)
    n_tok = f * (x.shape[2] // cfg.patch_size[1]) * (x.shape[3]
                                                     // cfg.patch_size[2])
    t = torch.as_tensor(t)
    if t.dim() == 2 and t.shape[1] > 1:
        t = _slice(t, 1, f, sp, r)
    if cam_emb is not None:
        cam_emb = wan_model.expand_cam_to_frames(cam_emb, f)
    cos, sin = freqs
    with _mesh.use_mesh(mesh):
        return model(
            _slice(x, 1, f, sp, r), t, context, context_mask,
            (_slice(cos, 0, n_tok, sp, r), _slice(sin, 0, n_tok, sp, r)),
            clip_features=clip_features,
            vace_context=_slice(vace_context, 1, f, sp, r),
            slg_keep=slg_keep,
            cam_emb=_slice(cam_emb, 1, f, sp, r),
            fps_idx=fps_idx,
            previous_residual=_slice(previous_residual, 1, n_tok, sp, r),
            compute=compute,
            attn_mode=f"ulysses:{axis_name}:{attn_mode}",
            vace_scale=vace_scale,
        )


def usp_ltx_forward(
    mesh,
    model: LTXTransformer3D,
    latents: torch.Tensor,            # [B, N, C] patchified tokens
    indices_grid: torch.Tensor,       # [B, 3, N] fractional coords
    timestep: torch.Tensor,           # [B] or [B, G] per-group timesteps
    caption: torch.Tensor,
    caption_mask: Optional[torch.Tensor] = None,
    skip_layer_mask: Optional[torch.Tensor] = None,
    skip_layer_strategy: Optional[str] = None,
    axis_name: str = "sp",
    attn_mode: str = "auto",
    previous_residual: Optional[torch.Tensor] = None,
    compute: bool = True,
    freqs: Optional[tuple] = None,    # precomputed (cos, sin) [B, N, d]
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's shard of ``(velocity [B, N/p, C_out], residual [B, N/p,
    D])``. Tokens and heads must divide over the sp size, and per-group
    timesteps' group count too (:163-244). RoPE follows the tokens: give
    the step-invariant tables in ``freqs`` (whole or this rank's rows), or
    each rank computes its rows from its slice of ``indices_grid``.
    ``remat``: the model's per-block checkpointing (the train step)."""
    cfg = model.cfg
    sp = _mesh.axis_size(mesh, axis_name)
    n = latents.shape[1]
    if n % sp:
        raise ValueError(f"tokens ({n}) must divide over sp={sp}")
    if cfg.num_attention_heads % sp:
        raise ValueError(
            f"heads ({cfg.num_attention_heads}) must divide over sp={sp}")
    t = torch.as_tensor(timestep)
    t_grouped = t.dim() == 2 and t.shape[1] > 1
    if t_grouped and t.shape[1] % sp:
        raise ValueError(
            f"timestep groups ({t.shape[1]}) must divide over sp={sp}")
    r = _mesh.axis_rank(mesh, axis_name)
    if t_grouped:
        t = _slice(t, 1, t.shape[1], sp, r)
    if freqs is not None:
        freqs = tuple(_slice(f, 1, n, sp, r) for f in freqs)
    with _mesh.use_mesh(mesh):
        return model(
            _slice(latents, 1, n, sp, r), _slice(indices_grid, 2, n, sp, r),
            t, caption, caption_mask,
            skip_layer_mask=skip_layer_mask,
            skip_layer_strategy=skip_layer_strategy,
            attn_mode=f"ulysses:{axis_name}:{attn_mode}",
            freqs=freqs,
            previous_residual=_slice(previous_residual, 1, n, sp, r),
            compute=compute, return_residual=True, remat=remat,
        )
