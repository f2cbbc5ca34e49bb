"""Wan 2.1 diffusion transformer (WanModel), text- and image-to-video.

Port of ``ltx_video_gpupoor_tpu/models/wan/model.py``: ``WanConfig``,
``WAN_T2V_1_3B``, ``WAN_T2V_14B``, ``WAN_I2V_14B`` (:48-102),
``sinusoidal_embedding_1d``, ``patch_embed`` (Conv3d), ``unpatchify``,
``_mod``, ``_gate``, ``_self_attention`` (full-dim q/k RMS norm, RoPE
shared by the heads), ``_cross_attention`` (segment ids from
``context_mask``; i2v adds the attention to the CLIP tokens through
``k_img`` / ``v_img`` / ``norm_k_img``, :361-375), ``_ffn`` with
``ffn_chunks``, ``block_forward`` with the SLG keep mask,
``time_modulation``, ``embed_text``, ``embed_clip`` (the i2v ``img_emb``
MLP, :468) and ``forward`` (:480-593) with TeaCache's residual: each call
returns ``out_tokens - in_tokens``, and ``compute=False`` skips the block
stack and adds ``previous_residual`` instead. The variants: fps
conditioning (``inject_sample_info``: ``fps_embedding`` /
``fps_projection`` add to the modulation table, :518-522), VACE
(``vace_blocks`` with ``before_proj`` / ``after_proj`` and
``vace_patch_embedding``: the hint stream ``_run_blocks_vace``, :632-674,
each hint added as its block runs and held back where SLG skips the
block) and ReCamMaster (``cam_encoder`` / ``projector`` in every block,
``_encode_cam`` :596 and ``expand_cam_to_frames`` :617).

The parameter tree becomes modules whose attribute names are the JAX
keys (``core/from_jax.py`` relies on that); the per-layer ``lax.scan``
becomes a loop over ``blocks``. Every linear is an ``ops.quant.Linear``,
so ``quantize_params(model, mode="dynamic")`` moves the DiT onto kernel K2; attention at
head dim 128 resolves to kernel K4 (``ops/attention.py``). Activations run
in the policy's ``compute_dtype``; modulation and the timestep path stay
fp32. The tokens live in ``[B, L, D]``, the latent video in JAX's
channels-last ``[B, F, H, W, C]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.attention import attention
from ...ops.norms import layer_norm, rms_norm
from ...ops.quant import Linear
from ...ops.rope import apply_rotary_emb_shared_heads, full_to_half


@dataclasses.dataclass(frozen=True)
class WanConfig:
    model_type: str = "t2v"  # t2v | i2v
    patch_size: tuple = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    qk_norm: bool = True
    attention_score_bound: Optional[float] = None
    cross_attn_norm: bool = True
    eps: float = 1e-6
    vace_layers: Optional[tuple] = None
    vace_in_dim: Optional[int] = None
    recammaster: bool = False
    inject_sample_info: bool = False
    ffn_chunks: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_T2V_1_3B = WanConfig(
    model_type="t2v", dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN_T2V_14B = WanConfig(
    model_type="t2v", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
WAN_I2V_14B = WanConfig(
    model_type="i2v", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
    in_dim=36)
CLIP_DIM = 1280   # the CLIP ViT-H/14 features that i2v attends to
CAM_DIM = 12      # ReCamMaster's pose row: a flattened [3, 4] camera


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """``[cos | sin]`` with ``10000^(-i/half)`` frequencies, fp32."""
    half = dim // 2
    # the power in float64, rounded once (an fp32 pow differs by an ulp
    # between libraries)
    expo = -torch.arange(half, dtype=torch.float32) / half
    freqs = torch.pow(torch.tensor(10000.0, dtype=torch.float64),
                      expo.double()).float().to(position.device)
    angles = position.float()[..., None] * freqs
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


class _Weight(nn.Module):
    """A norm's ``weight`` (and optional ``bias``) leaf."""

    def __init__(self, dim: int, bias: bool = False, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)


class _Attn(nn.Module):
    def __init__(self, cfg: WanConfig, img: bool = False, **kw):
        super().__init__()
        d = cfg.dim
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)
        self.norm_q = _Weight(d, **kw)
        self.norm_k = _Weight(d, **kw)
        if img:  # i2v: the keys and values of the CLIP tokens
            self.k_img = Linear(d, d, **kw)
            self.v_img = Linear(d, d, **kw)
            self.norm_k_img = _Weight(d, **kw)


class _MLP(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, d_out: int, **kw):
        super().__init__()
        self.fc1 = Linear(d_in, d_hidden, **kw)
        self.fc2 = Linear(d_hidden, d_out, **kw)


class Block(nn.Module):
    """A DiT block; ``vace=True`` makes it a VACE hint block (text cross
    attention whatever the model type, ``after_proj``, and ``before_proj``
    on the first, ``first=True``). Under ``cfg.recammaster`` every block
    has ReCamMaster's ``cam_encoder`` and ``projector``."""

    def __init__(self, cfg: WanConfig, *, vace: bool = False,
                 first: bool = False, **kw):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.modulation = nn.Parameter(
            torch.empty(1, 6, d, device=kw.get("device"),
                        dtype=kw.get("dtype")), requires_grad=False)
        self.self_attn = _Attn(cfg, **kw)
        self.cross_attn = _Attn(cfg, cfg.model_type == "i2v" and not vace,
                                **kw)
        self.ffn = _MLP(d, cfg.ffn_dim, d, **kw)
        self.norm3 = _Weight(d, True, **kw) if cfg.cross_attn_norm else None
        if cfg.recammaster:
            _add_cam(self, **kw)
        if vace:
            self.after_proj = Linear(d, d, **kw)
            if first:
                self.before_proj = Linear(d, d, **kw)

    def forward(self, x, e0, freqs, context, context_mask, keep=None,
                attn_mode="auto", img_context=None, cam=None):
        return block_forward(self, self.cfg, x, e0, freqs, context,
                             context_mask, keep, attn_mode, img_context, cam)


class _Head(nn.Module):
    def __init__(self, cfg: WanConfig, **kw):
        super().__init__()
        self.modulation = nn.Parameter(
            torch.empty(1, 2, cfg.dim, device=kw.get("device"),
                        dtype=kw.get("dtype")), requires_grad=False)
        self.head = Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim,
                           **kw)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: WanConfig, in_dim: Optional[int] = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cfg.dim, in_dim or cfg.in_dim, *cfg.patch_size,
                        device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cfg.dim, device=device,
                                             dtype=dtype), requires_grad=False)


class _ImgEmb(nn.Module):
    """i2v's ``MLPProj``: CLIP features ``[B, 257, 1280]`` -> ``[B, 257,
    D]``."""

    def __init__(self, cfg: WanConfig, **kw):
        super().__init__()
        self.norm_in = _Weight(CLIP_DIM, True, **kw)
        self.fc1 = Linear(CLIP_DIM, CLIP_DIM, **kw)
        self.fc2 = Linear(CLIP_DIM, cfg.dim, **kw)
        self.norm_out = _Weight(cfg.dim, True, **kw)


def _add_cam(block: nn.Module, **kw) -> None:
    """ReCamMaster's ``cam_encoder`` and ``projector`` on one block."""
    d = block.cfg.dim
    block.cam_encoder = Linear(CAM_DIM, d, **kw)
    block.projector = Linear(d, d, **kw)


def add_variant_modules(model: nn.Module, cfg: WanConfig,
                        **kw) -> nn.Module:
    """Give ``model`` (a :class:`WanModel`) the modules that ``cfg``'s
    variants add and it lacks: the fps table and projection
    (``inject_sample_info``), VACE's hint blocks and patch embedding
    (``vace_layers``), ReCamMaster's ``cam_encoder`` / ``projector`` in
    every block (``recammaster``); ``model.cfg`` (and each block's)
    becomes ``cfg``. :class:`WanModel` builds its variants through this;
    a built model takes them in place. ``kw``: device and dtype. Returns a
    module holding just the new ones, under the model's names (the cameras
    in ``cams``), for :func:`init_params`."""
    new = nn.Module()
    new.cfg = model.cfg = cfg
    d = cfg.dim
    if cfg.inject_sample_info and not hasattr(model, "fps_embedding"):
        model.fps_embedding = new.fps_embedding = nn.Parameter(
            torch.empty(2, d, **kw), requires_grad=False)
        model.fps_projection = new.fps_projection = _MLP(d, d, 6 * d, **kw)
    if cfg.vace_layers is not None and not hasattr(model, "vace_blocks"):
        model.vace_blocks = new.vace_blocks = nn.ModuleList(
            Block(cfg, vace=True, first=i == 0, **kw)
            for i in range(len(cfg.vace_layers)))
        model.vace_patch_embedding = new.vace_patch_embedding = _PatchEmbed(
            cfg, cfg.vace_in_dim or cfg.in_dim, **kw)
    cams = []
    for blk in model.blocks:
        blk.cfg = cfg
        if cfg.recammaster and not hasattr(blk, "cam_encoder"):
            _add_cam(blk, **kw)
            cams.append(nn.ModuleDict({"cam_encoder": blk.cam_encoder,
                                       "projector": blk.projector}))
    new.cams = nn.ModuleList(cams)
    return new


class WanModel(nn.Module):
    """The denoiser; :meth:`forward` returns ``(velocity, residual)``."""

    def __init__(self, cfg: WanConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 *, device=None):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise ValueError(f"Wan model_type {cfg.model_type!r}")
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        d = cfg.dim
        self.patch_embedding = _PatchEmbed(cfg, **kw)
        self.text_embedding = _MLP(cfg.text_dim, d, d, **kw)
        self.time_embedding = _MLP(cfg.freq_dim, d, d, **kw)
        self.time_projection = Linear(d, 6 * d, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.head = _Head(cfg, **kw)
        if cfg.model_type == "i2v":
            self.img_emb = _ImgEmb(cfg, **kw)
        add_variant_modules(self, cfg, **kw)

    def forward(
        self,
        x: torch.Tensor,                  # [B, F, H, W, C_in]
        t: torch.Tensor,                  # [B] or [B, G]
        context: torch.Tensor,            # [B, text_len, text_dim]
        context_mask: torch.Tensor,       # [B, text_len]
        freqs: tuple,                     # (cos, sin) [L, head_dim]
        clip_features=None,
        vace_context: Optional[torch.Tensor] = None,   # [B, F, H, W, vace_in]
        slg_keep: Optional[torch.Tensor] = None,   # [num_layers, B] 1 = run
        cam_emb: Optional[torch.Tensor] = None,    # [B, F', 12] camera poses
        fps_idx: Optional[int] = None,
        previous_residual=None,
        compute: bool = True,
        attn_mode: str = "auto",
        vace_scale: float = 1.0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        if not compute and previous_residual is None:
            raise ValueError("compute=False reuses previous_residual; none "
                             "was given")
        return forward(self, x, t, context, context_mask, freqs, slg_keep,
                       attn_mode, clip_features, previous_residual,
                       bool(compute), vace_context=vace_context,
                       vace_scale=vace_scale, cam_emb=cam_emb,
                       fps_idx=fps_idx)


def patch_embed(p: _PatchEmbed, cfg: WanConfig, video: torch.Tensor
                ) -> tuple[torch.Tensor, tuple]:
    """video ``[B, F, H, W, C]`` -> tokens ``[B, L, D]``, grid
    ``(F, H/ph, W/pw)``."""
    y = F.conv3d(video.permute(0, 4, 1, 2, 3), p.weight.to(video.dtype),
                 stride=cfg.patch_size)
    y = y + p.bias.to(y.dtype)[:, None, None, None]
    b, d, f, h, w = y.shape
    return y.flatten(2).transpose(1, 2).contiguous(), (f, h, w)


def unpatchify(x: torch.Tensor, grid: tuple, cfg: WanConfig) -> torch.Tensor:
    """tokens ``[B, L, out*prod(patch)]`` -> video ``[B, F*pt, H*ph, W*pw,
    out]``."""
    f, h, w = grid
    pt, ph, pw = cfg.patch_size
    return rearrange(x, "b (f h w) (p q r c) -> b (f p) (h q) (w r) c",
                     f=f, h=h, w=w, p=pt, q=ph, r=pw, c=cfg.out_dim)


def _mod(x, e_shift, e_scale):
    """x ``[B, L, D]``; ``e_* [B, G, D]``: modulate per token group."""
    b, l, d = x.shape
    g = e_shift.shape[1]
    if g == 1:
        return x * (1 + e_scale) + e_shift
    xg = x.reshape(b, g, l // g, d)
    return (xg * (1 + e_scale[:, :, None]) + e_shift[:, :, None]).reshape(
        b, l, d)


def _gate(x, y, e_gate):
    b, l, d = x.shape
    g = e_gate.shape[1]
    if g == 1:
        return x + y * e_gate
    xg = x.reshape(b, g, l // g, d)
    yg = y.reshape(b, g, l // g, d)
    return (xg + yg * e_gate[:, :, None]).reshape(b, l, d)


def _self_attention(p: _Attn, cfg: WanConfig, x, freqs, attn_mode):
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q, k, v = p.q(x), p.k(x), p.v(x)
    if cfg.qk_norm:
        q = rms_norm(q, p.norm_q.weight, eps=cfg.eps)
        k = rms_norm(k, p.norm_k.weight, eps=cfg.eps)
    cos, sin = freqs  # half layout [L, hd/2]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    qh = apply_rotary_emb_shared_heads(q.reshape(b, s, n, hd), cos, sin)
    kh = apply_rotary_emb_shared_heads(k.reshape(b, s, n, hd), cos, sin)
    vh = v.reshape(b, s, n, hd).transpose(1, 2)
    sb = cfg.attention_score_bound if cfg.qk_norm else None
    out = attention(qh, kh, vh, mode=attn_mode, score_bound=sb)
    return p.o(out.transpose(1, 2).reshape(b, s, d))


def _cross_attention(p: _Attn, cfg: WanConfig, x, context, context_mask,
                     attn_mode, img_context=None):
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = p.q(x)
    if cfg.qk_norm:
        q = rms_norm(q, p.norm_q.weight, eps=cfg.eps)
    qh = q.reshape(b, s, n, hd).transpose(1, 2)
    k = p.k(context)
    if cfg.qk_norm:
        k = rms_norm(k, p.norm_k.weight, eps=cfg.eps)
    v = p.v(context)
    sc = context.shape[1]
    sb = cfg.attention_score_bound if cfg.qk_norm else None
    out = attention(
        qh,
        k.reshape(b, sc, n, hd).transpose(1, 2),
        v.reshape(b, sc, n, hd).transpose(1, 2),
        torch.ones(b, s, dtype=torch.int32, device=x.device),
        context_mask.to(torch.int32),
        mode=attn_mode,
        score_bound=sb,
    )
    if img_context is not None:
        # i2v: the CLIP tokens, every one in sight (no mask)
        k_img = rms_norm(p.k_img(img_context), p.norm_k_img.weight,
                         eps=cfg.eps)
        v_img = p.v_img(img_context)
        si = img_context.shape[1]
        out = out + attention(
            qh,
            k_img.reshape(b, si, n, hd).transpose(1, 2),
            v_img.reshape(b, si, n, hd).transpose(1, 2),
            mode=attn_mode, score_bound=sb)
    return p.o(out.transpose(1, 2).reshape(b, s, d))


def _ffn(cfg: WanConfig, p: _MLP, x):
    """FFN, token-chunked by ``cfg.ffn_chunks`` to bound the ffn_dim-wide
    intermediate."""
    def part(c):
        return p.fc2(F.gelu(p.fc1(c), approximate="tanh"))

    if cfg.ffn_chunks <= 1:
        return part(x)
    s = x.shape[1]
    n = cfg.ffn_chunks
    pad = (-s) % n
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    out = torch.cat([part(c) for c in xp.chunk(n, dim=1)], dim=1)
    return out[:, :s] if pad else out


def block_forward(p: Block, cfg: WanConfig, x, e0, freqs, context,
                  context_mask, keep=None, attn_mode="auto", img_context=None,
                  cam=None):
    """One block; ``e0 [B, G, 6, D]`` fp32, ``keep [B]`` (1 = run the
    block, 0 = skip it, SLG) or None; ``img_context [B, 257, D]`` (i2v)
    or None; ``cam [B, L, D]``, this block's encoded camera tokens
    (:func:`_encode_cam`), or None: ReCamMaster adds them to the
    self-attention's input and projects its output (only where poses are
    given, as the reference does)."""
    e = p.modulation.float()[:, None] + e0           # [B, G, 6, D]
    e = [e[:, :, i].to(x.dtype) for i in range(6)]
    original = x
    h = _mod(layer_norm(x, eps=cfg.eps), e[0], e[1])
    if cam is not None:
        h = h + cam
    y = _self_attention(p.self_attn, cfg, h, freqs, attn_mode)
    if cam is not None:
        y = p.projector(y)
    x = _gate(x, y, e[2])
    if p.norm3 is not None:
        h = layer_norm(x, p.norm3.weight, p.norm3.bias, eps=cfg.eps)
    else:
        h = x
    x = x + _cross_attention(p.cross_attn, cfg, h, context, context_mask,
                             attn_mode, img_context)
    h = _mod(layer_norm(x, eps=cfg.eps), e[3], e[4])
    x = _gate(x, _ffn(cfg, p.ffn, h), e[5])
    if keep is not None:
        m = keep.to(x.dtype)[:, None, None]
        x = x * m + original * (1 - m)
    return x


def time_modulation(model: WanModel, cfg: WanConfig, t: torch.Tensor):
    """t ``[B]`` or ``[B, G]`` -> (e ``[B, G, D]``, e0 ``[B, G, 6, D]``),
    fp32."""
    tb = torch.as_tensor(t)
    if tb.dim() == 1:
        tb = tb[:, None]
    b, g = tb.shape
    emb = sinusoidal_embedding_1d(cfg.freq_dim, tb.reshape(-1))
    te = model.time_embedding
    e = te.fc2(F.silu(te.fc1(emb)))                  # [B*G, D]
    e0 = model.time_projection(F.silu(e))
    return (e.reshape(b, g, cfg.dim).float(),
            e0.reshape(b, g, 6, cfg.dim).float())


def embed_text(model: WanModel, cfg: WanConfig,
               text_embeds: torch.Tensor) -> torch.Tensor:
    """UMT5 embeddings ``[B, text_len, text_dim]`` -> ``[B, text_len, D]``."""
    te = model.text_embedding
    return te.fc2(F.gelu(te.fc1(text_embeds), approximate="tanh"))


def embed_clip(model: WanModel, clip_features: torch.Tensor) -> torch.Tensor:
    """i2v's ``img_emb``: CLIP features ``[B, 257, 1280]`` -> ``[B, 257,
    D]`` (layer norms at eps 1e-5, the exact GELU)."""
    p = model.img_emb
    h = layer_norm(clip_features, p.norm_in.weight, p.norm_in.bias, eps=1e-5)
    h = p.fc2(F.gelu(p.fc1(h), approximate="none"))
    return layer_norm(h, p.norm_out.weight, p.norm_out.bias, eps=1e-5)


def forward(model: WanModel, x, t, context, context_mask, freqs,
            slg_keep=None, attn_mode="auto", clip_features=None,
            previous_residual=None, compute=True, *, vace_context=None,
            vace_scale=1.0, cam_emb=None, fps_idx=None):
    """One denoiser evaluation: (velocity ``[B, F, H, W, C_out]``, the
    token-space residual ``out_tokens - in_tokens``). ``clip_features``
    (i2v; ignored by a t2v model, as in JAX): ``[B, 257, 1280]``. With
    ``compute=False`` the block stack is skipped: the output tokens are
    the input tokens plus ``previous_residual``, which is returned as the
    residual (TeaCache). ``vace_context [B, F, H, W, vace_in]`` runs the
    VACE hint blocks (a model with ``vace_layers``), each hint times
    ``vace_scale``; ``cam_emb [B, F', 12]`` the ReCamMaster pose rows;
    ``fps_idx`` (0 for 16 fps, 1 otherwise) the fps conditioning of a
    model with ``inject_sample_info``."""
    cfg = model.cfg
    dev = x.device
    tokens, grid = patch_embed(model.patch_embedding, cfg,
                               x.to(model.compute_dtype))
    b, l = tokens.shape[:2]
    cos, sin = freqs
    if cos.shape[-1] == cfg.head_dim:
        # one conversion per forward: the blocks take the half layout
        cos, sin = full_to_half(cos), full_to_half(sin)
    freqs = (cos.to(dev), sin.to(dev))
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    e, e0 = time_modulation(model, cfg, t)
    if cfg.inject_sample_info and fps_idx is not None:
        fp = model.fps_projection
        emb = model.fps_embedding[fps_idx].float()[None]
        e0 = e0 + fp.fc2(F.silu(fp.fc1(emb))).float().reshape(
            1, 1, 6, cfg.dim)
    if not compute:
        residual = previous_residual.to(device=dev, dtype=tokens.dtype)
        out = tokens + residual
    else:
        ctx = embed_text(model, cfg,
                         context.to(device=dev, dtype=tokens.dtype))
        cmask = context_mask.to(device=dev, dtype=torch.int32).contiguous()
        img_ctx = None
        if clip_features is not None and hasattr(model, "img_emb"):
            img_ctx = embed_clip(model, clip_features.to(
                device=dev, dtype=tokens.dtype))
        if slg_keep is not None:
            slg_keep = torch.as_tensor(slg_keep).cpu()
        if cam_emb is not None:
            cam_emb = cam_emb.to(dev)
        vace = {}
        if cfg.vace_layers is not None and vace_context is not None:
            vace = {layer: i for i, layer in enumerate(cfg.vace_layers)}
            c, _ = patch_embed(model.vace_patch_embedding, cfg,
                               vace_context.to(dev, tokens.dtype))
        out = tokens
        for i, blk in enumerate(model.blocks):
            keep = None
            # a layer whose streams all run needs no blend (x*1 + y*0 == x)
            if slg_keep is not None and bool((slg_keep[i] != 1).any()):
                keep = slg_keep[i].to(dev)
            cam = _encode_cam(blk, cfg, cam_emb, grid, b, l, out.dtype)
            if i not in vace:
                out = blk(out, e0, freqs, ctx, cmask, keep, attn_mode,
                          img_ctx, cam)
                continue
            # a VACE hint block: it takes the embedded context (through
            # before_proj) plus the tokens at the first hint layer, then
            # its own stream; each hint is added as its layer runs
            vp = model.vace_blocks[vace[i]]
            if vace[i] == 0:
                c = vp.before_proj(c) + out
            c = vp(c, e0, freqs, ctx, cmask, None, attn_mode)
            out = blk(out, e0, freqs, ctx, cmask, keep, attn_mode, img_ctx,
                      cam)
            hint = vp.after_proj(c) * vace_scale
            if keep is not None:
                # an SLG-skipped stream skips the whole block, hint included
                hint = hint * keep.to(hint.dtype)[:, None, None]
            out = out + hint
            del hint
        residual = out - tokens

    # the head runs in fp32 whatever the policy: guidance multiplies the
    # difference of two velocities by guide_scale, and with it their
    # rounding (JAX's Wan activations follow its fp32 latents throughout)
    hm = model.head.modulation.float()               # [1, 2, D]
    he = hm[:, None] + e[:, :, None]                 # [B, G, 2, D]
    y = _mod(layer_norm(out.float(), eps=cfg.eps), he[:, :, 0], he[:, :, 1])
    y = model.head.head(y)
    return unpatchify(y, grid, cfg), residual


def _encode_cam(p: Block, cfg: WanConfig, cam_emb, grid, b, l, dtype):
    """ReCamMaster's camera tokens of one block: the pose rows ``[B, F',
    12]`` through this block's ``cam_encoder``, tiled (a repeat of the
    whole row list, as torch's ``.repeat(1, 2, 1)``) where they cover
    fewer frames than the grid, one row a latent frame broadcast over (H,
    W): ``[B, L, D]``. Rows that already cover the frames
    (:func:`expand_cam_to_frames`) are not tiled. None without poses or
    without a ``cam_encoder``."""
    if cam_emb is None or not hasattr(p, "cam_encoder"):
        return None
    f, h, w = grid
    ce = p.cam_encoder(cam_emb.to(dtype))
    if ce.shape[1] < f:
        ce = ce.repeat(1, 2, 1)                      # [B, 2F', D]
    ce = ce[:, :f, None, None, :].expand(b, f, h, w, cfg.dim)
    return ce.reshape(b, -1, cfg.dim)[:, :l]


def expand_cam_to_frames(cam_emb: torch.Tensor,
                         num_frames: int) -> torch.Tensor:
    """Pose rows ``[B, F', 12]`` -> one a frame ``[B, F, 12]``, the frame
    -> pose map of :func:`_encode_cam` (frame f takes row f, wrapping past
    F')."""
    tiled = torch.cat([cam_emb, cam_emb], dim=1)
    if tiled.shape[1] < num_frames:
        raise ValueError(f"cam_emb rows ({cam_emb.shape[1]}) cover at most "
                         f"2x rows; need {num_frames} frames")
    return tiled[:, :num_frames]


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in the JAX ``init_params`` distribution: linear
    kernels N(0, 1/d_in), zero biases, unit norm weights, the patch
    convs N(0, 1/fan_in), modulation tables N(0, 1/D), the fps table
    N(0, 0.02**2), ReCamMaster's projector the identity and VACE's
    before / after projections zero. ``model`` is a
    :class:`WanModel` or one :class:`Block` (a layer-by-layer build).
    Draws on the model's device from ``generator``."""
    d = model.cfg.dim

    def randn(t):
        return torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=t.dtype)

    for mod in model.modules():
        if isinstance(mod, Linear) and not mod.quantized:
            mod.weight.copy_(randn(mod.weight) * mod.d_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
    for name in ("patch_embedding", "vace_patch_embedding"):
        pe = getattr(model, name, None)
        if pe is not None:
            pe.weight.copy_(randn(pe.weight)
                            * math.prod(pe.weight.shape[1:]) ** -0.5)
            pe.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("modulation"):
            p.copy_(randn(p) / d ** 0.5)
        elif name == "fps_embedding":
            p.copy_(randn(p) * 0.02)
    # JAX's starting values: ReCamMaster's projector the identity, VACE's
    # before / after projections zero
    for mod in model.modules():
        for name in ("projector", "before_proj", "after_proj"):
            lin = getattr(mod, name, None)
            if isinstance(lin, Linear) and not lin.quantized:
                lin.weight.zero_()
                if name == "projector":
                    lin.weight.fill_diagonal_(1.0)
    return model
