"""CLIP ViT-H/14 vision encoder for Wan image-to-video conditioning.

Port of ``ltx_video_gpupoor_tpu/models/wan/clip.py``: ``CLIP_MEAN`` /
``CLIP_STD``, ``CLIPVisionConfig``, ``init_params`` (as
:func:`init_params` on a module), ``_block`` (pre-norm: attention, then a
GELU MLP), ``visual`` (CLIP normalization, the 14x14 patch conv, the class
token, positions, the pre-norm and the first 31 of 32 blocks with
``use_31_block``: ``[B, 257, 1280]``) and ``resize_bicubic``.

The parameter tree becomes modules whose attribute names are the JAX keys
(``core/from_jax.py`` relies on that); the stacked ``blocks`` become a
list. Attention goes through ``ops.attention.attention`` with no mode, as
JAX calls it: ``auto`` at the head dim of 80 resolves to the int8 QK+PV
tier, kernel K4 on the card (its D = 80 instance). The linears are dense
(``x @ kernel + bias`` in the activation dtype, as JAX's ``_block``).

``resize_bicubic`` computes what the JAX package's does,
``jax.image.resize(..., "bicubic", antialias=False)``: Keys' cubic with
a = -0.5 (torch's ``F.interpolate`` bicubic takes -0.75, a different
function), its weights renormalized over the taps that fall inside the
image, one weight matrix a spatial axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.attention import attention
from ...ops.norms import layer_norm
from ...ops.quant import Linear

# open-clip ViT-H/14 image normalization
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    activation: str = "gelu"
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Norm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, **kw), requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.to_qkv = Linear(d, 3 * d, **kw)
        self.proj = Linear(d, d, **kw)


class _MLP(nn.Module):
    def __init__(self, d, hidden, **kw):
        super().__init__()
        self.fc1 = Linear(d, hidden, **kw)
        self.fc2 = Linear(hidden, d, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.norm1 = _Norm(d, **kw)
        self.attn = _Attn(d, **kw)
        self.norm2 = _Norm(d, **kw)
        self.mlp = _MLP(d, d * cfg.mlp_ratio, **kw)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        p = cfg.patch_size
        self.weight = nn.Parameter(torch.empty(cfg.dim, 3, p, p, **kw),
                                   requires_grad=False)


class CLIPVision(nn.Module):
    """The vision tower: ``patch_embedding``, ``cls_embedding [1, 1, D]``,
    ``pos_embedding [1, 257, D]``, ``pre_norm`` and ``blocks``."""

    def __init__(self, cfg: CLIPVisionConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        d = cfg.dim
        self.patch_embedding = _PatchEmbed(cfg, **kw)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, d, **kw),
                                          requires_grad=False)
        self.pos_embedding = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, d, **kw), requires_grad=False)
        self.pre_norm = _Norm(d, **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))


def _block(cfg: CLIPVisionConfig, p: _Block, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``."""
    b, s, d = x.shape
    n = cfg.num_heads
    hd = d // n
    h = layer_norm(x, p.norm1.weight, p.norm1.bias, eps=cfg.norm_eps)
    # head-split views of the fused projection: the kernels read them in
    # place
    q, k, v = p.attn.to_qkv(h).reshape(b, s, 3, n, hd).permute(2, 0, 3, 1, 4)
    a = attention(q, k, v).transpose(1, 2).reshape(b, s, d)
    x = x + p.attn.proj(a)
    h = layer_norm(x, p.norm2.weight, p.norm2.bias, eps=cfg.norm_eps)
    h = p.mlp.fc1(h)
    if cfg.activation == "quick_gelu":
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.gelu(h, approximate="none")
    return x + p.mlp.fc2(h)


@torch.no_grad()
def visual(model: CLIPVision, images: torch.Tensor,
           use_31_block: bool = True) -> torch.Tensor:
    """i2v features: ``images [B, H, W, 3]`` in [-1, 1] at the config's
    size (the resize is the caller's, :func:`resize_bicubic`) ->
    ``[B, 257, dim]`` in the policy's compute dtype, from the
    penultimate block with ``use_31_block``."""
    cfg = model.cfg
    dev = model.pos_embedding.device
    mean = torch.from_numpy(CLIP_MEAN).to(dev)
    std = torch.from_numpy(CLIP_STD).to(dev)
    x = ((images.to(dev) + 1.0) / 2.0 - mean) / std
    x = x.to(model.compute_dtype)
    patches = F.conv2d(x.permute(0, 3, 1, 2),
                       model.patch_embedding.weight.to(x.dtype),
                       stride=cfg.patch_size)
    b = x.shape[0]
    tokens = patches.flatten(2).transpose(1, 2)            # [B, 256, D]
    cls = model.cls_embedding.to(x.dtype).expand(b, 1, cfg.dim)
    x = torch.cat([cls, tokens], dim=1) + model.pos_embedding.to(x.dtype)
    x = layer_norm(x, model.pre_norm.weight, model.pre_norm.bias,
                   eps=cfg.norm_eps)
    n_layers = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    for blk in model.blocks[:n_layers]:
        x = _block(cfg, blk, x)
    return x


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, at ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]``: output sample j at ``(j + 0.5) n_in / n_out -
    0.5``, the kernel at its distance to each input pixel, each column
    divided by its sum (0 where the sum is about 0 or the sample lies
    outside the image), in fp32 as ``jax.image``'s weight matrix."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - pos[:, None]).abs())
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(image: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, size, size, C]``: JAX's bicubic resize
    without antialias (the reference's ``F.interpolate(mode="bicubic",
    align_corners=False)`` call as the JAX package computes it)."""
    b, h, w, c = image.shape
    wh = _resize_weights(h, size, image.device).to(image.dtype)
    ww = _resize_weights(w, size, image.device).to(image.dtype)
    return torch.einsum("bhwc,hp,wq->bpqc", image, wh, ww)


@torch.no_grad()
def init_params(model: CLIPVision, generator: torch.Generator) -> CLIPVision:
    """Random weights in the JAX ``init_params`` distribution: linear
    kernels N(0, 1/d_in), zero biases, unit norm weights, the patch conv
    N(0, 1/(3 p^2)), the class and position embeddings N(0, 1/D). Draws
    on the model's device from ``generator``."""
    def randn(t):
        return torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=t.dtype)

    d = model.cfg.dim
    for mod in model.modules():
        if isinstance(mod, Linear):
            mod.weight.copy_(randn(mod.weight) * mod.d_in ** -0.5)
    w = model.patch_embedding.weight
    w.copy_(randn(w) * (3 * model.cfg.patch_size ** 2) ** -0.5)
    model.cls_embedding.copy_(randn(model.cls_embedding) * d ** -0.5)
    model.pos_embedding.copy_(randn(model.pos_embedding) * d ** -0.5)
    return model
