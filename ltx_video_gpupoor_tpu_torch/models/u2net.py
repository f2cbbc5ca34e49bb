"""U2-Net salient-object detection (the rembg model), for background
removal.

Port of ``ltx_video_gpupoor_tpu/models/u2net.py``: ``U2NetConfig`` with
``U2NET`` and ``U2NETP`` (:33-57), the RSU blocks (:87-112: REBNCONV
convs with the batch norm folded into a scale and shift, ceil-mode 2x2
max pools, bilinear skip upsampling, the dilated RSU4F), ``forward``
(:115: six encoder stages, five decoder stages, six side outputs fused by
a 1x1 conv, a sigmoid), ``convert_torch_state_dict`` (:184, the official
``u2net.pth`` naming, each BN folded), ``salience_map`` (:247, the rembg
predict pipeline at 320x320) and ``load_torch_checkpoint`` (:290).

Modules carry the JAX keys (``stage1.rebnconvin.{weight, scale,
shift}``, ``side1``, ``outconv``), so ``core/from_jax.py::
u2net_state_dict`` carries JAX's weights over. Tensors are channels-first
``[B, C, H, W]`` (torch's conv layout) inside; ``salience_map`` takes and
returns host arrays as JAX's does, the network on the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class U2NetConfig:
    # (height, in_ch, mid_ch, out_ch, dilated) per encoder stage;
    # decoder mirrors it
    full: bool = True

    @property
    def stages(self):
        if self.full:
            enc = [(7, 3, 32, 64, False), (6, 64, 32, 128, False),
                   (5, 128, 64, 256, False), (4, 256, 128, 512, False),
                   (4, 512, 256, 512, True), (4, 512, 256, 512, True)]
            dec = [(4, 1024, 256, 512, True), (4, 1024, 128, 256, False),
                   (5, 512, 64, 128, False), (6, 256, 32, 64, False),
                   (7, 128, 16, 64, False)]
        else:  # u2netp
            enc = [(7, 3, 16, 64, False), (6, 64, 16, 64, False),
                   (5, 64, 16, 64, False), (4, 64, 16, 64, False),
                   (4, 64, 16, 64, True), (4, 64, 16, 64, True)]
            dec = [(4, 128, 16, 64, True), (4, 128, 16, 64, False),
                   (5, 128, 16, 64, False), (6, 128, 16, 64, False),
                   (7, 128, 16, 64, False)]
        return enc, dec


U2NET = U2NetConfig(full=True)
U2NETP = U2NetConfig(full=False)


class REBNConv(nn.Module):
    """3x3 conv ``weight [cout, cin, 3, 3]`` + the folded batch norm's
    ``scale`` / ``shift``."""

    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, **kw),
                                   requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout, **kw), requires_grad=False)
        self.shift = nn.Parameter(torch.zeros(cout, **kw),
                                  requires_grad=False)


class RSU(nn.Module):
    def __init__(self, height, cin, cmid, cout, **kw):
        super().__init__()
        self.rebnconvin = REBNConv(cin, cout, **kw)
        self.rebnconv1 = REBNConv(cout, cmid, **kw)
        for i in range(2, height + 1):
            setattr(self, f"rebnconv{i}", REBNConv(cmid, cmid, **kw))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNConv(2 * cmid, cmid, **kw))
        self.rebnconv1d = REBNConv(2 * cmid, cout, **kw)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, **kw),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, **kw), requires_grad=False)


class U2Net(nn.Module):
    """``stage1``..``stage6``, ``stage5d``..``stage1d``, ``side1``..
    ``side6``, ``outconv``; fp32 weights by default."""

    def __init__(self, cfg: U2NetConfig = U2NET, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        enc, dec = cfg.stages
        for i, (h, cin, cmid, cout, _) in enumerate(enc):
            setattr(self, f"stage{i + 1}", RSU(h, cin, cmid, cout, **kw))
        side_ch = [enc[5][3]]
        for i, (h, cin, cmid, cout, _) in enumerate(dec):
            setattr(self, f"stage{5 - i}d", RSU(h, cin, cmid, cout, **kw))
            side_ch.append(cout)
        for i, c in enumerate(reversed(side_ch)):
            setattr(self, f"side{i + 1}", _Conv(c, 1, 3, **kw))
        self.outconv = _Conv(6, 1, 1, **kw)


@torch.no_grad()
def init_params(model: U2Net, generator: torch.Generator) -> U2Net:
    """Random weights in the JAX ``init_params`` distribution: REBNCONV
    kernels N(0, 1 / (9 cin)) with the identity fold, side convs
    N(0, 0.02**2), the fuse conv N(0, 0.1**2), zero biases."""
    def randn_(w, std):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=w.dtype) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, REBNConv):
            randn_(mod.weight, (9 * mod.weight.shape[1]) ** -0.5)
        elif isinstance(mod, _Conv):
            randn_(mod.weight, 0.1 if name == "outconv" else 0.02)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(p: REBNConv, x, dilation=1):
    """3x3 same conv + the folded BN's scale / shift + ReLU (REBNCONV)."""
    y = F.conv2d(x, p.weight, padding=dilation, dilation=dilation)
    return F.relu(y * p.scale[:, None, None] + p.shift[:, None, None])


def _pool(x):
    """2x2 stride-2 max pool, ceil mode."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x, ref):
    """Bilinear resize to ``ref``'s spatial size, half-pixel centres (only
    ever up, where JAX's antialiased resize is the plain one)."""
    if x.shape[-2:] == ref.shape[-2:]:
        return x
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear",
                         align_corners=False)


def _rsu(p: RSU, x, height, dilated):
    hxin = _conv(p.rebnconvin, x)
    if dilated:  # RSU4F: the dilation doubles each level, no pooling
        hs = [hxin]
        for i in range(1, height + 1):
            hs.append(_conv(getattr(p, f"rebnconv{i}"), hs[-1],
                            dilation=2 ** (i - 1)))
        hx = hs[-1]
        for i in range(height - 1, 0, -1):
            hx = _conv(getattr(p, f"rebnconv{i}d"),
                       torch.cat([hx, hs[i]], 1), dilation=2 ** (i - 1))
        return hx + hxin
    hs = [hxin]
    hx = _conv(p.rebnconv1, hxin)
    hs.append(hx)
    for i in range(2, height):
        hx = _conv(getattr(p, f"rebnconv{i}"), _pool(hx))
        hs.append(hx)
    hx = _conv(getattr(p, f"rebnconv{height}"), hx, dilation=2)
    for i in range(height - 1, 0, -1):
        hx = _conv(getattr(p, f"rebnconv{i}d"), torch.cat([hx, hs[i]], 1))
        if i > 1:
            hx = _up_to(hx, hs[i - 1])
    return hx + hxin


@torch.no_grad()
def forward(model: U2Net, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` (normalized) -> ``[B, H, W, 1]`` salience in
    [0, 1]: the sigmoid of the fused side output."""
    enc, dec = model.cfg.stages
    hx = x.to(model.outconv.weight).permute(0, 3, 1, 2)
    hxs = []
    for i, (height, *_, dil) in enumerate(enc):
        hx = _rsu(getattr(model, f"stage{i + 1}"), hx, height, dil)
        hxs.append(hx)
        if i < 5:
            hx = _pool(hx)
    d_in = _up_to(hxs[5], hxs[4])
    outs = [hxs[5]]
    for i, (height, *_, dil) in enumerate(dec):
        stage = 5 - i
        hx = _rsu(getattr(model, f"stage{stage}d"),
                  torch.cat([d_in, hxs[stage - 1]], 1), height, dil)
        outs.append(hx)
        if stage > 1:
            d_in = _up_to(hx, hxs[stage - 2])
    ref = outs[-1]
    sides = []
    for i in range(1, 7):
        src = outs[6 - i]
        p = getattr(model, f"side{i}")
        d = F.conv2d(src, p.weight, p.bias, padding=1)
        sides.append(_up_to(d, ref))
    p = model.outconv
    fused = F.conv2d(torch.cat(sides, 1), p.weight, p.bias)
    return torch.sigmoid(fused).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Conversion and the rembg pipeline
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd: dict, cfg: U2NetConfig = U2NET,
                             eps: float = 1e-5) -> dict:
    """Official ``u2net.pth`` / ``u2netp.pth`` naming -> the ``state_dict``
    of :class:`U2Net`, each REBNCONV's batch norm folded: ``scale = gamma
    / sqrt(var + eps)``, ``shift = beta + (conv bias - mean) * scale``
    (exact at inference; computed in fp32 as JAX does in numpy)."""
    def g(name):
        return torch.as_tensor(np.asarray(sd[name], np.float32))

    out = {}

    def rebnconv(ours, pre):
        scale = g(pre + "bn_s1.weight") / torch.sqrt(
            g(pre + "bn_s1.running_var") + eps)
        out[ours + "weight"] = g(pre + "conv_s1.weight")
        out[ours + "scale"] = scale
        out[ours + "shift"] = g(pre + "bn_s1.bias") + (
            g(pre + "conv_s1.bias") - g(pre + "bn_s1.running_mean")) * scale

    enc, dec = cfg.stages
    names = [(f"stage{i + 1}", h) for i, (h, *_) in enumerate(enc)] + \
        [(f"stage{5 - i}d", h) for i, (h, *_) in enumerate(dec)]
    for name, h in names:
        convs = ["rebnconvin"] + [f"rebnconv{i}" for i in range(1, h + 1)] \
            + [f"rebnconv{i}d" for i in range(h - 1, 0, -1)]
        for c in convs:
            rebnconv(f"{name}.{c}.", f"{name}.{c}.")
    for n in [f"side{i}" for i in range(1, 7)] + ["outconv"]:
        out[n + ".weight"] = g(n + ".weight")
        out[n + ".bias"] = g(n + ".bias")
    return out


_SALIENCE_SIZE = 320  # rembg's U2-Net input resolution


@torch.no_grad()
def salience_map(model: U2Net, image: np.ndarray) -> np.ndarray:
    """``[H, W, 3]`` uint8 -> ``[H, W]`` float32 alpha in [0, 1]: the rembg
    predict pipeline (Lanczos resize to 320, per-image max normalize,
    ImageNet stats, the network, min-max rescale, resize back)."""
    from PIL import Image

    h, w = image.shape[:2]
    pil = Image.fromarray(image).convert("RGB").resize(
        (_SALIENCE_SIZE, _SALIENCE_SIZE), Image.Resampling.LANCZOS)
    arr = np.asarray(pil, np.float32)
    arr = arr / max(arr.max(), 1e-6)
    arr = (arr - np.asarray((0.485, 0.456, 0.406))) \
        / np.asarray((0.229, 0.224, 0.225))
    x = torch.from_numpy(arr[None].astype(np.float32))
    pred = forward(model, x)[0, :, :, 0].float().cpu().numpy()
    pred = (pred - pred.min()) / max(pred.max() - pred.min(), 1e-6)
    out = Image.fromarray((pred * 255).astype(np.uint8)).resize(
        (w, h), Image.Resampling.LANCZOS)
    return np.asarray(out, np.float32) / 255.0


def load_torch_checkpoint(path: str, cfg: U2NetConfig = U2NET, *,
                          device=None) -> U2Net:
    """The official ``u2net.pth`` (a torch pickle of tensors) or a
    safetensors export of it -> :class:`U2Net` on ``device`` (the card
    unless told the CPU)."""
    from ..core.checkpoint import build_module, load_safetensors
    from .llm import resolve_device

    if path.endswith(".safetensors"):
        sd, _ = load_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return build_module(U2Net(cfg, device="meta"),
                        convert_torch_state_dict(sd, cfg), "U2-Net",
                        resolve_device(device))
