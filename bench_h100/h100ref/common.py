"""The plain reference's primitives, in float32.

Frozen copies of the arithmetic that ``ltx_video_gpupoor_tpu_torch``'s
``ops/norms.py``, ``ops/rope.py`` (``ltx_freqs_cis``, ``apply_rotary_emb``)
and ``models/ltx/transformer3d.py::timestep_embedding`` compute, and the
dynamic int8 linear the configuration states (``ops/quant.py``: int8
weights per output channel, int8 activations per row, scales applied
after the integer product), written here in float32 with TF32 off. The
product of integer-valued float32 matrices is exact term by term; its sums
round in float32. Attention is the exact softmax in float32, whatever tier
the program runs (its int8 attention is judged against this).

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def strict_fp32() -> None:
    """Float32 matmuls and convolutions without TF32, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x, weight=None, eps=1e-5):
    ms = x.square().sum(dim=-1, keepdim=True, dtype=torch.float64) / x.shape[-1]
    y = x * torch.rsqrt(ms.float() + eps)
    return y if weight is None else y * weight


def layer_norm(x, weight=None, bias=None, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def pixel_norm(x, axis=1, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=axis, keepdim=True) + eps)


def group_norm(x, num_groups, weight, bias, eps, channel_axis=1):
    ax = channel_axis % x.ndim
    c = x.shape[ax]
    xg = x.reshape(x.shape[:ax] + (num_groups, c // num_groups)
                   + x.shape[ax + 1:])
    red = tuple(i for i in range(xg.ndim) if i not in (0, ax))
    mu = xg.mean(dim=red, keepdim=True)
    var = (xg - mu).square().mean(dim=red, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = [1] * x.ndim
    shape[ax] = c
    return y * weight.reshape(shape) + bias.reshape(shape)


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linspace(start, stop, num, device):
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / div
    step = torch.arange(div, dtype=torch.float32, device=device) * recip.to(device)
    out = torch.tensor(start, dtype=torch.float32) * (1 - step) + \
        torch.tensor(stop, dtype=torch.float32) * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32,
                                        device=device)])


def ltx_freqs(indices_grid, dim, theta, max_pos):
    """RoPE tables ``(cos, sin)`` ``[B, S, dim/2]`` (one entry a rotation
    pair) from ``[B, 3, S]`` fractional coordinates."""
    dev = indices_grid.device
    fractional = torch.stack(
        [indices_grid[:, i].float() / max_pos[i] for i in range(3)], dim=-1)
    n = dim // 6
    start = math.log(1.0, theta) if theta != 1.0 else 0.0
    idx = torch.pow(torch.tensor(float(theta), dtype=torch.float64),
                    _linspace(start, 1.0, n, dev).double()).float()
    idx = idx * math.pi / 2
    b, s = fractional.shape[:2]
    freqs = (idx[None, None, :, None]
             * (fractional[:, :, None, :] * 2 - 1)).reshape(b, s, -1)
    pad = dim % 6
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if pad:
        cos = torch.cat([torch.ones_like(cos[..., :pad // 2]), cos], -1)
        sin = torch.cat([torch.zeros_like(sin[..., :pad // 2]), sin], -1)
    return cos, sin


def apply_rotary(x, cos, sin):
    """Interleaved pairs rotated by half-width tables."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack([a * cos - b * sin, b * cos + a * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, max_bytes=2 << 30):
    """Exact softmax attention over ``[B, H, S, D]`` in float32, a few heads
    at a time so that the scores stay under ``max_bytes``."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    step = max(1, int(max_bytes // (4 * b * sq * skv)))
    out = torch.empty(b, h, sq, v.shape[-1], dtype=torch.float32,
                      device=q.device)
    for i in range(0, h, step):
        s = torch.matmul(q[:, i:i + step], k[:, i:i + step].transpose(-1, -2))
        p = torch.softmax(s * d ** -0.5, dim=-1)
        del s
        out[:, i:i + step] = torch.matmul(p, v[:, i:i + step])
        del p
    return out


def quantize_weights(w):
    """Per-output-channel int8 codes and float32 scales of ``[out, in]``."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


class Linear(nn.Module):
    """``y = x W^T + b`` in float32, or after :meth:`quantize_` the dynamic
    int8 linear: each row of ``x`` quantized by its absmax / 127, the
    integer product, then the two scales and the bias."""

    def __init__(self, d_in, d_out, bias=True, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device),
                                  requires_grad=False) if bias else None)
        self.codes = None

    def quantize_(self):
        self.codes, self.scale = quantize_weights(self.weight)
        del self.weight

    def forward(self, x):
        if self.codes is None:
            y = F.linear(x, self.weight)
        else:
            k = x.shape[-1]
            x2 = x.reshape(-1, k)
            amax = x2.abs().amax(dim=-1, keepdim=True)
            s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
            xq = torch.clamp(torch.round(x2 / s), -127, 127)
            y = (xq @ self.codes.float().T) * s * self.scale
            y = y.reshape(*x.shape[:-1], -1)
        return y if self.bias is None else y + self.bias
