"""Random weights drawn from the run's seed, one group of tensors at a time.

A group is a set of named parameters that one ``torch.Generator`` fills in
a single ``randn`` call: the DiT's tensors outside its blocks, each DiT
block, the VAE, the latent upsampler. The generator's seed is derived from
the run's seed and the group's name, so the program's set-up and the plain
reference draw the same values for the same group without one handing its
tensors to the other, and the reference can draw any block again on its
own. The values are drawn in the dtype the weights are served in
(bfloat16) and scaled in that dtype; the reference upcasts them.

Scales, by parameter name and shape: a matrix or convolution kernel
N(0, 1/fan_in); a bias N(0, 0.02^2); a one-dimensional weight (a norm's)
1 + N(0, 0.05^2); a ``scale_shift_table`` N(0, 1/width). Buffers (the VAE's
latent statistics, its timestep multiplier) keep the values the modules
give them.
"""

from __future__ import annotations

import hashlib
import math

import torch


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for ``group`` under the run's ``seed``."""
    digest = hashlib.sha256(f"{seed}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _scaled(name: str, raw: torch.Tensor, shape) -> torch.Tensor:
    x = raw.reshape(shape)
    if name.endswith("scale_shift_table"):
        return x / math.sqrt(shape[-1])
    if len(shape) >= 2:
        return x / math.sqrt(math.prod(shape[1:]))
    if name.endswith("bias"):
        return x * 0.02
    if name.endswith("weight"):
        return 1 + x * 0.05
    return x * 0.02


def draw_group(seed: int, group: str, shapes: dict, device,
               dtype=torch.bfloat16) -> dict:
    """``{name: tensor}`` for the parameters ``shapes`` names (``{name:
    shape}``), in sorted name order out of one ``randn`` call."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        out[name] = _scaled(name, buf[at:at + size], tuple(shapes[name]))
        at += size
    return out


def param_shapes(module: torch.nn.Module) -> dict:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, group: str) -> torch.nn.Module:
    """Copy the group's draw into ``module``'s parameters (cast to their
    dtype: the reference's float32 holds the bfloat16 values exactly)."""
    params = dict(module.named_parameters())
    dev = next(iter(params.values())).device
    drawn = draw_group(seed, group, param_shapes(module), dev)
    for name, p in params.items():
        p.copy_(drawn[name])
    return module
