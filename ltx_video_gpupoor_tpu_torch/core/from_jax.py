"""Carry the JAX package's weights into the port's modules.

The input is a JAX parameter tree as nested dicts/lists of numpy arrays
(what ``jax.tree.map(np.asarray, params)`` gives); the output is a
``state_dict`` for the matching port module. The port's modules use the
JAX keys as attribute names, so the conversion is mechanical:

- ``kernel`` leaves become ``weight``. A 2-D kernel (linear, JAX
  ``[in, out]``) is transposed to torch's ``[out, in]``; a 5-D kernel
  (conv, JAX ``(kt, kh, kw, cin, cout)``) is permuted to
  ``(cout, cin, kt, kh, kw)``, a 4-D one (the Wan VAE's framewise 2-D
  convs, JAX ``(kh, kw, cin, cout)``) to ``(cout, cin, kh, kw)``.
- int8 leaves ``{w_int8_dyn | w_int8 [K, N] int8, scale [N] f32}`` become
  ``[N, K]`` (row-major, K contiguous: the column-major B operand that
  kernel K2 reads) and ``scale [N]``; int4 leaves ``{w_int4 [K/2, N],
  scale [K/g, N] or [N]}`` become ``w_int4 [N, K/2]`` (the nibble pairs
  still run along K) and ``scale [N, K/g]`` or ``[N]``.
- per-layer stacks (``blocks``, leading axis L) become ``blocks.{i}.*``.
- lists (the VAE's ``up_blocks``, ``res_blocks``) become ``name.{i}.*``.
- every other leaf keeps its name and layout; empty dicts vanish.

bfloat16 leaves (``ml_dtypes``) arrive as torch bfloat16.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

STACKED = ("blocks",)


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _leaf(name: str, a: np.ndarray) -> tuple[str, torch.Tensor]:
    t = to_torch(a)
    if name == "kernel":
        if t.dim() == 2:
            return "weight", t.T.contiguous()
        if t.dim() == 5:
            return "weight", t.permute(4, 3, 0, 1, 2).contiguous()
        if t.dim() == 4:
            return "weight", t.permute(3, 2, 0, 1).contiguous()
        raise ValueError(f"kernel of rank {t.dim()}")
    if name in ("w_int8_dyn", "w_int8", "w_int4") or (
            name == "scale" and t.dim() == 2):
        return name, t.T.contiguous()
    return name, t


def _walk(tree: Any, prefix: str, out: dict, stacked: Iterable[str]):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            path = f"{prefix}{key}"
            if key in stacked and isinstance(sub, dict):
                n = _stack_len(sub)
                for i in range(n):
                    _walk(_index(sub, i), f"{path}.{i}.", out, stacked)
            else:
                _walk(sub, path + ".", out, stacked)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _walk(sub, f"{prefix}{i}.", out, stacked)
    else:
        parts = prefix[:-1].rsplit(".", 1)
        head = parts[0] + "." if len(parts) == 2 else ""
        name, t = _leaf(parts[-1], tree)
        out[head + name] = t


def _stack_len(tree) -> int:
    if isinstance(tree, dict):
        for sub in tree.values():
            return _stack_len(sub)
        raise ValueError("empty stacked subtree")
    return np.asarray(tree).shape[0]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict(tree: dict, stacked: Iterable[str] = STACKED) -> dict:
    """A JAX parameter tree -> the flat ``state_dict`` of the port module
    with the same keys: ``transformer3d.init_params`` (optionally after
    ``quantize_params(mode="dynamic")``) -> ``LTXTransformer3D``, the Wan
    ``model.init_params`` (stacked ``blocks``, ``[1, 6, D]`` modulation
    leaves, the 5-D patch conv; optionally quantized) -> ``WanModel``,
    ``t5.init_params`` -> ``T5Encoder``, the Wan ``vae.init_params`` ->
    ``WanVAE``, the Wan ``clip.init_params`` -> ``CLIPVision``."""
    out: dict[str, torch.Tensor] = {}
    _walk(tree, "", out, tuple(stacked))
    return out


def vae_decoder_state_dict(params: dict) -> dict:
    """``models/ltx/vae.init_params`` tree -> ``CausalVAEDecoder`` (the
    encoder and ``quant_conv`` are dropped)."""
    keep = {k: v for k, v in params.items()
            if k not in ("encoder", "quant_conv")}
    return state_dict(keep)


def vae_state_dict(params: dict) -> dict:
    """``models/ltx/vae.init_params`` tree -> ``CausalVAE`` (encoder,
    decoder, statistics and, where the config has them, the quant
    convs)."""
    return state_dict(params)


def upsampler_state_dict(params: dict) -> dict:
    """``models/ltx/latent_upsampler.init_params`` tree ->
    ``LatentUpsampler`` (4-D kernels are its framewise 2-D convs)."""
    return state_dict(params)


def wan_vae_decoder_state_dict(params: dict) -> dict:
    """Wan ``models/wan/vae.init_params`` tree -> ``WanVAEDecoder`` (the
    encoder and its ``conv1`` are dropped)."""
    keep = {k: v for k, v in params.items() if k not in ("encoder", "conv1")}
    return state_dict(keep)
