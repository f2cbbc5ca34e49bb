"""Synthetic LTX checkpoint files in the published layout, from a seed.

The published weights are not in the repository and cannot be fetched,
so the loaders (``core/checkpoint.py``, ``runtime/native_loader.py``,
``serving/model_zoo.py::load_ltxv_model``) are held on files written
here in the layout the releases use, under the names the download layer
provisions (``serving/downloads.py``):

- ``ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors``: the transformer in
  the reference's naming (``transformer_blocks.{i}.attn1.to_out.0``,
  ``adaln_single.emb.timestep_embedder.linear_1``, ``ff.net.0.proj``,
  ...), every linear weight as a quanto int8 pair ``weight._data`` int8
  ``[out, in]`` + ``weight._scale`` bf16 ``[out, 1]``, the rest bf16, and
  ``{"transformer": {...}}`` as the ``config`` metadata;
- ``ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors``: a LoRA over
  every block linear (``diffusion_model.transformer_blocks.{i}...
  .lora_A.weight`` ``[r, in]`` / ``.lora_B.weight`` ``[out, r]``, bf16);
- ``ltxv_0.9.7_VAE.safetensors``: the causal VAE (encoder and decoder)
  with ``per_channel_statistics.std-of-means`` / ``mean-of-means`` and
  ``time_embedder.timestep_embedder.linear_1``, bf16 weights, its config
  as metadata;
- ``ltxv_0.9.7_spatial_upscaler.safetensors``: the latent upsampler
  (``upsampler.0``), its config as metadata.

Weights follow the JAX ``init_params`` distributions (linear weights
N(0, 1/d_in), zero biases, unit norm weights, tables N(0, 1/d)), drawn
tensor by tensor on ``device`` (the card, for the full-width 13B), so no
whole model is ever materialized in floats.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from ..core.checkpoint import save_safetensors
from ..core.dtypes import DEFAULT_POLICY
from ..models.ltx import latent_upsampler as lup
from ..models.ltx import transformer3d as tf
from ..models.ltx import vae as ltx_vae
from ..ops.quant import quantize_weights

TRANSFORMER_FILE = "ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors"
LORA_FILE = "ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors"
VAE_FILE = "ltxv_0.9.7_VAE.safetensors"
UPSCALER_FILE = "ltxv_0.9.7_spatial_upscaler.safetensors"

# the port's key -> the reference's (prefix renames, applied in order)
_TO_PUBLISHED = [
    ("adaln.emb_linear_1.", "adaln_single.emb.timestep_embedder.linear_1."),
    ("adaln.emb_linear_2.", "adaln_single.emb.timestep_embedder.linear_2."),
    ("adaln.linear.", "adaln_single.linear."),
    ("blocks.", "transformer_blocks."),
]
_BLOCK_RENAMES = [(".to_out.", ".to_out.0."), (".ff.proj_in.", ".ff.net.0.proj."),
                  (".ff.proj_out.", ".ff.net.2.")]
LORA_TARGETS = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0",
                "ff.net.0.proj", "ff.net.2")


def published_key(key: str) -> str:
    """A key of the port's ``LTXTransformer3D`` state_dict -> the
    reference's name of the same weight."""
    for a, b in _TO_PUBLISHED:
        if key.startswith(a):
            key = b + key[len(a):]
    for a, b in _BLOCK_RENAMES:
        key = key.replace(a, b)
    return key


def _draw(shape, std, gen, device):
    return torch.randn(shape, generator=gen, device=device) * std


@torch.no_grad()
def transformer_tensors(cfg: tf.LTXTransformerConfig, *, seed: int = 0,
                        device="cpu") -> dict[str, torch.Tensor]:
    """The quanto int8 transformer file's tensors (on the CPU)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    meta = tf.LTXTransformer3D(cfg, DEFAULT_POLICY, device="meta")
    out: dict[str, torch.Tensor] = {}
    for key, p in meta.state_dict().items():
        name = published_key(key)
        if key.endswith(".weight") and p.dim() == 2:
            q = quantize_weights(_draw(p.shape, p.shape[1] ** -0.5, gen,
                                       device))
            out[name + "._data"] = q.w_int8.cpu()
            out[name + "._scale"] = q.scale[:, None].to(torch.bfloat16).cpu()
        elif key.endswith("scale_shift_table"):
            out[name] = _draw(p.shape, cfg.inner_dim ** -0.5, gen,
                              device).to(torch.bfloat16).cpu()
        elif key.endswith("norm.weight"):
            out[name] = torch.ones(p.shape, dtype=torch.bfloat16)
        else:   # biases
            out[name] = torch.zeros(p.shape, dtype=torch.bfloat16)
    return out


@torch.no_grad()
def lora_tensors(cfg: tf.LTXTransformerConfig, rank: int, *, seed: int = 1,
                 device="cpu", std: float = 0.01) -> dict[str, torch.Tensor]:
    """A LoRA over every block linear of ``cfg``'s transformer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    meta = tf.LTXTransformer3D(cfg, DEFAULT_POLICY, device="meta")
    shapes = {published_key(k): p.shape for k, p in meta.state_dict().items()}
    out = {}
    for i in range(cfg.num_layers):
        for target in LORA_TARGETS:
            base = f"transformer_blocks.{i}.{target}"
            d_out, d_in = shapes[base + ".weight"]
            pre = f"diffusion_model.{base}"
            out[pre + ".lora_A.weight"] = (_draw((rank, d_in), d_in ** -0.5,
                                                 gen, device)
                                           .to(torch.bfloat16).cpu())
            out[pre + ".lora_B.weight"] = (_draw((d_out, rank), std, gen,
                                                 device)
                                           .to(torch.bfloat16).cpu())
    return out


@torch.no_grad()
def vae_tensors(vae_cfg: dict, *, seed: int = 2, device="cpu"
                ) -> dict[str, torch.Tensor]:
    """The causal VAE file's tensors: the port's keys are the reference's
    but for the latent statistics."""
    vae = ltx_vae.init_params(
        ltx_vae.CausalVAE(ltx_vae.VAEConfig.from_dict(vae_cfg),
                          DEFAULT_POLICY, device=device),
        torch.Generator(device=device).manual_seed(seed))
    out = {}
    for key, t in vae.state_dict().items():
        key = key.replace("per_channel_statistics.std_of_means",
                          "per_channel_statistics.std-of-means")
        key = key.replace("per_channel_statistics.mean_of_means",
                          "per_channel_statistics.mean-of-means")
        # PixArt-style time embedders nest their MLP one level deeper
        key = key.replace("time_embedder.linear_",
                          "time_embedder.timestep_embedder.linear_")
        out[key] = t.to(torch.bfloat16).cpu()
    return out


@torch.no_grad()
def upscaler_tensors(cfg: lup.LatentUpsamplerConfig, *, seed: int = 3,
                     device="cpu") -> dict[str, torch.Tensor]:
    up = lup.init_params(lup.LatentUpsampler(cfg, DEFAULT_POLICY,
                                             device=device),
                         torch.Generator(device=device).manual_seed(seed))
    return {k.replace("upsampler.", "upsampler.0.", 1)
            if k.startswith("upsampler.") else k: t.to(torch.bfloat16).cpu()
            for k, t in up.state_dict().items()}


def write_ltxv_ckpt_dir(root: str, tcfg: tf.LTXTransformerConfig,
                        vae_cfg: dict, up_cfg: lup.LatentUpsamplerConfig, *,
                        lora_rank: int = 128, seed: int = 0,
                        device="cpu") -> dict:
    """Write the four files into ``root``; returns their paths, sizes in
    bytes and the seconds the transformer file took (drawn, quantized,
    written)."""
    os.makedirs(root, exist_ok=True)
    info: dict = {"paths": {}, "bytes": {}}
    tcfg_meta = {k: v for k, v in dataclasses.asdict(tcfg).items()
                 if k in ("num_attention_heads", "attention_head_dim",
                          "in_channels", "out_channels", "num_layers",
                          "cross_attention_dim", "caption_channels")}
    t0 = time.perf_counter()
    for name, make, config in (
            (TRANSFORMER_FILE,
             lambda: transformer_tensors(tcfg, seed=seed, device=device),
             {"transformer": tcfg_meta}),
            (LORA_FILE, lambda: lora_tensors(tcfg, lora_rank, seed=seed + 1,
                                             device=device), None),
            (VAE_FILE, lambda: vae_tensors(vae_cfg, seed=seed + 2,
                                           device=device), {"vae": vae_cfg}),
            (UPSCALER_FILE, lambda: upscaler_tensors(up_cfg, seed=seed + 3,
                                                     device=device),
             dataclasses.asdict(up_cfg))):
        path = os.path.join(root, name)
        tensors = make()
        save_safetensors(path, tensors, config)
        del tensors
        info["paths"][name] = path
        info["bytes"][name] = os.path.getsize(path)
        if name == TRANSFORMER_FILE:
            info["transformer_write_s"] = time.perf_counter() - t0
    info["write_s"] = time.perf_counter() - t0
    return info
