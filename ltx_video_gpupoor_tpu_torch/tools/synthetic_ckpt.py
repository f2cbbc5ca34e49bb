"""Synthetic LTX and Wan checkpoint files in the published layout, from
a seed.

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
  as metadata; or, where that config names ``"_class_name":
  "VideoAutoencoder"``, the legacy (pre-causal) VAE in its published
  naming (``encoder.down_blocks.N.res_blocks.M``, ``.downsample.conv``,
  ``decoder.up_blocks.N.upsample.conv``, the 1x1 convs 5-D;
  :func:`legacy_vae_tensors`);
- ``ltxv_0.9.7_spatial_upscaler.safetensors``: the latent upsampler
  (``upsampler.0``), its config as metadata;
- the Wan files that ``serving/model_zoo.py::load_wan_model`` reads (as
  the JAX loader reads them: safetensors): the DiT in the reference's
  naming (``blocks.{i}.self_attn.q``, ``ffn.0`` / ``ffn.2``,
  ``time_projection.1``, i2v's ``cross_attn.k_img`` and
  ``img_emb.proj.{0,1,3,4}``), the block linears as quanto int8 pairs and
  the rest bf16 (:data:`WAN_I2V_FILE`); the Wan VAE with its encoder
  (``downsamples.N.residual.{0,2,3,6}``, ``resample.1``, ``head.{0,2}``,
  gammas shaped ``[C, 1, 1, 1]``; :data:`WAN_VAE_FILE`); the CLIP vision
  tower under ``visual.`` (``transformer.{i}.mlp.{0,2}``;
  :data:`WAN_CLIP_FILE`);
- the official ``u2net.pth`` / ``u2netp.pth`` naming of U2-Net
  (``stage1.rebnconvin.conv_s1.weight``, ``bn_s1.running_var``,
  ``side1``, ``outconv``; :func:`u2net_tensors`), batch norms unfolded;
- HF-layout model directories (``config.json`` + ``model.safetensors``)
  for the prompt enhancers: a Llama / Qwen2 LLM (:func:`write_hf_llm_dir`)
  and Florence-2 (:func:`write_hf_florence_dir`). Their tokenizer files
  are the caller's to add.

Weights follow the JAX ``init_params`` distributions (linear weights
N(0, 1/d_in), zero biases, unit norm weights, tables N(0, 1/d)), drawn
tensor by tensor on ``device`` (the card, for the full-width 13B), so no
whole model is ever materialized in floats.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time

import torch

from ..core.checkpoint import save_safetensors
from ..core.dtypes import DEFAULT_POLICY
from ..models.ltx import latent_upsampler as lup
from ..models.ltx import transformer3d as tf
from ..models.ltx import vae as ltx_vae
from ..models.ltx import video_autoencoder as legacy_vae
from ..models.wan import clip as wan_clip
from ..models.wan import model as wan_model
from ..models.wan import vae as wan_vae
from ..ops.quant import quantize_weights

TRANSFORMER_FILE = "ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors"
LORA_FILE = "ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors"
VAE_FILE = "ltxv_0.9.7_VAE.safetensors"
UPSCALER_FILE = "ltxv_0.9.7_spatial_upscaler.safetensors"
WAN_I2V_FILE = "wan2.1_image2video_480p_14B_quanto_bf16_int8.safetensors"
WAN_VAE_FILE = "Wan2.1_VAE.safetensors"
WAN_CLIP_FILE = ("models_clip_open-clip-xlm-roberta-large-vit-huge-14"
                 ".safetensors")

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
def legacy_vae_tensors(vae_cfg: dict, *, seed: int = 2, device="cpu"
                       ) -> dict[str, torch.Tensor]:
    """The legacy VAE file's tensors in the reference's naming, bf16, with
    non-trivial latent statistics."""
    cfg = legacy_vae.LegacyVAEConfig.from_dict(vae_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    vae = legacy_vae.init_params(
        legacy_vae.LegacyVAE(cfg, DEFAULT_POLICY, device=device), gen)
    out = {}
    for key, t in vae.state_dict().items():
        if key.startswith("per_channel_statistics."):
            key = key.replace("_of_", "-of-")
            t = (1.0 + 0.5 * torch.rand(t.shape, generator=gen,
                                        device=device)
                 if "std" in key else
                 0.1 * torch.randn(t.shape, generator=gen, device=device))
        elif re.search(r"\.(downsample|upsample)\.", key):
            key = re.sub(r"\.(downsample|upsample)\.", r".\1.conv.", key)
        elif re.search(r"(conv_shortcut|quant_conv)\.weight$", key):
            t = t[:, :, None, None, None]
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
            (VAE_FILE, lambda: (
                legacy_vae_tensors if vae_cfg.get("_class_name")
                == "VideoAutoencoder" else vae_tensors)(
                    vae_cfg, seed=seed + 2, device=device),
             {"vae": vae_cfg}),
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


# the port's WanModel key -> the reference's (applied in order)
_WAN_TO_PUBLISHED = [
    (r"\.ffn\.fc1\.", ".ffn.0."), (r"\.ffn\.fc2\.", ".ffn.2."),
    (r"^(text|time)_embedding\.fc1\.", r"\1_embedding.0."),
    (r"^(text|time)_embedding\.fc2\.", r"\1_embedding.2."),
    (r"^time_projection\.", "time_projection.1."),
    (r"^img_emb\.norm_in\.", "img_emb.proj.0."),
    (r"^img_emb\.fc1\.", "img_emb.proj.1."),
    (r"^img_emb\.fc2\.", "img_emb.proj.3."),
    (r"^img_emb\.norm_out\.", "img_emb.proj.4."),
    (r"^fps_projection\.fc1\.", "fps_projection.0."),
    (r"^fps_projection\.fc2\.", "fps_projection.2."),
    (r"^fps_embedding$", "fps_embedding.weight"),
]


@torch.no_grad()
def wan_transformer_tensors(cfg: wan_model.WanConfig, *, seed: int = 0,
                            device="cpu") -> dict[str, torch.Tensor]:
    """The Wan DiT file's tensors (on the CPU), drawn as the JAX
    ``init_params`` draws them: the blocks' linears as quanto int8 pairs,
    the rest bf16; a config with ``vace_layers``, ``recammaster`` or
    ``inject_sample_info`` adds its published keys (``vace_blocks.N``,
    ``vace_patch_embedding``, ``blocks.N.cam_encoder`` / ``projector``,
    ``fps_embedding`` / ``fps_projection``), with VACE's and the fps
    projections drawn as every other linear (JAX starts some at zero)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    meta = wan_model.WanModel(cfg, DEFAULT_POLICY, device="meta")
    out: dict[str, torch.Tensor] = {}
    for key, p in meta.state_dict().items():
        name = key
        for a, b in _WAN_TO_PUBLISHED:
            name = re.sub(a, b, name)
        if key.endswith(".weight") and p.dim() == 2:
            w = _draw(p.shape, p.shape[1] ** -0.5, gen, device)
            if key.startswith("blocks."):
                q = quantize_weights(w)
                out[name + "._data"] = q.w_int8.cpu()
                out[name + "._scale"] = q.scale[:, None].to(
                    torch.bfloat16).cpu()
            else:
                out[name] = w.to(torch.bfloat16).cpu()
        elif key.endswith("modulation"):
            out[name] = _draw(p.shape, cfg.dim ** -0.5, gen,
                              device).to(torch.bfloat16).cpu()
        elif key.endswith("patch_embedding.weight"):
            out[name] = _draw(p.shape, math.prod(p.shape[1:]) ** -0.5, gen,
                              device).to(torch.bfloat16).cpu()
        elif key == "fps_embedding":
            out[name] = _draw(p.shape, 0.02, gen, device).to(
                torch.bfloat16).cpu()
        elif ("norm" in key and key.endswith(".weight")):
            out[name] = torch.ones(p.shape, dtype=torch.bfloat16)
        else:   # biases
            out[name] = torch.zeros(p.shape, dtype=torch.bfloat16)
    return out


_VAE_RES = re.compile(
    r"^((?:encoder|decoder)\.(?:downsamples|upsamples|middle)\.\d+)\."
    r"(norm1|conv1|norm2|conv2)\.")
_VAE_RES_NAMES = {"norm1": "residual.0", "conv1": "residual.2",
                  "norm2": "residual.3", "conv2": "residual.6"}


@torch.no_grad()
def wan_vae_tensors(cfg: wan_vae.WanVAEConfig, *, seed: int = 2,
                    device="cpu") -> dict[str, torch.Tensor]:
    """The Wan VAE file's tensors (encoder and decoder, bf16): the
    reference's names, its RMS norms' gammas shaped ``[C, 1, 1, 1]``
    (``[C, 1, 1]`` in the attention blocks)."""
    vae = wan_vae.init_params(
        wan_vae.WanVAE(cfg, DEFAULT_POLICY, device=device),
        torch.Generator(device=device).manual_seed(seed))
    resample = re.compile(r"^((?:encoder|decoder)\.(?:downsamples|upsamples)"
                          r"\.\d+)\.(weight|bias|resample\.weight"
                          r"|resample\.bias)$")
    out = {}
    for key, t in vae.state_dict().items():
        name = _VAE_RES.sub(lambda m: f"{m.group(1)}."
                            f"{_VAE_RES_NAMES[m.group(2)]}.", key)
        m = resample.match(name)
        if m:
            name = f"{m.group(1)}.resample.1.{m.group(2).split('.')[-1]}"
        name = name.replace("head_norm.", "head.0.").replace(
            "head_conv.", "head.2.")
        if name.endswith(".gamma"):
            t = t.reshape(-1, 1, 1) if ".middle.1." in name or (
                re.search(r"\.\d+\.norm\.gamma$", name)) else \
                t.reshape(-1, 1, 1, 1)
        out[name] = t.to(torch.bfloat16).cpu()
    return out


@torch.no_grad()
def wan_clip_tensors(cfg: wan_clip.CLIPVisionConfig, *, seed: int = 3,
                     device="cpu") -> dict[str, torch.Tensor]:
    """The CLIP vision tower's tensors under ``visual.`` (bf16)."""
    clip = wan_clip.init_params(
        wan_clip.CLIPVision(cfg, DEFAULT_POLICY, device=device),
        torch.Generator(device=device).manual_seed(seed))
    out = {}
    for key, t in clip.state_dict().items():
        name = key.replace("blocks.", "transformer.", 1) \
            .replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.", ".mlp.2.")
        out["visual." + name] = t.to(torch.bfloat16).cpu()
    return out


def write_wan_ckpt_dir(root: str, cfg: wan_model.WanConfig,
                       vae_cfg: wan_vae.WanVAEConfig,
                       clip_cfg: wan_clip.CLIPVisionConfig, *,
                       seed: int = 0, device="cpu") -> dict:
    """Write the Wan DiT, VAE and CLIP files into ``root``; returns their
    paths and sizes in bytes."""
    os.makedirs(root, exist_ok=True)
    info: dict = {"paths": {}, "bytes": {}}
    for name, make in (
            (WAN_I2V_FILE, lambda: wan_transformer_tensors(
                cfg, seed=seed, device=device)),
            (WAN_VAE_FILE, lambda: wan_vae_tensors(vae_cfg, seed=seed + 2,
                                                   device=device)),
            (WAN_CLIP_FILE, lambda: wan_clip_tensors(clip_cfg, seed=seed + 3,
                                                     device=device))):
        path = os.path.join(root, name)
        tensors = make()
        save_safetensors(path, tensors)
        del tensors
        info["paths"][name] = path
        info["bytes"][name] = os.path.getsize(path)
    return info


# ---------------------------------------------------------------------------
# HF-layout directories of the prompt enhancers' models
# ---------------------------------------------------------------------------

def _write_hf_dir(root: str, module, names: dict, hf_config: dict) -> str:
    os.makedirs(root, exist_ok=True)
    tensors = {names[k]: t.contiguous().cpu()
               for k, t in module.state_dict().items()}
    save_safetensors(os.path.join(root, "model.safetensors"), tensors)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf_config, f)
    return root


@torch.no_grad()
def write_hf_llm_dir(root: str, cfg, *, seed: int = 0,
                     dtype: torch.dtype = torch.float32) -> str:
    """A Llama (or, with ``qkv_bias``, Qwen2) ``LLMConfig`` as a HF model
    directory: ``config.json`` in ``LlamaConfig`` / ``Qwen2Config`` fields
    and ``model.safetensors`` in the published names, weights drawn as
    ``models/llm.init_params`` draws them."""
    from ..models import llm

    model = llm.init_params(llm.LLM(cfg, device="cpu", dtype=dtype),
                            torch.Generator().manual_seed(seed))
    hf = {"architectures": ["Qwen2ForCausalLM" if cfg.qkv_bias
                            else "LlamaForCausalLM"],
          "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "intermediate_size": cfg.ffn_dim, "rope_theta": cfg.rope_theta,
          "rms_norm_eps": cfg.rms_eps,
          "tie_word_embeddings": cfg.tie_embeddings}
    if cfg.head_dim:
        hf["head_dim"] = cfg.head_dim
    if cfg.rope_scaling:
        hf["rope_scaling"] = {
            "rope_type": cfg.rope_scaling, "factor": cfg.rope_factor,
            "low_freq_factor": cfg.rope_low_freq_factor,
            "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_original_max_pos}
    return _write_hf_dir(root, model, llm.hf_names(cfg), hf)


@torch.no_grad()
def write_hf_florence_dir(root: str, hf_config: dict, *, seed: int = 0,
                          dtype: torch.dtype = torch.float32) -> str:
    """Florence-2 as a HF model directory: ``hf_config`` (its
    ``vision_config`` / ``text_config`` fields) as ``config.json`` and
    ``model.safetensors`` in the published names, weights drawn as
    ``models/florence2.init_params`` draws them."""
    from ..models import florence2

    cfg = florence2.config_from_hf(hf_config)
    model = florence2.init_params(
        florence2.Florence2(cfg, device="cpu", dtype=dtype),
        torch.Generator().manual_seed(seed))
    return _write_hf_dir(root, model, florence2.hf_names(cfg), hf_config)


@torch.no_grad()
def u2net_tensors(cfg=None, *, seed: int = 0, device="cpu"
                  ) -> dict[str, torch.Tensor]:
    """A random U2-Net state dict in the official naming: each REBNCONV's
    conv (N(0, 1 / fan-in), a bias) and batch norm (weight, bias, running
    mean and variance near their identity), the side and fuse convs."""
    from ..models import u2net

    cfg = cfg or u2net.U2NET
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}

    def put(name, shape, std, base=0.0):
        out[name] = (base + _draw(shape, std, gen, device)).cpu()

    for name, mod in u2net.U2Net(cfg, device="meta").named_modules():
        if isinstance(mod, u2net.REBNConv):
            cout, cin = mod.weight.shape[:2]
            put(f"{name}.conv_s1.weight", (cout, cin, 3, 3), (9 * cin) ** -0.5)
            put(f"{name}.conv_s1.bias", (cout,), 0.1)
            put(f"{name}.bn_s1.weight", (cout,), 0.1, 1.0)
            put(f"{name}.bn_s1.bias", (cout,), 0.1)
            put(f"{name}.bn_s1.running_mean", (cout,), 0.1)
            out[f"{name}.bn_s1.running_var"] = (0.5 + torch.rand(
                (cout,), generator=gen, device=device)).cpu()
        elif name.startswith(("side", "outconv")):
            cout, cin, k = mod.weight.shape[:3]
            put(f"{name}.weight", (cout, cin, k, k), (cin * k * k) ** -0.5)
            put(f"{name}.bias", (cout,), 0.1)
    return out
