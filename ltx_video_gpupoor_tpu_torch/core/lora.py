"""LoRA loading and merging.

Port of ``ltx_video_gpupoor_tpu/core/lora.py``: ``normalize_lora_keys``
(ComfyUI ``lora_unet_*`` keys -> dotted diffusers-style paths),
``lora_pairs`` and ``merge_lora``, which the LoRA-distilled 13B needs
(``serving/model_zoo.py::load_ltxv_model``: the distilled file is a LoRA
merged onto the dev int8 transformer). The port merges into a
``state_dict`` in torch's ``[out, in]`` layout with per-layer keys
(``blocks.{i}.attn1.to_q.weight``), so ``W += mult * alpha / r * up @
down`` needs no transpose and no stacked update, and it updates the
weights in place, one at a time: a model's own parameters on the card
take the merge without a second copy of the model.
"""

from __future__ import annotations

import re
from typing import Callable

import torch


def normalize_lora_keys(sd: dict) -> dict:
    """Convert ComfyUI-format keys (``lora_unet_blocks_0_attn1_to_q``)
    into dotted diffusers-style paths with ``.lora_A`` / ``.lora_B``."""
    out = {}
    for k, v in sd.items():
        nk = k
        if nk.startswith("lora_unet_"):
            nk = nk[len("lora_unet_"):]
            nk = nk.replace(".lora_down.weight", ".lora_A.weight")
            nk = nk.replace(".lora_up.weight", ".lora_B.weight")
            # underscores between module path components -> dots, but keep
            # to_q / to_k / feed_forward style names intact
            nk = re.sub(r"blocks_(\d+)_", r"blocks.\1.", nk)
            nk = nk.replace("self_attn_", "self_attn.")
            nk = nk.replace("cross_attn_", "cross_attn.")
            nk = nk.replace("attn1_", "attn1.")
            nk = nk.replace("attn2_", "attn2.")
            nk = nk.replace("ffn_", "ffn.")
            nk = nk.replace("ff_", "ff.")
            # sub-module indices that stay underscore-joined after the
            # prefix replaces above: the attention output Sequential slot
            # and the GEGLU FFN projections
            nk = nk.replace("to_out_0", "to_out.0")
            nk = nk.replace("ff.net_0_proj", "ff.net.0.proj")
            nk = nk.replace("ff.net_2", "ff.net.2")
        nk = nk.removeprefix("diffusion_model.")
        nk = nk.removeprefix("transformer.")
        out[nk] = v
    return out


def lora_pairs(sd: dict):
    """Yield (base_path, down [r, in], up [out, r], alpha) triples."""
    sd = normalize_lora_keys(sd)
    bases = {}
    for k, v in sd.items():
        for marker, slot in (
            (".lora_A.weight", "down"), (".lora_down.weight", "down"),
            (".lora_B.weight", "up"), (".lora_up.weight", "up"),
            (".alpha", "alpha"),
        ):
            if k.endswith(marker):
                base = k[: -len(marker)]
                bases.setdefault(base, {})[slot] = v
                break
    for base, parts in bases.items():
        if "down" in parts and "up" in parts:
            yield base, parts["down"], parts["up"], parts.get("alpha")


def port_path(path: str) -> str:
    """The reference's module path -> the port's (and the JAX tree's)."""
    path = path.replace("transformer_blocks.", "blocks.")
    path = path.replace(".to_out.0", ".to_out")
    path = path.replace(".ff.net.0.proj", ".ff.proj_in")
    path = path.replace(".ff.net.2", ".ff.proj_out")
    # the Wan FFN is an nn.Sequential in the reference (ffn.0 / ffn.2);
    # the port names the projections fc1 / fc2
    path = path.replace(".ffn.0", ".ffn.fc1")
    path = path.replace(".ffn.2", ".ffn.fc2")
    return path


@torch.no_grad()
def merge_lora(
    state_dict: dict,
    lora_sd: dict,
    multiplier: float = 1.0,
    path_map: Callable[[str], str] | None = None,
) -> tuple[dict, int]:
    """Merge a LoRA state dict into the tensors of a ``state_dict``
    (``[out, in]`` weights, per-layer keys), in place; returns (the same
    dict, number of matched layers). Each delta ``mult * alpha / r * up @
    down`` is computed in fp32 on the weight's device and added in fp32,
    then cast back to the weight's dtype."""
    sd = state_dict
    matched = 0
    for base, down, up, alpha in lora_pairs(lora_sd):
        path = path_map(base) if path_map is not None else base
        key = port_path(path) + ".weight"
        if key not in sd:
            continue
        w = sd[key]
        r = down.shape[0]
        scale = float(multiplier)
        if alpha is not None:
            scale *= float(alpha) / r
        delta = scale * (up.to(w.device, torch.float32)
                         @ down.to(w.device, torch.float32))   # [out, in]
        w.copy_((w.float() + delta).to(w.dtype))
        matched += 1
    return sd, matched
