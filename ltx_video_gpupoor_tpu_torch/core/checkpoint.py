"""Checkpoint IO: safetensors files in the published layout -> the port's
``state_dict``s.

Port of ``ltx_video_gpupoor_tpu/core/checkpoint.py``: ``load_safetensors``
/ ``save_safetensors`` (:34, :52), ``save_quantized_model`` (:67),
``dequantize_quanto`` (:112), ``convert_ltx_transformer`` (:169),
``_apply_vae_renames`` + ``convert_ltx_vae`` (:281-289) and
``convert_wan_vae`` (:603), ``convert_wan_model`` (:697),
``convert_clip_vision`` (:808) and ``convert_t5_encoder`` (:861). The
on-disk conventions are the
reference's: one safetensors file with a JSON ``config`` entry in its
metadata; the diffusers key renames; the quanto int8 variant
``*_quanto_{bf16,fp16}_int8.safetensors`` whose weights ship as
``{name}._data`` (int8) + ``{name}._scale``; the latent statistics
``per_channel_statistics.std-of-means`` / ``mean-of-means``.

Differences from the JAX module:

- The safetensors format is read and written here (an 8-byte
  little-endian header length, a JSON header, the raw bytes; bf16 as its
  16-bit pattern viewed as ``torch.bfloat16``), so neither the
  ``safetensors`` package nor ``ml_dtypes`` is needed. Tensors are torch
  tensors on the CPU.
- The converters yield the port's ``state_dict``s directly: torch's
  ``[out, in]`` linear and ``[out, in, kt, kh, kw]`` conv layouts are the
  port's, so a conversion is key renames and the JAX converter's dtypes
  (``core/from_jax.py`` applied to the JAX converter's tree gives the same
  dict; ``tests/test_torch_checkpoint.py`` holds them equal).
- ``dequantize_quanto`` folds one tensor at a time into the target dtype
  (bf16 by default) and can drop each int8 pair as it goes: the 13B int8
  file dequantized wholesale to fp32 would take about 52 GB of host
  memory.

The legacy-VAE converter comes with its model (ROADMAP queue 1 step 14)
and raises until then.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _config(meta: dict) -> dict:
    if "config" not in meta:
        return {}
    try:
        return json.loads(meta["config"])
    except (json.JSONDecodeError, TypeError):
        return {}


def load_safetensors(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """Tensors (CPU torch tensors, their own memory) + the parsed
    ``config`` metadata entry ({} without one). The header maps each
    tensor name to ``{dtype, shape, data_offsets}`` and may hold
    ``__metadata__``."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        n = struct.unpack("<Q", raw)[0]
        header = json.loads(f.read(n))
    start = 8 + n
    meta = header.pop("__metadata__", None) or {}
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=start) \
        if any(v["data_offsets"][1] > v["data_offsets"][0]
               for v in header.values()) else None
    tensors: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        b, e = info["data_offsets"]
        if e == b:
            tensors[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.from_numpy(np.array(data[b:e]))
        tensors[name] = raw.view(dtype).reshape(shape)
    del data
    return tensors, _config(meta)


def save_safetensors(path: str, tensors: dict, config: Optional[dict] = None
                     ) -> None:
    """One safetensors file with the JSON ``config`` as metadata (the
    reference's checkpoint convention). Values are torch tensors or numpy
    arrays; each is written from a contiguous copy of its values (the JAX
    side guards the same way: a strided view written as its raw buffer
    would be corrupt)."""
    ts = {}
    for k, v in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        ts[k] = t.detach().cpu().contiguous()
    header: dict[str, Any] = {}
    if config is not None:
        header["__metadata__"] = {"config": json.dumps(config)}
    offset = 0
    for k, t in ts.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)       # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in ts.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


# ---------------------------------------------------------------------------
# quanto int8 pairs
# ---------------------------------------------------------------------------

def dequantize_quanto(tensors: dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16,
                      consume: bool = False,
                      device=None) -> dict[str, torch.Tensor]:
    """Fold quanto int8 weight pairs ``x._data`` (int8) / ``x._scale``
    back into ``dtype`` weights, one at a time: ``int8 * fp32 scale``
    (broadcast over the input axis for a torch ``[out, in]`` weight with
    an ``[out, 1]`` scale, or as JAX's ``[in, out]`` kernels with an
    ``[out]`` scale), then cast. Other tensors pass through as they are.
    ``consume`` empties ``tensors`` as it goes, so the int8 file and its
    dequantized copy are never both whole in host memory; ``device``
    moves every tensor there first (the int8 codes cross to the card at
    half the bytes of their bf16 values, and the product runs there)."""
    def put(t):
        return t if device is None else t.to(device)

    out: dict[str, torch.Tensor] = {}
    for k in list(tensors):
        if k not in tensors:
            continue
        if k.endswith("._data"):
            v = put(tensors.pop(k) if consume else tensors[k])
            base = k[: -len("._data")]
            scale = tensors.get(base + "._scale")
            if scale is None:
                out[k] = v
                continue
            if consume:
                del tensors[base + "._scale"]
            s = put(scale).float()
            if v.dim() == s.dim() + 1:
                # [in, out] kernel with a per-out scale ([L, in, out] stacks)
                s = s[..., None, :]
            w = (v.float() * s).to(dtype)
            if base.endswith((".weight", ".kernel")):
                out[base] = w
            else:
                out[base + ".weight"] = w
        elif k.endswith("._scale"):
            continue
        else:
            out[k] = put(tensors.pop(k) if consume else tensors[k])
    if consume:
        tensors.clear()
    return out


_TO_JAX = {2: lambda x: x.T, 4: lambda x: x.permute(2, 3, 1, 0),
           5: lambda x: x.permute(2, 3, 4, 1, 0)}


def _jax_leaves(sd: dict) -> dict[str, list]:
    """The port's ``state_dict`` grouped by the JAX package's flat
    parameter keys (the inverse of ``core/from_jax.py``): ``weight`` of
    rank 2, 4 or 5 -> ``kernel`` (torch's layout; :data:`_TO_JAX` gives
    JAX's), ``blocks.{i}.*`` -> ``blocks.*`` with one entry a layer.
    Values: lists of (layer or None, tensor)."""
    out: dict[str, list] = {}
    for key, t in sd.items():
        head, _, leaf = key.rpartition(".")
        if leaf == "weight" and t.dim() in _TO_JAX:
            leaf = "kernel"
        parts = (f"{head}.{leaf}" if head else leaf).split(".")
        layer = None
        if parts[0] == "blocks" and len(parts) > 2 and parts[1].isdigit():
            layer = int(parts.pop(1))
        out.setdefault(".".join(parts), []).append((layer, t))
    return out


@torch.no_grad()
def save_quantized_model(path: str, model_or_state: Any,
                         config: Optional[dict] = None,
                         dtype_tag: str = "bf16") -> str:
    """Export a model as a quanto-style int8 checkpoint
    (``*_quanto_{bf16,fp16}_int8.safetensors``), with the keys and values
    that the JAX package's ``save_quantized_model`` writes for the same
    weights: the JAX parameter tree's flat keys, every 2-D float
    ``.kernel`` (``[in, out]``; a layer stack ``[L, in, out]``) as
    ``._data`` int8 + ``._scale`` (symmetric per output channel, layer by
    layer), every other leaf as it is in JAX's layout (bf16 as fp32).
    Each weight is quantized where it lies (on the card, say) and only
    its int8 codes come to the host. Returns the path."""
    from ..ops.quant import quantize_weights

    sd = model_or_state.state_dict() \
        if isinstance(model_or_state, torch.nn.Module) else model_or_state
    out: dict[str, torch.Tensor] = {}
    for key, items in _jax_leaves(dict(sd)).items():
        items = sorted(items, key=lambda it: -1 if it[0] is None else it[0])
        stacked = items[0][0] is not None
        ts = [t.detach() for _, t in items]
        if key.endswith(".kernel") and ts[0].is_floating_point() \
                and ts[0].dim() == 2:
            # quantize_weights takes torch's [out, in]: JAX's kernel^T
            qs = [quantize_weights(t) for t in ts]
            data = [q.w_int8.T.contiguous().cpu() for q in qs]
            scales = [q.scale.cpu() for q in qs]
            out[key + "._data"] = torch.stack(data) if stacked else data[0]
            out[key + "._scale"] = torch.stack(scales) if stacked \
                else scales[0]
            continue
        # the tiers' weights and group scales are [out, ...] here, [..., out]
        # in JAX
        to_jax = key.endswith((".kernel", ".w_int8_dyn", ".w_int8",
                               ".w_int4")) or (key.endswith(".scale")
                                               and ts[0].dim() == 2)
        vals = [(_TO_JAX[t.dim()](t) if to_jax else t).cpu() for t in ts]
        vals = [v.float() if v.dtype == torch.bfloat16 else v for v in vals]
        out[key] = torch.stack(vals) if stacked else vals[0]
    if not path.endswith(".safetensors"):
        path = f"{path}_quanto_{dtype_tag}_int8.safetensors"
    save_safetensors(path, out, config)
    return path


# ---------------------------------------------------------------------------
# trees -> state_dicts
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """A converter's nested dicts / lists -> a flat ``state_dict``: list
    items by index, ``kernel`` leaves named ``weight`` (the layouts are
    torch's already), empty dicts dropped."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            name = "weight" if k == "kernel" else k
            out.update(_flatten(v, f"{prefix}{name}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _cast(t, dtype) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# LTX Transformer3D
# ---------------------------------------------------------------------------

# diffusers-format checkpoints use these names
# (TRANSFORMER_KEYS_RENAME_DICT of the reference's diffusers mapping)
_TRANSFORMER_RENAMES = {
    "proj_in": "patchify_proj",
    "time_embed": "adaln_single",
    "norm_q": "q_norm",
    "norm_k": "k_norm",
}


def convert_ltx_transformer(sd: dict[str, torch.Tensor], num_layers: int,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> dict[str, torch.Tensor]:
    """A state dict in the reference's naming -> the ``state_dict`` of
    ``models/ltx/transformer3d.LTXTransformer3D``: linears in ``dtype``,
    the adaLN-single MLP, the norms and the scale-shift tables in fp32,
    as the JAX converter keeps them."""
    renamed = {}
    for k, v in sd.items():
        for a, b in _TRANSFORMER_RENAMES.items():
            k = k.replace(a, b)
        renamed[k] = v
    sd = renamed

    def lin(prefix, d=dtype):
        p = {"kernel": _cast(sd[prefix + ".weight"], d)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], d)
        return p

    def maybe_norm(prefix, d=torch.float32):
        if prefix + ".weight" in sd:
            return {"weight": _cast(sd[prefix + ".weight"], d)}
        return None

    blocks = []
    for i in range(num_layers):
        pre = f"transformer_blocks.{i}"
        b = {
            "scale_shift_table": _cast(sd[f"{pre}.scale_shift_table"],
                                       torch.float32),
            "attn1": {
                "to_q": lin(f"{pre}.attn1.to_q"),
                "to_k": lin(f"{pre}.attn1.to_k"),
                "to_v": lin(f"{pre}.attn1.to_v"),
                "to_out": lin(f"{pre}.attn1.to_out.0"),
            },
            "attn2": {
                "to_q": lin(f"{pre}.attn2.to_q"),
                "to_k": lin(f"{pre}.attn2.to_k"),
                "to_v": lin(f"{pre}.attn2.to_v"),
                "to_out": lin(f"{pre}.attn2.to_out.0"),
            },
            "ff": {
                "proj_in": lin(f"{pre}.ff.net.0.proj"),
                "proj_out": lin(f"{pre}.ff.net.2"),
            },
        }
        for attn in ("attn1", "attn2"):
            for norm in ("q_norm", "k_norm"):
                n = maybe_norm(f"{pre}.{attn}.{norm}")
                if n:
                    b[attn][norm] = n
        blocks.append(b)

    return _flatten({
        "patchify_proj": lin("patchify_proj"),
        "adaln": {
            "emb_linear_1": lin("adaln_single.emb.timestep_embedder.linear_1",
                                d=torch.float32),
            "emb_linear_2": lin("adaln_single.emb.timestep_embedder.linear_2",
                                d=torch.float32),
            "linear": lin("adaln_single.linear", d=torch.float32),
        },
        "caption_projection": {
            "linear_1": lin("caption_projection.linear_1"),
            "linear_2": lin("caption_projection.linear_2"),
        },
        "blocks": blocks,
        "scale_shift_table": _cast(sd["scale_shift_table"], torch.float32),
        "proj_out": lin("proj_out"),
    })


# ---------------------------------------------------------------------------
# LTX causal VAE
# ---------------------------------------------------------------------------

# VAE_KEYS_RENAME_DICT of the reference's diffusers mapping, applied in
# order, longest prefix first, for diffusers-format VAE checkpoints
_VAE_RENAMES = [
    ("decoder.up_blocks.3.conv_in", "decoder.up_blocks.7"),
    ("decoder.up_blocks.3.upsamplers.0", "decoder.up_blocks.8"),
    ("decoder.up_blocks.3", "decoder.up_blocks.9"),
    ("decoder.up_blocks.2.upsamplers.0", "decoder.up_blocks.5"),
    ("decoder.up_blocks.2.conv_in", "decoder.up_blocks.4"),
    ("decoder.up_blocks.2", "decoder.up_blocks.6"),
    ("decoder.up_blocks.1.upsamplers.0", "decoder.up_blocks.2"),
    ("decoder.up_blocks.1", "decoder.up_blocks.3"),
    ("decoder.up_blocks.0", "decoder.up_blocks.1"),
    ("decoder.mid_block", "decoder.up_blocks.0"),
    ("encoder.down_blocks.3", "encoder.down_blocks.8"),
    ("encoder.down_blocks.2.downsamplers.0", "encoder.down_blocks.7"),
    ("encoder.down_blocks.2", "encoder.down_blocks.6"),
    ("encoder.down_blocks.1.downsamplers.0", "encoder.down_blocks.4"),
    ("encoder.down_blocks.1.conv_out", "encoder.down_blocks.5"),
    ("encoder.down_blocks.1", "encoder.down_blocks.3"),
    ("encoder.down_blocks.0.conv_out", "encoder.down_blocks.2"),
    ("encoder.down_blocks.0.downsamplers.0", "encoder.down_blocks.1"),
    ("encoder.down_blocks.0", "encoder.down_blocks.0"),
    ("encoder.mid_block", "encoder.down_blocks.9"),
    ("conv_shortcut.conv", "conv_shortcut"),
    ("resnets", "res_blocks"),
    ("norm3.norm", "norm3"),  # the port stores norm3 directly
    ("downsamplers.0", "downsample"),
    ("upsamplers.0", "upsample"),
]


def _apply_vae_renames(key: str) -> str:
    for a, b in _VAE_RENAMES:
        if key.startswith(a):
            key = b + key[len(a):]
    key = key.replace(".resnets.", ".res_blocks.")
    return key


def _linear_as_conv(w: torch.Tensor) -> torch.Tensor:
    """A linear ``[out, in]`` stored where a 1x1x1 conv is expected."""
    return w[:, :, None, None, None]


def convert_ltx_vae(sd: dict[str, torch.Tensor], cfg,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> dict[str, torch.Tensor]:
    """A VAE state dict -> the ``state_dict`` of ``models/ltx/vae.
    CausalVAE`` (``cfg`` a ``VAEConfig``), following the config's block
    plan: convs in ``dtype``, norms, time embedders and scales in fp32."""
    from ..models.ltx.vae import _decoder_plan, _encoder_plan

    sd = {k.removeprefix("vae."): v for k, v in sd.items()}
    # the rename table targets diffusers-format checkpoints (mid_block /
    # downsamplers / resnets naming); native-format keys pass through
    is_diffusers = any(
        ".mid_block." in k or "downsamplers" in k or "upsamplers" in k
        or ".resnets." in k for k in sd
    )
    if is_diffusers:
        sd = {_apply_vae_renames(k): v for k, v in sd.items()}

    def conv(prefix, d=dtype):
        # the reference's CausalConv3d nests the torch conv as ".conv"
        for cand in (prefix + ".conv.weight", prefix + ".weight"):
            if cand in sd:
                w = sd[cand]
                break
        else:
            raise KeyError(prefix)
        bias_key = cand.replace("weight", "bias")
        p = {}
        if w.dim() == 5:
            p["kernel"] = _cast(w, d)
        elif w.dim() == 2:  # make_linear_nd stored as a linear
            p["kernel"] = _cast(_linear_as_conv(w), d)
        else:
            raise ValueError(f"unexpected conv weight ndim {w.dim()} at "
                             f"{prefix}")
        if bias_key in sd:
            p["bias"] = _cast(sd[bias_key], d)
        return p

    def norm(prefix, d=torch.float32):
        # the reference's LayerNorm wraps nn.LayerNorm as ``.norm``
        if prefix + ".norm.weight" in sd:
            prefix = prefix + ".norm"
        p = {}
        if prefix + ".weight" in sd:
            p["weight"] = _cast(sd[prefix + ".weight"], d)
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], d)
        return p

    def linear(prefix, d=torch.float32):
        p = {"kernel": _cast(sd[prefix + ".weight"], d)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], d)
        return p

    def resnet(prefix, has_shortcut):
        p = {
            "norm1": norm(prefix + ".norm1"),
            "conv1": conv(prefix + ".conv1"),
            "norm2": norm(prefix + ".norm2"),
            "conv2": conv(prefix + ".conv2"),
        }
        if has_shortcut or (prefix + ".conv_shortcut.weight" in sd) or (
            prefix + ".conv_shortcut.conv.weight" in sd
        ):
            w = sd.get(prefix + ".conv_shortcut.weight",
                       sd.get(prefix + ".conv_shortcut.conv.weight"))
            if w is not None:
                if w.dim() == 5:
                    p["conv_shortcut"] = conv(prefix + ".conv_shortcut")
                else:
                    p["conv_shortcut"] = {
                        "kernel": _cast(_linear_as_conv(w), dtype)}
                    bk = prefix + ".conv_shortcut.bias"
                    if bk in sd:
                        p["conv_shortcut"]["bias"] = _cast(sd[bk], dtype)
                n3 = norm(prefix + ".norm3")
                if n3:
                    p["norm3"] = n3
        for scale_name in ("per_channel_scale1", "per_channel_scale2"):
            k = f"{prefix}.{scale_name}"
            if k in sd:
                p[scale_name] = _cast(sd[k].reshape(-1), torch.float32)
        if prefix + ".scale_shift_table" in sd:
            p["scale_shift_table"] = _cast(
                sd[prefix + ".scale_shift_table"], torch.float32)
        return p

    def timestep_embedder(prefix):
        return {
            "linear_1": linear(prefix + ".timestep_embedder.linear_1"),
            "linear_2": linear(prefix + ".timestep_embedder.linear_2"),
        }

    def midblock(prefix, num_layers, attn=False):
        p: dict[str, Any] = {
            "res_blocks": [
                resnet(f"{prefix}.res_blocks.{i}", False)
                for i in range(num_layers)
            ]
        }
        if f"{prefix}.time_embedder.timestep_embedder.linear_1.weight" in sd:
            p["time_embedder"] = timestep_embedder(f"{prefix}.time_embedder")
        if attn:
            p["attention_blocks"] = []
            for i in range(num_layers):
                a = f"{prefix}.attention_blocks.{i}"
                p["attention_blocks"].append({
                    "to_q": linear(a + ".to_q", dtype),
                    "to_k": linear(a + ".to_k", dtype),
                    "to_v": linear(a + ".to_v", dtype),
                    "to_out": linear(a + ".to_out.0", dtype),
                    "q_norm": {"weight": _cast(sd[a + ".q_norm.weight"],
                                               torch.float32)},
                    "k_norm": {"weight": _cast(sd[a + ".k_norm.weight"],
                                               torch.float32)},
                })
        return p

    enc: dict[str, Any] = {
        "conv_in": conv("encoder.conv_in"),
        "down_blocks": [],
        "conv_norm_out": norm("encoder.conv_norm_out"),
        "conv_out": conv("encoder.conv_out"),
    }
    for i, (name, bp, cin, cout) in enumerate(_encoder_plan(cfg)):
        pre = f"encoder.down_blocks.{i}"
        if name == "res_x":
            enc["down_blocks"].append(midblock(pre, bp["num_layers"]))
        elif name == "res_x_y":
            enc["down_blocks"].append(resnet(pre, cin != cout))
        elif name in ("compress_all_res", "compress_space_res",
                      "compress_time_res"):
            enc["down_blocks"].append({"conv": conv(pre + ".conv")})
        else:
            enc["down_blocks"].append(conv(pre))

    _, dec_plan = _decoder_plan(cfg)
    dec: dict[str, Any] = {
        "conv_in": conv("decoder.conv_in"),
        "up_blocks": [],
        "conv_norm_out": norm("decoder.conv_norm_out"),
        "conv_out": conv("decoder.conv_out"),
    }
    for i, (name, bp, cin, cout) in enumerate(dec_plan):
        pre = f"decoder.up_blocks.{i}"
        if name in ("res_x", "attn_res_x"):
            dec["up_blocks"].append(
                midblock(pre, bp["num_layers"], attn=(name == "attn_res_x")))
        elif name == "res_x_y":
            dec["up_blocks"].append(resnet(pre, cin != cout))
        else:
            dec["up_blocks"].append({"conv": conv(pre + ".conv")})
    if "decoder.timestep_scale_multiplier" in sd:
        dec["timestep_scale_multiplier"] = _cast(
            sd["decoder.timestep_scale_multiplier"], torch.float32)
    if "decoder.last_time_embedder.timestep_embedder.linear_1.weight" in sd:
        dec["last_time_embedder"] = timestep_embedder(
            "decoder.last_time_embedder")
        dec["last_scale_shift_table"] = _cast(
            sd["decoder.last_scale_shift_table"], torch.float32)

    params: dict[str, Any] = {"encoder": enc, "decoder": dec}
    for qc in ("quant_conv", "post_quant_conv"):
        if qc + ".weight" in sd:
            w = sd[qc + ".weight"]
            params[qc] = {
                "kernel": _cast(w if w.dim() == 5 else _linear_as_conv(w),
                                dtype),
                "bias": _cast(sd[qc + ".bias"], dtype),
            }
    stats = {}
    for ours, names in (
        # diffusers-format checkpoints store the stats as latents_std /
        # latents_mean
        ("std_of_means",
         ("per_channel_statistics.std-of-means", "latents_std")),
        ("mean_of_means",
         ("per_channel_statistics.mean-of-means", "latents_mean")),
    ):
        for theirs in names:
            if theirs in sd:
                stats[ours] = _cast(sd[theirs], torch.float32)
                break
    if "std_of_means" in stats:
        stats.setdefault("mean_of_means",
                         torch.zeros_like(stats["std_of_means"]))
        params["per_channel_statistics"] = stats
    return _flatten(params)


def is_legacy_vae(vcfg_dict: Optional[dict], keys) -> bool:
    """The pre-causal (2B-era) VAE: by its config or by the encoder
    mid-block naming of its weights (JAX ``model_zoo.py`` :317-325)."""
    return (vcfg_dict or {}).get("_class_name") == "VideoAutoencoder" or any(
        k.startswith(("encoder.mid_block.res_blocks.",
                      "vae.encoder.mid_block.res_blocks.")) for k in keys)


# ---------------------------------------------------------------------------
# T5 / UMT5
# ---------------------------------------------------------------------------

def convert_t5_encoder(sd: dict[str, torch.Tensor], num_layers: int,
                       shared_pos: bool, dtype: torch.dtype = torch.bfloat16
                       ) -> dict[str, torch.Tensor]:
    """Wan-style UMT5 naming (``blocks.N.attn.q.weight``) or HF T5 naming
    (``encoder.block.N.layer.0.SelfAttention.q.weight``) -> the
    ``state_dict`` of ``models/t5.T5Encoder``."""
    hf = any(k.startswith("encoder.block.") for k in sd)

    def lin(key):
        return {"kernel": _cast(sd[key], dtype)}

    blocks = []
    for i in range(num_layers):
        if hf:
            pre = f"encoder.block.{i}"
            b = {
                "norm1": {"weight": _cast(
                    sd[f"{pre}.layer.0.layer_norm.weight"], torch.float32)},
                "attn": {
                    "q": lin(f"{pre}.layer.0.SelfAttention.q.weight"),
                    "k": lin(f"{pre}.layer.0.SelfAttention.k.weight"),
                    "v": lin(f"{pre}.layer.0.SelfAttention.v.weight"),
                    "o": lin(f"{pre}.layer.0.SelfAttention.o.weight"),
                },
                "norm2": {"weight": _cast(
                    sd[f"{pre}.layer.1.layer_norm.weight"], torch.float32)},
                "ffn": {
                    "gate": lin(f"{pre}.layer.1.DenseReluDense.wi_0.weight"),
                    "fc1": lin(f"{pre}.layer.1.DenseReluDense.wi_1.weight"),
                    "fc2": lin(f"{pre}.layer.1.DenseReluDense.wo.weight"),
                },
            }
            rel = f"{pre}.layer.0.SelfAttention.relative_attention_bias.weight"
            if not shared_pos and rel in sd:
                b["pos_embedding"] = _cast(sd[rel], torch.float32)
        else:
            pre = f"blocks.{i}"
            b = {
                "norm1": {"weight": _cast(sd[f"{pre}.norm1.weight"],
                                          torch.float32)},
                "attn": {
                    "q": lin(f"{pre}.attn.q.weight"),
                    "k": lin(f"{pre}.attn.k.weight"),
                    "v": lin(f"{pre}.attn.v.weight"),
                    "o": lin(f"{pre}.attn.o.weight"),
                },
                "norm2": {"weight": _cast(sd[f"{pre}.norm2.weight"],
                                          torch.float32)},
                "ffn": {
                    "gate": lin(f"{pre}.ffn.gate.0.weight"),
                    "fc1": lin(f"{pre}.ffn.fc1.weight"),
                    "fc2": lin(f"{pre}.ffn.fc2.weight"),
                },
            }
            if not shared_pos:
                b["pos_embedding"] = _cast(
                    sd[f"{pre}.pos_embedding.embedding.weight"], torch.float32)
        blocks.append(b)

    if hf:
        params = {
            "token_embedding": _cast(sd["shared.weight"], dtype),
            "blocks": blocks,
            "norm": {"weight": _cast(sd["encoder.final_layer_norm.weight"],
                                     torch.float32)},
        }
        if shared_pos:
            params["pos_embedding"] = _cast(
                sd["encoder.block.0.layer.0.SelfAttention"
                   ".relative_attention_bias.weight"], torch.float32)
    else:
        params = {
            "token_embedding": _cast(sd["token_embedding.weight"], dtype),
            "blocks": blocks,
            "norm": {"weight": _cast(sd["norm.weight"], torch.float32)},
        }
        if shared_pos:
            params["pos_embedding"] = _cast(
                sd["pos_embedding.embedding.weight"], torch.float32)
    return _flatten(params)


# ---------------------------------------------------------------------------
# Wan VAE, Wan DiT, CLIP vision tower
# ---------------------------------------------------------------------------

def convert_wan_vae(sd: dict[str, torch.Tensor], cfg,
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """A Wan VAE state dict in the reference's naming
    (``encoder.downsamples.N.residual.{0,2,3,6}``, ``resample.1``,
    ``time_conv``, ``middle.{0,1,2}``, ``head.{0,2}``) -> the
    ``state_dict`` of ``models/wan/vae.WanVAE`` (convs in ``dtype``, the
    norms' gammas flat fp32, as JAX's converter keeps them)."""
    from ..models.wan.vae import _decoder_structure, _encoder_structure

    def conv(prefix):
        p = {"kernel": _cast(sd[prefix + ".weight"], dtype)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], dtype)
        return p

    def norm(prefix):
        p = {"gamma": _cast(sd[prefix + ".gamma"].reshape(-1), torch.float32)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"].reshape(-1), torch.float32)
        return p

    def res(prefix):
        p = {"norm1": norm(prefix + ".residual.0"),
             "conv1": conv(prefix + ".residual.2"),
             "norm2": norm(prefix + ".residual.3"),
             "conv2": conv(prefix + ".residual.6")}
        if prefix + ".shortcut.weight" in sd:
            p["shortcut"] = conv(prefix + ".shortcut")
        return p

    def attn(prefix):
        return {"norm": norm(prefix + ".norm"),
                "to_qkv": conv(prefix + ".to_qkv"),
                "proj": conv(prefix + ".proj")}

    def stage_blocks(structure, prefix):
        blocks = []
        for i, (kind, _, _, _) in enumerate(structure):
            pre = f"{prefix}.{i}"
            if kind == "res":
                blocks.append(res(pre))
            elif kind == "attn":
                blocks.append(attn(pre))
            elif kind in ("downsample2d", "upsample2d"):
                blocks.append(conv(pre + ".resample.1"))
            else:  # *sample3d
                blocks.append({"resample": conv(pre + ".resample.1"),
                               "time_conv": conv(pre + ".time_conv")})
        return blocks

    enc_struct, _ = _encoder_structure(cfg)
    dec_struct, _ = _decoder_structure(cfg)
    return _flatten({
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "downsamples": stage_blocks(enc_struct, "encoder.downsamples"),
            "middle": [res("encoder.middle.0"), attn("encoder.middle.1"),
                       res("encoder.middle.2")],
            "head_norm": norm("encoder.head.0"),
            "head_conv": conv("encoder.head.2"),
        },
        "conv1": conv("conv1"),
        "conv2": conv("conv2"),
        "decoder": {
            "conv1": conv("decoder.conv1"),
            "middle": [res("decoder.middle.0"), attn("decoder.middle.1"),
                       res("decoder.middle.2")],
            "upsamples": stage_blocks(dec_struct, "decoder.upsamples"),
            "head_norm": norm("decoder.head.0"),
            "head_conv": conv("decoder.head.2"),
        },
    })


def convert_wan_model(sd: dict[str, torch.Tensor], cfg,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> dict[str, torch.Tensor]:
    """A Wan state dict in the reference's naming (``blocks.N.self_attn.q``,
    ``ffn.0`` / ``ffn.2``, ``modulation``, the ``patch_embedding`` Conv3d,
    i2v's ``cross_attn.k_img`` / ``v_img`` / ``norm_k_img`` and
    ``img_emb.proj.{0,1,3,4}``) -> the ``state_dict`` of
    ``models/wan/model.WanModel``: the blocks' and the text and image
    embeddings' linears in ``dtype``, the time path, the head, the norms,
    the modulation tables and the patch conv in fp32, as JAX's converter
    keeps them; the variants' keys where the file has them (JAX :730-800):
    ReCamMaster's ``blocks.N.cam_encoder`` / ``projector``, the fps
    conditioning's ``fps_embedding`` and ``fps_projection.{0,2}``, VACE's
    ``vace_patch_embedding`` and ``vace_blocks.N`` (blocks with
    ``after_proj``, and ``before_proj`` on the first), those projections
    and embeddings in fp32 as JAX keeps them."""
    def lin(prefix, d=dtype):
        p = {"kernel": _cast(sd[prefix + ".weight"], d)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], d)
        return p

    def norm_w(prefix, bias=False):
        p = {"weight": _cast(sd[prefix + ".weight"], torch.float32)}
        if bias and prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], torch.float32)
        return p

    def attn(prefix, img=False):
        p = {"q": lin(prefix + ".q"), "k": lin(prefix + ".k"),
             "v": lin(prefix + ".v"), "o": lin(prefix + ".o"),
             "norm_q": norm_w(prefix + ".norm_q"),
             "norm_k": norm_w(prefix + ".norm_k")}
        if img and prefix + ".k_img.weight" in sd:
            p["k_img"] = lin(prefix + ".k_img")
            p["v_img"] = lin(prefix + ".v_img")
            p["norm_k_img"] = norm_w(prefix + ".norm_k_img")
        return p

    def block(prefix, vace=False):
        p = {"modulation": _cast(sd[prefix + ".modulation"], torch.float32),
             "self_attn": attn(prefix + ".self_attn"),
             "cross_attn": attn(prefix + ".cross_attn", img=True),
             "ffn": {"fc1": lin(prefix + ".ffn.0"),
                     "fc2": lin(prefix + ".ffn.2")}}
        if prefix + ".norm3.weight" in sd:
            p["norm3"] = norm_w(prefix + ".norm3", bias=True)
        if prefix + ".cam_encoder.weight" in sd:
            p["cam_encoder"] = lin(prefix + ".cam_encoder", torch.float32)
            p["projector"] = lin(prefix + ".projector", torch.float32)
        if vace:
            p["after_proj"] = lin(prefix + ".after_proj", torch.float32)
            if prefix + ".before_proj.weight" in sd:
                p["before_proj"] = lin(prefix + ".before_proj", torch.float32)
        return p

    params: dict[str, Any] = {
        "patch_embedding": {
            "kernel": _cast(sd["patch_embedding.weight"], torch.float32),
            "bias": _cast(sd["patch_embedding.bias"], torch.float32),
        },
        "text_embedding": {"fc1": lin("text_embedding.0"),
                           "fc2": lin("text_embedding.2")},
        "time_embedding": {"fc1": lin("time_embedding.0", torch.float32),
                           "fc2": lin("time_embedding.2", torch.float32)},
        "time_projection": lin("time_projection.1", torch.float32),
        "blocks": [block(f"blocks.{i}") for i in range(cfg.num_layers)],
        "head": {"modulation": _cast(sd["head.modulation"], torch.float32),
                 "head": lin("head.head", torch.float32)},
    }
    if "img_emb.proj.0.weight" in sd:
        params["img_emb"] = {
            "norm_in": norm_w("img_emb.proj.0", bias=True),
            "fc1": lin("img_emb.proj.1"),
            "fc2": lin("img_emb.proj.3"),
            "norm_out": norm_w("img_emb.proj.4", bias=True),
        }
    if "fps_embedding.weight" in sd:
        params["fps_embedding"] = _cast(sd["fps_embedding.weight"],
                                        torch.float32)
        params["fps_projection"] = {
            "fc1": lin("fps_projection.0", torch.float32),
            "fc2": lin("fps_projection.2", torch.float32)}
    if "vace_patch_embedding.weight" in sd:
        params["vace_patch_embedding"] = {
            "kernel": _cast(sd["vace_patch_embedding.weight"], torch.float32),
            "bias": _cast(sd["vace_patch_embedding.bias"], torch.float32)}
        n_vace = 0
        while f"vace_blocks.{n_vace}.after_proj.weight" in sd:
            n_vace += 1
        params["vace_blocks"] = [block(f"vace_blocks.{i}", vace=True)
                                 for i in range(n_vace)]
    return _flatten(params)


def convert_clip_vision(sd: dict[str, torch.Tensor], num_layers: int,
                        dtype: torch.dtype = torch.bfloat16
                        ) -> dict[str, torch.Tensor]:
    """An open-clip / Wan ``visual.*`` state dict (a whole CLIP state dict
    gives its ``visual.`` part) -> the ``state_dict`` of
    ``models/wan/clip.CLIPVision``: linears, the patch conv and the
    embeddings in ``dtype``, the norms fp32."""
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}

    def lin(prefix):
        p = {"kernel": _cast(sd[prefix + ".weight"], dtype)}
        if prefix + ".bias" in sd:
            p["bias"] = _cast(sd[prefix + ".bias"], dtype)
        return p

    def norm(prefix):
        return {"weight": _cast(sd[prefix + ".weight"], torch.float32),
                "bias": _cast(sd[prefix + ".bias"], torch.float32)}

    blocks = [{
        "norm1": norm(f"transformer.{i}.norm1"),
        "attn": {"to_qkv": lin(f"transformer.{i}.attn.to_qkv"),
                 "proj": lin(f"transformer.{i}.attn.proj")},
        "norm2": norm(f"transformer.{i}.norm2"),
        "mlp": {"fc1": lin(f"transformer.{i}.mlp.0"),
                "fc2": lin(f"transformer.{i}.mlp.2")},
    } for i in range(num_layers)]
    return _flatten({
        "patch_embedding": {"kernel": _cast(sd["patch_embedding.weight"],
                                            dtype)},
        "cls_embedding": _cast(sd["cls_embedding"], dtype),
        "pos_embedding": _cast(sd["pos_embedding"], dtype),
        "pre_norm": norm("pre_norm"),
        "blocks": blocks,
    })


# ---------------------------------------------------------------------------
# converters that come with their models
# ---------------------------------------------------------------------------

def _with_its_model(what: str, step: str):
    def convert(*args, **kwargs):
        raise NotImplementedError(
            f"{what}: comes with its model, ROADMAP queue 1 step {step}")
    convert.__name__ = what
    return convert


convert_legacy_vae = _with_its_model("convert_legacy_vae", "14")
