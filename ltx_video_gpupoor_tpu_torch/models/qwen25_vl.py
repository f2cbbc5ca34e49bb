"""Qwen2.5-VL (the windowed vision tower + the M-RoPE LLM): the image-aware
Wan prompt extender's model.

Port of ``ltx_video_gpupoor_tpu/models/qwen25_vl.py``: the configs and
``config_from_hf`` (:36-107); ``vision_layout`` (:153), the window and
full-attention segment layout computed once on the host per image grid,
copied; ``vision_forward`` (:217: the patch "Conv3d" as one product over
flattened patches, 2-D rotary positions, window or full attention by
block, the patch merger); ``get_rope_index`` (:310, host numpy, copied);
``scatter_image_embeds``, ``forward`` and ``generate`` (:374-459) on
``models/llm.py``; ``convert_hf_state_dict`` and ``load_hf_dir``
(:466-529).

Modules carry the JAX keys (``vision.blocks.{i}.attn.qkv``,
``vision.merger.fc1``, ``text.*`` = :class:`~.llm.LLM`), so ``core/
from_jax.py::qwen25_vl_state_dict`` carries JAX's weights over. The tower
attends over the whole sequence with a segment mask (window or frame),
scores in fp32 from fp32 operands, as JAX (``:270-274``); no hand kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import rms_norm
from ..ops.quant import Linear
from . import llm


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: tuple = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    """Full model: vision tower + text LLM + special token ids."""
    vision: QwenVLVisionConfig
    text: llm.LLMConfig
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


def config_from_hf(hf: dict) -> QwenVLConfig:
    v = hf.get("vision_config", {})
    t = hf.get("text_config", hf)
    rs = t.get("rope_scaling") or {}
    text = llm.LLMConfig(
        vocab_size=t["vocab_size"],
        dim=t["hidden_size"],
        num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"],
        num_kv_heads=t.get("num_key_value_heads", t["num_attention_heads"]),
        ffn_dim=t["intermediate_size"],
        rope_theta=t.get("rope_theta", 1000000.0),
        rms_eps=t.get("rms_norm_eps", 1e-6),
        qkv_bias=True,
        tie_embeddings=t.get("tie_word_embeddings", False),
        mrope_section=tuple(rs.get("mrope_section", (16, 24, 24))),
    )
    vision = QwenVLVisionConfig(
        depth=v.get("depth", 32),
        hidden_size=v.get("hidden_size", 1280),
        intermediate_size=v.get("intermediate_size", 3420),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        window_size=v.get("window_size", 112),
        out_hidden_size=v.get("out_hidden_size", 3584),
        fullatt_block_indexes=tuple(
            v.get("fullatt_block_indexes", (7, 15, 23, 31))),
    )
    return QwenVLConfig(
        vision=vision, text=text,
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
    )


# ---------------------------------------------------------------------------
# Modules (attribute names are the JAX parameter keys)
# ---------------------------------------------------------------------------

class _Norm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **kw), requires_grad=False)


class _VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig, **kw):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.norm1 = _Norm(d, **kw)
        self.attn = nn.Module()
        self.attn.qkv = Linear(d, 3 * d, **kw)
        self.attn.proj = Linear(d, d, **kw)
        self.norm2 = _Norm(d, **kw)
        self.mlp = nn.Module()
        self.mlp.gate = Linear(d, f, **kw)
        self.mlp.up = Linear(d, f, **kw)
        self.mlp.down = Linear(f, d, **kw)


class QwenVLVision(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        merge_dim = d * cfg.spatial_merge_size ** 2
        self.patch_embed = Linear(cfg.patch_dim, d, False, **kw)
        self.blocks = nn.ModuleList(_VisionBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.merger = nn.Module()
        self.merger.ln_q = _Norm(d, **kw)
        self.merger.fc1 = Linear(merge_dim, merge_dim, **kw)
        self.merger.fc2 = Linear(merge_dim, cfg.out_hidden_size, **kw)


class QwenVL(nn.Module):
    """``vision`` (the tower and merger) and ``text`` (the LLM)."""

    def __init__(self, cfg: QwenVLConfig, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.vision = QwenVLVision(cfg.vision, device=device, dtype=dtype)
        self.text = llm.LLM(cfg.text, device=device, dtype=dtype)


@torch.no_grad()
def init_params(model: QwenVL, generator: torch.Generator) -> QwenVL:
    """Random weights in the JAX ``init_params`` distributions: linears
    N(0, 1/d_in) with zero biases, the LLM's embedding N(0, 0.02**2),
    unit norms. Draws on the model's device from ``generator``."""
    llm.init_params(model.text, generator)
    for mod in model.vision.modules():
        if isinstance(mod, Linear):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                                dtype=w.dtype) * mod.d_in ** -0.5)
    return model


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def vision_layout(cfg: QwenVLVisionConfig, grid_thw: np.ndarray):
    """Host-side static layout for a batch of image/video grids
    (``grid_thw`` [N, 3] of (t, h, w) patch counts): ``(window_index,
    seg_window, seg_full, pos_hw)`` — the merge-unit permutation into
    window order (transformers ``get_window_index``), the attention
    segment ids in window order for the windowed / full-attention blocks,
    and the (h, w) rotary position ids in window order."""
    merge = cfg.spatial_merge_size
    mu = merge * merge
    win = cfg.window_size // merge // cfg.patch_size

    window_index = []
    win_sizes = []
    pos_ids = []
    base = 0
    for t, h, w in grid_thw:
        t, h, w = int(t), int(h), int(w)
        lh, lw = h // merge, w // merge
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % win, (-lw) % win
        nh, nw = (lh + pad_h) // win, (lw + pad_w) // win
        idxp = np.full((t, lh + pad_h, lw + pad_w), -100)
        idxp[:, :lh, :lw] = idx
        idxp = (idxp.reshape(t, nh, win, nw, win)
                .transpose(0, 1, 3, 2, 4).reshape(t, nh * nw, win, win))
        sizes = (idxp != -100).sum(axis=(2, 3)).reshape(-1)
        flat = idxp.reshape(-1)
        window_index.append(flat[flat != -100] + base)
        win_sizes.extend(int(s) * mu for s in sizes if s > 0)
        base += t * lh * lw
        # rotary (h, w) ids at PATCH granularity, merge-unit order
        hp = np.arange(h)[:, None].repeat(w, 1)
        hp = (hp.reshape(lh, merge, lw, merge).transpose(0, 2, 1, 3)
              .reshape(-1))
        wp = np.arange(w)[None, :].repeat(h, 0)
        wp = (wp.reshape(lh, merge, lw, merge).transpose(0, 2, 1, 3)
              .reshape(-1))
        pos_ids.append(np.tile(np.stack([hp, wp], -1), (t, 1)))
    window_index = np.concatenate(window_index)
    pos_hw = np.concatenate(pos_ids, axis=0)

    # expand the merge-unit permutation to patch granularity
    patch_perm = (window_index[:, None] * mu + np.arange(mu)).reshape(-1)
    pos_hw = pos_hw[patch_perm]

    # windowed segments: one id per non-empty window, repeated by size
    seg_window = np.repeat(np.arange(len(win_sizes)), win_sizes)
    # full-attention segments: one id per image/video frame group
    full = []
    fid = 0
    for t, h, w in grid_thw:
        for _ in range(int(t)):
            full.extend([fid] * (int(h) * int(w)))
            fid += 1
    seg_full = np.asarray(full)[patch_perm]
    return window_index, seg_window, seg_full, pos_hw


@torch.no_grad()
def vision_forward(model: QwenVL, patches: torch.Tensor,
                   grid_thw: np.ndarray) -> torch.Tensor:
    """``patches [S, patch_dim]`` -> merged vision embeddings ``[S / mu,
    out_hidden]`` in the original (pre-window) order."""
    cfg, tower = model.cfg.vision, model.vision
    mu = cfg.spatial_merge_size ** 2
    window_index, seg_window, seg_full, pos_hw = vision_layout(
        cfg, np.asarray(grid_thw))
    w = tower.patch_embed.weight
    dev, dt = w.device, w.dtype
    s = patches.shape[0]
    x = tower.patch_embed(patches.to(device=dev, dtype=dt))
    patch_perm = (window_index[:, None] * mu + np.arange(mu)).reshape(-1)
    x = x[torch.from_numpy(patch_perm).to(dev)]

    # rotary tables: head_dim/2 channels split between the h and w axes
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, half, 2) / half))
    ang = np.concatenate([pos_hw[:, 0:1] * inv_freq[None],
                          pos_hw[:, 1:2] * inv_freq[None]], axis=-1)
    ang = np.concatenate([ang, ang], axis=-1)            # [S, head_dim]
    cos = torch.from_numpy(np.cos(ang)).float().to(dev)[:, None]
    sin = torch.from_numpy(np.sin(ang)).float().to(dev)[:, None]

    def bias(seg):
        seg = torch.from_numpy(seg).to(dev)
        keep = seg[:, None] == seg[None, :]
        return torch.zeros(keep.shape, device=dev).masked_fill(~keep, -1e9)

    bias_w, bias_f = bias(seg_window), bias(seg_full)
    nh, hd = cfg.num_heads, cfg.head_dim
    full = set(cfg.fullatt_block_indexes)

    def rope(a):
        af = a.float()
        return (af * cos + llm.rotate_half(af) * sin).to(dt)

    for i, p in enumerate(tower.blocks):
        h = rms_norm(x, p.norm1.weight, eps=1e-6)
        q, k, v = p.attn.qkv(h).reshape(s, 3, nh, hd).unbind(1)
        q, k = rope(q), rope(k)
        scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) \
            * hd ** -0.5 + (bias_f if i in full else bias_w)[None]
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, nh * hd)
        x = x + p.attn.proj(out)
        h = rms_norm(x, p.norm2.weight, eps=1e-6)
        x = x + p.mlp.down(F.silu(p.mlp.gate(h)) * p.mlp.up(h))

    m = tower.merger
    h = rms_norm(x, m.ln_q.weight, eps=1e-6).reshape(s // mu, -1)
    h = m.fc2(F.gelu(m.fc1(h), approximate="none"))
    reverse = torch.from_numpy(np.argsort(window_index)).to(dev)
    return h[reverse]


# ---------------------------------------------------------------------------
# Multimodal glue
# ---------------------------------------------------------------------------

def get_rope_index(
    cfg: QwenVLConfig,
    input_ids: np.ndarray,            # [B, S]
    image_grid_thw: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    attention_mask: Optional[np.ndarray] = None,
) -> tuple:
    """Host-side 3D position ids (transformers ``get_rope_index``,
    image/video second_per_grid=1 path). Returns ``positions`` [3, B, S]
    and ``deltas`` [B] (first-decode position = prompt_len + delta)."""
    merge = cfg.vision.spatial_merge_size
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    positions = np.ones((3, b, s), np.int64)
    deltas = np.zeros((b,), np.int64)
    img_i = vid_i = 0
    for bi in range(b):
        ids = input_ids[bi][attention_mask[bi] == 1]
        starts = np.where(ids == cfg.vision_start_token_id)[0]
        vis_tokens = ids[starts + 1] if starts.size else np.zeros((0,))
        n_img = int((vis_tokens == cfg.image_token_id).sum())
        n_vid = int((vis_tokens == cfg.video_token_id).sum())
        rem = ids.tolist()
        pos_list = []
        st = 0
        st_idx = 0
        li, vi = img_i, vid_i
        for _ in range(n_img + n_vid):
            it = rem.index(cfg.image_token_id, st) \
                if cfg.image_token_id in rem[st:] else len(rem) + 1
            vt = rem.index(cfg.video_token_id, st) \
                if cfg.video_token_id in rem[st:] else len(rem) + 1
            if it < vt:
                t, h, w = image_grid_thw[li]
                li += 1
                ed = it
            else:
                t, h, w = video_grid_thw[vi]
                vi += 1
                ed = vt
            lt, lh, lw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            pos_list.append(
                np.tile(np.arange(text_len) + st_idx, (3, 1)))
            st_idx += text_len
            tpos = np.repeat(np.arange(lt), lh * lw)
            hpos = np.tile(np.repeat(np.arange(lh), lw), lt)
            wpos = np.tile(np.arange(lw), lt * lh)
            pos_list.append(np.stack([tpos, hpos, wpos]) + st_idx)
            st = ed + lt * lh * lw
            # text after a vision block resumes at max vision pos + 1
            st_idx += int(max(lt, lh, lw))
        if st < len(rem):
            text_len = len(rem) - st
            pos_list.append(np.tile(np.arange(text_len) + st_idx, (3, 1)))
        pos = np.concatenate(pos_list, axis=1) if pos_list else \
            np.tile(np.arange(len(rem)), (3, 1))
        positions[:, bi, attention_mask[bi] == 1] = pos
        deltas[bi] = pos.max() + 1 - len(ids) if len(ids) else 0
        img_i, vid_i = li, vi
    return positions, deltas


def scatter_image_embeds(cfg: QwenVLConfig, token_embeds: torch.Tensor,
                         input_ids: torch.Tensor,
                         image_embeds: torch.Tensor) -> torch.Tensor:
    """The k-th image / video token takes ``image_embeds[k]`` (the
    reference's ``masked_scatter``)."""
    flat = input_ids.reshape(-1).to(token_embeds.device)
    is_img = (flat == cfg.image_token_id) | (flat == cfg.video_token_id)
    order = (torch.cumsum(is_img.long(), 0) - 1).clamp(
        0, image_embeds.shape[0] - 1)
    out = torch.where(is_img[:, None],
                      image_embeds[order].to(token_embeds.dtype),
                      token_embeds.reshape(-1, token_embeds.shape[-1]))
    return out.reshape(token_embeds.shape)


def _embeds(model: QwenVL, input_ids, patches, grid_thw, mask):
    """Token embeddings (the ids clamped into the vocabulary, as XLA's
    gather clamps) with the tower's output scattered in, and the M-RoPE
    positions; ``(embeds, positions [3, B, S] or None)``."""
    emb = model.text.token_embedding
    ids = input_ids.to(emb.device)
    embeds = emb[ids.clamp(0, emb.shape[0] - 1)]
    if patches is None:
        return embeds, None
    img = vision_forward(model, patches, grid_thw)
    embeds = scatter_image_embeds(model.cfg, embeds, ids, img)
    pos, _ = get_rope_index(model.cfg, input_ids.cpu().numpy(),
                            image_grid_thw=np.asarray(grid_thw),
                            attention_mask=mask.cpu().numpy())
    return embeds, torch.from_numpy(pos)


@torch.no_grad()
def forward(model: QwenVL, input_ids: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            grid_thw: Optional[np.ndarray] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full multimodal forward -> logits."""
    if mask is None:
        mask = torch.ones(input_ids.shape, dtype=torch.int32)
    embeds, positions = _embeds(model, input_ids, patches, grid_thw, mask)
    return llm.forward(model.text, input_ids, mask, positions=positions,
                       embeds=embeds)


@torch.no_grad()
def generate(model: QwenVL, input_ids: torch.Tensor,
             patches: Optional[torch.Tensor],
             grid_thw: Optional[np.ndarray], mask: torch.Tensor,
             max_new_tokens: int, eos_ids: tuple = (),
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vision encode + scatter + M-RoPE positions (the first generated
    token at the largest prefill position + 1), then the LLM's prefill +
    decode."""
    embeds, positions = _embeds(model, input_ids, patches, grid_thw, mask)
    decode_pos0 = None
    if positions is not None:
        decode_pos0 = positions.amax(dim=(0, 2)) + 1
    return llm.generate(model.text, input_ids, mask, max_new_tokens,
                        eos_ids=eos_ids, temperature=temperature,
                        generator=generator, gumbel=gumbel,
                        positions=positions, decode_pos0=decode_pos0,
                        embeds=embeds)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def hf_vision_names(cfg: QwenVLVisionConfig) -> dict:
    """The port's ``vision.*`` key -> the published name below
    ``visual.``."""
    out = {"vision.patch_embed.weight": "patch_embed.proj.weight",
           "vision.merger.ln_q.weight": "merger.ln_q.weight"}
    for leaf in ("weight", "bias"):
        out[f"vision.merger.fc1.{leaf}"] = f"merger.mlp.0.{leaf}"
        out[f"vision.merger.fc2.{leaf}"] = f"merger.mlp.2.{leaf}"
    for i in range(cfg.depth):
        o, t = f"vision.blocks.{i}.", f"blocks.{i}."
        out[o + "norm1.weight"] = t + "norm1.weight"
        out[o + "norm2.weight"] = t + "norm2.weight"
        for leaf in ("weight", "bias"):
            for a in ("qkv", "proj"):
                out[f"{o}attn.{a}.{leaf}"] = f"{t}attn.{a}.{leaf}"
            for m in ("gate", "up", "down"):
                out[f"{o}mlp.{m}.{leaf}"] = f"{t}mlp.{m}_proj.{leaf}"
    return out


def convert_hf_state_dict(sd: dict, cfg: QwenVLConfig,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """Published Qwen2.5-VL naming (``model.visual.*`` +
    ``model.language_model.*``, or the older ``visual.*`` + ``model.*``)
    -> the ``state_dict`` of :class:`QwenVL`."""
    text_sd, vis_sd = {}, {}
    for k, v in sd.items():
        if ".visual." in k or k.startswith("visual."):
            vis_sd[k.split("visual.", 1)[1]] = v
        elif ".language_model." in k:
            text_sd["model." + k.split(".language_model.", 1)[1]] = v
        else:
            text_sd[k] = v
    out = {}
    for ours, theirs in hf_vision_names(cfg.vision).items():
        t = torch.as_tensor(vis_sd[theirs])
        if ours == "vision.patch_embed.weight":
            t = t.reshape(cfg.vision.hidden_size, -1)
        out[ours] = t if dtype is None else t.to(dtype)
    out.update({"text." + k: v for k, v in llm.convert_hf_state_dict(
        text_sd, cfg.text, dtype).items()})
    return out


def load_hf_dir(path: str, *, device=None,
                dtype: torch.dtype = torch.bfloat16) -> QwenVL:
    """:class:`QwenVL` from a HF model directory, on ``device`` (the card
    unless told the CPU) in ``dtype``."""
    from ..core.checkpoint import build_module

    hf_cfg, sd = llm.read_hf_dir(path)
    cfg = config_from_hf(hf_cfg)
    return build_module(QwenVL(cfg, device="meta", dtype=dtype),
                        convert_hf_state_dict(sd, cfg), "Qwen2.5-VL",
                        llm.resolve_device(device))
