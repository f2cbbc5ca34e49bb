"""Qwen2.5-VL in the port against the JAX package on the CPU, in fp32, at
a small width (a 2-block tower of 32 with its second block full attention,
a 2-layer LLM of 48 with M-RoPE sections (2, 2, 2)): ``vision_layout`` and
``get_rope_index`` exactly (one image, two images, left padding), the
tower's merged output on two grids, the multimodal ``forward`` logits,
``generate`` greedy and sampled with JAX's Gumbel noise handed over, and
the HF conversion. JAX's weights are carried over by
``core/from_jax.py``. Tolerance: embeddings and logits to 1e-4 of their
largest magnitude; positions and tokens identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import llm as jl
from ltx_video_gpupoor_tpu.models import qwen25_vl as jq
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.models import qwen25_vl as tq

TOL = 1e-4
HF = {
    "vision_config": {"depth": 2, "hidden_size": 32, "intermediate_size": 40,
                      "num_heads": 2, "patch_size": 14,
                      "spatial_merge_size": 2, "temporal_patch_size": 2,
                      "window_size": 112, "out_hidden_size": 48,
                      "fullatt_block_indexes": [1]},
    "text_config": {"vocab_size": 96, "hidden_size": 48,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "intermediate_size": 64,
                    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                    "tie_word_embeddings": False,
                    "rope_scaling": {"mrope_section": [2, 2, 2]}},
    "image_token_id": 90, "video_token_id": 91, "vision_start_token_id": 89,
}
GRID = (1, 8, 12)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = jq.config_from_hf(HF)
    rng = np.random.default_rng(0)
    params = {"vision": jq.vision_init_params(jax.random.key(0), cfg.vision),
              "text": jl.init_params(jax.random.key(1), cfg.text)}
    params = jax.tree.map(np.asarray, params)
    for blk in ("qkv", "proj"):
        b = params["vision"]["blocks"]["attn"][blk]["bias"]
        params["vision"]["blocks"]["attn"][blk]["bias"] = (
            rng.standard_normal(b.shape) * 0.1).astype(np.float32)
    model = tq.QwenVL(tq.config_from_hf(HF), device="cpu",
                      dtype=torch.float32)
    model.load_state_dict(from_jax.qwen25_vl_state_dict(params))
    return cfg, jax.tree.map(jnp.asarray, params), model


def _close(out, ref):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def _patches(grid, seed=1):
    n = int(np.prod(grid))
    return np.random.default_rng(seed).standard_normal(
        (n, 3 * 2 * 14 * 14)).astype(np.float32)


def _ids(grids, pad=3, seed=2):
    rng = np.random.default_rng(seed)
    parts = [[0] * pad, rng.integers(1, 80, 4)]
    for g in grids:
        parts += [[89], [90] * (int(np.prod(g)) // 4), rng.integers(1, 80, 3)]
    ids = np.concatenate(parts).astype(np.int32)[None]
    mask = (np.arange(ids.shape[1]) >= pad).astype(np.int32)[None]
    return ids, mask


def test_config_from_hf_equals_jax():
    assert dataclasses.asdict(tq.config_from_hf(HF)) == \
        dataclasses.asdict(jq.config_from_hf(HF))
    assert dataclasses.asdict(tq.QwenVLVisionConfig()) == \
        dataclasses.asdict(jq.QwenVLVisionConfig())


@pytest.mark.parametrize("grids", [[GRID], [GRID, (2, 4, 6)]])
def test_layout_and_rope_index_equal_jax(pair, grids):
    cfg, _, model = pair
    g = np.asarray(grids)
    for a, b in zip(tq.vision_layout(model.cfg.vision, g),
                    jq.vision_layout(cfg.vision, g)):
        np.testing.assert_array_equal(a, b)
    ids, mask = _ids(grids)
    ids2 = np.concatenate([ids, np.roll(ids, 2, axis=1)])
    mask2 = np.concatenate([mask, np.roll(mask, 2, axis=1)])
    for out, ref in zip(
            tq.get_rope_index(model.cfg, ids2, image_grid_thw=np.concatenate(
                [g, g]), attention_mask=mask2),
            jq.get_rope_index(cfg, ids2, image_grid_thw=np.concatenate(
                [g, g]), attention_mask=mask2)):
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("grids", [[GRID], [GRID, (2, 4, 6)]])
def test_vision_forward_matches_jax(pair, grids):
    cfg, params, model = pair
    px = np.concatenate([_patches(g, i) for i, g in enumerate(grids)])
    g = np.asarray(grids)
    ref = jq.vision_forward(params["vision"], cfg.vision, jnp.asarray(px), g)
    _close(tq.vision_forward(model, torch.from_numpy(px), g), ref)


def test_forward_matches_jax(pair):
    cfg, params, model = pair
    ids, mask = _ids([GRID])
    px = _patches(GRID)
    g = np.asarray([GRID])
    ref = jq.forward(params, cfg, jnp.asarray(ids), jnp.asarray(px), g,
                     jnp.asarray(mask))
    out = tq.forward(model, torch.from_numpy(ids), torch.from_numpy(px), g,
                     torch.from_numpy(mask))
    _close(out, ref)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_jax(pair, temperature):
    cfg, params, model = pair
    ids, mask = _ids([GRID], seed=4)
    px = _patches(GRID, 5)
    g = np.asarray([GRID])
    n, key = 8, jax.random.key(7)
    ref = jq.generate(params, cfg, jnp.asarray(ids), jnp.asarray(px), g,
                      jnp.asarray(mask), n, eos_ids=(3,),
                      temperature=temperature, key=key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        k, (1, cfg.text.vocab_size), jnp.float32))
        for k in jax.random.split(key, n)])
    out = tq.generate(model, torch.from_numpy(ids), torch.from_numpy(px), g,
                      torch.from_numpy(mask), n, eos_ids=(3,),
                      temperature=temperature,
                      gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_load_hf_dir_equals_jax(pair, tmp_path):
    cfg, params, model = pair
    names = tq.hf_vision_names(model.cfg.vision)
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("vision."):
            if k == "vision.patch_embed.weight":
                v = v.reshape(32, 3, 2, 14, 14)
            sd["model.visual." + names[k]] = v.clone()
    text = {k[len("text."):]: v for k, v in model.state_dict().items()
            if k.startswith("text.")}
    hf_text = {"model.embed_tokens.weight": text["token_embedding"],
               "model.norm.weight": text["norm.weight"],
               "lm_head.weight": text["lm_head.weight"]}
    for i in range(2):
        pre, o = f"model.layers.{i}.", f"blocks.{i}."
        for a, t in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "o_proj")):
            hf_text[f"{pre}self_attn.{t}.weight"] = text[f"{o}attn.{a}.weight"]
            if f"{o}attn.{a}.bias" in text:
                hf_text[f"{pre}self_attn.{t}.bias"] = \
                    text[f"{o}attn.{a}.bias"]
        hf_text[f"{pre}input_layernorm.weight"] = text[f"{o}input_norm.weight"]
        hf_text[f"{pre}post_attention_layernorm.weight"] = \
            text[f"{o}post_norm.weight"]
        for m in ("gate", "up", "down"):
            hf_text[f"{pre}mlp.{m}_proj.weight"] = text[f"{o}mlp.{m}.weight"]
    for k, v in hf_text.items():
        name = k.replace("model.", "model.language_model.", 1) \
            if k.startswith("model.") else k
        sd[name] = v.clone()
    tckpt.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    (tmp_path / "config.json").write_text(json.dumps(HF))
    jcfg, jparams = jq.load_hf_dir(str(tmp_path))
    loaded = tq.load_hf_dir(str(tmp_path), device="cpu", dtype=torch.float32)
    want = from_jax.qwen25_vl_state_dict(jax.tree.map(np.asarray, jparams))
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
