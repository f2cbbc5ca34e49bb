"""The Llama-3.x / Qwen2.5 decoder in the port against the JAX package on
the CPU, in fp32, at a small width (2 layers, dim 64, 4 query and 2 kv
heads of 16, vocabulary 96): ``rope_tables`` (plain, ``llama3``, M-RoPE
sections), ``forward`` logits on left-padded ids (Llama with tied
embeddings, Qwen2 with qkv biases and an ``lm_head``), ``generate`` greedy
and sampled (JAX's Gumbel noise drawn from its step keys and handed
over), the cached decode against a full forward, and the HF conversion.
Weights are JAX's ``init_params`` carried over by ``core/from_jax.py``.
Tolerance: logits to 1e-4 of their largest magnitude; tokens identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import llm as jl
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.models import llm as tl

TOL = 1e-4
KW = dict(vocab_size=96, dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
          ffn_dim=128, rope_theta=10000.0, rms_eps=1e-6)
VARIANTS = {
    "llama": dict(rope_scaling="llama3", rope_original_max_pos=16),
    "qwen": dict(qkv_bias=True, tie_embeddings=False),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(variant, seed=0):
    kw = {**KW, **VARIANTS[variant]}
    cfg = jl.LLMConfig(**kw)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.key(seed),
                                                     cfg))
    if "bias" in params["blocks"]["attn"]["q"]:
        rng = np.random.default_rng(seed)
        for n in ("q", "k", "v"):
            b = params["blocks"]["attn"][n]["bias"]
            params["blocks"]["attn"][n]["bias"] = rng.standard_normal(
                b.shape).astype(np.float32) * 0.1
    model = tl.LLM(tl.LLMConfig(**kw), device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax.llm_state_dict(params))
    return cfg, jax.tree.map(jnp.asarray, params), model


def _ids(seed=1, b=2, s=12, vocab=96):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, :5] = 0                      # left padding
    ids[0, :5] = 0
    return ids, mask


def _close(out, ref):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def test_configs_equal_jax():
    for t, j in ((tl.LLAMA_3_2_3B, jl.LLAMA_3_2_3B),
                 (tl.QWEN_2_5_3B, jl.QWEN_2_5_3B)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    hf = {"architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
          "hidden_size": 3072, "num_hidden_layers": 28,
          "num_attention_heads": 24, "num_key_value_heads": 8,
          "intermediate_size": 8192, "rope_theta": 500000.0,
          "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
          "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                           "original_max_position_embeddings": 8192}}
    assert dataclasses.asdict(tl.config_from_hf(hf)) == \
        dataclasses.asdict(jl.config_from_hf(hf))
    assert tl.config_from_hf(hf) == tl.LLAMA_3_2_3B


@pytest.mark.parametrize("kind", ["plain", "llama3", "mrope"])
def test_rope_tables_equal_jax(kind):
    kw = dict(KW, head_dim=16)
    if kind == "llama3":
        kw.update(rope_scaling="llama3", rope_original_max_pos=16)
    if kind == "mrope":
        kw.update(mrope_section=(2, 3, 3))
    pos = np.random.default_rng(2).integers(
        0, 300, (3, 2, 7) if kind == "mrope" else (2, 7))
    jc, jsn = jl.rope_tables(jl.LLMConfig(**kw), jnp.asarray(pos))
    tc, tsn = tl.rope_tables(tl.LLMConfig(**kw), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), atol=2e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    cfg, params, model = _pair(variant)
    ids, mask = _ids()
    ref = jl.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
    out = tl.forward(model, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(out, ref)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_greedy_matches_jax(variant):
    cfg, params, model = _pair(variant)
    ids, mask = _ids(3)
    ref = jl.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), 10,
                      eos_ids=(5, 7))
    out = tl.generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                      10, eos_ids=(5, 7))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_sampled_with_jax_noise(variant):
    """Temperature 0.7: JAX's ``categorical`` draws ``gumbel(key_t, [B,
    V])`` per step from ``split(key, max_new)``; handed over, the port
    picks the same tokens."""
    cfg, params, model = _pair(variant)
    ids, mask = _ids(4)
    n, key = 9, jax.random.key(11)
    ref = jl.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), n,
                      eos_ids=(3,), temperature=0.7, key=key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (2, cfg.vocab_size),
                                                    jnp.float32))
                       for k in jax.random.split(key, n)])
    out = tl.generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                      n, eos_ids=(3,), temperature=0.7,
                      gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # without the noise a generator draws it: seeded, so repeatable
    a, b = (tl.generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                        n, temperature=0.7,
                        generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, n)


def test_cached_decode_equals_full_forward():
    """The logits of the static-cache decode steps equal a full forward
    over the prompt plus the generated tokens (right after the prompt)."""
    _, _, model = _pair("llama")
    ids, mask = _ids(5)
    n = 8
    toks, seen = tl.generate(model, torch.from_numpy(ids),
                             torch.from_numpy(mask), n, return_logits=True)
    full = torch.cat([torch.from_numpy(ids).long(), toks], dim=1)
    fmask = torch.cat([torch.from_numpy(mask), torch.ones(2, n,
                                                          dtype=torch.int32)],
                      dim=1)
    logits = tl.forward(model, full, fmask)[:, ids.shape[1] - 1:-1]
    _close(seen, logits)
    assert torch.equal(torch.argmax(logits, dim=-1), toks)


def _hf_sd(params, cfg):
    """JAX's tree in the published HF naming."""
    sd = {"model.embed_tokens.weight": params["token_embedding"],
          "model.norm.weight": params["norm"]["weight"]}
    bl = params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "o_proj")):
            sd[f"{pre}self_attn.{theirs}.weight"] = \
                bl["attn"][ours]["kernel"][i].T
            if "bias" in bl["attn"][ours]:
                sd[f"{pre}self_attn.{theirs}.bias"] = \
                    bl["attn"][ours]["bias"][i]
        sd[f"{pre}input_layernorm.weight"] = bl["input_norm"]["weight"][i]
        sd[f"{pre}post_attention_layernorm.weight"] = \
            bl["post_norm"]["weight"][i]
        for ours in ("gate", "up", "down"):
            sd[f"{pre}mlp.{ours}_proj.weight"] = \
                bl["mlp"][ours]["kernel"][i].T
    if "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"]["kernel"].T
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_hf_dir_equals_jax(variant, tmp_path):
    cfg, params, _ = _pair(variant)
    sd = _hf_sd(jax.tree.map(np.asarray, params), cfg)
    tckpt.save_safetensors(str(tmp_path / "model.safetensors"),
                           {k: torch.from_numpy(v) for k, v in sd.items()})
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2ForCausalLM" if cfg.qkv_bias
                          else "LlamaForCausalLM"],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.ffn_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings}))
    jcfg, jparams = jl.load_hf_dir(str(tmp_path))
    model = tl.load_hf_dir(str(tmp_path), device="cpu", dtype=torch.float32)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jcfg)
    want = from_jax.llm_state_dict(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
