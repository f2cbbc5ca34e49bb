"""Florence-2 (DaViT tower, projector, BART) in the port against the JAX
package on the CPU, in fp32, at a small width (two DaViT stages of 16 and
32 channels, windows of 4, BART d 24 with 2 + 2 layers, a vocabulary of
120 whose image placeholder id lies past it, as Florence-2-large's 51289):
the tower on odd sizes (window padding), the projector, the encoder with
a padded mask, ``decode_full`` logits, ``forward`` and greedy
``generate`` (forced BOS, EOS), and the HF conversion. JAX's weights are
carried over by ``core/from_jax.py``. Tolerance: features and logits to
1e-4 of their largest magnitude; tokens identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import florence2 as jf
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.models import florence2 as tf

TOL = 1e-4
VIS = dict(in_channels=3, depths=(1, 2), patch_size=(3, 3),
           patch_stride=(2, 2), patch_padding=(1, 1),
           patch_prenorm=(False, True), embed_dim=(16, 32), num_heads=(2, 4),
           num_groups=(2, 4), window_size=4, mlp_ratio=2.0, qkv_bias=True,
           projection_dim=24, max_temporal_embeddings=10,
           max_position_embeddings=16)
TXT = dict(vocab_size=120, d_model=24, encoder_layers=2, decoder_layers=2,
           encoder_attention_heads=4, encoder_ffn_dim=40,
           max_position_embeddings=64, pad_token_id=1, bos_token_id=0,
           eos_token_id=2, decoder_start_token_id=2, forced_bos_token_id=0,
           forced_eos_token_id=2)
HF = {"vision_config": VIS, "text_config": TXT, "image_token_id": 120}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = jf.config_from_hf(HF)
    k = jax.random.split(jax.random.key(0), 3)
    params = {"vision": jf.vision_init_params(k[0], cfg.vision),
              "projector": jf.projector_init_params(k[1], cfg),
              "text": jf.text_init_params(k[2], cfg.text)}
    rng = np.random.default_rng(0)
    # wider than init's 0.02, so every path moves the output
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1
                   ).astype(np.float32), params)
    model = tf.Florence2(tf.config_from_hf(HF), device="cpu",
                         dtype=torch.float32)
    model.load_state_dict(from_jax.florence2_state_dict(params))
    return cfg, jax.tree.map(jnp.asarray, params), model


def _close(out, ref):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def _pixels(h=14, w=18, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, h, w, 3)).astype(np.float32)


def _ids(n_img, seed=2, text_len=5, pad=3):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([[120] * n_img, rng.integers(3, 110, text_len),
                          [1] * pad]).astype(np.int32)[None]
    mask = (np.arange(ids.shape[1]) < ids.shape[1] - pad).astype(
        np.int32)[None]
    return ids, mask


def test_config_from_hf_equals_jax():
    assert dataclasses.asdict(tf.config_from_hf(HF)) == \
        dataclasses.asdict(jf.config_from_hf(HF))
    assert dataclasses.asdict(tf.config_from_hf({})) == \
        dataclasses.asdict(jf.config_from_hf({}))


@pytest.mark.parametrize("hw", [(14, 18), (16, 16)])
def test_tower_and_projector_match_jax(pair, hw):
    cfg, params, model = pair
    px = _pixels(*hw)
    tower = jf.vision_forward(params["vision"], cfg.vision, jnp.asarray(px))
    out = tf.vision_forward(model, torch.from_numpy(px))
    _close(out, tower)
    ref = jf.project_image_features(params["projector"], cfg, tower)
    _close(tf.project_image_features(model, out), ref)


def test_forward_matches_jax(pair):
    cfg, params, model = pair
    px = _pixels(seed=3)
    n_img = 4 * 5 + 1          # (14 / 4) x (18 / 4) tokens + the mean token
    ids, mask = _ids(n_img)
    dec_ids = np.array([[2, 0, 5, 7, 9]], np.int32)
    ref = jf.forward(params, cfg, jnp.asarray(ids), jnp.asarray(px),
                     jnp.asarray(dec_ids), jnp.asarray(mask))
    out = tf.forward(model, torch.from_numpy(ids), torch.from_numpy(px),
                     torch.from_numpy(dec_ids), torch.from_numpy(mask))
    _close(out, ref)


def test_encode_decode_full_match_jax(pair):
    cfg, params, model = pair
    ids, mask = _ids(0, seed=4, text_len=9)
    emb = jf.build_encoder_embeds(params, cfg, jnp.asarray(ids), None)
    temb = tf.build_encoder_embeds(model, torch.from_numpy(ids), None)
    _close(temb, emb)
    enc = jf.encode(params["text"], cfg.text, emb, jnp.asarray(mask))
    tenc = tf.encode(model, temb, torch.from_numpy(mask))
    _close(tenc, enc)
    dec_ids = np.array([[2, 0, 11, 13]], np.int32)
    _close(tf.decode_full(model, torch.from_numpy(dec_ids), tenc,
                          torch.from_numpy(mask)),
           jf.decode_full(params["text"], cfg.text, jnp.asarray(dec_ids), enc,
                          jnp.asarray(mask)))


def test_generate_matches_jax(pair):
    cfg, params, model = pair
    px = _pixels(seed=5)
    ids, mask = _ids(21, seed=6)
    ref = np.asarray(jf.generate(params, cfg, jnp.asarray(ids),
                                 jnp.asarray(px), 12, mask=jnp.asarray(mask)))
    out = tf.generate(model, torch.from_numpy(ids), torch.from_numpy(px), 12,
                      mask=torch.from_numpy(mask))
    assert ref[0, 0] == 0          # the forced BOS
    np.testing.assert_array_equal(out.numpy(), ref)


def test_load_hf_dir_equals_jax(pair, tmp_path):
    cfg, params, model = pair
    names = tf.hf_names(tf.config_from_hf(HF))
    sd = {names[k]: v.clone() for k, v in model.state_dict().items()}
    tckpt.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    (tmp_path / "config.json").write_text(json.dumps(HF))
    jcfg, jparams = jf.load_hf_dir(str(tmp_path))
    loaded = tf.load_hf_dir(str(tmp_path), device="cpu", dtype=torch.float32)
    want = from_jax.florence2_state_dict(jax.tree.map(np.asarray, jparams))
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
