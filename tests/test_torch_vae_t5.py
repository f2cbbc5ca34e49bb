"""The port's VAE decoder and T5 encoder against the JAX package, with the
JAX weights carried across by core/from_jax.py and the inputs made with
numpy: a narrow VAE and a 2-layer T5, in fp32, compared at 1e-4 (the same
math summed in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae

torch.set_num_threads(2)

FP32_TOL = 1e-4

VAE_DICT = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "latent_channels": 8,
    "blocks": [["res_x", 1], ["compress_all", 1], ["res_x_y", 1],
               ["res_x", 1]],
    "base_channels": 8,
    "norm_num_groups": 4,
    "patch_size": 2,
    "norm_layer": "pixel_norm",
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
    "timestep_conditioning": True,
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def vae_pair():
    jcfg = jvae.VAEConfig.from_dict(VAE_DICT)
    jp = jax.jit(lambda k: jvae.init_params(k, jcfg))(jax.random.key(1))
    # non-trivial latent statistics and noise scales
    jp["per_channel_statistics"]["std_of_means"] = jnp.linspace(0.5, 1.5, 8)
    jp["per_channel_statistics"]["mean_of_means"] = jnp.linspace(-0.2, 0.2, 8)
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(VAE_DICT),
                                FP32_POLICY)
    vae.load_state_dict(from_jax.vae_decoder_state_dict(_np_tree(jp)))
    return jcfg, jp, vae


def test_vae_decode_matches_jax(vae_pair):
    jcfg, jp, vae = vae_pair
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, 3, 4, 6, 8)).astype(np.float32)
    ref = jvae.decode(jp, jcfg, jnp.asarray(z), jnp.asarray(0.05))
    out = tvae.decode(vae, torch.from_numpy(z), torch.tensor(0.05))
    assert tuple(out.shape) == ref.shape == (1, 5, 16, 24, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FP32_TOL, rtol=FP32_TOL)
    zt = torch.from_numpy(z)
    np.testing.assert_allclose(
        tvae.un_normalize_latents(zt, vae.per_channel_statistics).numpy(),
        np.asarray(jvae.un_normalize_latents(
            jnp.asarray(z), jp["per_channel_statistics"])), atol=1e-6)
    with pytest.raises(ValueError, match="timestep"):
        tvae.decode(vae, zt)


def test_vae_097_decoder_layout_matches_jax():
    """The 0.9.7 block plan at 1/8 of its base width: the port's decoder
    has exactly the JAX decoder's parameters, in the converter's shapes."""
    cfg = dataclasses.replace(
        tvae.VAEConfig.from_dict(tvae.LTX_VAE_CONFIG_097), base_channels=16)
    jcfg = dataclasses.replace(
        jvae.VAEConfig.from_dict(jvae.LTX_VAE_CONFIG_097), base_channels=16)
    vae = tvae.init_params(tvae.CausalVAEDecoder(cfg, FP32_POLICY),
                           torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda a: np.empty(a.shape, np.float32),
                      jax.eval_shape(lambda: jvae.init_params(
                          jax.random.key(0), jcfg)))
    want = {k: tuple(v.shape)
            for k, v in from_jax.vae_decoder_state_dict(jp).items()}
    have = {k: tuple(v.shape) for k, v in vae.state_dict().items()}
    assert have == want
    w = vae.decoder.conv_in.weight
    assert abs(float(w.std()) * (27 * w.shape[1]) ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("shared_pos", [True, False])
def test_t5_encode_matches_jax(shared_pos):
    jcfg = jt5.T5Config(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48,
                        num_heads=4, num_layers=2, shared_pos=shared_pos)
    tcfg = tt5.T5Config(**{f: getattr(jcfg, f)
                           for f in jcfg.__dataclass_fields__})
    jp = jt5.init_params(jax.random.key(3), jcfg)
    model = tt5.T5Encoder(tcfg)
    model.load_state_dict(from_jax.state_dict(_np_tree(jp)))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[0, 12:] = 0
    ref = jt5.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    out = tt5.encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    rel = np.arange(-300, 300)[None]
    np.testing.assert_array_equal(
        tt5.relative_position_bucket(torch.from_numpy(rel)).numpy(),
        np.asarray(jt5.relative_position_bucket(jnp.asarray(rel))))
    assert tt5.T5_XXL == tt5.T5Config(**{
        f: getattr(jt5.T5_XXL, f) for f in jt5.T5_XXL.__dataclass_fields__})
