"""The reference's modules hold the port's parameter names and shapes, so
that one seed draws the same weights into both."""

import dataclasses

import pytest
import torch

from h100bench import weights
from h100ref import dit as ref_dit
from h100ref import upsampler as ref_up
from h100ref import vae as ref_vae

from conftest import tiny_config


def _shapes(module):
    return weights.param_shapes(module)


@pytest.mark.parametrize("name", ["ltxv-13b-0.9.7-distilled",
                                  "ltxv-2b-0.9.6-distilled"])
def test_parameter_names_and_shapes_match_the_port(name):
    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem

    cfg = tiny_config(name)
    tcfg = tf.LTXTransformerConfig(**cfg["transformer"])
    outer = tf.LTXTransformer3D(dataclasses.replace(tcfg, num_layers=0))
    assert _shapes(outer) == _shapes(ref_dit.Outer(cfg["transformer"]))
    assert _shapes(tf.Block(tcfg)) == _shapes(
        ref_dit.Block(cfg["transformer"]))
    port_vae = vaem.CausalVAE(vaem.VAEConfig.from_dict(cfg["vae"]))
    assert _shapes(port_vae) == _shapes(ref_vae.VAE(cfg["vae"], 1, "cpu"))
    if "latent_upsampler" in cfg:
        port_up = lup.LatentUpsampler(
            lup.LatentUpsamplerConfig(**cfg["latent_upsampler"]))
        assert _shapes(port_up) == _shapes(
            ref_up.Upsampler(cfg["latent_upsampler"], 1, "cpu"))


def test_one_seed_draws_one_group_alike_and_seeds_differ():
    shapes = {"a.weight": (8, 4), "a.bias": (8,), "n.weight": (4,),
              "scale_shift_table": (2, 4)}
    one = weights.draw_group(3, "g", shapes, "cpu")
    again = weights.draw_group(3, "g", shapes, "cpu")
    other = weights.draw_group(4, "g", shapes, "cpu")
    for k in shapes:
        assert one[k].dtype == torch.bfloat16 and one[k].shape == shapes[k]
        assert torch.equal(one[k], again[k])
        assert not torch.equal(one[k], other[k])
    assert abs(float(one["n.weight"].float().mean()) - 1) < 0.2
    assert float(one["a.bias"].float().abs().max()) < 0.2


def test_the_reference_refuses_what_it_does_not_follow():
    cfg = tiny_config("ltxv-13b-0.9.7-distilled")
    with pytest.raises(ValueError):
        ref_vae.VAE(dict(cfg["vae"], norm_layer="group_norm"), 1, "cpu")
    with pytest.raises(ValueError):
        ref_up.Upsampler(dict(cfg["latent_upsampler"], dims=2), 1, "cpu")


@pytest.mark.parametrize("frames", [1, 9])
def test_the_vae_follows_the_port_in_float32(frames):
    """The published layout at a few channels: the encoder's space-to-depth
    downsamplers and the decoder's residual upsamplers, one seed's weights
    on both sides."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem

    cfg = tiny_config("ltxv-13b-0.9.7-distilled")["vae"]
    port = weights.fill(vaem.CausalVAE(vaem.VAEConfig.from_dict(cfg),
                                       FP32_POLICY), 5, "vae")
    ref = ref_vae.VAE(cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(11)
    media = torch.rand(1, frames, 64, 96, 3, generator=gen) * 2 - 1
    with torch.no_grad():
        want = vaem.sample_posterior(vaem.encode(port, media))
        got = ref_vae.encode(ref, media)
        assert got.shape == want.shape == (1, (frames - 1) // 8 + 1, 2, 3, 16)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        z = torch.randn(1, 2, 2, 3, 16, generator=gen)
        t = torch.tensor(0.05)
        want = vaem.decode(port, z, timestep=t)
        got = ref_vae.decode(ref, z, t)
        assert got.shape == want.shape == (1, 9, 64, 96, 3)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
