"""The modules that image-to-video and the multi-scale pipeline add to the
port, each against the JAX package in fp32 on shared weights
(core/from_jax.py) and numpy inputs: the VAE encoder (strided and
space-to-depth down blocks), the decoder's attention mid blocks,
``sample_posterior`` / ``normalize_latents``, the latent upsampler (both
``dims``), ``adain_filter_latent``, the tiled encode and decode,
``prepare_conditioning`` (a frame-0 image, a last-frame image, a video
prefix), the media helpers and the pass-size arithmetic.

Tolerance: 1e-4 (the same fp32 math summed in other orders), 2e-4 where a
result passes through the encoder and a resize; pinned copies and integer
arithmetic must be equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.ltx import latent_upsampler as jlup
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.models.ltx import vae_tiling as jtil
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.pipelines import multiscale as jms
from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as tlup
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.models.ltx import vae_tiling as ttil
from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as tpipe
from ltx_video_gpupoor_tpu_torch.pipelines import multiscale as tms
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia

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
# every down block the encoder has, group norm, quant convs, and an
# attention mid block in the decoder
VAE_DICT_WIDE = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "latent_channels": 8,
    "encoder_blocks": [["res_x", 1], ["compress_space_res", {"multiplier": 2}],
                       ["compress_time_res", {"multiplier": 2}],
                       ["compress_all_res", {"multiplier": 2}],
                       ["compress_time", 1], ["res_x_y", 1]],
    "decoder_blocks": [["res_x", 1], ["compress_all", {"residual": True}],
                       ["attn_res_x", {"num_layers": 1,
                                       "attention_head_dim": 8}],
                       ["compress_space", 1], ["compress_time", 1],
                       ["compress_all", 1], ["res_x_y", 1]],
    "base_channels": 8,
    "norm_num_groups": 4,
    "patch_size": 1,
    "norm_layer": "group_norm",
    "latent_log_var": "per_channel",
    "use_quant_conv": True,
    "causal_decoder": True,
    "timestep_conditioning": False,
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _vae_pair(vae_dict, seed=1):
    jcfg = jvae.VAEConfig.from_dict(vae_dict)
    jp = jax.jit(lambda k: jvae.init_params(k, jcfg))(jax.random.key(seed))
    c = jcfg.latent_channels
    jp["per_channel_statistics"]["std_of_means"] = jnp.linspace(0.5, 1.5, c)
    jp["per_channel_statistics"]["mean_of_means"] = jnp.linspace(-0.2, 0.2, c)
    vae = tvae.CausalVAE(tvae.VAEConfig.from_dict(vae_dict), FP32_POLICY)
    vae.load_state_dict(from_jax.vae_state_dict(_np_tree(jp)))
    return jcfg, jp, vae


@pytest.fixture(scope="module")
def vae_pair():
    return _vae_pair(VAE_DICT)


def test_vae_encode_matches_jax(vae_pair):
    jcfg, jp, vae = vae_pair
    rng = np.random.default_rng(3)
    media = rng.uniform(-1, 1, (1, 5, 16, 24, 3)).astype(np.float32)
    ref = jvae.encode(jp, jcfg, jnp.asarray(media))
    out = tvae.encode(vae, torch.from_numpy(media))
    assert tuple(out.shape) == ref.shape == (1, 3, 4, 6, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    # the posterior's mode, a sample's moments, and the normalization
    z_ref = jvae.sample_posterior(ref)
    z = tvae.sample_posterior(out)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=FP32_TOL)
    np.testing.assert_allclose(
        tvae.normalize_latents(z, vae.per_channel_statistics).numpy(),
        np.asarray(jvae.normalize_latents(z_ref,
                                          jp["per_channel_statistics"])),
        atol=FP32_TOL, rtol=FP32_TOL)
    back = tvae.un_normalize_latents(
        tvae.normalize_latents(z, vae.per_channel_statistics),
        vae.per_channel_statistics)
    np.testing.assert_allclose(back.numpy(), z.numpy(), atol=1e-5)
    enc = torch.cat([torch.zeros(1, 64, 8, 8, 4),
                     torch.full((1, 64, 8, 8, 4), np.log(4.0))], dim=-1)
    sample = tvae.sample_posterior(enc, torch.Generator().manual_seed(0))
    assert abs(float(sample.std()) - 2.0) < 0.05
    assert abs(float(sample.mean())) < 0.05


def test_vae_all_block_kinds_match_jax():
    """Space-to-depth down blocks, strided convs, group norm, quant convs,
    a residual upsampler and an attention mid block, encode and decode."""
    jcfg, jp, vae = _vae_pair(VAE_DICT_WIDE, seed=4)
    rng = np.random.default_rng(5)
    media = rng.uniform(-1, 1, (1, 9, 8, 8, 3)).astype(np.float32)
    ref = jvae.encode(jp, jcfg, jnp.asarray(media))
    out = tvae.encode(vae, torch.from_numpy(media))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    z = rng.standard_normal((1, 2, 2, 2, 8)).astype(np.float32)
    ref = jvae.decode(jp, jcfg, jnp.asarray(z))
    out = tvae.decode(vae, torch.from_numpy(z))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    t, j = tvae.VAEConfig.from_dict(VAE_DICT_WIDE), jcfg
    assert tvae._encoder_plan(t) == jvae._encoder_plan(j)
    assert (t.spatial_downscale_factor, t.temporal_downscale_factor) == \
        (j.spatial_downscale_factor, j.temporal_downscale_factor)


def test_vae_097_layout_matches_jax():
    """The 0.9.7 block plan at 1/8 of its base width: the port's VAE has
    exactly the JAX VAE's parameters, encoder included, in the converter's
    shapes, and its random init has the JAX distribution."""
    cfg = dataclasses.replace(
        tvae.VAEConfig.from_dict(tvae.LTX_VAE_CONFIG_097), base_channels=16)
    jcfg = dataclasses.replace(
        jvae.VAEConfig.from_dict(jvae.LTX_VAE_CONFIG_097), base_channels=16)
    vae = tvae.init_params(tvae.CausalVAE(cfg, FP32_POLICY),
                           torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda a: np.empty(a.shape, np.float32),
                      jax.eval_shape(lambda: jvae.init_params(
                          jax.random.key(0), jcfg)))
    want = {k: tuple(v.shape) for k, v in from_jax.vae_state_dict(jp).items()}
    have = {k: tuple(v.shape) for k, v in vae.state_dict().items()}
    assert have == want
    w = vae.encoder.conv_in.weight
    assert abs(float(w.std()) * (27 * w.shape[1]) ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("dims,temporal,spatial", [(3, False, True),
                                                   (2, False, True),
                                                   (3, True, True),
                                                   (3, True, False)])
def test_latent_upsampler_matches_jax(dims, temporal, spatial):
    kw = dict(in_channels=8, mid_channels=32, num_blocks_per_stage=2,
              dims=dims, spatial_upsample=spatial, temporal_upsample=temporal)
    jcfg = jlup.LatentUpsamplerConfig(**kw)
    jp = jlup.init_params(jax.random.key(6), jcfg)
    model = tlup.LatentUpsampler(tlup.LatentUpsamplerConfig(**kw), FP32_POLICY)
    model.load_state_dict(from_jax.upsampler_state_dict(_np_tree(jp)))
    rng = np.random.default_rng(7)
    z = rng.standard_normal((1, 3, 4, 5, 8)).astype(np.float32)
    ref = jlup.forward(jp, jcfg, jnp.asarray(z))
    out = tlup.forward(model, torch.from_numpy(z))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    mine = tlup.init_params(
        tlup.LatentUpsampler(tlup.LatentUpsamplerConfig(**kw), FP32_POLICY),
        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = mine.res_blocks[0].conv1.weight
    assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.1


def test_latent_upsampler_rejects_what_jax_rejects():
    for kw in (dict(spatial_upsample=False, temporal_upsample=False),
               dict(dims=2, temporal_upsample=True)):
        with pytest.raises(ValueError):
            jlup.init_params(jax.random.key(0),
                             jlup.LatentUpsamplerConfig(**kw))
        with pytest.raises(ValueError):
            tlup.LatentUpsampler(tlup.LatentUpsamplerConfig(**kw))


def test_adain_and_upsample_latents_match_jax(vae_pair):
    _, jp, vae = vae_pair
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((1, 3, 8, 10, 8)).astype(np.float32) * 2 + 1
    ref_lat = rng.standard_normal((1, 3, 4, 5, 8)).astype(np.float32)
    for factor in (1.0, 0.3):
        np.testing.assert_allclose(
            tms.adain_filter_latent(torch.from_numpy(lat),
                                    torch.from_numpy(ref_lat), factor).numpy(),
            np.asarray(jms.adain_filter_latent(jnp.asarray(lat),
                                               jnp.asarray(ref_lat), factor)),
            atol=1e-5, rtol=1e-5)
    kw = dict(in_channels=8, mid_channels=32, num_blocks_per_stage=1, dims=2)
    jcfg = jlup.LatentUpsamplerConfig(**kw)
    ju = jlup.init_params(jax.random.key(9), jcfg)
    up = tlup.LatentUpsampler(tlup.LatentUpsamplerConfig(**kw), FP32_POLICY)
    up.load_state_dict(from_jax.upsampler_state_dict(_np_tree(ju)))
    ref = jms.upsample_latents(ju, jcfg, jp["per_channel_statistics"],
                               jnp.asarray(ref_lat))
    out = tms.upsample_latents(up, vae.per_channel_statistics,
                               torch.from_numpy(ref_lat))
    assert tuple(out.shape) == ref.shape == (1, 3, 8, 10, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("z_tile,hw_tile", [(2, 0), (0, 16), (2, 16)])
def test_tiled_decode_matches_jax(vae_pair, z_tile, hw_tile):
    jcfg, jp, vae = vae_pair
    rng = np.random.default_rng(10)
    z = rng.standard_normal((1, 6, 6, 7, 8)).astype(np.float32)
    ref = jtil.tiled_decode(jp, jcfg, jnp.asarray(z), z_tile=z_tile,
                            hw_tile=hw_tile, timestep=jnp.asarray(0.05))
    out = ttil.tiled_decode(vae, torch.from_numpy(z), z_tile=z_tile,
                            hw_tile=hw_tile, timestep=torch.tensor(0.05))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("z_tile,hw_tile", [(2, 0), (0, 16), (2, 16)])
def test_tiled_encode_matches_jax(vae_pair, z_tile, hw_tile):
    jcfg, jp, vae = vae_pair
    rng = np.random.default_rng(11)
    media = rng.uniform(-1, 1, (1, 11, 24, 28, 3)).astype(np.float32)
    ref = jtil.tiled_encode(jp, jcfg, jnp.asarray(media), z_tile=z_tile,
                            hw_tile=hw_tile)
    out = ttil.tiled_encode(vae, torch.from_numpy(media), z_tile=z_tile,
                            hw_tile=hw_tile)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_tile_sizes_and_decode_tiles_match_jax(vae_pair):
    jcfg, jp, vae = vae_pair
    for kw in (dict(), dict(device_mem_mb=30000), dict(device_mem_mb=6000),
               dict(device_mem_mb=30000, mixed_precision=True),
               dict(vae_config=2)):
        assert ttil.get_vae_tile_size(**kw) == jtil.get_vae_tile_size(**kw)
    cfg97 = tvae.VAEConfig.from_dict(tvae.LTX_VAE_CONFIG_097)
    jcfg97 = jvae.VAEConfig.from_dict(jvae.LTX_VAE_CONFIG_097)
    tp = tpipe.LTXPipeline(None, types.SimpleNamespace(cfg=cfg97))
    jp_ = jpipe.LTXPipeline(None, None, None, jcfg97)
    for shape in ((1, 16, 15, 22, 128), (1, 16, 24, 40, 128),
                  (1, 33, 24, 40, 128), (1, 2, 64, 64, 128)):
        z = np.zeros(shape, np.float32)
        assert tp._decode_tiles(torch.from_numpy(z)) == \
            jp_._decode_tiles(jnp.asarray(z)), shape
    tp.vae_tile_size = (2, 256)
    assert tp._decode_tiles(torch.zeros(1, 2, 2, 2, 128)) == (2, 256)


def _items(kind, rng):
    if kind == "first_image":
        return [(rng.uniform(-1, 1, (1, 16, 24, 3)), 0, 1.0)]
    if kind == "last_image":
        return [(rng.uniform(-1, 1, (1, 16, 24, 3)), 8, 0.8)]
    if kind == "video_prefix":
        return [(rng.uniform(-1, 1, (5, 16, 24, 3)), 0, 1.0)]
    if kind == "late_video":                  # a sequence at frame 2
        return [(rng.uniform(-1, 1, (7, 16, 24, 3)), 2, 0.9)]
    return [(rng.uniform(-1, 1, (1, 32, 48, 3)), 0, 1.0)]   # resized


@pytest.mark.parametrize("kind", ["first_image", "last_image", "video_prefix",
                                  "late_video", "first_image_resized"])
def test_prepare_conditioning_matches_jax(vae_pair, kind):
    """In-grid items land on the grid with their strength in the mask; a
    non-first item leaves a prefix as extra tokens. A resized item goes
    through the antialiased bilinear resize on both sides (2e-4)."""
    jcfg, jp, vae = vae_pair
    rng = np.random.default_rng(12)
    items = [(m.astype(np.float32), f, s) for m, f, s in _items(kind, rng)]
    init = np.zeros((1, 5, 4, 6, 8), np.float32)
    ref_lat, ref_mask, ref_extras = jpipe.prepare_conditioning(
        jnp.asarray(init),
        [jpipe.ConditioningItem(jnp.asarray(m), f, s) for m, f, s in items],
        jp, jcfg)
    lat, mask, extras = tpipe.prepare_conditioning(
        torch.from_numpy(init),
        [tpipe.ConditioningItem(m, f, s) for m, f, s in items], vae)
    tol = 2e-4 if kind.endswith("resized") else FP32_TOL
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_lat), atol=tol,
                               rtol=tol)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert len(extras) == len(ref_extras) == \
        (0 if kind.startswith(("first", "video")) else 1)
    for (z, f, s), (rz, rf, rs) in zip(extras, ref_extras):
        assert (f, s) == (rf, rs)
        np.testing.assert_allclose(z.numpy(), np.asarray(rz), atol=tol,
                                   rtol=tol)
    if not extras:
        a, b = tpipe.apply_conditioning(
            torch.from_numpy(init),
            [tpipe.ConditioningItem(m, f, s) for m, f, s in items], vae)
        assert torch.equal(a, lat) and torch.equal(b, mask)
    else:
        with pytest.raises(ValueError, match="extra-token"):
            tpipe.apply_conditioning(
                torch.from_numpy(init),
                [tpipe.ConditioningItem(m, f, s) for m, f, s in items], vae)


def test_prepare_conditioning_rejects_what_jax_rejects(vae_pair):
    jcfg, jp, vae = vae_pair
    init = torch.zeros(1, 3, 4, 6, 8)
    video = np.zeros((9, 16, 24, 3), np.float32)
    with pytest.raises(ValueError, match="past the latent grid"):
        tpipe.prepare_conditioning(
            init, [tpipe.ConditioningItem(video, 2, 1.0)], vae)
    with pytest.raises(ValueError, match="past the latent grid"):
        jpipe.prepare_conditioning(
            jnp.zeros((1, 3, 4, 6, 8)),
            [jpipe.ConditioningItem(jnp.asarray(video), 2, 1.0)], jp, jcfg)
    with pytest.raises(ValueError, match="latent grid"):
        tpipe.prepare_conditioning(
            init, [tpipe.ConditioningItem(video[:1], 3, 1.0)], vae)
    decoder_only = tvae.CausalVAEDecoder(vae.cfg, FP32_POLICY)
    with pytest.raises(ValueError, match="encoder"):
        tpipe.prepare_conditioning(
            init, [tpipe.ConditioningItem(video[:1], 0, 1.0)], decoder_only)


@pytest.mark.parametrize("shape,size", [((2, 12, 18, 3), (8, 12)),
                                        ((1, 3, 8, 12, 3), (12, 18)),
                                        ((3, 24, 24, 3), (16, 20))])
def test_resize_bilinear_matches_jax_image_resize(shape, size):
    """Shrinking is antialiased in ``jax.image.resize``; growing is plain
    bilinear with half-pixel centres."""
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), shape[:-3] + size + (3,),
                           method="bilinear")
    out = tpipe.resize_bilinear(torch.from_numpy(x), *size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("canvas,image,fit", [((704, 1216), (480, 640), True),
                                              ((608, 992), (608, 992), True),
                                              ((512, 512), (300, 900), False)])
def test_media_helpers_equal_jax(canvas, image, fit):
    assert tmedia.calculate_new_dimensions(*canvas, *image, fit, 32) == \
        jmedia.calculate_new_dimensions(*canvas, *image, fit, 32)
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (48, 80, 3)).astype(np.uint8)
    for h, w in ((32, 32), (48, 80), (64, 96)):
        np.testing.assert_array_equal(
            tmedia.resize_and_crop_image(img, h, w),
            jmedia.resize_and_crop_image(img, h, w))
        np.testing.assert_array_equal(tmedia.resize_image(img, h, w),
                                      jmedia.resize_image(img, h, w))
    np.testing.assert_array_equal(tmedia.gaussian_blur_3x3(img),
                                  jmedia.gaussian_blur_3x3(img))
    np.testing.assert_array_equal(tmedia._blur3_np(img),
                                  tmedia.gaussian_blur_3x3(img))
    for apply_crf in (False,):
        np.testing.assert_array_equal(
            tmedia.prepare_conditioning_image(img, 32, 64, apply_crf),
            jmedia.prepare_conditioning_image(img, 32, 64, apply_crf))
    fl = img.astype(np.float32) / 127.5 - 1
    np.testing.assert_array_equal(
        tmedia.prepare_conditioning_image(fl, 48, 80, False),
        jmedia.prepare_conditioning_image(fl, 48, 80, False))
    pad = tmedia.calculate_padding(48, 80, 64, 96)
    frames = fl[None]
    np.testing.assert_array_equal(tmedia.pad_media(frames, pad),
                                  jmedia.pad_media(frames, pad))
    np.testing.assert_array_equal(tmedia.pad_media(frames, pad, "edge"),
                                  jmedia.pad_media(frames, pad, "edge"))


def test_crf_compress_routes(monkeypatch):
    """Without an ffmpeg binary the cv2 JPEG route answers, as in the JAX
    package, once the native codec of both packages is out of the way (its
    route: tests/test_torch_native_codec.py); the result stays in [0, 1]
    and close to the frame."""
    from ltx_video_gpupoor_tpu.utils import native_codec
    from ltx_video_gpupoor_tpu_torch.utils import native_codec as tnative

    rng = np.random.default_rng(15)
    img = np.clip(rng.normal(0.5, 0.05, (32, 48, 3)), 0, 1).astype(np.float32)
    monkeypatch.setattr(native_codec, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tmedia, "_ffmpeg", lambda: None)
    monkeypatch.setattr(jmedia, "_ffmpeg", lambda: None)
    out = tmedia.crf_compress(img)
    np.testing.assert_array_equal(out, jmedia.crf_compress(img))
    assert out.shape == img.shape and 0 <= out.min() and out.max() <= 1
    assert np.abs(out - img).mean() < 0.1


@pytest.mark.parametrize("factor", [2 / 3, 0.6666666, 0.75, 0.5])
def test_downscaled_dims_match_jax(vae_pair, factor):
    """Digit for digit: the YAML factor and 2/3 differ by a whole VAE
    block at dims divisible by 96."""
    jcfg, jp, vae = vae_pair
    cfg97 = tvae.VAEConfig.from_dict(tvae.LTX_VAE_CONFIG_097)
    jcfg97 = jvae.VAEConfig.from_dict(jvae.LTX_VAE_CONFIG_097)
    t = tms.MultiScalePipeline(
        tpipe.LTXPipeline(None, types.SimpleNamespace(cfg=cfg97)), None,
        downscale_factor=factor)
    j = jms.MultiScalePipeline(jpipe.LTXPipeline(None, None, None, jcfg97),
                               None, None, downscale_factor=factor)
    for h, w in ((704, 1216), (608, 992), (480, 704), (96, 192), (32, 32),
                 (720, 1280)):
        assert t.downscaled_dims(h, w) == j.downscaled_dims(h, w), (h, w)
    if factor == 0.6666666:
        assert t.downscaled_dims(608, 992) == (384, 640)
