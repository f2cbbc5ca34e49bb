"""The legacy (pre-causal) LTX video VAE in the port against the JAX
package on the CPU, in fp32: ``encode`` and ``decode`` for dims 3 and
(2, 1) (and 2), with and without the channel padding of the pixel
patchifier, a single image, the uniform log-variance; the published-file
converter against JAX's on the same tensors; ``load_ltxv_model`` on a
synthetic published-layout directory whose VAE is a legacy one, against
JAX's loader, and the pipeline's encode / decode dispatch. Weights are
JAX's ``init_params`` carried over by ``core/from_jax.py``. Tolerance:
2e-5 relative to each output's largest magnitude (fp32 convolutions in
another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.core import checkpoint as jckpt
from ltx_video_gpupoor_tpu.models.ltx import video_autoencoder as jv
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import video_autoencoder as tv

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1.0))


CASES = {
    "dims3": dict(dims=3),
    "dual": dict(dims=(2, 1)),
    "dims2": dict(dims=2),
    "dims3_patch2_padded": dict(dims=3, patch_size=2,
                                add_channel_padding=True),
    "dual_patch2_pt2": dict(dims=(2, 1), patch_size=2, patch_size_t=2),
    "dual_patch2": dict(dims=(2, 1), patch_size=2),
    "uniform_pixelnorm": dict(dims=3, latent_log_var="uniform",
                              use_quant_conv=False, norm_layer="pixel_norm"),
}


def _pair(**kw):
    base = dict(latent_channels=4, block_out_channels=(8, 16, 16),
                layers_per_block=1, norm_num_groups=4)
    cfg = jv.LegacyVAEConfig(**{**base, **kw})
    params = jax.tree.map(np.asarray, jv.init_params(jax.random.key(3), cfg))
    model = tv.LegacyVAE(tv.LegacyVAEConfig(**{**base, **kw}), FP32_POLICY)
    model.load_state_dict(from_jax.legacy_vae_state_dict(params))
    return cfg, params, model


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_decode_match_jax(name):
    cfg, params, model = _pair(**CASES[name])
    rng = np.random.default_rng(0)
    media = rng.standard_normal((1, 8, 16, 24, 3)).astype(np.float32)
    enc = jv.encode(params, cfg, jnp.asarray(media))
    out = tv.encode(model, torch.from_numpy(media))
    _close(out, enc)
    z = rng.standard_normal(enc.shape[:-1] + (4,)).astype(np.float32)
    for target in (None, 8):
        ref = jv.decode(params, cfg, jnp.asarray(z), target_frames=target)
        _close(tv.decode(model, torch.from_numpy(z), target_frames=target),
               ref)


@pytest.mark.parametrize("dims", [(2, 1), 2])
def test_single_image(dims):
    """One frame: time is neither padded nor strided (``in_time``)."""
    cfg, params, model = _pair(dims=dims)
    image = np.random.default_rng(1).standard_normal(
        (1, 1, 16, 16, 3)).astype(np.float32)
    enc = jv.encode(params, cfg, jnp.asarray(image))
    _close(tv.encode(model, torch.from_numpy(image)), enc)
    z = np.asarray(enc)[..., :4]
    _close(tv.decode(model, torch.from_numpy(z), target_frames=1),
           jv.decode(params, cfg, jnp.asarray(z), target_frames=1))


def test_patchify_round_trip_and_padding_equal_jax():
    x = np.random.default_rng(2).standard_normal(
        (1, 4, 8, 8, 3)).astype(np.float32)
    for q, pt, pad in ((4, 1, False), (4, 1, True), (2, 2, False),
                       (4, 2, False)):
        ref = jv.pixel_patchify(jnp.asarray(x), q, pt, pad)
        out = tv.pixel_patchify(torch.from_numpy(x), q, pt, pad)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        back = tv.pixel_unpatchify(out, q, pt, 3, pad)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jv.pixel_unpatchify(ref, q, pt, 3, pad)))
        if out.shape[-1] == 3 * pt * q * q:   # no padding channels
            np.testing.assert_array_equal(back.numpy(), x)


def test_config_from_dict_equals_jax():
    for d in ({"dims": [2, 1], "latent_channels": 128,
               "block_out_channels": [128, 256, 512, 512], "patch_size": 4},
              {"dims": 3, "latent_channels": 64, "double_z": False,
               "block_out_channels": [64, 128], "use_quant_conv": False}):
        t, j = tv.LegacyVAEConfig.from_dict(d), jv.LegacyVAEConfig.from_dict(d)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
        assert (t.spatial_downscale_factor, t.temporal_downscale_factor) == \
            (j.spatial_downscale_factor, j.temporal_downscale_factor)
    with pytest.raises(ValueError, match="uniform"):
        tv.LegacyVAEConfig.from_dict({"dims": 3, "latent_channels": 4,
                                      "block_out_channels": [8],
                                      "latent_log_var": "uniform"})


def _published_sd(params):
    """JAX's tree in the reference's published naming (the inverse of
    ``convert_legacy_vae``), torch layouts."""
    sd = {}

    def conv(prefix, p):
        if "kernel1" in p:
            for i in (1, 2):
                sd[f"{prefix}.weight{i}"] = np.transpose(
                    p[f"kernel{i}"], (4, 3, 0, 1, 2))
                sd[f"{prefix}.bias{i}"] = p[f"bias{i}"]
            return
        k = p["kernel"]
        sd[prefix + ".weight"] = np.transpose(
            k, (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1))
        sd[prefix + ".bias"] = p["bias"]

    def lin(prefix, p):
        sd[prefix + ".weight"] = p["kernel"].T[:, :, None, None, None]
        sd[prefix + ".bias"] = p["bias"]

    def res(prefix, p):
        conv(prefix + ".conv1", p["conv1"])
        conv(prefix + ".conv2", p["conv2"])
        for n in ("norm1", "norm2"):
            if n in p:
                sd[f"{prefix}.{n}.weight"] = p[n]["weight"]
                sd[f"{prefix}.{n}.bias"] = p[n]["bias"]
        if "conv_shortcut" in p:
            lin(prefix + ".conv_shortcut", p["conv_shortcut"])

    for side, stages, updown in (("encoder", "down_blocks", "downsample"),
                                 ("decoder", "up_blocks", "upsample")):
        h = params[side]
        conv(f"{side}.conv_in", h["conv_in"])
        conv(f"{side}.conv_out", h["conv_out"])
        if "conv_norm_out" in h:
            sd[f"{side}.conv_norm_out.weight"] = h["conv_norm_out"]["weight"]
            sd[f"{side}.conv_norm_out.bias"] = h["conv_norm_out"]["bias"]
        for j, rp in enumerate(h["mid_block"]["res_blocks"]):
            res(f"{side}.mid_block.res_blocks.{j}", rp)
        for i, st in enumerate(h[stages]):
            for j, rp in enumerate(st["res_blocks"]):
                res(f"{side}.{stages}.{i}.res_blocks.{j}", rp)
            if updown in st:
                conv(f"{side}.{stages}.{i}.{updown}.conv", st[updown])
    for n in ("quant_conv", "post_quant_conv"):
        if n in params:
            lin(n, params[n])
    c = params["decoder"]["conv_in"]
    c = (c["kernel"] if "kernel" in c else c["kernel1"]).shape[-2]
    sd["per_channel_statistics.std-of-means"] = np.linspace(
        0.5, 2.0, c).astype(np.float32)
    sd["per_channel_statistics.mean-of-means"] = np.linspace(
        -0.3, 0.3, c).astype(np.float32)
    return {"vae." + k: np.ascontiguousarray(v, np.float32)
            for k, v in sd.items()}


@pytest.mark.parametrize("name", ["dims3", "dual", "dims2"])
def test_convert_legacy_vae_equals_jax(name):
    cfg, params, _ = _pair(**CASES[name])
    sd = _published_sd(params)
    want = from_jax.legacy_vae_state_dict(
        jax.tree.map(np.asarray, jckpt.convert_legacy_vae(sd, cfg)))
    got = tckpt.convert_legacy_vae(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    model = tv.LegacyVAE(tv.LegacyVAEConfig(**{
        **dict(latent_channels=4, block_out_channels=(8, 16, 16),
               layers_per_block=1, norm_num_groups=4), **CASES[name]}),
        FP32_POLICY, device="meta")
    tckpt.build_module(model, got, "VAE", "cpu")
    assert float(model.per_channel_statistics.std_of_means[-1]) == 2.0


def test_pipeline_dispatch_matches_jax():
    """``encode_media`` (posterior mode, normalized) and ``decode_full``
    (un-normalized; no timestep, no noise, never tiled) take the legacy
    VAE where JAX's ``vae_encode`` / ``_decode_full`` do."""
    from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
    from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jlp
    from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as tlp

    cfg, params, model = _pair(dims=(2, 1))
    rng = np.random.default_rng(5)
    stats = {"std_of_means": rng.uniform(0.5, 2.0, 4).astype(np.float32),
             "mean_of_means": rng.normal(0, 0.3, 4).astype(np.float32)}
    params = dict(params, per_channel_statistics=stats)
    model.per_channel_statistics.std_of_means.copy_(
        torch.from_numpy(stats["std_of_means"]))
    model.per_channel_statistics.mean_of_means.copy_(
        torch.from_numpy(stats["mean_of_means"]))
    media = rng.standard_normal((1, 9, 16, 24, 3)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    ref = jvae.normalize_latents(jvae.sample_posterior(
        jlp.vae_encode(jparams, cfg, jnp.asarray(media))), stats)
    _close(tlp.encode_media(model, torch.from_numpy(media)), ref)
    grid = rng.standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    ref = jlp._decode_full(jparams, cfg, jnp.asarray(grid), jnp.float32(0.05),
                           jnp.float32(0.05), jax.random.key(0), 0, 0)
    out = tlp.decode_full(model, torch.from_numpy(grid), 0.05, 0.05, None)
    _close(out, ref)
    pipe = tlp.LTXPipeline(transformer=None, vae=model, vae_tile_size=(4, 64))
    assert pipe._decode_tiles(torch.from_numpy(grid)) == (0, 0)
