"""The two requests that ``chip_smoke.py``'s ``[cards]`` spreads over four
cards, at tiny widths on 4 gloo ranks, against the JAX package on 4 of the
virtual CPU devices:

- the LTX-13B route (``LTXVideoGenerator.generate`` with the multi-scale
  pipeline, image-to-video, ``ltxv-13b-0.9.7-distilled``'s passes) with
  ``sp_mesh`` at sp = 4, against JAX's orchestrator on a 4-device sp mesh;
  Ulysses' all-to-alls must run in both passes (4 latent frames and 4
  heads divide over sp, so neither pass falls back);
- Wan ``generate_t2v`` with the DiT cut over tp = 4 by
  ``apply_wan_serving_mesh``, against JAX's SPMD program: its parameters
  placed by ``wan_param_shardings`` on a 4-device tp mesh and every step
  jitted;
- Wan ``generate_i2v`` the same way: CLIP's features (CLIP whole on every
  rank, at CLIP ViT-H/14's width 1280 and head dim 80, two blocks), the
  Wan VAE encode of the first frame, 2 steps of the 36-channel-style DiT
  (latents, mask and the encoded frame) cut over tp = 4, and the parallel
  spatial tiled decode over the 4 ranks against JAX's fused one.

Weights come from JAX's ``init_params`` through ``core/from_jax.py``,
inputs and noises from numpy with a seed, in fp32 with the exact
attention on both sides (JAX's mode pinned to ``xla``); tolerances are
JAX's for the sharded pipelines (tests/test_parallel.py): 2e-4, and 40 dB
on the decoded frames. Rank bodies: ``tests/torch_cards_workers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np

import torch_cards_workers as workers
from ltx_video_gpupoor_tpu.core import mesh as jmesh
from ltx_video_gpupoor_tpu.models.ltx import latent_upsampler as jlup
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.models.wan import clip as jclip
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.parallel import sharding as jsh
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.pipelines import multiscale as jms
from ltx_video_gpupoor_tpu.pipelines.wan import WanPipeline
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu_torch.configs import LTXV_13B_097_DISTILLED
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh
from test_torch_wan import _vae_params

TOL = dict(atol=2e-4, rtol=2e-4)
FRAMES_DB = 40.0
TIMEOUT = 120.0


def spawn(tmp_path, fn, world, *args):
    return tmesh.spawn_ranks(fn, world, backend="gloo", timeout=TIMEOUT,
                             store_dir=str(tmp_path), args=args)


def _mesh(sp=1, tp=1):
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, sp=sp, tp=tp),
                           devices=jax.devices()[:sp * tp])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


# ---- LTX-13B's route over sp = 4 -------------------------------------------

TF_KW = dict(num_attention_heads=4, attention_head_dim=32, in_channels=16,
             out_channels=16, num_layers=2, cross_attention_dim=128,
             caption_channels=32)
VAE_DICT = {
    "_class_name": "CausalVideoAutoencoder", "dims": 3,
    "latent_channels": 16,
    "blocks": [["res_x", 1], ["compress_time", 1], ["compress_time", 1],
               ["compress_time", 1], ["res_x", 1]],
    "base_channels": 8, "norm_num_groups": 4, "patch_size": 4,
    "norm_layer": "pixel_norm", "latent_log_var": "uniform",
    "use_quant_conv": False, "causal_decoder": False,
    "timestep_conditioning": True,
}
UP_KW = dict(in_channels=16, mid_channels=32, num_blocks_per_stage=1, dims=2)
CONFIG = {**LTXV_13B_097_DISTILLED, "downscale_factor": 0.75,
          "decode_noise_scale": 0.0}
# 25 frames are 4 latent frames (the VAE halves time three times, as the
# 0.9.7 VAE does); pass 1 at 48x48
H, W, FRAMES = 64, 64, 25
LAT = (4, 12, 12)


class _NoiseMultiScale(jms.MultiScalePipeline):
    noise = (None, None)

    def generate(self, *args, **kwargs):
        n1, n2 = self.noise
        return super().generate(*args, noise_pass1=jnp.asarray(n1),
                                noise_pass2=jnp.asarray(n2), **kwargs)


class _RecordingPipeline(jpipe.LTXPipeline):
    def decode(self, latent_grid, *args, **kwargs):
        self.decoded_latents = np.asarray(latent_grid)
        return super().decode(latent_grid, *args, **kwargs)


def test_ltx13b_route_at_sp4_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jattn, "_FORCED_MODE", "xla")
    monkeypatch.setattr(jmedia, "crf_compress", lambda img, crf=29: img)
    cfg = jtf.LTXTransformerConfig(**TF_KW)
    tf_p = jax.jit(lambda k: jtf.init_params(k, cfg))(jax.random.key(0))
    vcfg = jvae.VAEConfig.from_dict(VAE_DICT)
    vae_p = jax.jit(lambda k: jvae.init_params(k, vcfg))(jax.random.key(1))
    vae_p["per_channel_statistics"]["std_of_means"] = jnp.linspace(
        0.8, 1.2, 16)
    ucfg = jlup.LatentUpsamplerConfig(**UP_KW)
    up_p = jlup.init_params(jax.random.key(2), ucfg)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[0, 5:] = 0
    yy, xx = np.mgrid[0:H, 0:W]
    image = np.stack([128 + 100 * np.sin(xx / 9.0),
                      128 + 100 * np.cos(yy / 7.0),
                      (xx + yy) * 255.0 / (H + W)], -1).astype(np.uint8)
    f, h, w = LAT
    noises = (rng.standard_normal((1, f * h * w, 16)).astype(np.float32),
              rng.standard_normal((1, f * 4 * h * w, 16)).astype(np.float32))

    pipe = _RecordingPipeline(
        transformer_params=tf_p, transformer_cfg=cfg, vae_params=vae_p,
        vae_cfg=vcfg, vae_tile_size=(2, 0), sp_mesh=_mesh(sp=4))
    ms = _NoiseMultiScale(pipe, up_p, ucfg)
    _NoiseMultiScale.noise = noises
    ref_frames = np.asarray(jorch.LTXVideoGenerator(
        pipe, multiscale=ms, pipeline_config=CONFIG).generate(
        jnp.asarray(emb), jnp.asarray(mask), height=H, width=W,
        frame_num=FRAMES, seed=0, image_start=image,
        image_cond_noise_scale=0.0))
    ref_lat = pipe.decoded_latents

    outs = spawn(tmp_path, workers.multiscale_sp, 4, TF_KW,
                 _numpy(from_jax.state_dict(_np_tree(tf_p))), VAE_DICT,
                 _numpy(from_jax.vae_state_dict(_np_tree(vae_p))), UP_KW,
                 _numpy(from_jax.upsampler_state_dict(_np_tree(up_p))),
                 CONFIG, emb, mask, image, noises, (H, W, FRAMES))
    for lat, frames, logs, passes in outs:
        assert lat.shape == ref_lat.shape == (1, f, 2 * h, 2 * w, 16)
        np.testing.assert_allclose(lat, ref_lat, **TOL)
        assert frames.shape == ref_frames.shape == (FRAMES, H, W, 3)
        assert _psnr(frames, ref_frames) >= FRAMES_DB
        assert frames.std() > 1.0
        # USP in both passes: 4 all-to-alls a block a step, no fallback
        steps = (len(CONFIG["first_pass"]["timesteps"]),
                 len(CONFIG["second_pass"]["timesteps"]))
        assert passes == tuple(4 * TF_KW["num_layers"] * n for n in steps)
        assert not [m for m in logs if "USP disabled" in m]


# ---- Wan generate_t2v over tp = 4 ------------------------------------------

WAN_KW = dict(dim=128, ffn_dim=256, num_heads=4, num_layers=2, text_dim=64,
              in_dim=4, out_dim=4, freq_dim=32, text_len=8,
              patch_size=(1, 2, 2), model_type="t2v")
STEPS = 2


def test_wan_t2v_at_tp4_matches_jax_spmd(tmp_path):
    cfg = jwm.WanConfig(**WAN_KW)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((2, 8, 64)).astype(np.float32)
    cmask = np.ones((2, 8), np.int32)
    cmask[1, 5:] = 0
    noise = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    kw = dict(width=32, height=32, frame_num=5, sampling_steps=STEPS,
              guide_scale=5.0, attn_mode="xla")
    mesh = _mesh(tp=4)
    placed = jax.tree.map(jax.device_put, params,
                          jsh.wan_param_shardings(mesh, params))
    jp = WanPipeline(model_params=placed, model_cfg=cfg, vae_params=None,
                     vae_cfg=None, vae_tile_size=0, mesh=mesh)
    ref = np.asarray(jp.generate_t2v(
        jnp.asarray(ctx), jnp.asarray(cmask), noise=jnp.asarray(noise),
        output_type="latent", key=jax.random.key(5), **kw))
    outs = spawn(tmp_path, workers.wan_t2v_tp, 4, WAN_KW,
                 _numpy(from_jax.state_dict(_np_tree(params))), ctx, cmask,
                 noise, kw)
    for out, calls in outs:
        np.testing.assert_allclose(out, ref, **TOL)
        # one forward a step (the guidance streams are batch rows); a
        # block's all-reduces: the sums of its three row-parallel linears
        # and of the four q/k norms (dense weights: no int8 row amax); no
        # all-to-all
        assert calls == {"all_reduce": 7 * WAN_KW["num_layers"] * STEPS}



# ---- Wan generate_i2v over tp = 4 ------------------------------------------

I2V_VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                  attn_scales=(), temperal_downsample=(True,))
I2V_STRIDE = (2, 2, 2)
# in_dim: the noisy latents, the first frame's mask (one channel a frame of
# the temporal stride) and its encoded latents
I2V_KW = dict(WAN_KW, model_type="i2v", in_dim=4 + I2V_STRIDE[0] + 4)
# CLIP ViT-H/14's width and heads (the DiT's img_emb takes 1280 features),
# cut to 3 layers (the features are the penultimate block's)
CLIP_KW = dict(image_size=224, patch_size=14, dim=1280, num_heads=16,
               num_layers=3)
I2V_H, I2V_W, I2V_FRAMES = 32, 32, 5


def test_wan_i2v_at_tp4_matches_jax_spmd(tmp_path):
    cfg = jwm.WanConfig(**I2V_KW)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    ccfg = jclip.CLIPVisionConfig(**CLIP_KW)
    clip_p = jax.jit(lambda k: jclip.init_params(k, ccfg))(jax.random.key(1))
    vae_p = _vae_params(2, **I2V_VAE_KW)
    rng = np.random.default_rng(4)
    image = rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)
    frame = rng.uniform(-1, 1, (I2V_H, I2V_W, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 64)).astype(np.float32)
    cmask = np.ones((2, 8), np.int32)
    cmask[1, 5:] = 0
    f = (I2V_FRAMES - 1) // I2V_STRIDE[0] + 1
    noise = rng.standard_normal(
        (1, f, I2V_H // 2, I2V_W // 2, 4)).astype(np.float32)
    kw = dict(width=I2V_W, height=I2V_H, frame_num=I2V_FRAMES,
              sampling_steps=STEPS, guide_scale=5.0, attn_mode="xla")

    feats = np.asarray(jclip.visual(clip_p, ccfg, jnp.asarray(image)))
    mesh = _mesh(tp=4)
    placed = jax.tree.map(jax.device_put, params,
                          jsh.wan_param_shardings(mesh, params))
    jp = WanPipeline(model_params=placed, model_cfg=cfg, vae_params=vae_p,
                     vae_cfg=jwv.WanVAEConfig(**I2V_VAE_KW),
                     vae_stride=I2V_STRIDE, vae_tile_size=16, mesh=mesh)
    ref_lat = jp.generate_i2v(
        jnp.asarray(ctx), jnp.asarray(cmask), jnp.asarray(feats),
        jnp.asarray(frame), noise=jnp.asarray(noise), output_type="latent",
        key=jax.random.key(5), **kw)
    ref_frames = np.asarray(jp._vae_decode(ref_lat))
    ref_lat = np.asarray(ref_lat)
    outs = spawn(tmp_path, workers.wan_i2v_tp, 4, I2V_KW,
                 _numpy(from_jax.state_dict(_np_tree(params))), CLIP_KW,
                 _numpy(from_jax.state_dict(_np_tree(clip_p))), I2V_VAE_KW,
                 _numpy(from_jax.state_dict(_np_tree(vae_p))), I2V_STRIDE,
                 image, frame, ctx, cmask, noise, kw)
    for lat, frames, got_feats, calls in outs:
        np.testing.assert_allclose(got_feats, feats, atol=1e-4, rtol=1e-4)
        assert lat.shape == ref_lat.shape == noise.shape
        np.testing.assert_allclose(lat, ref_lat, **TOL)
        assert frames.shape == ref_frames.shape == (1, I2V_FRAMES, I2V_H,
                                                    I2V_W, 3)
        assert _psnr(frames, ref_frames) >= FRAMES_DB
        assert frames.std() > 0.05
        # one forward a step; a block's all-reduces: its three row-parallel
        # linears' sums and the four q/k norms (the image keys' norm_k_img
        # is whole: k_img is not cut), and the decode's gather of tiles
        assert calls == {"all_reduce": 7 * I2V_KW["num_layers"] * STEPS,
                         "all_gather": 1}
