"""The port's LTX and Wan pipelines with ``sp_mesh`` and its parallel tiled
decodes, against the JAX package on the CPU: the fallback on shapes that
do not divide over sp, the places where every rank must take the same
branch (TeaCache's skips, the fallback, the SLG / STG skip masks), and
``parallel_tiled_decode`` / ``parallel_spatial_tiled_decode``.

Ranks are gloo processes (``core.mesh.spawn_ranks``, a ``FileStore`` under
``tmp_path``, a 120 s group timeout, one thread each) running
``tests/torch_mesh_workers.py``; the JAX side runs its own sharded versions
on the virtual CPU devices of tests/conftest.py. Weights come from JAX's
``init_params`` through ``core/from_jax.py``, inputs from numpy with a
seed; all in fp32, at JAX's tolerances (tests/test_parallel.py,
tests/test_vae_tiling.py): 2e-4 for the pipelines, 1e-4 for the decodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.models.ltx import vae_tiling as jtiling
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.pipelines.ltx_pipeline import LTXPipeline
from ltx_video_gpupoor_tpu.pipelines.wan import WanPipeline
from ltx_video_gpupoor_tpu.schedulers import unipc
from ltx_video_gpupoor_tpu_torch.core import from_jax
from test_torch_usp import TOL, _np_tree, _sd, jax_mesh, spawn


# ---- the pipelines --------------------------------------------------------

PIPE_LTX_KW = dict(num_attention_heads=2, attention_head_dim=16,
                   in_channels=8, out_channels=8, num_layers=2,
                   cross_attention_dim=32, caption_channels=24)
PIPE_VAE = {
    "_class_name": "CausalVideoAutoencoder", "dims": 3,
    "latent_channels": 8,
    "blocks": [["res_x", 1], ["compress_all", 1], ["res_x", 1]],
    "base_channels": 8, "norm_num_groups": 4, "patch_size": 2,
    "norm_layer": "pixel_norm", "latent_log_var": "uniform",
    "use_quant_conv": False, "causal_decoder": False,
}


class _NoisePipeline(LTXPipeline):
    """The JAX pipeline with the test's initial noise injected."""

    def generate(self, *args, **kwargs):
        return super().generate(*args, noise=jnp.asarray(self.noise),
                                **kwargs)


@pytest.fixture(scope="module")
def ltx_pipe():
    cfg = jtf.LTXTransformerConfig(**PIPE_LTX_KW)
    vcfg = jvae.VAEConfig.from_dict(PIPE_VAE)
    tf_p = jax.jit(lambda k: jtf.init_params(k, cfg))(jax.random.key(0))
    vae_p = jax.jit(lambda k: jvae.init_params(k, vcfg))(jax.random.key(1))
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 8, 24)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[0, 6:] = 0
    return cfg, vcfg, tf_p, vae_p, emb, mask


def _ltx_pipeline_case(tmp_path, ltx_pipe, num_frames, extra):
    cfg, vcfg, tf_p, vae_p, emb, mask = ltx_pipe
    kw = dict(height=32, width=32, num_frames=num_frames,
              num_inference_steps=3, guidance_scale=3.0, stg_scale=1.0,
              skip_block_list=[1], output_type="latent", **extra)
    jp = _NoisePipeline(transformer_params=tf_p, transformer_cfg=cfg,
                        vae_params=vae_p, vae_cfg=vcfg, sp_mesh=jax_mesh(2))
    f, h, w = jp.latent_shape(32, 32, num_frames)
    jp.noise = np.random.default_rng(3).standard_normal(
        (1, f * h * w, 8)).astype(np.float32)
    ref = np.asarray(jp.generate(
        jnp.asarray(emb), jnp.asarray(mask), key=jax.random.key(3),
        attn_mode="xla", **kw))
    outs = spawn(tmp_path, workers.ltx_pipeline, 2, PIPE_LTX_KW,
                 _sd(tf_p), PIPE_VAE,
                 {k: v.numpy() for k, v in from_jax.vae_decoder_state_dict(
                     _np_tree(vae_p)).items()},
                 emb, mask, jp.noise, dict(kw, attn_mode="xla"))
    return ref, outs


def test_usp_ltx_pipeline_matches_jax(tmp_path, ltx_pipe):
    """``generate`` with ``sp_mesh`` (sp = 2): CFG + STG streams and the
    per-group timesteps under USP, against JAX's USP run."""
    ref, outs = _ltx_pipeline_case(tmp_path, ltx_pipe, 7, {})
    for out, logs in outs:
        np.testing.assert_allclose(out, ref, **TOL)
        assert not [m for m in logs if "USP disabled" in m]


def test_usp_ltx_teacache_same_on_every_rank(tmp_path, ltx_pipe):
    """TeaCache under sp = 2: the skip schedule is computed before the
    loop from replicated inputs, so both ranks skip the same steps (a
    rank that skipped alone would leave the other waiting in the
    all-to-all); the latents match JAX's USP run with the same
    multiplier."""
    ref, outs = _ltx_pipeline_case(tmp_path, ltx_pipe, 7,
                                   dict(teacache_multiplier=3.0))
    for out, _ in outs:
        np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


def test_usp_ltx_fallback_logs_and_runs_unsharded(tmp_path, ltx_pipe):
    """3 latent frames do not divide over sp = 2: every rank logs and runs
    the call unsharded (the same decision everywhere, from shapes
    alone), equal to JAX's fallback."""
    ref, outs = _ltx_pipeline_case(tmp_path, ltx_pipe, 9, {})
    for out, logs in outs:
        np.testing.assert_allclose(out, ref, **TOL)
        assert [m for m in logs if "USP disabled" in m]


PIPE_WAN_KW = dict(model_type="t2v", patch_size=(1, 2, 2), text_len=16,
                   in_dim=4, dim=128, ffn_dim=256, freq_dim=32, text_dim=32,
                   out_dim=4, num_heads=4, num_layers=2)


@pytest.mark.parametrize("case", ["slg", "teacache", "fallback"])
def test_usp_wan_pipeline_matches_jax(tmp_path, case):
    """``denoise`` with ``sp_mesh`` (sp = 2) against JAX's: CFG with an
    SLG window (the skip masks replicated, so every rank skips the same
    layers), a TeaCache mask that skips steps on both ranks alike, and
    5 frames that fall back to the unsharded run with a warning."""
    cfg = jwm.WanConfig(**PIPE_WAN_KW)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    f = 5 if case == "fallback" else 4
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, f, 4, 6, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    cmask = np.ones((2, 16), np.int32)
    sigmas = np.asarray(unipc.unipc_sigmas(4, shift=5.0))
    kw = dict(guide_scale=5.0, solver="unipc", slg_layers=[1],
              slg_start=0.0, slg_end=1.0, cfg_zero_step=0)
    tc = (np.array([True, False, True, False]) if case == "teacache"
          else None)
    jp = WanPipeline(model_params=params, model_cfg=cfg, vae_params=None,
                     vae_cfg=None, vae_tile_size=0, sp_mesh=jax_mesh(2))
    ref = np.asarray(jp.denoise(jnp.asarray(lat), jnp.asarray(ctx),
                                jnp.asarray(cmask), jnp.asarray(sigmas),
                                key=jax.random.key(4), attn_mode="xla",
                                teacache_mask=tc, **kw))
    outs = spawn(tmp_path, workers.wan_pipeline, 2, PIPE_WAN_KW, _sd(params),
                 lat, ctx, cmask, sigmas, dict(kw, attn_mode="pallas"), tc)
    for out, flags, logs in outs:
        np.testing.assert_allclose(out, ref, **TOL)
        assert flags == (list(tc) if tc is not None else [True] * 4)
        assert bool([m for m in logs if "sp-mesh fallback" in m]) == (
            case == "fallback")


# ---- the parallel tiled decodes -------------------------------------------

DEC_VAE = {
    "_class_name": "CausalVideoAutoencoder", "dims": 3,
    "latent_channels": 4, "blocks": [["res_x", 1], ["compress_all", 1]],
    "base_channels": 8, "norm_num_groups": 4, "patch_size": 2,
    "norm_layer": "pixel_norm", "latent_log_var": "uniform",
    "use_quant_conv": False, "causal_decoder": False,
}


@pytest.mark.parametrize("world,shape,z_tile", [
    (2, (1, 2, 14, 12, 4), 0),       # 6 tiles over 2 ranks, tails padded
    (2, (1, 9, 12, 12, 4), 4),       # temporal tiles, each one's grid
    (4, (1, 2, 12, 8, 4), 0),        # a narrow grid: 2 tiles on 4 ranks
])
def test_parallel_tiled_decode_matches_jax(tmp_path, world, shape, z_tile):
    vcfg = jvae.VAEConfig.from_dict(DEC_VAE)
    params = jax.jit(lambda k: jvae.init_params(k, vcfg))(jax.random.key(0))
    z = (np.random.default_rng(1).standard_normal(shape) * 0.5).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, zz: jtiling.parallel_tiled_decode(
        jax_mesh(world), p, vcfg, zz, z_tile=z_tile, hw_tile=32))(
        params, jnp.asarray(z)))
    vae_np = {k: v.numpy() for k, v in from_jax.vae_decoder_state_dict(
        _np_tree(params)).items()}
    outs = spawn(tmp_path, workers.ltx_decode, world, DEC_VAE, vae_np, z,
                 z_tile, 32)
    for out in outs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


WAN_VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                  attn_scales=(), temperal_downsample=(True,))


def test_parallel_spatial_tiled_decode_matches_jax(tmp_path):
    vcfg = jwv.WanVAEConfig(**WAN_VAE_KW)
    params = jax.jit(lambda k: jwv.init_params(k, vcfg))(jax.random.key(0))
    z = (np.random.default_rng(2).standard_normal((1, 2, 12, 10, 4))
         * 0.5).astype(np.float32)
    # 8-latent tiles at stride 6: 2 x 2 tiles, both tails edge-padded
    ref = np.asarray(jwv.parallel_spatial_tiled_decode_fused(
        jax_mesh(2), params, vcfg, jnp.asarray(z), tile_size=16))
    vae_np = {k: v.numpy() for k, v in from_jax.wan_vae_decoder_state_dict(
        _np_tree(params)).items()}
    outs = spawn(tmp_path, workers.wan_decode, 2, WAN_VAE_KW, vae_np, z, 16)
    for out in outs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_usp_wan_df_pipeline_matches_jax(tmp_path):
    """Diffusion forcing with ``sp_mesh`` (sp = 2): 10 latent frames, each
    with its own timestep row, causal blocks of one frame at ar_step 1,
    the fps row; the timestep matrix stays whole on every rank and each
    row's ``[B, F]`` timesteps shard with their frames, against JAX's DF
    pipeline under its ``shard_map``."""
    from ltx_video_gpupoor_tpu.pipelines import wan_df as jdf

    cfg = jwm.WanConfig(**PIPE_WAN_KW, inject_sample_info=True)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    cmask = np.ones((2, 16), np.int32)
    cmask[1, 7:] = 0
    noise = rng.standard_normal((1, 10, 8, 8, 4)).astype(np.float32)
    kw = dict(height=16, width=16, frame_num=37, sampling_steps=3,
              ar_step=1, causal_block_size=1, guide_scale=5.0, fps=24,
              output_type="latent")
    jp = jdf.WanDFPipeline(model_params=params, model_cfg=cfg,
                           vae_params=None,
                           vae_cfg=jwv.WanVAEConfig(**WAN_VAE_KW),
                           vae_stride=(4, 2, 2), sp_mesh=jax_mesh(2))
    ref = np.asarray(jp.generate(jnp.asarray(ctx), jnp.asarray(cmask),
                                 key=jax.random.key(5),
                                 noise=jnp.asarray(noise), attn_mode="xla",
                                 **kw))
    outs = spawn(tmp_path, workers.wan_df_pipeline, 2,
                 dict(PIPE_WAN_KW, inject_sample_info=True), _sd(params),
                 WAN_VAE_KW, ctx, cmask, noise, dict(kw, attn_mode="pallas"))
    for out, logs in outs:
        assert out.shape == ref.shape == noise.shape
        np.testing.assert_allclose(out, ref, **TOL)
        assert not [m for m in logs if "fallback" in m]
