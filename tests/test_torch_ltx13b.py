"""The image-to-video slice as a whole: T5 encode, then
``LTXVideoGenerator.generate`` with ``image_start`` under the 13B distilled
multi-scale config (pass 1 at the downscaled size, latent 2x upsample,
AdaIN, pass 2, tiled VAE decode, resize back, uint8 frames) in the port
against the JAX orchestrator.

Tiny widths, but the 13B block's shape: 2 layers, 2 heads of d=128,
int8_dynamic, one guidance stream, 7 + 3 distilled timesteps. Both sides
get the same weights (core/from_jax.py), token ids, image and the two
passes' initial noise (``noise_pass1`` / ``noise_pass2``; the JAX
orchestrator has no such arguments, so a test-side subclass of its
multi-scale pipeline injects them). The conditioning-noise refresh and the
decode noise are off (they draw from generators that the two frameworks
cannot share), and the CRF round trip is patched to the identity on both
sides, since it depends on which codec a machine has. The config's
``downscale_factor`` is 0.75 here: with the shipped 0.6666666 no size that
this narrow VAE (stride 4) allows gives pass 1 a latent frame of a
16-multiple of tokens, which the fused prologue's gate needs.

Tiers: the default (``auto``: K4 + K2) against JAX's ``pallas_int8pv`` in
interpret mode; K5 + K6 (``LTXV_TPU_FUSED_PROLOGUE`` and ``pallas_hp``)
against JAX's fused prologue in interpret mode with exact attention; K3
(``attention_score_bound=32``) against JAX's bounded Pallas branch in
interpret mode; K3q (``pallas_int8`` pinned process-wide, as
``LTXV_TPU_ATTN=pallas_int8`` does, with ``attention_score_bound=32``)
against JAX's int8 Q.K^T branch under the bounded softmax in interpret
mode. Bar: the repo's oracle bar (PARITY.md), >= 40 dB PSNR on
the latents and on the uint8 frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import latent_upsampler as jlup
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.pipelines import multiscale as jms
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu_torch.configs import LTXV_13B_097_DISTILLED
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as tlup
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as tfp
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as tpipe
from ltx_video_gpupoor_tpu_torch.pipelines import multiscale as tms
from ltx_video_gpupoor_tpu_torch.serving import orchestrator as torch_orch
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0

TF_KW = dict(num_attention_heads=2, attention_head_dim=128, in_channels=16,
             out_channels=16, num_layers=2, cross_attention_dim=256,
             caption_channels=32)
VAE_DICT = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "latent_channels": 16,
    "blocks": [["res_x", 1], ["compress_all", 1], ["res_x", 1]],
    "base_channels": 8,
    "norm_num_groups": 4,
    "patch_size": 2,
    "norm_layer": "pixel_norm",
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
    "timestep_conditioning": True,
}
UP_KW = dict(in_channels=16, mid_channels=32, num_blocks_per_stage=1, dims=2)
T5_KW = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
             num_layers=2, shared_pos=True)
CONFIG = {**LTXV_13B_097_DISTILLED, "downscale_factor": 0.75,
          "decode_noise_scale": 0.0}
H, W, FRAMES = 64, 64, 9
# the VAE decode in temporal tiles of 2 latent frames (the default budget
# would not tile a frame this small)
TILE = (2, 0)


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class _NoiseMultiScale(jms.MultiScalePipeline):
    """The JAX multi-scale pipeline with the test's noise injected (kept
    on the class: the orchestrator works on a ``dataclasses.replace``
    copy)."""

    noise = (None, None)

    def generate(self, *args, **kwargs):
        n1, n2 = self.noise
        return super().generate(*args, noise_pass1=jnp.asarray(n1),
                                noise_pass2=jnp.asarray(n2), **kwargs)


class _RecordingPipeline(jpipe.LTXPipeline):
    """The JAX pipeline, keeping the latents it is asked to decode."""

    def decode(self, latent_grid, *args, **kwargs):
        self.decoded_latents = np.asarray(latent_grid)
        return super().decode(latent_grid, *args, **kwargs)


@pytest.fixture(scope="module")
def weights():
    tf_p = jax.jit(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**TF_KW)))(jax.random.key(0))
    tf_p = jq.quantize_params(tf_p, mode="dynamic")
    vcfg = jvae.VAEConfig.from_dict(VAE_DICT)
    vae_p = jax.jit(lambda k: jvae.init_params(k, vcfg))(jax.random.key(1))
    vae_p["per_channel_statistics"]["std_of_means"] = jnp.linspace(0.8, 1.2, 16)
    ucfg = jlup.LatentUpsamplerConfig(**UP_KW)
    up_p = jlup.init_params(jax.random.key(2), ucfg)
    t5_p = jt5.init_params(jax.random.key(3), jt5.T5Config(**T5_KW))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[0, 5:] = 0
    yy, xx = np.mgrid[0:H, 0:W]
    image = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 100 * np.cos(yy / 7.0),
                      (xx + yy) * 255.0 / (H + W)], axis=-1).astype(np.uint8)
    noise1 = rng.standard_normal((1, 5 * 12 * 12, 16)).astype(np.float32)
    noise2 = rng.standard_normal((1, 5 * 24 * 24, 16)).astype(np.float32)
    return tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, noise1, noise2


@pytest.fixture
def identity_crf(monkeypatch):
    monkeypatch.setattr(jmedia, "crf_compress", lambda img, crf=29: img)
    monkeypatch.setattr(tmedia, "crf_compress", lambda img, crf=29: img)


def _jax_run(weights, cfg_extra):
    tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, n1, n2 = weights
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    pipe = _RecordingPipeline(
        transformer_params=tf_p,
        transformer_cfg=jtf.LTXTransformerConfig(**TF_KW, **cfg_extra),
        vae_params=vae_p, vae_cfg=vcfg, vae_tile_size=TILE)
    ms = _NoiseMultiScale(pipe, up_p, ucfg)
    _NoiseMultiScale.noise = (n1, n2)
    frames = jorch.LTXVideoGenerator(
        pipe, multiscale=ms, pipeline_config=CONFIG).generate(
        emb, jnp.asarray(mask), height=H, width=W, frame_num=FRAMES, seed=0,
        image_start=image, image_cond_noise_scale=0.0)
    return pipe.decoded_latents, np.asarray(frames)


def _port_generator(weights, cfg_extra, policy):
    tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, n1, n2 = weights
    t5 = tt5.T5Encoder(tt5.T5Config(**T5_KW), dtype=policy.param_dtype)
    t5.load_state_dict(from_jax.state_dict(_np_tree(t5_p)))
    emb = tt5.encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    model = ttf.LTXTransformer3D(
        ttf.LTXTransformerConfig(**TF_KW, **cfg_extra), policy)
    quantize_params(model, mode="dynamic")
    model.load_state_dict(from_jax.state_dict(_np_tree(tf_p)))
    vae = tvae.CausalVAE(tvae.VAEConfig.from_dict(VAE_DICT), policy)
    vae.load_state_dict(from_jax.vae_state_dict(_np_tree(vae_p)))
    up = tlup.LatentUpsampler(tlup.LatentUpsamplerConfig(**UP_KW), policy)
    up.load_state_dict(from_jax.upsampler_state_dict(_np_tree(up_p)))
    pipe = tpipe.LTXPipeline(model, vae, vae_tile_size=TILE)
    gen = torch_orch.LTXVideoGenerator(
        pipe, multiscale=tms.MultiScalePipeline(pipe, up),
        pipeline_config=CONFIG)
    return gen, emb


def _port_run(weights, cfg_extra, attn_mode, policy=FP32_POLICY, **kw):
    *_, mask, image, n1, n2 = weights
    gen, emb = _port_generator(weights, cfg_extra, policy)
    seen = {}

    def on_stage(name, value):
        seen.setdefault(name, value)

    frames = gen.generate(
        emb, torch.from_numpy(mask), height=H, width=W, frame_num=FRAMES,
        seed=0, image_start=image, image_cond_noise_scale=0.0,
        noise_pass1=torch.from_numpy(n1), noise_pass2=torch.from_numpy(n2),
        attn_mode=attn_mode, on_stage=on_stage, **kw)
    return seen, frames


def _compare(ref_lat, ref_frames, seen, frames):
    lat = seen["decode"].float().numpy()
    assert lat.shape == ref_lat.shape == (1, 5, 24, 24, 16)
    assert seen["upsample"].shape == (1, 5, 12, 12, 16)    # pass 1 at 48x48
    assert np.isfinite(lat).all()
    assert frames.dtype == ref_frames.dtype == np.uint8
    assert frames.shape == ref_frames.shape == (FRAMES, H, W, 3)
    db_lat = _psnr(ref_lat, lat)
    db_px = _psnr(ref_frames.astype(np.float32) / 127.5 - 1,
                  frames.astype(np.float32) / 127.5 - 1)
    print(f"latents {db_lat:.2f} dB, frames {db_px:.2f} dB, frame std "
          f"{frames.std():.1f}")
    assert frames.std() > 1.0, "constant frames"
    assert db_lat >= PSNR_BAR_DB, f"latents {db_lat:.2f} dB"
    assert db_px >= PSNR_BAR_DB, f"frames {db_px:.2f} dB"
    return db_lat, db_px


def test_slice_i2v_default_tier_matches_jax(monkeypatch, weights,
                                            identity_crf):
    """``auto`` at head dim 128: the int8 QK+PV attention (K4) and the
    dynamic-int8 linears (K2), against JAX's ``pallas_int8pv`` kernel in
    interpret mode at its own default blocks."""
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))
    monkeypatch.setattr(jattn, "_FORCED_MODE", "pallas_int8pv")
    calls = []
    real = tattn.flash_attention_int8
    monkeypatch.setattr(tattn, "flash_attention_int8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ref_lat, ref_frames = _jax_run(weights, {})
    seen, frames = _port_run(weights, {}, "auto")
    assert len(calls) == 2 * 2 * (7 + 3)       # self + cross, layers, steps
    _compare(ref_lat, ref_frames, seen, frames)


def test_slice_i2v_fused_prologue_and_head_packed_match_jax(
        monkeypatch, weights, identity_crf):
    """K5 + K6: ``LTXV_TPU_FUSED_PROLOGUE`` on in both packages (the JAX
    kernel interpreted), ``pallas_hp`` in the port against JAX's exact
    attention; the cross-attention runs the exact kernel (K1) and the
    remaining linears K2."""
    monkeypatch.setenv("LTXV_TPU_FUSED_PROLOGUE", "interpret")
    fused, packed = [], []
    real_f, real_p = tfp.apply_fused, tattn.flash_attention_hp
    monkeypatch.setattr(tfp, "apply_fused",
                        lambda *a, **k: fused.append(1) or real_f(*a, **k))
    monkeypatch.setattr(tattn, "flash_attention_hp",
                        lambda *a, **k: packed.append(1) or real_p(*a, **k))
    ref_lat, ref_frames = _jax_run(weights, {})
    seen, frames = _port_run(weights, {}, "pallas_hp")
    assert len(fused) == 2 * 2 * (7 + 3) and len(packed) == 2 * (7 + 3)
    _compare(ref_lat, ref_frames, seen, frames)


def test_slice_i2v_bounded_scores_match_jax(monkeypatch, weights,
                                            identity_crf):
    """K3: ``attention_score_bound=32`` in both DiT configs; JAX runs its
    Pallas kernel's bounded branch in interpret mode."""
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))
    monkeypatch.setattr(jattn, "_FORCED_MODE", "pallas")
    bounds = []
    real = tattn.flash_attention
    monkeypatch.setattr(
        tattn, "flash_attention",
        lambda *a, **k: bounds.append(k.get("score_bound")) or real(*a, **k))
    extra = dict(attention_score_bound=32.0)
    ref_lat, ref_frames = _jax_run(weights, extra)
    seen, frames = _port_run(weights, extra, "auto")
    assert bounds == [32.0] * (2 * 2 * (7 + 3))
    _compare(ref_lat, ref_frames, seen, frames)


def test_slice_i2v_int8_bounded_scores_match_jax(monkeypatch, weights,
                                                 identity_crf):
    """K3q: ``pallas_int8`` pinned in both packages' process-wide mode and
    ``attention_score_bound=32`` in both DiT configs; JAX runs its Pallas
    kernel's int8 Q.K^T branch under the bounded softmax in interpret
    mode, the port K3q's plain version, for the self- and the
    cross-attention."""
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))
    monkeypatch.setattr(jattn, "_FORCED_MODE", "pallas_int8")
    calls = []
    real = tattn.flash_attention_int8
    monkeypatch.setattr(
        tattn, "flash_attention_int8",
        lambda *a, **k: calls.append((k["pv_int8"], k["score_bound"]))
        or real(*a, **k))
    extra = dict(attention_score_bound=32.0)
    ref_lat, ref_frames = _jax_run(weights, extra)
    try:
        tattn.set_attention_mode("pallas_int8")
        seen, frames = _port_run(weights, extra, "auto")
    finally:
        tattn.set_attention_mode("auto")
    assert calls == [(False, 32.0)] * (2 * 2 * (7 + 3))
    _compare(ref_lat, ref_frames, seen, frames)


def test_slice_i2v_bf16_policy_runs_every_tier(monkeypatch, weights,
                                               identity_crf):
    """The card's program (DEFAULT_POLICY: bf16 weights and activations)
    through the four tiers: finite latents of the right shape, frames
    that stay within 25 dB of the fp32 run of the default tier (bf16
    activations move int8 codes; the 40 dB bar is for fp32 against
    fp32)."""
    base_seen, base_frames = _port_run(weights, {}, "auto")
    bound = dict(attention_score_bound=32.0)
    for extra, mode, env in (({}, "auto", None), ({}, "pallas_hp", "1"),
                             (bound, "auto", None),
                             (bound, "pallas_int8", None)):
        if env:
            monkeypatch.setenv("LTXV_TPU_FUSED_PROLOGUE", env)
        else:
            monkeypatch.delenv("LTXV_TPU_FUSED_PROLOGUE", raising=False)
        seen, frames = _port_run(weights, extra, mode, DEFAULT_POLICY)
        assert torch.isfinite(seen["decode"]).all()
        assert frames.shape == base_frames.shape and frames.dtype == np.uint8
        db = _psnr(base_frames.astype(np.float32), frames.astype(np.float32))
        assert db >= 25.0, (mode, extra, db)


def test_generator_media_branches(monkeypatch, weights, identity_crf):
    """The other media branches against JAX, base pipeline config, 2
    steps: a last-frame image (an extra-token item), a conditioning video
    prefix, and video-to-video with ``strength`` (the schedule is cut at
    the strength and the run starts from the noised video)."""
    tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, n1, n2 = weights
    cfg = {"pipeline_type": "base", "guidance_scale": 1, "stg_scale": 0,
           "rescaling_scale": 1, "timesteps": [1.0, 0.8, 0.5, 0.2],
           "decode_timestep": 0.05, "decode_noise_scale": 0.0,
           "stochastic_sampling": False}
    rng = np.random.default_rng(5)
    video = np.clip(rng.normal(0, 0.3, (9, 32, 32, 3)), -1, 1).astype(
        np.float32)
    noise = rng.standard_normal((1, 5 * 8 * 8, 16)).astype(np.float32)
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))

    class Noise(jpipe.LTXPipeline):
        def generate(self, *a, **k):
            return super().generate(*a, noise=jnp.asarray(noise), **k)

    jp = Noise(transformer_params=tf_p,
               transformer_cfg=jtf.LTXTransformerConfig(**TF_KW),
               vae_params=vae_p, vae_cfg=vcfg)
    gen, temb = _port_generator(weights, {}, FP32_POLICY)
    gen.pipeline_config = cfg
    for kw in (dict(image_start=image[:32, :32], image_end=image[32:, 32:]),
               dict(input_video=video[:5]),
               dict(input_video=video, strength=0.6)):
        ref = jorch.LTXVideoGenerator(jp, pipeline_config=cfg).generate(
            emb, jnp.asarray(mask), height=32, width=32, frame_num=9, seed=0,
            image_cond_noise_scale=0.0, output_type="latent", **kw)
        out = gen.generate(temb, torch.from_numpy(mask), height=32, width=32,
                           frame_num=9, seed=0, image_cond_noise_scale=0.0,
                           output_type="latent", attn_mode="pallas",
                           noise=torch.from_numpy(noise), **kw)
        assert out.shape == ref.shape == (1, 5, 8, 8, 16)
        db = _psnr(np.asarray(ref), out.numpy())
        assert db >= PSNR_BAR_DB, (sorted(kw), db)
    with pytest.raises(ValueError, match="latent upsampler"):
        torch_orch.LTXVideoGenerator(
            gen.pipeline, pipeline_config=CONFIG).generate(
            temb, torch.from_numpy(mask), height=32, width=32, frame_num=9)
