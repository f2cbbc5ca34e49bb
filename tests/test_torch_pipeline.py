"""The slice as a whole: T5 encode, then ``LTXVideoGenerator.generate``
(text-to-video, base pipeline config, CFG + STG three streams, 8 steps,
timestep-conditioned decode) in the port against the JAX package.

Both sides get the same weights (core/from_jax.py), the same token ids
and the same initial noise, injected with ``noise=``. Sampling is
deterministic (``stochastic_sampling=False``) and the decode noise scale
is 0: the JAX and torch generators never draw the same numbers, so these
are the only stochastic inputs both sides can share. The JAX side runs
in fp32 on the CPU; the port runs in fp32 too, and once more in the
card's bf16 policy. The bar is the repo's oracle bar (PARITY.md):
>= 40 dB PSNR on the latents and on the decoded uint8 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu_torch.configs import LTXV_2B_096_DISTILLED
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as tpipe
from ltx_video_gpupoor_tpu_torch.serving import orchestrator as torch_orch

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0

TF_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=16,
             out_channels=16, num_layers=2, cross_attention_dim=32,
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
T5_KW = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
             num_layers=2, shared_pos=True)
CONFIG = {**LTXV_2B_096_DISTILLED, "stochastic_sampling": False,
          "decode_noise_scale": 0.0, "skip_block_list": [1]}
H, W, FRAMES = 32, 64, 9


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


class _NoisePipeline(jpipe.LTXPipeline):
    """The JAX pipeline with the test's initial noise injected (the JAX
    orchestrator has no ``noise=`` of its own)."""

    def generate(self, *args, **kwargs):
        return super().generate(*args, noise=jnp.asarray(self.noise),
                                **kwargs)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    tf_p = jax.jit(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**TF_KW)))(jax.random.key(0))
    vcfg = jvae.VAEConfig.from_dict(VAE_DICT)
    vae_p = jax.jit(lambda k: jvae.init_params(k, vcfg))(jax.random.key(1))
    vae_p["per_channel_statistics"]["std_of_means"] = jnp.linspace(0.8, 1.2, 16)
    t5_p = jt5.init_params(jax.random.key(2), jt5.T5Config(**T5_KW))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[0, 5:] = 0      # the negative prompt is shorter
    return tf_p, vcfg, vae_p, t5_p, ids, mask


def _run(weights, tier, output_type, policy=FP32_POLICY):
    """The JAX package in fp32 against the port under ``policy`` (the T5
    weights in its ``param_dtype``, as on the card); ``tier`` is
    ``"fp32"``, ``"int8_dynamic"`` or a ``quantize_params`` mode."""
    tf_p, vcfg, vae_p, t5_p, ids, mask = weights
    mode = {"fp32": None, "int8_dynamic": "dynamic"}.get(tier, tier)
    if mode is not None:
        tf_p = jq.quantize_params(tf_p, mode=mode)

    # JAX package
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    jp = _NoisePipeline(transformer_params=tf_p,
                        transformer_cfg=jtf.LTXTransformerConfig(**TF_KW),
                        vae_params=vae_p, vae_cfg=vcfg)
    f, h, w = jp.latent_shape(H, W, FRAMES)
    jp.noise = np.random.default_rng(1).standard_normal(
        (1, f * h * w, TF_KW["in_channels"])).astype(np.float32)
    ref = jorch.LTXVideoGenerator(jp, pipeline_config=CONFIG).generate(
        emb, jnp.asarray(mask), height=H, width=W, frame_num=FRAMES, seed=0,
        output_type=output_type)

    # port
    t5 = tt5.T5Encoder(tt5.T5Config(**T5_KW), dtype=policy.param_dtype)
    t5.load_state_dict(from_jax.state_dict(_np_tree(t5_p)))
    temb = tt5.encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW), policy)
    if mode is not None:
        quantize_params(model, mode=mode)
    model.load_state_dict(from_jax.state_dict(_np_tree(tf_p)))
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(VAE_DICT), policy)
    vae.load_state_dict(from_jax.vae_decoder_state_dict(_np_tree(vae_p)))
    gen = torch_orch.LTXVideoGenerator(tpipe.LTXPipeline(model, vae),
                                       pipeline_config=CONFIG)
    out = gen.generate(temb, torch.from_numpy(mask), height=H, width=W,
                       frame_num=FRAMES, seed=0, output_type=output_type,
                       noise=torch.from_numpy(jp.noise))
    return np.asarray(ref), np.asarray(out)


@pytest.mark.parametrize("tier", ["fp32", "int8_dynamic"])
def test_slice_t2v_matches_jax(weights, tier):
    ref, out = _run(weights, tier, "pixels")
    assert out.dtype == np.uint8 and ref.dtype == np.uint8
    assert out.shape == ref.shape == (FRAMES, H, W, 3)
    db = _psnr(ref.astype(np.float32) / 127.5 - 1,
               out.astype(np.float32) / 127.5 - 1)
    assert db >= PSNR_BAR_DB, f"frames {db:.2f} dB"


def test_slice_latents_match_jax(weights):
    ref, out = _run(weights, "int8_dynamic", "latent")
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    db = _psnr(ref, out)
    assert db >= PSNR_BAR_DB, f"latents {db:.2f} dB"


@pytest.mark.parametrize("output_type", ["latent", "pixels"])
def test_slice_bf16_compute_matches_jax(weights, output_type):
    """The card's program (DEFAULT_POLICY: bf16 weights, DiT and VAE
    activations in bf16, int8_dynamic) against the JAX package, whose DiT
    sees fp32 latents and so runs fp32 activations."""
    ref, out = _run(weights, "int8_dynamic", output_type, DEFAULT_POLICY)
    assert out.shape == ref.shape
    if output_type == "pixels":
        assert out.dtype == np.uint8
        ref, out = (a.astype(np.float32) / 127.5 - 1 for a in (ref, out))
    assert np.isfinite(out).all()
    db = _psnr(ref, out)
    assert db >= PSNR_BAR_DB, f"{output_type} {db:.2f} dB"


def test_generator_rejects_unported_branches(weights):
    """An unknown output type is refused. TeaCache is ported
    (tests/test_torch_teacache.py); ``yuv420`` and resolution bucketing
    are ported
    (tests/test_torch_serving.py), as are image conditioning and the
    multi-scale configs (tests/test_torch_ltx13b.py): what those still
    refuse is a VAE without its encoder and a multi-scale config without
    an upsampler."""
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(VAE_DICT),
                                FP32_POLICY)
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                 FP32_POLICY)
    gen = torch_orch.LTXVideoGenerator(tpipe.LTXPipeline(model, vae))
    emb, mask = torch.zeros(2, 4, 32), torch.ones(2, 4)
    with pytest.raises(ValueError, match="output_type"):
        gen.generate(emb, mask, output_type="yuv444")
    with pytest.raises(ValueError, match="encoder"):
        gen.generate(emb, mask, height=32, width=32, frame_num=9,
                     image_start=np.zeros((32, 32, 3), np.uint8))
    ms = torch_orch.LTXVideoGenerator(
        tpipe.LTXPipeline(model, vae),
        pipeline_config="ltxv-13b-0.9.7-distilled")
    with pytest.raises(ValueError, match="latent upsampler"):
        ms.generate(emb, mask, height=32, width=32, frame_num=9)


@pytest.mark.parametrize("sampler,shift", [("Constant", 2.5),
                                           ("Uniform", None)])
def test_generate_threads_sampler_and_shift(monkeypatch, sampler, shift):
    """``generate(sampler=, shift=)`` reaches ``make_schedule`` in both
    packages (JAX :734, :755) and gives the same schedule."""
    class Stop(Exception):
        pass

    seen = {}

    def spy(name, make):
        def wrapped(*args, **kwargs):
            seen[name] = np.asarray(make(*args, **kwargs).timesteps)
            raise Stop
        return wrapped

    make_schedule = tpipe.rf.make_schedule
    monkeypatch.setattr(tpipe.rf, "make_schedule",
                        spy("port", make_schedule))
    monkeypatch.setattr(jpipe.rf, "make_schedule",
                        spy("jax", jpipe.rf.make_schedule))
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(VAE_DICT),
                                FP32_POLICY)
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                 FP32_POLICY)
    kw = dict(height=H, width=W, num_frames=FRAMES, num_inference_steps=6,
              sampler=sampler, shift=shift)
    pipe = tpipe.LTXPipeline(model, vae)
    with pytest.raises(Stop):
        pipe.generate(torch.zeros(2, 4, 32), torch.ones(2, 4), **kw)
    jp = jpipe.LTXPipeline(transformer_params={},
                           transformer_cfg=jtf.LTXTransformerConfig(**TF_KW),
                           vae_params={},
                           vae_cfg=jvae.VAEConfig.from_dict(VAE_DICT))
    with pytest.raises(Stop):
        jp.generate(jnp.zeros((2, 4, 32)), jnp.ones((2, 4)), **kw)
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=1e-6)
    uniform = np.asarray(make_schedule(
        6, shifting="SD3", n_media_tokens=int(np.prod(pipe.latent_shape(
            H, W, FRAMES))), target_shift_terminal=0.1).timesteps)
    assert np.allclose(seen["port"], uniform) == (sampler == "Uniform")


@pytest.mark.parametrize("h,w,f", [(480, 704, 121), (250, 250, 10)])
def test_orchestrator_helpers_match_jax(h, w, f):
    assert torch_orch.pad_dimensions(h, w, f) == jorch.pad_dimensions(h, w, f)
    for cfg in (CONFIG, {"timesteps": [1.0, 0.9, 0.5],
                         "skip_initial_inference_steps": 1}):
        np.testing.assert_allclose(
            torch_orch.build_timesteps(cfg, 5280, "from_checkpoint"),
            jorch.build_timesteps(cfg, 5280, "from_checkpoint"), atol=1e-6)
    g_t = tpipe.build_guidance_schedule(np.linspace(1, 0.1, 6), 4, 3.0, 1.0,
                                        0.7, [[], [1, 2]], [1.0, 0.5])
    g_j = jpipe.build_guidance_schedule(np.linspace(1, 0.1, 6), 4, 3.0, 1.0,
                                        0.7, [[], [1, 2]], [1.0, 0.5])
    for field in ("guidance_scale", "stg_scale", "rescaling_scale",
                  "skip_layer_mask"):
        np.testing.assert_array_equal(getattr(g_t, field), getattr(g_j, field))
    assert (g_t.num_conds, g_t.do_cfg, g_t.do_stg) == \
        (g_j.num_conds, g_j.do_cfg, g_j.do_stg)
    coords = np.stack(np.meshgrid(np.arange(3), np.arange(2), np.arange(2),
                                  indexing="ij")).reshape(1, 3, -1)
    np.testing.assert_array_equal(
        tpipe.latent_to_pixel_coords(torch.from_numpy(coords), (8, 32, 32)),
        jpipe.latent_to_pixel_coords(jnp.asarray(coords), (8, 32, 32)))
