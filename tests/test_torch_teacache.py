"""LTX TeaCache in the port against the JAX package: the pinned
``calibrate_mask``, ``ltx_teacache_schedule`` on shared weights, the
DiT's ``previous_residual`` / ``compute`` / ``return_residual``, the
denoise loop's residual carry through ``generate`` (single-scale and the
two-pass multi-scale pipeline) and the CLI's ``--teacache``.

Both sides get the same weights (core/from_jax.py), token ids and
injected noise, and run the plain fp32 attention (``xla``), so what is
compared is TeaCache itself. Tolerances: masks equal exactly; the DiT
forward within 1e-4 (fp32, other summation orders); latents and frames
>= 40 dB PSNR (PARITY.md's oracle bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.pipelines import ltx_pipeline as jpipe
from ltx_video_gpupoor_tpu.pipelines import teacache as jteacache
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as tpipe
from ltx_video_gpupoor_tpu_torch.pipelines import teacache as tteacache
from ltx_video_gpupoor_tpu_torch.serving import cli as tcli
from ltx_video_gpupoor_tpu_torch.serving import orchestrator as torch_orch

import test_torch_ltx13b as slice13b   # the multi-scale slice's harness
import test_torch_pipeline as slice2b  # the single-scale slice's harness

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0
FP32_TOL = 1e-4
TF_KW = slice2b.TF_KW
weights = slice2b.weights               # module-scoped fixtures
weights13b = slice13b.weights
identity_crf = slice13b.identity_crf


@pytest.fixture(autouse=True)
def _xla_tier(monkeypatch):
    """Both packages in the plain fp32 attention tier."""
    monkeypatch.setattr(jattn, "_FORCED_MODE", "xla")


@pytest.fixture
def masks(monkeypatch):
    """The compute masks the port's pipeline makes, in call order."""
    seen = []
    real = tpipe.ltx_teacache_schedule

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(tpipe, "ltx_teacache_schedule", spy)
    return seen


@pytest.mark.parametrize("multiplier", [1.3, 1.75, 2.2, 3.0])
@pytest.mark.parametrize("start_step", [0, 2])
def test_calibrate_mask_equal_jax(multiplier, start_step):
    rng = np.random.default_rng(int(multiplier * 10) + start_step)
    e = np.cumsum(rng.standard_normal((30, 64)), axis=0).astype(np.float32)
    for coefficients in (None, [2.0, -0.5, 1.0, 0.0]):
        ref = jteacache.calibrate_mask(e, multiplier, coefficients,
                                       start_step)
        out = tteacache.calibrate_mask(e, multiplier, coefficients,
                                       start_step)
        assert out.dtype == ref.dtype == bool
        np.testing.assert_array_equal(out, ref)
    assert out[: start_step + 1].all() and out[-1]
    assert out.sum() < 30


def _port_dit(jparams):
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                 FP32_POLICY)
    model.load_state_dict(from_jax.state_dict(jax.tree.map(np.asarray,
                                                           jparams)))
    return model


@pytest.mark.parametrize("multiplier", [1.75, 2.2])
def test_ltx_teacache_schedule_equal_jax(weights, multiplier):
    jparams = weights[0]
    ts = np.linspace(1.0, 0.05, 30).astype(np.float32)
    ref = jpipe.ltx_teacache_schedule(
        jparams, jtf.LTXTransformerConfig(**TF_KW), ts, multiplier)
    out = tpipe.ltx_teacache_schedule(_port_dit(jparams), ts, multiplier)
    np.testing.assert_array_equal(out, ref)
    assert 1 < out.sum() < 30


@pytest.mark.parametrize("compute", [True, False])
def test_forward_residual_equal_jax(weights, compute):
    """``previous_residual`` / ``compute`` / ``return_residual`` in fp32:
    with ``compute=False`` no block runs and the residual is ``x - x_in``
    of the re-applied one (JAX :529-551)."""
    jparams = weights[0]
    lat, grid, t, cap, mask, skip = _dit_inputs()
    prev = np.random.default_rng(7).standard_normal(
        (3, lat.shape[1], 32)).astype(np.float32)
    ref, ref_res = jtf.forward(
        jparams, jtf.LTXTransformerConfig(**TF_KW),
        *map(jnp.asarray, (lat, grid, t, cap, mask)),
        skip_layer_mask=jnp.asarray(skip),
        skip_layer_strategy=ttf.SkipLayerStrategy.AttentionValues,
        previous_residual=jnp.asarray(prev), compute=compute,
        return_residual=True)
    model = _port_dit(jparams)
    calls = []
    for blk in model.blocks:
        blk.register_forward_hook(lambda *a: calls.append(1))
    out, res = model(*map(torch.from_numpy, (lat, grid, t, cap, mask)),
                     skip_layer_mask=torch.from_numpy(skip),
                     skip_layer_strategy=ttf.SkipLayerStrategy.AttentionValues,
                     previous_residual=torch.from_numpy(prev),
                     compute=compute, return_residual=True)
    assert len(calls) == (2 if compute else 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res),
                               atol=FP32_TOL, rtol=FP32_TOL)
    if not compute:
        np.testing.assert_allclose(res.numpy(), prev, atol=1e-6)


def _dit_inputs(seed=0, b=3, f=2, h=4, w=4, sc=6):
    rng = np.random.default_rng(seed)
    s = f * h * w
    lat = rng.standard_normal((b, s, 16)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                                indexing="ij")).reshape(3, -1)
    grid = np.broadcast_to(grid[None] * np.array([[[8 / 25]], [[32]], [[32]]]),
                           (b, 3, s)).astype(np.float32)
    t = rng.uniform(0.2, 1.0, (b, f)).astype(np.float32)
    cap = rng.standard_normal((b, sc, 32)).astype(np.float32)
    mask = np.ones((b, sc), np.int32)
    mask[0, 4:] = 0
    skip = np.ones((2, b), np.float32)
    skip[1, b - 1] = 0.0
    return lat, grid, t, cap, mask, skip


@pytest.mark.parametrize("output_type", ["latent", "pixels"])
def test_denoise_with_skipped_steps_matches_jax(weights, masks, output_type):
    """``generate(teacache_multiplier=2.2)`` on the single-scale base
    config (CFG + STG, 12 steps): the port's mask skips steps, the
    residual carries across them, and the latents / frames stay >= 40 dB
    from JAX's."""
    tf_p, vcfg, vae_p, t5_p, ids, mask = weights
    cfg = dict(slice2b.CONFIG, num_inference_steps=12)
    h, w, frames = slice2b.H, slice2b.W, slice2b.FRAMES
    emb = jt5.encode(t5_p, jt5.T5Config(**slice2b.T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    jp = slice2b._NoisePipeline(
        transformer_params=tf_p,
        transformer_cfg=jtf.LTXTransformerConfig(**TF_KW),
        vae_params=vae_p, vae_cfg=vcfg)
    f, hl, wl = jp.latent_shape(h, w, frames)
    jp.noise = np.random.default_rng(1).standard_normal(
        (1, f * hl * wl, TF_KW["in_channels"])).astype(np.float32)
    ref = jorch.LTXVideoGenerator(jp, pipeline_config=cfg).generate(
        emb, jnp.asarray(mask), height=h, width=w, frame_num=frames, seed=0,
        output_type=output_type, teacache_multiplier=2.2)

    t5 = tt5.T5Encoder(tt5.T5Config(**slice2b.T5_KW))
    t5.load_state_dict(from_jax.state_dict(jax.tree.map(np.asarray, t5_p)))
    temb = tt5.encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(slice2b.VAE_DICT),
                                FP32_POLICY)
    vae.load_state_dict(from_jax.vae_decoder_state_dict(
        jax.tree.map(np.asarray, vae_p)))
    gen = torch_orch.LTXVideoGenerator(
        tpipe.LTXPipeline(_port_dit(tf_p), vae), pipeline_config=cfg)
    out = gen.generate(temb, torch.from_numpy(mask), height=h, width=w,
                       frame_num=frames, seed=0, output_type=output_type,
                       noise=torch.from_numpy(jp.noise), attn_mode="xla",
                       teacache_multiplier=2.2)
    assert len(masks) == 1 and masks[0].sum() < 12, masks
    ref, out = np.asarray(ref), np.asarray(out)
    assert out.shape == ref.shape
    if output_type == "pixels":
        ref, out = (a.astype(np.float32) / 127.5 - 1 for a in (ref, out))
    db = slice2b._psnr(ref, out)
    assert db >= PSNR_BAR_DB, f"{output_type} {db:.2f} dB"


def test_multiscale_generate_with_skipped_steps_matches_jax(
        weights13b, masks, identity_crf):
    """The 13B distilled multi-scale config (7 + 3 steps, image to
    video) at ``teacache_multiplier=2.0``, threaded into both passes as
    JAX does (:176, :278): latents and frames >= 40 dB."""
    (tf_p, vcfg, vae_p, ucfg, up_p, t5_p, ids, mask, image, n1,
     n2) = weights13b
    h, w, frames = slice13b.H, slice13b.W, slice13b.FRAMES
    emb = jt5.encode(t5_p, jt5.T5Config(**slice13b.T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    pipe = slice13b._RecordingPipeline(
        transformer_params=tf_p,
        transformer_cfg=jtf.LTXTransformerConfig(**slice13b.TF_KW),
        vae_params=vae_p, vae_cfg=vcfg, vae_tile_size=slice13b.TILE)
    ms = slice13b._NoiseMultiScale(pipe, up_p, ucfg)
    slice13b._NoiseMultiScale.noise = (n1, n2)
    ref_frames = np.asarray(jorch.LTXVideoGenerator(
        pipe, multiscale=ms, pipeline_config=slice13b.CONFIG).generate(
        emb, jnp.asarray(mask), height=h, width=w, frame_num=frames, seed=0,
        image_start=image, image_cond_noise_scale=0.0,
        teacache_multiplier=2.0))
    ref_lat = pipe.decoded_latents

    gen, temb = slice13b._port_generator(weights13b, {}, FP32_POLICY)
    seen = {}
    frames_out = gen.generate(
        temb, torch.from_numpy(mask), height=h, width=w, frame_num=frames,
        seed=0, image_start=image, image_cond_noise_scale=0.0,
        noise_pass1=torch.from_numpy(n1), noise_pass2=torch.from_numpy(n2),
        attn_mode="xla", teacache_multiplier=2.0,
        on_stage=lambda name, v: seen.setdefault(name, v))
    assert [len(m) for m in masks] == [7, 3]
    assert masks[0].sum() < 7, masks
    slice13b._compare(ref_lat, ref_frames, seen, frames_out)


def test_cli_demo_teacache_end_to_end(tmp_path, masks):
    out = tmp_path / "tc.mp4"
    path = tcli.main(["--prompt", "a red fox", "--demo", "--device", "cpu",
                      "--height", "64", "--width", "64", "--video-length",
                      "9", "--num-inference-steps", "8", "--teacache", "2.2",
                      "--output-path", str(out)])
    assert path == str(out) and out.stat().st_size > 0
    # the demo's multi-scale config: both passes computed their masks
    assert len(masks) == 2 and all(m[0] and m[-1] for m in masks)
    assert sum(int(m.sum()) for m in masks) < sum(len(m) for m in masks)


def test_skipped_step_launches_no_block(monkeypatch):
    """A step the mask skips calls no block of the DiT (the skip is a
    host-side ``if``): 8 steps, 4 computed, 2 layers -> 8 block calls."""
    model = ttf.init_params(
        ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW), FP32_POLICY),
        torch.Generator().manual_seed(0))
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(slice2b.VAE_DICT),
                                FP32_POLICY)
    calls = []
    for blk in model.blocks:
        blk.register_forward_hook(lambda *a: calls.append(1))
    mask = np.array([1, 0, 1, 0, 0, 1, 0, 1], bool)
    monkeypatch.setattr(tpipe, "ltx_teacache_schedule",
                        lambda *a, **k: mask)
    pipe = tpipe.LTXPipeline(model, vae)
    lat = pipe.generate(torch.zeros(1, 4, 32), torch.ones(1, 4), height=32,
                        width=32, num_frames=9, num_inference_steps=8,
                        guidance_scale=1.0, teacache_multiplier=2.0)
    assert len(calls) == 2 * int(mask.sum())
    assert torch.isfinite(lat).all()
    with pytest.raises(ValueError, match="first"):
        monkeypatch.setattr(tpipe, "ltx_teacache_schedule",
                            lambda *a, **k: ~mask)
        pipe.generate(torch.zeros(1, 4, 32), torch.ones(1, 4), height=32,
                      width=32, num_frames=9, num_inference_steps=8,
                      guidance_scale=1.0, teacache_multiplier=2.0)
