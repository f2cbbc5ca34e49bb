"""Wan 2.1 image-to-video, DPM++, TeaCache and the Wan loaders of the port
against the JAX package, on the CPU.

As ``tests/test_torch_wan.py``: tiny widths (the DiT has dim 256 with 2
heads, head dim 128, so the port's ``auto`` attention is the int8 QK+PV
tier, held against JAX's ``pallas_int8pv`` Pallas kernel run in interpret
mode by a test-side patch; the exact tier against JAX's ``xla``), the
same numpy weights on both sides (core/from_jax.py), the same token ids,
initial noise (``noise=``) and CLIP features. Bars: >= 40 dB PSNR on
latents and frames (PARITY.md), 1e-5 for the fp32 modules and the
schedulers. The Wan VAE encoder runs in fp32, whole clip and a few frames
at a time a layer (the same function).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.wan import clip as jclip
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.ops import rope as jrope
from ltx_video_gpupoor_tpu.pipelines import wan as jpipe
from ltx_video_gpupoor_tpu.schedulers import dpm as jdpm
from ltx_video_gpupoor_tpu.serving import model_zoo as jzoo
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.wan import clip as tclip
from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
from ltx_video_gpupoor_tpu_torch.ops import rope as trope
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch.pipelines import wan as tpipe
from ltx_video_gpupoor_tpu_torch.schedulers import dpm as tdpm
from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as syn

from test_torch_wan import (DIT_KW, FRAMES, H, SLG, STRIDE, T5_KW, VAE8_KW,
                            VAE_KW, W, _np_tree, _psnr, _vae_params,
                            pallas_interpret, weights)  # noqa: F401

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0
ATOL = 1e-5


@pytest.fixture
def one_thread():
    """The 1e-5 checks run their plain ops on the calling thread alone:
    the first ``torch.exp`` of a freshly started intra-op worker thread can
    come out about 4e-5 relative off on that thread's share (the effect
    ``tests/test_torch_kernels.py::_one_intra_op_thread`` describes; it
    showed here in the encoder's SiLU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
I2V_KW = {**DIT_KW, "model_type": "i2v",
          "in_dim": VAE_KW["z_dim"] + STRIDE[0] + VAE_KW["z_dim"]}
N_CLIP = 257                         # CLIP tokens: the class + 16 x 16


# --------------------------------------------------------------------------
# DPM++
# --------------------------------------------------------------------------

@pytest.mark.parametrize("steps,shift", [(4, 5.0), (7, 3.0)])
def test_dpm_matches_jax_step_by_step(steps, shift):
    js = jdpm.dpm_sigmas_from_custom(jdpm.get_sampling_sigmas(steps, shift))
    ts = tdpm.dpm_sigmas_from_custom(tdpm.get_sampling_sigmas(steps, shift))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    jstate, tstate = jdpm.dpm_init(x.shape), tdpm.dpm_init(x.shape)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        jstate, jx = jdpm.dpm_step(jstate, jnp.asarray(v), jx, i, js, steps)
        tstate, tx = tdpm.dpm_step(tstate, torch.from_numpy(v), tx, i, ts,
                                   steps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=ATOL)
        assert tstate.lower_order_nums == int(jstate.lower_order_nums)


# --------------------------------------------------------------------------
# the Wan VAE encoder
# --------------------------------------------------------------------------

ENC_KW = {**VAE8_KW, "attn_scales": (1.0,)}     # an attention block too


def _enc_vae():
    params = _vae_params(5, **ENC_KW)
    vae = twv.WanVAE(twv.WanVAEConfig(**ENC_KW), FP32_POLICY)
    vae.load_state_dict(from_jax.state_dict(_np_tree(params)))
    return params, vae


@pytest.mark.parametrize("frames,end,chunk", [(9, False, None), (9, False, 2),
                                              (10, True, 3)],
                         ids=["whole", "chunked", "any_end_frame"])
def test_wan_vae_encode_matches_jax(one_thread, monkeypatch, frames, end,
                                    chunk):
    """fp32 encode, normalized, against JAX's jitted ``encode``; the
    frame chunks inside each layer compute the same function."""
    monkeypatch.setattr(twv, "ENCODE_CHUNK_FRAMES", chunk)
    params, vae = _enc_vae()
    video = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 40, 48, 3)).astype(np.float32)
    ref = jwv.encode(params, jwv.WanVAEConfig(**ENC_KW), jnp.asarray(video),
                     any_end_frame=end)
    out = twv.encode(vae, torch.from_numpy(video), any_end_frame=end)
    assert tuple(out.shape) == ref.shape == (1, 5 + end, 5, 6, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert twv._encoder_structure(twv.WanVAEConfig()) == \
        jwv._encoder_structure(jwv.WanVAEConfig())


def test_wan_vae_spatial_tiled_encode_matches_jax(one_thread):
    params, vae = _enc_vae()
    video = np.random.default_rng(3).uniform(
        -1, 1, (1, 5, 80, 96, 3)).astype(np.float32)
    ref = jwv.spatial_tiled_encode(params, jwv.WanVAEConfig(**ENC_KW),
                                   jnp.asarray(video), tile_size=64)
    out = twv.spatial_tiled_encode(vae, torch.from_numpy(video),
                                   tile_size=64)
    assert tuple(out.shape) == ref.shape == (1, 3, 10, 12, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# --------------------------------------------------------------------------
# the i2v DiT and TeaCache's skip
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def i2v_params():
    return jax.jit(lambda k: jwm.init_params(k, jwm.WanConfig(**I2V_KW)))(
        jax.random.key(7))


def _i2v_model(jp, policy=FP32_POLICY, mode=None):
    if mode is not None:
        jp = jq.quantize_params(jp, mode=mode)
    model = twm.WanModel(twm.WanConfig(**I2V_KW), policy)
    if mode is not None:
        quantize_params(model, mode=mode)
    model.load_state_dict(from_jax.state_dict(_np_tree(jp)))
    return jp, model


def _clip_features(seed=11):
    return np.random.default_rng(seed).standard_normal(
        (1, N_CLIP, twm.CLIP_DIM)).astype(np.float32)


@pytest.mark.parametrize("jax_mode,port_mode,bar_db", [
    ("xla", "pallas", 100.0), ("pallas_int8pv", "auto", 50.0)])
def test_i2v_forward_matches_jax(one_thread, pallas_interpret, i2v_params,
                                 jax_mode, port_mode, bar_db):
    """One forward of the i2v DiT: the image branch of the
    cross-attention (257 CLIP tokens through ``img_emb``), text padding,
    an SLG-skipped layer; then TeaCache's ``compute=False``, which adds
    the residual it is given to the input tokens."""
    jp, model = _i2v_model(i2v_params)
    rng = np.random.default_rng(3)
    grid = (2, 6, 6)
    x = rng.standard_normal((2, 2, 12, 12, I2V_KW["in_dim"])).astype(
        np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    t = np.array([900.0, 310.5], np.float32)
    keep = np.ones((2, 2), np.float32)
    keep[1, 1] = 0.0
    clip = np.concatenate([_clip_features()] * 2)
    ref, ref_res = jwm.forward(
        jp, jwm.WanConfig(**I2V_KW), *map(jnp.asarray, (x, t, ctx, mask)),
        jrope.wan_rope_freqs(grid, 128), clip_features=jnp.asarray(clip),
        slg_keep=jnp.asarray(keep), attn_mode=jax_mode)
    freqs = trope.wan_rope_freqs(grid, 128)
    args = [torch.from_numpy(a) for a in (x, t, ctx, mask)]
    with torch.no_grad():
        out, res = model(*args, freqs, clip_features=torch.from_numpy(clip),
                         slg_keep=torch.from_numpy(keep), attn_mode=port_mode)
    assert out.shape == ref.shape and res.shape == ref_res.shape
    assert _psnr(ref, out) >= bar_db, f"{_psnr(ref, out):.2f} dB"
    assert _psnr(ref_res, res) >= bar_db, f"{_psnr(ref_res, res):.2f} dB"
    prev = np.asarray(ref_res)
    skip_ref, skip_res = jwm.forward(
        jp, jwm.WanConfig(**I2V_KW), *map(jnp.asarray, (x, t, ctx, mask)),
        jrope.wan_rope_freqs(grid, 128), previous_residual=jnp.asarray(prev),
        compute=False)
    with torch.no_grad():
        skip, sres = model(*args, freqs, previous_residual=torch.from_numpy(
            prev.copy()), compute=False)
    np.testing.assert_allclose(skip.numpy(), np.asarray(skip_ref), atol=ATOL)
    np.testing.assert_array_equal(sres.numpy(), prev)


def test_wan_dit_i2v_weights_and_remaining_raises(i2v_params):
    _, model = _i2v_model(i2v_params)
    names = set(model.state_dict())
    assert {"img_emb.fc1.weight", "img_emb.norm_out.bias",
            "blocks.1.cross_attn.k_img.weight",
            "blocks.0.cross_attn.norm_k_img.weight"} <= names
    args = [torch.zeros(1, 1, 4, 4, I2V_KW["in_dim"]), torch.zeros(1),
            torch.zeros(1, 16, 32), torch.ones(1, 16)]
    freqs = trope.wan_rope_freqs((1, 2, 2), 128)
    with pytest.raises(ValueError, match="previous_residual"):
        model(*args, freqs, compute=False)
    # a VACE context, an fps index and camera poses reach only a model
    # built for them: an i2v model ignores them on both sides
    jp, _ = _i2v_model(i2v_params)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 1, 4, 4, I2V_KW["in_dim"])).astype(
        np.float32)
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32)
    targs = [torch.from_numpy(x), torch.full((1,), 500.0),
             torch.from_numpy(ctx), torch.ones(1, 16)]
    jargs = (jp, jwm.WanConfig(**I2V_KW), jnp.asarray(x),
             jnp.full((1,), 500.0), jnp.asarray(ctx), jnp.ones((1, 16)),
             jrope.wan_rope_freqs((1, 2, 2), 128))
    with torch.no_grad():
        bare, _ = model(*targs, freqs, attn_mode="pallas")
    for kw in (dict(vace_context=np.ones((1, 1, 4, 4, 4), np.float32)),
               dict(fps_idx=0),
               dict(cam_emb=np.ones((1, 1, 12), np.float32))):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        with torch.no_grad():
            out, _ = model(*targs, freqs, attn_mode="pallas", **tkw)
        ref, _ = jwm.forward(*jargs, attn_mode="xla", **jkw)
        assert torch.equal(out, bare)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# --------------------------------------------------------------------------
# the slice: generate_i2v
# --------------------------------------------------------------------------

def _frame(seed=5):
    return np.random.default_rng(seed).uniform(
        -1, 1, (H, W, 3)).astype(np.float32)


def _i2v_noise():
    f = (FRAMES - 1) // STRIDE[0] + 1
    return np.random.default_rng(1).standard_normal(
        (1, f, H // STRIDE[1], W // STRIDE[2], VAE_KW["z_dim"])).astype(
            np.float32)


def _jax_i2v(weights, i2v_params, mode, jax_mode, last=False, **kw):
    _, vae_p, t5_p, ids, mask = weights
    dit = i2v_params if mode is None else jq.quantize_params(i2v_params,
                                                             mode=mode)
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    pipe = jpipe.WanPipeline(
        model_params=dit, model_cfg=jwm.WanConfig(**I2V_KW),
        vae_params=vae_p, vae_cfg=jwv.WanVAEConfig(**VAE_KW),
        vae_stride=STRIDE)
    lat = pipe.generate_i2v(
        emb, jnp.asarray(mask), jnp.asarray(_clip_features()),
        jnp.asarray(_frame()), width=W, height=H, frame_num=FRAMES,
        sampling_steps=3, noise=jnp.asarray(_i2v_noise()),
        attn_mode=jax_mode, guide_scale=2.0,
        last_frame=jnp.asarray(_frame(6)) if last else None, **SLG, **kw)
    return np.asarray(lat), np.asarray(pipe._vae_decode(lat))


def _port_i2v_pipe(weights, i2v_params, mode, policy):
    _, vae_p, t5_p, ids, mask = weights
    t5 = tt5.T5Encoder(tt5.T5Config(**T5_KW), dtype=policy.param_dtype)
    t5.load_state_dict(from_jax.state_dict(_np_tree(t5_p)))
    emb = tt5.encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    _, model = _i2v_model(i2v_params, policy, mode)
    vae = twv.WanVAE(twv.WanVAEConfig(**VAE_KW), policy)
    vae.load_state_dict(from_jax.state_dict(_np_tree(vae_p)))
    return tpipe.WanPipeline(model, vae, vae_stride=STRIDE), emb, \
        torch.from_numpy(mask)


def _port_i2v(weights, i2v_params, mode, port_mode, policy, last=False,
              **kw):
    pipe, emb, mask = _port_i2v_pipe(weights, i2v_params, mode, policy)
    args = dict(width=W, height=H, frame_num=FRAMES, sampling_steps=3,
                noise=torch.from_numpy(_i2v_noise()), attn_mode=port_mode,
                guide_scale=2.0,
                last_frame=torch.from_numpy(_frame(6)) if last else None,
                **SLG, **kw)
    clip, frame = torch.from_numpy(_clip_features()), torch.from_numpy(
        _frame())
    lat = pipe.generate_i2v(emb, mask, clip, frame, **args)
    frames = pipe.generate_i2v(emb, mask, clip, frame, output_type="pixels",
                               **args)
    return lat.numpy(), frames.float().numpy()


@pytest.mark.parametrize("mode,jax_mode,port_mode,policy,last", [
    (None, "xla", "pallas", FP32_POLICY, False),             # exact tier
    ("dynamic", "pallas_int8pv", "auto", FP32_POLICY, True),  # the default
    ("mixed_int4", "xla", "pallas", FP32_POLICY, False),     # weight-only
], ids=["exact", "default_last_frame", "mixed_int4"])
def test_generate_i2v_matches_jax(pallas_interpret, weights, i2v_params,
                                  mode, jax_mode, port_mode, policy, last):
    ref_lat, ref_frames = _jax_i2v(weights, i2v_params, mode, jax_mode, last)
    lat, frames = _port_i2v(weights, i2v_params, mode, port_mode, policy,
                            last)
    assert lat.shape == ref_lat.shape == _i2v_noise().shape
    assert frames.shape == ref_frames.shape == (1, FRAMES, H, W, 3)
    assert np.isfinite(lat).all() and np.isfinite(frames).all()
    assert _psnr(ref_lat, lat) >= PSNR_BAR_DB, \
        f"latents {_psnr(ref_lat, lat):.2f} dB"
    assert _psnr(ref_frames, frames) >= PSNR_BAR_DB, \
        f"frames {_psnr(ref_frames, frames):.2f} dB"


def test_prepare_i2v_conditioning_matches_jax(one_thread, weights):
    _, vae_p, *_ = weights
    jp = jpipe.WanPipeline(model_params=None, model_cfg=None,
                           vae_params=vae_p,
                           vae_cfg=jwv.WanVAEConfig(**VAE_KW),
                           vae_stride=STRIDE)
    vae = twv.WanVAE(twv.WanVAEConfig(**VAE_KW), FP32_POLICY)
    vae.load_state_dict(from_jax.state_dict(_np_tree(vae_p)))
    tp = tpipe.WanPipeline(twm.WanModel(twm.WanConfig(**I2V_KW),
                                        FP32_POLICY), vae, vae_stride=STRIDE)
    for last in (None, _frame(6)):
        ref = jp.prepare_i2v_conditioning(
            jnp.asarray(_frame()), H, W, FRAMES,
            None if last is None else jnp.asarray(last))
        out = tp.prepare_i2v_conditioning(
            torch.from_numpy(_frame()), H, W, FRAMES,
            None if last is None else torch.from_numpy(last))
        assert tuple(out.shape) == ref.shape == (1, 3, 8, 8, 6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    decoder_only = tpipe.WanPipeline(tp.model, twv.WanVAEDecoder(
        twv.WanVAEConfig(**VAE_KW), FP32_POLICY), vae_stride=STRIDE)
    with pytest.raises(ValueError, match="encoder"):
        decoder_only.prepare_i2v_conditioning(torch.zeros(H, W, 3), H, W,
                                              FRAMES)


# --------------------------------------------------------------------------
# generate_t2v with DPM++ and with TeaCache
# --------------------------------------------------------------------------

def _t2v_pair(weights, steps, **kw):
    """JAX's and the port's ``generate_t2v`` in the exact tier (fp32)."""
    from test_torch_wan import _port_pipe

    dit, vae_p, t5_p, ids, mask = weights
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    jp = jpipe.WanPipeline(model_params=dit, model_cfg=jwm.WanConfig(**DIT_KW),
                           vae_params=vae_p, vae_cfg=jwv.WanVAEConfig(**VAE_KW),
                           vae_stride=STRIDE)
    tp, temb, tmask, noise = _port_pipe(weights, FP32_POLICY, quant=False)
    args = dict(width=W, height=H, frame_num=FRAMES, sampling_steps=steps,
                guide_scale=2.0, **SLG, **kw)
    ref = jp.generate_t2v(emb, jnp.asarray(mask), noise=jnp.asarray(
        noise.numpy()), attn_mode="xla", **args)
    lat = tp.generate_t2v(temb, tmask, noise=noise, attn_mode="pallas",
                          **args)
    frames = (np.asarray(jp._vae_decode(ref)),
              tp.generate_t2v(temb, tmask, noise=noise, attn_mode="pallas",
                              output_type="pixels", **args).numpy())
    return (np.asarray(ref), lat.numpy()), frames, jp, tp


def test_generate_t2v_with_dpm_matches_jax(weights):
    (ref, lat), (ref_f, frames), jp, tp = _t2v_pair(weights, 4,
                                                    solver="dpm++")
    np.testing.assert_array_equal(
        tp._solve_schedule("dpm++", 4, 5.0).numpy(),
        np.asarray(jp._solve_schedule("dpm++", 4, 5.0)))
    assert _psnr(ref, lat) >= PSNR_BAR_DB, f"{_psnr(ref, lat):.2f} dB"
    assert _psnr(ref_f, frames) >= PSNR_BAR_DB, f"{_psnr(ref_f, frames):.2f}"


def test_generate_t2v_with_teacache_matches_jax(weights, monkeypatch):
    """TeaCache 2.0 over 8 steps with the t2v_1.3B coefficients: the same
    skip mask as JAX's (the model's own time embedding), some steps
    skipped, and the result at the oracle bar."""
    masks = {}
    for mod, key in ((jpipe, "jax"), (tpipe, "port")):
        fn = mod.teacache_skip_schedule
        monkeypatch.setattr(mod, "teacache_skip_schedule",
                            lambda *a, _fn=fn, _k=key, **k:
                            masks.setdefault(_k, _fn(*a, **k)))
    (ref, lat), (ref_f, frames), _, tp = _t2v_pair(
        weights, 8, teacache_multiplier=2.0, teacache_model="t2v_1.3B")
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    assert masks["port"][0] and 0 < int((~masks["port"]).sum()) < 8
    assert _psnr(ref, lat) >= PSNR_BAR_DB, f"{_psnr(ref, lat):.2f} dB"
    assert _psnr(ref_f, frames) >= PSNR_BAR_DB, f"{_psnr(ref_f, frames):.2f}"
    assert tpipe.TEACACHE_COEFFICIENTS == jpipe.TEACACHE_COEFFICIENTS


# --------------------------------------------------------------------------
# the loaders
# --------------------------------------------------------------------------

LOAD_SPEC = {"model_type": "i2v", "dim": 256, "ffn_dim": 512, "freq_dim": 32,
             "num_heads": 2, "num_layers": 2, "in_dim": 36,
             "vae_stride": (4, 8, 8)}
LOAD_VAE = dict(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                attn_scales=(), temperal_downsample=(False, True, True))
LOAD_CLIP = dict(image_size=28, patch_size=14, dim=160, num_heads=2,
                 num_layers=2)


def test_load_wan_model_matches_jax_loader(tmp_path):
    """Synthetic files in the published layout (the i2v DiT with quanto
    int8 block linears, the VAE with its encoder, the CLIP tower under
    ``visual.``), read by the JAX loader and by the port's on the CPU: the
    same weights, key for key (bf16 values in fp32 modules)."""
    tcfg = twm.WanConfig(model_type="i2v", dim=256, ffn_dim=512, freq_dim=32,
                         num_heads=2, num_layers=2, in_dim=36)
    info = syn.write_wan_ckpt_dir(str(tmp_path), tcfg,
                                  twv.WanVAEConfig(**LOAD_VAE),
                                  tclip.CLIPVisionConfig(**LOAD_CLIP))
    names = (syn.WAN_I2V_FILE, syn.WAN_VAE_FILE, syn.WAN_CLIP_FILE)
    assert all(info["bytes"][n] > 0 for n in names)
    kw = dict(ckpt_dir=str(tmp_path), vae_filename=syn.WAN_VAE_FILE,
              clip_filename=syn.WAN_CLIP_FILE, spec=LOAD_SPEC)
    jp = jzoo.load_wan_model(syn.WAN_I2V_FILE, "i2v-14B",
                             vae_cfg=jwv.WanVAEConfig(**LOAD_VAE),
                             clip_cfg=jclip.CLIPVisionConfig(**LOAD_CLIP),
                             **kw)
    tp = tzoo.load_wan_model(syn.WAN_I2V_FILE, "i2v-14B",
                             vae_cfg=twv.WanVAEConfig(**LOAD_VAE),
                             clip_cfg=tclip.CLIPVisionConfig(**LOAD_CLIP),
                             device="cpu", policy=FP32_POLICY, **kw)
    assert dataclasses.asdict(tp.model.cfg) == dataclasses.asdict(
        jp.model_cfg)
    for module, tree in ((tp.model, jp.model_params), (tp.vae, jp.vae_params),
                         (tp.clip, jp.clip_params)):
        want = {k: v.float() for k, v in
                from_jax.state_dict(_np_tree(tree)).items()}
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v.reshape(got[k].shape),
                                       atol=0, rtol=0, msg=k)
    assert tp.load_stats["transformer_reader"] in ("native mmap", "python")
    with pytest.raises(FileNotFoundError, match="CLIP"):
        tzoo.load_wan_model(syn.WAN_I2V_FILE, "i2v-14B", device="cpu",
                            vae_cfg=twv.WanVAEConfig(**LOAD_VAE),
                            **{**kw, "clip_filename": "missing.safetensors"})
