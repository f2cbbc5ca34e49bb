"""VACE in the port against the JAX package, on the CPU: the hint blocks
of the DiT (``vace_blocks``, ``before_proj`` / ``after_proj``,
``vace_patch_embedding``), the hints under the SLG keep mask,
``utils/vace.py`` function by function, and ``generate_t2v`` with a VACE
context, alone and as a sliding window's continuation whose context is
re-noised at the overlap-noise floor every step.

The DiT has dim 256 with 2 heads (head dim 128) and hint blocks at layers
0 and 2 of 3; JAX's ``init_params`` starts ``before_proj`` and
``after_proj`` at zero, so the test draws them (seeded numpy) to make the
hints show. Exact tier in fp32 on both sides (the port's ``pallas``
against JAX's ``xla``) at 100 dB for one forward; the int8 QK+PV tier
(K4, ``auto`` at head dim 128) with the dynamic int8 linears (K2) against
JAX's ``pallas_int8pv`` kernel run in interpret mode (a test-side patch),
at 50 dB, as ``tests/test_torch_wan.py`` holds the plain DiT; 40 dB on
latents. The VAE is the tiny Wan VAE of ``tests/test_torch_wan.py`` with
its encoder, at stride (2, 2, 2): the context has 2 x 4 latent and 4 mask
channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.ops import rope as jrope
from ltx_video_gpupoor_tpu.pipelines import wan as jpipe
from ltx_video_gpupoor_tpu.utils import vace as jvace
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
from ltx_video_gpupoor_tpu_torch.ops import rope as trope
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch.pipelines import wan as tpipe
from ltx_video_gpupoor_tpu_torch.utils import vace as tvace
from test_torch_wan import VAE_KW, _vae_params
from test_torch_wan_variants import (_loop_noises, _np_tree, _psnr, _text,
                                     DIT_KW, H, STEPS, STRIDE, W, Z)

torch.set_num_threads(2)

FORWARD_DB = 100.0
INT8_DB = 50.0
PSNR_BAR_DB = 40.0
VACE_IN = 2 * Z + STRIDE[1] * STRIDE[2]         # 12
VACE_KW = dict(DIT_KW, num_layers=3, vace_layers=(0, 2), vace_in_dim=VACE_IN)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True, block_q=128, block_kv=128))


@functools.cache
def _vace_params(seed=0):
    cfg = jwm.WanConfig(**VACE_KW)
    params = _np_tree(jax.jit(lambda k: jwm.init_params(k, cfg))(
        jax.random.key(seed)))
    rng = np.random.default_rng(seed + 11)
    for i, vb in enumerate(params["vace_blocks"]):
        for name in ("after_proj", "before_proj"):
            if name in vb:
                vb[name]["kernel"] = (rng.standard_normal(
                    vb[name]["kernel"].shape) * 0.05).astype(np.float32)
    return cfg, params


def _pair(quant=False):
    cfg, params = _vace_params()
    if quant:
        params = _np_tree(jq.quantize_params(params, mode="dynamic"))
    model = twm.WanModel(twm.WanConfig(**VACE_KW), FP32_POLICY)
    if quant:
        quantize_params(model, mode="dynamic")
    model.load_state_dict(from_jax.state_dict(params))
    return cfg, params, model


def _inputs(seed=3, grid=(2, 6, 6)):
    rng = np.random.default_rng(seed)
    f, h, w = grid
    x = rng.standard_normal((2, f, 2 * h, 2 * w, Z)).astype(np.float32)
    vctx = rng.standard_normal((2, f, 2 * h, 2 * w, VACE_IN)).astype(
        np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[-1, 9:] = 0
    t = np.array([900.0, 310.5], np.float32)
    return x, vctx, t, ctx, mask, grid


def _forward(cfg, params, model, x, vctx, t, ctx, mask, grid, jmode, tmode,
             scale=1.0, keep=None):
    ref, ref_res = jwm.forward(
        params, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(mask), jrope.wan_rope_freqs(grid, 128),
        vace_context=None if vctx is None else jnp.asarray(vctx),
        vace_scale=scale,
        slg_keep=None if keep is None else jnp.asarray(keep),
        attn_mode=jmode)
    with torch.no_grad():
        out, res = model(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(mask), trope.wan_rope_freqs(grid, 128),
            vace_context=None if vctx is None else torch.from_numpy(vctx),
            vace_scale=scale,
            slg_keep=None if keep is None else torch.from_numpy(keep),
            attn_mode=tmode)
    return (np.asarray(ref), np.asarray(ref_res), out.numpy(), res.numpy())


@pytest.mark.parametrize("jmode,tmode,quant,bar", [
    ("xla", "pallas", False, FORWARD_DB),
    ("pallas_int8pv", "auto", True, INT8_DB),
], ids=["exact", "int8pv"])
def test_vace_forward_matches_jax(pallas_interpret, jmode, tmode, quant, bar):
    """The hint stream: the embedded context through ``before_proj``
    plus the tokens at the first hint layer, each hint block's output
    through ``after_proj`` times ``vace_scale`` added after its layer."""
    cfg, params, model = _pair(quant)
    x, vctx, t, ctx, mask, grid = _inputs()
    ref, ref_res, out, res = _forward(cfg, params, model, x, vctx, t, ctx,
                                      mask, grid, jmode, tmode, scale=0.7)
    assert _psnr(ref, out) >= bar, f"{_psnr(ref, out):.2f} dB"
    assert _psnr(ref_res, res) >= bar
    bare = _forward(cfg, params, model, x, None, t, ctx, mask, grid, jmode,
                    tmode)[2]
    assert _psnr(bare, out) < 60            # the hints moved the output


def test_vace_hints_respect_slg_keep():
    """A stream that SLG skips at a hint layer skips the whole block,
    hint included (JAX's ``tests/test_wan_model.py:212``), on both
    sides."""
    cfg, params, model = _pair()
    x, vctx, t, ctx, mask, grid = _inputs()
    keep = np.ones((3, 2), np.float32)
    keep[2, 1] = 0.0                       # layer 2 (a hint layer), stream 1
    ref, _, out, _ = _forward(cfg, params, model, x, vctx, t, ctx, mask,
                              grid, "xla", "pallas", keep=keep)
    assert _psnr(ref, out) >= FORWARD_DB, f"{_psnr(ref, out):.2f} dB"
    full = _forward(cfg, params, model, x, vctx, t, ctx, mask, grid, "xla",
                    "pallas")[2]
    np.testing.assert_array_equal(out[0], full[0])   # stream 0 runs all
    assert _psnr(full[1], out[1]) < 60


def test_vace_weights_match_jax_layout():
    cfg, params, model = _pair()
    want = from_jax.state_dict(params)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert "vace_blocks.0.before_proj.weight" in got
    assert "vace_blocks.1.before_proj.weight" not in got
    assert "vace_blocks.1.cross_attn.k_img.weight" not in got


# --------------------------------------------------------------------------
# utils/vace.py
# --------------------------------------------------------------------------

def test_resize_crop_equals_jax():
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (3, 37, 53, 3)).astype(np.uint8)
    for oh, ow in ((16, 24), (40, 40)):
        np.testing.assert_array_equal(tvace.resize_crop(video, oh, ow),
                                      jvace.resize_crop(video, oh, ow))
    masks = rng.uniform(0, 1, (2, 20, 30, 1)).astype(np.float32)
    out = tvace.resize_crop(masks, 16, 16)
    assert out.shape == (2, 16, 16, 1)
    np.testing.assert_array_equal(out, jvace.resize_crop(masks, 16, 16))


@pytest.mark.parametrize("keep_last", [True, False])
def test_video_processor_equals_jax(keep_last):
    tp = tvace.VaceVideoProcessor(keep_last=keep_last)
    jp = jvace.VaceVideoProcessor(keep_last=keep_last)
    for fps, n, mx, start in ((30.0, 120, 0, 0), (24.0, 81, 49, 3),
                              (12.0, 40, 0, 0), (60.0, 300, 81, 0)):
        assert tp.select_frames(fps, n, mx, start) == \
            jp.select_frames(fps, n, mx, start)
    for h, w, n in ((480, 832, 81), (1080, 1920, 81), (720, 1280, 121),
                    (240, 320, 17)):
        assert tp.budget_dimensions(h, w, n) == jp.budget_dimensions(h, w, n)


@functools.cache
def _vae_pair():
    params = _vae_params(1, **VAE_KW)
    vae = twv.WanVAE(twv.WanVAEConfig(**VAE_KW), FP32_POLICY)
    vae.load_state_dict(from_jax.state_dict(_np_tree(params)))
    return params, vae


def _media(seed=0, frames=5):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (1, frames, H, W, 3)).astype(np.float32)
    masks = np.zeros((1, frames, H, W, 1), np.float32)
    masks[:, 1:-1, 4:12, 2:14] = 1.0         # the middle frames' centre
    ref = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    return video, masks, ref


@pytest.mark.parametrize("with_masks,with_ref", [(True, True), (False, False),
                                                 (True, False)])
def test_vace_encode_frames_matches_jax(with_masks, with_ref):
    params, vae = _vae_pair()
    video, masks, ref = _media()
    jref = jvace.vace_encode_frames(
        params, jwv.WanVAEConfig(**VAE_KW), jnp.asarray(video),
        [jnp.asarray(ref)] if with_ref else None,
        jnp.asarray(masks) if with_masks else None)
    got = tvace.vace_encode_frames(
        vae, torch.from_numpy(video),
        [torch.from_numpy(ref)] if with_ref else None,
        torch.from_numpy(masks) if with_masks else None)
    assert tuple(got.shape) == jref.shape == (1, 3 + with_ref, 8, 8, 2 * Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=1e-5)


@pytest.mark.parametrize("frames,hw,num_refs", [(5, (16, 16), 1),
                                                (9, (20, 18), 0),
                                                (17, (64, 48), 2)])
def test_vace_encode_masks_and_latent_match_jax(frames, hw, num_refs):
    rng = np.random.default_rng(frames)
    masks = (rng.uniform(0, 1, (1, frames, *hw, 1)) > 0.5).astype(np.float32)
    for stride in ((4, 8, 8), STRIDE):
        ref = jvace.vace_encode_masks(jnp.asarray(masks), stride, num_refs)
        got = tvace.vace_encode_masks(torch.from_numpy(masks), stride,
                                      num_refs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    z = rng.standard_normal(ref.shape[:-1] + (2 * Z,)).astype(np.float32)
    np.testing.assert_array_equal(
        tvace.vace_latent(torch.from_numpy(z), got).numpy(),
        np.asarray(jvace.vace_latent(jnp.asarray(z), ref)))


# --------------------------------------------------------------------------
# generate_t2v with a VACE context
# --------------------------------------------------------------------------

def _context():
    """A VACE context from the tiny VAE: a control video whose middle
    frames a mask hides, and one reference image, as JAX builds it."""
    params, vae = _vae_pair()
    video, masks, ref = _media(1)
    z = jvace.vace_encode_frames(params, jwv.WanVAEConfig(**VAE_KW),
                                 jnp.asarray(video), [jnp.asarray(ref)],
                                 jnp.asarray(masks))
    m = jvace.vace_encode_masks(jnp.asarray(masks), STRIDE, num_refs=1)
    return np.asarray(jvace.vace_latent(z, m))


def _pipes():
    cfg, params, model = _pair()
    jp = jpipe.WanPipeline(model_params=params, model_cfg=cfg,
                           vae_params=None, vae_cfg=None, vae_stride=STRIDE)
    tp = tpipe.WanPipeline(model, twv.WanVAEDecoder(
        twv.WanVAEConfig(**VAE_KW), FP32_POLICY), vae_stride=STRIDE)
    return jp, tp


@pytest.mark.parametrize("overlap_noise", [None, 0.0, 150.0],
                         ids=["vace", "window", "window_renoised"])
def test_generate_t2v_with_vace_context_matches_jax(overlap_noise):
    """The context has one reference frame before the video's three
    latent frames, so the request has four; as a sliding window the first
    two latent frames are the previous window's, and with
    ``overlap_noise`` the context's matching frames and latent channels
    are re-noised from their clean values every step (JAX's per-step keys
    derived here and handed over)."""
    jp, tp = _pipes()
    ctx, mask = _text()
    vctx = _context()
    assert vctx.shape == (1, 4, 8, 8, VACE_IN)
    frames = 4 * STRIDE[0] - STRIDE[0] + 1    # 4 latent frames
    noise = np.random.default_rng(5).standard_normal(
        (1, 4, H // 2, W // 2, Z)).astype(np.float32)
    key = jax.random.key(4)
    kw = dict(width=W, height=H, frame_num=frames, sampling_steps=STEPS,
              guide_scale=5.0, cfg_zero_step=0, vace_scale=0.8)
    extra_j, extra_t = {}, {}
    if overlap_noise is not None:
        over = np.random.default_rng(6).standard_normal(
            (1, 2, H // 2, W // 2, Z)).astype(np.float32)
        _, k_loop = jax.random.split(key)
        extra_j = dict(overlapped_latents=jnp.asarray(over),
                       overlap_noise=overlap_noise)
        extra_t = dict(overlapped_latents=torch.from_numpy(over),
                       overlap_noise=overlap_noise,
                       overlap_noises=_loop_noises(
                           k_loop, STEPS, over.shape,
                           (1, 2, 8, 8, Z) if overlap_noise else None))
    ref = jp.generate_t2v(jnp.asarray(ctx), jnp.asarray(mask), key=key,
                          noise=jnp.asarray(noise), attn_mode="xla",
                          vace_context=jnp.asarray(vctx), **kw, **extra_j)
    got = tp.generate_t2v(torch.from_numpy(ctx), torch.from_numpy(mask),
                          noise=torch.from_numpy(noise), attn_mode="pallas",
                          vace_context=torch.from_numpy(vctx), **kw,
                          **extra_t)
    assert got.shape == ref.shape == noise.shape
    db = _psnr(np.asarray(ref), got.numpy())
    assert db >= PSNR_BAR_DB, f"{db:.2f} dB"
