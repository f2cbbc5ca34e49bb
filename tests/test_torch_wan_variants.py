"""The Wan 2.1 variants of the port against the JAX package, on the CPU:
fps conditioning, ReCamMaster (its pose rows, its projector, the source
frames and ``utils/camera.py``), Phantom's reference-image guidance and
the sliding window (overlapped latents, ``return_latent_slice``).

The DiT has dim 256 with 2 heads (head dim 128) and runs in fp32 on both
sides, the exact tier (the port's ``pallas``, K1's plain version on the
CPU, against JAX's ``xla``); weights are JAX's ``init_params`` carried
over with ``core/from_jax.py``, with ReCamMaster's projector drawn away
from its identity start so that it shows. Bars: 100 dB on one forward,
the oracle bar of 40 dB on latents (PARITY.md). The sliding window draws
its noises inside the loop from per-step keys; the test derives the same
keys with JAX's API and hands the draws to the port through
``overlap_noises=``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.ops import rope as jrope
from ltx_video_gpupoor_tpu.pipelines import wan as jpipe
from ltx_video_gpupoor_tpu.utils import camera as jcam
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
from ltx_video_gpupoor_tpu_torch.ops import rope as trope
from ltx_video_gpupoor_tpu_torch.pipelines import wan as tpipe
from ltx_video_gpupoor_tpu_torch.utils import camera as tcam

torch.set_num_threads(2)

FORWARD_DB = 100.0
PSNR_BAR_DB = 40.0
DIT_KW = dict(model_type="t2v", patch_size=(1, 2, 2), text_len=16, in_dim=4,
              dim=256, ffn_dim=512, freq_dim=32, text_dim=32, out_dim=4,
              num_heads=2, num_layers=2)               # head dim 128
Z = 4
STRIDE = (2, 2, 2)
H, W, FRAMES, STEPS = 16, 16, 5, 3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain ops on the calling thread alone (the fresh-thread
    ``torch.exp`` effect of ``tests/test_torch_kernels.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(seed=0, **kw):
    """JAX's ``init_params`` for the config, ReCamMaster's projector
    moved off the identity (a seeded numpy draw)."""
    cfg = jwm.WanConfig(**{**DIT_KW, **kw})
    params = _np_tree(jax.jit(lambda k: jwm.init_params(k, cfg))(
        jax.random.key(seed)))
    if cfg.recammaster:
        rng = np.random.default_rng(seed + 7)
        proj = params["blocks"]["projector"]
        proj["kernel"] = (proj["kernel"] + rng.standard_normal(
            proj["kernel"].shape).astype(np.float32) * 0.05)
    return cfg, params


def _pair(seed=0, **kw):
    cfg, params = _jax_params(seed, **kw)
    model = twm.WanModel(twm.WanConfig(**{**DIT_KW, **kw}), FP32_POLICY)
    model.load_state_dict(from_jax.state_dict(params))
    return cfg, params, model


def _inputs(seed=3, b=2, grid=(2, 6, 6)):
    rng = np.random.default_rng(seed)
    f, h, w = grid
    x = rng.standard_normal((b, f, 2 * h, 2 * w, Z)).astype(np.float32)
    ctx = rng.standard_normal((b, 16, 32)).astype(np.float32)
    mask = np.ones((b, 16), np.int32)
    mask[-1, 9:] = 0
    return x, ctx, mask


def _forward_pair(cfg, params, model, x, t, ctx, mask, grid, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref, ref_res = jwm.forward(params, cfg, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx), jnp.asarray(mask),
                               jrope.wan_rope_freqs(grid, 128),
                               attn_mode="xla", **jkw)
    with torch.no_grad():
        out, res = model(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ctx), torch.from_numpy(mask),
                         trope.wan_rope_freqs(grid, 128), attn_mode="pallas",
                         **tkw)
    return np.asarray(ref), np.asarray(ref_res), out.numpy(), res.numpy()


# --------------------------------------------------------------------------
# fps conditioning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fps_idx", [0, 1])
@pytest.mark.parametrize("per_frame_t", [False, True])
def test_fps_forward_matches_jax(fps_idx, per_frame_t):
    """``inject_sample_info``: the fps row's projection adds to every
    block's modulation; with one timestep a latent frame (diffusion
    forcing's 2-D ``t``) as with one a stream."""
    cfg, params, model = _pair(inject_sample_info=True)
    grid = (3, 6, 6)
    x, ctx, mask = _inputs(grid=grid)
    t = (np.array([[900.0, 500.0, 20.0], [999.0, 310.5, 0.0]], np.float32)
         if per_frame_t else np.array([900.0, 310.5], np.float32))
    ref, ref_res, out, res = _forward_pair(cfg, params, model, x, t, ctx,
                                           mask, grid, fps_idx=fps_idx)
    assert _psnr(ref, out) >= FORWARD_DB and _psnr(ref_res, res) >= FORWARD_DB
    plain, _, _, _ = _forward_pair(cfg, params, model, x, t, ctx, mask, grid)
    assert _psnr(plain, out) < 60           # the fps row moved the output


# --------------------------------------------------------------------------
# ReCamMaster
# --------------------------------------------------------------------------

def test_recammaster_forward_matches_jax():
    """Source frames appended (the grid spans 2F frames), the pose rows of
    F frames tiled over 2F through each block's ``cam_encoder``, the
    projector on the self-attention's output; without poses the
    projector is not applied (a trained projector must not touch plain
    runs), also under the SLG keep mask."""
    cfg, params, model = _pair(recammaster=True)
    grid = (4, 6, 6)                       # F = 2 latent frames + 2 source
    x, ctx, mask = _inputs(grid=grid)
    t = np.array([900.0, 310.5], np.float32)
    cam = np.random.default_rng(5).standard_normal((1, 2, 12)).astype(
        np.float32)
    keep = np.ones((2, 2), np.float32)
    keep[1, 1] = 0.0
    ref, _, out, _ = _forward_pair(cfg, params, model, x, t, ctx, mask, grid,
                                   cam_emb=cam, slg_keep=keep)
    assert _psnr(ref, out) >= FORWARD_DB, f"{_psnr(ref, out):.2f} dB"
    ref0, _, out0, _ = _forward_pair(cfg, params, model, x, t, ctx, mask,
                                     grid)
    assert _psnr(ref0, out0) >= FORWARD_DB
    # with no poses the model is the plain t2v model on the same weights
    plain = twm.WanModel(twm.WanConfig(**DIT_KW), FP32_POLICY)
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if "cam_encoder" not in k
                           and "projector" not in k})
    with torch.no_grad():
        out_plain, _ = plain(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ctx), torch.from_numpy(mask),
                             trope.wan_rope_freqs(grid, 128),
                             attn_mode="pallas")
    np.testing.assert_array_equal(out_plain.numpy(), out0)
    assert _psnr(out0, out) < 60


def test_cam_tiling_and_expand_match_jax():
    """``_encode_cam`` tiles the pose rows (row f of frame f, wrapping
    past F'), broadcast over each frame's tokens; ``expand_cam_to_frames``
    gives the same rows one a frame."""
    cfg, params, model = _pair(recammaster=True)
    cam = np.random.default_rng(6).standard_normal((2, 3, 12)).astype(
        np.float32)
    grid = (5, 2, 3)
    b, l = 2, 5 * 2 * 3
    lp = jax.tree.map(lambda a: a[0], params["blocks"])
    ref = jwm._encode_cam(lp, cfg, jnp.asarray(cam), grid, b, l, jnp.float32)
    with torch.no_grad():
        got = twm._encode_cam(model.blocks[0], model.cfg,
                              torch.from_numpy(cam), grid, b, l,
                              torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(
        twm.expand_cam_to_frames(torch.from_numpy(cam), 5).numpy(),
        np.asarray(jwm.expand_cam_to_frames(jnp.asarray(cam), 5)))
    with pytest.raises(ValueError, match="cover at most"):
        twm.expand_cam_to_frames(torch.from_numpy(cam), 7)


@pytest.mark.parametrize("cam_type", list(range(1, 11)))
def test_camera_embedding_equals_jax(cam_type):
    """The port's copy of ``utils/camera.py`` (and of the packaged
    trajectories) gives JAX's embedding for every preset camera."""
    np.testing.assert_array_equal(
        tcam.get_camera_embedding(cam_type),
        jcam.get_camera_embedding(cam_type))


def test_camera_helpers_equal_jax(tmp_path):
    s = "[1 0 0 0] [0 1 0 0] [0 0 1 0] [3390 1380 240 1] "
    np.testing.assert_array_equal(tcam.parse_matrix(s), jcam.parse_matrix(s))
    rng = np.random.default_rng(1)
    poses = [np.eye(4) + 0.1 * rng.standard_normal((4, 4)) for _ in range(3)]
    np.testing.assert_array_equal(tcam.relative_poses(poses),
                                  jcam.relative_poses(poses))
    assert tcam.PRESET_TRAJECTORIES == jcam.PRESET_TRAJECTORIES
    ext = tcam.generate_preset_extrinsics(21)
    assert ext == jcam.generate_preset_extrinsics(21)
    path = tmp_path / "ext.json"
    path.write_text(json.dumps(ext))
    for cam_type in (3, 10):
        np.testing.assert_array_equal(
            tcam.get_camera_embedding(cam_type, str(path), num_frames=21),
            jcam.get_camera_embedding(cam_type, str(path), num_frames=21))
    assert open(tcam.PACKAGED_EXTRINSICS).read() == \
        open(jcam.PACKAGED_EXTRINSICS).read()


# --------------------------------------------------------------------------
# the pipeline: Phantom, ReCamMaster, the sliding window
# --------------------------------------------------------------------------

def _pipes(**kw):
    cfg, params, model = _pair(**kw)
    jp = jpipe.WanPipeline(model_params=params, model_cfg=cfg,
                           vae_params=None, vae_cfg=None, vae_stride=STRIDE)
    vae = twv.WanVAEDecoder(twv.WanVAEConfig(
        dim=8, z_dim=Z, dim_mult=(1, 2), num_res_blocks=1, attn_scales=(),
        temperal_downsample=(True,)), FP32_POLICY)
    tp = tpipe.WanPipeline(model, vae, vae_stride=STRIDE)
    return jp, tp


def _text(seed=0):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.zeros((2, 16), np.int32)
    mask[0, :11] = 1
    mask[1, :6] = 1
    return ctx, mask


def _latents(seed, frames):
    return np.random.default_rng(seed).standard_normal(
        (1, frames, H // 2, W // 2, Z)).astype(np.float32)


def _denoise_pair(jp, tp, latents, guide_scale=5.0, **kw):
    ctx, mask = _text()
    sig = jp._solve_schedule("unipc", STEPS, 5.0)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = jp.denoise(jnp.asarray(latents), jnp.asarray(ctx),
                     jnp.asarray(mask), sig, guide_scale=guide_scale,
                     attn_mode="xla", cfg_zero_step=0, **jkw)
    got = tp.denoise(torch.from_numpy(latents), torch.from_numpy(ctx),
                     torch.from_numpy(mask), torch.from_numpy(np.asarray(sig)),
                     guide_scale=guide_scale, attn_mode="pallas",
                     cfg_zero_step=0, **tkw)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("guide_scale", [5.0, 1.0])
def test_phantom_denoise_matches_jax(guide_scale):
    """Three guidance streams over the latents with the reference image
    latents appended (text + refs, refs alone, the negative refs), the
    reference frames stripped; at guide scale 1 one stream on the bare
    latents, the references never appended."""
    jp, tp = _pipes()
    lat = _latents(1, 3)
    refs, refs_neg = _latents(2, 1), np.zeros((1, 1, H // 2, W // 2, Z),
                                              np.float32)
    ref, got = _denoise_pair(jp, tp, lat, guide_scale, ref_latents=refs,
                             ref_latents_neg=refs_neg, slg_layers=[1])
    assert got.shape == ref.shape == lat.shape
    assert _psnr(ref, got) >= PSNR_BAR_DB, f"{_psnr(ref, got):.2f} dB"
    if guide_scale == 1.0:
        bare, _ = _denoise_pair(jp, tp, lat, guide_scale)
        np.testing.assert_allclose(got, bare, atol=1e-5)


def test_recammaster_denoise_matches_jax():
    """The source video's latents appended along frames in every stream
    (RoPE over 2F frames), the preset trajectory's pose rows of F
    frames."""
    jp, tp = _pipes(recammaster=True)
    lat, src = _latents(1, 3), _latents(3, 3)
    cam = tcam.get_camera_embedding(4, num_frames=9)[None]
    assert cam.shape == (1, 3, 12)
    ref, got = _denoise_pair(jp, tp, lat, source_latents=src, cam_emb=cam)
    assert _psnr(ref, got) >= PSNR_BAR_DB, f"{_psnr(ref, got):.2f} dB"


def _loop_noises(key, steps, over_shape, vace_shape=None):
    """The sliding window's per-step draws as JAX makes them: (x noise,
    VACE context noise or None) from ``split(split(key, steps)[i])``."""
    out = []
    for k in jax.random.split(key, steps):
        k_x, k_vace = jax.random.split(k)
        xn = np.asarray(jax.random.normal(k_x, over_shape, jnp.float32))
        vn = (None if vace_shape is None else np.asarray(
            jax.random.normal(k_vace, vace_shape, jnp.float32)))
        out.append((torch.from_numpy(xn),
                    None if vn is None else torch.from_numpy(vn)))
    return out


def test_sliding_window_generate_t2v_matches_jax():
    """A continuation: the previous window's last latents (the boundary
    frame included) replace the first frames at every step, noised to
    its level, and come back clean at the end; ``return_latent_slice``
    hands back the tail for the next window."""
    jp, tp = _pipes()
    ctx, mask = _text()
    over = _latents(4, 2)
    noise = _latents(5, 3)
    key = jax.random.key(9)
    kw = dict(width=W, height=H, frame_num=FRAMES, sampling_steps=STEPS,
              guide_scale=5.0, cfg_zero_step=0, return_latent_slice=slice(-2,
                                                                          None))
    ref = jp.generate_t2v(jnp.asarray(ctx), jnp.asarray(mask), key=key,
                          noise=jnp.asarray(noise), attn_mode="xla",
                          overlapped_latents=jnp.asarray(over), **kw)
    _, k_loop = jax.random.split(key)
    got = tp.generate_t2v(torch.from_numpy(ctx), torch.from_numpy(mask),
                          noise=torch.from_numpy(noise), attn_mode="pallas",
                          overlapped_latents=torch.from_numpy(over),
                          overlap_noises=_loop_noises(k_loop, STEPS,
                                                      over.shape), **kw)
    assert set(got) == {"x", "latent_slice"}
    lat, tail = got["x"].numpy(), got["latent_slice"].numpy()
    np.testing.assert_array_equal(lat[:, :2], over)
    assert tail.shape == (1, 2, H // 2, W // 2, Z)
    assert _psnr(np.asarray(ref["x"]), lat) >= PSNR_BAR_DB
    assert _psnr(np.asarray(ref["latent_slice"]), tail) >= PSNR_BAR_DB
    # drawn from a generator instead, the window runs and restores too
    out = tp.generate_t2v(torch.from_numpy(ctx), torch.from_numpy(mask),
                          noise=torch.from_numpy(noise), attn_mode="pallas",
                          overlapped_latents=torch.from_numpy(over),
                          generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(out["x"].numpy()[:, :2], over)


def test_variant_modules_attach_to_a_built_model_as_the_constructor_builds():
    """``add_variant_modules`` on a plain t2v model gives the parameter
    names, shapes and dtypes that ``WanModel`` builds for the variant
    config, and ``init_params`` over what it returns draws JAX's starting
    values for them (the projector the identity, the hint projections
    zero)."""
    import dataclasses

    cfg = twm.WanConfig(**DIT_KW, vace_layers=(0, 1), vace_in_dim=8,
                        recammaster=True, inject_sample_info=True)
    built = twm.WanModel(cfg, FP32_POLICY)
    plain = twm.WanModel(dataclasses.replace(
        cfg, vace_layers=None, vace_in_dim=None, recammaster=False,
        inject_sample_info=False), FP32_POLICY)
    base = sum(p.numel() for p in plain.parameters())
    new = twm.init_params(twm.add_variant_modules(
        plain, cfg, dtype=FP32_POLICY.param_dtype), torch.Generator())
    assert plain.cfg == cfg
    assert all(blk.cfg == cfg for blk in plain.blocks)

    def shapes(m):
        return {k: (tuple(v.shape), v.dtype) for k, v in
                m.state_dict().items()}

    assert shapes(plain) == shapes(built)
    assert len(new.cams) == cfg.num_layers
    # what it returns holds every new parameter once (the VACE blocks'
    # cameras inside the blocks)
    assert sum(p.numel() for p in new.parameters()) == sum(
        p.numel() for p in built.parameters()) - base
    for blk in plain.blocks:
        assert torch.equal(blk.projector.weight, torch.eye(cfg.dim))
    for blk in plain.vace_blocks:
        assert not blk.after_proj.weight.any()
    assert not plain.vace_blocks[0].before_proj.weight.any()
    # a second call adds nothing
    again = twm.add_variant_modules(plain, cfg)
    assert not list(again.parameters())
