"""The Wan 2.1 t2v slice of the port against the JAX package, on the CPU.

Each module and then the whole ``WanPipeline.generate_t2v`` (a UMT5
encode, UniPC with CFG + CFG-Zero-star + SLG, pixels out) run at tiny
widths on both sides, from the same weights (core/from_jax.py), the same
token ids and the same initial noise (``noise=``). The DiT has dim 256
with 2 heads, so its head dim is 128: the port's ``auto`` attention
resolves to the int8 QK+PV tier (K4), which is held against the JAX
package's ``pallas_int8pv`` Pallas kernel run in interpret mode (the
test patches ``ltx_video_gpupoor_tpu.ops.attention.flash_attention`` with
``interpret=True`` and 128 blocks, as tests/test_flash_attention.py runs
it; no JAX file changes). The exact tier is held against JAX's ``xla``
path. Bars: the repo's oracle bar (PARITY.md), >= 40 dB PSNR on latents
and frames; 1e-5 absolute for the fp32 modules without int8 math.

Every slice runs the CFG-Zero-star alpha rescale from step 1
(``cfg_zero_step=0``; the default 5 would skip it at 3 steps). The exact
tier runs at guide scales 2 and 5 (the pipeline's default). The int8
programs' final latents are held at guide scale 2: two int8 programs
differ where a 1-ulp difference upstream rounds one int8 activation code
the other way, and at this tiny width with random weights the sampler
amplifies such a difference the more, the larger the guide scale. At
guide scale 5 the int8 programs are held step by step instead: each
DiT call of the port's sampling run (both CFG streams, SLG) is replayed
through the JAX forward on the same inputs, and the velocities agree to
the same 40 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.ops import rope as jrope
from ltx_video_gpupoor_tpu.pipelines import wan as jpipe
from ltx_video_gpupoor_tpu.schedulers import flowmatch as jfm
from ltx_video_gpupoor_tpu.schedulers import unipc as junipc
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
from ltx_video_gpupoor_tpu_torch.ops import rope as trope
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch.pipelines import wan as tpipe
from ltx_video_gpupoor_tpu_torch.schedulers import flowmatch as tfm
from ltx_video_gpupoor_tpu_torch.schedulers import unipc as tunipc

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0
ATOL = 1e-5

T5_KW = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
             num_layers=2, shared_pos=False)           # a UMT5
DIT_KW = dict(model_type="t2v", patch_size=(1, 2, 2), text_len=16, in_dim=4,
              dim=256, ffn_dim=512, freq_dim=32, text_dim=32, out_dim=4,
              num_heads=2, num_layers=2)               # head dim 128
VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              attn_scales=(), temperal_downsample=(True,))
STRIDE = (2, 2, 2)
H, W, FRAMES, STEPS = 16, 16, 5, 3
SLG = dict(slg_layers=[1], slg_start=0.0, slg_end=0.5, cfg_zero_step=0)


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's attention dispatch reaches the Pallas kernel in interpret
    mode with 128 blocks (a test-side patch)."""
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True, block_q=128, block_kv=128))


@functools.cache
def _vae_params(seed, **cfg_kw):
    """A Wan VAE parameter tree in the layout of the JAX ``init_params``
    (its shapes, traced without compiling it), drawn with numpy: conv
    kernels N(0, 1/fan_in), biases N(0, 0.1^2), gammas 1 + N(0, 0.1^2).
    Unlike the JAX init, the attention projections and biases are
    nonzero, so every block shows in the output."""
    cfg = jwv.WanVAEConfig(**cfg_kw)
    shapes = jax.eval_shape(lambda k: jwv.init_params(k, cfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        return (x * np.float32(0.1)
                + np.float32(1.0 if name == "gamma" else 0.0))

    return jax.tree_util.tree_map_with_path(draw, shapes)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid,riflex", [((3, 4, 5), False),
                                         ((21, 6, 4), True)])
def test_wan_rope_matches_jax(grid, riflex):
    jc, js = jrope.wan_rope_freqs(grid, 128, enable_riflex=riflex)
    tc, ts = trope.wan_rope_freqs(grid, 128, enable_riflex=riflex)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    assert trope.default_rope_dims(128) == jrope.default_rope_dims(128)
    assert trope.identify_k(10000.0, 44, 21) == jrope.identify_k(
        10000.0, 44, 21)
    half = (trope.full_to_half(tc), trope.full_to_half(ts))
    x = np.random.default_rng(0).standard_normal(
        (2, tc.shape[0], 3, 128)).astype(np.float32)
    ref = jrope.apply_rotary_emb_shared_heads(
        jnp.asarray(x), *(jnp.asarray(t.numpy())[None, :, None]
                          for t in half))
    out = trope.apply_rotary_emb_shared_heads(
        torch.from_numpy(x), *(t[None, :, None] for t in half))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("steps,shift", [(3, 5.0), (6, 3.0)])
def test_unipc_and_euler_match_jax(steps, shift):
    js = junipc.unipc_sigmas(steps, shift=shift)
    ts = tunipc.unipc_sigmas(steps, shift=shift)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    jstate, tstate = junipc.unipc_init(x.shape), tunipc.unipc_init(x.shape)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        jstate, jx = junipc.unipc_step(jstate, jnp.asarray(v), jx, i, js,
                                       steps)
        tstate, tx = tunipc.unipc_step(tstate, torch.from_numpy(v), tx, i, ts,
                                       steps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=1e-5)
    jf = jfm.make_flowmatch_schedule(steps, shift=shift)
    tf_ = tfm.make_flowmatch_schedule(steps, shift=shift)
    np.testing.assert_array_equal(tf_.sigmas.numpy(), np.asarray(jf.sigmas))
    np.testing.assert_array_equal(tf_.timesteps.numpy(),
                                  np.asarray(jf.timesteps))


VAE8_KW = dict(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
               attn_scales=(), temperal_downsample=(False, False, True))


@pytest.mark.parametrize("tile", [0, 64])
def test_wan_vae_decode_matches_jax(tile):
    """fp32 decoder, untiled and spatially tiled (tile 64 px = 8 latents:
    a 2 x 2 grid with crossfades), against the JAX decode (jitted)."""
    cfg = jwv.WanVAEConfig(**VAE8_KW)
    params = _vae_params(3, **VAE8_KW)
    z = np.random.default_rng(2).standard_normal(
        (1, 2, 10, 12, 4)).astype(np.float32)
    vae = twv.WanVAEDecoder(twv.WanVAEConfig(**VAE8_KW), FP32_POLICY)
    vae.load_state_dict(from_jax.wan_vae_decoder_state_dict(_np_tree(params)))
    if tile:
        ref = jwv.spatial_tiled_decode(params, cfg, jnp.asarray(z),
                                       tile_size=tile)
        out = twv.spatial_tiled_decode(vae, torch.from_numpy(z),
                                       tile_size=tile)
    else:
        ref = jwv._tile_decode(params, cfg, jnp.asarray(z))
        out = twv.decode(vae, torch.from_numpy(z))
    assert tuple(out.shape) == ref.shape == (1, 3, 80, 96, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert twv.get_vae_tile_size(0, 16000) == jwv.get_vae_tile_size(0, 16000)
    assert twv._decoder_structure(twv.WanVAEConfig()) == \
        jwv._decoder_structure(jwv.WanVAEConfig())


@functools.cache
def _dit_params(key=0):
    return jax.jit(lambda k: jwm.init_params(k, jwm.WanConfig(**DIT_KW)))(
        jax.random.key(key))


def _dit(policy=FP32_POLICY, quant=False, key=0):
    jp = _dit_params(key)
    if quant:
        jp = jq.quantize_params(jp, mode="dynamic")
    model = twm.WanModel(twm.WanConfig(**DIT_KW), policy)
    if quant:
        quantize_params(model, mode="dynamic")
    model.load_state_dict(from_jax.state_dict(_np_tree(jp)))
    return jp, model


def _dit_inputs(seed=3, b=2, grid=(2, 6, 6)):
    rng = np.random.default_rng(seed)
    f, h, w = grid
    x = rng.standard_normal((b, f, 2 * h, 2 * w, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 16, 32)).astype(np.float32)
    mask = np.ones((b, 16), np.int32)
    mask[-1, 9:] = 0
    t = np.array([900.0, 310.5][:b], np.float32)
    keep = np.ones((2, b), np.float32)
    keep[1, -1] = 0.0                      # SLG: skip layer 1, last stream
    return x, t, ctx, mask, grid, keep


@pytest.mark.parametrize("jax_mode,port_mode,quant,bar_db", [
    ("xla", "pallas", False, 100.0),        # exact tier, K1's plain version
    ("pallas_int8pv", "auto", True, 50.0),  # K4 (head dim 128), int8_dynamic
])
def test_wan_dit_forward_matches_jax(pallas_interpret, jax_mode, port_mode,
                                     quant, bar_db):
    """One forward with text padding and an SLG-skipped layer. The int8
    program's bar is lower: an int8 code may round the other way."""
    jp, model = _dit(quant=quant)
    x, t, ctx, mask, grid, keep = _dit_inputs()
    freqs = jrope.wan_rope_freqs(grid, 128)
    ref, ref_res = jwm.forward(jp, jwm.WanConfig(**DIT_KW), jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx),
                               jnp.asarray(mask), freqs,
                               slg_keep=jnp.asarray(keep), attn_mode=jax_mode)
    with torch.no_grad():
        out, res = model(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ctx), torch.from_numpy(mask),
                         trope.wan_rope_freqs(grid, 128),
                         slg_keep=torch.from_numpy(keep), attn_mode=port_mode)
    assert out.shape == ref.shape == x.shape
    assert _psnr(ref, out) >= bar_db, f"{_psnr(ref, out):.2f} dB"
    assert _psnr(ref_res, res) >= bar_db, f"{_psnr(ref_res, res):.2f} dB"


def test_wan_dit_rejects_unported_branches():
    """What this test once refused is ported and held to JAX here: a
    VACE context and an fps index reach only a model built with
    ``vace_layers`` / ``inject_sample_info`` (a plain t2v model ignores
    them, as JAX's does: the same output on both sides;
    tests/test_torch_wan_vace.py and tests/test_torch_wan_variants.py hold
    those models), CLIP features reach only an i2v model, TeaCache's
    ``compute=False`` adds the given residual to the input tokens, and an
    i2v model holds JAX's i2v parameters (tests/test_torch_wan_i2v.py
    holds its forward)."""
    jp, model = _dit()
    x, t, ctx, mask, grid, _ = _dit_inputs(b=1)
    args = [torch.from_numpy(a) for a in (x, t, ctx, mask)]
    freqs = trope.wan_rope_freqs(grid, 128)
    jargs = (jp, jwm.WanConfig(**DIT_KW), *map(jnp.asarray, (x, t, ctx, mask)),
             jrope.wan_rope_freqs(grid, 128))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the fresh-thread exp of test_torch_kernels
    vctx = np.ones((1, 2, 12, 12, 4), np.float32)
    for kw in (dict(vace_context=vctx), dict(fps_idx=0)):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        with torch.no_grad():
            out, _ = model(*args, freqs, attn_mode="pallas", **tkw)
            bare, _ = model(*args, freqs, attn_mode="pallas")
        ref, _ = jwm.forward(*jargs, attn_mode="xla", **jkw)
        assert torch.equal(out, bare)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    with torch.no_grad():
        plain, res = model(*args, freqs, attn_mode="pallas")
        with_clip, _ = model(*args, freqs, attn_mode="pallas",
                             clip_features=torch.ones(1, 257, 1280))
        skip, skip_res = model(*args, freqs, previous_residual=res,
                               compute=False)
    torch.set_num_threads(threads)
    assert torch.equal(plain, with_clip)
    ref, _ = jwm.forward(*jargs, previous_residual=jnp.asarray(res.numpy()),
                         compute=False)
    np.testing.assert_allclose(skip.numpy(), np.asarray(ref), atol=ATOL)
    assert torch.equal(skip_res, res)
    i2v = {**DIT_KW, "model_type": "i2v", "in_dim": 12}
    want = from_jax.state_dict(_np_tree(jax.jit(
        lambda k: jwm.init_params(k, jwm.WanConfig(**i2v)))(
            jax.random.key(0))))
    got = twm.WanModel(twm.WanConfig(**i2v)).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# --------------------------------------------------------------------------
# the slice: UMT5 encode, then generate_t2v
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    dit = _dit_params(0)
    vae = _vae_params(1, **VAE_KW)
    t5 = jt5.init_params(jax.random.key(2), jt5.T5Config(**T5_KW))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = np.zeros((2, 16), np.int32)
    mask[0, :11] = 1                        # the prompt
    mask[1, :6] = 1                         # the negative prompt
    return dit, vae, t5, ids, mask


@pytest.fixture(scope="module")
def jax_results(weights):
    """The JAX package's latents and frames per attention tier and guide
    scale, computed once: {("xla", 2.0): (latents, frames), ...}."""
    return {}


def _noise(pipe_shape):
    return np.random.default_rng(1).standard_normal(
        (1, *pipe_shape, VAE_KW["z_dim"])).astype(np.float32)


def _jax_slice(weights, jax_results, mode, guide_scale):
    if (mode, guide_scale) in jax_results:
        return jax_results[mode, guide_scale]
    dit, vae_p, t5_p, ids, mask = weights
    if mode != "xla":
        dit = jq.quantize_params(dit, mode="dynamic")
    emb = jt5.encode(t5_p, jt5.T5Config(**T5_KW), jnp.asarray(ids),
                     jnp.asarray(mask))
    pipe = jpipe.WanPipeline(
        model_params=dit, model_cfg=jwm.WanConfig(**DIT_KW),
        vae_params=vae_p, vae_cfg=jwv.WanVAEConfig(**VAE_KW),
        vae_stride=STRIDE)
    noise = _noise(pipe.latent_shape(H, W, FRAMES))
    lat = pipe.generate_t2v(emb, jnp.asarray(mask), width=W, height=H,
                            frame_num=FRAMES, sampling_steps=STEPS,
                            noise=jnp.asarray(noise), attn_mode=mode,
                            guide_scale=guide_scale, **SLG)
    frames = pipe._vae_decode(lat)
    jax_results[mode, guide_scale] = (np.asarray(lat), np.asarray(frames))
    return jax_results[mode, guide_scale]


def _port_pipe(weights, policy, quant):
    dit, vae_p, t5_p, ids, mask = weights
    t5 = tt5.T5Encoder(tt5.T5Config(**T5_KW), dtype=policy.param_dtype)
    t5.load_state_dict(from_jax.state_dict(_np_tree(t5_p)))
    emb = tt5.encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    model = twm.WanModel(twm.WanConfig(**DIT_KW), policy)
    if quant:
        quantize_params(model, mode="dynamic")
        dit = jq.quantize_params(dit, mode="dynamic")
    model.load_state_dict(from_jax.state_dict(_np_tree(dit)))
    vae = twv.WanVAEDecoder(twv.WanVAEConfig(**VAE_KW), policy)
    vae.load_state_dict(from_jax.wan_vae_decoder_state_dict(_np_tree(vae_p)))
    pipe = tpipe.WanPipeline(model, vae, vae_stride=STRIDE)
    noise = torch.from_numpy(_noise(pipe.latent_shape(H, W, FRAMES)))
    return pipe, emb, torch.from_numpy(mask), noise


def _port_slice(weights, mode, policy, quant, guide_scale):
    pipe, emb, mask, noise = _port_pipe(weights, policy, quant)
    kw = dict(width=W, height=H, frame_num=FRAMES, sampling_steps=STEPS,
              noise=noise, attn_mode=mode, guide_scale=guide_scale, **SLG)
    lat = pipe.generate_t2v(emb, mask, **kw)
    frames = pipe.generate_t2v(emb, mask, output_type="pixels", **kw)
    return lat.numpy(), frames.float().numpy()


@pytest.mark.parametrize("jax_mode,port_mode,policy,quant,guide_scale", [
    ("xla", "pallas", FP32_POLICY, False, 2.0),          # exact tier
    ("pallas_int8pv", "auto", FP32_POLICY, True, 2.0),   # K4 + K2
    ("pallas_int8pv", "auto", DEFAULT_POLICY, True, 2.0),  # the card's
    ("xla", "pallas", FP32_POLICY, False, 5.0),          # the default scale
], ids=["exact", "int8pv", "bf16_policy", "exact_guide5"])
def test_slice_t2v_matches_jax(pallas_interpret, weights, jax_results,
                               jax_mode, port_mode, policy, quant,
                               guide_scale):
    ref_lat, ref_frames = _jax_slice(weights, jax_results, jax_mode,
                                     guide_scale)
    lat, frames = _port_slice(weights, port_mode, policy, quant, guide_scale)
    assert lat.shape == ref_lat.shape == (1, 3, 8, 8, 4)
    assert frames.shape == ref_frames.shape == (1, FRAMES, H, W, 3)
    assert np.isfinite(lat).all() and np.isfinite(frames).all()
    assert _psnr(ref_lat, lat) >= PSNR_BAR_DB, \
        f"latents {_psnr(ref_lat, lat):.2f} dB"
    assert _psnr(ref_frames, frames) >= PSNR_BAR_DB, \
        f"frames {_psnr(ref_frames, frames):.2f} dB"


@pytest.mark.parametrize("policy", [FP32_POLICY, DEFAULT_POLICY],
                         ids=["int8pv", "bf16_policy"])
def test_slice_int8_velocities_match_jax_at_guide5(pallas_interpret,
                                                   weights, policy):
    """The int8 programs at the default guide scale 5, step by step:
    every DiT call of the port's sampling run is replayed through the
    JAX forward (``pallas_int8pv`` in interpret mode) on the same
    latents, timesteps, text and SLG mask."""
    pipe, emb, mask, noise = _port_pipe(weights, policy, quant=True)
    calls, forward = [], pipe.model.forward

    def record(x, t, context, context_mask, freqs, **kw):
        out = forward(x, t, context, context_mask, freqs, **kw)
        calls.append((x, t, context, context_mask, kw["slg_keep"], out[0]))
        return out

    pipe.model.forward = record
    lat = pipe.generate_t2v(emb, mask, width=W, height=H, frame_num=FRAMES,
                            sampling_steps=STEPS, noise=noise,
                            guide_scale=5.0, **SLG)
    assert np.isfinite(lat.numpy()).all() and len(calls) == STEPS
    jp = jq.quantize_params(weights[0], mode="dynamic")
    cfg = jwm.WanConfig(**DIT_KW)
    for i, (x, t, ctx, cmask, keep, out) in enumerate(calls):
        # two CFG streams; SLG skips a layer of the uncond one at step 0
        assert x.shape[0] == 2 and float(keep.min()) == float(i > 0)
        grid = (x.shape[1], x.shape[2] // 2, x.shape[3] // 2)
        ref, _ = jwm.forward(jp, cfg, *(jnp.asarray(a.float().numpy())
                                        for a in (x, t, ctx)),
                             jnp.asarray(cmask.numpy()),
                             jrope.wan_rope_freqs(grid, 128),
                             slg_keep=jnp.asarray(keep.numpy()),
                             attn_mode="pallas_int8pv")
        db = _psnr(ref, out.float().numpy())
        assert db >= PSNR_BAR_DB, f"step {i}: velocity {db:.2f} dB"


def test_pipeline_helpers_match_jax(weights):
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        float(tpipe.optimized_scale(torch.from_numpy(a), torch.from_numpy(b))),
        float(jpipe.optimized_scale(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    _, model = _dit()
    vae = twv.WanVAEDecoder(twv.WanVAEConfig(**VAE_KW), FP32_POLICY)
    tp = tpipe.WanPipeline(model, vae, vae_stride=STRIDE)
    jp = jpipe.WanPipeline(model_params=None, model_cfg=None, vae_params=None,
                           vae_cfg=None, vae_stride=STRIDE)
    assert tp.latent_shape(480, 832, 81) == jp.latent_shape(480, 832, 81)
    for solver in ("unipc", "euler", "dpm++"):
        np.testing.assert_array_equal(
            tp._solve_schedule(solver, 4, 5.0).numpy(),
            np.asarray(jp._solve_schedule(solver, 4, 5.0)))
    # TeaCache's schedule (once refused here): JAX's mask from the same
    # time embedding (tests/test_torch_wan_i2v.py holds the slice)
    timesteps = tp._solve_schedule("unipc", 12, 5.0)[:-1].numpy() * 1000
    np.testing.assert_array_equal(
        tpipe.teacache_skip_schedule(
            model, timesteps, tpipe.TEACACHE_COEFFICIENTS["t2v_1.3B"], 1.5),
        jpipe.teacache_skip_schedule(
            _dit_params(0), jwm.WanConfig(**DIT_KW), timesteps,
            jpipe.TEACACHE_COEFFICIENTS["t2v_1.3B"], 1.5))
    # Phantom's reference latents, ReCamMaster's source latents, a VACE
    # context (which a model without hint blocks ignores) and a sliding
    # window's overlapped latents, each held to JAX's generate_t2v with the
    # same arguments (the window's per-step noises drawn from JAX's keys)
    from test_torch_wan_variants import _loop_noises

    rng = np.random.default_rng(7)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    noise = rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    key = jax.random.key(2)
    _, k_loop = jax.random.split(key)
    over = rng.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    for kw in (dict(ref_latents=rng.standard_normal((1, 1, 8, 8, 4))),
               dict(source_latents=rng.standard_normal((1, 3, 8, 8, 4))),
               dict(vace_context=rng.standard_normal((1, 3, 8, 8, 12))),
               dict(overlapped_latents=over)):
        kw = {k: v.astype(np.float32) for k, v in kw.items()}
        if "ref_latents" in kw:
            kw["ref_latents_neg"] = np.zeros_like(kw["ref_latents"])
        gen = dict(width=16, height=16, frame_num=5, sampling_steps=2)
        jp_full = jpipe.WanPipeline(
            model_params=_dit_params(0), model_cfg=jwm.WanConfig(**DIT_KW),
            vae_params=None, vae_cfg=None, vae_stride=STRIDE)
        ref = jp_full.generate_t2v(
            jnp.asarray(ctx), jnp.asarray(mask), noise=jnp.asarray(noise),
            key=key, attn_mode="xla", **gen,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        extra = ({"overlap_noises": _loop_noises(k_loop, 2, over.shape)}
                 if "overlapped_latents" in kw else {})
        got = tp.generate_t2v(
            torch.from_numpy(ctx), torch.from_numpy(mask),
            noise=torch.from_numpy(noise), attn_mode="pallas", **gen,
            **{k: torch.from_numpy(v) for k, v in kw.items()}, **extra)
        assert _psnr(np.asarray(ref), got.numpy()) >= PSNR_BAR_DB, kw.keys()
    # the sequence-parallel route (ported): on a one-rank mesh it is the
    # unsharded run bit for bit (tests/test_torch_usp.py holds it at 2)
    from torch_mesh_workers import OneRankMesh

    ctx, mask = torch.zeros(2, 16, 32), torch.ones(2, 16)
    run = dict(width=16, height=16, frame_num=5, sampling_steps=2,
               noise=torch.from_numpy(noise), attn_mode="pallas")
    want = tp.generate_t2v(ctx, mask, **run)
    tp.sp_mesh = OneRankMesh()
    assert torch.equal(tp.generate_t2v(ctx, mask, **run), want)
