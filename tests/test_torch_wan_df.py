"""SkyReels-V2 diffusion forcing in the port against the JAX package, on
the CPU: ``snap_frame_num``, ``generate_timestep_matrix`` (the port's own
numpy copy, equal to JAX's over the grid of JAX's
``tests/test_wan_df.py`` and more), and ``WanDFPipeline.generate``
without and with a prefix video (through the Wan VAE encoder) and the
``overlap_noise`` floor, latents and decoded frames.

The DiT is the fps-conditioned one of ``tests/test_torch_wan_variants.py``
(dim 256, 2 heads of 128, fp32, the port's exact tier against JAX's
``xla``); the VAE is the tiny Wan VAE with its encoder at stride (2, 2,
2). The prefix noise is drawn inside JAX's loop from per-row keys; the
test derives the same keys with JAX's API and hands the draws over
(``prefix_noises=``). Bars: the oracle's 40 dB on latents and frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.wan import vae as jwv
from ltx_video_gpupoor_tpu.pipelines import wan_df as jdf
from ltx_video_gpupoor_tpu_torch.pipelines import wan_df as tdf
from test_torch_wan import VAE_KW
from test_torch_wan_vace import _vae_pair
from test_torch_wan_variants import _pair, _psnr, _text

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0
STRIDE = (2, 2, 2)
H = W = 16
FRAMES, STEPS = 17, 3                 # 9 latent frames at stride 2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_snap_frame_num_equals_jax():
    for n in (1, 5, 17, 26, 27, 30, 37, 96, 97, 121, 257):
        assert tdf.snap_frame_num(n) == jdf.snap_frame_num(n)


@pytest.mark.parametrize("frames,steps,ar,pre,block,base", [
    (8, 4, 2, 0, 1, 8), (10, 5, 3, 2, 2, 10), (6, 3, 0, 0, 1, 6),
    (25, 4, 1, 5, 5, 25), (25, 4, 5, 0, 5, 15), (9, 3, 1, 0, 3, 9),
    (30, 10, 5, 10, 5, 20)])
def test_timestep_matrix_equals_jax(frames, steps, ar, pre, block, base):
    template = np.linspace(999, 1, steps).astype(np.int64)
    if ar == 0:
        block = 1
    got = tdf.generate_timestep_matrix(frames, template, base, ar, pre,
                                       block)
    ref = jdf.generate_timestep_matrix(frames, template, base, ar, pre,
                                       block)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3]


def _pipes(tile=None):
    cfg, params, model = _pair(inject_sample_info=True)
    vparams, vae = _vae_pair()
    jp = jdf.WanDFPipeline(model_params=params, model_cfg=cfg,
                           vae_params=vparams,
                           vae_cfg=jwv.WanVAEConfig(**VAE_KW),
                           vae_stride=STRIDE, vae_tile_size=tile)
    tp = tdf.WanDFPipeline(model, vae, vae_stride=STRIDE, vae_tile_size=tile)
    return jp, tp


def _noise(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (1, 9, H // 2, W // 2, 4)).astype(np.float32)


@pytest.mark.parametrize("ar_step,block,guide_scale,fps", [
    (1, 1, 2.0, 24), (1, 3, 5.0, 16), (0, 1, 1.0, 24)])
def test_df_generate_matches_jax(ar_step, block, guide_scale, fps):
    """Staggered per-frame timesteps (the DiT's 2-D ``t``), one UniPC
    state a frame stepped where the row's update mask is set, the fps
    row; a frame a row leaves alone keeps its latents bit for bit."""
    jp, tp = _pipes()
    ctx, mask = _text()
    noise = _noise()
    kw = dict(height=H, width=W, frame_num=FRAMES, sampling_steps=STEPS,
              ar_step=ar_step, causal_block_size=block,
              guide_scale=guide_scale, fps=fps)
    ref = jp.generate(jnp.asarray(ctx), jnp.asarray(mask),
                      noise=jnp.asarray(noise), attn_mode="xla", **kw)
    seen, fwd = [], tp.model.forward

    def record(x, t, *args, **k):
        seen.append((x[0].clone(), t[0].clone()))
        return fwd(x, t, *args, **k)

    tp.model.forward = record
    got = tp.generate(torch.from_numpy(ctx), torch.from_numpy(mask),
                      noise=torch.from_numpy(noise), attn_mode="pallas",
                      **kw)
    assert got.shape == ref.shape == noise.shape
    db = _psnr(np.asarray(ref), got.numpy())
    assert db >= PSNR_BAR_DB, f"{db:.2f} dB"
    # the rows' update masks, as the pipeline makes them
    sig = np.asarray(jax.numpy.asarray(
        jdf.junipc.unipc_sigmas(STEPS, shift=1.0)))
    _, _, um, _ = tdf.generate_timestep_matrix(
        9, (sig[:-1] * 1000).astype(np.int64), 9, ar_step,
        0, block if ar_step else 1)
    assert len(seen) == um.shape[0]
    seen.append((got[0], None))
    for row in range(um.shape[0]):
        before, after = seen[row][0], seen[row + 1][0]
        for f in np.nonzero(~um[row])[0]:
            assert torch.equal(before[f], after[f]), (row, f)


@pytest.mark.parametrize("overlap_noise,tile", [(20, None), (0, None),
                                                (20, 8)])
def test_df_generate_with_prefix_matches_jax(overlap_noise, tile):
    """A continuation: a 5-frame prefix video through the VAE encoder
    (3 latent frames, cut to the causal block), its frames done from the
    first row; with ``overlap_noise`` the DiT sees them noised at that
    floor and timestep. Frames decoded, untiled and tiled."""
    jp, tp = _pipes(tile)
    ctx, mask = _text()
    noise = _noise(2)
    prefix = np.random.default_rng(3).uniform(
        -1, 1, (1, 5, H, W, 3)).astype(np.float32)
    key = jax.random.key(7)
    kw = dict(height=H, width=W, frame_num=FRAMES, sampling_steps=STEPS,
              ar_step=1, causal_block_size=1, guide_scale=2.0,
              overlap_noise=overlap_noise, output_type="pixels")
    ref = jp.generate(jnp.asarray(ctx), jnp.asarray(mask), key=key,
                      noise=jnp.asarray(noise), attn_mode="xla",
                      prefix_video=jnp.asarray(prefix), **kw)
    prefix_lat = np.asarray(jwv._tile_encode(
        jp.vae_params, jp.vae_cfg, jnp.asarray(prefix)))
    sig = np.asarray(jdf.junipc.unipc_sigmas(STEPS, shift=1.0))
    sm, _, _, _ = jdf.generate_timestep_matrix(
        9, (sig[:-1] * 1000).astype(np.int64), 9, 1, prefix_lat.shape[1], 1)
    _, k_loop = jax.random.split(key)
    draws = [torch.from_numpy(np.asarray(jax.random.normal(
        k, noise.shape, jnp.float32)))
        for k in jax.random.split(k_loop, sm.shape[0])]
    got = tp.generate(torch.from_numpy(ctx), torch.from_numpy(mask),
                      noise=torch.from_numpy(noise), attn_mode="pallas",
                      prefix_video=torch.from_numpy(prefix),
                      prefix_noises=draws, **kw)
    assert got.shape == ref.shape == (1, FRAMES, H, W, 3)
    db = _psnr(np.asarray(ref), got.float().numpy())
    assert db >= PSNR_BAR_DB, f"frames {db:.2f} dB"
    lat = tp.generate(torch.from_numpy(ctx), torch.from_numpy(mask),
                      noise=torch.from_numpy(noise), attn_mode="pallas",
                      prefix_latents=torch.from_numpy(prefix_lat),
                      prefix_noises=draws, **{**kw, "output_type": "latent"})
    np.testing.assert_allclose(lat[:, :3].numpy(), prefix_lat, atol=1e-6)


def test_df_sp_mesh_names_step_15():
    """``sp_mesh`` (ROADMAP step 15, which the route used to name in its
    error, is ported): on a one-rank mesh the sequence-parallel route is
    the unsharded run bit for bit (tests/test_torch_usp.py holds it at 2
    ranks against JAX)."""
    from torch_mesh_workers import OneRankMesh

    _, tp = _pipes()
    ctx, mask = _text()
    run = dict(height=H, width=W, frame_num=FRAMES, sampling_steps=1,
               ar_step=1, causal_block_size=1, attn_mode="pallas",
               noise=torch.from_numpy(_noise()))
    want = tp.generate(torch.from_numpy(ctx), torch.from_numpy(mask), **run)
    tp.sp_mesh = OneRankMesh()
    got = tp.generate(torch.from_numpy(ctx), torch.from_numpy(mask), **run)
    assert torch.equal(got, want)
