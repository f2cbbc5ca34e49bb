"""Norms, RoPE, the patchifier and the rectified-flow scheduler of the port
against the JAX package, on inputs made with numpy. Tolerance 1e-5 for
fp32 elementwise math (both sides compute in fp32, in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.ltx import patchifier as jpatch
from ltx_video_gpupoor_tpu.ops import norms as jnorms
from ltx_video_gpupoor_tpu.ops import rope as jrope
from ltx_video_gpupoor_tpu.schedulers import rf as jrf
from ltx_video_gpupoor_tpu_torch.models.ltx import patchifier as tpatch
from ltx_video_gpupoor_tpu_torch.ops import norms as tnorms
from ltx_video_gpupoor_tpu_torch.ops import rope as trope
from ltx_video_gpupoor_tpu_torch.schedulers import rf as trf

torch.set_num_threads(2)
TOL = 1e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=tol)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    xj, wj, bj = map(jnp.asarray, (x, w, b))
    _close(tnorms.rms_norm(xt, wt), jnorms.rms_norm(xj, wj))
    _close(tnorms.layer_norm(xt, wt, bt), jnorms.layer_norm(xj, wj, bj))
    _close(tnorms.pixel_norm(xt, axis=-1), jnorms.pixel_norm(xj, axis=-1))
    _close(tnorms.group_norm(xt, 4, wt, bt), jnorms.group_norm(xj, 4, wj, bj))
    # channels-first group norm is the same math on a permuted tensor
    cf = tnorms.group_norm(xt.movedim(-1, 1), 4, wt, bt, channel_axis=1)
    _close(cf.movedim(1, -1), jnorms.group_norm(xj, 4, wj, bj))
    y = tnorms.rms_norm(xt.bfloat16())
    assert y.dtype == torch.bfloat16


# Angles reach 1.6e4 rad at dim 2048, where the fp32 products that form
# them round differently in the two frameworks (8e-6 seen on the tables,
# 2e-5 after rotating unit-normal inputs): compared at 5e-5.
ROPE_TOL = 5e-5


@pytest.mark.parametrize("dim,half", [(2048, True), (96, False), (100, True)])
def test_ltx_rope_matches_jax(dim, half):
    rng = np.random.default_rng(1)
    grid = (rng.random((2, 3, 37)) * np.array([[[9], [30], [40]]])).astype(
        np.float32)
    tc, ts = trope.ltx_freqs_cis(torch.from_numpy(grid), dim,
                                 half_layout=half)
    jc, js = jrope.ltx_freqs_cis(jnp.asarray(grid), dim, half_layout=half)
    _close(tc, jc, ROPE_TOL)
    _close(ts, js, ROPE_TOL)
    x = rng.standard_normal((2, 37, dim)).astype(np.float32)
    _close(trope.apply_rotary_emb(torch.from_numpy(x), tc, ts),
           jrope.apply_rotary_emb(jnp.asarray(x), jc, js), ROPE_TOL)
    _close(trope.rotate_pairs(torch.from_numpy(x)),
           jrope.rotate_pairs(jnp.asarray(x)), 0)


def test_patchify_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 3, 4, 6, 8)).astype(np.float32)
    tt, tcoords = tpatch.patchify(torch.from_numpy(lat))
    jt, jcoords = jpatch.patchify(jnp.asarray(lat))
    _close(tt, jt, 0)
    np.testing.assert_array_equal(tcoords.numpy(), np.asarray(jcoords))
    back = tpatch.unpatchify(tt, 4, 6, 8)
    np.testing.assert_array_equal(back.numpy(), lat)


@pytest.mark.parametrize("kw", [
    dict(num_steps=8, shifting="SD3", n_media_tokens=1280,
         target_shift_terminal=0.1),
    dict(num_steps=30, sampler="LinearQuadratic"),
    dict(num_steps=10, shifting="SimpleDiffusion", n_media_tokens=5280),
    dict(timesteps=[1.0, 0.9937, 0.9875, 0.7250]),
    dict(num_steps=8, sampler="Constant", shift=1.5, shifting=None),
    dict(num_steps=12, sampler="Constant", shift=0.7, shifting="SD3",
         n_media_tokens=5280, target_shift_terminal=0.1),
])
def test_rf_schedules_match_jax(kw):
    kw = dict(kw)
    n = kw.pop("num_steps", None)
    tsched = trf.make_schedule(n, **kw)
    jsched = jrf.make_schedule(n, **{k: (jnp.asarray(v) if k == "timesteps"
                                         else v) for k, v in kw.items()})
    _close(tsched.timesteps, jsched.timesteps, 1e-6)


@pytest.mark.parametrize("n,shift", [(1, 2.0), (7, 1.0), (30, 3.5)])
def test_rf_constant_sampler_matches_jax(n, shift):
    """``Constant`` is the Uniform grid shifted by ``shift``, which it
    requires."""
    _close(trf.initial_timesteps(n, "Constant", shift),
           jrf.initial_timesteps(n, "Constant", shift), 1e-6)
    assert trf.initial_timesteps(n, "Constant", shift).dtype == torch.float32
    with pytest.raises(ValueError, match="shift"):
        trf.initial_timesteps(n, "Constant")
    with pytest.raises(ValueError, match="sampler"):
        trf.initial_timesteps(n, "Quadratic")


def test_rf_steps_match_jax():
    """Per-token Euler steps, and the stochastic step with shared noise."""
    rng = np.random.default_rng(3)
    ts = np.asarray([1.0, 0.8, 0.5, 0.2], np.float32)
    sample = rng.standard_normal((1, 12, 4)).astype(np.float32)
    v = rng.standard_normal((1, 12, 4)).astype(np.float32)
    t_tok = np.full((1, 12), 0.8, np.float32)
    t_tok[0, :3] = 0.5      # conditioned tokens sit at a lower timestep
    tsched = trf.make_schedule(timesteps=ts)
    jsched = jrf.make_schedule(timesteps=jnp.asarray(ts))
    for t in (t_tok, np.float32(0.5)):
        out = trf.step(tsched, torch.from_numpy(v), torch.as_tensor(t),
                       torch.from_numpy(sample))
        ref = jrf.step(jsched, jnp.asarray(v), jnp.asarray(t),
                       jnp.asarray(sample))
        _close(out, ref)
    noise = rng.standard_normal((1, 12, 4)).astype(np.float32)
    out = trf.step(tsched, torch.from_numpy(v), torch.from_numpy(t_tok),
                   torch.from_numpy(sample), stochastic_sampling=True,
                   noise=torch.from_numpy(noise))
    lower = jrf.lower_timestep(jsched.timesteps, jnp.asarray(t_tok))
    t_full = jnp.asarray(t_tok)[..., None]
    x0 = jnp.asarray(sample) - t_full * jnp.asarray(v)
    ref = jrf.add_noise(x0, jnp.asarray(noise), t_full - (t_full - lower[..., None]))
    _close(out, ref)
    with pytest.raises(ValueError, match="generator"):
        trf.step(tsched, torch.from_numpy(v), torch.from_numpy(t_tok),
                 torch.from_numpy(sample), stochastic_sampling=True)
