"""Sequence parallelism (USP) of the port against the JAX package on the CPU:
``usp_ltx_forward`` (also with STG's skip mask and TeaCache's residual)
and ``usp_wan_forward`` (also with VACE, ReCamMaster, DF per-frame
timesteps and the TeaCache residual) at sp = 2, and JAX's guards. The
pipelines and the parallel decodes: tests/test_torch_usp_pipelines.py.

Ranks are gloo processes (``core.mesh.spawn_ranks``, a ``FileStore`` under
``tmp_path``, a 120 s group timeout, one thread each) running
``tests/torch_mesh_workers.py``. The JAX side runs its own ``shard_map``
versions on the virtual CPU devices of tests/conftest.py. Weights come
from JAX's ``init_params`` through ``core/from_jax.py``, inputs from numpy
with a seed; all in fp32, at JAX's tolerance for them
(tests/test_parallel.py): 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from ltx_video_gpupoor_tpu.core import mesh as jmesh
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.ops.rope import wan_rope_freqs
from ltx_video_gpupoor_tpu.parallel.usp import usp_ltx_forward, usp_wan_forward
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh

TOL = dict(atol=2e-4, rtol=2e-4)


def spawn(tmp_path, fn, world, *args):
    return tmesh.spawn_ranks(fn, world, backend="gloo", timeout=120.0,
                             store_dir=str(tmp_path), args=args)


def jax_mesh(sp):
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, sp=sp, tp=1),
                           devices=jax.devices()[:sp])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(params):
    return {k: v.numpy() for k, v in
            from_jax.state_dict(_np_tree(params)).items()}


def _join(outs, i=0, dim=1):
    return np.concatenate([o[i] for o in outs], axis=dim)


# ---- the forwards ---------------------------------------------------------

LTX_KW = dict(num_attention_heads=4, attention_head_dim=16, in_channels=8,
              out_channels=8, num_layers=2, cross_attention_dim=64,
              caption_channels=24)


def _ltx_inputs(seed=0, b=2, f=4, h=2, w=4, sc=6):
    rng = np.random.default_rng(seed)
    s = f * h * w
    lat = rng.standard_normal((b, s, 8)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                                indexing="ij")).reshape(3, -1)
    scale = np.array([8 / 25, 32, 32]).reshape(1, 3, 1)
    grid = np.broadcast_to(grid[None] * scale, (b, 3, s)).astype(np.float32)
    t = rng.uniform(0.2, 1.0, (b, f)).astype(np.float32)
    cap = rng.standard_normal((b, sc, 24)).astype(np.float32)
    mask = np.ones((b, sc), np.int32)
    mask[0, 4:] = 0
    return lat, grid, t, cap, mask


@pytest.fixture(scope="module")
def ltx_params():
    return jax.jit(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**LTX_KW)))(jax.random.key(0))


@pytest.mark.parametrize("case", ["plain", "stg", "teacache"])
def test_usp_ltx_forward_matches_jax(tmp_path, ltx_params, case):
    """sp = 2: per-group timesteps sharded with their tokens; STG's skip
    mask (AttentionValues) replicated; TeaCache's residual sharded and a
    skipped step (``compute=False``) taken alike on both ranks."""
    lat, grid, t, cap, mask = _ltx_inputs()
    cfg = jtf.LTXTransformerConfig(**LTX_KW)
    kw = {}
    if case == "stg":
        skip = np.ones((2, 2), np.float32)
        skip[1, 1] = 0.0
        kw = dict(skip_layer_mask=skip, skip_layer_strategy="attention_values")
    if case == "teacache":
        res = np.random.default_rng(5).standard_normal(
            (2, lat.shape[1], cfg.inner_dim)).astype(np.float32)
        kw = dict(previous_residual=res, compute=False)
    arrays = {k: jnp.asarray(v) for k, v in kw.items()
              if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    ref, ref_res = jax.jit(lambda p, a, *x: usp_ltx_forward(
        jax_mesh(2), p, cfg, *x, attn_mode="xla", **a, **static))(
        ltx_params, arrays, *(jnp.asarray(a) for a in
                              (lat, grid, t, cap, mask)))
    outs = spawn(tmp_path, workers.usp_ltx, 2, LTX_KW, _sd(ltx_params),
                 (lat, grid, t, cap, mask), dict(kw, attn_mode="xla"))
    np.testing.assert_allclose(_join(outs, 0), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_join(outs, 1), np.asarray(ref_res), **TOL)


WAN_KW = dict(model_type="t2v", patch_size=(1, 2, 2), text_len=16, in_dim=4,
              dim=128, ffn_dim=256, freq_dim=32, text_dim=32, out_dim=4,
              num_heads=4, num_layers=2)


def _wan_inputs(seed=1, b=1, f=4, h=4, w=6, sc=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, h, w, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, sc, 32)).astype(np.float32)
    cmask = np.ones((b, sc), np.int32)
    cmask[:, 12:] = 0
    cos, sin = (np.asarray(a) for a in wan_rope_freqs(
        (f, h // 2, w // 2), 32))
    return x, ctx, cmask, cos, sin


def _wan_params(**variant):
    cfg = jwm.WanConfig(**WAN_KW, **variant)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    if variant.get("vace_layers"):
        # after_proj / before_proj start at zero and the projector at the
        # identity: give them weights so that the hint and pose paths
        # contribute
        kr = iter(jax.random.split(jax.random.key(7), 4))
        vp0 = params["vace_blocks"][0]
        for name in ("after_proj", "before_proj"):
            vp0[name]["kernel"] = jax.random.normal(
                next(kr), vp0[name]["kernel"].shape) * 0.02
        pj = params["blocks"]["projector"]
        pj["kernel"] = pj["kernel"] + jax.random.normal(
            next(kr), pj["kernel"].shape) * 0.02
    return cfg, params


@pytest.mark.parametrize("case", ["t2v", "vace_recam", "df", "teacache"])
def test_usp_wan_forward_matches_jax(tmp_path, case):
    """sp = 2 on the frame axis: VACE hints sharded with the frames,
    ReCamMaster poses expanded to one row a frame then sharded, DF's
    per-frame ``t [B, F]`` sharded, TeaCache's residual rows sharded."""
    variant = (dict(vace_layers=(0,), vace_in_dim=12, recammaster=True)
               if case == "vace_recam" else {})
    cfg, params = _wan_params(**variant)
    x, ctx, cmask, cos, sin = _wan_inputs()
    rng = np.random.default_rng(9)
    t = np.full((1,), 400.0, np.float32)
    kw = {}
    if case == "vace_recam":
        kw = dict(vace_context=rng.standard_normal(
            x.shape[:4] + (12,)).astype(np.float32), vace_scale=1.3,
            cam_emb=rng.standard_normal((1, 2, 12)).astype(np.float32))
    if case == "df":
        t = np.array([[900.0, 700.0, 500.0, 300.0]], np.float32)
    if case == "teacache":
        n = x.shape[1] * (x.shape[2] // 2) * (x.shape[3] // 2)
        kw = dict(previous_residual=rng.standard_normal(
            (1, n, 128)).astype(np.float32), compute=False)
    arrays = {k: jnp.asarray(v) for k, v in kw.items()
              if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    ref, ref_res = jax.jit(lambda p, a, x, t, ctx, cmask, cos, sin:
                           usp_wan_forward(
                               jax_mesh(2), p, cfg, x, t, ctx, cmask,
                               (cos, sin), attn_mode="xla", **a,
                               **static))(
        params, arrays, *(jnp.asarray(a) for a in
                          (x, t, ctx, cmask, cos, sin)))
    outs = spawn(tmp_path, workers.usp_wan, 2,
                 dict(WAN_KW, **variant), _sd(params),
                 (x, t, ctx, cmask, cos, sin), dict(kw, attn_mode="pallas"))
    np.testing.assert_allclose(_join(outs, 0), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_join(outs, 1), np.asarray(ref_res), **TOL)


def test_usp_guards_raise_like_jax(tmp_path):
    """JAX's guards: frames, heads and timestep groups that do not divide
    over sp, and a temporal patch other than 1, raise ValueError."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.parallel import usp

    mesh = workers.OneRankMesh()
    model = twm.WanModel(twm.WanConfig(**dict(WAN_KW, patch_size=(2, 2, 2))))
    with pytest.raises(ValueError, match="patch_size"):
        usp.usp_wan_forward(mesh, model, torch.zeros(1, 2, 4, 4, 4),
                            torch.zeros(1), None, None, (None, None))

    class TwoRanks(workers.OneRankMesh):
        def size(self, mesh_dim=None):
            return 2 if mesh_dim in (None, 1) else 1

    model = twm.WanModel(twm.WanConfig(**dict(WAN_KW, num_heads=1,
                                              dim=32, ffn_dim=32)))
    with pytest.raises(ValueError, match="frames"):
        usp.usp_wan_forward(TwoRanks(), model, torch.zeros(1, 3, 4, 4, 4),
                            torch.zeros(1), None, None, (None, None))
    with pytest.raises(ValueError, match="heads"):
        usp.usp_wan_forward(TwoRanks(), model, torch.zeros(1, 2, 4, 4, 4),
                            torch.zeros(1), None, None, (None, None))
