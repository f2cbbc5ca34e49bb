"""Rank bodies for the tests of the port on four cards
(tests/test_torch_ring_rdma_rank.py, tests/test_torch_cards.py).

Each function runs in a gloo rank on the CPU that ``core.mesh.spawn_ranks``
started and returns numpy arrays or plain values. Like
``torch_mesh_workers.py`` it imports torch and the port only, never jax;
``chip_smoke.py`` (which imports neither at module level) lends its
``[cards]`` helpers.
"""

from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch

from torch_mesh_workers import _np, _sd, _t, logged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(dp=1, sp=1, tp=1):
    from ltx_video_gpupoor_tpu_torch.core.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=dp, sp=sp, tp=tp), "cpu")


# ---- K7's per-rank entry ---------------------------------------------------


def ring_rank(rank, world, dims, q, k, v, dtype):
    """``ring_attention_rdma_rank_sharded`` on a (dp, sp, tp) mesh over
    the global q, k, v (the same on every rank): the joined output, and
    this rank's output of the per-rank entry against the list entry's
    plain ring on the same shards (bit for bit)."""
    from ltx_video_gpupoor_tpu_torch.core import mesh as M
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr

    mesh = _mesh(*dims)
    tdt = getattr(torch, dtype)
    q, k, v = (_t(a).to(tdt) for a in (q, k, v))
    out = rr.ring_attention_rdma_rank_sharded(mesh, q, k, v)
    sp = M.axis_size(mesh, "sp")
    my = M.axis_rank(mesh, "sp")
    shards = [t.chunk(sp, dim=2) for t in (q, k, v)]
    with M.use_mesh(mesh):
        mine = rr.ring_attention_rdma_rank(*(s[my] for s in shards), sp)
    listed = rr.ring_attention_plain(*shards)[my]
    return _np(out), bool(torch.equal(mine, listed)), str(mine.dtype)


def ring_rank_rejects(rank, world):
    """What the per-rank entry refuses: an axis size that is not the
    mesh's, and no active mesh at all."""
    from ltx_video_gpupoor_tpu_torch.core import mesh as M
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr

    q = torch.zeros(1, 2, 8, 16)
    errors = []
    with M.use_mesh(_mesh(sp=world)):
        try:
            rr.ring_attention_rdma_rank(q, q, q, world + 1)
        except ValueError as e:
            errors.append(str(e))
        try:
            rr.ring_attention_rdma_rank(q, q[:, :1], q, world)
        except ValueError as e:
            errors.append(str(e))
    try:
        rr.ring_attention_rdma_rank(q, q, q, world)
    except RuntimeError as e:
        errors.append(str(e))
    return errors


def collective_counts(rank, world):
    """Each collective of ``parallel/comm.py`` once on CPU tensors (nothing
    is staged on the CPU, whatever is named), then the counts reset."""
    from ltx_video_gpupoor_tpu_torch.parallel import comm

    group = _mesh(sp=world).get_group("sp")
    comm.reset_counts()
    comm.set_staged(comm.COLLECTIVES)
    try:
        x = torch.arange(world * 2, dtype=torch.float32).reshape(world, 2)
        comm.all_to_all(x, group)
        comm.all_reduce(x.clone(), group)
        comm.all_gather_cat(x, group, 0)
        comm.ring_shift([x, x], group)
        comm.reduce_sum(x.clone(), group)
        first = (dict(comm.call_counts), dict(comm.staged_counts))
        comm.reset_counts()
        return first, dict(comm.call_counts)
    finally:
        comm.set_staged(())


# ---- [cards]' forwards: launches and collective calls ----------------------


def _count_calls(calls):
    """Wrap the wrappers each kernel launches through (``ops.attention``'s
    and ``ops.quant``'s references to them) to count their calls on the
    CPU, where they launch nothing."""
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
    from ltx_video_gpupoor_tpu_torch.ops import quant

    for module, name, key in ((tattn, "flash_attention", "K1"),
                              (tattn, "flash_attention_int8", "K4"),
                              (tattn, "flash_attention_hp", "K6"),
                              (quant, "int8_linear", "K2"),
                              (quant, "int8_linear_scaled", "K2s")):
        def counted(*a, _fn=getattr(module, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        setattr(module, name, counted)


def _tiny_model(kind, layers):
    """A small LTX (head dim 64, as LTX-2B; 8 heads, so that tp=4 leaves
    each rank the even count that the head-packed kernel wants at d=64,
    as LTX-2B's 32 do) or Wan (head dim 128) DiT in the dynamic tier,
    bf16 (the card's policy, so that ``auto`` picks the card's kernels),
    and its inputs: two streams."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    g = torch.Generator().manual_seed(0)
    if kind == "ltx":
        from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf

        cfg = tf.LTXTransformerConfig(
            num_attention_heads=8, attention_head_dim=64, in_channels=8,
            out_channels=8, num_layers=layers, cross_attention_dim=256,
            caption_channels=16)
        model = tf.init_params(tf.LTXTransformer3D(cfg, DEFAULT_POLICY), g)
        f, h, w = 4, 2, 2
        grid = torch.stack(torch.meshgrid(
            torch.arange(f), torch.arange(h), torch.arange(w),
            indexing="ij")).reshape(1, 3, -1).float().expand(2, -1, -1)
        inputs = [torch.randn(2, f * h * w, 8, generator=g),
                  grid.contiguous(), torch.rand(2, f, generator=g),
                  torch.randn(2, 8, 16, generator=g),
                  torch.ones(2, 8, dtype=torch.int32)]
    else:
        from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
        from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

        cfg = wm.WanConfig(model_type="t2v", text_len=8, in_dim=4, dim=512,
                           ffn_dim=64, freq_dim=32, text_dim=16, out_dim=4,
                           num_heads=4, num_layers=layers)
        model = wm.init_params(wm.WanModel(cfg, DEFAULT_POLICY), g)
        inputs = [torch.randn(2, 4, 4, 4, 4, generator=g),
                  torch.full((2,), 500.0), torch.randn(2, 8, 16, generator=g),
                  torch.ones(2, 8), wan_rope_freqs((4, 2, 2), 128)]
    return quantize_params(model, mode="dynamic"), inputs


def cards_counts(rank, world, layers):
    """One forward of each model in each of chip_smoke's CARDS_LAYOUTS
    through its ``cards_forward``: the calls of each kernel's wrapper and
    the collective calls of this rank, by (kind, layout)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from ltx_video_gpupoor_tpu_torch.parallel import comm

    calls = collections.Counter()
    _count_calls(calls)
    meshes = {name: _mesh(*dims)
              for name, dims in chip_smoke.CARDS_LAYOUTS.items()}
    seen = {}
    with torch.no_grad():
        for kind in ("ltx", "wan"):
            for layout in chip_smoke.CARDS_LAYOUTS:
                model, inputs = _tiny_model(kind, layers)
                calls.clear()
                comm.reset_counts()
                out = chip_smoke.cards_forward(meshes[layout], layout, kind,
                                               model, inputs)
                assert torch.isfinite(out.float()).all()
                seen[(kind, layout)] = (
                    {k: calls[k] for k in ("K1", "K2", "K2s", "K4", "K6")},
                    dict(comm.call_counts))
    return seen


def train_counts(rank, world, layers):
    """One train step (backward and update) of a small LTX DiT in fp32
    with per-block remat on each of chip_smoke's CARDS_TRAIN_MESHES, the
    grads in buckets of a few thousand values: this rank's collective
    calls and the buckets its grads fill, by layout."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.parallel import comm
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import shard_params
    from ltx_video_gpupoor_tpu_torch.training import (
        TrainBatch,
        TrainConfig,
        make_train_step,
        trainer,
    )

    trainer.GRAD_BUCKET = 4096
    seen = {}
    for layout, dims in chip_smoke.CARDS_TRAIN_MESHES.items():
        mesh = _mesh(*dims)
        g = torch.Generator().manual_seed(0)
        cfg = tf.LTXTransformerConfig(
            num_attention_heads=8, attention_head_dim=8, in_channels=8,
            out_channels=8, num_layers=layers, cross_attention_dim=64,
            caption_channels=16)
        model = tf.init_params(tf.LTXTransformer3D(cfg, FP32_POLICY), g)
        shard_params(mesh, model)
        f, h, w = 4, 2, 2
        grid = torch.stack(torch.meshgrid(
            torch.arange(f), torch.arange(h), torch.arange(w),
            indexing="ij")).reshape(1, 3, -1).float().expand(2, -1, -1)
        batch = TrainBatch(torch.randn(2, f * h * w, 8, generator=g),
                           grid.contiguous(),
                           torch.randn(2, 8, 16, generator=g),
                           torch.ones(2, 8, dtype=torch.int32))
        step = make_train_step(model, TrainConfig(), attn_mode="xla",
                               mesh=mesh)
        comm.reset_counts()
        step(batch, t=torch.tensor([0.6, 0.3]),
             eps=torch.randn(2, f * h * w, 8, generator=g))
        seen[layout] = (dict(comm.call_counts), chip_smoke.grad_buckets(
            [p.numel() for p in step.params.values()]))
    return seen


def i2v_counts(rank, world, layers, clip_layers):
    """One forward of a small Wan i2v DiT (head dim 128, bf16, the dynamic
    tier) cut over tp = world as ``apply_wan_serving_mesh`` cuts it, with
    CLIP's features; then CLIP ``visual`` at head dim 80 (whole on every
    rank): the calls of each kernel's wrapper in each, and the forward's
    collective calls."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as wc
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs
    from ltx_video_gpupoor_tpu_torch.parallel import comm
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import shard_wan_params

    calls = collections.Counter()
    _count_calls(calls)
    g = torch.Generator().manual_seed(0)
    cfg = wm.WanConfig(model_type="i2v", text_len=8, in_dim=36, dim=512,
                       ffn_dim=64, freq_dim=32, text_dim=16, out_dim=16,
                       num_heads=4, num_layers=layers)
    model = quantize_params(wm.init_params(wm.WanModel(cfg, DEFAULT_POLICY),
                                           g), mode="dynamic")
    shard_wan_params(_mesh(tp=world), model)
    comm.reset_counts()
    with torch.no_grad():
        out = model(torch.randn(2, 4, 4, 4, 36, generator=g),
                    torch.full((2,), 500.0), torch.randn(2, 8, 16,
                                                         generator=g),
                    torch.ones(2, 8), wan_rope_freqs((4, 2, 2), 128),
                    clip_features=torch.randn(2, 257, wm.CLIP_DIM,
                                              generator=g))[0]
    assert torch.isfinite(out.float()).all()
    dit = dict(calls)
    collectives = dict(comm.call_counts)
    calls.clear()
    clip = wc.init_params(wc.CLIPVision(wc.CLIPVisionConfig(
        dim=160, num_heads=2, num_layers=clip_layers), DEFAULT_POLICY), g)
    with torch.no_grad():
        wc.visual(clip, torch.rand(1, 224, 224, 3, generator=g) * 2 - 1)
    return dit, dict(calls), collectives


def usp_hp_calls(rank, world, layers=2):
    """One ``usp_ltx_forward`` at sp = world of a small LTX DiT at the 13B's
    head dim (128) in ``pallas_hp``: the calls of each kernel's wrapper."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.parallel.usp import usp_ltx_forward

    calls = collections.Counter()
    _count_calls(calls)
    g = torch.Generator().manual_seed(0)
    cfg = tf.LTXTransformerConfig(
        num_attention_heads=8, attention_head_dim=128, in_channels=8,
        out_channels=8, num_layers=layers, cross_attention_dim=1024,
        caption_channels=16)
    model = quantize_params(tf.init_params(
        tf.LTXTransformer3D(cfg, DEFAULT_POLICY), g), mode="dynamic")
    f, h, w = 4, 2, 2
    grid = torch.stack(torch.meshgrid(
        torch.arange(f), torch.arange(h), torch.arange(w),
        indexing="ij")).reshape(1, 3, -1).float()
    with torch.no_grad():
        usp_ltx_forward(_mesh(sp=world), model,
                        torch.randn(1, f * h * w, 8, generator=g), grid,
                        torch.rand(1, f, generator=g),
                        torch.randn(1, 8, 16, generator=g),
                        torch.ones(1, 8, dtype=torch.int32),
                        attn_mode="pallas_hp")
    return dict(calls)


def tp_int8_forward(rank, world, kind):
    """One forward of a small LTX or Wan DiT in the dynamic-int8 tier, bf16,
    its weights cut over tp = world (none at world 1), at 1792 tokens a
    stream, two streams: the output, which every rank holds whole."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import (
        shard_params,
        shard_wan_params,
    )

    g = torch.Generator().manual_seed(0)
    f, h, w = 7, 16, 16
    if kind == "ltx":
        from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf

        cfg = tf.LTXTransformerConfig(
            num_attention_heads=8, attention_head_dim=64, in_channels=8,
            out_channels=8, num_layers=2, cross_attention_dim=512,
            caption_channels=16)
        model = tf.init_params(tf.LTXTransformer3D(cfg, DEFAULT_POLICY), g)
        grid = torch.stack(torch.meshgrid(
            torch.arange(f), torch.arange(h), torch.arange(w),
            indexing="ij")).reshape(1, 3, -1).float().expand(2, -1, -1)
        inputs = [torch.randn(2, f * h * w, 8, generator=g),
                  grid.contiguous(), torch.rand(2, f, generator=g),
                  torch.randn(2, 8, 16, generator=g),
                  torch.ones(2, 8, dtype=torch.int32)]
        shard = shard_params
    else:
        from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
        from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

        cfg = wm.WanConfig(model_type="t2v", text_len=8, in_dim=4, dim=512,
                           ffn_dim=64, freq_dim=32, text_dim=16, out_dim=4,
                           num_heads=4, num_layers=2)
        model = wm.init_params(wm.WanModel(cfg, DEFAULT_POLICY), g)
        inputs = [torch.randn(2, f, 2 * h, 2 * w, 4, generator=g),
                  torch.full((2,), 500.0), torch.randn(2, 8, 16, generator=g),
                  torch.ones(2, 8), wan_rope_freqs((f, h, w), 128)]
        shard = shard_wan_params
    quantize_params(model, mode="dynamic")
    if world > 1:
        shard(_mesh(tp=world), model)
    with torch.no_grad():
        out = model(*inputs, attn_mode="auto")
    return _np(out if kind == "ltx" else out[0])


# ---- the requests spread over cards, at tiny widths ------------------------


def multiscale_sp(rank, world, tf_kw, tf_np, vae_dict, vae_np, up_kw, up_np,
                  config, emb, mask, image, noises, size):
    """The LTX multi-scale image-to-video ``generate`` (the 13B's route)
    with ``sp_mesh`` at sp = world, fp32, exact attention, the image's
    CRF compression off (as the test turns JAX's off): the latents it
    decodes, its frames, its log messages and the all-to-alls of each
    pass."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
    from ltx_video_gpupoor_tpu_torch.parallel import comm
    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import LTXPipeline
    from ltx_video_gpupoor_tpu_torch.pipelines.multiscale import (
        MultiScalePipeline,
    )
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )
    from ltx_video_gpupoor_tpu_torch.utils import media

    media.crf_compress = lambda img, crf=29: img
    model = tf.LTXTransformer3D(tf.LTXTransformerConfig(**tf_kw), FP32_POLICY)
    model.load_state_dict(_sd(tf_np))
    vae = tvae.CausalVAE(tvae.VAEConfig.from_dict(vae_dict), FP32_POLICY)
    vae.load_state_dict(_sd(vae_np))
    up = lup.LatentUpsampler(lup.LatentUpsamplerConfig(**up_kw), FP32_POLICY)
    up.load_state_dict(_sd(up_np))
    pipe = LTXPipeline(model, vae, vae_tile_size=(2, 0),
                       sp_mesh=_mesh(sp=world))
    gen = LTXVideoGenerator(pipe, multiscale=MultiScalePipeline(pipe, up),
                            pipeline_config=config)
    seen, a2a = {}, {}

    def on_stage(name, value):
        seen.setdefault(name, value)
        a2a[name] = comm.call_counts.get("all_to_all", 0)

    comm.reset_counts()
    h, w, frames = size
    out, logs = logged(lambda: gen.generate(
        _t(emb), _t(mask), height=h, width=w, frame_num=frames, seed=0,
        image_start=image, image_cond_noise_scale=0.0,
        noise_pass1=_t(noises[0]), noise_pass2=_t(noises[1]),
        attn_mode="xla", on_stage=on_stage))
    passes = (a2a["upsample"] - a2a["pass1"], a2a["decode"] - a2a["pass2"])
    return _np(seen["decode"]), np.asarray(out), logs, passes


def wan_t2v_tp(rank, world, cfg_kw, sd_np, ctx, cmask, noise, kw):
    """``WanPipeline.generate_t2v`` with the DiT cut over tp = world by
    ``apply_wan_serving_mesh``: the latents and this rank's collective
    calls."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.parallel import comm
    from ltx_video_gpupoor_tpu_torch.pipelines.wan import WanPipeline
    from ltx_video_gpupoor_tpu_torch.serving.model_zoo import (
        apply_wan_serving_mesh,
    )

    model = twm.WanModel(twm.WanConfig(**cfg_kw), FP32_POLICY)
    model.load_state_dict(_sd(sd_np))
    pipe = apply_wan_serving_mesh(WanPipeline(model, None, vae_tile_size=0),
                                  _mesh(tp=world))
    assert pipe.sp_mesh is None and pipe.mesh is not None
    comm.reset_counts()
    out = pipe.generate_t2v(_t(ctx), _t(cmask), noise=_t(noise),
                            output_type="latent", **kw)
    return _np(out), dict(comm.call_counts)


def wan_i2v_tp(rank, world, cfg_kw, sd_np, clip_kw, clip_np, vae_kw, vae_np,
               stride, image, frame, ctx, cmask, noise, kw):
    """Wan image-to-video with the DiT cut over tp = world by
    ``apply_wan_serving_mesh``: CLIP's features of ``image`` (whole on
    every rank, the exact tier, as JAX runs it), then ``generate_i2v``
    (the Wan VAE encode of ``frame``, the steps, the parallel spatial
    tiled decode over every rank). The latents, the frames and this
    rank's collective calls."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as tclip
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
    from ltx_video_gpupoor_tpu_torch.ops.attention import set_attention_mode
    from ltx_video_gpupoor_tpu_torch.parallel import comm
    from ltx_video_gpupoor_tpu_torch.pipelines.wan import WanPipeline
    from ltx_video_gpupoor_tpu_torch.serving.model_zoo import (
        apply_wan_serving_mesh,
    )

    clip = tclip.CLIPVision(tclip.CLIPVisionConfig(**clip_kw), FP32_POLICY)
    clip.load_state_dict(_sd(clip_np))
    set_attention_mode("xla")
    try:
        with torch.no_grad():
            feats = tclip.visual(clip, _t(image))
    finally:
        set_attention_mode("auto")
    model = twm.WanModel(twm.WanConfig(**cfg_kw), FP32_POLICY)
    model.load_state_dict(_sd(sd_np))
    vae = twv.WanVAE(twv.WanVAEConfig(**vae_kw), FP32_POLICY)
    vae.load_state_dict(_sd(vae_np))
    pipe = apply_wan_serving_mesh(
        WanPipeline(model, vae, vae_stride=tuple(stride), vae_tile_size=16),
        _mesh(tp=world))
    assert pipe.sp_mesh is None and pipe.mesh is not None
    latents = {}

    def on_stage(name, value):
        if name == "decode":
            latents["z"] = value
    comm.reset_counts()
    with torch.no_grad():
        frames = pipe.generate_i2v(_t(ctx), _t(cmask), feats, _t(frame),
                                   noise=_t(noise), output_type="pixels",
                                   on_stage=on_stage, **kw)
    return (_np(latents["z"]), _np(frames), _np(feats),
            dict(comm.call_counts))
