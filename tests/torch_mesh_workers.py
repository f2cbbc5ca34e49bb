"""Rank bodies for the port's multi-rank tests (tests/test_torch_mesh.py,
test_torch_usp.py, test_torch_tp.py).

Each function runs in a process that ``core.mesh.spawn_ranks`` started (a
gloo rank on the CPU) and returns numpy arrays or plain values. This module
imports torch and the port only, never jax: the ranks are fresh ``spawn``
processes, and the JAX references are computed by the test in its own
process. Weights arrive as numpy state dicts (``core/from_jax.py`` keys).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch


def _mesh(dp=1, sp=1, tp=1):
    from ltx_video_gpupoor_tpu_torch.core.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=dp, sp=sp, tp=tp), "cpu")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def _sd(sd_np):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd_np.items()}


# ---- attention ------------------------------------------------------------


def seq_attention(rank, world, kind, q, k, v, mode="xla"):
    """Ulysses or ring attention at sp = world on global q/k/v; the joined
    output."""
    from ltx_video_gpupoor_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded,
    )
    from ltx_video_gpupoor_tpu_torch.parallel.ulysses import (
        ulysses_attention_sharded,
    )

    mesh = _mesh(sp=world)
    q, k, v = _t(q), _t(k), _t(v)
    if kind == "ulysses":
        out = ulysses_attention_sharded(mesh, q, k, v, attn_mode=mode)
    else:
        out = ring_attention_sharded(mesh, q, k, v)
    return _np(out)


# ---- models ---------------------------------------------------------------


def _ltx(cfg_kw, sd_np, quant=None):
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**cfg_kw),
                                 FP32_POLICY)
    if quant:
        quantize_params(model, mode=quant)
    model.load_state_dict(_sd(sd_np))
    return model


def _wan(cfg_kw, sd_np, quant=None):
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    model = twm.WanModel(twm.WanConfig(**cfg_kw), FP32_POLICY)
    if quant:
        quantize_params(model, mode=quant)
    model.load_state_dict(_sd(sd_np))
    return model


def usp_ltx(rank, world, cfg_kw, sd_np, inputs, kw):
    """``usp_ltx_forward`` at sp = world: this rank's (velocity,
    residual) shards."""
    from ltx_video_gpupoor_tpu_torch.parallel.usp import usp_ltx_forward

    mesh = _mesh(sp=world)
    model = _ltx(cfg_kw, sd_np)
    lat, grid, t, cap, mask = (_t(a) for a in inputs)
    kw = dict(kw)
    if kw.get("skip_layer_mask") is not None:
        kw["skip_layer_mask"] = _t(kw["skip_layer_mask"])
    if kw.get("previous_residual") is not None:
        kw["previous_residual"] = _t(kw["previous_residual"])
    with torch.no_grad():
        vel, res = usp_ltx_forward(mesh, model, lat, grid, t, cap, mask,
                                   **kw)
    return _np(vel), _np(res)


def usp_wan(rank, world, cfg_kw, sd_np, inputs, kw):
    """``usp_wan_forward`` at sp = world: this rank's (velocity, residual)
    shards."""
    from ltx_video_gpupoor_tpu_torch.parallel.usp import usp_wan_forward

    mesh = _mesh(sp=world)
    model = _wan(cfg_kw, sd_np)
    x, t, ctx, cmask, cos, sin = (_t(a) for a in inputs)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    with torch.no_grad():
        vel, res = usp_wan_forward(mesh, model, x, t, ctx, cmask, (cos, sin),
                                   **kw)
    return _np(vel), _np(res)


def _record_attention_heads():
    """Wrap the attention kernels' wrappers to record the heads of every
    call (``flash_attention``, ``flash_attention_int8`` and the head-packed
    ``flash_attention_hp``, as ``ops.attention`` reaches them)."""
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

    seen = []

    def wrap(name, heads_of):
        fn = getattr(tattn, name)

        def rec(*a, **k):
            seen.append((name, heads_of(a, k)))
            return fn(*a, **k)
        setattr(tattn, name, rec)

    wrap("flash_attention", lambda a, k: a[0].shape[1])
    wrap("flash_attention_int8", lambda a, k: a[0].shape[1])
    wrap("flash_attention_hp", lambda a, k: k["heads"])
    return seen


def tp_ltx(rank, world, cfg_kw, sd_np, inputs, kw, quant=None,
           record=False):
    """The LTX forward with its weights cut over tp = world (quantized in
    ``quant``'s tier before the cut): the velocity, which every rank
    holds whole; with ``record`` also the heads each attention call saw."""
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import shard_params

    mesh = _mesh(tp=world)
    model = shard_params(mesh, _ltx(cfg_kw, sd_np, quant))
    seen = _record_attention_heads() if record else None
    lat, grid, t, cap, mask = (_t(a) for a in inputs)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    with torch.no_grad():
        vel = model(lat, grid, t, cap, mask, **kw)
    return (_np(vel), seen) if record else _np(vel)


def tp_wan(rank, world, cfg_kw, sd_np, inputs, kw, quant=None):
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import (
        shard_wan_params,
    )

    mesh = _mesh(tp=world)
    model = shard_wan_params(mesh, _wan(cfg_kw, sd_np, quant))
    x, t, ctx, cmask, cos, sin = (_t(a) for a in inputs)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    with torch.no_grad():
        vel, _ = model(x, t, ctx, cmask, (cos, sin), **kw)
    return _np(vel)


def tp_t5(rank, world, cfg_kw, sd_np, ids, mask, quant=None):
    from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import shard_t5_params

    mesh = _mesh(tp=world)
    model = tt5.T5Encoder(tt5.T5Config(**cfg_kw))
    if quant:
        quantize_params(model, mode=quant)
    model.load_state_dict(_sd(sd_np))
    shard_t5_params(mesh, model)
    return _np(tt5.encode(model, _t(ids), _t(mask)))


def row_parallel_codes(rank, world, x, w_int8, w_scale, bias):
    """A row-parallel int8_dynamic linear over tp = world: this rank's
    codes (against the all-reduced amax) and the summed output."""
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul
    from ltx_video_gpupoor_tpu_torch.ops.quant import Linear
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import (
        ROW,
        shard_linear,
        tensor_parallel,
    )

    mesh = _mesh(tp=world)
    n, k = w_int8.shape
    lin = Linear(k, n, bias is not None)
    del lin.weight
    lin.register_buffer("w_int8_dyn", _t(w_int8))
    lin.register_buffer("scale", _t(w_scale))
    if bias is not None:
        lin.bias.data.copy_(_t(bias))
    tp = tensor_parallel(mesh)
    shard_linear(lin, ROW, tp)
    xl = tp.local(_t(x))
    codes = []
    fn = int8_matmul.quantize_rows_scaled_plain

    def spy(x2, s_x):
        out = fn(x2, s_x)
        codes.append(out)
        return out
    int8_matmul.quantize_rows_scaled_plain = spy
    with torch.no_grad():
        y = lin(xl)
    return codes[0].numpy(), _np(y)


# ---- mesh, launcher -------------------------------------------------------


def mesh_env(rank, world, spec):
    """``mesh_from_env`` under ``LTXV_TPU_MESH=spec``: the mesh's axis
    sizes and this rank's coordinates, or None."""
    from ltx_video_gpupoor_tpu_torch.core import mesh as cm

    os.environ["LTXV_TPU_MESH"] = spec
    mesh = cm.mesh_from_env(device_type="cpu", backend="gloo", device="cpu")
    if mesh is None:
        return None
    return (cm.mesh_shape(mesh),
            {a: cm.axis_rank(mesh, a) for a in cm.AXIS_NAMES})


def raise_on(rank, world, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective it never
    joins."""
    import torch.distributed as dist

    if rank == bad_rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    dist.barrier()
    return rank


def logged(fn):
    """Run ``fn`` with this rank's log records captured; returns (result,
    messages)."""
    records = []

    class H(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())
    h = H()
    logging.getLogger().addHandler(h)
    logging.getLogger().setLevel(logging.INFO)
    try:
        return fn(), records
    finally:
        logging.getLogger().removeHandler(h)


class OneRankMesh:
    """A mesh of one rank (every axis of size 1) without a process group:
    what the pipelines' mesh routes take when nothing needs to be
    exchanged."""

    mesh_dim_names = ("dp", "sp", "tp")

    def size(self, mesh_dim=None):
        return 1

    def get_local_rank(self, mesh_dim=None):
        return 0

    def get_group(self, mesh_dim=None):
        raise AssertionError("a one-rank mesh exchanges nothing")


# ---- pipelines and decodes ------------------------------------------------


def ltx_pipeline(rank, world, cfg_kw, sd_np, vae_dict, vae_np, emb, mask,
                 noise, kw, sp=True):
    """``LTXPipeline.generate`` with ``sp_mesh`` at sp = world (``sp``
    False: no mesh, the unsharded run on every rank); returns (latents,
    this rank's log messages)."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import (
        LTXPipeline,
    )

    mesh = _mesh(sp=world) if sp else None
    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(vae_dict),
                                FP32_POLICY)
    vae.load_state_dict(_sd(vae_np))
    pipe = LTXPipeline(_ltx(cfg_kw, sd_np), vae, sp_mesh=mesh)
    out, logs = logged(lambda: pipe.generate(_t(emb), _t(mask),
                                             noise=_t(noise), **kw))
    return _np(out), logs


def wan_pipeline(rank, world, cfg_kw, sd_np, lat, ctx, cmask, sigmas, kw,
                 teacache_mask=None):
    """``WanPipeline.denoise`` with ``sp_mesh`` at sp = world; returns
    (latents, the compute flags the DiT saw, log messages)."""
    from ltx_video_gpupoor_tpu_torch.pipelines.wan import WanPipeline

    mesh = _mesh(sp=world)
    model = _wan(cfg_kw, sd_np)
    flags = []
    fwd = model.forward

    def record(*a, compute=True, **k):
        flags.append(bool(compute))
        return fwd(*a, compute=compute, **k)
    model.forward = record
    pipe = WanPipeline(model, None, vae_tile_size=0, sp_mesh=mesh)
    out, logs = logged(lambda: pipe.denoise(
        _t(lat), _t(ctx), _t(cmask), _t(sigmas), teacache_mask=teacache_mask,
        **kw))
    return _np(out), flags, logs


def ltx_decode(rank, world, vae_dict, vae_np, z, z_tile, hw_tile):
    """``parallel_tiled_decode`` over a mesh of every rank."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
    from ltx_video_gpupoor_tpu_torch.models.ltx.vae_tiling import (
        parallel_tiled_decode,
    )

    vae = tvae.CausalVAEDecoder(tvae.VAEConfig.from_dict(vae_dict),
                                FP32_POLICY)
    vae.load_state_dict(_sd(vae_np))
    return _np(parallel_tiled_decode(_mesh(sp=world), vae, _t(z),
                                     z_tile=z_tile, hw_tile=hw_tile))


def wan_decode(rank, world, vae_kw, vae_np, z, tile_size):
    """``parallel_spatial_tiled_decode`` over a mesh of every rank."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv

    vae = twv.WanVAEDecoder(twv.WanVAEConfig(**vae_kw), FP32_POLICY)
    vae.load_state_dict(_sd(vae_np))
    return _np(twv.parallel_spatial_tiled_decode(
        _mesh(sp=world), vae, _t(z), tile_size=tile_size))


# ---- serving --------------------------------------------------------------


def served_request(rank, world, out_dir, body, fail_on_rank=None):
    """The demo model served over sp = world: rank 0's stdlib server takes
    ``POST /`` three times over a socket, the other ranks follow; with
    ``fail_on_rank`` that rank raises in the second request. Rank 0
    returns the (status, payload) of each request and whether the first
    video landed; the others return how many requests they ran."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from ltx_video_gpupoor_tpu_torch.serving import model_zoo
    from ltx_video_gpupoor_tpu_torch.serving import server as tserver

    model = model_zoo.build_demo_model(0, device="cpu")
    model_zoo.apply_serving_mesh(model.generator.pipeline, _mesh(sp=world))
    # the warm-up on a mesh is served_warmup's
    svc = tserver.InferenceService(model=model, outputs_dir=out_dir,
                                   warmup_spec="off")
    assert svc.channel is not None and svc._warmup_thread is None
    if rank != 0:
        calls = []
        produce = svc._produce

        def planted(data):
            calls.append(1)
            if rank == fail_on_rank and len(calls) == 2:
                # before its first collective: rank 0 waits in one until
                # the group's timeout
                raise RuntimeError(f"planted follower failure on {rank}")
            return produce(data)
        svc._produce = planted
        svc.follow()
        return len(calls)
    httpd = tserver.create_stdlib_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    root = f"http://127.0.0.1:{httpd.server_address[1]}"
    answers = []
    try:
        for _ in range(3):
            req = urllib.request.Request(
                root + "/", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=100) as resp:
                    answers.append((resp.status, json.loads(resp.read())))
            except urllib.error.HTTPError as e:
                answers.append((e.code, json.loads(e.read())))
    finally:
        svc.stop()
        httpd.shutdown()
        httpd.server_close()
    name = answers[0][1][0]["video"].rsplit("/", 1)[-1]
    return answers, os.path.getsize(os.path.join(out_dir, name)) > 0


def served_warmup(rank, world, out_dir, body, spec, fail=False):
    """The demo model served over sp = world with the warm-up ``spec``
    (``LTXV_TPU_WARMUP``'s form): rank 0 waits for its warm-up thread,
    then takes ``POST /`` once over a socket; with ``fail`` the follower
    raises after its first warm-up generation. Rank 0 returns whether a
    warm-up thread started, the warm-up counters of ``Metrics`` and the
    request's (status, payload); a follower returns what it ran, in
    order: ``("warmup", (W, H, F))`` or ``"request"``."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from ltx_video_gpupoor_tpu_torch.serving import model_zoo
    from ltx_video_gpupoor_tpu_torch.serving import server as tserver
    from ltx_video_gpupoor_tpu_torch.utils.observability import Metrics

    model = model_zoo.build_demo_model(0, device="cpu")
    model_zoo.apply_serving_mesh(model.generator.pipeline, _mesh(sp=world))
    svc = tserver.InferenceService(model=model, outputs_dir=out_dir,
                                   warmup_spec=spec)
    if rank != 0:
        assert svc._warmup_thread is None
        ran = []
        serve = svc._serve

        def recorded(message):
            out = serve(message)
            kind, payload = message
            ran.append((kind, tuple(payload)) if kind == "warmup" else kind)
            if fail and kind == "warmup":
                raise RuntimeError(f"planted warm-up failure on {rank}")
            return out
        svc._serve = recorded
        svc.follow()
        return ran
    started = svc._warmup_thread is not None
    if started:
        svc._warmup_thread.join(timeout=100)
        assert not svc._warmup_thread.is_alive(), "the warm-up hangs"
    counters = {k: v for k, v in Metrics.snapshot()["counters"].items()
                if k.startswith("warmup")}
    httpd = tserver.create_stdlib_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    req = urllib.request.Request(
        f"http://127.0.0.1:{httpd.server_address[1]}/",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        try:
            with urllib.request.urlopen(req, timeout=100) as resp:
                answer = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            answer = (e.code, json.loads(e.read()))
    finally:
        svc.stop()
        httpd.shutdown()
        httpd.server_close()
    return started, counters, answer


def cli_on_ranks(rank, world, out_path):
    """``cli.main`` on every rank under ``LTXV_TPU_MESH=dp1,sp<world>,tp1``
    (--demo on the CPU): what each rank's ``main`` returns, and whether
    the mesh reached the pipeline."""
    from ltx_video_gpupoor_tpu_torch.serving import cli

    os.environ["LTXV_TPU_MESH"] = f"dp1,sp{world},tp1"
    seen = []
    from ltx_video_gpupoor_tpu_torch.serving import model_zoo

    apply = model_zoo.apply_serving_mesh

    def spy(pipe, mesh=None):
        out = apply(pipe, mesh)
        seen.append(pipe.sp_mesh is not None and pipe.mesh.size() == world)
        return out
    model_zoo.apply_serving_mesh = spy
    got = cli.main(["--demo", "--device", "cpu", "--prompt", "a fox",
                    "--height", "64", "--width", "64", "--video-length", "9",
                    "--num-inference-steps", "2", "--output-path", out_path])
    return got, seen


def wan_df_pipeline(rank, world, cfg_kw, sd_np, vae_kw, ctx, cmask, noise,
                    kw):
    """``WanDFPipeline.generate`` (latents out) with ``sp_mesh`` at sp =
    world: the per-frame timestep rows shard with their frames."""
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv
    from ltx_video_gpupoor_tpu_torch.pipelines.wan_df import WanDFPipeline

    vae = twv.WanVAEDecoder(twv.WanVAEConfig(**vae_kw), FP32_POLICY)
    pipe = WanDFPipeline(_wan(cfg_kw, sd_np), vae, vae_stride=(4, 2, 2),
                         sp_mesh=_mesh(sp=world))
    out, logs = logged(lambda: pipe.generate(_t(ctx), _t(cmask),
                                             noise=_t(noise), **kw))
    return _np(out), logs
