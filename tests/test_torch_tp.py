"""Tensor parallelism (tp = 2) of the port against the JAX package on the
CPU: the LTX, Wan and T5 forwards with their weights cut by
``parallel/sharding.py`` against JAX's tp-sharded jit (XLA SPMD), in fp32
and (LTX, Wan) in the ``dynamic`` and ``mixed_int4`` tiers; the row-parallel int8
linear's codes against the unsharded quantize; and the port's counterpart
of ``ops/headpar.py`` (none needed: each rank's attention call sees its
``H/tp`` heads, and the joined result is the unsharded one).

Ranks are gloo processes (``core.mesh.spawn_ranks``, a ``FileStore`` under
``tmp_path``, a 120 s group timeout, one thread each) running
``tests/torch_mesh_workers.py``. Tolerances are JAX's
(tests/test_parallel.py): 2e-5 in fp32, 2e-2 in the quantized tiers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from ltx_video_gpupoor_tpu.core import mesh as jmesh
from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu.ops.rope import wan_rope_freqs
from ltx_video_gpupoor_tpu.parallel import sharding as jsh
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul
from test_torch_usp import _sd, spawn

FP32 = dict(atol=2e-5, rtol=2e-5)
QUANT = dict(atol=2e-2, rtol=2e-2)


def tp_mesh():
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, sp=1, tp=2),
                           devices=jax.devices()[:2])


def _placed(params, shardings):
    return jax.tree.map(jax.device_put, params, shardings)


LTX_KW = dict(num_attention_heads=4, attention_head_dim=32, in_channels=16,
              out_channels=16, num_layers=2, cross_attention_dim=64,
              caption_channels=32)


def _ltx_inputs(b=2, s=32, sc=8):
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((b, s, 16)).astype(np.float32)
    coords = np.tile(rng.uniform(0, 8, (1, 3, s)), (b, 1, 1)).astype(
        np.float32)
    t = np.full((b,), 0.4, np.float32)
    cap = rng.standard_normal((b, sc, 32)).astype(np.float32)
    cmask = np.ones((b, sc), np.int32)
    cmask[0, 6:] = 0
    return lat, coords, t, cap, cmask


@pytest.fixture(scope="module")
def ltx_params():
    return jax.jit(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**LTX_KW)))(jax.random.key(0))


def _ltx_ref(params, inputs, **kw):
    cfg = jtf.LTXTransformerConfig(**LTX_KW)
    lat, coords, t, cap, cmask = (jnp.asarray(a) for a in inputs)
    fn = jax.jit(lambda p: jtf.forward(p, cfg, lat, coords, t, cap, cmask,
                                       attn_mode="xla", **kw))
    return np.asarray(fn(_placed(
        params, jsh.transformer_param_shardings(tp_mesh(), params))))


@pytest.mark.parametrize("tier", [None, "dynamic", "mixed_int4"])
def test_tp_ltx_forward_matches_jax(tmp_path, ltx_params, tier):
    """q/k/v and FFN-in column-parallel, to_out and FFN-out row-parallel
    (the fp32 sum, the bias once; in ``dynamic`` the rows quantized by the
    all-reduced amax), the q/k RMS norms' sum of squares all-reduced."""
    params = ltx_params if tier is None else jq.quantize_params(
        ltx_params, mode=tier)
    inputs = _ltx_inputs()
    ref = _ltx_ref(params, inputs)
    outs = spawn(tmp_path, workers.tp_ltx, 2, LTX_KW, _sd(params), inputs,
                 dict(attn_mode="xla"), tier)
    for out in outs:           # every rank holds the whole velocity
        np.testing.assert_allclose(out, ref, **(FP32 if tier is None
                                                else QUANT))


def test_tp_ltx_stg_attention_skip_matches_jax(tmp_path, ltx_params):
    """AttentionSkip mixes the normed input into the attention output
    before ``to_out``: a tp rank mixes its slice of it."""
    inputs = _ltx_inputs()
    skip = np.ones((2, 2), np.float32)
    skip[1, 1] = 0.0
    ref = _ltx_ref(ltx_params, inputs, skip_layer_mask=jnp.asarray(skip),
                   skip_layer_strategy="attention_skip")
    outs = spawn(tmp_path, workers.tp_ltx, 2, LTX_KW, _sd(ltx_params),
                 inputs, dict(attn_mode="xla", skip_layer_mask=skip,
                              skip_layer_strategy="attention_skip"))
    for out in outs:
        np.testing.assert_allclose(out, ref, **FP32)


@pytest.mark.parametrize("mode,kernel", [("pallas", "flash_attention"),
                                         ("pallas_hp", "flash_attention_hp")])
def test_tp_attention_runs_local_heads(tmp_path, mode, kernel):
    """The port's counterpart of JAX's
    ``test_headpar_attention_matches_unsharded``: ``ops/headpar.py`` has
    none, because under explicit tensor parallelism each rank's attention
    already runs its own heads. Every kernel call of a tp = 2 rank sees
    ``H/2`` heads (K6 on the packed ``[B, S, (H/2)·D]`` under
    ``pallas_hp``, K1 on split heads otherwise), and the joined result
    equals the unsharded forward."""
    # K6 serves head dims 64 and 128
    cfg_kw = dict(LTX_KW, attention_head_dim=64)
    params = jax.jit(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**cfg_kw)))(jax.random.key(0))
    inputs = _ltx_inputs()
    want = _unsharded_ltx(cfg_kw, params, inputs, mode)
    outs = spawn(tmp_path, workers.tp_ltx, 2, cfg_kw, _sd(params),
                 inputs, dict(attn_mode=mode), None, True)
    heads = LTX_KW["num_attention_heads"]
    for out, seen in outs:
        np.testing.assert_allclose(out, want, **FP32)
        self_attn = [h for name, h in seen if name == kernel]
        assert self_attn and all(h == heads // 2 for _, h in seen), seen


def _unsharded_ltx(cfg_kw, params, inputs, mode):
    model = workers._ltx(cfg_kw, _sd(params))
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in inputs),
                     attn_mode=mode).numpy()


WAN_KW = dict(dim=128, ffn_dim=256, num_heads=4, num_layers=2, text_dim=64,
              in_dim=4, out_dim=4, freq_dim=32, text_len=8,
              patch_size=(1, 2, 2), model_type="t2v")


@pytest.mark.parametrize("tier", [None, "dynamic", "mixed_int4"])
def test_tp_wan_forward_matches_jax(tmp_path, tier):
    """Wan's q/k/v column-parallel and ``o`` / ``fc2`` row-parallel, the
    ``norm_q`` / ``norm_k`` sums of squares all-reduced."""
    cfg = jwm.WanConfig(**WAN_KW)
    params = jax.jit(lambda k: jwm.init_params(k, cfg))(jax.random.key(0))
    if tier:
        params = jq.quantize_params(params, mode=tier)
    rng = np.random.default_rng(1)
    f, h, w = 2, 4, 4
    x = rng.standard_normal((1, f, h, w, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 64)).astype(np.float32)
    cmask = np.ones((1, 8), np.int32)
    t = np.full((1,), 500.0, np.float32)
    cos, sin = (np.asarray(a) for a in wan_rope_freqs((f, h // 2, w // 2),
                                                      cfg.head_dim))
    fn = jax.jit(lambda p: jwm.forward(
        p, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(cmask), (jnp.asarray(cos), jnp.asarray(sin)),
        attn_mode="xla")[0])
    ref = np.asarray(fn(_placed(params, jsh.wan_param_shardings(
        tp_mesh(), params))))
    outs = spawn(tmp_path, workers.tp_wan, 2, WAN_KW, _sd(params),
                 (x, t, ctx, cmask, cos, sin), dict(attn_mode="pallas"),
                 tier)
    for out in outs:
        np.testing.assert_allclose(out, ref, **(FP32 if tier is None
                                                else QUANT))


T5_KW = dict(vocab_size=100, dim=128, dim_attn=128, dim_ffn=256,
             num_heads=4, num_layers=2)


@pytest.mark.parametrize("shared_pos", [False, True])
def test_tp_t5_encode_matches_jax(tmp_path, shared_pos):
    """T5 / UMT5 over tp = 2: heads and FFN hidden split, the relative
    position bias tables cut to each rank's heads (fp32: JAX's encode
    reads dense kernels only)."""
    cfg = jt5.T5Config(**T5_KW, shared_pos=shared_pos)
    params = jt5.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    ref = np.asarray(jt5.encode(
        _placed(params, jsh.t5_param_shardings(tp_mesh(), params)), cfg,
        jnp.asarray(ids), jnp.asarray(mask)))
    outs = spawn(tmp_path, workers.tp_t5, 2, dict(T5_KW,
                                                  shared_pos=shared_pos),
                 _sd(params), ids, mask)
    for out in outs:
        np.testing.assert_allclose(out, ref, **FP32)


@pytest.mark.parametrize("k", [64, 96])
def test_row_parallel_int8_codes_equal_unsharded(tmp_path, k):
    """Each rank's codes of its half of a row, against the scale of the
    whole row (the amax all-reduced with MAX), are exactly the unsharded
    quantize's codes of that half; the summed output is the unsharded
    K2's within the fp32 rounding of a sum of two partial products."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 3, k)) * rng.uniform(0.1, 4, (5, 3, 1))
         ).astype(np.float32)
    w = rng.standard_normal((24, k)).astype(np.float32)
    q = int8_matmul.quantize_rows_plain(torch.from_numpy(w))
    w_int8, w_scale = q[0], q[1].reshape(-1)
    bias = rng.standard_normal(24).astype(np.float32)
    want_codes, _ = int8_matmul.quantize_rows_plain(
        torch.from_numpy(x).reshape(-1, k))
    want = int8_matmul.int8_linear_plain(torch.from_numpy(x), w_int8,
                                         w_scale, torch.from_numpy(bias))
    outs = spawn(tmp_path, workers.row_parallel_codes, 2, x, w_int8.numpy(),
                 w_scale.numpy(), bias)
    half = k // 2
    for r, (codes, y) in enumerate(outs):
        np.testing.assert_array_equal(
            codes, want_codes[:, r * half:(r + 1) * half].numpy())
        np.testing.assert_allclose(y, want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_row_parallel_int8_output_equals_unsharded_bit_for_bit(tmp_path,
                                                               world):
    """The ranks sum their exact int32 accumulators, as XLA's SPMD sums the
    int8 dot's int32 partials, and K2's epilogue runs once on the sum: the
    row-parallel output is the unsharded K2's bit for bit (a sum of the
    ranks' fp32 partial products is not: it rounds each partial, and the
    partials cancel)."""
    rng = np.random.default_rng(5)
    k = 128
    x = (rng.standard_normal((6, 4, k)) * rng.uniform(0.1, 4, (6, 4, 1))
         ).astype(np.float32)
    w = rng.standard_normal((40, k)).astype(np.float32)
    w_int8, w_scale = int8_matmul.quantize_rows_plain(torch.from_numpy(w))
    w_scale = w_scale.reshape(-1)
    bias = rng.standard_normal(40).astype(np.float32)
    want = int8_matmul.int8_linear_plain(torch.from_numpy(x), w_int8,
                                         w_scale, torch.from_numpy(bias))
    outs = spawn(tmp_path, workers.row_parallel_codes, world, x,
                 w_int8.numpy(), w_scale.numpy(), bias)
    for _, y in outs:
        np.testing.assert_array_equal(y, want.numpy())


def test_scaled_k2_plain_is_k2_at_its_own_scale():
    """K2's given-scale entry (plain version, as the CPU runs it) handed
    the scale K2 computes gives K2's result bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((7, 40)).astype(np.float32))
    w, sw = int8_matmul.quantize_rows_plain(torch.from_numpy(
        rng.standard_normal((9, 40)).astype(np.float32)))
    _, sx = int8_matmul.quantize_rows_plain(x)
    got = int8_matmul.int8_linear_scaled(x, sx.reshape(-1), w,
                                         sw.reshape(-1))
    want = int8_matmul.int8_linear_plain(x, w, sw.reshape(-1))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="s_x"):
        int8_matmul.int8_linear_scaled(x, sx, w, sw.reshape(-1))
