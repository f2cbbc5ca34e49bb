"""The weight-only int8 and int4 tiers and the mixed tier of the port
against the JAX package, on the CPU.

The codes and scales of ``quantize_weights`` / ``quantize_weights_int4``
are held bit for bit against JAX's (the port stores torch's ``[out, in]``,
so its packed int4 bytes and group scales are JAX's transposed), every
tier of ``maybe_quantized_matmul`` against JAX's on the same inputs, the
set of leaves the mixed tier keeps in int8 against JAX's on an LTX tree
and a Wan i2v tree, and the LTX text-to-video slice in each tier against
JAX's same tier at the oracle bar (PARITY.md): >= 40 dB PSNR on latents
and frames. The weight-only tiers are XLA chains in JAX, no Pallas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.core.params import flatten
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.wan import model as jwm
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
from ltx_video_gpupoor_tpu_torch.ops import quant as tq
from ltx_video_gpupoor_tpu_torch.serving import cli as tcli

from test_torch_pipeline import _np_tree, _psnr, _run, weights  # noqa: F401

torch.set_num_threads(2)

PSNR_BAR_DB = 40.0


def _weights(din, dout, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((din, dout))
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# codes and scales
# --------------------------------------------------------------------------

def test_int8_wo_codes_and_scales_bit_equal_jax():
    w = _weights(96, 40)
    w[:, 3] = 0.0                          # a zero channel: the 1e-8 floor
    ref = jq.quantize_weights(jnp.asarray(w))
    out = tq.quantize_weights(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(out.w_int8.numpy(), np.asarray(ref.w_int8).T)
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("din,group", [(128, 64), (96, 64), (64, None),
                                       (40, 8)],
                         ids=["groups", "channel_fallback", "no_groups",
                              "group8"])
def test_int4_codes_and_scales_bit_equal_jax(din, group):
    """Per-group scales where ``in`` splits into groups, else per channel;
    the -8 code is reached (a column whose largest magnitude is negative
    rounds to -7.5 / scale -> -8)."""
    w = _weights(din, 24, seed=din)
    w[5, 0] = -np.abs(w[:, 0]).max() * 1.5   # the absmax is negative
    ref = jq.quantize_weights_int4(jnp.asarray(w), group_size=group)
    out = tq.quantize_weights_int4(torch.from_numpy(w.T.copy()),
                                   group_size=group)
    np.testing.assert_array_equal(out.w_int4.numpy(), np.asarray(ref.w_int4).T)
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale).T)
    codes = tq.unpack_int4(out.w_int4).numpy()
    np.testing.assert_array_equal(codes, np.asarray(jq.unpack_int4(
        ref.w_int4)).T)
    assert codes.min() == -8 and codes.max() <= 7
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize_int4(out, dtype).float().numpy(),
            np.asarray(jq.dequantize_int4(ref, jdt).astype(jnp.float32)).T)


def test_unpack_int4_every_byte_equals_jax():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(256, 1)
    ref = np.asarray(jq.unpack_int4(jnp.asarray(packed)))   # [512, 1]
    out = tq.unpack_int4(torch.from_numpy(packed.T.copy())).numpy()  # [1, 512]
    np.testing.assert_array_equal(out, ref.T)
    assert sorted(set(out.ravel())) == list(range(-8, 8))


# --------------------------------------------------------------------------
# maybe_quantized_matmul, tier by tier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "dynamic", "wo", "wo_int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_maybe_quantized_matmul_matches_jax(mode, dtype):
    w = _weights(128, 48, seed=1, scale=128 ** -0.5)
    bias = _weights(1, 48, seed=2)[0]
    x = _weights(10, 128, seed=3)
    jp = {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}
    if mode != "dense":
        jp = jq.quantize_params({"l": jp}, mode=mode)["l"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jq.maybe_quantized_matmul(
        jp, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    lin = tq.Linear(128, 48)
    if mode != "dense":
        lin.quantize_(mode)
    lin.load_state_dict(from_jax.state_dict(_np_tree(jp)))
    assert lin.mode == (None if mode == "dense" else mode)
    out = lin(torch.from_numpy(x).to(dtype)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:   # one bf16 rounding of the output apart at most
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-2)


def test_quantize_params_modes_and_refusals():
    lin = tq.Linear(64, 8)
    with pytest.raises(ValueError, match="mode"):
        tq.quantize_params(lin, mode="int3")
    with pytest.raises(ValueError, match="even"):
        tq.quantize_weights_int4(torch.zeros(4, 7))
    tq.quantize_params(lin)                # JAX's default mode: "wo"
    assert lin.mode == "wo" and tuple(lin.w_int8.shape) == (8, 64)
    tq.quantize_params(lin, mode="wo_int4")   # already quantized: kept
    assert lin.mode == "wo"


# --------------------------------------------------------------------------
# the mixed tier's leaves
# --------------------------------------------------------------------------

def _int8_leaves_jax(tree):
    return {k.removesuffix(".w_int8") + ".kernel"
            for k in flatten(jq.quantize_params(tree, mode="mixed_int4"))
            if k.endswith(".w_int8")}


def _int8_leaves_port(model):
    tq.quantize_params(model, mode="mixed_int4")
    modes = {tq.jax_path(n): m.mode for n, m in model.named_modules()
             if isinstance(m, tq.Linear)}
    assert set(modes.values()) == {"wo", "wo_int4"}
    return {p for p, m in modes.items() if m == "wo"}


LTX_MIXED_KW = dict(num_attention_heads=2, attention_head_dim=16,
                    in_channels=16, out_channels=16, num_layers=2,
                    cross_attention_dim=32, caption_channels=32)
WAN_I2V_KW = dict(model_type="i2v", patch_size=(1, 2, 2), text_len=16,
                  in_dim=12, dim=64, ffn_dim=128, freq_dim=32, text_dim=32,
                  out_dim=4, num_heads=2, num_layers=2)


def test_mixed_int4_keeps_the_leaves_jax_keeps():
    jtree = jax.eval_shape(lambda k: jtf.init_params(
        k, jtf.LTXTransformerConfig(**LTX_MIXED_KW)), jax.random.key(0))
    jtree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jtree)
    want = _int8_leaves_jax(jtree)
    got = _int8_leaves_port(ttf.LTXTransformer3D(
        ttf.LTXTransformerConfig(**LTX_MIXED_KW), FP32_POLICY))
    assert got == want and any("adaln" in p for p in want) \
        and "proj_out.kernel" in want
    jtree = jwm.init_params(jax.random.key(0), jwm.WanConfig(**WAN_I2V_KW))
    want = _int8_leaves_jax(jtree)
    got = _int8_leaves_port(twm.WanModel(twm.WanConfig(**WAN_I2V_KW),
                                         FP32_POLICY))
    assert got == want and "head.head.kernel" in want \
        and "time_projection.kernel" in want
    assert not any(p.startswith(("img_emb", "blocks.")) for p in want)


# --------------------------------------------------------------------------
# the LTX slice in each tier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["wo", "wo_int4", "mixed_int4"])
@pytest.mark.parametrize("output_type", ["latent", "pixels"])
def test_ltx_slice_in_weight_only_tiers_matches_jax(weights, tier,
                                                    output_type):
    ref, out = _run(weights, tier, output_type)
    assert out.shape == ref.shape
    if output_type == "pixels":
        assert out.dtype == np.uint8
        ref, out = (a.astype(np.float32) / 127.5 - 1 for a in (ref, out))
    assert np.isfinite(out).all()
    db = _psnr(ref, out)
    assert db >= PSNR_BAR_DB, f"{tier} {output_type} {db:.2f} dB"


def test_ltx_slice_bf16_policy_in_mixed_tier_matches_jax(weights):
    """The card's program (bf16 weights and activations) in the mixed
    tier, against JAX's fp32 program in the same tier."""
    ref, out = _run(weights, "mixed_int4", "latent", DEFAULT_POLICY)
    assert np.isfinite(out).all()
    assert _psnr(ref, out) >= PSNR_BAR_DB, f"{_psnr(ref, out):.2f} dB"


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["wo", "wo_int4", "mixed_int4"])
def test_cli_int8_mode_quantizes_in_that_tier(tmp_path, monkeypatch, mode):
    """``--quantize-transformer --int8-mode`` quantizes the demo DiT in
    the named tier (as the JAX CLI passes it to ``quantize_params``) and
    the request runs."""
    from ltx_video_gpupoor_tpu_torch.serving import model_zoo

    built = []
    make = model_zoo.build_demo_model
    monkeypatch.setattr(model_zoo, "build_demo_model",
                        lambda *a, **k: built.append(make(*a, **k))
                        or built[-1])
    out = str(tmp_path / "vid.mp4")
    path = tcli.main(["--prompt", "a cat", "--demo", "--device", "cpu",
                      "--height", "64", "--width", "64", "--video-length",
                      "9", "--num-inference-steps", "2", "--output-path",
                      out, "--quantize-transformer", "--int8-mode", mode])
    assert path == out
    dit = built[0].generator.pipeline.transformer
    modes = {m.mode for m in dit.modules() if isinstance(m, tq.Linear)}
    assert modes == ({"wo", "wo_int4"} if mode == "mixed_int4" else {mode})
