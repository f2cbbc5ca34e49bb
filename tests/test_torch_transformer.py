"""The port's Transformer3D against the JAX package, with the JAX weights
carried across by core/from_jax.py and the inputs made with numpy. Small
widths: 2 layers, 2 heads of d=16.

Tolerances: 1e-4 for fp32 programs (the same math summed in other
orders); 2e-2 for the int8_dynamic tier (the K2 tolerance of
tests/test_int8_matmul.py: a rounding flip in one activation code moves
an output by up to s_x * s_w * 127)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import DtypePolicy, FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

torch.set_num_threads(2)

FP32_TOL = 1e-4
INT8_TOL = 2e-2

TF_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=16,
             out_channels=16, num_layers=2, cross_attention_dim=32,
             caption_channels=32)

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_transformer(jparams, cfg_kw, policy=FP32_POLICY, quantized=False):
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**cfg_kw), policy)
    if quantized:
        quantize_params(model, mode="dynamic")
    model.load_state_dict(from_jax.state_dict(_np_tree(jparams)))
    return model


def _dit_inputs(seed=0, b=3, f=2, h=4, w=4, sc=6):
    rng = np.random.default_rng(seed)
    s = f * h * w
    lat = rng.standard_normal((b, s, 16)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                                indexing="ij")).reshape(3, -1)
    grid = np.broadcast_to(grid[None] * np.array([[[8 / 25]], [[32]], [[32]]]),
                           (b, 3, s)).astype(np.float32)
    t = rng.uniform(0.2, 1.0, (b, f)).astype(np.float32)
    cap = rng.standard_normal((b, sc, 32)).astype(np.float32)
    mask = np.ones((b, sc), np.int32)
    mask[0, 4:] = 0
    skip = np.ones((2, b), np.float32)
    skip[1, b - 1] = 0.0
    return lat, grid, t, cap, mask, skip


def _run_both(jparams, model, strategy, inputs):
    lat, grid, t, cap, mask, skip = inputs
    ref = jtf.forward(jparams, jtf.LTXTransformerConfig(**TF_KW),
                      *map(jnp.asarray, (lat, grid, t, cap, mask)),
                      skip_layer_mask=jnp.asarray(skip),
                      skip_layer_strategy=strategy)
    out = model(*map(torch.from_numpy, (lat, grid, t, cap, mask)),
                skip_layer_mask=torch.from_numpy(skip),
                skip_layer_strategy=strategy)
    return out.detach().numpy(), np.asarray(ref)


STRATEGIES = [ttf.SkipLayerStrategy.AttentionValues,
              ttf.SkipLayerStrategy.AttentionSkip,
              ttf.SkipLayerStrategy.Residual,
              ttf.SkipLayerStrategy.TransformerBlock]


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jax.random.key(0), jtf.LTXTransformerConfig(**TF_KW))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_transformer_bf16_params_matches_jax(jparams, strategy):
    """Dense tier with bf16 weights and fp32 activations on both sides."""
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    model = _port_transformer(
        jp, TF_KW, DtypePolicy(param_dtype=torch.bfloat16,
                               compute_dtype=torch.float32))
    out, ref = _run_both(jp, model, strategy, _dit_inputs())
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("strategy", STRATEGIES[:2])
def test_transformer_int8_dynamic_matches_jax(jparams, strategy):
    jp = jq.quantize_params(jparams, mode="dynamic")
    model = _port_transformer(jp, TF_KW, quantized=True)
    out, ref = _run_both(jp, model, strategy, _dit_inputs(1))
    np.testing.assert_allclose(out, ref, atol=INT8_TOL, rtol=INT8_TOL)
    # the port's own quantization of the fp32 weights gives the same codes
    mine = _port_transformer(jparams, TF_KW)
    quantize_params(mine, mode="dynamic")
    for (name, a), (_, b) in zip(sorted(model.state_dict().items()),
                                 sorted(mine.state_dict().items())):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_transformer_random_init_distribution():
    cfg = ttf.LTXTransformerConfig(**TF_KW)
    model = ttf.init_params(ttf.LTXTransformer3D(cfg, FP32_POLICY),
                            torch.Generator().manual_seed(0))
    w = model.blocks[0].ff.proj_in.weight
    assert abs(float(w.std()) * 32 ** 0.5 - 1) < 0.1
    assert float(model.blocks[0].attn1.to_q.bias.abs().max()) == 0.0


# --------------------------------------------------------------------------
# The tiers of the 13B block: head dim 128, per-group timesteps [B, G]
# --------------------------------------------------------------------------

TF128_KW = dict(num_attention_heads=2, attention_head_dim=128, in_channels=16,
                out_channels=16, num_layers=2, cross_attention_dim=256,
                caption_channels=32)


@pytest.fixture(scope="module")
def jparams128():
    return jtf.init_params(jax.random.key(3),
                           jtf.LTXTransformerConfig(**TF128_KW))


def _run_both_128(jparams, model, inputs, jax_kw, port_kw, cfg_extra=None,
                  strategy=ttf.SkipLayerStrategy.AttentionValues):
    lat, grid, t, cap, mask, skip = inputs
    jcfg = jtf.LTXTransformerConfig(**TF128_KW, **(cfg_extra or {}))
    ref = jtf.forward(jparams, jcfg,
                      *map(jnp.asarray, (lat, grid, t, cap, mask)),
                      skip_layer_mask=jnp.asarray(skip),
                      skip_layer_strategy=strategy, **jax_kw)
    out = model(*map(torch.from_numpy, (lat, grid, t, cap, mask)),
                skip_layer_mask=torch.from_numpy(skip),
                skip_layer_strategy=strategy, **port_kw)
    return out.detach().numpy(), np.asarray(ref)


@pytest.mark.parametrize("strategy", [ttf.SkipLayerStrategy.AttentionValues,
                                      ttf.SkipLayerStrategy.AttentionSkip])
def test_transformer_fused_prologue_matches_jax_fused(monkeypatch, jparams128,
                                                      strategy):
    """int8_dynamic with the fused adaLN prologue on in both packages
    (K5's plain version against the interpreted Pallas kernel), 16 rows a
    group. Under AttentionSkip the perturbed layer stays unfused in both.
    The port's fused forward also equals its unfused one to the same
    tolerance (INT8_TOL)."""
    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as tfp

    jp = jq.quantize_params(jparams128, mode="dynamic")
    model = _port_transformer(jp, TF128_KW, quantized=True)
    inputs = _dit_inputs(2)
    unfused = model(*map(torch.from_numpy, inputs[:5])).numpy()
    monkeypatch.setenv("LTXV_TPU_FUSED_PROLOGUE", "interpret")
    calls = []
    real = tfp.apply_fused
    monkeypatch.setattr(tfp, "apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out, ref = _run_both_128(jp, model, inputs, dict(attn_mode="xla"),
                             dict(attn_mode="pallas"), strategy=strategy)
    # two fused calls a layer, none in the layer that AttentionSkip perturbs
    skip_layers = 1 if strategy == ttf.SkipLayerStrategy.AttentionSkip else 0
    assert len(calls) == 2 * (2 - skip_layers)
    np.testing.assert_allclose(out, ref, atol=INT8_TOL, rtol=INT8_TOL)
    fused = model(*map(torch.from_numpy, inputs[:5])).numpy()
    np.testing.assert_allclose(fused, unfused, atol=INT8_TOL, rtol=INT8_TOL)


def test_transformer_fused_prologue_gates(monkeypatch, jparams128):
    """The gates of the JAX block: dense linears, a layer norm, a chunked
    FFN (the q/k/v half stays fused) and a group size off the 16-row grid
    each leave the fused tier."""
    import dataclasses

    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as tfp

    monkeypatch.setenv("LTXV_TPU_FUSED_PROLOGUE", "1")
    calls = []
    real = tfp.apply_fused
    monkeypatch.setattr(tfp, "apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    inputs = [torch.from_numpy(a) for a in _dit_inputs(2)[:5]]
    dense = _port_transformer(jparams128, TF128_KW)
    dense(*inputs)
    assert calls == []
    jp = jq.quantize_params(jparams128, mode="dynamic")
    for extra, want in ((dict(standardization_norm="layer_norm"), 0),
                        (dict(ffn_chunks=2), 2), (dict(), 4)):
        model = _port_transformer(jp, {**TF128_KW, **extra}, quantized=True)
        calls.clear()
        model(*inputs)
        assert len(calls) == want, extra
    calls.clear()
    odd = [torch.from_numpy(a) for a in _dit_inputs(2, h=3, w=4)[:5]]
    model(*odd)                                   # 12 rows a group
    assert calls == []


def test_transformer_bounded_scores_match_jax_bounded(monkeypatch,
                                                      jparams128):
    """``attention_score_bound`` in fp32: the port's bounded tier (K3's
    plain version) against the JAX forward through the Pallas kernel's
    bounded branch in interpret mode, and against the exact forward (the
    logits of this model lie within the bound)."""
    import functools

    from ltx_video_gpupoor_tpu.ops import attention as jattn
    from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True, block_q=128, block_kv=128))
    bounds = []
    real = tattn.flash_attention
    monkeypatch.setattr(
        tattn, "flash_attention",
        lambda *a, **k: bounds.append(k.get("score_bound")) or real(*a, **k))
    extra = dict(attention_score_bound=32.0)
    model = _port_transformer(jparams128, {**TF128_KW, **extra})
    inputs = _dit_inputs(4)
    out, ref = _run_both_128(jparams128, model, inputs,
                             dict(attn_mode="pallas"), dict(attn_mode="auto"),
                             cfg_extra=extra)
    assert bounds == [32.0] * 4          # self and cross, two layers
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)
    exact = _port_transformer(jparams128, TF128_KW)
    lat, grid, t, cap, mask, skip = inputs
    want = exact(*map(torch.from_numpy, (lat, grid, t, cap, mask)),
                 skip_layer_mask=torch.from_numpy(skip),
                 skip_layer_strategy=ttf.SkipLayerStrategy.AttentionValues,
                 attn_mode="pallas").numpy()
    np.testing.assert_allclose(out, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("chunks", [1, 3])
def test_transformer_head_packed_and_chunked_ffn_match_jax(monkeypatch,
                                                           jparams128,
                                                           chunks):
    """``pallas_hp`` (K6's plain version for the self-attention, the exact
    kernel's for the cross-attention) against the JAX exact forward, with
    the FFN whole and in 3 token chunks (32 tokens pad to 33)."""
    from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

    calls = []
    real = tattn.flash_attention_hp
    monkeypatch.setattr(tattn, "flash_attention_hp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    extra = dict(ffn_chunks=chunks)
    model = _port_transformer(jparams128, {**TF128_KW, **extra})
    out, ref = _run_both_128(jparams128, model, _dit_inputs(5),
                             dict(attn_mode="xla"),
                             dict(attn_mode="pallas_hp"), cfg_extra=extra)
    assert len(calls) == 2
    np.testing.assert_allclose(out, ref, atol=FP32_TOL, rtol=FP32_TOL)
