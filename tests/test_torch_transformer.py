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
        quantize_params(model)
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
    quantize_params(mine)
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
