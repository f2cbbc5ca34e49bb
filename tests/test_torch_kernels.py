"""Kernels K1 (attention) and K2 (dynamic int8) against the JAX package.

On the CPU the wrappers take their plain versions; those are held against
the JAX functions the Pallas kernels are held against in
tests/test_flash_attention.py and tests/test_int8_matmul.py, at the same
tolerances: 2e-5 for fp32 attention, 2e-2 for the int8 linear. The CUDA
kernels themselves are compared with the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import int8_matmul as jim
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as tim
from ltx_video_gpupoor_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

ATOL = RTOL = 2e-5          # tests/test_flash_attention.py:26
INT8_TOL = 2e-2             # tests/test_int8_matmul.py:28-47


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv", [(128, 128), (256, 384)])
def test_k1_plain_matches_pallas_interpret(sq, skv):
    q, k, v = _qkv(0, 2, 2, sq, skv, 64)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              interpret=True)
    out = tfa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_k1_plain_segments_and_fully_masked_rows():
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _qkv(1, b, h, s, s, d)
    seg = np.zeros((b, s), np.int32)
    seg[0, :200] = 1
    seg[1, :100] = 1
    seg[1, 100:180] = 2
    ref = jfa.reference_attention(*map(jnp.asarray, (q, k, v, seg, seg)))
    pal = jfa.flash_attention(*map(jnp.asarray, (q, k, v, seg, seg)),
                              interpret=True)
    out = tfa.flash_attention(*_t(q, k, v, seg, seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL,
                               rtol=RTOL)
    # padding rows see no key: exactly zero, not NaN
    np.testing.assert_array_equal(out[0, :, 200:].numpy(), 0.0)


def test_k1_plain_cross_attention_kv_mask():
    """The DiT's cross-attention: q ids all 1, kv ids from the T5 mask."""
    b, h, sq, skv, d = 2, 2, 300, 77, 32
    q, k, v = _qkv(2, b, h, sq, skv, d)
    q_seg = np.ones((b, sq), np.int32)
    q_seg[1, 10] = 3           # a row that matches no key
    kv_seg = np.ones((b, skv), np.int32)
    kv_seg[0, 50:] = 0
    ref = jfa.reference_attention(*map(jnp.asarray,
                                       (q, k, v, q_seg, kv_seg)))
    out = tattn.attention(*_t(q, k, v, q_seg, kv_seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(out[1, :, 10].numpy(), 0.0)


def test_k1_plain_causal_and_kv_valid():
    b, h, s, d = 1, 2, 384, 64
    q, k, v = _qkv(3, b, h, s, s, d)
    jq_, jk, jv = map(jnp.asarray, (q, k, v))
    ref = jfa.flash_attention(jq_, jk, jv, causal=True, interpret=True)
    out = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    ref = jfa.flash_attention(jq_, jk, jv, kv_valid=300, block_q=128,
                              block_kv=128, causal=True, interpret=True)
    out = tfa.flash_attention(*_t(q, k, v), kv_valid=300, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_attention_packed_matches_jax():
    from ltx_video_gpupoor_tpu.ops.attention import attention_packed

    rng = np.random.default_rng(4)
    b, s, heads, d = 2, 200, 4, 64
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
               for _ in range(3))
    ref = attention_packed(*map(jnp.asarray, (q, k, v)), heads, mode="xla")
    out = tattn.attention_packed(*_t(q, k, v), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mode,entry", [
    ("pallas_int8", "K4"), ("pallas_int8pv", "K4"), ("pallas_hp", "K6"),
    ("ulysses:sp", "step 16"), ("xla", "reference_attention")])
def test_unported_attention_tiers_raise(mode, entry):
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(NotImplementedError, match=entry):
        tattn.attention(q, q, q, mode=mode)
    with pytest.raises(NotImplementedError, match="K3"):
        tattn.attention(q, q, q, score_bound=40.0)


def test_k1_rejects_kv_only_segments():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_attention(q, q, q, None, torch.ones(1, 8, dtype=torch.int32))


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------

def _w_x(seed, m, k, n, zero_row=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if zero_row:
        x[1] = 0.0             # s_x floors at 1e-8: the row must come out 0
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, b


def test_quantize_weights_bitwise_equal_jax():
    _, w, _ = _w_x(5, 4, 256, 96)
    jql = jq.quantize_weights(jnp.asarray(w))
    tql = tq.quantize_weights(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tql.w_int8.numpy(), np.asarray(jql.w_int8).T)
    np.testing.assert_array_equal(tql.scale.numpy(), np.asarray(jql.scale))


@pytest.mark.parametrize("m,k,n", [(3, 256, 512), (130, 512, 384),
                                   (64, 48, 40)])
def test_k2_plain_matches_jax_dynamic_path(m, k, n):
    x, w, b = _w_x(6, m, k, n)
    ql = jq.quantize_weights(jnp.asarray(w))
    ref = jq.int8_dynamic_matmul(jnp.asarray(x), ql, jnp.asarray(b))
    w8 = torch.from_numpy(np.asarray(ql.w_int8).T.copy())
    sw = torch.from_numpy(np.array(ql.scale))
    out = tim.int8_linear(torch.from_numpy(x), w8, sw, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=INT8_TOL,
                               rtol=INT8_TOL)
    np.testing.assert_allclose(out[1].numpy(), b, atol=1e-6)
    # the int32 accumulator of the plain version is exact
    xq, _ = tim.quantize_rows_plain(torch.from_numpy(x))
    acc = tim.int8_gemm_acc_plain(xq, w8)
    np.testing.assert_array_equal(
        acc.numpy(), xq.numpy().astype(np.int64) @ w8.numpy().T.astype(np.int64))


def test_k2_plain_matches_pallas_interpret_bf16():
    x, w, _ = _w_x(7, 130, 256, 1024, zero_row=False)
    xb = jnp.asarray(x, jnp.bfloat16)
    ql = jq.quantize_weights(jnp.asarray(w, jnp.bfloat16))
    ref = jim.int8_dynamic_matmul_fused(xb, ql.w_int8, ql.scale,
                                        interpret=True, block_m=128,
                                        block_n=256)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    out = tim.int8_linear(xt, torch.from_numpy(np.asarray(ql.w_int8).T.copy()),
                          torch.from_numpy(np.array(ql.scale)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=INT8_TOL, rtol=INT8_TOL)


def test_linear_tiers_dispatch():
    x, w, b = _w_x(8, 5, 64, 32, zero_row=False)
    lin = tq.Linear(64, 32)
    lin.weight.data.copy_(torch.from_numpy(w.T.copy()))
    lin.bias.data.copy_(torch.from_numpy(b))
    dense = lin(torch.from_numpy(x))
    np.testing.assert_allclose(dense.numpy(), x @ w + b, atol=1e-5, rtol=1e-5)
    tq.quantize_params(lin)
    assert lin.quantized and not hasattr(lin, "weight")
    ref = jq.maybe_quantized_matmul(
        jq.quantize_params({"l": {"kernel": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}},
                           mode="dynamic")["l"], jnp.asarray(x))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=INT8_TOL, rtol=INT8_TOL)
    with pytest.raises(NotImplementedError, match="step 12"):
        tq.quantize_params(tq.Linear(16, 16), mode="wo")


def test_k2_rejects_bad_operands():
    w8 = torch.zeros(32, 40, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 16"):
        tim.int8_linear(torch.zeros(3, 40), w8, torch.ones(32))
    w8 = torch.zeros(32, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tim.int8_linear(torch.zeros(3, 48, dtype=torch.float64), w8,
                        torch.ones(32))
