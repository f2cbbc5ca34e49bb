"""K2 at any K and the row quantizer's two contracts against the JAX package.

JAX's dynamic-int8 chain (``ltx_video_gpupoor_tpu/ops/quant.py:190-206``)
and its fused adaLN tier take any K. The port's plain K2 does too: at K =
40 and K = 1000 its int8 codes and int32 accumulator equal those of JAX's
arithmetic exactly and its output agrees with ``int8_dynamic_matmul`` at
the K2 tolerance (``tests/test_int8_matmul.py``: 2e-2). The fused tier
(K5) at such a K agrees with JAX's ``apply_fused`` in interpret mode
within the JAX package's own 5e-2 (its kernel may keep the modulation's
last bf16 sum in fp32). The attention tiers' quantize prologue (Q codes
and scales, the QK tier's per-row K codes and scales) equals, bit for
bit, what the JAX package's own jitted ``flash_attention`` hands its
Pallas call, on contiguous and head-split operands. The CUDA kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import functools
from unittest import mock


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import fused_prologue as jfp
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as tfp
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as tim
from ltx_video_gpupoor_tpu_torch.ops import quant as tq

INT8_TOL = 2e-2             # tests/test_int8_matmul.py:28-47
FUSED_TOL = 5e-2            # tests/test_fused_prologue.py


def _jax_codes(x):
    """``quant.py:196-198`` as JAX computes it: (x_q int8, x_scale)."""
    xf = jnp.asarray(x, jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0,
                    1e-8)
    return np.asarray(jnp.clip(jnp.round(xf / s), -127, 127)
                      .astype(jnp.int8)), np.asarray(s)


@pytest.mark.parametrize("m,k,n", [(5, 40, 24), (33, 1000, 72),
                                   (3, 1, 16)])
def test_k2_plain_takes_any_k_as_jax(m, k, n):
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    x[1 % m] = 0.0            # s_x floors at 1e-8
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ql = jq.quantize_weights(jnp.asarray(w))
    ref = jq.int8_dynamic_matmul(jnp.asarray(x), ql, jnp.asarray(b))
    w8 = torch.from_numpy(np.asarray(ql.w_int8).T.copy())
    out = tim.int8_linear(torch.from_numpy(x), w8,
                          torch.from_numpy(np.array(ql.scale)),
                          torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=INT8_TOL,
                               rtol=INT8_TOL)
    # the codes, the scales and the int32 accumulator are JAX's exactly
    jx, js = _jax_codes(x)
    xq, s = tim.quantize_rows_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), jx)
    np.testing.assert_array_equal(s.numpy(), js)
    acc = tim.int8_gemm_acc_plain(xq, w8)
    np.testing.assert_array_equal(
        acc.numpy(), jx.astype(np.int64) @ np.asarray(ql.w_int8, np.int64))


@pytest.mark.parametrize("k,groups", [(40, 2), (24, 1), (1000, 2)])
def test_fused_tier_at_any_k_equals_jax(k, groups):
    """bf16 activations at a K that is not a 16-multiple, q/k/v side by
    side with biases, as the DiT calls it: K5's plain version agrees with
    JAX's ``apply_fused``."""
    rng = np.random.default_rng(11)
    b, s = 2, 32
    x = rng.standard_normal((b, s, k)).astype(np.float32)
    sc = (rng.standard_normal((b, groups, k)) * 0.1).astype(np.float32)
    sh = (rng.standard_normal((b, groups, k)) * 0.1).astype(np.float32)
    ws = [rng.standard_normal((k, 128)).astype(np.float32) * k ** -0.5
          for _ in range(3)]
    bs = [rng.standard_normal(128).astype(np.float32) * 0.1 for _ in range(3)]
    jlins = []
    tlins = []
    for w, bias in zip(ws, bs):
        jw = jq.quantize_weights(jnp.asarray(w, jnp.bfloat16))
        jlins.append({"w_int8_dyn": jw.w_int8, "scale": jw.scale,
                      "bias": jnp.asarray(bias)})
        lin = tq.Linear(k, 128)
        lin.weight.data.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.data.copy_(torch.from_numpy(bias))
        tq.quantize_params(lin, mode="dynamic")
        lin.w_int8_dyn.copy_(torch.from_numpy(np.asarray(jw.w_int8).T.copy()))
        lin.scale.copy_(torch.from_numpy(np.array(jw.scale)))
        tlins.append(lin)
    ref = jfp.apply_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc),
                          jnp.asarray(sh), jlins, eps=1e-6, interpret=True)
    out = tfp.apply_fused(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(sc), torch.from_numpy(sh), tlins,
                          eps=1e-6)
    assert out.shape == (b, s, 384) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=FUSED_TOL, rtol=FUSED_TOL)


def _jax_package_prologue(q, k):
    """The QK tier's operands as the JAX package's own jitted
    ``flash_attention`` hands them to its Pallas call (the prologue,
    ``ltx_video_gpupoor_tpu/ops/flash_attention.py:484-505``, compiled by
    XLA with the softmax scale a Python constant, as the package runs it):
    ``(q8, q_scale, k8, k_scale)``, read back by a host callback that
    stands in for the Pallas call."""
    got = {}

    def pallas_call(kernel, *, out_shape, **_):
        def call(*args):
            jax.debug.callback(lambda *a: got.update(args=a), *args)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call

    # a fresh jit of the undecorated function, so that no trace cached by
    # another test runs in place of this one
    fa = jax.jit(functools.partial(jfa.flash_attention.__wrapped__,
                                   qk_int8=True))
    with mock.patch.object(jfa.pl, "pallas_call", pallas_call):
        jax.block_until_ready(fa(q, k, k))
        jax.effects_barrier()
    q8, k8, _, q_scale, k_scale = (np.asarray(t) for t in got["args"])
    return q8, q_scale[:, :, 0], k8, k_scale[:, :, 0]


@pytest.mark.parametrize("d,packed", [(64, False), (128, True), (64, True)])
def test_prologue_rows_equal_jax(d, packed):
    """Q's codes and scales (the softmax scale times log2(e) folded in) and
    the QK tier's per-row K codes and scales, on bf16 operands, some rows
    all zero (the 1e-6 floor); head-split views of a ``[B, S, H*D]``
    projection read as they lie. XLA folds ``/ 127`` and ``scale * log2
    e`` into one constant: the unfolded product is another float in some
    rows, so the check tells the two apart."""
    rng = np.random.default_rng(d)
    b, h, sq, skv = 2, 3, 128, 256
    arrays = []
    for n in (sq, skv):
        a = (rng.standard_normal((b, n, h * d)) * rng.uniform(
            0.1, 8, (b, n, 1))).astype(np.float32)
        a[0, 1] = 0.0
        arrays.append(a)
    qn, kn = arrays
    q, k = (torch.from_numpy(a).bfloat16().view(b, -1, h, d).transpose(1, 2)
            for a in (qn, kn))
    if not packed:
        q, k = q.contiguous(), k.contiguous()
    ops = tfa.int8_prologue(q, k, k, pv_int8=False)
    jq8, jqs, jk8, jks = _jax_package_prologue(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), jnp.bfloat16))
    amax = np.abs(q.float().numpy()).max(axis=-1)
    unfolded = (np.maximum(amax, np.float32(1e-6)) / np.float32(127.0)
                * np.float32(d ** -0.5 * tfa.LOG2E))
    assert not np.array_equal(unfolded, jqs)
    np.testing.assert_array_equal(ops.q8.numpy(), jq8)
    np.testing.assert_array_equal(ops.q_scale.numpy(), jqs)
    np.testing.assert_array_equal(ops.k8.numpy(), jk8)
    spad = tfa.round_up(skv, tfa.K4_TILE_KV)
    assert ops.k_scale.shape == (b, h, spad) and ops.k_block == 1
    np.testing.assert_array_equal(ops.k_scale[..., :skv].numpy(), jks)
    assert not ops.k_scale[..., skv:].any()
    # the plain prologue is the CPU route of the wrapper
    plain = tfa.int8_prologue_plain(q, k, k, pv_int8=False)
    for name in ("q8", "q_scale", "k8", "k_scale"):
        assert torch.equal(getattr(ops, name), getattr(plain, name)), name
