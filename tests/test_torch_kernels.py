"""Kernels K1 (attention), K2 (dynamic int8) and K4 (int8 attention)
against the JAX package.

On the CPU the wrappers take their plain versions; those are held against
the JAX functions the Pallas kernels are held against in
tests/test_flash_attention.py and tests/test_int8_matmul.py, at the same
tolerances: 2e-5 for fp32 attention, 2e-2 for the int8 linear. K4's plain
version is held against the JAX int8 tiers run in interpret mode at 1e-5
(it computes the same int8 codes and the same exponent, exp(ln2 * x),
but torch's exp and XLA's differ by up to 2 ulps, so a p that lies that
close to a half rounds to the next int8 code on one side: such a row,
about one in 2000 here, moves by one code's weight, under 5e-3), and
against exact attention at the tiers' 3e-2 on the inputs of the JAX tier
tests. That bound is a maximum over samples that the tiers' own math
exceeds on other draws (0.05 at worst in 12 draws of 6 heads), so on
other inputs the check against exact attention is a mean abs error under
3e-3 (the tiers sit near 1.6e-3). The CUDA kernels themselves
are compared with the plain versions on the card by
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
K4_ATOL = 1e-5              # K4's plain version against the interpreted tier
K4_FLIP_SHARE = 1e-3        # ... except rows where a p code rounds apart:
K4_FLIP_ATOL = 5e-3         # at most this share of elements, by this much
K4_EXACT_TOL = 3e-2         # tests/test_flash_attention.py:144-226
K4_EXACT_MEAN = 3e-3        # mean abs error against exact attention


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
    ("pallas_hp", "K6"), ("ulysses:sp", "step 15"),
    ("xla", "reference_attention")])
def test_unported_attention_tiers_raise(mode, entry):
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(NotImplementedError, match=entry):
        tattn.attention(q, q, q, mode=mode)
    with pytest.raises(NotImplementedError, match="K3"):
        tattn.attention(q, q, q, score_bound=40.0)


@pytest.mark.parametrize("head_dim", [None, 32, 64, 80, 128, 256])
def test_auto_tier_matches_jax_tpu_policy(monkeypatch, head_dim):
    """``auto`` resolves as the JAX package resolves it on the TPU: exact
    (K1) at head dims up to 64, the int8 QK+PV tier (K4) above and for an
    unknown head dim; explicit tiers stay as given."""
    from ltx_video_gpupoor_tpu.ops import attention as jattn

    monkeypatch.setattr(jattn, "_default_backend_is_tpu", lambda: True)
    monkeypatch.setattr(jattn, "_FORCED_MODE", "auto")
    assert tattn.resolve_mode("auto", None, head_dim) == \
        jattn.resolve_mode("auto", None, head_dim)
    for mode in ("pallas", "pallas_int8", "pallas_int8pv"):
        assert tattn.resolve_mode(mode, None, head_dim) == \
            jattn.resolve_mode(mode, None, head_dim) == mode


@pytest.mark.parametrize("mode,d,tier", [
    ("auto", 64, "K1"), ("auto", 128, "K4pv"), ("pallas", 128, "K1"),
    ("pallas_int8", 64, "K4qk"), ("pallas_int8pv", 64, "K4pv")])
def test_attention_dispatches_by_tier(monkeypatch, mode, d, tier):
    """``attention`` reaches the tier ``resolve_mode`` names; an explicit
    ``pallas_int8pv`` drops a score bound (as in JAX), every other tier
    with a bound raises (K3)."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append("K1"))
    monkeypatch.setattr(
        tattn, "flash_attention_int8",
        lambda *a, pv_int8, **k: calls.append("K4pv" if pv_int8 else "K4qk"))
    q = torch.zeros(1, 1, 8, d)
    tattn.attention(q, q, q, mode=mode)
    assert calls == [tier]
    if mode == "pallas_int8pv":
        tattn.attention(q, q, q, mode=mode, score_bound=40.0)
        assert calls == [tier, tier]
    else:
        with pytest.raises(NotImplementedError, match="K3"):
            tattn.attention(q, q, q, mode=mode, score_bound=40.0)


def test_k1_rejects_kv_only_segments():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_attention(q, q, q, None, torch.ones(1, 8, dtype=torch.int32))


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("d,sq,skv,seg,kv_valid,causal", [
    (64, 256, 384, False, None, False),    # several kv blocks, sum_col
    (128, 256, 384, False, None, False),
    (128, 256, 256, True, None, False),    # segments and a lost q row
    (64, 384, 384, False, 300, False),     # kv_valid tail
    (128, 256, 256, False, None, True),    # causal
])
def test_k4_plain_matches_pallas_interpret(pv_int8, d, sq, skv, seg,
                                           kv_valid, causal):
    q, k, v = _qkv(9, 2, 2, sq, skv, d)
    segs = ()
    if seg:
        q_seg = np.ones((2, sq), np.int32)
        q_seg[1, 3] = 5                    # a row that matches no key
        kv_seg = np.ones((2, skv), np.int32)
        kv_seg[0, skv // 2:] = 0           # padded text
        segs = (q_seg, kv_seg)
    kw = dict(kv_valid=kv_valid, causal=causal)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v) + segs),
                              qk_int8=True, pv_int8=pv_int8, block_q=128,
                              block_kv=128, interpret=True, **kw)
    ops = tfa.int8_prologue(*_t(q, k, v), pv_int8=pv_int8, block_kv=128)
    assert ops.kv_block == 128
    out = tfa.int8_attention_plain(ops, *_t(*segs), **kw)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert np.mean(err > K4_ATOL) < K4_FLIP_SHARE, np.mean(err > K4_ATOL)
    assert err.max() < K4_FLIP_ATOL, err.max()
    exact = tfa.reference_attention(*_t(q, k, v, *segs), **kw)
    assert float((out - exact).abs().mean()) < K4_EXACT_MEAN
    if seg:
        np.testing.assert_array_equal(out[1, :, 3].numpy(), 0.0)


@pytest.mark.parametrize("key,d,s,pv_int8,seg,kv_valid", [
    (6, 64, 256, False, False, None),      # test_int8_qk_tier_close_to_fp
    (7, 128, 256, True, False, None),      # test_int8_pv_tier_close_to_fp
    (17, 64, 256, True, False, None),      # ..._odd_head_dim_close_to_fp
    (9, 64, 256, False, True, None),       # ..._with_segments_matches_ref
    (11, 128, 384, True, False, 300),      # test_int8pv_with_kv_tail_...
])
def test_k4_plain_within_tier_bound_of_exact(key, d, s, pv_int8, seg,
                                             kv_valid):
    """On the inputs of the JAX package's int8 tier tests, K4's plain
    version stays within their 3e-2 of exact attention."""
    k1, k2, k3 = jax.random.split(jax.random.key(key), 3)
    q, k, v = (np.array(jax.random.normal(kk, (1, 2, s, d)))
               for kk in (k1, k2, k3))
    segs = ()
    if seg:
        ids = np.where(np.arange(s) < 200, 1, 0)[None, :].astype(np.int32)
        segs = (ids, ids)
    out = tfa.flash_attention_int8(*_t(q, k, v, *segs), pv_int8=pv_int8,
                                   kv_valid=kv_valid)
    if kv_valid is not None:
        segs = (np.ones((1, s), np.int32),
                np.where(np.arange(s) < kv_valid, 1, 0)[None].astype(np.int32))
    exact = tfa.reference_attention(*_t(q, k, v, *segs))
    assert float((out - exact).abs().max()) < K4_EXACT_TOL


def test_k4_scales_take_masked_rows_and_the_jax_block():
    """The k and v scales' absmax covers segment-masked rows (JAX masks
    scores, not the prologue), and the QK+PV tier's k scales are per
    block of JAX's compiled kv block (fit_blocks on the 128-padded
    lengths: 4096 at the Wan self-attention's S=32760)."""
    from ltx_video_gpupoor_tpu.ops.flash_attention import fit_blocks

    for sq, skv in ((32768, 32768), (32768, 512), (5376, 5376), (384, 256)):
        assert tfa.fit_blocks(sq, skv) == fit_blocks(sq, skv)
        assert tfa.fit_blocks(sq, skv, 128, 128) == \
            fit_blocks(sq, skv, 128, 128)
    assert tfa.fit_blocks(32768, 32768)[1] == 4096
    q, k, v = _t(*_qkv(10, 1, 1, 8, 300, 128))
    k[0, 0, 290, 0] = 50.0                 # in the last kv block only
    v[0, 0, 290, 3] = -60.0
    ops = tfa.int8_prologue(q, k, v, block_kv=128)
    assert ops.kv_block == ops.k_block == 128
    assert ops.k_scale.shape == (1, 1, 3)
    np.testing.assert_allclose(float(ops.k_scale[0, 0, 2]), 50.0 / 127,
                               rtol=1e-6)
    assert float(ops.k_scale[0, 0, 0]) < 10.0 / 127
    np.testing.assert_allclose(float(ops.v_scale[0, 0, 3]), 60.0 / 127,
                               rtol=1e-6)
    qk = tfa.int8_prologue(q, k, v, pv_int8=False)
    assert qk.k_block == 1 and qk.k_scale.shape == (1, 1, 300)
    assert qk.v_scale is None and qk.v.dtype == torch.float32
    # JAX's ones column of V (head dims that are not a 128 multiple):
    # scale 1/127, code 127, and its scale times the x127 fold
    one = tfa._absmax_scale(torch.ones(1), 0)
    assert float(torch.round(1.0 / one)) == 127.0
    assert float(one * tfa.INV127_F32 * 127.0) == tfa.SUM_COL_SCALE


@pytest.mark.parametrize("pv_int8", [True, False])
def test_k4_row_mass_matches_softmax(pv_int8):
    """``int8_row_mass``, stepped over kv blocks, is the softmax mass of
    K4's scores taken at once; a row that sees no key has mass 0."""
    q, k, v = _t(*_qkv(12, 2, 2, 200, 300, 64))
    q_seg = torch.ones(2, 200, dtype=torch.int32)
    q_seg[1, 7] = 3
    kv_seg = torch.ones(2, 300, dtype=torch.int32)
    kv_seg[0, 250:] = 0
    ops = tfa.int8_prologue(q, k, v, pv_int8=pv_int8, block_kv=128)
    mass = tfa.int8_row_mass(ops, q_seg, kv_seg, causal=True)
    s = (ops.q8.double() @ ops.k8.double().transpose(-1, -2)) \
        * ops.q_scale[..., None].double() \
        * ops.k_scale.repeat_interleave(ops.k_block, -1)[:, :, None, :300]
    rows, cols = torch.arange(200)[:, None], torch.arange(300)[None, :]
    keep = (q_seg[:, None, :, None] == kv_seg[:, None, None, :]) \
        & (kv_seg[:, None, None, :] > 0) & (rows >= cols)
    s = torch.where(keep, s, -torch.inf)
    ref = torch.exp2(s - s.amax(-1, keepdim=True)).sum(-1)
    ref = torch.nan_to_num(ref, nan=0.0)
    torch.testing.assert_close(mass, ref.float(), rtol=1e-5, atol=0)
    assert float(mass[1, :, 7].abs().max()) == 0.0
    assert float(mass[0, :, 0].min()) == 1.0         # row 0 sees one key


@pytest.mark.parametrize("pv_int8", [True, False])
def test_k4_tile_bound_rejects_planted_faults(pv_int8):
    """The card's check of K4 against its plain version at the kernel's
    tile: an output the plain version gives passes; a q tile written as
    zeros or a channel that lost its v scale fails it, in the largest
    ratio to ``int8_tile_bound`` and in the mean."""
    q, k, v = (x.bfloat16() for x in _t(*_qkv(13, 1, 2, 1000, 1000, 128)))
    ops = tfa.int8_prologue(q, k, v, pv_int8=pv_int8)
    tile = tfa.int8_attention_plain(ops, block_kv=tfa.K4_TILE_KV,
                                    out_dtype=torch.bfloat16)
    bound = tfa.int8_tile_bound(ops, tile)
    assert float(bound.min()) > 0

    def ratios(kern):
        diff = (kern.float() - tile.float()).abs()
        return (float((diff / bound).max()),
                float(diff.mean() / tile.float().abs().mean()))

    assert ratios(tile) == (0.0, 0.0)
    zeroed = tile.clone()
    zeroed[:, :, 960:] = 0                 # the last (ragged) 64-row q tile
    worst, mean = ratios(zeroed)
    assert worst > 10 and mean > tfa.K4_TILE_MEAN_REL
    scale = ops.v_scale[:, :, 5] if pv_int8 else torch.full((1, 2), 0.5)
    dropped = tile.clone()
    dropped[..., 5] = (dropped[..., 5].float() / scale[..., None]).bfloat16()
    worst, mean = ratios(dropped)
    assert worst > 10 and mean > tfa.K4_TILE_MEAN_REL


def test_k4_rejects_kv_only_segments_and_other_devices():
    q = torch.zeros(1, 1, 8, 128)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_attention_int8(q, q, q, None,
                                 torch.ones(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tfa.flash_attention_int8(q.to("meta"), q.to("meta"), q.to("meta"))


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
