"""Kernels K1 to K8 on the card against their plain versions.

This file imports torch and the port only (no jax), so it runs on the
machine with the GPU:  python -m pytest tests/test_torch_cuda.py -q
Every test takes the ``cuda`` fixture, which skips where there is no CUDA
device; the marker ``cuda`` selects them. Tolerances: K1 and K6 (exact
attention on wgmma) against their plain versions on the same bf16 operands:
every element within two bf16 ulps plus 2**-9 of the largest output
(``_within_two_ulps``), at shapes that land on each mask kind of the block and
on each edge of its 128-row tiles; K2's int8 activations and int32
accumulators exactly (at ragged M, N and K: M 1, 17, 129; N off the
256-column tile; K 16, 48, 8960; a dropped K tail must fail the check),
its outputs at 1e-2 relative (one bf16 rounding).
K4 (int8 attention, both tiers, every mask kind) against its plain version
on the same prologue operands, stepping its online softmax (a) by the
kernel's 128-row tile, the same math: every element within ``int8_tile_bound`` (a few P
codes that round the other way, each moving a row by at most
max|v| / (127 * its softmax mass), then one bf16 rounding), and the mean
abs difference under 5e-4 of the mean |output|; (b) by JAX's kv block,
where P is quantized against other running maxima: every element within
``int8_tile_bound`` plus ``int8_order_bound`` (the bound derived for the P
codes' order: a code step of 1/127 of its running max, times the rescale
between the two maxima, over |V| in sight), the ratio's root mean square
under ``K4_ORDER_RMS``, and mean < 1e-3. Against exact fp32 attention
the kernel's mean abs error is at most 1.1x the plain version's: it adds
no error to the tier's own.
(The 3e-2 max bound of the JAX tier tests holds on their inputs; the
tiers' own math exceeds it on other draws, 0.05 at worst in 12 CPU
draws, so it is no bound for every input.)
K3 (bounded scores, on K1's block) against its plain version at atol =
rtol = 2e-2 and within two bf16 ulps plus 2**-9 of the largest output, at
every mask kind and both head dims; K3q (int8 Q.K^T, bounded scores)
against its plain version on the same prologue operands within the same
two ulps (per-row k scales and no running max: nothing depends on a kv
block). K5 (fused adaLN prologue): the int8 codes and
row scales of its row kernel and the int32 product exactly, as for K2
(the mean of squares is rounded from a float64 sum on both sides, and
``rsqrt`` is the same device function), its outputs at 1e-2 relative.
K8 (sub-block-pipelined attention on K1's block) against its plain
version, which takes the same sub-blocks with the same roundings, at
every (block_kv, nsub) it is built for and with a ragged last q tile:
every element within two bf16 ulps plus 2**-9 of the largest output. K7
(ring attention, the whole ring in one cooperative launch) against the
plain ring: the CUDA-core body at fp32 atol 2e-5 and bf16 atol 3e-2 (the
tolerances of the JAX package's tests), the tensor-core body (K1's block)
at K8's bound at p = 1, 2, 4, 8 and where S/p is an odd multiple of 64;
each twice in a row on one workspace, so that a call cannot take the
previous call's flags. Under autograd each wrapper raises, naming its
route, before its kernel launches (``tests/torch_guard_cases.py``).
"""

import numpy as np
import pytest
import torch
import torch_guard_cases as guard_cases

from ltx_video_gpupoor_tpu_torch.ops import attention as attn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_weights
from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr
from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device)


def _within_two_ulps(kern, plain):
    """Every element within two bf16 ulps of the plain value plus 2**-9 of
    the largest output (fp32 summation order, the exp2 approximation and
    the final rounding differ); an all-zero plain output allows no
    difference."""
    diff = (kern.float() - plain.float()).abs()
    bound = plain.float().abs() * 2.0 ** -7 \
        + float(plain.float().abs().max()) * 2.0 ** -9
    return bool((diff <= bound).all())


@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid,kind", [
    (64, 300, 300, False, False, None, "tail"),
    (64, 130, 77, True, False, None, "general"),
    (128, 200, 200, False, True, 150, "general"),
    # Sq and Skv one under, at and one over a 128-row tile
    (64, 127, 255, False, False, None, "tail"),
    (64, 128, 256, False, False, None, "none"),
    (128, 129, 257, False, False, None, "tail"),
    (128, 384, 128, False, False, None, "none"),
    # kv_valid inside the last tile, at a tile edge, a whole tile short, 0
    (64, 256, 512, False, False, 500, "tail"),
    (128, 256, 512, False, False, 384, "none"),
    (64, 256, 512, False, False, 300, "tail"),
    (128, 130, 130, False, False, 0, "none"),
    # causal from a tile edge on; segments over three kv tiles
    (64, 512, 512, False, True, None, "general"),
    (128, 300, 300, True, False, None, "general"),
    # d = 80 (CLIP ViT-H/14's heads, 257 tokens) in the D=128 layout
    (80, 257, 257, False, False, None, "tail"),
    (80, 256, 512, False, False, 384, "none"),
    (80, 300, 300, True, False, None, "general"),
])
def test_k1_matches_plain(cuda, d, sq, skv, seg, causal, kv_valid, kind):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, 2, 3, n, d).bfloat16() for n in (sq, skv, skv))
    args = []
    if seg:
        args = [torch.ones(2, sq, dtype=torch.int32, device=cuda),
                torch.ones(2, skv, dtype=torch.int32, device=cuda)]
        args[1][0, 40:] = 0
        args[0][1, 5] = 7                      # sees no key
    assert fa.mask_kind(skv, kv_valid, segments=seg, causal=causal) == kind
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, *args, causal=causal, kv_valid=kv_valid)
    assert fa.flash_attention.launches == before + 1
    ref = fa.reference_attention(q, k, v, *args, causal=causal,
                                 kv_valid=kv_valid)
    assert torch.isfinite(out.float()).all()
    assert _within_two_ulps(out, ref)
    if seg:
        assert float(out[1, :, 5].float().abs().max()) == 0.0
    if kv_valid == 0:
        assert float(out.float().abs().max()) == 0.0


def test_k1_reads_head_split_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, d = 2, 97, 4, 64
    q, k, v = (_randn(gen, b, s, h * d).bfloat16().view(b, s, h, d)
               .transpose(1, 2) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    assert out.stride() == q.stride()
    ref = fa.reference_attention(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


def test_k1_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    # fp16 (fp32 is FP32_POLICY's, which takes K1f)
    q = torch.zeros(1, 1, 8, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("m,k,n,dtype", [(67, 256, 200, torch.bfloat16),
                                         (3, 2048, 384, torch.float32),
                                         (300, 48, 130, torch.bfloat16),
                                         (1, 16, 200, torch.bfloat16),
                                         (17, 48, 257, torch.float32),
                                         (129, 8960, 600, torch.bfloat16),
                                         (1000, 4096, 4100, torch.bfloat16)])
def test_k2_matches_plain(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (_randn(gen, m, k) * 3).to(dtype)
    if m > 1:
        x[1] = 0
    ql = quantize_weights(_randn(gen, n, k) * k ** -0.5)
    xq, sx, acc = im.int8_linear_acc(x, ql.w_int8)
    pq, ps = im.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, ps[:, 0])
    assert torch.equal(acc, im.int8_gemm_acc_plain(pq, ql.w_int8))
    # a kernel that dropped its last 16-byte K step would not pass
    dropped = im.int8_gemm_acc_plain(pq[:, :-16], ql.w_int8[:, :-16])
    assert not torch.equal(acc, dropped)
    bias = _randn(gen, n)
    before = im.int8_linear.launches
    out = im.int8_linear(x, ql.w_int8, ql.scale, bias)
    assert im.int8_linear.launches == before + 1
    ref = im.int8_linear_plain(x, ql.w_int8, ql.scale, bias)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-6)
    if m > 1:
        np.testing.assert_allclose(out[1].float().cpu().numpy(),
                                   bias.to(dtype).float().cpu().numpy(),
                                   atol=1e-6)


def test_k2_rejects_what_it_does_not_take(cuda):
    """K2 takes any K, as JAX does: at K = 40 the codes, the row scales and
    the int32 accumulator equal the plain version's exactly (codes in rows
    of 48 bytes, zeros past K; the weight zero-padded at the call); a
    weight on another device raises."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _randn(gen, 33, 40).bfloat16()
    ql = quantize_weights(_randn(gen, 72, 40))
    xq, sx, acc = im.int8_linear_acc(x, ql.w_int8)
    pq, ps = im.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, ps[:, 0])
    assert torch.equal(acc, im.int8_gemm_acc_plain(pq, ql.w_int8))
    out = im.int8_linear(x, ql.w_int8, ql.scale)
    ref = im.int8_linear_plain(x, ql.w_int8, ql.scale)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-6)
    w8 = torch.zeros(32, 48, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        im.int8_linear(torch.zeros(3, 48, device=cuda), w8,
                       torch.ones(32))


@pytest.mark.parametrize("m,k,dtype,offset", [
    (15840, 2048, torch.bfloat16, 0),    # one slot a lane, 4 warps a row
    (300, 512, torch.bfloat16, 0),       # 8 rows a block, ragged M
    (129, 8960, torch.bfloat16, 0),      # 2 slots a lane
    (64, 16384, torch.float32, 0),       # 4 slots a lane
    (33, 20000, torch.bfloat16, 0),      # two passes
    (17, 40, torch.float32, 0),          # K off a 16-multiple
    (9, 4096, torch.bfloat16, 1),        # rows off a 16-byte boundary
])
def test_k2_row_kernel_matches_plain(cuda, m, k, dtype, offset):
    """K2's row kernel: codes and row scales equal ``quantize_rows_plain``
    bit for bit at every form of the kernel, zero codes up to the padded
    row; one all-zero row (the 1e-8 floor)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    buf = (_randn(gen, m * k + offset) * 3).to(dtype)
    x = buf[offset:].view(m, k)
    x[m // 2] = 0
    xq, sx = im.quantize_rows(x)
    pq, ps = im.quantize_rows_plain(x)
    kp = -(-k // 16) * 16
    assert xq.shape == (m, kp) and xq.data_ptr() % 16 == 0
    assert torch.equal(xq[:, :k], pq) and torch.equal(sx, ps[:, 0])
    assert not xq[:, k:].any()


@pytest.mark.parametrize("d,dtype,pv_int8", [
    (64, torch.bfloat16, False), (128, torch.bfloat16, False),
    (128, torch.bfloat16, True), (64, torch.float32, False),
    (128, torch.float32, True)])
def test_prologue_kernel_matches_plain(cuda, d, dtype, pv_int8):
    """The int8 tiers' prologue on the card (Q by the row kernel in every
    tier, K too in the QK tier) equals the plain ops bit for bit on
    head-split views of ``[B, S, H*D]`` projections, one launch a
    quantized operand."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, h, sq, skv = 2, 3, 300, 200

    def heads(n):
        t = (_randn(gen, b, n, h * d) * 2).to(dtype)
        return t.view(b, n, h, d).transpose(1, 2)

    q, k, v = heads(sq), heads(skv), heads(skv)
    q[0, 1, 5] = 0
    before = fa.int8_prologue.kernel_launches
    ops = fa.int8_prologue(q, k, v, pv_int8=pv_int8)
    assert fa.int8_prologue.kernel_launches == before + (1 if pv_int8 else 2)
    plain = fa.int8_prologue_plain(q, k, v, pv_int8=pv_int8)
    for name in fa.Int8Operands._fields:
        a, p = getattr(ops, name), getattr(plain, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, p), name
        else:
            assert a == p, name


K4_BLOCK_MEAN = 1e-3


def _k4_tile_ok(ops, kern, tile, *args, **kw):
    """K4's output against the plain version stepped by K4's tile."""
    diff = (kern.float() - tile.float()).abs()
    bound = fa.int8_tile_bound(ops, tile, *args, **kw)
    return (float((diff / bound).max()) <= 1.0 and float(diff.mean())
            <= fa.K4_TILE_MEAN_REL * float(tile.float().abs().mean()))


@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid,block_kv", [
    (128, 300, 300, False, False, None, 4096),   # ragged S: tail
    (64, 256, 700, False, False, None, 256),     # several kv blocks, D=64
    (128, 130, 77, True, False, None, 4096),     # text segments, a lost row
    (128, 500, 500, False, False, 333, 128),     # kv_valid tail
    (64, 200, 200, False, True, None, 128),      # causal: general
    (128, 256, 512, False, False, None, 256),    # no mask code: none
    (64, 384, 384, False, False, 256, 128),      # kv_valid on a tile: none
    (80, 257, 257, False, False, None, 4096),    # CLIP's heads and tokens
    (80, 130, 77, True, False, None, 4096),      # d = 80, text segments
])
def test_k4_matches_plain(cuda, pv_int8, d, sq, skv, seg, causal, kv_valid,
                          block_kv):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, 2, 3, n, d).bfloat16() for n in (sq, skv, skv))
    args = []
    if seg:
        args = [torch.ones(2, sq, dtype=torch.int32, device=cuda),
                torch.ones(2, skv, dtype=torch.int32, device=cuda)]
        args[1][0, 40:] = 0
        args[0][1, 5] = 7                      # sees no key
    kw = dict(causal=causal, kv_valid=kv_valid)
    before = fa.flash_attention_int8.launches
    out = fa.flash_attention_int8(q, k, v, *args, pv_int8=pv_int8, **kw)
    assert fa.flash_attention_int8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    kern = fa.int8_attention_cuda(fa.int8_prologue(q, k, v, pv_int8=pv_int8),
                                  *args, **kw)
    assert fa.flash_attention_int8.launches == before + 2
    torch.testing.assert_close(out, kern, atol=0, rtol=0)
    ops = fa.int8_prologue(q, k, v, pv_int8=pv_int8, block_kv=block_kv)
    kern = fa.int8_attention_cuda(ops, *args, **kw)
    tile = fa.int8_attention_plain(ops, *args, block_kv=fa.K4_TILE_KV,
                                   out_dtype=q.dtype, **kw)
    assert _k4_tile_ok(ops, kern, tile, *args, **kw)
    zeroed = kern.clone()                      # a planted fault: the last
    zeroed[:, :, (sq - 1) // 128 * 128:] = 0   # q tile never written
    assert not _k4_tile_ok(ops, zeroed, tile, *args, **kw)
    plain = fa.int8_attention_plain(ops, *args, out_dtype=q.dtype, **kw)
    bound = fa.int8_tile_bound(ops, tile, *args, **kw) \
        + fa.int8_order_bound(ops, plain, *args, **kw)
    block = (kern.float() - plain.float()).abs()
    assert float((block / bound).max()) <= 1.0
    assert float((block / bound).square().mean().sqrt()) <= fa.K4_ORDER_RMS
    assert float(block.mean()) < K4_BLOCK_MEAN
    assert float(((zeroed.float() - plain.float()).abs() / bound).max()) > 1
    exact = fa.reference_attention(q.float(), k.float(), v.float(), *args,
                                   **kw)
    assert float((kern.float() - exact).abs().mean()) <= \
        1.1 * float((plain - exact).abs().mean()) + 1e-5
    if seg:
        assert float(out[1, :, 5].float().abs().max()) == 0.0


def test_k4_reads_head_split_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, s, h, d = 2, 97, 4, 128
    q, k, v = (_randn(gen, b, s, h * d).bfloat16().view(b, s, h, d)
               .transpose(1, 2) for _ in range(3))
    out = fa.flash_attention_int8(q, k, v)
    assert out.stride() == q.stride()
    ops = fa.int8_prologue(q, k, v)
    ref = fa.int8_attention_plain(ops, block_kv=fa.K4_TILE_KV,
                                  out_dtype=q.dtype)
    assert _k4_tile_ok(ops, out, ref)


def test_k4_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_int8(q, q, q)
    q = torch.zeros(1, 1, 8, 128, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_int8(q, q, q)
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16, device=cuda)
    ops = fa.int8_prologue(q, q, q)
    with pytest.raises(ValueError, match="int8 v"):
        fa.int8_attention_cuda(ops._replace(v=q))
    with pytest.raises(ValueError, match="k_scale"):
        fa.int8_attention_cuda(ops._replace(k_scale=ops.k_scale[..., :0]))


@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid", [
    (128, 300, 300, False, False, None),         # ragged S
    (64, 300, 300, False, False, 211),           # D=64: bf16 denominator
    (128, 130, 77, True, False, None),           # text segments, a lost row
    (64, 200, 200, False, True, None),           # causal
    (128, 256, 384, False, False, None),         # no mask code: none
    (64, 384, 384, False, False, 256),           # kv_valid on a tile: none
    (64, 1000, 1000, False, False, 777),         # D=64 with the producer
])
def test_k3_matches_plain(cuda, d, sq, skv, seg, causal, kv_valid):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn(gen, 2, 3, n, d).bfloat16() for n in (sq, skv, skv))
    q[0, 0, 3] *= 40                               # scores over the bound
    args = []
    if seg:
        args = [torch.ones(2, sq, dtype=torch.int32, device=cuda),
                torch.ones(2, skv, dtype=torch.int32, device=cuda)]
        args[1][0, 40:] = 0
        args[0][1, 5] = 7                          # sees no key
    kw = dict(causal=causal, kv_valid=kv_valid)
    before = (fa.flash_attention.bounded_launches, fa.flash_attention.launches)
    out = fa.flash_attention(q, k, v, *args, score_bound=16.0, **kw)
    assert (fa.flash_attention.bounded_launches,
            fa.flash_attention.launches) == (before[0] + 1, before[1])
    ref = fa.bounded_attention_plain(q, k, v, *args, score_bound=16.0, **kw)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert _within_two_ulps(out, ref)
    # within the bound it is exact attention
    q[0, 0, 3] /= 40
    out = fa.flash_attention(q, k, v, *args, score_bound=40.0, **kw)
    exact = fa.reference_attention(q.float(), k.float(), v.float(), *args,
                                   **kw)
    torch.testing.assert_close(out.float(), exact, atol=2e-2, rtol=2e-2)
    if seg:
        assert float(out[1, :, 5].float().abs().max()) == 0.0


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention.bounded_launches,
            fa.flash_attention_int8.launches,
            fa.flash_attention_int8.bounded_launches)


@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid,kind", [
    (128, 300, 300, False, False, None, "tail"),     # ragged S
    (64, 300, 300, False, False, 211, "tail"),       # bf16 denominator
    (128, 130, 77, True, False, None, "general"),    # segments, a lost row
    (64, 200, 200, False, True, None, "general"),    # causal
    (128, 256, 384, False, False, None, "none"),     # no mask code
    (64, 384, 384, False, False, 256, "none"),       # kv_valid on a tile
    # more kv tiles than ring stages: the warpgroups take turns
    (128, 200, 1000, False, False, None, "tail"),
    (64, 300, 1024, False, False, None, "none"),
    (128, 700, 700, False, True, None, "general"),   # turns in late q tiles
    (64, 600, 900, True, False, None, "general"),
    # a head of 80 in the D=128 layout (CLIP ViT-H/14's)
    (80, 257, 257, False, False, None, "tail"),
    (80, 130, 77, True, False, None, "general"),
    (80, 256, 384, False, False, None, "none"),
    (80, 200, 1000, False, True, None, "general"),
])
def test_k3q_matches_plain(cuda, d, sq, skv, seg, causal, kv_valid, kind):
    """K3q against its plain version on the same prologue operands: one
    launch, counted in ``flash_attention_int8.bounded_launches`` (and its
    head dim's entry of ``bounded_launches_by_d``) and in no other
    counter; a row whose scores lie over the bound stays finite and
    agrees; a row that sees no key returns 0; the wrapper (prologue +
    kernel) gives the same bits in q's layout."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (_randn(gen, 2, 3, n, d).bfloat16() for n in (sq, skv, skv))
    q[0, 0, 3] *= 40                               # scores over the bound
    args = []
    if seg:
        args = [torch.ones(2, sq, dtype=torch.int32, device=cuda),
                torch.ones(2, skv, dtype=torch.int32, device=cuda)]
        args[1][0, 40:] = 0
        args[0][1, 5] = 7                          # sees no key
    assert fa.mask_kind(skv, kv_valid, segments=seg, causal=causal) == kind
    kw = dict(causal=causal, kv_valid=kv_valid, score_bound=16.0)
    ops = fa.int8_prologue(q, k, v, pv_int8=False)
    before = _counts()
    by_d = fa.flash_attention_int8.bounded_launches_by_d.get(d, 0)
    kern = fa.int8_attention_cuda(ops, *args, **kw)
    assert _counts() == before[:3] + (before[3] + 1,)
    assert fa.flash_attention_int8.bounded_launches_by_d[d] == by_d + 1
    plain = fa.int8_attention_plain(ops, *args, out_dtype=q.dtype, **kw)
    assert torch.isfinite(kern.float()).all()
    assert _within_two_ulps(kern, plain)
    zeroed = kern.clone()                          # a planted fault: the
    zeroed[:, :, (sq - 1) // 128 * 128:] = 0       # last q tile unwritten
    assert not _within_two_ulps(zeroed, plain)
    if seg:
        assert float(kern[1, :, 5].float().abs().max()) == 0.0
    out = fa.flash_attention_int8(q, k, v, *args, pv_int8=False, **kw)
    assert out.stride() == q.stride() and torch.equal(out, kern)
    with pytest.raises(ValueError, match="pv_int8"):
        fa.int8_attention_cuda(fa.int8_prologue(q, k, v), score_bound=16.0)


@pytest.mark.parametrize("heads,d,s,kv_valid", [(4, 64, 300, None),
                                                (3, 128, 200, 150),
                                                (3, 64, 97, None),
                                                (2, 64, 256, None),
                                                (2, 128, 257, None),
                                                (3, 128, 384, 256),
                                                (2, 64, 384, 255)])
def test_k6_matches_plain(cuda, heads, d, s, kv_valid):
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (_randn(gen, 2, s, heads * d).bfloat16() for _ in range(3))
    before = fa.flash_attention_hp.launches
    out = fa.flash_attention_hp(q, k, v, heads=heads, kv_valid=kv_valid)
    assert fa.flash_attention_hp.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    ref = fa.flash_attention_hp_plain(q, k, v, heads=heads, kv_valid=kv_valid)
    assert torch.isfinite(out.float()).all()
    assert _within_two_ulps(out, ref)


def test_k6_reads_a_fused_qkv_projection_in_place(cuda):
    """q, k and v as slices of one [B, S, 3*H*D] projection, through the
    dispatch: ``pallas_hp`` launches K6 and nothing else."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, s, heads, d = 2, 130, 2, 128
    qkv = _randn(gen, b, s, 3 * heads * d).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    before = (fa.flash_attention_hp.launches, fa.flash_attention.launches)
    out = attn.attention_packed(q, k, v, heads, mode="pallas_hp")
    assert (fa.flash_attention_hp.launches, fa.flash_attention.launches) == \
        (before[0] + 1, before[1])
    ref = fa.flash_attention_hp_plain(q.float(), k.float(), v.float(),
                                      heads=heads)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    # fp16 is refused (fp32 is FP32_POLICY's, which takes K1f)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_hp(q.half(), k.half(), v.half(), heads=heads)


@pytest.mark.parametrize("m,k,n,groups,bias", [(64, 256, 384, 1, True),
                                               (96, 4096, 200, 4, False),
                                               (48, 64, 130, 2, True),
                                               (48, 40, 130, 2, True),
                                               (32, 32784, 64, 2, False)])
def test_k5_matches_plain(cuda, m, k, n, groups, bias):
    """K5 at every K: rows in registers, a K off a 16-multiple (codes in
    rows of round_up(K, 16) with zeros past K, the weight zero-padded at
    the call) and a row past the registers (read three times)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = (_randn(gen, m, k) * 3).bfloat16()
    x[1] = 0                                       # s_x floors at 1e-8
    scale = (_randn(gen, groups, k) * 0.3).bfloat16()
    shift = (_randn(gen, groups, k) * 0.3).bfloat16()
    if groups == 1:
        shift[:] = 0                               # so that row 1 stays 0
    ql = quantize_weights(_randn(gen, n, k) * k ** -0.5)
    b = _randn(gen, n) if bias else None
    kw = dict(rows_per_group=m // groups, eps=1e-6)
    before = (fp.norm_mod_int8_matmul.launches, im.int8_linear.launches)
    hq, sx = fp.norm_mod_quantize_rows(x, scale, shift, **kw)
    pq, ps = fp.norm_mod_quantize_plain(x, scale, shift, **kw)
    assert hq.shape == (m, -(-k // 16) * 16) and not hq[:, k:].any()
    assert torch.equal(hq[:, :k], pq) and torch.equal(sx, ps[:, 0])
    hq, sx, acc = fp.norm_mod_int8_acc(x, scale, shift, ql.w_int8, **kw)
    assert torch.equal(hq, pq) and torch.equal(sx, ps[:, 0])
    assert torch.equal(acc, im.int8_gemm_acc_plain(pq, ql.w_int8))
    out = fp.norm_mod_int8_matmul(x, scale, shift, ql.w_int8, ql.scale, b,
                                  **kw)
    assert (fp.norm_mod_int8_matmul.launches, im.int8_linear.launches) == \
        (before[0] + 1, before[1])
    ref = fp.norm_mod_int8_matmul_plain(x, scale, shift, ql.w_int8, ql.scale,
                                        b, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-6)


def test_k5_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(32, 64, dtype=torch.float16, device=cuda)
    w8 = torch.zeros(16, 64, dtype=torch.int8, device=cuda)
    ws = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fp.norm_mod_int8_matmul(x, x[:1], x[:1], w8, ws, rows_per_group=32)
    x = x.bfloat16()
    with pytest.raises(ValueError, match="on cpu"):
        fp.norm_mod_int8_matmul(x, x[:1], x[:1], w8.cpu(), ws,
                                rows_per_group=32)
    with pytest.raises(ValueError, match="scale shape"):
        fp.norm_mod_int8_matmul(x, x[:2], x[:2], w8, ws, rows_per_group=32)


@pytest.mark.parametrize("block_kv,nsub", [
    (128, 1), (128, 2), (128, 4), (128, 8), (64, 1), (64, 2), (64, 4)])
def test_k8_matches_plain(cuda, block_kv, nsub):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, 1, 3, 640, 64).bfloat16() for _ in range(3))
    before = mb.pipelined_attention.launches
    out = mb.pipelined_attention(q, k, v, block_kv=block_kv, nsub=nsub)
    torch.cuda.synchronize()
    assert mb.pipelined_attention.launches == before + 1
    plain = mb.pipelined_attention_plain(q, k, v, block_kv=block_kv,
                                         nsub=nsub)
    assert _within_two_ulps(out, plain)
    exact = fa.reference_attention(q, k, v)
    torch.testing.assert_close(out.float(), exact.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("nsub", [1, 2, 4])
def test_k8_ragged_q_tile_matches_plain(cuda, nsub):
    """S = 320 fills two and a half of the kernel's 128-row q tiles: the
    rows past S read as 0 and are not stored (in [B, H, S, D] they would
    land on the next head's first rows)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn(gen, 2, 2, 320, 64).bfloat16() for _ in range(3))
    out = mb.pipelined_attention(q, k, v, block_kv=64, nsub=nsub)
    assert _within_two_ulps(out, mb.pipelined_attention_plain(
        q, k, v, block_kv=64, nsub=nsub))


def test_k8_reads_head_split_views_and_rejects(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(gen, 2, 256, 4 * 64).bfloat16().view(2, 256, 4, 64)
               .transpose(1, 2) for _ in range(3))
    out = mb.pipelined_attention(q, k, v, nsub=4)
    assert out.stride() == q.stride()
    assert _within_two_ulps(out, mb.pipelined_attention_plain(q, k, v,
                                                              nsub=4))
    with pytest.raises(ValueError, match="bfloat16"):
        mb.pipelined_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="multiple of the kv tile"):
        mb.pipelined_attention(q[:, :, :192], k[:, :, :192], v[:, :, :192])


@pytest.mark.parametrize("dtype,shape,p,atol", [
    (torch.float32, (1, 2, 64, 32), 8, 2e-5),
    (torch.float32, (2, 3, 48, 20), 4, 2e-5),
    (torch.bfloat16, (1, 2, 32, 16), 8, 3e-2),
    (torch.bfloat16, (1, 2, 96, 64), 2, 3e-2),     # 48 rows a rank: no tile
    (torch.float32, (1, 2, 64, 32), 1, 2e-5),
])
def test_k7_cuda_core_body_matches_plain(cuda, dtype, shape, p, atol):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (_randn(gen, *shape).to(dtype) for _ in range(3))
    plain = torch.cat(rr.ring_attention_plain(
        q.chunk(p, 2), k.chunk(p, 2), v.chunk(p, 2)), 2)
    before = rr.ring_attention_rdma.launches_simple
    for _ in range(2):
        out = rr.ring_attention_rdma_sharded(q, k, v, p)
        torch.cuda.synchronize()
        assert float((out.float() - plain.float()).abs().max()) <= atol
    assert rr.ring_attention_rdma.launches_simple == before + 2
    exact = fa.reference_attention(q, k, v)
    assert float((out.float() - exact.float()).abs().max()) <= atol


@pytest.mark.parametrize("d,s,p", [(64, 512, 4), (128, 1024, 8),
                                   (128, 256, 1), (64, 384, 2),
                                   # S/p an odd multiple of 64: the tail
                                   (128, 8 * 192, 8), (64, 64, 1),
                                   (128, 4 * 320, 4)])
def test_k7_tensor_core_body_matches_plain(cuda, d, s, p):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, 2, s, 3 * d).bfloat16().view(2, s, 3, d)
               .transpose(1, 2) for _ in range(3))
    shards = [t.chunk(p, 2) for t in (q, k, v)]
    plain = torch.cat(rr.ring_attention_plain(*shards), 2)
    before = rr.ring_attention_rdma.launches_tc
    for _ in range(2):
        out = rr.ring_attention_rdma_sharded(q, k, v, p)
        torch.cuda.synchronize()
        assert _within_two_ulps(out, plain)
    assert rr.ring_attention_rdma.launches_tc == before + 2
    if p > 2:       # a rank that skips a step must show
        bad = torch.cat(rr.ring_attention_rdma(*shards, _fault=(1, 1)), 2)
        assert not _within_two_ulps(bad, plain)
        assert _within_two_ulps(rr.ring_attention_rdma_sharded(q, k, v, p),
                                plain)
    rr.release_workspaces()


def test_k7_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="K7 takes"):
        rr.ring_attention_rdma_sharded(q.double(), q.double(), q.double(), 2)
    with pytest.raises(ValueError, match="K7 takes"):
        big = _randn(gen, 1, 2, 64, 256)
        rr.ring_attention_rdma_sharded(big, big, big, 2)
    with pytest.raises(ValueError, match="at most"):
        rr.ring_attention_rdma_sharded(q, q, q, 32)


# K1f: fp32 attention on the CUDA cores (FP32_POLICY), every variant and
# mask kind, at atol = rtol = 2e-5 (the JAX tests' fp32 tolerance); the
# QK+PV variant against the plain version stepped by K1f's 64-row kv tile
# within int8_tile_bound
@pytest.mark.parametrize("variant", ["exact", "bounded", "qk8",
                                     "qk8_bounded", "pv8"])
@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid", [
    (64, 300, 300, False, False, None), (128, 256, 256, False, False, None),
    (64, 200, 333, False, False, 250), (128, 333, 333, False, True, None),
    (64, 150, 70, True, False, None), (128, 128, 128, False, False, 0),
    # the edges of the split-TF32 design's tiles: 128 q rows a block, kv
    # tiles of 64 rows (32 at D=128 in the fp32-score variants)
    (128, 129, 96, False, False, None), (64, 129, 96, False, False, None),
    (128, 64, 33, False, False, None), (64, 64, 33, False, False, None),
    (128, 256, 256, False, False, 96), (64, 160, 65, False, True, None),
    (128, 257, 128, False, False, 127), (128, 100, 32, True, False, None),
    # a head of 80 in the D=128 layout (CLIP ViT-H/14's)
    (80, 257, 257, False, False, None), (80, 129, 96, False, False, None),
    (80, 150, 70, True, False, None), (80, 200, 200, False, True, None),
    (80, 256, 256, False, False, 96)])
def test_k1f_matches_plain(cuda, variant, d, sq, skv, seg, causal, kv_valid):
    gen = torch.Generator(device=cuda).manual_seed(d + sq + skv)
    q, k, v = (_randn(gen, 2, 3, n, d) for n in (sq, skv, skv))
    segs = (None, None)
    if seg:
        q_seg = torch.ones(2, sq, dtype=torch.int32, device=cuda)
        q_seg[0, 5] = 2
        kv_seg = torch.zeros(2, skv, dtype=torch.int32, device=cuda)
        kv_seg[0, :40] = 1
        kv_seg[1, :] = 1
        segs = (q_seg, kv_seg)
    kw = dict(causal=causal, kv_valid=kv_valid)
    bound = 20.0 if "bounded" in variant else None
    before = dict(fa.flash_attention_fp32.by_variant)
    by_d = fa.flash_attention_fp32.launches_by_d.get(d, 0)
    if variant in ("exact", "bounded"):
        out = fa.flash_attention(q, k, v, *segs, score_bound=bound, **kw)
        plain = (fa.reference_attention(q.cpu(), k.cpu(), v.cpu(),
                                        *(s.cpu() if s is not None else None
                                          for s in segs), **kw)
                 if bound is None else fa.bounded_attention_plain(
                     q.cpu(), k.cpu(), v.cpu(),
                     *(s.cpu() if s is not None else None for s in segs),
                     score_bound=bound, **kw))
    else:
        ops = fa.int8_prologue(q, k, v, pv_int8=variant == "pv8")
        out = fa.int8_attention_fp32(ops, *segs, score_bound=bound, **kw)
        plain = fa.int8_attention_plain(
            ops, *segs, score_bound=bound,
            block_kv=fa.K1F_TILE_KV if variant == "pv8" else None, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fp32.by_variant[variant] == before[variant] + 1
    assert fa.flash_attention_fp32.launches_by_d[d] == by_d + 1
    assert out.dtype == torch.float32
    plain = plain.to(cuda)
    if variant == "pv8":
        bnd = fa.int8_tile_bound(ops, plain, *segs, **kw)
        assert ((out - plain).abs() <= bnd).all()
    else:
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    if seg:
        assert float(out[0, :, 5].abs().max()) == 0.0


def test_k1f_reads_the_head_packed_layout(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = _randn(gen, 2, 300, 3 * 4 * 64)
    q, k, v = qkv.chunk(3, dim=-1)
    out = fa.flash_attention_hp(q, k, v, heads=4, kv_valid=250)
    plain = fa.flash_attention_hp_plain(q.cpu(), k.cpu(), v.cpu(), heads=4,
                                        kv_valid=250)
    torch.testing.assert_close(out.cpu(), plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["auto", "pallas", "pallas_hp",
                                  "pallas_int8", "pallas_int8pv"])
@pytest.mark.parametrize("d,bound", [(64, None), (128, None), (128, 30.0)])
def test_fp32_tiers_launch_what_kernel_route_names(cuda, mode, d, bound):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (_randn(gen, 1, 2, 200, d) for _ in range(3))
    want = attn.kernel_route(mode, dtype=torch.float32, head_dim=d,
                             score_bound=bound)
    before = dict(fa.flash_attention_fp32.by_variant)
    attn.attention(q, k, v, mode=mode, score_bound=bound)
    torch.cuda.synchronize()
    moved = [f"K1f {key}" for key, n in
             fa.flash_attention_fp32.by_variant.items() if n != before[key]]
    assert moved == [want]


@pytest.mark.parametrize("m,k,groups", [
    (3840, 4096, 16), (15360, 4096, 16), (240, 4096, 3), (17, 48, 1),
    (129, 8960, 3), (64, 16384, 4), (16, 32768, 2), (17, 40, 1),
    (9, 1000, 3), (16, 32784, 2), (6, 40000, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_row_kernel_matches_plain(cuda, m, k, groups, dtype):
    """K5's row kernel at the 13B pass 1 and pass 2 shapes, the ragged
    case and every form of the kernel (one slot a lane up to K = 4096,
    more up to 32768, three reads of the row beyond, a value at a time
    where K is not a 16-multiple): bf16 codes and row scales exactly,
    zero codes up to the padded row; fp32 codes where rsqrt may round a
    norm the other way in a row (at most 1e-4 of them)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = (_randn(gen, m, k)
         * torch.rand(m, 1, generator=gen, device=cuda) * 4).to(dtype)
    x[1] = 0
    scale, shift = ((_randn(gen, groups, k) * 0.3).to(dtype) for _ in "st")
    kw = dict(rows_per_group=m // groups, eps=1e-6)
    hq, sx = fp.norm_mod_quantize_rows(x, scale, shift, **kw)
    pq, ps = fp.norm_mod_quantize_plain(x, scale, shift, **kw)
    assert hq.shape == (m, -(-k // 16) * 16) and not hq[:, k:].any()
    hq = hq[:, :k]
    if dtype == torch.bfloat16:
        assert torch.equal(hq, pq) and torch.equal(sx, ps[:, 0])
    else:
        assert float((hq != pq).float().mean()) <= 1e-4


def test_k5_fp32_row_instance_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    m, kk, n, g = 96, 256, 192, 3
    x = _randn(gen, m, kk) * 2
    scale, shift = (_randn(gen, g, kk) * 0.3 for _ in range(2))
    w = quantize_weights(_randn(gen, n, kk) * kk ** -0.5)
    out = fp.norm_mod_int8_matmul(x, scale, shift, w.w_int8, w.scale,
                                  rows_per_group=m // g)
    plain = fp.norm_mod_int8_matmul_plain(x, scale, shift, w.w_int8, w.scale,
                                          rows_per_group=m // g)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, plain, rtol=1e-2, atol=1e-5)


def test_int4_unpack_on_the_card_equals_the_cpu(cuda):
    """The int4 weight-only tier's unpack (int8 shifts and masks) gives
    the CPU's codes for every byte, and its dequantized weight the CPU's
    bit for bit, per group and per channel."""
    from ltx_video_gpupoor_tpu_torch.ops import quant as tq

    packed = torch.arange(-128, 128, dtype=torch.int8).reshape(2, 128)
    torch.testing.assert_close(tq.unpack_int4(packed.to(cuda)).cpu(),
                               tq.unpack_int4(packed), atol=0, rtol=0)
    gen = torch.Generator().manual_seed(5)
    for din, group in ((256, 64), (96, 64)):
        q = tq.quantize_weights_int4(torch.randn(40, din, generator=gen),
                                     group_size=group)
        on_card = tq.QuantizedLinear4(q.w_int4.to(cuda), q.scale.to(cuda))
        torch.testing.assert_close(
            tq.dequantize_int4(on_card, torch.bfloat16).cpu(),
            tq.dequantize_int4(q, torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("route", sorted(guard_cases.CASES))
def test_guard_refuses_under_grad(cuda, route):
    """A kernel wrapper's call on CUDA tensors that autograd records raises
    ``RuntimeError`` naming its route and the ``xla`` tier, and no kernel
    launches (the kernels write outputs with no backward)."""
    call = guard_cases.CASES[route](cuda)
    before = guard_cases.launches()
    with pytest.raises(RuntimeError, match=f"route {route} .*attn_mode='xla'"):
        call()
    assert guard_cases.launches() == before
