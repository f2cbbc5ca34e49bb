"""Kernels K1 to K8 on the card against their plain versions.

This file imports torch and the port only (no jax), so it runs on the
machine with the GPU:  python -m pytest tests/test_torch_cuda.py -q
Every test takes the ``cuda`` fixture, which skips where there is no CUDA
device; the marker ``cuda`` selects them. Tolerances: K1 bf16 against the
fp32 plain version at atol = rtol = 2e-2; K2's int8 activations and int32
accumulators exactly, its outputs at 1e-2 relative (one bf16 rounding).
K4 (int8 attention, both tiers) against its plain version on the same
prologue operands, stepping its online softmax (a) by the kernel's 64-row
tile, the same math: every element within ``int8_tile_bound`` (a few P
codes that round the other way, each moving a row by at most
max|v| / (127 * its softmax mass), then one bf16 rounding), and the mean
abs difference under 5e-4 of the mean |output|; (b) by JAX's kv block,
where P is quantized against other running maxima: max < 1e-1, mean
< 1e-3. Against exact fp32 attention the kernel's mean abs error is at
most 1.1x the plain version's: it adds no error to the tier's own.
(The 3e-2 max bound of the JAX tier tests holds on their inputs; the
tiers' own math exceeds it on other draws, 0.05 at worst in 12 CPU
draws, so it is no bound for every input.)
K3 (bounded scores) and K6 (head-packed) against their plain versions at
K1's atol = rtol = 2e-2. K5 (fused adaLN prologue): the int8 codes and
row scales of its row kernel and the int32 product exactly, as for K2
(the mean of squares is rounded from a float64 sum on both sides, and
``rsqrt`` is the same device function), its outputs at 1e-2 relative.
K8 (sub-block-pipelined attention) against its plain version, which takes
the same sub-blocks with the same roundings: every element within two
bf16 ulps plus 2**-9 of the largest output. K7 (ring attention, the whole
ring in one cooperative launch) against the plain ring: the CUDA-core body
at fp32 atol 2e-5 and bf16 atol 3e-2 (the tolerances of the JAX package's
tests), the tensor-core body at K8's bound; each twice in a row on one
workspace, so that a call cannot take the previous call's flags.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid", [
    (64, 300, 300, False, False, None),
    (64, 130, 77, True, False, None),
    (128, 200, 200, False, True, 150),
])
def test_k1_matches_plain(cuda, d, sq, skv, seg, causal, kv_valid):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, 2, 3, n, d).bfloat16() for n in (sq, skv, skv))
    args = []
    if seg:
        args = [torch.ones(2, sq, dtype=torch.int32, device=cuda),
                torch.ones(2, skv, dtype=torch.int32, device=cuda)]
        args[1][0, 40:] = 0
        args[0][1, 5] = 7                      # sees no key
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, *args, causal=causal, kv_valid=kv_valid)
    assert fa.flash_attention.launches == before + 1
    ref = fa.reference_attention(q.float(), k.float(), v.float(), *args,
                                 causal=causal, kv_valid=kv_valid)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    if seg:
        assert float(out[1, :, 5].float().abs().max()) == 0.0


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
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("m,k,n,dtype", [(67, 256, 200, torch.bfloat16),
                                         (3, 2048, 384, torch.float32),
                                         (300, 48, 130, torch.bfloat16)])
def test_k2_matches_plain(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (_randn(gen, m, k) * 3).to(dtype)
    x[1] = 0
    ql = quantize_weights(_randn(gen, n, k) * k ** -0.5)
    xq, sx, acc = im.int8_linear_acc(x, ql.w_int8)
    pq, ps = im.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, ps[:, 0])
    assert torch.equal(acc, im.int8_gemm_acc_plain(pq, ql.w_int8))
    bias = _randn(gen, n)
    before = im.int8_linear.launches
    out = im.int8_linear(x, ql.w_int8, ql.scale, bias)
    assert im.int8_linear.launches == before + 1
    ref = im.int8_linear_plain(x, ql.w_int8, ql.scale, bias)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(out[1].float().cpu().numpy(),
                               bias.to(dtype).float().cpu().numpy(), atol=1e-6)


def test_k2_rejects_what_it_does_not_take(cuda):
    w8 = torch.zeros(32, 40, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="K % 16"):
        im.int8_linear(torch.zeros(3, 40, device=cuda), w8,
                       torch.ones(32, device=cuda))
    w8 = torch.zeros(32, 48, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        im.int8_linear(torch.zeros(3, 48, device=cuda), w8,
                       torch.ones(32))


K4_BLOCK_MAX, K4_BLOCK_MEAN = 1e-1, 1e-3


def _k4_tile_ok(ops, kern, tile, *args, **kw):
    """K4's output against the plain version stepped by K4's tile."""
    diff = (kern.float() - tile.float()).abs()
    bound = fa.int8_tile_bound(ops, tile, *args, **kw)
    return (float((diff / bound).max()) <= 1.0 and float(diff.mean())
            <= fa.K4_TILE_MEAN_REL * float(tile.float().abs().mean()))


@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("d,sq,skv,seg,causal,kv_valid,block_kv", [
    (128, 300, 300, False, False, None, 4096),   # ragged S
    (64, 256, 700, False, False, None, 256),     # several kv blocks, D=64
    (128, 130, 77, True, False, None, 4096),     # text segments, a lost row
    (128, 500, 500, False, False, 333, 128),     # kv_valid tail
    (64, 200, 200, False, True, None, 128),      # causal
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
    plain = fa.int8_attention_plain(ops, *args, out_dtype=q.dtype, **kw)
    block = (kern.float() - plain).abs()
    assert float(block.max()) < K4_BLOCK_MAX
    assert float(block.mean()) < K4_BLOCK_MEAN
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
    q = torch.zeros(1, 1, 8, 128, device=cuda)
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
    # within the bound it is exact attention
    q[0, 0, 3] /= 40
    out = fa.flash_attention(q, k, v, *args, score_bound=40.0, **kw)
    exact = fa.reference_attention(q.float(), k.float(), v.float(), *args,
                                   **kw)
    torch.testing.assert_close(out.float(), exact, atol=2e-2, rtol=2e-2)
    if seg:
        assert float(out[1, :, 5].float().abs().max()) == 0.0


@pytest.mark.parametrize("heads,d,s,kv_valid", [(4, 64, 300, None),
                                                (3, 128, 200, 150),
                                                (3, 64, 97, None)])
def test_k6_matches_plain(cuda, heads, d, s, kv_valid):
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (_randn(gen, 2, s, heads * d).bfloat16() for _ in range(3))
    before = fa.flash_attention_hp.launches
    out = fa.flash_attention_hp(q, k, v, heads=heads, kv_valid=kv_valid)
    assert fa.flash_attention_hp.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    ref = fa.flash_attention_hp_plain(q.float(), k.float(), v.float(),
                                      heads=heads, kv_valid=kv_valid)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


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
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_hp(q.float(), k.float(), v.float(), heads=heads)


@pytest.mark.parametrize("m,k,n,groups,bias", [(64, 256, 384, 1, True),
                                               (96, 4096, 200, 4, False),
                                               (48, 64, 130, 2, True)])
def test_k5_matches_plain(cuda, m, k, n, groups, bias):
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
    assert torch.equal(hq, pq) and torch.equal(sx, ps[:, 0])
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
    x = torch.zeros(32, 64, device=cuda)
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


def _within_two_ulps(kern, plain):
    diff = (kern.float() - plain.float()).abs()
    bound = plain.float().abs() * 2.0 ** -7 \
        + float(plain.float().abs().max()) * 2.0 ** -9
    return bool((diff <= bound).all())


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
                                   (128, 256, 1), (64, 384, 2)])
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
