"""K1f's arithmetic on the tensor cores, emulated on the CPU.

K1f (``csrc/flash_attention_fp32.cu``) takes its fp32 products on TF32
``wgmma`` as three TF32 products: each operand ``a`` splits into ``big =
tf32_rna(a)`` and ``small = tf32_rna(a - big)``, and ``A.B ~ Ab.Bb + Ab.Bs
+ As.Bb`` with fp32 accumulation (the dropped ``As.Bs`` is about 2**-22 of
``|A||B|``). These tests run that arithmetic in torch, tile by tile as the
kernel steps its online softmax (the scores' and P's splits, the exp2
domain, the running max), and hold it against the plain versions and the
JAX reference at the fp32 attention tolerance, atol = rtol = 2e-5, the
tolerance the card check holds the kernel to. A tolerance the emulation
misses would be missed by the kernel too. They also pin the P.V operand
order: the kv rows of V^T inside each 8-row group in the order that makes
the fp32 accumulator's score columns the TF32 A fragment (``K1F_PV_ORDER``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa

ATOL = RTOL = 2e-5          # tests/test_flash_attention.py:26


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, ties away
    from zero (the bit pattern is sign and magnitude, so adding half of
    the dropped 13 bits' weight rounds the magnitude up at a tie)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_mm(a, b):
    """``a @ b`` as the kernel takes it: three TF32 products summed in
    fp32 (each product of two TF32 values is exact in fp32)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (ab @ bb + ab @ bs) + as_ @ bb


def emulate_k1f(q, k, v, *, tile_kv, scale=None, kv_valid=None,
                score_bound=None):
    """K1f's exact (or, with ``score_bound``, bounded) variant in fp32,
    [B, H, S, D]: the scores of each kv tile by split_mm, the online
    softmax in the exp2 domain, P split and multiplied with V the same
    way, o = acc / l."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    c = np.float32(scale * tfa.LOG2E)
    kv_end = skv if kv_valid is None else min(skv, kv_valid)
    m = torch.full((b, h, sq, 1), tfa.M_FLOOR)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for c0 in range(0, kv_end, tile_kv):
        c1 = min(c0 + tile_kv, skv)
        s = split_mm(q, k[:, :, c0:c1].transpose(-1, -2))
        cols = torch.arange(c0, c1)
        s = torch.where(cols < kv_end, s, tfa.NEG_INF)
        if score_bound is not None:
            sb = np.float32(score_bound * tfa.LOG2E)
            p = torch.exp2(torch.clamp(s * c, max=sb) - sb)
            l = l + p.sum(-1, keepdim=True)
        else:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha
            m = m_new
        acc = acc + split_mm(p, v[:, :, c0:c1])
    return acc / torch.where(l > 0, l, 1.0)


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d),
                                                 dtype=np.float32))
            for n in (sq, skv, skv)]


def test_tf32_rna_rounds_to_ten_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11,
                      -(1.0 + 2**-11), 1.0 + 2**-12, 3.0e38])
    got = tf32_rna(x)
    assert got.tolist()[:5] == [1.0, 1.0 + 2**-10, 1.0 + 2**-9,
                                -(1.0 + 2**-10), 1.0]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big, small = split(torch.randn(1000, generator=torch.Generator()
                                   .manual_seed(0)))
    assert (small.abs() <= big.abs() * 2.0**-11).all()


@pytest.mark.parametrize("d,sq,skv,kv_valid,tile_kv", [
    (64, 256, 3840, None, 64), (128, 256, 3840, None, 32),
    (64, 128, 128, None, 64), (128, 200, 1000, 777, 32),
    (64, 70, 5280, 5000, 64)])
def test_split_tf32_meets_the_fp32_tolerance(d, sq, skv, kv_valid, tile_kv):
    q, k, v = _qkv(d + skv, 1, 2, sq, skv, d)
    got = emulate_k1f(q, k, v, tile_kv=tile_kv, kv_valid=kv_valid)
    plain = tfa.reference_attention(q, k, v, kv_valid=kv_valid)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)
    if kv_valid is None:       # the JAX reference takes no kv tail
        ref = jfa.reference_attention(*(jnp.asarray(t.numpy())
                                        for t in (q, k, v)))
        torch.testing.assert_close(got, torch.from_numpy(np.asarray(ref)),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d,tile_kv", [(64, 64), (128, 32)])
def test_split_tf32_bounded_meets_the_fp32_tolerance(d, tile_kv):
    q, k, v = _qkv(d, 1, 2, 192, 2048, d)
    q[0, 0, 3] *= 60            # a row over the bound, as the card check's
    got = emulate_k1f(q, k, v, tile_kv=tile_kv, score_bound=20.0)
    plain = tfa.bounded_attention_plain(q, k, v, score_bound=20.0)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)


def test_one_tf32_product_misses_the_tolerance():
    """The check has teeth: products of the TF32-rounded operands alone
    (what an fp32 operand read as TF32 gives) miss 2e-5."""
    q, k, v = _qkv(1, 1, 2, 128, 1024, 64)
    c = 64 ** -0.5
    s = tf32_rna(q) @ tf32_rna(k).transpose(-1, -2) * c
    p = torch.softmax(s, -1)
    got = tf32_rna(p) @ tf32_rna(v)
    plain = tfa.reference_attention(q, k, v)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)


def test_pv_order_makes_the_accumulator_the_a_fragment():
    """Thread t of a quad holds score columns 2t and 2t + 1 of each
    8-column group (the fp32 accumulator); the TF32 A fragment of an
    8-deep k-step wants k indices t (a0, a1) and t + 4 (a2, a3). V^T
    lays kv row 2t + i at k index t + 4i, so each thread's accumulator
    registers (4j, 4j + 1) are its A fragment's (a0, a2) and P.V over the
    permuted k order is P.V."""
    order = tfa.K1F_PV_ORDER
    assert sorted(order) == list(range(8))
    for t in range(4):
        for i in range(2):
            assert order[t + 4 * i] == 2 * t + i
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((16, 64), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32))
    perm = torch.tensor([8 * g + o for g in range(8) for o in order])
    torch.testing.assert_close(p[:, perm] @ v[perm], p @ v, atol=1e-5,
                               rtol=1e-5)
