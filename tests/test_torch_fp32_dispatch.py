"""Which kernel ``FP32_POLICY`` selects in each attention tier
(``ops.attention.kernel_route``, the rule that ``attention`` and
``attention_packed`` follow on the card, where K1f's launch counters hold
them to it: ``chip_smoke.py`` ``[k1f]`` and ``tests/test_torch_cuda.py``),
and that on the CPU the fp32 tiers still take the plain versions and
return fp32, agreeing with the JAX tiers in fp32 (tolerance: the JAX
tests' fp32 2e-5 for exact and bounded attention; the int8 tiers at 2e-2,
their own noise against JAX's kv blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

FP32_ROUTES = {
    # (mode, head dim, bounded) -> the kernel on fp32 operands
    ("auto", 64, False): "K1f exact", ("auto", 64, True): "K1f bounded",
    ("auto", 128, False): "K1f pv8", ("auto", 128, True): "K1f bounded",
    ("pallas", 64, False): "K1f exact", ("pallas", 128, True): "K1f bounded",
    ("pallas_hp", 128, False): "K1f exact",
    ("pallas_int8", 64, False): "K1f qk8",
    ("pallas_int8", 128, True): "K1f qk8_bounded",
    ("pallas_int8pv", 64, False): "K1f pv8",
    ("pallas_int8pv", 128, True): "K1f pv8",     # the bound is dropped
    ("xla", 64, False): "xla", ("xla", 128, True): "xla",
}
BF16_ROUTES = {
    ("auto", 64, False): "K1", ("auto", 128, False): "K4",
    ("auto", 128, True): "K3", ("pallas_int8", 128, True): "K3q",
    ("pallas_int8pv", 128, True): "K4", ("pallas_hp", 64, False): "K1",
}


@pytest.mark.parametrize("key", sorted(FP32_ROUTES))
def test_fp32_policy_route(key):
    mode, d, bounded = key
    got = tattn.kernel_route(mode, dtype=torch.float32, head_dim=d,
                             score_bound=40.0 if bounded else None)
    assert got == FP32_ROUTES[key]


@pytest.mark.parametrize("key", sorted(BF16_ROUTES))
def test_bf16_routes_unchanged(key):
    mode, d, bounded = key
    assert tattn.kernel_route(mode, dtype=torch.bfloat16, head_dim=d,
                              score_bound=40.0 if bounded else None) \
        == BF16_ROUTES[key]


def test_packed_routes():
    """``attention_packed`` in ``pallas_hp``: K6 for bf16, K1f on the
    head-packed strides for fp32; an odd head count at D=64 or a bound
    splits the heads, as in JAX."""
    kw = dict(head_dim=64, heads=4)
    assert tattn.kernel_route("pallas_hp", dtype=torch.bfloat16, **kw) == "K6"
    assert tattn.kernel_route("pallas_hp", dtype=torch.float32,
                              **kw) == "K1f exact"
    assert tattn.kernel_route("pallas_hp", dtype=torch.float32, head_dim=64,
                              heads=3) == "K1f exact"
    assert tattn.kernel_route("pallas_hp", dtype=torch.bfloat16, head_dim=64,
                              heads=3) == "K1"
    assert tattn.kernel_route("pallas_hp", dtype=torch.float32, heads=4,
                              head_dim=128, score_bound=30.0) == "K1f bounded"


def test_k1f_variant():
    assert tfa.K1F_VARIANTS == ("exact", "bounded", "qk8", "qk8_bounded",
                                "pv8")
    assert tfa.k1f_variant() == "exact"
    assert tfa.k1f_variant(bounded=True) == "bounded"
    assert tfa.k1f_variant(qk_int8=True) == "qk8"
    assert tfa.k1f_variant(qk_int8=True, bounded=True) == "qk8_bounded"
    assert tfa.k1f_variant(qk_int8=True, pv_int8=True) == "pv8"
    with pytest.raises(ValueError, match="online-softmax"):
        tfa.k1f_variant(qk_int8=True, pv_int8=True, bounded=True)


@pytest.mark.parametrize("mode,bound", [("pallas", None), ("pallas", 8.0),
                                        ("pallas_int8", None),
                                        ("pallas_int8pv", None),
                                        ("xla", None)])
def test_fp32_tiers_on_the_cpu_match_jax(monkeypatch, mode, bound):
    """The same tiers on CPU tensors: the plain versions, fp32 out, equal
    to JAX's tier in fp32 (JAX's Pallas kernel in interpret mode)."""
    import functools

    from ltx_video_gpupoor_tpu.ops import flash_attention as jfa

    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jattn.attention(*map(jnp.asarray, (q, k, v)), mode=mode,
                                     score_bound=bound))
    out = tattn.attention(*map(torch.from_numpy, (q, k, v)), mode=mode,
                          score_bound=bound)
    assert out.dtype == torch.float32
    tol = 2e-2 if "int8" in mode else 2e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)
