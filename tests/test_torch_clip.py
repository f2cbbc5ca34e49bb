"""The CLIP ViT-H/14 vision tower of Wan i2v in the port against the JAX
package, on the CPU, at a small width that keeps CLIP's head dim of 80
(dim 160, 2 heads) and its 257 tokens (224 px in 14-px patches).

``visual`` runs its attention with no mode, as JAX calls it. Pinned to
the exact tier on both sides (the port's ``xla``, JAX's off-TPU default)
the two agree to 1e-5. In the port ``auto`` at d = 80 is the int8 QK+PV
tier (K4), as JAX resolves it on the TPU; it is held against JAX's
``pallas_int8pv`` Pallas kernel run in interpret mode (a test-side
patch), which pads the 257 tokens to 384 with a kv tail the port's call
does not need. ``resize_bicubic`` computes JAX's ``jax.image.resize``
bicubic (Keys a = -0.5, no antialias), which is not torch's
``F.interpolate`` bicubic (a = -0.75); the two are held to 1e-5 on a
smooth image and to 1e-4 on random ones, down and up.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ltx_video_gpupoor_tpu.models.wan import clip as jclip
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.wan import clip as tclip
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

CFG_KW = dict(image_size=224, patch_size=14, dim=160, num_heads=2,
              num_layers=3)                       # head dim 80, 257 tokens
ATOL = 1e-5
PSNR_BAR_DB = 40.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain ops on the calling thread alone (the fresh-thread
    ``torch.exp`` effect of ``tests/test_torch_kernels.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9) * 2
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


@pytest.fixture(scope="module")
def clip_pair():
    params = jax.jit(lambda k: jclip.init_params(
        k, jclip.CLIPVisionConfig(**CFG_KW)))(jax.random.key(3))
    model = tclip.CLIPVision(tclip.CLIPVisionConfig(**CFG_KW), FP32_POLICY)
    model.load_state_dict(from_jax.state_dict(jax.tree.map(np.asarray,
                                                           params)))
    return params, model


def _images(seed=0, n=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 224, 224, 3)).astype(np.float32)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_visual_exact_tier_matches_jax(clip_pair, use_31_block):
    params, model = clip_pair
    img = _images(n=2)
    ref = jclip.visual(params, jclip.CLIPVisionConfig(**CFG_KW),
                       jnp.asarray(img), use_31_block=use_31_block)
    try:
        tattn.set_attention_mode("xla")
        out = tclip.visual(model, torch.from_numpy(img),
                           use_31_block=use_31_block)
    finally:
        tattn.set_attention_mode("auto")
    assert tuple(out.shape) == ref.shape == (2, 257, 160)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_visual_auto_tier_is_k4_and_matches_jax_int8pv(clip_pair,
                                                       monkeypatch):
    """``auto`` at d = 80 takes the int8 QK+PV tier in both packages (JAX's
    TPU policy); the port's plain K4 on the unpadded 257 tokens against
    JAX's interpreted kernel on the padded 384."""
    params, model = clip_pair
    assert tattn.resolve_mode("auto", head_dim=80) == "pallas_int8pv"
    assert tattn.kernel_route("auto", dtype=torch.bfloat16,
                              head_dim=80) == "K4"
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True, block_q=128, block_kv=128))
    img = _images(1)
    try:
        jattn.set_attention_mode("pallas_int8pv")
        ref = jclip.visual(params, jclip.CLIPVisionConfig(**CFG_KW),
                           jnp.asarray(img))
    finally:
        jattn.set_attention_mode("auto")
    calls = []
    plain = tfa.int8_attention_plain
    monkeypatch.setattr(tfa, "int8_attention_plain",
                        lambda *a, **k: calls.append(a[0].q8.shape)
                        or plain(*a, **k))
    out = tclip.visual(model, torch.from_numpy(img))
    assert calls == [(1, 2, 257, 80)] * 2     # 31 of 32 blocks: 2 of 3
    assert _psnr(ref, out) >= PSNR_BAR_DB, f"{_psnr(ref, out):.2f} dB"


def test_resize_bicubic_is_torch_bicubic_near_jax():
    """On a smooth image the port's resize is JAX's
    ``jax.image.resize(..., "bicubic", antialias=False)`` to 1e-5, and
    not torch's own bicubic (Keys a = -0.75), which lies about 5e-4
    apart."""
    yy, xx = np.meshgrid(np.linspace(0, 1, 480), np.linspace(0, 1, 832),
                         indexing="ij")
    img = np.stack([np.sin(3 * xx + 2 * yy), np.cos(5 * yy), xx * yy - 0.5],
                   -1)[None].astype(np.float32)
    out = tclip.resize_bicubic(torch.from_numpy(img), 224)
    assert tuple(out.shape) == (1, 224, 224, 3)
    ref = np.asarray(jclip.resize_bicubic(jnp.asarray(img), 224))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    torch_bicubic = F.interpolate(
        torch.from_numpy(img).permute(0, 3, 1, 2), size=(224, 224),
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert float(np.abs(torch_bicubic.numpy() - ref).max()) > 20 * ATOL
    np.testing.assert_array_equal(tclip.CLIP_MEAN, jclip.CLIP_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_STD, jclip.CLIP_STD)


@pytest.mark.parametrize("h, w, size", [(480, 832, 224), (100, 150, 224),
                                        (224, 224, 224), (37, 53, 16)])
def test_resize_bicubic_matches_jax_on_random_images(h, w, size):
    """Uniform noise in [-1, 1], where a cubic kernel's sign changes and
    the renormalized border taps show: down, up, the identity and an odd
    downscale, each to 1e-4 of JAX's resize, while torch's own bicubic
    lies more than 1e-2 off. The port's eager fp32 weights are within
    2e-7 of the same resize in float64; XLA's compiled weight matrix is up
    to 4e-5 off it (480 -> 224), which sets the bar."""
    img = np.random.default_rng(h * w).uniform(
        -1, 1, (2, h, w, 3)).astype(np.float32)
    out = tclip.resize_bicubic(torch.from_numpy(img), size)
    ref = np.asarray(jclip.resize_bicubic(jnp.asarray(img), size))
    assert out.shape == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    exact = tclip.resize_bicubic(torch.from_numpy(img).double(), size)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=1e-6, rtol=0)
    if (h, w) != (size, size):
        torch_bicubic = F.interpolate(
            torch.from_numpy(img).permute(0, 3, 1, 2), size=(size, size),
            mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
        assert float(np.abs(torch_bicubic.numpy() - ref).max()) > 1e-2
