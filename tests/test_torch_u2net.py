"""U2-Net (U2-NetP's widths) and background removal in the port against
the JAX package on the CPU, in fp32, on a random ``u2netp.pth`` in the
official naming (``tools/synthetic_ckpt.py``): ``forward`` on an
odd-sized input (ceil-mode pools, bilinear skips that do not double),
``salience_map``
through the rembg pipeline at 320x320, the ``u2net.pth`` conversion with
its batch-norm fold, and ``remove_background`` on a checkpoint file with
and without the matting refinement, without the variable (the images
unchanged, one warning), and with a model that raises (the error
propagates: the port has no rembg or identity fallback). JAX's weights
are carried over by ``core/from_jax.py``. Tolerance: 1e-4 of the largest
magnitude (salience in [0, 1]; the 8-bit Lanczos resize back may move a
value by one step, 1/255, where the two maps straddle a rounding edge).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models import u2net as ju
from ltx_video_gpupoor_tpu.utils import video_ops as jvo
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.models import u2net as tu
from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
from ltx_video_gpupoor_tpu_torch.utils import video_ops as tvo

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    sd = sc.u2net_tensors(tu.U2NETP)
    params = ju.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, ju.U2NETP)
    model = tu.U2Net(tu.U2NETP)
    model.load_state_dict(tu.convert_torch_state_dict(sd, tu.U2NETP))
    return sd, params, model


def test_convert_equals_jax(pair):
    sd, params, model = pair
    want = from_jax.u2net_state_dict(jax.tree.map(np.asarray, params))
    got = tu.convert_torch_state_dict(sd, tu.U2NETP)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_forward_matches_jax(pair):
    _, params, model = pair
    x = np.random.default_rng(1).standard_normal(
        (1, 44, 36, 3)).astype(np.float32)
    ref = np.asarray(ju.forward(params, ju.U2NETP, jnp.asarray(x)))
    out = tu.forward(model, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 44, 36, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def _image(h=72, w=96, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 90 * np.cos(yy / 7.0),
                    (xx + yy) * 255.0 / (h + w)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)


def test_salience_map_matches_jax(pair):
    _, params, model = pair
    img = _image()
    ref = ju.salience_map(params, ju.U2NETP, img)
    out = tu.salience_map(model, img)
    assert out.shape == ref.shape == img.shape[:2]
    # the resize back quantizes to 8 bits: equal up to one step
    assert np.abs(out - ref).max() <= 1 / 255 + 1e-6
    assert np.mean(out != ref) < 0.01


@pytest.mark.parametrize("matting", ["1", "0"])
def test_remove_background_matches_jax(pair, tmp_path, monkeypatch,
                                       matting):
    sd, _, _ = pair
    path = tmp_path / "u2netp.safetensors"
    tckpt.save_safetensors(str(path), sd)
    monkeypatch.setenv("LTXV_TPU_U2NET_PATH", str(path))
    monkeypatch.setenv("LTXV_TPU_REMBG_MATTING", matting)
    monkeypatch.setattr(jvo, "_u2net_cache", {})
    monkeypatch.setattr(tvo, "_u2net_cache", {})
    imgs = [_image(40, 48, 3)]
    ref = jvo.remove_background(imgs)[0]
    out = tvo.remove_background(imgs, device="cpu")[0]
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 2


def test_remove_background_without_a_model(monkeypatch, caplog):
    monkeypatch.delenv("LTXV_TPU_U2NET_PATH", raising=False)
    monkeypatch.setattr(tvo, "_warned", set())
    imgs = [_image(8, 8)]
    with caplog.at_level(logging.WARNING):
        assert tvo.remove_background(imgs) is imgs
        assert tvo.remove_background(imgs) is imgs
    warned = [r for r in caplog.records if "LTXV_TPU_U2NET_PATH" in
              r.getMessage()]
    assert len(warned) == 1


def test_remove_background_error_propagates(pair, tmp_path, monkeypatch):
    """A configured model that fails raises; JAX would fall through to
    rembg or the identity."""
    sd, _, _ = pair
    path = tmp_path / "u2netp.safetensors"
    tckpt.save_safetensors(str(path), sd)
    monkeypatch.setenv("LTXV_TPU_U2NET_PATH", str(path))
    monkeypatch.setattr(tvo, "_u2net_cache", {})

    def broken(model, image):
        raise RuntimeError("a device fault")

    monkeypatch.setattr(tu, "salience_map", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        tvo.remove_background([_image(8, 8)], device="cpu")
    monkeypatch.setenv("LTXV_TPU_U2NET_PATH", str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError):
        tvo.remove_background([_image(8, 8)], device="cpu")
