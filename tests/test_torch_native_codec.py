"""The native h264 codec route: the port's pinned ``utils/native_codec.py``
against the JAX module (both build ``runtime/h264_codec.cpp``, the port
into its own ``build/``), and its routing: ``save_video`` takes the
planar-YUV420 tuple to the native writer, ``crf_compress`` and
``load_video`` try the shim first, and the server and the CLI ask the
orchestrator for ``yuv420`` when the shim is available, ``pixels``
otherwise. Outputs are compared byte for byte: the same encoder on the
same input. Where the shim does not build (no libavcodec headers),
``available()`` is False in both packages and the routes fall back."""

import filecmp
import os

import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu.utils import native_codec as jnative
from ltx_video_gpupoor_tpu_torch.serving import cli as tcli
from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
from ltx_video_gpupoor_tpu_torch.serving import orchestrator as torch_orch
from ltx_video_gpupoor_tpu_torch.serving import server as tserver
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia
from ltx_video_gpupoor_tpu_torch.utils import native_codec as tnative

import test_torch_serving as serving   # the POST body helpers

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1)
    return np.stack([(base + 9 * i + rng.integers(0, 8, base.shape)) % 256
                     for i in range(6)]).astype(np.uint8)


@pytest.fixture
def native():
    if not jnative.available():
        pytest.skip("the native h264 shim does not build on this machine "
                    "(no libavcodec headers)")
    assert tnative.available()
    return tnative


def test_available_equal_jax():
    assert tnative.available() == jnative.available()
    path = tnative.library_path()
    if tnative.available():
        assert os.path.dirname(path).endswith(
            os.path.join("ltx_video_gpupoor_tpu_torch", "build"))


def test_write_mp4_byte_equal_jax(native, frames, tmp_path):
    a, b = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    assert jnative.write_mp4(a, frames, fps=24.0, crf=18)
    assert native.write_mp4(b, frames, fps=24.0, crf=18)
    assert filecmp.cmp(a, b, shallow=False)
    back = native.read_video(b)
    np.testing.assert_array_equal(back, jnative.read_video(a))
    assert back.shape == frames.shape
    # the bool-on-failure contract: planes of the wrong shape
    assert not native.write_mp4(b, frames[..., 0])


def test_write_mp4_yuv_byte_equal_jax(native, frames, tmp_path):
    y, u, v = (np.ascontiguousarray(p) for p in _yuv(frames))
    a, b = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    assert jnative.write_mp4_yuv(a, y, u, v, fps=30.0)
    assert native.write_mp4_yuv(b, y, u, v, fps=30.0)
    assert filecmp.cmp(a, b, shallow=False)
    assert not native.write_mp4_yuv(b, y[:, :47], u, v)   # odd height


@pytest.mark.parametrize("crf", [18, 29])
def test_crf_roundtrip_equal_jax(native, frames, crf):
    out = native.crf_roundtrip(frames[2], crf)
    np.testing.assert_array_equal(out, jnative.crf_roundtrip(frames[2], crf))
    assert out.shape == frames[2].shape and out.dtype == np.uint8


def test_crf_compress_takes_the_native_route(native, frames):
    img = frames[3].astype(np.float32) / 255.0
    out = tmedia.crf_compress(img, 29)
    np.testing.assert_array_equal(out, jmedia.crf_compress(img, 29))
    np.testing.assert_array_equal(
        out, native.crf_roundtrip(frames[3], 29).astype(np.float32) / 255.0)


def _yuv(frames):
    rgb = torch.from_numpy(frames).float() / 127.5 - 1.0
    return tuple(p.numpy() for p in torch_orch._rgb_to_yuv420(rgb))


def test_save_video_routes_yuv420_to_the_native_writer(native, frames,
                                                       tmp_path):
    planes = _yuv(frames)
    a, b = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    jmedia.save_video(planes, a, fps=25.0)
    tmedia.save_video(planes, b, fps=25.0)
    assert tmedia.last_writer == "native h264 (yuv420)"
    assert filecmp.cmp(a, b, shallow=False)
    back = tmedia.load_video(b)
    assert back.shape == frames.shape and back.dtype == np.float32
    np.testing.assert_array_equal(back, jmedia.load_video(a))
    tmedia.save_video(frames, b, fps=25.0)
    assert tmedia.last_writer == "native h264 (rgb)"


def test_save_video_without_the_shim_converts_yuv420(monkeypatch, frames,
                                                     tmp_path):
    """Where the shim is unavailable the planes go back to RGB for the
    other writers (cv2's mp4v here; imageio is tried first where it and an
    ffmpeg backend exist)."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    out = str(tmp_path / "cv2.mp4")
    tmedia.save_video(_yuv(frames), out, fps=25.0)
    assert tmedia.last_writer in ("imageio libx264", "cv2 mp4v")
    assert tmedia.load_video(out).shape == frames.shape


@pytest.mark.parametrize("shim", [True, False])
def test_cli_asks_for_yuv420_when_the_shim_is_available(monkeypatch,
                                                        tmp_path, shim):
    if shim and not tnative.available():
        pytest.skip("the native h264 shim does not build on this machine")
    if not shim:
        monkeypatch.setattr(tnative, "available", lambda: False)
    asked = []
    real = torch_orch.LTXVideoGenerator.generate

    def spy(self, *args, **kwargs):
        asked.append(kwargs["output_type"])
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch_orch.LTXVideoGenerator, "generate", spy)
    out = tmp_path / "cli.mp4"
    tcli.main(["--prompt", "x", "--demo", "--device", "cpu", "--height",
               "64", "--width", "64", "--video-length", "9",
               "--num-inference-steps", "2", "--output-path", str(out)])
    assert asked == ["yuv420" if shim else "pixels"]
    assert tmedia.load_video(str(out)).shape == (9, 64, 64, 3)
    assert (tmedia.last_writer == "native h264 (yuv420)") == shim


@pytest.mark.parametrize("shim", [True, False])
def test_server_asks_for_yuv420_when_the_shim_is_available(monkeypatch,
                                                           tmp_path, shim):
    if shim and not tnative.available():
        pytest.skip("the native h264 shim does not build on this machine")
    if not shim:
        monkeypatch.setattr(tnative, "available", lambda: False)
    asked = []
    real = torch_orch.LTXVideoGenerator.generate

    def spy(self, *args, **kwargs):
        asked.append(kwargs["output_type"])
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch_orch.LTXVideoGenerator, "generate", spy)
    svc = tserver.InferenceService(model=tzoo.build_demo_model(
        0, device="cpu"), outputs_dir=str(tmp_path), warmup_spec="off")
    image = np.random.default_rng(1).integers(0, 255, (64, 64, 3)).astype(
        np.uint8)
    status, payload = svc.run(serving._body(image), "http://host/")
    assert status == 200, payload
    assert asked == ["yuv420" if shim else "pixels"]
    path = svc.download_path(payload[0]["video"].rsplit("/", 1)[1])
    assert tmedia.load_video(path).shape == (9, 64, 64, 3)
