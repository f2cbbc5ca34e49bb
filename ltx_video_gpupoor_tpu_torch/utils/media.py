"""Host-side media utilities: dimension fitting, padding, image resizing
and the conditioning-image preprocessing.

Pinned copies from ``ltx_video_gpupoor_tpu/utils/media.py`` (the JAX
package cannot be imported without jax; ``tests/test_torch_configs.py``
and ``tests/test_torch_i2v_modules.py`` pin them equal):
``calculate_new_dimensions`` (:26), ``calculate_padding`` (:45),
``pad_media`` (:58), ``crop_padding`` (:72, slices numpy arrays and torch
tensors alike), ``resize_image`` (:79), ``resize_and_crop_image`` (:95),
``gaussian_blur_3x3`` (:122), ``crf_compress`` (:163),
``prepare_conditioning_image`` (:224), ``yuv420_to_rgb`` (:242),
``save_video`` (:257) and ``load_video`` (:322).

Every codec route tries the native libx264 shim first
(``utils/native_codec.py`` over ``runtime/h264_codec.cpp``), as the JAX
package does: ``crf_compress`` then an ffmpeg binary, then the cv2 JPEG
approximation, then the identity; ``save_video`` takes the orchestrator's
planar-YUV420 tuple straight to the shim, then imageio (where it and an
ffmpeg backend exist), then OpenCV's ``mp4v``, and records the writer
that ran in ``last_writer``; ``load_video`` reads through the
shim, then imageio, then OpenCV.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

# the writer that wrote the last mp4 (save_video)
last_writer: Optional[str] = None


def calculate_new_dimensions(
    canvas_height: int,
    canvas_width: int,
    height: int,
    width: int,
    fit_into_canvas: bool = True,
    block_size: int = 16,
) -> tuple[int, int]:
    if fit_into_canvas:
        scale1 = min(canvas_height / height, canvas_width / width)
        scale2 = min(canvas_width / height, canvas_height / width)
        scale = max(scale1, scale2)
    else:
        scale = (canvas_height * canvas_width / (height * width)) ** 0.5
    new_height = round(height * scale / block_size) * block_size
    new_width = round(width * scale / block_size) * block_size
    return new_height, new_width


def calculate_padding(
    height: int, width: int, padded_height: int, padded_width: int
) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) pads centering content in the padded frame."""
    pad_h = padded_height - height
    pad_w = padded_width - width
    pad_top = pad_h // 2
    pad_bottom = pad_h - pad_top
    pad_left = pad_w // 2
    pad_right = pad_w - pad_left
    return (pad_left, pad_right, pad_top, pad_bottom)


def pad_media(media: np.ndarray, padding, mode: str = "constant") -> np.ndarray:
    """media [F, H, W, C] in [-1, 1] -> padded to target size.

    Default constant-0 (mid-gray in [-1, 1]) matches the reference's
    ``torch.nn.functional.pad(media_tensor, padding)`` on conditioning
    media (``ltxv.py:543, 559``); ``mode="edge"`` is available for
    callers that prefer replicate padding."""
    left, right, top, bottom = padding
    kw = {"constant_values": 0.0} if mode == "constant" else {}
    return np.pad(
        media, [(0, 0), (top, bottom), (left, right), (0, 0)], mode=mode, **kw
    )


def crop_padding(frames, padding, num_frames: int):
    left, right, top, bottom = padding
    bottom = frames.shape[1] if bottom == 0 else -bottom
    right = frames.shape[2] if right == 0 else -right
    return frames[:num_frames, top:bottom, left:right]


def resize_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Lanczos resize of [H, W, C] uint8 / float image via PIL."""
    from PIL import Image

    if image.dtype != np.uint8:
        arr = np.clip((image + 1.0) * 127.5, 0, 255).astype(np.uint8)
    else:
        arr = image
    out = np.asarray(
        Image.fromarray(arr).resize((width, height), Image.LANCZOS)
    )
    if image.dtype != np.uint8:
        return out.astype(np.float32) / 127.5 - 1.0
    return out


def resize_and_crop_image(
    image: np.ndarray, height: int, width: int, just_crop: bool = False
) -> np.ndarray:
    """Aspect-preserving center-crop to the target aspect ratio, then
    bicubic resize to (height, width) — the reference's
    ``load_image_to_tensor_with_resize_and_crop`` geometry
    (``ltx_video/ltxv.py:85-101``; PIL ``resize`` default = BICUBIC).
    [H, W, C] uint8 in, uint8 out."""
    from PIL import Image

    ih, iw = image.shape[:2]
    aspect_target = width / height
    aspect_frame = iw / ih
    if aspect_frame > aspect_target:
        nw, nh = int(ih * aspect_target), ih
        x0, y0 = (iw - nw) // 2, 0
    else:
        nw, nh = iw, int(iw / aspect_target)
        x0, y0 = 0, (ih - nh) // 2
    cropped = image[y0:y0 + nh, x0:x0 + nw]
    if just_crop:
        return cropped
    if cropped.shape[:2] == (height, width):
        return np.array(cropped)    # PIL's resize to the same size copies
    return np.asarray(
        Image.fromarray(cropped).resize((width, height), Image.BICUBIC)
    )


def gaussian_blur_3x3(image: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(image, (3, 3), 0)`` on a [H, W, C] uint8 frame
    (``ltx_video/ltxv.py:104``) — applied to every conditioning image
    before the CRF round-trip to match the VAE's training distribution.

    cv2 with ksize=3 and sigma=0 uses the fixed separable kernel
    [1, 2, 1]/4 with REFLECT_101 borders and round-half-up fixed-point
    arithmetic; the numpy fallback reproduces that bit-exactly
    ((sum + 8) >> 4 over the 16-weight outer product).
    """
    try:
        import cv2

        return cv2.GaussianBlur(image, (3, 3), 0)
    except Exception:
        return _blur3_np(image)


def _blur3_np(image: np.ndarray) -> np.ndarray:
    """numpy fallback for ``gaussian_blur_3x3`` (bit-exact vs cv2)."""
    arr = np.pad(
        image.astype(np.int32), [(1, 1), (1, 1)] + [(0, 0)] * (image.ndim - 2),
        mode="reflect",
    )
    row = arr[:, :-2] + 2 * arr[:, 1:-1] + arr[:, 2:]
    out = row[:-2] + 2 * row[1:-1] + row[2:]
    return ((out + 8) >> 4).astype(image.dtype)


def _ffmpeg() -> Optional[str]:
    for cand in ("ffmpeg", "/usr/bin/ffmpeg"):
        if shutil.which(cand):
            return cand
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        return None


def crf_compress(image: np.ndarray, crf: int = 29) -> np.ndarray:
    """Encode a frame through libx264 at the given CRF and decode it back,
    matching the VAE's training-data compression artifacts
    (``crf_compressor.py:34-50``). Input/output [H, W, 3] float in [0, 1].

    The native libavcodec/libx264 shim where it builds (the artifact
    distribution the VAE was trained on); then an ffmpeg binary if one
    exists; else a JPEG round-trip approximation through cv2; else the
    identity.
    """
    from . import native_codec

    if native_codec.available():
        arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
        out = native_codec.crf_roundtrip(arr, crf)
        if out is not None:
            return out.astype(np.float32) / 255.0
    ffmpeg = _ffmpeg()
    if ffmpeg is None:
        # no h264 encoder in this image: approximate the compression
        # artifacts with a JPEG round-trip (same DCT-block character)
        try:
            import cv2

            arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
            ok, enc = cv2.imencode(
                ".jpg", arr[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 60]
            )
            if not ok:
                return image
            dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
            return dec.astype(np.float32) / 255.0
        except Exception:
            return image
    arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "in.rgb")
        mp4 = os.path.join(td, "out.mp4")
        arr.tofile(raw)
        try:
            subprocess.run(
                [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo",
                 "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-i", raw,
                 "-c:v", "libx264", "-crf", str(crf), "-pix_fmt", "yuv420p",
                 mp4],
                check=True, capture_output=True,
            )
            out = subprocess.run(
                [ffmpeg, "-y", "-loglevel", "error", "-i", mp4, "-f",
                 "rawvideo", "-pix_fmt", "rgb24", "-"],
                check=True, capture_output=True,
            ).stdout
        except (subprocess.CalledProcessError, OSError):
            return image
        dec = np.frombuffer(out, np.uint8)
        if dec.size != h * w * 3:
            return image
        return dec.reshape(h, w, 3).astype(np.float32) / 255.0


def prepare_conditioning_image(
    image: np.ndarray,
    height: int,
    width: int,
    apply_crf: bool = True,
) -> np.ndarray:
    """``load_media_file`` preprocessing (``ltxv.py:85-110, 530-567``):
    aspect-crop + bicubic resize, 3x3 Gaussian blur, CRF-29 round-trip,
    scale to [-1, 1]. Returns [1, H, W, 3] float32."""
    if image.dtype != np.uint8:
        image = np.clip((image + 1.0) * 127.5, 0, 255).astype(np.uint8)
    img = resize_and_crop_image(image, height, width)
    img = gaussian_blur_3x3(img).astype(np.float32) / 255.0
    if apply_crf:
        img = crf_compress(img)
    return (img * 2.0 - 1.0)[None].astype(np.float32)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Host inverse of the device BT.601 RGB->YUV420 (nearest chroma
    upsample), for writers that need RGB frames."""
    yf = (y.astype(np.float32) - 16.0) / 219.0
    cu = (u.astype(np.float32) - 128.0) / 224.0
    cv = (v.astype(np.float32) - 128.0) / 224.0
    cu = cu.repeat(2, axis=1).repeat(2, axis=2)[:, : y.shape[1], : y.shape[2]]
    cv = cv.repeat(2, axis=1).repeat(2, axis=2)[:, : y.shape[1], : y.shape[2]]
    r = yf + 1.402 * cv
    g = yf - 0.344136 * cu - 0.714136 * cv
    b = yf + 1.772 * cu
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def save_video(frames, path: str, fps: float = 30.0, retries: int = 5) -> str:
    """mp4 writer with a retry loop.

    frames: [F, H, W, 3] float in [-1, 1] or uint8, or a planar-YUV420
    tuple ``(y, u, v)`` from the orchestrator's ``output_type="yuv420"``
    (written as it is by the native shim; converted back to RGB for the
    other writers). The native libx264 shim where it builds, then imageio
    with libx264 where it and an ffmpeg backend exist, else OpenCV's
    ``mp4v``; the module's ``last_writer`` names the one that wrote."""
    global last_writer
    from . import native_codec

    err = None
    if isinstance(frames, tuple):
        y, u, v = frames
        if native_codec.available():
            for _ in range(retries):
                if native_codec.write_mp4_yuv(path, y, u, v, fps=fps, crf=18):
                    last_writer = "native h264 (yuv420)"
                    return path
        frames = yuv420_to_rgb(y, u, v)
    if frames.dtype != np.uint8:
        frames = np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if native_codec.available():
        for _ in range(retries):
            if native_codec.write_mp4(path, frames, fps=fps, crf=18):
                last_writer = "native h264 (rgb)"
                return path
    for _ in range(retries):
        try:
            import imageio

            with imageio.get_writer(
                path, fps=fps, codec="libx264", quality=8,
                pixelformat="yuv420p",
            ) as writer:
                for frame in frames:
                    writer.append_data(frame)
            last_writer = "imageio libx264"
            return path
        except ImportError as e:
            err = e
            break
        except Exception as e:  # a transient file-system race: retry
            err = e
    try:
        import cv2

        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        if writer.isOpened():
            for frame in frames:
                writer.write(np.ascontiguousarray(frame[..., ::-1]))
            writer.release()
            last_writer = "cv2 mp4v"
            return path
    except Exception as e:
        err = e
    raise RuntimeError(f"failed to write video after {retries} tries: {err}")


def load_video(path: str) -> np.ndarray:
    """Read a video into [F, H, W, 3] float32 in [-1, 1]."""
    from . import native_codec

    if native_codec.available():
        arr = native_codec.read_video(path)
        if arr is not None:
            return arr.astype(np.float32) / 127.5 - 1.0
    try:
        import imageio

        frames = [np.asarray(f) for f in imageio.get_reader(path)]
    except Exception:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1])
        cap.release()
    if not frames:
        raise RuntimeError(f"no frames could be read from {path}")
    arr = np.stack(frames).astype(np.float32)
    return arr / 127.5 - 1.0
