"""ctypes bindings for the native h264 codec shim
(``runtime/h264_codec.cpp`` over the system libavcodec/libx264).

A pinned copy of ``ltx_video_gpupoor_tpu/utils/native_codec.py`` (ctypes
and numpy only; ``tests/test_torch_native_codec.py`` holds its outputs
byte-equal to the JAX module's). It gives the package the reference's
codec behaviours without an ffmpeg binary or PyAV:

- :func:`crf_roundtrip`: the libx264 CRF-29 conditioning-image round trip;
- :func:`write_mp4` / :func:`write_mp4_yuv`: h264 mp4 output from RGB
  frames or from planar YUV420 (no host colour-space pass);
- :func:`read_video`: h264/mp4 decode for video-to-video inputs.

The one difference from the JAX copy: the shared library is built with
``g++`` from the repository's ``runtime/h264_codec.cpp`` into this
package's ``build/`` directory (ignored by git) at first use, and nothing
under ``runtime/`` is written. Where the build or the load fails (no
compiler, no libavcodec headers), :func:`available` is False and the
callers take their other routes, as in the JAX package: a codec choice,
not a device fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR.parent / "runtime" / "h264_codec.cpp"
_SO_PATH = _PKG_DIR / "build" / "libh264_codec.so"

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build() -> Optional[str]:
    if not _SRC.is_file():
        return None
    _SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", str(_SRC),
             "-o", str(tmp), "-lavcodec", "-lavformat", "-lavutil",
             "-lswscale"],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _SO_PATH)
    return str(_SO_PATH)


def library_path() -> Optional[str]:
    """The built library (built now if it is missing or older than its
    source), or None where it cannot be built."""
    if _SO_PATH.is_file() and _SO_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return str(_SO_PATH)
    return _build()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = library_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.h264_roundtrip.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p
    ]
    lib.h264_roundtrip.restype = ctypes.c_int
    lib.h264_write_mp4.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int,
    ]
    lib.h264_write_mp4.restype = ctypes.c_int
    lib.h264_write_mp4_yuv.argtypes = [
        ctypes.c_char_p, u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ]
    lib.h264_write_mp4_yuv.restype = ctypes.c_int
    lib.h264_read_video.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.h264_read_video.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crf_roundtrip(rgb: np.ndarray, crf: int = 29) -> Optional[np.ndarray]:
    """libx264 encode at ``crf`` + decode back. [H, W, 3] uint8 in/out.
    None when the native shim is unavailable or the codec fails."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty_like(rgb)
    rc = lib.h264_roundtrip(_u8p(rgb), h, w, int(crf), _u8p(out))
    return out if rc == 0 else None


def write_mp4(
    path: str, frames: np.ndarray, fps: float = 30.0, crf: int = 18
) -> bool:
    """Write [F, H, W, 3] uint8 frames as h264 mp4. False on failure."""
    lib = _load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[3] != 3:
        # grayscale/RGBA would make the native encoder read out of
        # bounds or interleave planes wrongly: honour the contract
        return False
    n, h, w = frames.shape[:3]
    rc = lib.h264_write_mp4(
        path.encode(), _u8p(frames), n, h, w, float(fps), int(crf)
    )
    return rc == 0


def write_mp4_yuv(
    path: str,
    y: np.ndarray,              # [F, H, W] uint8
    u: np.ndarray,              # [F, H/2, W/2] uint8
    v: np.ndarray,              # [F, H/2, W/2] uint8
    fps: float = 30.0,
    crf: int = 18,
) -> bool:
    """Write planar-YUV420 frames as h264 mp4, with no host colour-space
    pass: the orchestrator converts RGB to YUV420 on the card, so the
    host fetch moves 1.5 bytes a pixel instead of 3."""
    lib = _load()
    if lib is None:
        return False
    y = np.ascontiguousarray(y, dtype=np.uint8)
    u = np.ascontiguousarray(u, dtype=np.uint8)
    v = np.ascontiguousarray(v, dtype=np.uint8)
    if y.ndim != 3:  # bool-on-failure contract: never raise from here
        return False
    n, h, w = y.shape
    if h % 2 or w % 2 or u.shape != (n, h // 2, w // 2) or u.shape != v.shape:
        return False
    rc = lib.h264_write_mp4_yuv(
        path.encode(), _u8p(y), _u8p(u), _u8p(v), n, h, w, float(fps),
        int(crf),
    )
    return rc == 0


def read_video(path: str) -> Optional[np.ndarray]:
    """Decode a video file to [F, H, W, 3] uint8. None on failure."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    n = lib.h264_read_video(path.encode(), None, 0, ctypes.byref(h),
                            ctypes.byref(w))
    if n <= 0:
        return None
    out = np.empty((n, h.value, w.value, 3), np.uint8)
    n2 = lib.h264_read_video(path.encode(), _u8p(out), n, ctypes.byref(h),
                             ctypes.byref(w))
    return out[:n2] if n2 > 0 else None
