"""ctypes bindings for the native mmap safetensors loader
(``runtime/safetensors_loader.cpp``).

A pinned copy of ``ltx_video_gpupoor_tpu/runtime/native_loader.py``
(ctypes and numpy only; ``tests/test_torch_checkpoint.py`` holds it
equal to the Python reader). Tensor payloads are views into the file
mapping, and a parallel page prefetch warms the mapping before the
tensors are copied out. Differences from the JAX copy: the library is
built with ``g++`` from the repository's ``runtime/safetensors_loader.cpp``
into this package's ``build/`` directory (ignored by git), nothing under
``runtime/`` is written; tensors come out as torch tensors (bf16 as its
16-bit pattern viewed as ``torch.bfloat16``, no ``ml_dtypes``); and
:func:`load_safetensors_native` raises where the library cannot be built
or the file not read, so that its caller
(``serving/model_zoo.py::load_ltxv_model``) takes the Python reader and
says which reader ran.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR.parent / "runtime" / "safetensors_loader.cpp"
_SO_PATH = _PKG_DIR / "build" / "libst_loader.so"

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _build_library() -> Optional[str]:
    if not _SRC.is_file():
        return None
    _SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", str(_SRC),
             "-o", str(tmp), "-lpthread"],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _SO_PATH)
    return str(_SO_PATH)


_lib = None
_lib_tried = False


def _get_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True  # never re-run the g++ attempt per call
    fresh = _SO_PATH.is_file() and \
        _SO_PATH.stat().st_mtime >= _SRC.stat().st_mtime
    path = str(_SO_PATH) if fresh else _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.st_open.restype = ctypes.c_void_p
    lib.st_open.argtypes = [ctypes.c_char_p]
    lib.st_error.restype = ctypes.c_char_p
    lib.st_num_tensors.restype = ctypes.c_int64
    lib.st_num_tensors.argtypes = [ctypes.c_void_p]
    lib.st_tensor_name.restype = ctypes.c_char_p
    lib.st_tensor_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.st_tensor_dtype.restype = ctypes.c_char_p
    lib.st_tensor_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.st_tensor_ndim.restype = ctypes.c_int
    lib.st_tensor_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.st_tensor_shape.restype = None
    lib.st_tensor_shape.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.st_tensor_data.restype = ctypes.c_void_p
    lib.st_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.st_tensor_nbytes.restype = ctypes.c_int64
    lib.st_tensor_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.st_metadata.restype = ctypes.c_char_p
    lib.st_metadata.argtypes = [ctypes.c_void_p]
    lib.st_prefetch.restype = None
    lib.st_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.st_close.restype = None
    lib.st_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeSafetensors:
    """A view over a safetensors file through the native loader."""

    def __init__(self, path: str, prefetch_threads: int = 8):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._h = lib.st_open(path.encode())
        if not self._h:
            raise OSError(f"st_open failed: {lib.st_error().decode()}")
        if prefetch_threads:
            lib.st_prefetch(self._h, prefetch_threads)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._h:
            self._lib.st_close(self._h)
            self._h = None

    def keys(self) -> list[str]:
        n = self._lib.st_num_tensors(self._h)
        return [
            self._lib.st_tensor_name(self._h, i).decode() for i in range(n)
        ]

    def metadata(self) -> dict:
        raw = self._lib.st_metadata(self._h).decode()
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return {}

    def tensor(self, index: int) -> torch.Tensor:
        """The tensor as a copy out of the mapping (the mapping is
        read-only and lives until :meth:`close`)."""
        lib, h = self._lib, self._h
        dtype = _DTYPES[lib.st_tensor_dtype(h, index).decode()]
        ndim = lib.st_tensor_ndim(h, index)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        lib.st_tensor_shape(h, index, shape)
        shape = tuple(shape[i] for i in range(ndim))
        nbytes = lib.st_tensor_nbytes(h, index)
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        ptr = lib.st_tensor_data(h, index)
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        raw = np.frombuffer(buf, dtype=np.uint8).copy()
        return torch.from_numpy(raw).view(dtype).reshape(shape)

    def as_dict(self) -> dict[str, torch.Tensor]:
        return {name: self.tensor(i) for i, name in enumerate(self.keys())}


def load_safetensors_native(
    path: str, prefetch_threads: int = 8
) -> tuple[dict[str, torch.Tensor], dict]:
    """``core.checkpoint.load_safetensors`` through the native loader:
    (tensors, parsed ``config`` metadata). Raises where the library
    cannot be built or the file cannot be read."""
    with NativeSafetensors(path, prefetch_threads) as f:
        tensors = f.as_dict()
        meta = f.metadata()
    config = {}
    if "config" in meta:
        try:
            config = json.loads(meta["config"])
        except (json.JSONDecodeError, TypeError):
            config = meta["config"] if isinstance(meta["config"], dict) else {}
    return tensors, config
