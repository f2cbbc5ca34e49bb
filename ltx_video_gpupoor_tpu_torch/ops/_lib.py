"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library name carries a hash of the sources, so an edited source builds
a new library at its first use; the build goes to ``build/`` inside the
package (listed in ``.gitignore``). Nothing here runs at import time.

Every C entry point takes its tensors as pointers, the stream last, and
returns ``cudaGetLastError()``; :func:`check` turns a nonzero code into
an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float
L = ctypes.c_longlong

# C signatures: name -> argtypes (restype is int, the cudaError_t, but for
# RESTYPES).
SIGNATURES = {
    # q, k, v, out, q_seg, kv_seg, B, H, Sq, Skv, D,
    # q strides (b, h, s), k strides, v strides, out strides,
    # kv_valid (-1 = none), causal, mask kind (flash_attention.MASK_KINDS),
    # scale, stream
    "k1_flash_attention_bf16": [P, P, P, P, P, P, I, I, I, I, I,
                                I, I, I, I, I, I, I, I, I, I, I, I,
                                I, I, I, F, P],
    # K1's arguments, then bound_log2 before the stream
    "k3_flash_attention_bounded_bf16": [P, P, P, P, P, P, I, I, I, I, I,
                                        I, I, I, I, I, I, I, I, I, I, I, I,
                                        I, I, I, F, F, P],
    # q, k, v, out ([B, S, H*D]), B, S, Skv, H, D, q/k/v/out strides
    # (batch, token), kv_valid (-1 = none), mask kind, scale, stream
    "k6_flash_attention_hp_bf16": [P, P, P, P, I, I, I, I, I,
                                   I, I, I, I, I, I, I, I, I, I, F, P],
    # q8, k8, v (V^T int8 in K4's kv order, or bf16), out, q_seg, kv_seg,
    # q_scale, k_scale, v_scale, B, H, Sq, Skv, D, q/k/v/out strides
    # (b, h, s; V^T: b, h, d), ks_block, nks, kv_valid (-1 = none), causal,
    # pv_int8, mask kind, stream
    "k4_flash_attention_int8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                I, I, I, I, I, I, I, I, I, I, I, I,
                                I, I, I, I, I, I, P],
    # K3q: q8, k8, v (bf16), out, q_seg, kv_seg, q_scale, k_scale (a kv
    # row's), B, H, Sq, Skv, D, q/k/v/out strides (b, h, s), nks, kv_valid
    # (-1 = none), causal, mask kind, bound_log2, stream
    "k3q_flash_attention_int8_bounded": [P, P, P, P, P, P, P, P, I, I, I, I,
                                         I, I, I, I, I, I, I, I, I, I, I, I,
                                         I, I, I, I, I, F, P],
    # x, M, K, x_dtype (0 bf16, 1 f32), xq (rows of round_up(K, 16)), sx,
    # stream
    "k2_quantize_rows": [P, I, I, I, P, P, P],
    # x, M, K, x_dtype, sx (given, [M] fp32), xq, stream
    "k2_quantize_rows_scaled": [P, I, I, I, P, P, P],
    # x, B, H, S, D, x strides (b, h, s), x_dtype, c (the scale's factor),
    # xq, sx, scale_pitch, stream
    "k2_prologue_quantize": [P, I, I, I, I, L, L, L, I, F, P, P, I, P],
    # xq, w, M, N, K, sx, sw, bias, out, out_mode (0 s32, 1 bf16, 2 f32),
    # stream
    "k2_int8_gemm": [P, P, I, I, I, P, P, P, P, I, P],
    # x, scale, shift, M, K, x_dtype (0 bf16, 1 f32), rows_per_group, eps,
    # xq, sx, stream
    "k5_norm_mod_quantize_rows": [P, P, P, I, I, I, I, F, P, P, P],
    # x, scale, shift, M, K, x_dtype, rows_per_group, eps, xq, sx
    # (scratch), w, N, sw, bias, out, out_mode (0 s32, 1 bf16, 2 f32),
    # stream
    "k5_norm_mod_int8_matmul": [P, P, P, I, I, I, I, F, P, P, P, I, P, P, P,
                                I, P],
    # K1f: q, k, v, out, q_seg, kv_seg, q_scale, k_scale, v_scale, B, H,
    # Sq, Skv, D, q/k/v/out strides (b, h, s; int8 V^T: b, h, d), kv_valid
    # (-1 = none), causal, mask kind, variant (K1F_VARIANTS), k_block, nks,
    # scale * log2(e), score_bound * log2(e), stream
    "k1f_flash_attention_fp32": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                 I, I, I, I, I, I, I, I, I, I, I, I,
                                 I, I, I, I, I, I, F, F, P],
    # q, k, v, out, B, H, S, D, q/k/v/out strides (b, h, s), block_kv, nsub,
    # D**-0.5 * log2(e), stream
    "k8_flash_attention_pipelined_bf16": [P, P, P, P, I, I, I, I,
                                          I, I, I, I, I, I, I, I, I, I, I, I,
                                          I, I, F, P],
    # body (0 tensor cores, 1 CUDA cores fp32, 2 CUDA cores bf16), p, B*H,
    # S/p, D -> blocks per rank of one cooperative launch (-1: none)
    "k7_ring_blocks": [I, I, I, I, I],
    # body, B*H, S/p, D -> floats of softmax state per rank (a long long)
    "k7_ring_state_floats": [I, I, I, I],
    # per-rank pointer arrays q, k, v, out, kslot, vslot, state; the tensor
    # maps' buffer and whether its slot maps are written; the arrived and
    # done counters; body, p, B, H, S/p, D; q/k/v/out strides (b, h, s);
    # blocks per rank, the counters' target, scale, the planted fault's rank
    # and step (-1 = none), stream
    "k7_ring_attention": [P, P, P, P, P, P, P, P, I, P, P, I, I, I, I, I, I,
                          I, I, I, I, I, I, I, I, I, I, I, I,
                          I, U, F, I, I, P],
    # K7 once per card: body, B*H, S/p, D -> blocks of one rank's launch
    # (-1: none)
    "k7_card_blocks": [I, I, I, I],
    # body, B*H, S/p, D -> bytes of a rank's workspace (a long long)
    "k7_card_workspace_bytes": [I, I, I, I],
    # this rank's q, k, v, out; its workspace, the right and the left
    # neighbour's (peer-mapped); its state; the maps' buffer and whether
    # its slot maps are written; body, rank, p, B, H, S/p, D; q/k/v/out
    # strides (b, h, s); blocks, the call's epoch, scale, the planted
    # fault's rank and step (-1 = none), a spin's bound in s, stream
    "k7_ring_attention_card": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                               I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                               I, U, F, I, I, F, P],
    # workspace, stream, int* status: waits for the stream, reads it
    "k7_card_status": [P, P, P],
    # device, bytes, void** ptr, the IPC handle's bytes (out)
    "k7_ipc_alloc": [I, L, P, P],
    "k7_ipc_handle_bytes": [],
    # device, handle, void** ptr
    "k7_ipc_open": [I, P, P],
    "k7_ipc_close": [I, P],
    "k7_device_free": [I, P],
    # device, peer, int* can
    "k7_can_access_peer": [I, I, P],
}
# entries that return something other than a cudaError_t
RESTYPES = {"k7_ring_state_floats": ctypes.c_longlong,
            "k7_card_workspace_bytes": ctypes.c_longlong}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libltx_kernels_{source_hash()}.so"


def build(force: bool = False,
          parallel: bool = True) -> tuple[Path, float, str]:
    """Compile the kernels unless a library for these sources exists.

    ``parallel=False`` compiles one source after another, to measure what
    starting them together saves. Returns ``(path, seconds,
    ptxas_report)``; seconds and report are 0 and "" when nothing was
    compiled."""
    out = library_path()
    if out.exists() and not force:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    procs, results = [], []
    for src, obj in zip(sources(), objects):
        procs.append(subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
             "-fPIC", "-Xptxas=-v", "-lineinfo", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        if not parallel:
            results.append((procs[-1], *procs[-1].communicate()))
    if parallel:
        results = [(proc, *proc.communicate()) for proc in procs]
    try:
        for proc, stdout, stderr in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{stdout}\n{stderr}")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objects)], capture_output=True, text=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    report = "".join(stderr for _, _, stderr in results)
    os.replace(tmp, out)
    return out, seconds, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` at first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "?"
        raise RuntimeError(f"{what}: CUDA error {code} on {name}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(route, device, *tensors) -> None:
    """Raise where a call would launch kernel ``route`` (a name, or a
    function that gives it, called only then) on CUDA tensors that
    autograd is recording: the kernels write into outputs with no
    backward, so the inputs would get no gradient through them. Training
    runs the ``xla`` attention tier and dense linears (plain torch, as the
    JAX trainer runs XLA); nothing here swaps one in. CPU tensors take the
    plain versions, which autograd passes through."""
    import torch

    if torch.device(device).type != "cuda" or not torch.is_grad_enabled() \
            or not any(t is not None and t.requires_grad for t in tensors):
        return
    route = route() if callable(route) else route
    if route != "xla":
        raise RuntimeError(
            f"kernel route {route} has no backward: under autograd run "
            "attn_mode='xla' (the plain fp32 attention) and dense "
            "(unquantized) linears")


# ---- device memory outside PyTorch's caching allocator, and CUDA IPC ----
# (K7 once per card: a rank's workspace is one cudaMalloc'd allocation
# whose IPC handle its neighbours map; a tensor from the caching allocator
# may lie inside a larger segment, and a handle maps whole allocations)


def _index(device) -> int:
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device memory and IPC need a CUDA device, not "
                         f"{device}")
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def device_alloc(nbytes: int, device) -> tuple[int, bytes]:
    """``cudaMalloc`` of ``nbytes`` on ``device``, zeroed; returns the
    pointer and its IPC handle (``cudaIpcGetMemHandle``). Free it with
    :func:`device_free`."""
    lib = library()
    ptr = ctypes.c_void_p()
    handle = ctypes.create_string_buffer(lib.k7_ipc_handle_bytes())
    check(lib.k7_ipc_alloc(_index(device), nbytes, ctypes.byref(ptr),
                           handle), f"cudaMalloc + IPC handle of {nbytes} B")
    return ptr.value, handle.raw


def device_free(ptr: int, device) -> None:
    check(library().k7_device_free(_index(device), ptr), "cudaFree")


def ipc_open(handle: bytes, device) -> int:
    """Map another process's allocation into this one
    (``cudaIpcOpenMemHandle`` with ``cudaIpcMemLazyEnablePeerAccess``);
    returns the pointer. Unmap it with :func:`ipc_close`."""
    ptr = ctypes.c_void_p()
    check(library().k7_ipc_open(_index(device), handle, ctypes.byref(ptr)),
          "cudaIpcOpenMemHandle")
    return ptr.value


def ipc_close(ptr: int, device) -> None:
    check(library().k7_ipc_close(_index(device), ptr),
          "cudaIpcCloseMemHandle")


def can_access_peer(device: int, peer: int) -> bool:
    """``cudaDeviceCanAccessPeer``: may ``device`` map ``peer``'s memory."""
    can = ctypes.c_int()
    check(library().k7_can_access_peer(device, peer, ctypes.byref(can)),
          "cudaDeviceCanAccessPeer")
    return bool(can.value)
