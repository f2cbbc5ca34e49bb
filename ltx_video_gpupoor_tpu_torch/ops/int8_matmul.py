"""Dynamic-int8 linear: kernel K2 and its plain version.

Port of ``ltx_video_gpupoor_tpu/ops/int8_matmul.py::int8_dynamic_matmul_fused``
(:59, Pallas ``_kernel`` :40), computing what the JAX default path computes,
``ops/quant.py::int8_dynamic_matmul`` (:190-206): per-row activation
scales ``max(absmax / 127, 1e-8)``, round half to even, clip to +-127,
int8 x int8 -> int32, ``acc * s_x * s_w + bias`` in fp32, cast to the
input dtype.

:func:`int8_linear_scaled` is K2 with a given per-row scale (the row
kernel skips its amax pass), for the row-parallel linears of tensor
parallelism (``ops/quant.py::row_parallel_matmul``).

Weights are ``w_int8 [N, K]`` (torch's ``[out, in]``; the JAX package
stores ``[K, N]``) with fp32 per-output-channel scales ``[N]``.
:func:`int8_linear` takes :func:`int8_linear_plain` for CPU tensors and
launches ``csrc/int8_linear.cu`` for CUDA tensors, or raises. Both take
any K, as JAX does: the row kernel writes the codes in rows of
``round_up(K, 16)`` bytes with zero codes past K, which add nothing to the
int32 accumulator, and the GEMM runs at that padded K.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_X_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_OUT_MODES = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}


def quantize_rows_plain(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[M, K]`` -> (int8 ``[M, K]``, fp32 scales ``[M, 1]``)."""
    xf = x2.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor keeps this an IEEE division on the card too (a
    # Python scalar divisor becomes a multiply by its reciprocal there)
    s = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def int8_gemm_acc_plain(xq: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq @ w_int8.T``. Every partial sum is an integer of
    magnitude at most 127**2 * K, far below 2**53 for any K a linear
    has, so float64 holds each one exactly, in any order of summation;
    float64 matmuls run on both the CPU and the card (int32 ones do not
    run on the card)."""
    return (xq.double() @ w_int8.double().T).to(torch.int32)


def int8_linear_plain(x: torch.Tensor, w_int8: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2 (``quant.int8_dynamic_matmul``)."""
    k = x.shape[-1]
    xq, s = quantize_rows_plain(x.reshape(-1, k))
    acc = int8_gemm_acc_plain(xq, w_int8)
    y = acc.float() * s * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], w_int8.shape[0])


def quantize_rows_scaled_plain(x2: torch.Tensor,
                               s_x: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` codes ``clip(round(x / s_x), -127, 127)`` against given
    row scales ``s_x [M]`` fp32 (a tensor divisor: the IEEE quotient)."""
    return torch.clamp(torch.round(x2.float() / s_x.reshape(-1, 1)),
                       -127, 127).to(torch.int8)


def int8_linear_scaled_plain(x: torch.Tensor, s_x: torch.Tensor,
                             w_int8: torch.Tensor, w_scale: torch.Tensor,
                             bias: torch.Tensor | None = None,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """The plain version of K2's entry with a given row scale: the codes
    of :func:`quantize_rows_scaled_plain`, the exact int32 product, ``acc *
    s_x * s_w (+ bias)`` in fp32, cast to ``out_dtype`` (``torch.int32``:
    the product itself, before the scales and the bias)."""
    k = x.shape[-1]
    sx = s_x.reshape(-1, 1).float()
    acc = int8_gemm_acc_plain(quantize_rows_scaled_plain(
        x.reshape(-1, k), sx), w_int8)
    if out_dtype == torch.int32:
        return acc.reshape(*x.shape[:-1], w_int8.shape[0])
    y = acc.float() * sx * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], w_int8.shape[0])


def _check(x, w_int8, w_scale, bias):
    n, k = w_int8.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match w [N={n}, K={k}]")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"K2 takes bf16 or fp32 activations, got {x.dtype}")
    if w_int8.dtype != torch.int8 or not w_int8.is_contiguous():
        raise ValueError("w_int8 must be contiguous int8 [N, K]")
    if w_scale.shape != (n,) or w_scale.dtype != torch.float32 \
            or not w_scale.is_contiguous():
        raise ValueError("w_scale must be contiguous fp32 [N]")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    for name, t in (("w_int8", w_int8), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w_int8.data_ptr() % 16:
        raise ValueError("K2 needs a 16-byte aligned w_int8")


def _quantize_rows_cuda(lib, x2, stream):
    """The row kernel on contiguous ``[M, K]``: ``(x_q [M, round_up(K,
    16)] int8, zero codes past K; s_x [M] fp32)``."""
    from . import _lib

    m, k = x2.shape
    xq = torch.empty((m, -(-k // 16) * 16), dtype=torch.int8,
                     device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    code = lib.k2_quantize_rows(x2.data_ptr(), m, k, _X_DTYPES[x2.dtype],
                                xq.data_ptr(), sx.data_ptr(), stream)
    _lib.check(code, "K2 quantize_rows launch")
    return xq, sx


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's row kernel alone on the card, to check and to time it:
    ``(x_q [M, round_up(K, 16)] int8, s_x [M] fp32)``; ``x_q[:, :K]`` is
    :func:`quantize_rows_plain`'s codes and the rest are zeros. Not counted
    as a launch."""
    if x2.device.type != "cuda" or x2.dim() != 2 \
            or x2.dtype not in _X_DTYPES:
        raise ValueError("quantize_rows checks the CUDA kernel on bf16 or "
                         "fp32 [M, K]")
    from . import _lib

    return _quantize_rows_cuda(_lib.library(), x2.contiguous(),
                               _lib.stream_ptr(x2.device))


def padded_weight(w_int8: torch.Tensor, kp: int) -> torch.Tensor:
    """``w_int8 [N, K]`` with zero columns up to ``kp``: a copy at every
    call where K is not a 16-multiple (no shipped linear has such a K)."""
    k = w_int8.shape[1]
    return w_int8 if kp == k else F.pad(w_int8, (0, kp - k))


def _gemm_cuda(lib, xq, sx, w_int8, w_scale, bias, out_dtype, stream):
    from . import _lib

    m, k = xq.shape
    n = w_int8.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    code = lib.k2_int8_gemm(
        xq.data_ptr(), w_int8.data_ptr(), m, n, k, sx.data_ptr(),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), _OUT_MODES[out_dtype], stream)
    _lib.check(code, "K2 int8_gemm launch")
    return out


def int8_linear(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Dynamic-int8 linear ``[..., K] -> [..., N]`` in x's dtype, any K.
    On the card a K that is not a 16-multiple costs a zero-padded copy of
    the weight at each call (the GEMM's TMA rows are 16-byte multiples);
    every shipped linear has a 16-multiple K."""
    _check(x, w_int8, w_scale, bias)
    if x.device.type == "cpu":
        return int8_linear_plain(x, w_int8, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or the CPU, not {x.device}")
    from . import _lib

    lib = _lib.library()
    stream = _lib.stream_ptr(x.device)
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    xq, sx = _quantize_rows_cuda(lib, x2, stream)
    w_int8 = padded_weight(w_int8, xq.shape[1])
    out = _gemm_cuda(lib, xq, sx, w_int8, w_scale, bias, x.dtype, stream)
    int8_linear.launches += 1
    return out.reshape(*x.shape[:-1], w_int8.shape[0])


int8_linear.launches = 0


def int8_linear_acc(x: torch.Tensor, w_int8: torch.Tensor) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's intermediate results on the card, for exactness checks:
    ``(x_q [M, K] int8, s_x [M] fp32, acc [M, N] int32)``. Not counted as
    a launch of the main path's kernel."""
    _check(x, w_int8, torch.ones(w_int8.shape[0], device=x.device), None)
    if x.device.type != "cuda":
        raise ValueError("int8_linear_acc checks the CUDA kernel")
    from . import _lib

    lib = _lib.library()
    stream = _lib.stream_ptr(x.device)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    xq, sx = _quantize_rows_cuda(lib, x2, stream)
    ones = torch.ones(w_int8.shape[0], dtype=torch.float32, device=x.device)
    acc = _gemm_cuda(lib, xq, sx, padded_weight(w_int8, xq.shape[1]), ones,
                     None, torch.int32, stream)
    return xq[:, :x2.shape[1]], sx, acc


def _check_scale(x, s_x):
    m = x.numel() // x.shape[-1]
    if s_x.shape != (m,) or s_x.dtype != torch.float32 \
            or s_x.device != x.device:
        raise ValueError(f"s_x must be fp32 [{m}] on {x.device}")


def _quantize_rows_scaled_cuda(lib, x2, s_x, stream):
    from . import _lib

    m, k = x2.shape
    xq = torch.empty((m, -(-k // 16) * 16), dtype=torch.int8,
                     device=x2.device)
    code = lib.k2_quantize_rows_scaled(x2.data_ptr(), m, k,
                                       _X_DTYPES[x2.dtype],
                                       s_x.contiguous().data_ptr(),
                                       xq.data_ptr(), stream)
    _lib.check(code, "K2 quantize_rows_scaled launch")
    return xq


def quantize_rows_scaled(x2: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """The given-scale row kernel alone on the card, to check it: codes
    ``[M, round_up(K, 16)]`` int8 (``[:, :K]`` is
    :func:`quantize_rows_scaled_plain`'s, zeros after). Not counted as a
    launch."""
    if x2.device.type != "cuda" or x2.dim() != 2 \
            or x2.dtype not in _X_DTYPES:
        raise ValueError("quantize_rows_scaled checks the CUDA kernel on "
                         "bf16 or fp32 [M, K]")
    _check_scale(x2, s_x)
    from . import _lib

    return _quantize_rows_scaled_cuda(_lib.library(), x2.contiguous(), s_x,
                                      _lib.stream_ptr(x2.device))


def int8_linear_scaled(x: torch.Tensor, s_x: torch.Tensor,
                       w_int8: torch.Tensor, w_scale: torch.Tensor,
                       bias: torch.Tensor | None = None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2 with a given per-row activation scale ``s_x [M]`` fp32 (M = the
    rows of ``x [..., K]``): the row kernel skips its own amax pass and
    writes ``clip(round(x / s_x), -127, 127)``, then the s8 GEMM with the
    scale-and-bias epilogue, ``[..., N]`` in ``out_dtype`` (fp32 or bf16;
    ``torch.int32``: the exact accumulator, the GEMM's int32 output mode
    with no epilogue). A row-parallel linear passes the scale of the whole
    row, its amax all-reduced over the ``tp`` group, and asks for the
    accumulator, which the ranks sum as XLA's SPMD sums the int8 dot's
    int32 partials. CPU tensors take :func:`int8_linear_scaled_plain`;
    CUDA ones launch or raise."""
    _check(x, w_int8, w_scale, bias)
    _check_scale(x, s_x)
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise ValueError(f"out_dtype {out_dtype}: fp32, bf16 or int32")
    if x.device.type == "cpu":
        return int8_linear_scaled_plain(x, s_x, w_int8, w_scale, bias,
                                        out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or the CPU, not {x.device}")
    from . import _lib

    lib = _lib.library()
    stream = _lib.stream_ptr(x.device)
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    xq = _quantize_rows_scaled_cuda(lib, x2, s_x, stream)
    w_int8 = padded_weight(w_int8, xq.shape[1])
    out = _gemm_cuda(lib, xq, s_x.contiguous(), w_int8, w_scale, bias,
                     out_dtype, stream)
    int8_linear_scaled.launches += 1
    return out.reshape(*x.shape[:-1], w_int8.shape[0])


int8_linear_scaled.launches = 0
