"""Fused adaLN prologue + dynamic-int8 linear: kernel K5 and its plain
version.

Port of ``ltx_video_gpupoor_tpu/ops/fused_prologue.py``: ``enabled_mode``
(:45), ``supports`` (:56), ``apply_fused`` (:73) and
``norm_mod_int8_matmul`` (:129, Pallas ``_kernel`` :104). Every LTX block
runs ``h = rms_norm(x) * (1 + scale) + shift`` twice a layer, each time
followed by dynamic-int8 linears that read ``h`` (q, k, v; the FFN's
``proj_in``). This tier computes the prologue, the activation quantizer
and the product in one call: ``h`` never reaches device memory, and q, k
and v are one product over their concatenated weights.

The contract is the JAX kernel's cast chain (:104-121): fp32 mean of
squares and ``rsqrt``, round to the activation dtype, modulate in that
dtype (``1 + scale``, the product and the sum each round), back to fp32,
absmax over the row, ``max(absmax / 127, 1e-8)`` (an IEEE division: the
interpreted JAX kernel follows it, not a multiply by 1/127), round half
to even, clip to +-127, s8 product with int32 accumulation, ``acc *
x_scale * w_scale`` in that order, bias, cast. Scale and shift arrive per
group ``[G_total, K]``; row ``r`` reads group ``r // rows_per_group``.

Opt-in through ``LTXV_TPU_FUSED_PROLOGUE`` (the JAX package's switch, so
that one setting selects the tier in both packages); the wiring is in
``models/ltx/transformer3d.py``. Weights are ``[N, K]`` int8 (torch's
``[out, in]``). CPU tensors take :func:`norm_mod_int8_matmul_plain`; CUDA
tensors launch ``csrc/fused_prologue.cu`` (a row kernel, then K2's GEMM)
or raise; bf16 activations (the served tiers) or fp32 (``FP32_POLICY``,
the row kernel's fp32 instance: no bf16 rounding between its ops, an fp32
output from the same GEMM). The TPU kernel's refusal of a group size with no 16-multiple
divisor (:165-174) has no counterpart: each row (one warp, or a few,
of the row kernel) reads its own group's scale and shift rows, so a block
may straddle two groups; :func:`supports` keeps the JAX gate so that
both packages take the same tier at the same shapes. Any K, as in JAX:
the row kernel writes its codes in rows of ``round_up(K, 16)`` bytes with
zero codes past K, and a weight whose K is not a 16-multiple is
zero-padded at each call (every shipped linear has a 16-multiple K).
"""

from __future__ import annotations

import ctypes
import os

import torch

from .int8_matmul import int8_gemm_acc_plain, padded_weight, \
    quantize_rows_plain


def enabled_mode() -> str | None:
    """``LTXV_TPU_FUSED_PROLOGUE``: unset/``0``/``off`` = the unfused
    chain (None); anything else = the fused tier (``"on"``). The JAX
    package's ``interpret`` value also means on here: the port has no
    interpreter, and CPU tensors take the plain version anyway."""
    raw = os.environ.get("LTXV_TPU_FUSED_PROLOGUE", "").strip().lower()
    if raw in ("", "0", "off", "false", "none"):
        return None
    return "on"


def supports(p_linears, s: int, g: int) -> bool:
    """Whether the fused tier serves these ``ops.quant.Linear`` modules at
    ``s`` tokens in ``g`` groups: the JAX gate (tokens split evenly into
    groups of a 16-multiple of rows, every linear int8-dynamic, biases
    on all or on none)."""
    if s % g:
        return False
    if (s // g) % 16:
        return False
    for p in p_linears:
        if p.mode != "dynamic" or p.w_int8_dyn.dim() != 2:
            return False
    has_bias = [p.bias is not None for p in p_linears]
    return all(has_bias) or not any(has_bias)


def fused_weights(p_linears):
    """``(w [sum N, K] int8, scale [sum N] fp32, bias [sum N] fp32 or
    None)`` of the linears side by side, concatenated at each call as the
    JAX ``apply_fused`` does (a single linear's own buffers as they
    are)."""
    if len(p_linears) == 1:
        w, ws = p_linears[0].w_int8_dyn, p_linears[0].scale
    else:
        w = torch.cat([p.w_int8_dyn for p in p_linears], dim=0)
        ws = torch.cat([p.scale for p in p_linears], dim=0)
    bias = None
    if p_linears[0].bias is not None:
        bias = torch.cat([p.bias.float() for p in p_linears], dim=0)
    return w, ws, bias


def apply_fused(x: torch.Tensor, scale_g: torch.Tensor, shift_g: torch.Tensor,
                p_linears, *, eps: float) -> torch.Tensor:
    """Prologue + all the linears that consume it, one call: ``x [B, S,
    K]``, adaLN rows ``scale_g`` / ``shift_g`` ``[B, G, K]``; returns
    ``[B, S, sum(N_i)]`` for the caller to split."""
    b, s, k = x.shape
    g = scale_g.shape[1]
    w, ws, bias = fused_weights(p_linears)
    out = norm_mod_int8_matmul(
        x.reshape(b * s, k),
        scale_g.to(x.dtype).reshape(b * g, k),
        shift_g.to(x.dtype).reshape(b * g, k),
        w, ws, bias, rows_per_group=s // g, eps=eps)
    return out.reshape(b, s, -1)


def norm_mod_quantize_plain(x, scale, shift, *, rows_per_group: int,
                            eps: float = 1e-5):
    """The prologue and the quantizer of K5, plain PyTorch: ``[M, K]`` ->
    (int8 ``[M, K]``, fp32 scales ``[M, 1]``). The mean of squares is
    summed in float64 and rounded to fp32 once, so it does not depend on
    the order of summation."""
    m, k = x.shape
    xf = x.float()
    mean = xf.double().square().mean(dim=-1, keepdim=True).float()
    h = (xf * torch.rsqrt(mean + eps)).to(x.dtype)
    hg = h.reshape(m // rows_per_group, rows_per_group, k)
    hg = hg * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return quantize_rows_plain(hg.reshape(m, k))


def norm_mod_int8_matmul_plain(x, scale, shift, w_int8, w_scale, bias=None, *,
                               rows_per_group: int, eps: float = 1e-5):
    """The plain PyTorch version of K5."""
    hq, s = norm_mod_quantize_plain(x, scale, shift,
                                    rows_per_group=rows_per_group, eps=eps)
    acc = int8_gemm_acc_plain(hq, w_int8)
    y = acc.float() * s * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check(x, scale, shift, w_int8, w_scale, bias, rows_per_group):
    m, k = x.shape
    if rows_per_group <= 0 or m % rows_per_group:
        raise ValueError(f"M={m} not a multiple of rows_per_group="
                         f"{rows_per_group}")
    want = (m // rows_per_group, k)
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} must have x's dtype {x.dtype}")
    if w_int8 is None:
        return
    n = w_int8.shape[0]
    if w_int8.dim() != 2 or w_int8.shape[1] != k or w_int8.dtype != torch.int8:
        raise ValueError(f"w_int8 must be int8 [N, K={k}], got "
                         f"{w_int8.dtype} {tuple(w_int8.shape)}")
    if w_scale.shape != (n,):
        raise ValueError(f"w_scale must be [{n}]")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")


_X_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # the C entry's x_dtype
_OUT_MODES = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}


def _padded(k: int) -> int:
    """The row pitch of the codes: K rounded up to a 16-multiple."""
    return -(-k // 16) * 16


def _check_cuda(x, scale, shift, w_int8, w_scale, bias):
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"K5 takes bf16 or fp32 activations, got {x.dtype}")
    tensors = [("x", x), ("scale", scale), ("shift", shift)]
    if w_int8 is not None:
        if w_scale.dtype != torch.float32:
            raise ValueError("w_scale must be fp32")
        if bias is not None and bias.dtype != torch.float32:
            raise ValueError("bias must be fp32")
        tensors += [("w_int8", w_int8), ("w_scale", w_scale), ("bias", bias)]
    for name, t in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K5 needs a contiguous 16-byte aligned {name}")


def norm_mod_quantize_rows(x, scale, shift, *, rows_per_group: int,
                           eps: float = 1e-5):
    """K5's row kernel alone on the card, to check and to time it: ``(h_q
    [M, round_up(K, 16)] int8, s_x [M] fp32)``; ``h_q[:, :K]`` is
    :func:`norm_mod_quantize_plain`'s codes and the rest are zeros. Not
    counted as a launch."""
    _check(x, scale, shift, None, None, None, rows_per_group)
    if x.device.type != "cuda":
        raise ValueError("norm_mod_quantize_rows checks the CUDA kernel")
    _check_cuda(x, scale, shift, None, None, None)
    from . import _lib

    m, k = x.shape
    xq = torch.empty((m, _padded(k)), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    code = _lib.library().k5_norm_mod_quantize_rows(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), m, k,
        _X_DTYPES[x.dtype], rows_per_group, ctypes.c_float(eps),
        xq.data_ptr(), sx.data_ptr(), _lib.stream_ptr(x.device))
    _lib.check(code, "K5 norm_mod_quantize_rows launch")
    return xq, sx


def _launch(x, scale, shift, w_int8, w_scale, bias, rows_per_group, eps,
            out_dtype):
    """The row kernel, then the GEMM: ``(h_q [M, round_up(K, 16)], s_x,
    out [M, N])``."""
    from . import _lib

    m, k = x.shape
    n = w_int8.shape[0]
    w_int8 = padded_weight(w_int8, _padded(k))
    xq = torch.empty((m, _padded(k)), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    code = _lib.library().k5_norm_mod_int8_matmul(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), m, k,
        _X_DTYPES[x.dtype], rows_per_group, ctypes.c_float(eps),
        xq.data_ptr(), sx.data_ptr(), w_int8.data_ptr(), n,
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), _OUT_MODES[out_dtype], _lib.stream_ptr(x.device))
    _lib.check(code, "K5 norm_mod_int8_matmul launch")
    return xq, sx, out


def norm_mod_int8_acc(x, scale, shift, w_int8, *, rows_per_group: int,
                      eps: float = 1e-5):
    """K5's intermediate results on the card, for exactness checks:
    ``(h_q [M, K] int8, s_x [M] fp32, acc [M, N] int32)``. Not counted as
    a launch of the main path's kernel."""
    if x.device.type != "cuda":
        raise ValueError("norm_mod_int8_acc checks the CUDA kernel")
    ones = torch.ones(w_int8.shape[0], dtype=torch.float32, device=x.device)
    _check(x, scale, shift, w_int8, ones, None, rows_per_group)
    _check_cuda(x, scale, shift, w_int8, ones, None)
    hq, sx, acc = _launch(x, scale, shift, w_int8, ones, None, rows_per_group,
                          eps, torch.int32)
    return hq[:, :x.shape[1]], sx, acc


def norm_mod_int8_matmul(
    x: torch.Tensor,          # [M, K] tokens (B*S flattened)
    scale: torch.Tensor,      # [G_total, K] adaLN scale rows, x's dtype
    shift: torch.Tensor,      # [G_total, K] adaLN shift rows
    w_int8: torch.Tensor,     # [N, K] int8 weight
    w_scale: torch.Tensor,    # [N] fp32 per-channel weight scale
    bias: torch.Tensor | None = None,   # [N] fp32
    *,
    rows_per_group: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``(rms_norm(x) * (1 + scale) + shift) @ dequant(w)`` in one call;
    ``[M, N]`` in x's dtype."""
    _check(x, scale, shift, w_int8, w_scale, bias, rows_per_group)
    if x.device.type == "cpu":
        return norm_mod_int8_matmul_plain(
            x, scale, shift, w_int8, w_scale, bias,
            rows_per_group=rows_per_group, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or the CPU, not {x.device}")
    _check_cuda(x, scale, shift, w_int8, w_scale, bias)
    out = _launch(x, scale, shift, w_int8, w_scale, bias, rows_per_group, eps,
                  x.dtype)[2]
    norm_mod_int8_matmul.launches += 1
    return out


norm_mod_int8_matmul.launches = 0
