"""Linear layers and the dynamic-int8 quantization tier.

Port of ``ltx_video_gpupoor_tpu/ops/quant.py``: ``quantize_weights``,
``quantize_params(mode="dynamic")`` (:235), ``int8_dynamic_matmul``
(:190-206, the plain version of kernel K2) and ``maybe_quantized_matmul``
(:290) with its dense ``kernel`` path and its ``w_int8_dyn`` path, which
runs kernel K2 (``ops/int8_matmul.py``).

A :class:`Linear` holds either a dense ``weight [out, in]`` (+ ``bias``)
or, after :func:`quantize_params`, the buffers ``w_int8_dyn [out, in]``
int8 and ``scale [out]`` fp32. The weight-only int8/int4 and mixed tiers
are still to be ported (ROADMAP queue 1 step 12).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .int8_matmul import int8_linear, int8_linear_plain


class QuantizedLinear(NamedTuple):
    """int8 weight ``[out, in]`` + per-output-channel fp32 scale ``[out]``."""

    w_int8: torch.Tensor
    scale: torch.Tensor


def quantize_weights(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of ``[out, in]``."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return QuantizedLinear(q.to(torch.int8).contiguous(), scale.contiguous())


def int8_dynamic_matmul(x: torch.Tensor, q: QuantizedLinear,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Dynamic-activation int8 linear, plain PyTorch (K2's plain version)."""
    return int8_linear_plain(x, q.w_int8, q.scale, bias)


class Linear(nn.Module):
    """``y = x W^T (+ b)`` in the JAX package's quantization-tier dispatch."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device,
                                              dtype=dtype),
                                  requires_grad=False)
                     if bias else None)

    @property
    def quantized(self) -> bool:
        return hasattr(self, "w_int8_dyn")

    def quantize_(self) -> None:
        """Replace the dense weight by ``w_int8_dyn`` + ``scale``."""
        q = quantize_weights(self.weight)
        del self.weight
        self.register_buffer("w_int8_dyn", q.w_int8)
        self.register_buffer("scale", q.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return maybe_quantized_matmul(self, x)


def maybe_quantized_matmul(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """Apply a :class:`Linear` in its tier: K2 for ``w_int8_dyn``, a dense
    matmul (fp32 accumulation, result in x's dtype, then the bias in x's
    dtype) otherwise."""
    if p.quantized:
        return int8_linear(x, p.w_int8_dyn, p.scale, p.bias)
    y = F.linear(x, p.weight.to(x.dtype))
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def quantize_params(model: nn.Module, mode: str = "wo") -> nn.Module:
    """Quantize, in place, every :class:`Linear` of ``model``; returns the
    model. The default mode is JAX's (``"wo"``, not ported yet, so it
    raises): a caller names ``mode="dynamic"``."""
    if mode != "dynamic":
        raise NotImplementedError(
            f"quantize_params(mode={mode!r}): only 'dynamic' is ported; the "
            "weight-only int8/int4 and mixed tiers are ROADMAP queue 1 "
            "step 12")
    for mod in model.modules():
        if isinstance(mod, Linear) and not mod.quantized:
            mod.quantize_()
    return model
