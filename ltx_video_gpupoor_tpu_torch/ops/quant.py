"""Linear layers and the quantization tiers.

Port of ``ltx_video_gpupoor_tpu/ops/quant.py``: ``quantize_weights``,
``QuantizedLinear4``, ``quantize_weights_int4``, ``unpack_int4``,
``dequantize_int4``, ``int4_wo_matmul`` and ``int8_wo_matmul`` (:47-153),
``int8_dynamic_matmul`` (:190-206, the plain version of kernel K2),
``is_mixed_sensitive`` (:217-232), ``quantize_params`` (:235) in its four
modes and ``maybe_quantized_matmul`` (:290) with every branch.

A :class:`Linear` holds a dense ``weight [out, in]`` (+ ``bias``) or,
after :func:`quantize_params`, one tier's buffers, named as JAX names the
leaves:

- ``w_int8_dyn [out, in]`` int8 + ``scale [out]`` (``"dynamic"``): per-row
  dynamic int8 activations and an s8 product, kernel K2 on the card;
- ``w_int8 [out, in]`` int8 + ``scale [out]`` (``"wo"``, JAX's default):
  weight-only, the codes dequantized into the activation dtype at each
  call and a dense product;
- ``w_int4 [out, in/2]`` int8, two codes a byte along ``in`` (low nibble
  the even input index) + ``scale [out, in/g]`` per input group of g = 64
  or ``scale [out]`` per channel where ``in`` does not split into groups
  (``"wo_int4"``): weight-only, unpacked and dequantized at each call.

``"mixed_int4"`` stores int4 for most linears and int8-WO for the leaves
:func:`is_mixed_sensitive` names. The weight-only tiers are chains of
torch ops in JAX's order and dtypes, as XLA runs them on the TPU (no
Pallas kernel there, so none here); the dense product is ``F.linear``.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .int8_matmul import int8_linear, int8_linear_plain

INT4_GROUP_SIZE = 64
MODES = ("dynamic", "wo", "wo_int4", "mixed_int4")
# a tier's weight buffer, by mode (the JAX leaf names)
_WEIGHT_KEYS = {"dynamic": "w_int8_dyn", "wo": "w_int8", "wo_int4": "w_int4"}


class QuantizedLinear(NamedTuple):
    """int8 weight ``[out, in]`` + per-output-channel fp32 scale ``[out]``."""

    w_int8: torch.Tensor
    scale: torch.Tensor


class QuantizedLinear4(NamedTuple):
    """Packed int4 weight ``[out, in/2]`` (int8 storage, the low nibble
    the even input index) + fp32 scale ``[out, in/g]`` per input group or
    ``[out]`` per channel (``scale.dim()`` tells them apart)."""

    w_int4: torch.Tensor
    scale: torch.Tensor


def quantize_weights(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of ``[out, in]``."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return QuantizedLinear(q.to(torch.int8).contiguous(), scale.contiguous())


def quantize_weights_int4(w: torch.Tensor,
                          group_size: int | None = INT4_GROUP_SIZE
                          ) -> QuantizedLinear4:
    """Symmetric int4 over the whole [-8, 7] code range (scale = absmax /
    7.5, round half to even), packed two a byte along ``in`` (which must
    be even). Per input group of ``group_size`` where ``in`` splits into
    such groups, else per output channel."""
    dout, din = w.shape
    if din % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {din}")
    wf = w.float()
    if group_size and din % group_size == 0 and group_size % 2 == 0:
        wg = wf.reshape(dout, din // group_size, group_size)
        absmax = wg.abs().amax(dim=2)                     # [out, in/g]
        scale = torch.clamp(absmax / torch.full_like(absmax, 7.5), min=1e-8)
        q = torch.clamp(torch.round(wg / scale[..., None]), -8, 7)
        q = q.reshape(dout, din)
    else:
        absmax = wf.abs().amax(dim=1)                     # [out]
        scale = torch.clamp(absmax / torch.full_like(absmax, 7.5), min=1e-8)
        q = torch.clamp(torch.round(wf / scale[:, None]), -8, 7)
    q = q.to(torch.int32)
    byte = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)
    packed = byte.to(torch.uint8).view(torch.int8)
    return QuantizedLinear4(packed.contiguous(), scale.contiguous())


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``[out, in/2]`` packed int8 -> ``[out, in]`` int8 in [-8, 7]."""
    lo = ((packed & 0x0F) ^ 8) - 8     # the low nibble, sign-extended
    hi = packed >> 4                   # arithmetic: the high one
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def dequantize_int4(q: QuantizedLinear4, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """Packed codes + per-group or per-channel scales -> the dense
    ``[out, in]`` weight in ``dtype`` (codes and scales cast to it, their
    product rounded in it, as in JAX)."""
    w = unpack_int4(q.w_int4).to(dtype)
    dout, din = w.shape
    if q.scale.dim() == 2:  # per group
        g = din // q.scale.shape[1]
        return (w.reshape(dout, din // g, g)
                * q.scale.to(dtype)[..., None]).reshape(dout, din)
    return w * q.scale.to(dtype)[:, None]


def _dense(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """``x w^T`` (fp32 accumulation, result in x's dtype), then the bias
    in x's dtype."""
    y = F.linear(x, w)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def int4_wo_matmul(x: torch.Tensor, q: QuantizedLinear4,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Weight-only int4: unpack and dequantize into x's dtype, then the
    dense product."""
    return _dense(x, dequantize_int4(q, x.dtype), bias)


def int8_wo_matmul(x: torch.Tensor, q: QuantizedLinear,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Weight-only int8: codes and scales cast to x's dtype, their product
    rounded there, then the dense product."""
    w = q.w_int8.to(x.dtype) * q.scale.to(x.dtype)[:, None]
    return _dense(x, w, bias)


def int8_dynamic_matmul(x: torch.Tensor, q: QuantizedLinear,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Dynamic-activation int8 linear, plain PyTorch (K2's plain version)."""
    return int8_linear_plain(x, q.w_int8, q.scale, bias)


# Leaves the mixed int4 tier keeps in int8-WO (JAX :217-224): their
# quantization error lands on the output or multiplies activations.
MIXED_SENSITIVE_PATTERNS = (
    "adaln.",
    "patchify_proj",
    "caption_projection",
    "time_embedding", "time_projection", "text_embedding",
    "fps_embedding", "fps_projection",
)


def is_mixed_sensitive(path: str) -> bool:
    """True for leaves the mixed int4 tier keeps in int8-WO; ``path`` is a
    JAX parameter path (``blocks.self_attn.q.kernel``, ``head.head.kernel``):
    :func:`jax_path` maps a port module name to it."""
    base = path.removesuffix(".kernel")
    if base == "proj_out" or base.endswith("head.head") or \
            base.endswith(".head"):
        return True
    return any(p in path for p in MIXED_SENSITIVE_PATTERNS)


def jax_path(name: str) -> str:
    """A :class:`Linear`'s qualified module name -> the JAX path of its
    kernel: the layer stack loses its index (``blocks.3.`` -> ``blocks.``,
    the JAX ``blocks`` are stacked) and the weight is a ``kernel``."""
    return re.sub(r"^blocks\.\d+\.", "blocks.", name) + ".kernel"


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
    def mode(self) -> str | None:
        """The tier of the stored weight (``"dynamic"``, ``"wo"``,
        ``"wo_int4"``), None while it is dense."""
        for mode, key in _WEIGHT_KEYS.items():
            if hasattr(self, key):
                return mode
        return None

    @property
    def quantized(self) -> bool:
        return self.mode is not None

    def quantize_(self, mode: str = "dynamic") -> None:
        """Replace the dense weight by the buffers of ``mode``
        (``"dynamic"``, ``"wo"`` or ``"wo_int4"``)."""
        if mode not in _WEIGHT_KEYS:
            raise ValueError(f"Linear.quantize_ mode {mode!r}")
        q = (quantize_weights_int4 if mode == "wo_int4"
             else quantize_weights)(self.weight)
        del self.weight
        self.register_buffer(_WEIGHT_KEYS[mode], q[0])
        self.register_buffer("scale", q.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return maybe_quantized_matmul(self, x)


def maybe_quantized_matmul(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """Apply a :class:`Linear` in its tier: K2 for ``w_int8_dyn``, the
    weight-only chains for ``w_int8`` and ``w_int4``, a dense matmul (fp32
    accumulation, result in x's dtype, then the bias in x's dtype)
    otherwise."""
    mode = p.mode
    if mode == "dynamic":
        return int8_linear(x, p.w_int8_dyn, p.scale, p.bias)
    if mode == "wo":
        return int8_wo_matmul(x, QuantizedLinear(p.w_int8, p.scale), p.bias)
    if mode == "wo_int4":
        return int4_wo_matmul(x, QuantizedLinear4(p.w_int4, p.scale), p.bias)
    return _dense(x, p.weight.to(x.dtype), p.bias)


def quantize_params(model: nn.Module, mode: str = "wo") -> nn.Module:
    """Quantize, in place, every dense :class:`Linear` of ``model`` (the
    JAX kernels of rank 2 or 3 with a ``.kernel`` path: the same leaves);
    returns the model. ``mode`` is JAX's: ``"wo"`` (the default),
    ``"dynamic"``, ``"wo_int4"`` or ``"mixed_int4"`` (int4-WO, and
    int8-WO for the leaves :func:`is_mixed_sensitive` names by their JAX
    path)."""
    if mode not in MODES:
        raise ValueError(f"quantize_params mode {mode!r}: expected one of "
                         f"{MODES}")
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and not mod.quantized:
            if mode == "mixed_int4":
                mod.quantize_("wo" if is_mixed_sensitive(jax_path(name))
                              else "wo_int4")
            else:
                mod.quantize_(mode)
    return model
