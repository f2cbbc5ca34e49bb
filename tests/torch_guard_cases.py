"""One call of each kernel wrapper under autograd, for the grad guard's
tests (``tests/test_torch_training.py`` on the CPU,
``tests/test_torch_cuda.py`` on the card). Torch and the port only.

``CASES[route](device)`` builds a call's inputs on ``device``, those that
a train step would differentiate requiring grad, and returns the call;
on CUDA tensors each must raise ``RuntimeError`` naming ``route`` before
its kernel launches (:func:`launches` unchanged)."""

import torch

from ltx_video_gpupoor_tpu_torch.ops import attention as attn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
from ltx_video_gpupoor_tpu_torch.ops.quant import Linear
from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr
from ltx_video_gpupoor_tpu_torch.parallel.comm import TensorParallel
from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb


def _randn(device, dtype, *shape, grad=True):
    g = torch.Generator().manual_seed(sum(shape))
    t = torch.randn(*shape, generator=g).to(device, dtype)
    return t.requires_grad_(grad)


def _qkv(device, dtype, shape=(1, 2, 128, 64)):
    return [_randn(device, dtype, *shape) for _ in range(3)]


def _attention(dtype, mode, score_bound=None):
    def case(device):
        q, k, v = _qkv(device, dtype)
        return lambda: attn.attention(q, k, v, mode=mode,
                                      score_bound=score_bound)
    return case


def _packed(device):
    q, k, v = _qkv(device, torch.bfloat16, (1, 128, 2 * 64))
    return lambda: attn.attention_packed(q, k, v, 2, mode="pallas_hp")


def _linear(device, tp_kind=None):
    lin = Linear(64, 32, device=device, dtype=torch.bfloat16)
    lin.weight.copy_(_randn(device, torch.bfloat16, 32, 64, grad=False))
    lin.quantize_("dynamic")
    if tp_kind is not None:
        # this rank's rows of a tp=2 cut; the guard comes before the sum
        lin.tp, lin.tp_kind = TensorParallel(None, 2, 0), tp_kind
    x = _randn(device, torch.bfloat16, 2, 16, 64)
    return lambda: lin(x)


def _prologue(device):
    x = _randn(device, torch.bfloat16, 32, 64)
    scale = _randn(device, torch.bfloat16, 2, 64)
    shift = _randn(device, torch.bfloat16, 2, 64)
    w = torch.ones(32, 64, dtype=torch.int8, device=device)
    w_scale = torch.full((32,), 1e-2, device=device)
    return lambda: fp.norm_mod_int8_matmul(x, scale, shift, w, w_scale,
                                           rows_per_group=16)


def _ring(device):
    shards = [_qkv(device, torch.bfloat16) for _ in range(2)]
    return lambda: rr.ring_attention_rdma(*zip(*shards))


def _pipelined(device):
    q, k, v = _qkv(device, torch.bfloat16)
    return lambda: mb.pipelined_attention(q, k, v)


CASES = {
    "K1": _attention(torch.bfloat16, "pallas"),
    "K3": _attention(torch.bfloat16, "pallas", 40.0),
    "K4": _attention(torch.bfloat16, "pallas_int8"),
    "K3q": _attention(torch.bfloat16, "pallas_int8", 40.0),
    "K6": _packed,
    "K1f exact": _attention(torch.float32, "pallas"),
    "K1f qk8": _attention(torch.float32, "pallas_int8"),
    "K2": _linear,
    "K2s": lambda device: _linear(device, "row"),
    "K5": _prologue,
    "K7": _ring,
    "K8": _pipelined,
}


def launches() -> tuple:
    """Every kernel wrapper's launch count."""
    return (fa.flash_attention.launches, fa.flash_attention.bounded_launches,
            fa.flash_attention_int8.launches,
            fa.flash_attention_int8.bounded_launches,
            fa.flash_attention_hp.launches, fa.flash_attention_fp32.launches,
            fa.int8_prologue.kernel_launches, im.int8_linear.launches,
            im.int8_linear_scaled.launches, fp.norm_mod_int8_matmul.launches,
            rr.ring_attention_rdma.launches, mb.pipelined_attention.launches)
