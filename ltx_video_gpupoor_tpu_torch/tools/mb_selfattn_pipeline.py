"""Experiment: software-pipelined flash-attention kernel at the LTX shape.

Port of ``tools/mb_selfattn_pipeline.py`` of the JAX package. Hypothesis,
restated for the card: an attention block serializes per kv tile, Q.K^T on
the tensor cores, then max and exp2 on the CUDA cores and the
special-function unit, then P.V on the tensor cores. Cutting the kv tile
into sub-blocks and issuing the next sub-block's Q.K^T before this one's
softmax hands the tensor cores independent work to run under the
exponentials. K1's ``wgmma`` block already overlaps a tile's exponentials
with the previous tile's P.V; the tool asks whether the finer cut adds to
that.

- :func:`pipelined_attention` is ``pipelined_attention`` (:81), backed by
  ``csrc/flash_attention_pipelined.cu`` (kernel K8, which replaces the
  Pallas ``_kernel``, :32): K1's D=64 block (``wgmma``, a producer
  warpgroup, a four-stage TMA ring). The TPU's 768 x 2688 blocks answer its
  VMEM; the kernel's q tile is 128 rows (a ragged last one is not stored
  past S) and its kv tile ``block_kv`` = 128 rows (64 for lengths that 128
  does not divide), cut into ``nsub`` sub-blocks of at least 16 rows.
  Launches count in ``pipelined_attention.launches``.
- :func:`pipelined_attention_plain` is its plain PyTorch version: the same
  sub-blocks in the same order with the same roundings.
- :func:`main` does what the JAX tool's does (:120-147): the check at a
  small shape against exact attention, then milliseconds per call of the
  production kernel and of K8 at ``nsub`` 1, 2, 4, 8 at B=2 H=32 S=5376
  D=64.

    python3 -m ltx_video_gpupoor_tpu_torch.tools.mb_selfattn_pipeline

It runs on the card (``--device cpu`` runs the check alone, on the plain
version).
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import torch

B, H, S, D = 2, 32, 5376, 64
LOG2E = 1.4426950408889634
M_FLOOR = -1e20
NSUBS = {128: (1, 2, 4, 8), 64: (1, 2, 4)}   # block_kv -> nsub it is built for
SMALL = (1, 2, 1344)              # the check's B, H, S: 64-row kv tiles


def _check_blocks(s: int, d: int, block_kv: int, nsub: int) -> None:
    if d != D:
        raise ValueError(f"K8 takes head dim {D}, got {d}")
    if block_kv not in NSUBS or nsub not in NSUBS[block_kv]:
        raise ValueError(f"K8 is built for (block_kv, nsub) in {NSUBS}, got "
                         f"({block_kv}, {nsub})")
    if s % block_kv:
        raise ValueError(f"K8 takes no mask: S={s} must be a multiple of the "
                         f"kv tile {block_kv}")


def pipelined_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, block_kv: int = 128,
                              nsub: int = 1) -> torch.Tensor:
    """The plain version of K8 over ``[B, H, S, D]``: q times
    ``D**-0.5 * log2(e)`` in fp32, rounded to q's dtype; per sub-block of
    ``block_kv // nsub`` kv rows the running max (from -1e20), ``p =
    exp2(s - m)`` rounded to V's dtype, the rescale of the accumulator;
    the denominator sums the rounded p (the TPU kernel reads it off a ones
    column of V)."""
    b, h, s, d = q.shape
    if s % block_kv or block_kv % nsub:
        raise ValueError(f"S={s} must be a multiple of block_kv={block_kv}, "
                         f"block_kv of nsub={nsub}")
    c = d ** -0.5 * LOG2E
    qs = (q.float() * c).to(q.dtype).float()
    bsub = block_kv // nsub
    m = torch.full((b, h, s, 1), M_FLOOR, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for c0 in range(0, s, bsub):
        sc = qs @ k[:, :, c0:c0 + bsub].float().transpose(-1, -2)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp2(sc - m_new).to(v.dtype).float()
        alpha = torch.exp2(m - m_new)
        acc = acc * alpha + p @ v[:, :, c0:c0 + bsub].float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)


def pipelined_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        block_kv: int = 128, nsub: int = 1) -> torch.Tensor:
    """Unmasked self-attention over ``[B, H, S, 64]`` with the kv tile cut
    into ``nsub`` sub-blocks, the next sub-block's Q.K^T issued before this
    one's softmax.

    CPU tensors take :func:`pipelined_attention_plain`; CUDA tensors (bf16,
    unit last stride) launch K8 or raise (also under autograd: the kernel
    has no backward)."""
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D]: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    _check_blocks(s, d, block_kv, nsub)
    from ..ops import _lib

    _lib.refuse_grad("K8", q.device, q, k, v)
    if q.device.type == "cpu":
        return pipelined_attention_plain(q, k, v, block_kv=block_kv,
                                         nsub=nsub)
    if q.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA or the CPU, not {q.device}")
    from ..ops.flash_attention import _check_layout

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout("K8", name, t, torch.bfloat16, q.device)
    out = torch.empty_like(q)
    code = _lib.library().k8_flash_attention_pipelined_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, s, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], block_kv, nsub,
        ctypes.c_float(d ** -0.5 * LOG2E), _lib.stream_ptr(q.device))
    _lib.check(code, "K8 pipelined_attention launch")
    pipelined_attention.launches += 1
    return out


pipelined_attention.launches = 0


def main(argv=None) -> dict:
    """Run the check and the timings; returns what it printed as a dict
    (``err``, ``production_ms``, ``pipelined_ms`` by nsub)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the check alone, on the "
                    "plain version)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tool runs on the card "
                           "(--device cpu runs the check alone)")
    from ..ops.flash_attention import flash_attention, reference_attention

    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (B, H, S, D) if dev.type == "cuda" else (*SMALL, D)
    q, k, v = (torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))

    # correctness check at a small shape against exact attention
    sb, sh, ss = SMALL
    qs, ks, vs = (t[:sb, :sh, :ss] for t in (q, k, v))
    want = reference_attention(qs, ks, vs)
    got = pipelined_attention(qs, ks, vs, block_kv=64, nsub=4)
    err = float((want.float() - got.float()).abs().max())
    print(f"max abs err vs oracle (nsub=4): {err:.2e}", flush=True)
    result = {"err": err, "production_ms": None, "pipelined_ms": {}}
    if dev.type != "cuda":
        return result

    from ._bench_util import cuda_time_ms

    t = cuda_time_ms(lambda: flash_attention(q, k, v))
    result["production_ms"] = t
    print(f"production kernel      : {t:8.3f} ms/layer", flush=True)
    for nsub in NSUBS[128]:
        t = cuda_time_ms(functools.partial(pipelined_attention, q, k, v,
                                           nsub=nsub))
        result["pipelined_ms"][nsub] = t
        print(f"pipelined nsub={nsub:2d}      : {t:8.3f} ms/layer", flush=True)
    return result


if __name__ == "__main__":
    main()
