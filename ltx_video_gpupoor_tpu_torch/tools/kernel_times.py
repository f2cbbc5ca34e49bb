"""Times of K1f (fp32 attention), K5's row kernel, K2's row quantize, the
int8 attention tiers' quantize prologue and K3q (int8 Q.K^T, bounded
scores) at the shapes the served paths give them: one call as a path
makes it (the host's launch path included) and the device time a call in
a CUDA graph, beside the bytes bound of the row kernels (each input read
once, each output written once, at 3.35 TB/s).

It uses only the wrappers' public entry points, so the same file (with
``tools/_bench_util.py`` beside it) copied into an older checkout times
that checkout's kernels: two trees compared on one card in one call,
in turns (old, new, new, old), is the comparison these numbers are for.
Run on the card from the root of a checkout::

    python3 -m ltx_video_gpupoor_tpu_torch.tools.kernel_times --label new
    python3 -m ltx_video_gpupoor_tpu_torch.tools.kernel_times --only k2 k3q

It prints the card's name and power limit, then one line a shape.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ltx_video_gpupoor_tpu_torch.ops import _lib
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
from ltx_video_gpupoor_tpu_torch.tools._bench_util import (cuda_time_ms,
                                                         graph_ms)

# (name, B, H, Sq, Skv, D, text segments, score bound): LTX-2B at
# 704x480x121 (three streams of 5280 tokens, 32 heads of 64), the [fp32]
# request at 256x256x9 (128 tokens), LTX-13B pass 1 (3840 tokens, 32
# heads of 128)
K1F_SHAPES = [("K1f LTX-2B self", 3, 32, 5280, 5280, 64, False, None),
              ("K1f LTX-2B cross", 3, 32, 5280, 256, 64, True, None),
              ("K1f request self", 3, 32, 128, 128, 64, False, None),
              ("K1f request cross", 3, 32, 128, 256, 64, True, None),
              ("K1f 13B pass 1 self", 1, 32, 3840, 3840, 128, False, None),
              ("K1f LTX-2B bounded self", 3, 32, 5280, 5280, 64, False,
               40.0)]
# (name, M, K, groups, dtype): LTX-13B pass 1 and pass 2 (one stream of
# 3840 and 15360 tokens, 16 latent frames), and the fp32 instance
K5_SHAPES = [("K5 rows pass 1", 3840, 4096, 16, torch.bfloat16),
             ("K5 rows pass 2", 15360, 4096, 16, torch.bfloat16),
             ("K5 rows pass 1 fp32", 3840, 4096, 16, torch.float32)]


# (name, M, K, dtype): K2's activation rows at its main-path shapes with M
# >= 3840: LTX-2B at 704x480x121 (three streams of 5280 tokens), Wan 2.1
# 1.3B at 832x480x81 (two of 32760), LTX-13B pass 1 and 2 (3840 and 15360)
K2_ROW_SHAPES = [("K2 rows LTX-2B K=2048", 15840, 2048, torch.bfloat16),
                 ("K2 rows LTX-2B K=8192", 15840, 8192, torch.bfloat16),
                 ("K2 rows Wan K=1536", 65520, 1536, torch.bfloat16),
                 ("K2 rows Wan K=8960", 65520, 8960, torch.bfloat16),
                 ("K2 rows Wan head K=1536 fp32", 65520, 1536,
                  torch.float32),
                 ("K2 rows 13B pass 1 K=4096", 3840, 4096, torch.bfloat16),
                 ("K2 rows 13B pass 1 K=16384", 3840, 16384, torch.bfloat16),
                 ("K2 rows 13B pass 2 K=4096", 15360, 4096, torch.bfloat16),
                 ("K2 rows 13B pass 2 K=16384", 15360, 16384,
                  torch.bfloat16)]
# (name, B, H, Sq, Skv, D, text segments): K3q's shapes in an LTX-13B tier
# (d) request (pass 2 and pass 1 self-attention, pass 2 and pass 1
# cross-attention to 256 text tokens) and LTX-2B's self-attention; the
# prologue is timed at each in the QK tier, and at the Wan self-attention
# in the QK+PV tier
K3Q_SHAPES = [("13B pass 2 self", 1, 32, 15360, 15360, 128, False),
              ("13B pass 1 self", 1, 32, 3840, 3840, 128, False),
              ("13B pass 2 cross", 1, 32, 15360, 256, 128, True),
              ("13B pass 1 cross", 1, 32, 3840, 256, 128, True),
              ("LTX-2B self", 3, 32, 5280, 5280, 64, False)]
WAN_SELF = ("Wan self", 2, 12, 32760, 32760, 128, False)
# --only: K1f; K5's row kernel; K2's row kernel; the prologue and K3q
GROUPS = ["k1f", "k5", "k2", "k3q"]
PEAK_BYTES = 3.35e12


def _bytes_ms(nbytes):
    return nbytes / PEAK_BYTES * 1e3


def _heads(b, h, s, d, gen, dev):
    """A head-split view of a random bf16 ``[B, S, H*D]`` projection."""
    return (torch.randn(b, s, h * d, generator=gen, device=dev)
            .to(torch.bfloat16).view(b, s, h, d).transpose(1, 2))


def _segments(b, sq, skv, dev):
    """Text segments as the DiT's cross-attention has them: every q row in
    segment 1, the first 200 keys of each batch row valid."""
    q_seg = torch.ones(b, sq, dtype=torch.int32, device=dev)
    kv_seg = torch.zeros(b, skv, dtype=torch.int32, device=dev)
    kv_seg[:, :200] = 1
    return q_seg, kv_seg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the kernels to time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, b, h, sq, skv, d, seg, bound in (
            K1F_SHAPES if "k1f" in args.only else []):
        q, k, v = (torch.randn(b, n, h * d, generator=gen, device=dev)
                   .view(b, n, h, d).transpose(1, 2) for n in (sq, skv, skv))
        segs = _segments(b, sq, skv, dev) if seg else (None, None)

        def call():
            return fa.flash_attention(q, k, v, *segs, score_bound=bound)

        calls = 20 if sq <= 128 else 3
        print(f"{args.label} {name} B={b} H={h} Sq={sq} Skv={skv} D={d}: one "
              f"call {cuda_time_ms(call):.4f} ms, in a CUDA graph "
              f"{graph_ms(call, calls):.4f} ms", flush=True)
        del q, k, v
    for name, m, kk, g, dtype in K5_SHAPES if "k5" in args.only else []:
        x = torch.randn(m, kk, generator=gen, device=dev).to(dtype)
        scale, shift = (torch.randn(g, kk, generator=gen, device=dev)
                        .mul(0.3).to(dtype) for _ in range(2))

        def call():
            return fp.norm_mod_quantize_rows(x, scale, shift,
                                             rows_per_group=m // g, eps=1e-6)

        print(f"{args.label} {name} M={m} K={kk} groups={g}: one call "
              f"{cuda_time_ms(call):.4f} ms, in a CUDA graph "
              f"{graph_ms(call, 20):.4f} ms", flush=True)
        del x, scale, shift
    lib = _lib.library()
    for name, m, kk, dtype in K2_ROW_SHAPES if "k2" in args.only else []:
        x = torch.randn(m, kk, generator=gen, device=dev).to(dtype)

        def call():
            # the stream read at call time: a graph capture runs on its own
            return im._quantize_rows_cuda(lib, x, _lib.stream_ptr(dev))

        bound = _bytes_ms(m * kk * (x.element_size() + 1) + 4 * m)
        dev_ms = graph_ms(call, 20)
        print(f"{args.label} {name} M={m}: one call "
              f"{cuda_time_ms(call):.4f} ms, in a CUDA graph {dev_ms:.4f} "
              f"ms, bytes bound {bound:.4f} ms ({dev_ms / bound:.2f}x)",
              flush=True)
        del x
    for name, b, h, sq, skv, d, seg in (
            K3Q_SHAPES + [WAN_SELF] if "k3q" in args.only else []):
        q, k, v = (_heads(b, h, n, d, gen, dev) for n in (sq, skv, skv))
        segs = _segments(b, sq, skv, dev) if seg else (None, None)
        for pv in ((True,) if name == WAN_SELF[0] else (False,)):

            def pro():
                return fa.int8_prologue(q, k, v, pv_int8=pv)

            # Q (and the QK tier's K) read once, codes and scales written
            rows = b * h * (sq + (0 if pv else skv))
            bound = _bytes_ms(rows * (d * 3 + 4))
            dev_ms = graph_ms(pro, 5)
            print(f"{args.label} prologue {'QK+PV' if pv else 'QK'} {name} "
                  f"B={b} H={h} Sq={sq} Skv={skv} D={d}: one call "
                  f"{cuda_time_ms(pro):.4f} ms, in a CUDA graph "
                  f"{dev_ms:.4f} ms, bytes bound of its Q"
                  f"{'' if pv else ' and K'} quantize {bound:.4f} ms",
                  flush=True)
        if name != WAN_SELF[0]:
            ops = fa.int8_prologue(q, k, v, pv_int8=False)

            def k3q():
                return fa.int8_attention_cuda(ops, *segs, score_bound=40.0)

            print(f"{args.label} K3q {name} B={b} H={h} Sq={sq} Skv={skv} "
                  f"D={d}: one call {cuda_time_ms(k3q):.4f} ms, in a CUDA "
                  f"graph {graph_ms(k3q, 3):.4f} ms", flush=True)
            del ops
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
