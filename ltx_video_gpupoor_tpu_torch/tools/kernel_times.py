"""Times of K1f (fp32 attention) and K5's row kernel at the shapes the
served paths give them: one call as a path makes it (the host's launch
path included) and the device time a call in a CUDA graph.

It uses only the wrappers' public entry points, so the same file (with
``tools/_bench_util.py`` beside it) copied into an older checkout times
that checkout's kernels: two trees compared on one card in one call,
in turns (old, new, new, old), is the comparison these numbers are for.
Run on the card from the root of a checkout::

    python3 -m ltx_video_gpupoor_tpu_torch.tools.kernel_times --label new

It prints the card's name and power limit, then one line a shape.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
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
    for name, b, h, sq, skv, d, seg, bound in K1F_SHAPES:
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
    for name, m, kk, g, dtype in K5_SHAPES:
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
