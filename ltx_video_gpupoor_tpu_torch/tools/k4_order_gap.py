"""How far K4's plain version stepped by the kernel's 128-row kv tile lies
from the same plain version stepped by JAX's kv block, over seeds.

The two compute one function with P quantized against other running
maxima, so they differ in the rounding of P codes alone; the kernel
itself is held to the tile-stepped one (``int8_tile_bound``).
``chip_smoke.py``'s comparison at JAX's block caps this distance at
``K4_BLOCK_MAX``; this tool measures what the plain versions themselves
give on the text-segment shape of its checks (B3 H4 Sq700 Skv300, 200 /
300 / 17 valid keys, one q row with no key), on the CPU::

    python3 -m ltx_video_gpupoor_tpu_torch.tools.k4_order_gap --seeds 40

It prints, per head dim and tier, the largest and the median distance
over the seeds and the seeds past the cap.
"""

from __future__ import annotations

import argparse

import torch

from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

SHAPE = (3, 4, 700, 300)          # B, H, Sq, Skv
KV_VALID_ROWS = (200, 300, 17)
K4_BLOCK_MAX = 1e-1               # chip_smoke.py's cap


def _segments(b, sq, skv):
    q_seg = torch.ones(b, sq, dtype=torch.int32)
    q_seg[0, 17] = 2                      # a row no key matches
    kv_seg = torch.zeros(b, skv, dtype=torch.int32)
    for i, n in enumerate(KV_VALID_ROWS[:b]):
        kv_seg[i, :n] = 1
    return q_seg, kv_seg


def order_gap(seed: int, d: int, pv_int8: bool) -> float:
    """max |plain at K4_TILE_KV - plain at JAX's kv block| on one draw."""
    b, h, sq, skv = SHAPE
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g).to(torch.bfloat16)
               for n in (sq, skv, skv))
    ops = fa.int8_prologue(q, k, v, pv_int8=pv_int8)
    segs = _segments(b, sq, skv)
    tile = fa.int8_attention_plain(ops, *segs, block_kv=fa.K4_TILE_KV,
                                   out_dtype=torch.bfloat16)
    block = fa.int8_attention_plain(ops, *segs, out_dtype=torch.bfloat16)
    return float((tile.float() - block.float()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for d in (64, 80):
        for pv_int8 in (True, False):
            gaps = sorted((order_gap(s, d, pv_int8), s)
                          for s in range(args.seeds))
            past = [s for gap, s in gaps if gap > K4_BLOCK_MAX]
            tier = "QK+PV" if pv_int8 else "QK"
            print(f"D={d} {tier}: over {args.seeds} seeds max "
                  f"{gaps[-1][0]:.4f} (seed {gaps[-1][1]}), median "
                  f"{gaps[len(gaps) // 2][0]:.4f}; past {K4_BLOCK_MAX}: "
                  f"{len(past)} (seeds {past})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
