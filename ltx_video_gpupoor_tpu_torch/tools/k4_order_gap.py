"""How far K4's plain version stepped by the kernel's 128-row kv tile lies
from the same plain version stepped by JAX's kv block, over seeds, beside
the bound derived for that distance (``int8_order_bound``).

The two compute one function with P quantized against other running
maxima, so they differ in the rounding of P codes alone; the kernel
itself is held to the tile-stepped one (``int8_tile_bound``), and
``chip_smoke.py``'s comparison at JAX's block to the sum of the two
bounds. This tool measures the plain versions on the text-segment shape
of its checks (B3 H4 Sq700 Skv300, 200 / 300 / 17 valid keys, one q row
with no key), on the CPU::

    python3 -m ltx_video_gpupoor_tpu_torch.tools.k4_order_gap --seeds 40

It prints, per head dim and tier, the largest gap and the largest ratio
of gap to bound over the seeds, the range of the ratio's root mean square
over all elements (held under ``K4_ORDER_RMS`` by the checks), and on how
many draws the bound at the element of the largest gap lies under the
fixed cap the check used before (``OLD_CAP``) and on how many above it;
then the ratios of two planted faults (the last q tile zeroed, channel 5
without its v scale) to the bound, and the largest ratio and the root mean
square of a fault spread inside the bound (``spread_fault``).
"""

from __future__ import annotations

import argparse

import torch

from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

SHAPE = (3, 4, 700, 300)          # B, H, Sq, Skv
KV_VALID_ROWS = (200, 300, 17)
OLD_CAP = 1e-1                    # the fixed cap the bound replaced


def _segments(b, sq, skv):
    q_seg = torch.ones(b, sq, dtype=torch.int32)
    q_seg[0, 17] = 2                      # a row no key matches
    kv_seg = torch.zeros(b, skv, dtype=torch.int32)
    for i, n in enumerate(KV_VALID_ROWS[:b]):
        kv_seg[i, :n] = 1
    return q_seg, kv_seg


def _draw(seed: int, d: int, pv_int8: bool):
    """(operands, segments, plain at K4_TILE_KV, plain at JAX's block,
    int8_order_bound) on one draw."""
    b, h, sq, skv = SHAPE
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g).to(torch.bfloat16)
               for n in (sq, skv, skv))
    ops = fa.int8_prologue(q, k, v, pv_int8=pv_int8)
    segs = _segments(b, sq, skv)
    tile = fa.int8_attention_plain(ops, *segs, block_kv=fa.K4_TILE_KV,
                                   out_dtype=torch.bfloat16)
    block = fa.int8_attention_plain(ops, *segs, out_dtype=torch.bfloat16)
    return ops, segs, tile, block, fa.int8_order_bound(ops, block, *segs)


def _ratios(out, block, bound) -> tuple[float, float]:
    """(largest |out - block| / bound, its root mean square)"""
    r = (out.float() - block.float()).abs() / bound
    return float(r.max()), float(r.square().mean().sqrt())


def order_gap(seed: int, d: int,
              pv_int8: bool) -> tuple[float, float, float, float]:
    """(max |plain at K4_TILE_KV - plain at JAX's kv block|, the largest
    ratio of that gap to ``int8_order_bound``, the bound at the element of
    the largest gap, the ratio's root mean square) on one draw."""
    _, _, tile, block, bound = _draw(seed, d, pv_int8)
    gap = (tile.float() - block.float()).abs()
    i = int(gap.argmax())
    ratio, rms = _ratios(tile, block, bound)
    return float(gap.max()), ratio, float(bound.flatten()[i]), rms


def spread_fault(seed: int, d: int, pv_int8: bool,
                 share: float = 0.9) -> tuple[float, float]:
    """(largest ratio, root mean square) against ``int8_order_bound`` of
    an order fault spread inside the bound: every element where the two
    orders disagree moved ``share`` of its bound from the block-stepped
    output, in the gap's direction."""
    _, _, tile, block, bound = _draw(seed, d, pv_int8)
    gap = tile.float() - block.float()
    out = block.float() + share * bound * torch.sign(gap)
    return _ratios(out, block, bound)


def planted_ratios(seed: int, d: int, pv_int8: bool) -> dict:
    """The largest ratio to ``int8_order_bound`` of two planted faults
    made of the tile-stepped output: its last q tile zeroed, and its
    channel 5 divided by the channel's v scale (QK+PV) or by 0.5 (QK)."""
    ops, _, tile, block, bound = _draw(seed, d, pv_int8)
    sq = tile.shape[2]
    zeroed = tile.clone()
    zeroed[:, :, (sq - 1) // 128 * 128:] = 0
    dropped = tile.clone()
    c_scale = ops.v_scale[:, :, 5, None] if pv_int8 else 0.5
    dropped[..., 5] = (tile[..., 5].float() / c_scale).to(tile.dtype)
    return {name: float(((out.float() - block.float()).abs() / bound).max())
            for name, out in (("last q tile zeroed", zeroed),
                              ("channel 5 scale dropped", dropped))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for d in (64, 80):
        for pv_int8 in (True, False):
            draws = [(*order_gap(s, d, pv_int8), s)
                     for s in range(args.seeds)]
            gap, _, at, _, seed = max(draws)
            ratio = max(r for _, r, _, _, _ in draws)
            rms = [m for *_, m, _ in draws]
            under = sum(b < OLD_CAP for _, _, b, _, _ in draws)
            tier = "QK+PV" if pv_int8 else "QK"
            planted = planted_ratios(seed, d, pv_int8)
            spread = spread_fault(seed, d, pv_int8)
            print(f"D={d} {tier}: over {args.seeds} seeds max gap {gap:.4f} "
                  f"(seed {seed}, bound there {at:.4f}); largest gap / "
                  f"bound {ratio:.4f}; its root mean square "
                  f"{min(rms):.4f}-{max(rms):.4f} (limit "
                  f"{fa.K4_ORDER_RMS}); bound at the largest gap under "
                  f"{OLD_CAP} on {under} draws, above on "
                  f"{args.seeds - under}; planted faults on seed {seed}: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in planted.items())
                  + f"; spread fault largest {spread[0]:.2f}, root mean "
                  f"square {spread[1]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
