#!/usr/bin/env python3
"""Drive the PyTorch port's text-to-video paths on one NVIDIA GPU:
LTX-Video 2B and Wan 2.1 t2v-1.3B.

    python3 chip_smoke.py              # one card; a few minutes on an H100
    python3 chip_smoke.py --profile    # and device-time breakdowns

Phases, one output line each (or a few):

1. device   the card, its power limit, TF32 switched off for matmul/cuDNN.
2. build    nvcc builds csrc/ into the kernel library (seconds, registers).
3. K1       the attention kernel against its plain version at the main
            path's shapes (self-attention B=3 H=32 S=5280 D=64; cross-
            attention to 256 masked text tokens with one q row that sees
            no key; D=128; ragged S), bf16 against fp32, atol=rtol=2e-2.
4. K2       the dynamic-int8 linear at every main-path shape (LTX-2B and
            Wan-1.3B): the int8 activations and int32 accumulators equal
            the plain version's exactly, the outputs agree to 1e-2
            relative.
5. K4       the int8 attention kernel, both tiers (QK+PV, QK), against its
            plain version on the same prologue operands at the Wan shapes
            (self-attention B=2 H=12 S=32760 D=128 on head-split views;
            cross-attention to 512 text tokens with padding and a q row
            that sees no key), and at D=64, ragged, kv_valid and causal
            shapes. The plain version steps its online softmax by the
            kernel's 64-row tile, the kernel's math: every element within
            int8_tile_bound (a few P codes apart, each worth max|v| /
            (127 * the row's softmax mass), then one bf16 rounding), the
            mean difference under 5e-4 of the mean |output|; planted
            faults at the self-attention shape (the last q tile zeroed,
            a channel without its v scale) must fail that check. By JAX's
            kv block: max < 1e-1, mean < 1e-3. Against exact fp32
            attention the kernel's mean abs error is at most 1.1x the
            plain version's.
6. timing   each kernel and its plain version, CUDA events, median of 5
            (K4's plain version at the self-attention shape: median of 3).
7. path     LTX-2B at full width (28 layers, 32x64 heads, int8_dynamic),
            the 0.9.7 VAE decoder and T5-XXL, random weights from seeds:
            a 2-layer cut of the DiT on the card against the plain
            versions on the CPU, then three requests through
            a T5 encode of seeded token ids and LTXVideoGenerator.generate
            (256x256x9, 512x320x41, 704x480x121; 8 steps, CFG + STG,
            stochastic sampling, decode noise), each with its stage times
            (T5, denoise, decode), peak memory and kernel launch counts.
8. wan      the LTX models are freed; Wan 2.1 t2v-1.3B at full width (30
            layers, 12x128 heads, ffn 8960, int8_dynamic), UMT5-XXL (24
            layers, d 4096, bf16) and the Wan VAE decoder (dim 96, z 16),
            random weights from seeds: a 2-layer cut of the DiT at
            832x480x17 on the card against the plain versions on the CPU,
            then three requests through a UMT5 encode of seeded token ids
            and WanPipeline.generate_t2v (UniPC, shift 5, guide scale 5,
            CFG-Zero-star, tiled VAE decode; 4 steps, the alpha rescale
            from step 1 as from step 6 of 50): 832x480x17 (7800
            tokens a stream) in the default tier (K4 QK+PV) and in the
            QK tier, and 832x480x81 (32760 tokens); stage times, peak
            memory, launch counts of K2 and K4.
9. profile  only with --profile: one more 704x480x121 LTX request and one
            more 832x480x81 Wan request under torch.profiler; device span,
            busy time, idle share and device time by kernel group (K1, K2,
            K4, ...), read from the exported traces.

Then a JSON line with one entry per kernel, and last the line
{"ok": true, "device": {...}}. Any failure raises: the script exits
nonzero and prints no result. It needs CUDA and this repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

K1_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention.cu"
K1_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:160"
K2_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/int8_linear.cu"
K2_REPLACES = "ltx_video_gpupoor_tpu/ops/int8_matmul.py:40"
K4_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_int8.cu"
K4_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:160"
# K4 against its plain version stepped by JAX's kv block (see _k4_case):
# P against other running maxima (0.034 max, 1.4e-4 mean emulated on the
# CPU at the cross shape)
K4_BLOCK_MAX, K4_BLOCK_MEAN = 1e-1, 1e-3

# main-path K2 shapes: (name, M, K, N, activation dtype)
TOKENS = 3 * 5280          # three guidance streams at 704x480x121
K2_SHAPES = [
    ("qkvo 2048->2048", TOKENS, 2048, 2048, "bf16"),
    ("ffn_in 2048->8192", TOKENS, 2048, 8192, "bf16"),
    ("ffn_out 8192->2048", TOKENS, 8192, 2048, "bf16"),
    ("patchify 128->2048", TOKENS, 128, 2048, "bf16"),
    ("proj_out 2048->128", TOKENS, 2048, 128, "bf16"),
    ("caption 4096->2048", 3 * 256, 4096, 2048, "bf16"),
    ("cross kv 2048->2048", 3 * 256, 2048, 2048, "bf16"),
    ("adaln emb 256->2048 M=3", 3, 256, 2048, "fp32"),
    ("adaln 2048->12288 M=3", 3, 2048, 12288, "fp32"),
    ("adaln 2048->12288 M=48", 48, 2048, 12288, "fp32"),
    # Wan 2.1 1.3B at 832x480x81: two CFG streams of 32760 tokens
    ("wan qkvo 1536->1536", 2 * 32760, 1536, 1536, "bf16"),
    ("wan ffn_in 1536->8960", 2 * 32760, 1536, 8960, "bf16"),
    ("wan ffn_out 8960->1536", 2 * 32760, 8960, 1536, "bf16"),
    ("wan head 1536->64", 2 * 32760, 1536, 64, "fp32"),
    ("wan cross k/v 1536->1536 M=1024", 1024, 1536, 1536, "bf16"),
    ("wan text 4096->1536 M=1024", 1024, 4096, 1536, "bf16"),
    ("wan time_projection 1536->9216 M=2", 2, 1536, 9216, "fp32"),
]
K2_TIMED = "wan ffn_in 1536->8960"

# Wan 2.1 1.3B attention shapes (B, H, Sq, Skv, D)
WAN_SELF = (2, 12, 32760, 32760, 128)
WAN_CROSS = (2, 12, 32760, 512, 128)
WAN_REQUESTS = [(480, 832, 17, "auto"), (480, 832, 17, "pallas_int8"),
                (480, 832, 81, "auto")]      # (H, W, F, attention tier)
WAN_STEPS = 4
WAN_CFG_ZERO_STEP = 0    # the default 5 of 50 steps, cut with the steps

REQUESTS = [(256, 256, 9), (320, 512, 41), (480, 704, 121)]  # (H, W, F)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------------------
# phases 1-2
# --------------------------------------------------------------------------

def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"[device] {name}; count={torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(smi[0] if smi else "nvidia-smi: no output")
    return name, (smi[0] if smi else "")


def phase_build():
    from ltx_video_gpupoor_tpu_torch.ops import _lib

    path, seconds, report = _lib.build(force=True)
    _lib.library()
    lines = [ln.strip() for ln in report.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    log(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.2f} s")
    for ln in lines:
        if "Compiling entry" in ln:
            log("  " + ln.split("'")[1][:60] if "'" in ln else "  " + ln)
        elif "Used" in ln or ("spill" in ln and "0 bytes spill" not in ln):
            log("    " + ln.replace("ptxas info    : ", ""))
    return seconds


# --------------------------------------------------------------------------
# phase 3: K1
# --------------------------------------------------------------------------

def _heads(b, h, s, d, gen, packed):
    """Random bf16 ``[B, H, S, D]``; ``packed``: the DiT's head-split view
    of a ``[B, S, H*D]`` projection."""
    import torch

    dev = torch.device("cuda")
    if packed:
        t = torch.randn(b, s, h * d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        return t.view(b, s, h, d).transpose(1, 2)
    return torch.randn(b, h, s, d, generator=gen, device=dev,
                       dtype=torch.bfloat16)


def _k1_case(name, b, h, sq, skv, d, *, packed=False, seg=None, causal=False,
             kv_valid=None, gen):
    """Run K1 and the plain version; returns (max_abs_err, out, args)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    segs = seg(b, sq, skv) if seg else (None, None)
    out = fa.flash_attention(q, k, v, *segs, causal=causal,
                             kv_valid=kv_valid)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):        # the fp32 plain version, one batch row at a time
        sl = slice(i, i + 1)
        ref = fa.reference_attention(
            q[sl].float(), k[sl].float(), v[sl].float(),
            *(s_[sl] if s_ is not None else None for s_ in segs),
            causal=causal, kv_valid=kv_valid)
        torch.testing.assert_close(out[sl].float(), ref, atol=2e-2, rtol=2e-2,
                                   msg=lambda m: f"K1 {name}: {m}")
        err = max(err, float((out[sl].float() - ref).abs().max()))
        del ref
    assert torch.isfinite(out.float()).all(), f"K1 {name}: non-finite"
    log(f"[K1] {name}: B={b} H={h} Sq={sq} Skv={skv} D={d} "
        f"max_abs_err={err:.3e} ok")
    return err, out, (q, k, v, segs)


def _cross_segments(b, sq, skv):
    import torch

    dev = torch.device("cuda")
    q_seg = torch.ones(b, sq, dtype=torch.int32, device=dev)
    q_seg[0, 17] = 2                       # a row no key matches
    kv_seg = torch.zeros(b, skv, dtype=torch.int32, device=dev)
    for i, n in enumerate((200, skv, 17)[:b]):
        kv_seg[i, :n] = 1                  # padded T5 tails
    return q_seg, kv_seg


def phase_k1(gen):
    errs = []
    e, out, _ = _k1_case("self-attention", 3, 32, 5280, 5280, 64,
                         packed=True, gen=gen)
    errs.append(e)
    e, out, _ = _k1_case("cross-attention", 3, 32, 5280, 256, 64,
                         seg=_cross_segments, gen=gen)
    errs.append(e)
    assert float(out[0, :, 17].float().abs().max()) == 0.0, \
        "K1: a row with no valid key must be 0"
    errs.append(_k1_case("D=128", 1, 8, 2048, 2048, 128, gen=gen)[0])
    errs.append(_k1_case("ragged S, kv_valid", 2, 4, 1000, 1000, 64,
                         kv_valid=777, gen=gen)[0])
    errs.append(_k1_case("ragged causal", 1, 2, 333, 333, 128, causal=True,
                         gen=gen)[0])
    return max(errs)


# --------------------------------------------------------------------------
# phase 4: K2
# --------------------------------------------------------------------------

def _k2_operands(m, k, n, dtype, gen):
    import torch

    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_weights

    dev = torch.device("cuda")
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.float32)
    x = (x * torch.rand(m, 1, generator=gen, device=dev) * 4).to(dt)
    if m > 2:
        x[1] = 0                           # s_x floors at 1e-8
    w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
    ql = quantize_weights(w)
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    return x, ql.w_int8, ql.scale, bias


def phase_k2(gen):
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    worst = 0.0
    for name, m, k, n, dtype in K2_SHAPES:
        x, w8, sw, bias = _k2_operands(m, k, n, dtype, gen)
        xq, sx, acc = im.int8_linear_acc(x, w8)
        pq, ps = im.quantize_rows_plain(x)
        assert torch.equal(xq, pq), f"K2 {name}: int8 activations differ"
        assert torch.equal(sx, ps[:, 0]), f"K2 {name}: row scales differ"
        pacc = im.int8_gemm_acc_plain(pq, w8)
        assert torch.equal(acc, pacc), f"K2 {name}: int32 accumulators differ"
        out = im.int8_linear(x, w8, sw, bias)
        ref = im.int8_linear_plain(x, w8, sw, bias)
        torch.cuda.synchronize()
        assert out.dtype == x.dtype and out.shape == (m, n)
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                                   atol=1e-6, msg=lambda s: f"K2 {name}: {s}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log(f"[K2] {name}: M={m} K={k} N={n} x={dtype} int8/int32 exact, "
            f"max_abs_err={err:.3e} ok")
        del x, w8, sw, bias, xq, sx, acc, pq, ps, pacc, out, ref
    return worst


# --------------------------------------------------------------------------
# phase 5: K4
# --------------------------------------------------------------------------

def _exact_mean_errs(q, k, v, segs, outs, **kw):
    """Mean abs error of each of ``outs`` against exact fp32 attention,
    computed by batch row and q-row chunk (the scores of one chunk stay
    near 2**28 elements; chunks only where ``causal`` is off)."""
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    b, h, sq, _ = q.shape
    step = sq if kw.get("causal") else max(1, (1 << 28) // (h * k.shape[2]))
    sums = [0.0] * len(outs)
    for i in range(b):
        sl = slice(i, i + 1)
        for r0 in range(0, sq, step):
            rs = slice(r0, min(r0 + step, sq))
            qs = None if segs[0] is None else segs[0][sl, rs]
            ks = None if segs[1] is None else segs[1][sl]
            ref = fa.reference_attention(q[sl, :, rs].float(), k[sl].float(),
                                         v[sl].float(), qs, ks, **kw)
            for j, o in enumerate(outs):
                sums[j] += float((o[sl, :, rs].float() - ref).abs().sum())
            del ref
    return [x / q.numel() for x in sums]


def _k4_tile_check(kern, tile, bound):
    """(largest |kern - tile| / bound, mean |kern - tile| / mean |tile|)"""
    diff = (kern.float() - tile.float()).abs()
    return (float((diff / bound).max()),
            float(diff.mean() / tile.float().abs().mean()))


def _k4_case(name, b, h, sq, skv, d, *, pv_int8, gen, packed=False,
             seg=None, causal=False, kv_valid=None, exact=True, plant=False):
    """K4 against its plain version on the same prologue operands: (a)
    stepping the online softmax by the kernel's 64-row tile, the same
    math, where only fp32 summation order and exp2f's approximation
    differ: every element within int8_tile_bound, the mean within
    K4_TILE_MEAN_REL of the mean |output|; with ``plant``, two planted
    faults (the last q tile zeroed, one channel without its v scale or
    doubled) must fail that check; (b) stepping by JAX's kv block, where
    P is quantized against other running maxima; (c) where it is not too
    costly, both against exact fp32 attention: the kernel may not add
    error to the tier's own. Returns the max abs error of (a)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    segs = seg(b, sq, skv) if seg else (None, None)
    kw = dict(causal=causal, kv_valid=kv_valid)
    ops = fa.int8_prologue(q, k, v, pv_int8=pv_int8)
    kern = fa.int8_attention_cuda(ops, *segs, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(kern.float()).all(), f"K4 {name}: non-finite"
    tile = fa.int8_attention_plain(ops, *segs, block_kv=fa.K4_TILE_KV,
                                   out_dtype=q.dtype, **kw)
    bound = fa.int8_tile_bound(ops, tile, *segs, **kw)
    err = float((kern.float() - tile.float()).abs().max())
    ratio, rel = _k4_tile_check(kern, tile, bound)
    assert ratio <= 1.0 and rel < fa.K4_TILE_MEAN_REL, \
        (f"K4 {name}: vs plain at the kernel's tile max {err:.3e}, "
         f"{ratio:.3f} of the bound, mean {rel:.3e} of the mean |output|")
    planted = ""
    if plant:
        zeroed = kern.clone()
        zeroed[:, :, (sq - 1) // 64 * 64:] = 0
        dropped = kern.clone()
        c_scale = ops.v_scale[:, :, 5, None] if pv_int8 else 0.5
        dropped[..., 5] = (kern[..., 5].float() / c_scale).to(kern.dtype)
        found = []
        for fault, out in (("last q tile zeroed", zeroed),
                           ("channel 5 scale dropped", dropped)):
            f_ratio, f_rel = _k4_tile_check(out, tile, bound)
            assert f_ratio > 1.0 and f_rel >= fa.K4_TILE_MEAN_REL, \
                f"K4 {name}: the check passes a planted fault ({fault})"
            found.append(f"{fault}: {f_ratio:.1f} of the bound, mean "
                         f"{f_rel:.2e}")
        planted = "; planted faults fail it (" + "; ".join(found) + ")"
        del zeroed, dropped
    del tile, bound
    plain = fa.int8_attention_plain(ops, *segs, out_dtype=q.dtype, **kw)
    diff = (kern.float() - plain).abs()
    err_j, mean_j = float(diff.max()), float(diff.mean())
    del diff
    assert err_j < K4_BLOCK_MAX and mean_j < K4_BLOCK_MEAN, \
        f"K4 {name}: vs plain at JAX's block max {err_j:.3e} mean {mean_j:.3e}"
    msg = ""
    if exact:
        ex_k, ex_p = _exact_mean_errs(q, k, v, segs, [kern, plain], **kw)
        assert ex_k <= 1.1 * ex_p + 1e-5, \
            f"K4 {name}: mean abs error vs exact {ex_k:.3e} > 1.1 x {ex_p:.3e}"
        msg = f"; vs exact mean {ex_k:.3e} (plain {ex_p:.3e})"
    del plain
    if seg:
        assert float(kern[0, :, 17].float().abs().max()) == 0.0, \
            f"K4 {name}: a row with no valid key must be 0"
    tier = "QK+PV" if pv_int8 else "QK"
    log(f"[K4] {name} ({tier}): B={b} H={h} Sq={sq} Skv={skv} D={d} "
        f"kv_block={ops.kv_block}: vs plain at the kernel's tile max "
        f"{err:.3e}, {ratio:.3f} of the bound, mean {rel:.3e} of the mean "
        f"|output|{planted}; at JAX's block max {err_j:.3e} mean "
        f"{mean_j:.3e}{msg} ok")
    return err


def phase_k4(gen):
    """Both tiers at the Wan shapes and at the edges; returns the worst
    error per tier."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    errs = {True: [], False: []}
    for pv in (True, False):
        errs[pv].append(_k4_case("wan self-attention", *WAN_SELF, pv_int8=pv,
                                 gen=gen, packed=True, plant=True))
        errs[pv].append(_k4_case("wan cross-attention", *WAN_CROSS,
                                 pv_int8=pv, gen=gen, packed=True,
                                 seg=_cross_segments))
        errs[pv].append(_k4_case("D=64 ragged S, kv_valid", 2, 4, 1000, 1000,
                                 64, pv_int8=pv, gen=gen, kv_valid=777))
        errs[pv].append(_k4_case("D=64 text segments", 3, 4, 700, 300, 64,
                                 pv_int8=pv, gen=gen, seg=_cross_segments))
        errs[pv].append(_k4_case("ragged causal", 1, 2, 333, 333, 128,
                                 pv_int8=pv, gen=gen, causal=True))
        torch.cuda.empty_cache()
    # the wrapper: prologue + kernel, output in q's head-split layout
    q, k, v = (_heads(2, 12, 4000, 128, gen, True) for _ in range(3))
    out = fa.flash_attention_int8(q, k, v)
    ref = fa.int8_attention_cuda(fa.int8_prologue(q, k, v))
    assert out.stride() == q.stride() and torch.equal(out, ref)
    log("[K4] wrapper: prologue + kernel in q's head-split layout ok")
    return max(errs[True]), max(errs[False])


# --------------------------------------------------------------------------
# phase 6: timing
# --------------------------------------------------------------------------

def phase_timing(gen):
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    times = {}
    b, h, s, d = 3, 32, 5280, 64
    q, k, v = (_heads(b, h, s, d, gen, True) for _ in range(3))

    def plain_self():
        for i in range(b):
            fa.reference_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])

    kern = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(plain_self, reps=3, warmup=1)
    flops = fa.attention_flops(b, h, s, s, d)
    times["K1 self"] = (kern, plain)
    log(f"[time] K1 self-attention B=3 H=32 S=5280 D=64: kernel {kern:.3f} ms "
        f"({flops / kern / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms")
    kc, vc = (_heads(b, h, 256, d, gen, False) for _ in range(2))
    q_seg, kv_seg = _cross_segments(b, s, 256)
    kern_c = cuda_time_ms(lambda: fa.flash_attention(q, kc, vc, q_seg, kv_seg))
    plain_c = cuda_time_ms(lambda: fa.reference_attention(
        q, kc, vc, q_seg, kv_seg), reps=3, warmup=1)
    times["K1 cross"] = (kern_c, plain_c)
    log(f"[time] K1 cross-attention Sq=5280 Skv=256: kernel {kern_c:.3f} ms, "
        f"plain {plain_c:.3f} ms")
    del q, k, v, kc, vc

    # K4 at the Wan shapes: the kernel body and the plain version on the
    # same prologue operands, and the shared prologue on its own
    for name, (b, h, sq, skv, d), seg in (("self", WAN_SELF, None),
                                          ("cross", WAN_CROSS,
                                           _cross_segments)):
        q, k, v = (_heads(b, h, n, d, gen, True) for n in (sq, skv, skv))
        segs = seg(b, sq, skv) if seg else (None, None)
        for pv in (True, False):
            tier = "int8pv" if pv else "int8qk"
            ops = fa.int8_prologue(q, k, v, pv_int8=pv)
            kern = cuda_time_ms(lambda: fa.int8_attention_cuda(ops, *segs))
            pro = cuda_time_ms(lambda: fa.int8_prologue(q, k, v, pv_int8=pv))
            plain = cuda_time_ms(lambda: fa.int8_attention_plain(ops, *segs),
                                 reps=3, warmup=1)
            flops = fa.attention_flops(b, h, sq, skv, d)
            times[f"K4 {tier} {name}"] = (kern, plain)
            log(f"[time] K4 {tier} {name}-attention B={b} H={h} Sq={sq} "
                f"Skv={skv} D={d}: kernel {kern:.3f} ms "
                f"({flops / kern / 1e9:.1f} TOP/s), plain {plain:.3f} ms, "
                f"prologue {pro:.3f} ms")
            del ops
        del q, k, v
        torch.cuda.empty_cache()

    for name, m, kk, n, dtype in K2_SHAPES:
        if m < 100 and name != "adaln 2048->12288 M=48":
            continue
        x, w8, sw, bias = _k2_operands(m, kk, n, dtype, gen)
        kern = cuda_time_ms(lambda: im.int8_linear(x, w8, sw, bias))
        plain = cuda_time_ms(lambda: im.int8_linear_plain(x, w8, sw, bias),
                             reps=3, warmup=1)
        times[f"K2 {name}"] = (kern, plain)
        log(f"[time] K2 {name} M={m}: kernel {kern:.3f} ms "
            f"({2 * m * kk * n / kern / 1e9:.1f} TOP/s), plain {plain:.3f} ms")
        del x, w8, sw, bias
    torch.cuda.empty_cache()
    return times


# --------------------------------------------------------------------------
# phase 7: the LTX path
# --------------------------------------------------------------------------

def ltx2b_config():
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf

    return tf.LTXTransformerConfig(
        num_attention_heads=32, attention_head_dim=64, in_channels=128,
        out_channels=128, num_layers=28, cross_attention_dim=2048,
        caption_channels=4096)


def vae_config():
    """The 0.9.7 VAE with timestep conditioning on, so that the decode
    noise and the decoder's timestep modulation run."""
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem

    return vaem.VAEConfig.from_dict(
        {**vaem.LTX_VAE_CONFIG_097, "timestep_conditioning": True})


def build_models(cfg, vcfg):
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models import t5 as t5m
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dit = tf.init_params(tf.LTXTransformer3D(cfg, DEFAULT_POLICY, device=dev),
                         torch.Generator(device=dev).manual_seed(SEED))
    dense_cut = {k: v.cpu() for k, v in dit.state_dict().items()
                 if not k.startswith("blocks.")
                 or k.split(".")[1] in ("0", "1")}
    quantize_params(dit)
    vae = vaem.init_params(vaem.CausalVAEDecoder(vcfg, DEFAULT_POLICY,
                                                 device=dev),
                           torch.Generator(device=dev).manual_seed(SEED + 1))
    t5 = t5m.init_params(t5m.T5Encoder(t5m.T5_XXL, device=dev,
                                       dtype=torch.bfloat16),
                         torch.Generator(device=dev).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    n_dit = sum(t.numel() for t in dit.state_dict().values())
    n_t5 = sum(t.numel() for t in t5.state_dict().values())
    log(f"[path] built DiT ({cfg.num_layers} layers, {n_dit / 1e9:.3f}e9 "
        f"values, int8_dynamic), VAE decoder (timestep-conditioned), T5 "
        f"({t5.cfg.num_layers} layers, {n_t5 / 1e9:.3f}e9 values, bf16) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dit, dense_cut, vae, t5


def reference_check(cfg, dense_cut):
    """A 2-layer cut of the DiT (the main model's own first two blocks) on
    the card with the kernels against the same cut on the CPU with the
    plain versions, both int8_dynamic in bf16, at the 256x256x9 request's
    token count. Bar: 30 dB PSNR on the velocity (bf16 roundings that
    differ between a kernel and its plain version can flip an int8 code of
    the next linear's activations)."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    cut = dataclasses.replace(cfg, num_layers=2)
    models = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        m = tf.LTXTransformer3D(cut, DEFAULT_POLICY, device=d)
        m.load_state_dict(dense_cut)
        models.append(quantize_params(m))
    g = torch.Generator().manual_seed(SEED + 3)
    f, h, w = 2, 8, 8
    lat = torch.randn(3, f * h * w, cfg.in_channels, generator=g)
    grid = torch.stack(torch.meshgrid(torch.arange(f), torch.arange(h),
                                      torch.arange(w), indexing="ij"))
    grid = (grid.reshape(1, 3, -1).float()
            * torch.tensor([8 / 25, 32.0, 32.0])[None, :, None]
            ).expand(3, -1, -1)
    t = torch.full((3, f), 0.9)
    cap = torch.randn(3, 256, cfg.caption_channels, generator=g)
    mask = torch.ones(3, 256, dtype=torch.int32)
    mask[:, 77:] = 0
    skip = torch.ones(2, 3)
    skip[1, 2] = 0
    kw = dict(skip_layer_mask=skip,
              skip_layer_strategy=tf.SkipLayerStrategy.AttentionValues)
    with torch.no_grad():
        l0, a0 = im.int8_linear.launches, fa.flash_attention.launches
        out = models[0](*(x.cuda() for x in (lat, grid, t, cap, mask)), **kw)
        torch.cuda.synchronize()
        assert im.int8_linear.launches > l0, "K2 not launched"
        assert fa.flash_attention.launches > a0, "K1 not launched"
        ref = models[1](lat, grid, t, cap, mask, **kw)
    o = out.float().cpu().numpy()
    r = ref.float().numpy()
    assert np.isfinite(o).all() and o.shape == r.shape
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o - r) ** 2))
    db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
    log(f"[path] reference check, 2-layer cut at full width, kernels on "
        f"the card vs plain versions on the CPU: PSNR {db:.2f} dB (bar 30)")
    assert db >= 30.0, f"reference check {db:.2f} dB < 30"
    return db


def encode_prompts(t5, seq=256):
    import torch

    from ltx_video_gpupoor_tpu_torch.models import t5 as t5m

    g = torch.Generator().manual_seed(SEED + 4)
    ids = torch.randint(0, t5.cfg.vocab_size, (2, seq), generator=g)
    mask = torch.zeros(2, seq, dtype=torch.int32)
    mask[0, :20] = 1        # negative prompt
    mask[1, :77] = 1        # positive prompt
    ids, mask = ids.cuda(), mask.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = t5m.encode(t5, ids, mask)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    assert emb.shape == (2, seq, t5.cfg.dim) and torch.isfinite(emb).all()
    return emb, mask, sec


def run_request(gen, t5, height, width, frames):
    """One request: T5 encode of its prompts, then ``generate``."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    marks = {}
    checks = {}

    def on_stage(name, value):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()
        if name == "decode":
            checks["latents_finite"] = bool(torch.isfinite(value).all())
            checks["latent_shape"] = tuple(value.shape)
        if name == "postprocess":
            checks["pixels_finite"] = bool(torch.isfinite(value.float()).all())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    im.int8_linear.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    emb, mask, t5_sec = encode_prompts(t5)
    frames_u8 = gen.generate(emb, mask, height=height, width=width,
                             frame_num=frames, frame_rate=25.0, seed=SEED,
                             on_stage=on_stage)
    t_end = time.perf_counter()
    launches = {"K1": fa.flash_attention.launches,
                "K2": im.int8_linear.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    denoise = marks["decode"] - marks["denoise"]
    decode = marks["postprocess"] - marks["decode"]
    post = t_end - marks["postprocess"]
    tokens = 1
    for s_ in checks["latent_shape"][1:4]:
        tokens *= s_
    log(f"[path] request {width}x{height}x{frames}: tokens={tokens} "
        f"t5={t5_sec:.3f} s denoise={denoise:.3f} s decode={decode:.3f} s "
        f"postprocess={post:.3f} s total={t_end - t0:.3f} s "
        f"peak={peak:.2f} GiB frames={frames_u8.dtype.name}"
        f"{list(frames_u8.shape)} latents_finite={checks['latents_finite']} "
        f"pixels_finite={checks['pixels_finite']} launches={launches}")
    assert frames_u8.dtype.name == "uint8" and \
        frames_u8.shape == (frames, height, width, 3), frames_u8.shape
    assert checks["latents_finite"] and checks["pixels_finite"]
    assert launches["K1"] > 0 and launches["K2"] > 0, launches
    assert frames_u8.std() > 0, "constant frames"
    return launches


def phase_path():
    """Build the models, check a cut against the plain versions, then serve
    REQUESTS; returns the launch counts per request and the generator."""
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import LTXPipeline
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )

    cfg = ltx2b_config()
    dit, dense_cut, vae, t5 = build_models(cfg, vae_config())
    reference_check(cfg, dense_cut)
    del dense_cut
    gen = LTXVideoGenerator(LTXPipeline(dit, vae),
                            pipeline_config="ltxv-2b-0.9.6-distilled")
    launches = []
    for height, width, frames in REQUESTS:
        launches.append(run_request(gen, t5, height, width, frames))
        torch.cuda.empty_cache()
    return launches, gen, t5


# --------------------------------------------------------------------------
# phase 8: the Wan path
# --------------------------------------------------------------------------

def build_wan_models():
    """Wan 2.1 t2v-1.3B (int8_dynamic), the Wan VAE decoder and UMT5-XXL
    at full width on the card, random weights from seeds; also the dense
    bf16 weights of the DiT's first two blocks and the rest, on the CPU."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models import t5 as t5m
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as wv
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = wm.WAN_T2V_1_3B
    dit = wm.init_params(wm.WanModel(cfg, DEFAULT_POLICY, device=dev),
                         torch.Generator(device=dev).manual_seed(SEED + 10))
    dense_cut = {k: v.cpu() for k, v in dit.state_dict().items()
                 if not k.startswith("blocks.")
                 or k.split(".")[1] in ("0", "1")}
    quantize_params(dit)
    vae = wv.init_params(wv.WanVAEDecoder(wv.WanVAEConfig(), DEFAULT_POLICY,
                                          device=dev),
                         torch.Generator(device=dev).manual_seed(SEED + 11))
    umt5 = t5m.init_params(t5m.T5Encoder(t5m.UMT5_XXL, device=dev,
                                         dtype=torch.bfloat16),
                           torch.Generator(device=dev).manual_seed(SEED + 12))
    torch.cuda.synchronize()
    n_dit = sum(t.numel() for t in dit.state_dict().values())
    n_t5 = sum(t.numel() for t in umt5.state_dict().values())
    log(f"[wan] built DiT ({cfg.num_layers} layers, dim {cfg.dim}, "
        f"{cfg.num_heads}x{cfg.head_dim} heads, ffn {cfg.ffn_dim}, "
        f"{n_dit / 1e9:.3f}e9 values, int8_dynamic), VAE decoder (dim "
        f"{vae.cfg.dim}, z {vae.cfg.z_dim}), UMT5-XXL ({umt5.cfg.num_layers} "
        f"layers, {n_t5 / 1e9:.3f}e9 values, bf16) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dit, dense_cut, vae, umt5


def wan_reference_check(dense_cut, height=480, width=832, frames=17):
    """A 2-layer cut of the Wan DiT (the main model's own first two
    blocks) at 832x480x17, two CFG streams, text padding and an SLG-
    skipped layer, on the card with the kernels (K2, K4) against the same
    cut on the CPU with the plain versions, both int8_dynamic in bf16.
    Bar: 30 dB PSNR on the velocity (K4 quantizes P against a running max
    per 64-row tile, its plain version per kv block; bf16 roundings that
    differ can flip an int8 code of the next linear's activations)."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

    cut = dataclasses.replace(wm.WAN_T2V_1_3B, num_layers=2)
    models = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        m = wm.WanModel(cut, DEFAULT_POLICY, device=d)
        m.load_state_dict(dense_cut)
        models.append(quantize_params(m))
    g = torch.Generator().manual_seed(SEED + 13)
    f, h, w = (frames - 1) // 4 + 1, height // 8, width // 8
    x = torch.randn(2, f, h, w, cut.in_dim, generator=g)
    t = torch.tensor([900.0, 900.0])
    ctx = torch.randn(2, cut.text_len, cut.text_dim, generator=g)
    mask = torch.zeros(2, cut.text_len, dtype=torch.int32)
    mask[0, :77] = 1
    mask[1, :40] = 1
    keep = torch.ones(2, 2)
    keep[1, 1] = 0                         # SLG: layer 1, uncond stream
    grid = (f, h // 2, w // 2)
    t0 = time.perf_counter()
    with torch.no_grad():
        l0, a0 = im.int8_linear.launches, fa.flash_attention_int8.launches
        out, _ = models[0](*(a.cuda() for a in (x, t, ctx, mask)),
                           wan_rope_freqs(grid, cut.head_dim, device="cuda"),
                           slg_keep=keep)
        torch.cuda.synchronize()
        assert im.int8_linear.launches > l0, "K2 not launched"
        assert fa.flash_attention_int8.launches > a0, "K4 not launched"
        t1 = time.perf_counter()
        ref, _ = models[1](x, t, ctx, mask,
                           wan_rope_freqs(grid, cut.head_dim), slg_keep=keep)
    o = out.float().cpu().numpy()
    r = ref.float().numpy()
    assert np.isfinite(o).all() and o.shape == r.shape
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o - r) ** 2))
    db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
    log(f"[wan] reference check, 2-layer cut at full width, "
        f"{width}x{height}x{frames} ({f * (h // 2) * (w // 2)} tokens a "
        f"stream, 2 streams), kernels on the card ({t1 - t0:.2f} s) vs "
        f"plain versions on the CPU ({time.perf_counter() - t1:.1f} s): "
        f"PSNR {db:.2f} dB (bar 30)")
    assert db >= 30.0, f"Wan reference check {db:.2f} dB < 30"
    return db


def encode_wan_prompts(umt5):
    """A UMT5 encode of seeded token ids: (prompt, negative prompt), 512
    tokens each with 77 and 40 real ones."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models import t5 as t5m

    g = torch.Generator().manual_seed(SEED + 14)
    ids = torch.randint(0, umt5.cfg.vocab_size, (2, 512), generator=g)
    mask = torch.zeros(2, 512, dtype=torch.int32)
    mask[0, :77] = 1
    mask[1, :40] = 1
    ids, mask = ids.cuda(), mask.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = t5m.encode(umt5, ids, mask)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    assert emb.shape == (2, 512, umt5.cfg.dim) and torch.isfinite(emb).all()
    return emb, mask, sec


def run_wan_request(pipe, umt5, height, width, frames, mode):
    """One request: a UMT5 encode, then ``generate_t2v`` to pixels."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    marks, checks = {}, {}

    def on_stage(name, value):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()
        if name == "decode":
            checks["latents_finite"] = bool(torch.isfinite(value).all())
            checks["latent_shape"] = tuple(value.shape)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    im.int8_linear.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention_int8.launches = 0
    t0 = time.perf_counter()
    emb, mask, t5_sec = encode_wan_prompts(umt5)
    video = pipe.generate_t2v(
        emb, mask, width=width, height=height, frame_num=frames,
        sampling_steps=WAN_STEPS, shift=5.0, solver="unipc", guide_scale=5.0,
        cfg_zero_step=WAN_CFG_ZERO_STEP,
        generator=torch.Generator(device="cuda").manual_seed(SEED),
        output_type="pixels", attn_mode=mode, on_stage=on_stage)
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    launches = {"K1": fa.flash_attention.launches,
                "K2": im.int8_linear.launches,
                "K4": fa.flash_attention_int8.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixels_finite = bool(torch.isfinite(video.float()).all())
    frames_u8 = torch.clamp((video[0].float() + 1.0) * 127.5, 0, 255)
    frames_u8 = frames_u8.to(torch.uint8).cpu().numpy()
    t_end = time.perf_counter()
    f, h, w = checks["latent_shape"][1:4]
    tokens = f * (h // 2) * (w // 2)
    log(f"[wan] request {width}x{height}x{frames} tier={mode}: "
        f"tokens={tokens} a stream, steps={WAN_STEPS} umt5={t5_sec:.3f} s "
        f"denoise={marks['decode'] - marks['denoise']:.3f} s "
        f"decode={t_dec - marks['decode']:.3f} s "
        f"postprocess={t_end - t_dec:.3f} s total={t_end - t0:.3f} s "
        f"peak={peak:.2f} GiB frames={frames_u8.dtype.name}"
        f"{list(frames_u8.shape)} latents_finite={checks['latents_finite']} "
        f"pixels_finite={pixels_finite} launches={launches}")
    assert frames_u8.shape == (frames, height, width, 3), frames_u8.shape
    assert checks["latents_finite"] and pixels_finite
    assert launches["K4"] > 0 and launches["K2"] > 0, launches
    assert launches["K1"] == 0, launches     # every Wan head dim is 128
    assert frames_u8.std() > 0, "constant frames"
    return launches


def phase_wan():
    """Build the Wan models, check a cut against the plain versions, then
    serve WAN_REQUESTS; returns the launch counts per request, the
    pipeline and the encoder."""
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines.wan import WanPipeline

    dit, dense_cut, vae, umt5 = build_wan_models()
    wan_reference_check(dense_cut)
    del dense_cut
    pipe = WanPipeline(dit, vae)
    launches = []
    for height, width, frames, mode in WAN_REQUESTS:
        launches.append(run_wan_request(pipe, umt5, height, width, frames,
                                        mode))
        torch.cuda.empty_cache()
    return launches, pipe, umt5


# --------------------------------------------------------------------------
# phase 9 (--profile): where the device time of the headline requests goes
# --------------------------------------------------------------------------

# kernel name fragment -> group, first match wins
KERNEL_GROUPS = [
    ("flash_fwd_kernel", "K1 flash attention"),
    ("flash_int8_kernel", "K4 int8 flash attention"),
    ("int8_gemm_kernel", "K2 int8 GEMM"),
    ("quantize_rows_kernel", "K2 row quantize"),
    ("fprop", "cuDNN conv3d (VAE)"),
    ("cudnn", "cuDNN conv3d (VAE)"),
    ("nvjet", "cuBLAS GEMM (T5)"),
    ("gemm", "cuBLAS GEMM (T5)"),
]


def summarize_trace(path):
    """Device time of a torch.profiler chrome trace, from its ``kernel``,
    ``gpu_memcpy`` and ``gpu_memset`` events: the span from the first
    start to the last end, busy time (the union of the intervals, so
    overlap counts once), the idle share 1 - busy/span, and the summed
    durations by kernel group (all other kernels are PyTorch's own
    elementwise, reduction and copy kernels)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e.get("ph") == "X"]
    if not events:
        raise RuntimeError(f"{path}: the trace holds no device events")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    groups = {}
    for e in events:
        group = "PyTorch elementwise and copies"
        if e["cat"] == "kernel":
            name = e["name"].lower()
            group = next((g for frag, g in KERNEL_GROUPS if frag in name),
                         group)
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e["dur"] / 1e3, n + 1)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / span, "groups": groups}


def profile_request(name, run):
    """Run one more request (``run()``) under torch.profiler and print
    its device span, busy time, idle share and time by kernel group; the
    trace goes to the ignored build directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = os.path.join(ROOT, "ltx_video_gpupoor_tpu_torch", "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{name}.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    s = summarize_trace(path)
    log(f"[profile] {name} with the profiler on: wall "
        f"{wall:.3f} s; device span {s['span_ms']:.1f} ms, busy "
        f"{s['busy_ms']:.1f} ms, idle {100 * s['idle_share']:.2f} %; "
        f"trace {os.path.relpath(path, ROOT)}")
    for group, (ms, n) in sorted(s["groups"].items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {group}: {ms:.1f} ms "
            f"({100 * ms / s['busy_ms']:.1f} % of busy), {n} events")
    return s


def profile_ltx(gen, t5, height=480, width=704, frames=121):
    def run():
        emb, mask, _ = encode_prompts(t5)
        gen.generate(emb, mask, height=height, width=width, frame_num=frames,
                     frame_rate=25.0, seed=SEED)

    return profile_request(f"ltx_{width}x{height}x{frames}", run)


def profile_wan(pipe, umt5, height=480, width=832, frames=81):
    import torch

    def run():
        emb, mask, _ = encode_wan_prompts(umt5)
        pipe.generate_t2v(
            emb, mask, width=width, height=height, frame_num=frames,
            sampling_steps=WAN_STEPS, cfg_zero_step=WAN_CFG_ZERO_STEP,
            generator=torch.Generator(device="cuda").manual_seed(SEED),
            output_type="pixels")

    return profile_request(f"wan_{width}x{height}x{frames}", run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each path, profile one more headline "
                    "request (LTX 704x480x121, Wan 832x480x81) and print "
                    "the device time by kernel group")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    kind, _ = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_err = phase_k1(gen)
    k2_err = phase_k2(gen)
    k4_err = phase_k4(gen)
    times = phase_timing(gen)
    ltx_launches, generator, t5 = phase_path()
    if args.profile:
        profile_ltx(generator, t5)
    del generator, t5        # free the LTX models for the Wan path
    torch.cuda.empty_cache()
    wan_launches, pipe, umt5 = phase_wan()
    if args.profile:
        profile_wan(pipe, umt5)
    k1_t = times["K1 self"]
    k2_t = times[f"K2 {K2_TIMED}"]
    by_tier = dict(zip((m for *_, m in WAN_REQUESTS), wan_launches))
    kernels = [
        {"name": "flash_attention (exact online softmax)", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": ltx_launches[-1]["K1"], "max_abs_err": k1_err,
         "ms": k1_t[0], "plain_ms": k1_t[1]},
        {"name": "int8_linear (dynamic int8)", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": wan_launches[-1]["K2"], "max_abs_err": k2_err,
         "ms": k2_t[0], "plain_ms": k2_t[1]},
        {"name": "flash_attention_int8 (int8 QK + int8 PV)", "route": "cuda",
         "source": K4_SOURCE, "replaces": K4_REPLACES,
         "launches": wan_launches[-1]["K4"], "max_abs_err": k4_err[0],
         "ms": times["K4 int8pv self"][0],
         "plain_ms": times["K4 int8pv self"][1]},
        {"name": "flash_attention_int8 (int8 QK + bf16 PV)", "route": "cuda",
         "source": K4_SOURCE, "replaces": K4_REPLACES,
         "launches": by_tier["pallas_int8"]["K4"], "max_abs_err": k4_err[1],
         "ms": times["K4 int8qk self"][0],
         "plain_ms": times["K4 int8qk self"][1]},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
