#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: LTX-Video 2B
text-to-video, LTX-Video 13B image-to-video through the two-pass
multi-scale pipeline (one request of it through the HTTP server), the CLI,
Wan 2.1 t2v-1.3B, the ring-attention kernel and the attention
micro-benchmark tool.

    python3 chip_smoke.py              # one card; several minutes on an H100
    python3 chip_smoke.py --profile    # and device-time breakdowns

Phases, one output line each (or a few):

1. device   the card, its power limit, TF32 switched off for matmul/cuDNN.
2. build    nvcc builds csrc/ into the kernel library (seconds, registers).
3. K1       the attention kernel against its plain version at the main
            path's shapes (self-attention B=3 H=32 S=5280 D=64; cross-
            attention to 256 masked text tokens with one q row that sees
            no key; the 13B shapes B=1 H=32 S=3840 and 15360 D=128 on
            head-split views, cross-attention to 256 text tokens with
            segments and self-attention; ragged S), bf16 against fp32,
            atol=rtol=2e-2.
4. K2       the dynamic-int8 linear at every main-path shape (LTX-2B,
            Wan-1.3B and LTX-13B at both passes' token counts: 4096->4096,
            4096->16384, 16384->4096, patchify, proj_out, the caption and
            adaLN projections): the int8 activations and int32 accumulators equal
            the plain version's exactly, the outputs agree to 1e-2
            relative.
5. K4       the int8 attention kernel, both tiers (QK+PV, QK), against its
            plain version on the same prologue operands at the Wan shapes
            (self-attention B=2 H=12 S=32760 D=128 on head-split views;
            cross-attention to 512 text tokens with padding and a q row
            that sees no key), at the 13B shapes (self-attention B=1 H=32
            S=3840 and 15360 D=128; cross-attention to 256 text tokens
            with segments), and at D=64, ragged, kv_valid and causal
            shapes. The plain version steps its online softmax by the
            kernel's 64-row tile, the kernel's math: every element within
            int8_tile_bound (a few P codes apart, each worth max|v| /
            (127 * the row's softmax mass), then one bf16 rounding), the
            mean difference under 5e-4 of the mean |output|; planted
            faults at the self-attention shapes (the last q tile zeroed,
            a channel without its v scale) must fail that check. By JAX's
            kv block: max < 1e-1, mean < 1e-3. Against exact fp32
            attention the kernel's mean abs error is at most 1.1x the
            plain version's.
5b. K3     the bounded-score tier of the exact kernel against its plain
            version at the 13B shapes (self-attention B=1 H=32 S=3840 and
            15360 D=128 on head-split views; cross-attention to 256 text
            tokens with padding and a q row that sees no key) and at
            ragged, kv_valid, causal and D=64 shapes, with one q row whose
            scores lie over the bound: every element within two bf16 ulps
            of the plain version plus 2**-9 of its largest output; planted
            faults (the last q tile zeroed, a head scaled by 1 + 2**-5)
            must fail that check.
5c. K5     the fused adaLN prologue + int8 linear at the 13B shapes (M
            3840 and 15360, K 4096, N 12288 and 16384, 16 groups, so a
            group edge lies inside a GEMM tile) and at a ragged one: the
            int8 codes and row scales of the row kernel and the int32
            product equal the plain version's exactly, the outputs agree
            to 1e-2 relative; a planted fault (two groups' modulation rows
            swapped) must fail the check.
5d. K6     the head-packed kernel against its plain version at the 13B
            shapes (B=1 S=3840 and 15360, 32 heads of 128), at the LTX-2B
            shape (B=3 S=5280, 32 heads of 64), on slices of a fused q/k/v
            projection, ragged with a kv_valid tail and with an odd head
            count: K3's check and planted faults.
5e. K8     the sub-block-pipelined attention kernel against its plain
            version (the same sub-blocks, the same roundings) at B=2 H=32
            S=5376 D=64 for nsub 1, 2, 4, 8 and at B=1 H=2 S=1344 with
            64-row kv tiles: K3's check; a planted fault (two sub-blocks'
            V rows swapped) must fail it. Then the tool's own main() runs
            (ltx_video_gpupoor_tpu_torch.tools.mb_selfattn_pipeline): its
            check against exact attention, K1 and K8 per nsub timed (each
            instance's registers are in the build phase's ptxas lines).
5f. K7     the ring-attention kernel (the whole ring in one cooperative
            launch) for p = 2, 4, 8 at B=1 H=12 S=32768 D=128 in bf16
            against the same ring in plain PyTorch (K3's check) and
            against one K1 call on the joined tensors, twice in a row on
            one workspace; a planted fault (a rank skips a step's math)
            must fail the check; p = 1 runs without a workspace; at the
            JAX tests' shapes (B=1 H=2 S=64 D=32 and S=32 D=16, p = 8) in
            fp32 (atol 2e-5) and bf16 (atol 3e-2) through the CUDA-core
            body; on a dp2 x sp2 x tp2 mesh the rings that the neighbour
            ids spell out.
6. timing   each kernel and its plain version, CUDA events, median of 5
            (plain versions at the large attention shapes: median of 3),
            and the one PyTorch call that computes the same function where
            there is one (scaled_dot_product_attention for K1 and K6,
            torch._int_mm for K2's GEMM alone), timed here and used
            nowhere in the port; each kernel's bound (the larger of its
            operations over the card's peak rate and its bytes over the
            memory rate) is computed from the timed shapes.
7. path     LTX-2B at full width (28 layers, 32x64 heads, int8_dynamic),
            the 0.9.7 VAE decoder and T5-XXL, random weights from seeds:
            a 2-layer cut of the DiT on the card against the plain
            versions on the CPU, then two requests through
            a T5 encode of seeded token ids and LTXVideoGenerator.generate
            (256x256x9, 704x480x121; 8 steps, CFG + STG, stochastic
            sampling, decode noise), each with its stage times (T5,
            denoise, decode), peak memory and kernel launch counts.
7b. ltx13b  the LTX-2B DiT is freed; LTX-13B at full width and depth (48
            layers, 32x128 heads, inner 4096, int8_dynamic, built and
            quantized layer by layer), the 0.9.7 VAE with its encoder, the
            latent upsampler (mid 512, 4 blocks a stage) and the same
            T5-XXL: a 2-layer cut of the DiT on the card against the plain
            versions on the CPU in each tier, then three image-to-video
            requests at 992x608x121 from a seeded synthetic image through
            LTXVideoGenerator.generate with ltxv-13b-0.9.7-distilled (pass
            1 at 640x384, 3840 tokens, 7 steps; latent upsample; AdaIN;
            pass 2 at 1280x768, 15360 tokens, 3 steps; VAE decode in
            temporal tiles; resize back): (a) auto (K4 + K2), (b)
            pallas_hp with the fused prologue (K6, K5, K1 for the
            cross-attention, K2 for the rest), (c) attention_score_bound=40
            (K3 + K2). The launch counts are read per pass; the script
            fails unless K5 and K6 were launched in both passes of (b) and
            K3 in both passes of (c). Request (b) goes through the server:
7c. server  InferenceService around the 13B models with one warm-up
            bucket (which must complete, through K5, K6 and K2),
            create_stdlib_server on 127.0.0.1 in a thread, and
            urllib: POST / with a base64 PNG of the synthetic image at
            992x608x121 (the tier chosen as a server process chooses it:
            set_attention_mode("pallas_hp") and LTXV_TPU_FUSED_PROLOGUE=1),
            GET of the returned /download/ URL (an mp4 that load_video
            reads back to 121 frames of 608x992), a POST with a field
            missing (400), a path that leaves outputs/ (404), GET
            /metrics (the request's seconds by stage, the mp4 write among
            them). Then one request through the CLI's main() at 256x256x9
            on the demo model.
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
9. profile  only with --profile: one more 704x480x121 LTX-2B request, one
            more 13B request of kind (b) and one of kind (c) and one more
            832x480x81 Wan request under torch.profiler; device span, busy
            time, idle share and device time by kernel group (K1/K6, K3,
            K2, K4, K5, ...), read from the exported traces; the build
            phase also builds once with one source after another and
            prints that time beside the parallel build's.

Then a JSON line with one entry per kernel (its launches on its path, its
error against the plain version, its time, the plain version's, its bound
and the library call's), and last the line
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
K3_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:294"
K5_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/fused_prologue.cu"
K5_REPLACES = "ltx_video_gpupoor_tpu/ops/fused_prologue.py:104"
K6_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:663"
K7_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/ring_attention.cu"
K7_REPLACES = "ltx_video_gpupoor_tpu/parallel/ring_rdma.py:43"
K8_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_pipelined.cu"
K8_REPLACES = "tools/mb_selfattn_pipeline.py:32"
# the card's published peaks (H100 SXM, dense): operations per second by
# operand type, and bytes per second of device memory
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
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

REQUESTS = [(256, 256, 9), (480, 704, 121)]  # (H, W, F)

# K7: the Wan-1.3B self-attention width at the nearest length that every p
# times a 64-row tile divides; the JAX tests' shapes for the CUDA-core body
RING_SHAPE = (1, 12, 32768, 128)
RING_RANKS = (2, 4, 8)
RING_TIMED_P = 4
RING_SMALL = [(1, 2, 64, 32), (1, 2, 32, 16)]
RING_MESH = (("dp", 2), ("sp", 2), ("tp", 2))
# K8: the tool's shape, and its check's shape with 64-row kv tiles
K8_SHAPE = (2, 32, 5376, 64)
K8_SMALL = (1, 2, 1344, 64)
K8_JSON_NSUB = 4
# pass 1 at 256x256 and pass 2 at 512x512: 64 and 256 tokens a latent
# frame, multiples of 16, so the warm-up runs K5 as the request does (at
# 384x384 the config's factor 0.6666666 gives 255, snapped to 224: 49)
SERVER_WARMUP = "416x416x9"
CLI_REQUEST = (256, 256, 9)

# LTX-13B: image-to-video at 992x608x121 (pass 1 at 640x384 = 16 x 12 x 20
# latents = 3840 tokens, pass 2 at 1280x768 = 15360 tokens); attention
# shapes (B, H, Sq, Skv, D) and the fused prologue's (M, K, N, groups)
LTX13B_REQUEST = (608, 992, 121)
LTX13B_PASS_TOKENS = (3840, 15360)
LTX13B_SELF = [(1, 32, n, n, 128) for n in LTX13B_PASS_TOKENS]
LTX13B_CROSS = [(1, 32, n, 256, 128) for n in LTX13B_PASS_TOKENS]
K5_SHAPES = [("pass 1 qkv", 3840, 4096, 12288, 16),
             ("pass 1 proj_in", 3840, 4096, 16384, 16),
             ("pass 2 qkv", 15360, 4096, 12288, 16),
             ("pass 2 proj_in", 15360, 4096, 16384, 16)]
K5_TIMED = "pass 2 qkv"
LTX13B_BOUND = 40.0
# the 13B DiT's linears that K2 runs (tiers a and c: all of them; tier b:
# those the fused prologue does not take), one stream of each pass's
# tokens, 256 text tokens, 16 latent frames with a timestep each
for _p, _m in enumerate(LTX13B_PASS_TOKENS, 1):
    K2_SHAPES += [
        (f"13B pass {_p} qkvo 4096->4096", _m, 4096, 4096, "bf16"),
        (f"13B pass {_p} ffn_in 4096->16384", _m, 4096, 16384, "bf16"),
        (f"13B pass {_p} ffn_out 16384->4096", _m, 16384, 4096, "bf16"),
        (f"13B pass {_p} patchify 128->4096", _m, 128, 4096, "bf16"),
        (f"13B pass {_p} proj_out 4096->128", _m, 4096, 128, "bf16"),
    ]
K2_SHAPES += [
    ("13B caption, cross kv 4096->4096 M=256", 256, 4096, 4096, "bf16"),
    ("13B adaln emb 256->4096 M=16", 16, 256, 4096, "fp32"),
    ("13B adaln emb 4096->4096 M=16", 16, 4096, 4096, "fp32"),
    ("13B adaln 4096->24576 M=16", 16, 4096, 24576, "fp32"),
]
# (name, attention mode, fused prologue on, score bound)
LTX13B_TIERS = [("a: auto", "auto", False, None),
                ("b: pallas_hp + fused prologue", "pallas_hp", True, None),
                ("c: score bound", "auto", False, LTX13B_BOUND)]
LTX13B_SERVED = "b: pallas_hp + fused prologue"   # goes through the server


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


def phase_build(compare=False):
    """Build the kernel library, every source's nvcc started together;
    ``compare``: first once with one source after another, for its time."""
    from ltx_video_gpupoor_tpu_torch.ops import _lib

    if compare:
        log(f"[build] one source after another: "
            f"{_lib.build(force=True, parallel=False)[1]:.2f} s")
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
    for i in range(b):        # the fp32 plain version, one batch row and a
        sl = slice(i, i + 1)  # few heads at a time
        seg_i = [s_[sl] if s_ is not None else None for s_ in segs]
        ref = _by_heads(lambda a, b_, c: fa.reference_attention(
            a, b_, c, *seg_i, causal=causal, kv_valid=kv_valid),
            q[sl].float(), k[sl].float(), v[sl].float())
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
    import torch

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
    # the 13B path: tier (b) runs its cross-attention through K1
    for i, shape in enumerate(LTX13B_CROSS):
        e, out, _ = _k1_case(f"13B cross-attention pass {i + 1}", *shape,
                             packed=True, seg=_cross_segments, gen=gen)
        errs.append(e)
        assert float(out[0, :, 17].float().abs().max()) == 0.0, \
            "K1: a row with no valid key must be 0"
    for i, shape in enumerate(LTX13B_SELF):
        errs.append(_k1_case(f"13B self-attention pass {i + 1}", *shape,
                             packed=True, gen=gen)[0])
        torch.cuda.empty_cache()
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
    """Both tiers at the Wan and the 13B shapes and at the edges; returns
    the worst error per tier."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    errs = {True: [], False: []}
    for pv in (True, False):
        errs[pv].append(_k4_case("wan self-attention", *WAN_SELF, pv_int8=pv,
                                 gen=gen, packed=True, plant=True))
        errs[pv].append(_k4_case("wan cross-attention", *WAN_CROSS,
                                 pv_int8=pv, gen=gen, packed=True,
                                 seg=_cross_segments))
        # the 13B path: tier (a) runs both attentions through K4
        for i, shape in enumerate(LTX13B_SELF):
            errs[pv].append(_k4_case(f"13B self-attention pass {i + 1}",
                                     *shape, pv_int8=pv, gen=gen, packed=True,
                                     plant=i == 1))
        for i, shape in enumerate(LTX13B_CROSS):
            errs[pv].append(_k4_case(f"13B cross-attention pass {i + 1}",
                                     *shape, pv_int8=pv, gen=gen, packed=True,
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
# phases 5b-5d: K3, K6 (the exact kernel's other entries) and K5
# --------------------------------------------------------------------------

def _by_heads(fn, q, k, v, heads_per_call=4):
    """``fn(q, k, v)`` over ``[B, H, S, D]`` a few heads at a time: the
    plain versions hold whole score matrices (2**30 fp32 scores for 4
    heads at S=15360)."""
    import torch

    return torch.cat([fn(q[:, h0:h0 + heads_per_call],
                         k[:, h0:h0 + heads_per_call],
                         v[:, h0:h0 + heads_per_call])
                      for h0 in range(0, q.shape[1], heads_per_call)], dim=1)


def _exact_check(kern, plain):
    """The exact kernel's entries (K3, K6) against their plain versions on
    the same bf16 operands. The two differ by fp32 summation order,
    exp2f's approximation and the final bf16 rounding, so every element
    must lie within two bf16 ulps of the plain version (2**-7 relative)
    plus 2**-9 of its largest output (for outputs near 0, where the
    summands cancel). Returns (largest |difference| / bound, max abs
    error)."""
    diff = (kern.float() - plain.float()).abs()
    bound = plain.float().abs() * 2.0 ** -7 \
        + float(plain.float().abs().max()) * 2.0 ** -9
    return float((diff / bound).max()), float(diff.max())


def _exact_planted(name, kern, plain, head_axis):
    """Two planted faults must fail ``_exact_check``: the last 64-row q
    tile zeroed, and one head scaled by 1 + 2**-5 (four bf16 ulps)."""
    seq_axis = 2 if head_axis == 1 else 1
    n = kern.shape[seq_axis]
    zeroed = kern.clone()
    zeroed.narrow(seq_axis, (n - 1) // 64 * 64, n - (n - 1) // 64 * 64).zero_()
    scaled = kern.clone()
    if head_axis == 1:
        scaled[:, 1] = (scaled[:, 1].float() * (1 + 2.0 ** -5)).to(kern.dtype)
    else:       # packed [B, S, H*D]: head 1 is the second block of columns
        d = plain.shape[-1] // head_axis
        scaled[..., d:2 * d] = (scaled[..., d:2 * d].float()
                                * (1 + 2.0 ** -5)).to(kern.dtype)
    found = []
    for fault, out in (("last q tile zeroed", zeroed),
                       ("a head scaled by 1 + 2**-5", scaled)):
        ratio, _ = _exact_check(out, plain)
        assert ratio > 1.0, f"{name}: the check passes a planted fault ({fault})"
        found.append(f"{fault}: {ratio:.1f} of the bound")
    return "; planted faults fail it (" + "; ".join(found) + ")"


def _k3_case(name, b, h, sq, skv, d, *, gen, bound=LTX13B_BOUND, packed=False,
             seg=None, causal=False, kv_valid=None, plant=False):
    """K3 against its plain version; one q row is scaled so that its
    scores lie over the bound (they tie at it in both)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    q[0, 0, min(3, sq - 1)] *= 60
    segs = seg(b, sq, skv) if seg else (None, None)
    kw = dict(causal=causal, kv_valid=kv_valid, score_bound=bound)
    before = fa.flash_attention.launches
    kern = fa.flash_attention(q, k, v, *segs, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before, "K3 counted as K1"
    assert torch.isfinite(kern.float()).all(), f"K3 {name}: non-finite"
    plain = _by_heads(lambda a, b_, c: fa.bounded_attention_plain(
        a, b_, c, *segs, **kw), q, k, v)
    ratio, err = _exact_check(kern, plain)
    assert ratio <= 1.0, (f"K3 {name}: max_abs_err {err:.3e}, {ratio:.3f} of "
                          "the bound")
    planted = _exact_planted(f"K3 {name}", kern, plain, 1) if plant else ""
    if seg:
        assert float(kern[0, :, 17].float().abs().max()) == 0.0, \
            f"K3 {name}: a row with no valid key must be 0"
    log(f"[K3] {name}: B={b} H={h} Sq={sq} Skv={skv} D={d} bound={bound} "
        f"max_abs_err={err:.3e}, {ratio:.3f} of the bound{planted} ok")
    return err


def phase_k3(gen):
    import torch

    errs = []
    for i, shape in enumerate(LTX13B_SELF):
        errs.append(_k3_case(f"13B self-attention pass {i + 1}", *shape,
                             gen=gen, packed=True, plant=i == 1))
        torch.cuda.empty_cache()
    for i, shape in enumerate(LTX13B_CROSS):
        errs.append(_k3_case(f"13B cross-attention pass {i + 1}", *shape,
                             gen=gen, packed=True, seg=_cross_segments))
    errs.append(_k3_case("D=64 ragged S, kv_valid", 2, 4, 1000, 1000, 64,
                         gen=gen, kv_valid=777, bound=20.0))
    errs.append(_k3_case("D=64 text segments", 3, 4, 700, 300, 64, gen=gen,
                         seg=_cross_segments, bound=20.0))
    errs.append(_k3_case("ragged causal", 1, 2, 333, 333, 128, gen=gen,
                         causal=True, bound=20.0))
    torch.cuda.empty_cache()
    return max(errs)


def _k6_case(name, b, s, heads, d, *, gen, kv_valid=None, fused_qkv=False,
             plant=False):
    """K6 against its plain version on ``[B, S, H*D]`` operands (slices of
    one fused projection with ``fused_qkv``)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    if fused_qkv:
        qkv = torch.randn(b, s, 3 * heads * d, generator=gen, device=dev,
                          dtype=torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q, k, v = (torch.randn(b, s, heads * d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
    kern = fa.flash_attention_hp(q, k, v, heads=heads, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert kern.shape == q.shape and kern.is_contiguous()
    assert torch.isfinite(kern.float()).all(), f"K6 {name}: non-finite"

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    plain = _by_heads(lambda a, b_, c: fa.reference_attention(
        a, b_, c, kv_valid=kv_valid), split(q), split(k), split(v))
    plain = plain.transpose(1, 2).reshape(b, s, heads * d)
    ratio, err = _exact_check(kern, plain)
    assert ratio <= 1.0, (f"K6 {name}: max_abs_err {err:.3e}, {ratio:.3f} of "
                          "the bound")
    planted = _exact_planted(f"K6 {name}", kern, plain, heads) if plant else ""
    log(f"[K6] {name}: B={b} S={s} H={heads} D={d} kv_valid={kv_valid} "
        f"max_abs_err={err:.3e}, {ratio:.3f} of the bound{planted} ok")
    return err


def phase_k6(gen):
    import torch

    errs = []
    for i, (b, h, n, _, d) in enumerate(LTX13B_SELF):
        errs.append(_k6_case(f"13B self-attention pass {i + 1}", b, n, h, d,
                             gen=gen, fused_qkv=True, plant=i == 1))
        torch.cuda.empty_cache()
    errs.append(_k6_case("LTX-2B self-attention, D=64 pairs", 3, 5280, 32, 64,
                         gen=gen))
    errs.append(_k6_case("ragged S, kv_valid, D=64", 2, 1000, 4, 64, gen=gen,
                         kv_valid=777))
    errs.append(_k6_case("odd head count, D=64", 1, 333, 3, 64, gen=gen,
                         fused_qkv=True))
    torch.cuda.empty_cache()
    return max(errs)


# --------------------------------------------------------------------------
# phases 5e-5f: K8 (the pipelined attention tool) and K7 (ring attention)
# --------------------------------------------------------------------------

def phase_k8(gen, times, info):
    """K8 against its plain version, then the tool's own ``main``; fills
    ``times`` / ``info`` and returns (max abs error, launches of K8 in the
    tool's run)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb

    errs = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, block_kv in ((K8_SHAPE, 128), (K8_SMALL, 64)):
        b, h, s_, d = shape
        q, k, v = (_heads(b, h, s_, d, gen, False) for _ in range(3))
        for nsub in mb.NSUBS[block_kv]:
            kw = dict(block_kv=block_kv, nsub=nsub)
            kern = mb.pipelined_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert torch.isfinite(kern.float()).all(), f"K8 {kw}: non-finite"
            plain = mb.pipelined_attention_plain(q, k, v, **kw)
            ratio, err = _exact_check(kern, plain)
            assert ratio <= 1.0, (f"K8 {shape} {kw}: max_abs_err {err:.3e}, "
                                  f"{ratio:.3f} of the bound")
            # planted fault: the V rows of the first two sub-blocks (or, at
            # nsub = 1, of two halves of the first) change places
            half = block_kv // max(nsub, 2)
            vs = v.clone()
            vs[:, :, :half] = v[:, :, half:2 * half]
            vs[:, :, half:2 * half] = v[:, :, :half]
            fault, _ = _exact_check(mb.pipelined_attention(q, k, vs, **kw),
                                    plain)
            assert fault > 1.0, f"K8 {kw}: the check passes swapped V rows"
            errs.append(err)
            log(f"[K8] B={b} H={h} S={s_} D={d} block_kv={block_kv} "
                f"nsub={nsub}: max_abs_err={err:.3e}, {ratio:.3f} of the "
                f"bound; swapped V rows fail it ({fault:.1f} of the bound) ok")
            if shape == K8_SHAPE:
                pl = cuda_time_ms(lambda: mb.pipelined_attention_plain(
                    q, k, v, **kw), reps=3, warmup=1)
                times[f"K8 nsub {nsub}"] = (None, pl)
        if shape == K8_SHAPE:
            lib = cuda_time_ms(lambda: sdpa(q, k, v))
        del q, k, v
        torch.cuda.empty_cache()
    # the entry point itself: its check, K1 and K8 timed
    reset_kernel_counts()
    result = mb.main([])
    counts = kernel_counts()
    assert result["err"] < 2e-2, result
    assert counts["K8"] > 0 and counts["K1"] > 0, counts
    b, h, s_, d = K8_SHAPE
    bnd = attention_bound(b, h, s_, s_, d)
    flops = 4 * b * h * s_ * s_ * d
    for nsub, ms in result["pipelined_ms"].items():
        times[f"K8 nsub {nsub}"] = (ms, times[f"K8 nsub {nsub}"][1])
        info[f"K8 nsub {nsub}"] = (*bnd, lib)
        log(f"[time] K8 B={b} H={h} S={s_} D={d} nsub={nsub}: kernel "
            f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{times[f'K8 nsub {nsub}'][1]:.3f} ms, K1 (the production "
            f"kernel) {result['production_ms']:.3f} ms, bound {bnd[0]:.3f} "
            f"ms ({bnd[1]}), scaled_dot_product_attention {lib:.3f} ms")
    return max(errs), counts["K8"]


def _ring_mesh_rings():
    """The rings of RING_MESH's ``sp`` axis, each a list of global device
    ids in ring order, found by following right neighbours; every device's
    left and right must be each other's inverse."""
    import itertools

    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr

    names = [n for n, _ in RING_MESH]
    right, left = {}, {}
    for idx in itertools.product(*(range(n) for _, n in RING_MESH)):
        coords = dict(zip(names, idx))
        me = rr.logical_id(RING_MESH, "sp", coords["sp"], coords)
        left[me], right[me] = rr.ring_neighbours(RING_MESH, "sp", coords)
    assert all(left[right[d]] == d for d in right), (left, right)
    rings, seen = [], set()
    for start in sorted(right):
        if start in seen:
            continue
        ring, d = [], start
        while d not in seen:
            seen.add(d)
            ring.append(d)
            d = right[d]
        rings.append(ring)
    return rings


def phase_k7(gen, times, info):
    """K7 against the plain ring and against K1 on the joined tensors;
    fills ``times`` / ``info`` and returns (max abs error, launches of the
    main path's call)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr

    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the CUDA-core body at the JAX tests' shapes, both types, p = 8 (and a
    # one-rank ring, which has no workspace and touches no counter)
    for shape in RING_SMALL:
        for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
                       for _ in range(3))
            for p in (8, 1):
                shards = [t.chunk(p, dim=2) for t in (q, k, v)]
                plain = torch.cat(rr.ring_attention_plain(*shards), dim=2)
                for call in range(2):      # the second sees the first's flags
                    out = rr.ring_attention_rdma_sharded(q, k, v, p)
                    torch.cuda.synchronize()
                    err = float((out.float() - plain.float()).abs().max())
                    assert err <= atol, (shape, dtype, p, call, err)
                exact = float((out.float() - fa.reference_attention(
                    q, k, v).float()).abs().max())
                assert exact <= atol, (shape, dtype, p, exact)
                log(f"[K7] CUDA-core body {tuple(shape)} {str(dtype)[6:]} "
                    f"p={p}: max_abs_err={err:.3e} against the plain ring, "
                    f"{exact:.3e} against exact attention (atol {atol}), "
                    "two calls ok")
    assert rr.ring_attention_rdma.launches_simple > 0
    assert not any(key[0] == 1 for key in rr._workspaces), \
        "a one-rank ring must not allocate a workspace"

    # a dp2 x sp2 x tp2 mesh: dp cuts the batch, tp the heads, sp the ring
    rings = _ring_mesh_rings()
    assert sorted(map(tuple, rings)) == [(0, 2), (1, 3), (4, 6), (5, 7)], rings
    q, k, v = (torch.randn(2, 2, 64, 32, generator=gen, device="cuda")
               for _ in range(3))
    ref = fa.reference_attention(q, k, v)
    for ring in rings:
        dp, tp = ring[0] // 4, ring[0] % 2      # row-major (dp, sp, tp)
        # device id -> its shard: batch row dp, head tp, sequence half sp
        pick = [[t[dp:dp + 1, tp:tp + 1].chunk(2, dim=2)[(dev // 2) % 2]
                 for dev in ring] for t in (q, k, v)]
        out = torch.cat(rr.ring_attention_rdma(*pick), dim=2)
        err = float((out - ref[dp:dp + 1, tp:tp + 1]).abs().max())
        assert err <= 2e-5, (ring, err)
    log(f"[K7] dp2 x sp2 x tp2 mesh: sp rings {rings} from the neighbour "
        "ids, each against exact attention on its batch row and head, "
        "atol 2e-5 ok")

    # the tensor-core body at the Wan-1.3B self-attention width
    b, h, s_, d = RING_SHAPE
    q, k, v = (_heads(b, h, s_, d, gen, True) for _ in range(3))
    k1 = fa.flash_attention(q, k, v)
    bnd = attention_bound(b, h, s_, s_, d)
    flops = fa.attention_flops(b, h, s_, s_, d)
    k1_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    lib = cuda_time_ms(lambda: sdpa(q, k, v))
    errs = []
    before = rr.ring_attention_rdma.launches_tc
    for p in (1,) + RING_RANKS:
        shards = [t.chunk(p, dim=2) for t in (q, k, v)]
        plain = torch.cat(rr.ring_attention_plain(*shards), dim=2)
        for call in range(2):
            out = rr.ring_attention_rdma_sharded(q, k, v, p)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), f"K7 p={p}: non-finite"
            ratio, err = _exact_check(out, plain)
            assert ratio <= 1.0, (f"K7 p={p} call {call}: max_abs_err "
                                  f"{err:.3e}, {ratio:.3f} of the bound")
        # K1 and K7 each lie within the bound of the fp32 ring: two apart
        ratio_k1, err_k1 = _exact_check(out, k1)
        assert ratio_k1 <= 2.0, (p, ratio_k1, err_k1)
        planted = ""
        if p == RING_TIMED_P:
            bad = torch.cat(rr.ring_attention_rdma(*shards, _fault=(1, 1)),
                            dim=2)
            fault, _ = _exact_check(bad, plain)
            assert fault > 1.0, "K7: the check passes a skipped ring step"
            again, _ = _exact_check(
                rr.ring_attention_rdma_sharded(q, k, v, p), plain)
            assert again <= 1.0, again
            planted = (f"; rank 1 skipping step 1 fails it ({fault:.1f} of "
                       f"the bound), the next call passes ({again:.3f})")
        errs.append(err)
        ms = cuda_time_ms(lambda: rr.ring_attention_rdma_sharded(q, k, v, p))
        pl = cuda_time_ms(lambda: rr.ring_attention_plain(*shards), reps=3,
                          warmup=1)
        times[f"K7 p={p}"] = (ms, pl)
        info[f"K7 p={p}"] = (*bnd, lib)
        log(f"[K7] tensor-core body B={b} H={h} S={s_} D={d} p={p}: "
            f"max_abs_err={err:.3e}, {ratio:.3f} of the bound against the "
            f"plain ring, {ratio_k1:.3f} against one K1 call on the joined "
            f"tensors, two calls on one workspace{planted} ok")
        log(f"[time] K7 ring attention p={p}: kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain ring {pl:.3f} ms, one "
            f"K1 call on the joined tensors {k1_ms:.3f} ms, bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}), scaled_dot_product_attention "
            f"{lib:.3f} ms")
        del plain, shards
        torch.cuda.empty_cache()
    assert rr.ring_attention_rdma.launches_tc > before
    # the main path's own run: the sharded entry point, counts from zero
    reset_kernel_counts()
    out = rr.ring_attention_rdma_sharded(q, k, v, RING_TIMED_P)
    torch.cuda.synchronize()
    launches = kernel_counts()["K7"]
    assert launches == rr.ring_attention_rdma.launches_tc == 1, launches
    del q, k, v, k1, out
    rr.release_workspaces()      # slots and state of every ring run here
    torch.cuda.empty_cache()
    return max(errs), launches


def _k5_operands(m, k, n, groups, gen, bias=True):
    """x with rows of varied size (one of them 0), adaLN rows, int8 weights
    as q, k, v side by side."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_weights

    dev = torch.device("cuda")
    x = torch.randn(m, k, generator=gen, device=dev)
    x = (x * torch.rand(m, 1, generator=gen, device=dev) * 4).bfloat16()
    x[1] = 0
    scale = (torch.randn(groups, k, generator=gen, device=dev) * 0.3).bfloat16()
    shift = (torch.randn(groups, k, generator=gen, device=dev) * 0.3).bfloat16()
    ql = quantize_weights(torch.randn(n, k, generator=gen, device=dev)
                          * k ** -0.5)
    b = torch.randn(n, generator=gen, device=dev) * 0.1 if bias else None
    return x, scale, shift, ql.w_int8, ql.scale, b


def _k5_agrees(x, scale, shift, w8, sw, bias, rows, eps, plain_mod=None):
    """Whether K5 on ``(x, scale, shift)`` equals the plain version (on
    ``plain_mod`` = other (scale, shift) to plant a fault): int8 codes, row
    scales and the int32 product exactly, outputs to 1e-2 relative.
    Returns (ok, max abs error, what failed)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    p_scale, p_shift = plain_mod or (scale, shift)
    kw = dict(rows_per_group=rows, eps=eps)
    hq, sx, acc = fp.norm_mod_int8_acc(x, scale, shift, w8, **kw)
    out = fp.norm_mod_int8_matmul(x, scale, shift, w8, sw, bias, **kw)
    torch.cuda.synchronize()
    pq, ps = fp.norm_mod_quantize_plain(x, p_scale, p_shift, **kw)
    failed = []
    if not torch.equal(hq, pq):
        failed.append(f"int8 codes differ in {float((hq != pq).float().mean()):.2e}"
                      " of the elements")
    if not torch.equal(sx, ps[:, 0]):
        failed.append("row scales differ")
    if not torch.equal(acc, im.int8_gemm_acc_plain(pq, w8)):
        failed.append("int32 products differ")
    ref = fp.norm_mod_int8_matmul_plain(x, p_scale, p_shift, w8, sw, bias, **kw)
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-6):
        failed.append(f"outputs differ (max {err:.3e})")
    assert out.dtype == x.dtype and out.shape == (x.shape[0], w8.shape[0])
    return not failed, err, "; ".join(failed)


def phase_k5(gen):
    import torch

    worst = 0.0
    cases = [(name, m, k, n, g, True) for name, m, k, n, g in K5_SHAPES]
    cases.append(("ragged M=240, N=200, 3 groups, no bias", 240, 4096, 200, 3,
                  False))
    for name, m, k, n, g, bias in cases:
        x, scale, shift, w8, sw, b = _k5_operands(m, k, n, g, gen, bias)
        ok, err, why = _k5_agrees(x, scale, shift, w8, sw, b, m // g, 1e-6)
        assert ok, f"K5 {name}: {why}"
        planted = ""
        if name == K5_TIMED:
            swapped = (scale.roll(1, 0), shift.roll(1, 0))
            bad, _, why = _k5_agrees(x, scale, shift, w8, sw, b, m // g, 1e-6,
                                     plain_mod=swapped)
            assert not bad, "K5: the check passes a planted fault"
            planted = f"; a planted fault (groups' rows swapped) fails it ({why})"
        worst = max(worst, err)
        log(f"[K5] {name}: M={m} K={k} N={n} groups={g} rows/group={m // g} "
            f"int8 codes, row scales and int32 product exact, "
            f"max_abs_err={err:.3e}{planted} ok")
        del x, scale, shift, w8, sw, b
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------
# the bounds: the least time the card could take
# --------------------------------------------------------------------------

def bound_ms(ops_by_type: dict, nbytes: float) -> tuple[float, str]:
    """(milliseconds, "operations" or "bytes"): the larger of the
    operations over the card's peak rate for their type and the bytes
    (each input read once, each output written once) over its memory
    rate."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops_by_type.items())
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, sq, skv, d, *, qk="bf16", pv="bf16", q_bytes=2,
                    kv_bytes=2, v_bytes=2, extra_bytes=0):
    """Unmasked attention: two products of 2*B*H*Sq*Skv*D operations; q
    and the bf16 output once, k and v once."""
    half = 2 * b * h * sq * skv * d
    ops = {}
    for kind in (qk, pv):
        ops[kind] = ops.get(kind, 0) + half
    nbytes = b * h * d * (sq * (q_bytes + 2) + skv * (kv_bytes + v_bytes)) \
        + extra_bytes
    return bound_ms(ops, nbytes)


def linear_bound(m, k, n, *, x_bytes=2, out_bytes=2, extra_bytes=0):
    """A dynamic-int8 linear: 2*M*K*N int8 operations; x, the int8
    weights, scales and bias, and the output once."""
    nbytes = m * k * x_bytes + n * k + 8 * n + m * n * out_bytes + extra_bytes
    return bound_ms({"int8": 2 * m * k * n}, nbytes)


# --------------------------------------------------------------------------
# phase 6: timing
# --------------------------------------------------------------------------

def phase_timing(gen):
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    times = {}
    info = {}     # name -> (bound ms, what bounds it, library call ms or None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, s, d = 3, 32, 5280, 64
    q, k, v = (_heads(b, h, s, d, gen, True) for _ in range(3))

    def plain_self():
        for i in range(b):
            fa.reference_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])

    kern = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(plain_self, reps=3, warmup=1)
    flops = fa.attention_flops(b, h, s, s, d)
    times["K1 self"] = (kern, plain)
    lib = cuda_time_ms(lambda: sdpa(q, k, v))
    info["K1 self"] = (*attention_bound(b, h, s, s, d), lib)
    log(f"[time] K1 self-attention B=3 H=32 S=5280 D=64: kernel {kern:.3f} ms "
        f"({flops / kern / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms, bound "
        f"{info['K1 self'][0]:.3f} ms ({info['K1 self'][1]}), "
        f"scaled_dot_product_attention {lib:.3f} ms")
    kc, vc = (_heads(b, h, 256, d, gen, False) for _ in range(2))
    q_seg, kv_seg = _cross_segments(b, s, 256)
    kern_c = cuda_time_ms(lambda: fa.flash_attention(q, kc, vc, q_seg, kv_seg))
    plain_c = cuda_time_ms(lambda: fa.reference_attention(
        q, kc, vc, q_seg, kv_seg), reps=3, warmup=1)
    times["K1 cross"] = (kern_c, plain_c)
    log(f"[time] K1 cross-attention Sq=5280 Skv=256: kernel {kern_c:.3f} ms, "
        f"plain {plain_c:.3f} ms")
    del q, k, v, kc, vc

    # K4 at the Wan and the 13B shapes: the kernel body and the plain version on the
    # same prologue operands, and the shared prologue on its own
    k4_shapes = [("self", WAN_SELF, None), ("cross", WAN_CROSS,
                                            _cross_segments)]
    for i in range(len(LTX13B_PASS_TOKENS)):
        k4_shapes += [(f"13B pass {i + 1} self", LTX13B_SELF[i], None),
                      (f"13B pass {i + 1} cross", LTX13B_CROSS[i],
                       _cross_segments)]
    for name, (b, h, sq, skv, d), seg in k4_shapes:
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
            # the kernel body's operands: int8 q and k, int8 or bf16 v,
            # fp32 row, block and channel scales
            scales = 4 * (ops.q_scale.numel() + ops.k_scale.numel()
                          + (ops.v_scale.numel() if pv else 0))
            bnd = attention_bound(
                b, h, sq, skv, d, qk="int8", pv="int8" if pv else "bf16",
                q_bytes=1, kv_bytes=1, v_bytes=1 if pv else 2,
                extra_bytes=scales)
            info[f"K4 {tier} {name}"] = (*bnd, None)
            log(f"[time] K4 {tier} {name}-attention B={b} H={h} Sq={sq} "
                f"Skv={skv} D={d}: kernel {kern:.3f} ms "
                f"({flops / kern / 1e9:.1f} TOP/s), plain {plain:.3f} ms, "
                f"prologue {pro:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]})")
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
        xb = 2 if dtype == "bf16" else 4
        bnd = linear_bound(m, kk, n, x_bytes=xb, out_bytes=xb)
        lib = None
        if m >= 1024 and n >= 1024:
            # the GEMM alone: int8 [M, K] @ [K, N] -> int32
            xq = im.quantize_rows_plain(x)[0]
            lib = cuda_time_ms(lambda: torch._int_mm(xq, w8.t()))
            del xq
        info[f"K2 {name}"] = (*bnd, lib)
        log(f"[time] K2 {name} M={m}: kernel {kern:.3f} ms "
            f"({2 * m * kk * n / kern / 1e9:.1f} TOP/s), plain {plain:.3f} ms, "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}), torch._int_mm (GEMM alone) "
            + (f"{lib:.3f} ms" if lib is not None else "none"))
        del x, w8, sw, bias
    torch.cuda.empty_cache()

    # K3 and K6 at the 13B self-attention shapes (K3 also at the cross
    # shape), K6 at the LTX-2B shape; the library call is SDPA on the
    # head-split views (exact attention: K6's function, not K3's clamp)
    for i, (b, h, n, _, d) in enumerate(LTX13B_SELF):
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        qp, kp, vp = qkv.chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (qp, kp, vp))
        reps = dict(reps=3, warmup=1)
        k3 = cuda_time_ms(lambda: fa.flash_attention(
            q, k, v, score_bound=LTX13B_BOUND))
        k3_plain = cuda_time_ms(lambda: _by_heads(
            lambda a, b_, c: fa.bounded_attention_plain(
                a, b_, c, score_bound=LTX13B_BOUND), q, k, v), **reps)
        k6 = cuda_time_ms(lambda: fa.flash_attention_hp(qp, kp, vp, heads=h))
        k6_plain = cuda_time_ms(lambda: _by_heads(fa.reference_attention,
                                                  q, k, v), **reps)
        k1 = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
        lib = cuda_time_ms(lambda: sdpa(q, k, v))
        bnd = attention_bound(b, h, n, n, d)
        times[f"K3 self pass {i + 1}"] = (k3, k3_plain)
        times[f"K6 self pass {i + 1}"] = (k6, k6_plain)
        # K1 on the same views computes K6's function: one plain version
        times[f"K1 self pass {i + 1}"] = (k1, k6_plain)
        info[f"K1 self pass {i + 1}"] = (*bnd, lib)
        info[f"K3 self pass {i + 1}"] = (*bnd, None)
        info[f"K6 self pass {i + 1}"] = (*bnd, lib)
        flops = fa.attention_flops(b, h, n, n, d)
        log(f"[time] 13B self-attention pass {i + 1} B={b} H={h} S={n} D={d}: "
            f"K3 {k3:.3f} ms ({flops / k3 / 1e9:.1f} TFLOP/s, plain "
            f"{k3_plain:.3f} ms), K6 {k6:.3f} ms ({flops / k6 / 1e9:.1f} "
            f"TFLOP/s, plain {k6_plain:.3f} ms), K1 on the head-split views "
            f"{k1:.3f} ms (K6's plain version), bound {bnd[0]:.3f} ms ({bnd[1]}), "
            f"scaled_dot_product_attention {lib:.3f} ms")
        kc, vc = (_heads(b, h, 256, d, gen, True) for _ in range(2))
        q_seg, kv_seg = _cross_segments(b, n, 256)
        k3c = cuda_time_ms(lambda: fa.flash_attention(
            q, kc, vc, q_seg, kv_seg, score_bound=LTX13B_BOUND))
        k1c = cuda_time_ms(lambda: fa.flash_attention(q, kc, vc, q_seg,
                                                      kv_seg))
        k3c_plain = cuda_time_ms(lambda: fa.bounded_attention_plain(
            q, kc, vc, q_seg, kv_seg, score_bound=LTX13B_BOUND), **reps)
        k1c_plain = cuda_time_ms(lambda: fa.reference_attention(
            q, kc, vc, q_seg, kv_seg), **reps)
        times[f"K3 cross pass {i + 1}"] = (k3c, k3c_plain)
        times[f"K1 cross pass {i + 1}"] = (k1c, k1c_plain)
        # the data's work: 200 of the 256 text tokens are valid
        bnd_c = attention_bound(b, h, n, 200, d)
        info[f"K3 cross pass {i + 1}"] = (*bnd_c, None)
        info[f"K1 cross pass {i + 1}"] = (*bnd_c, None)
        log(f"[time] 13B cross-attention pass {i + 1} Sq={n} Skv=256: K3 "
            f"{k3c:.3f} ms (plain {k3c_plain:.3f} ms), K1 {k1c:.3f} ms (plain "
            f"{k1c_plain:.3f} ms), bound {bnd_c[0]:.3f} ms ({bnd_c[1]})")
        del qkv, qp, kp, vp, q, k, v, kc, vc
        torch.cuda.empty_cache()
    b, n, h, d = 3, 5280, 32, 64
    qp, kp, vp = (torch.randn(b, n, h * d, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    k6 = cuda_time_ms(lambda: fa.flash_attention_hp(qp, kp, vp, heads=h))

    def k6_plain():          # one batch row at a time, as K1's plain version
        for i in range(b):
            fa.flash_attention_hp_plain(qp[i:i + 1], kp[i:i + 1],
                                        vp[i:i + 1], heads=h)

    k6_plain_ms = cuda_time_ms(k6_plain, reps=3, warmup=1)
    times["K6 LTX-2B"] = (k6, k6_plain_ms)
    log(f"[time] K6 at the LTX-2B shape B=3 S=5280 H=32 D=64: {k6:.3f} ms, "
        f"plain {k6_plain_ms:.3f} ms "
        f"(K1 on the head-split views: {times['K1 self'][0]:.3f} ms)")
    del qp, kp, vp

    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops.norms import rms_norm

    for name, m, kk, n, g in K5_SHAPES:
        x, scale, shift, w8, sw, bias = _k5_operands(m, kk, n, g, gen)
        kw = dict(rows_per_group=m // g, eps=1e-6)
        kern = cuda_time_ms(lambda: fp.norm_mod_int8_matmul(
            x, scale, shift, w8, sw, bias, **kw))
        rows = cuda_time_ms(lambda: fp.norm_mod_quantize_rows(
            x, scale, shift, **kw))
        plain = cuda_time_ms(lambda: fp.norm_mod_int8_matmul_plain(
            x, scale, shift, w8, sw, bias, **kw), reps=3, warmup=1)

        def unfused():      # what the tier replaces: norm, modulate, K2
            hh = rms_norm(x, eps=1e-6).reshape(g, m // g, kk)
            hh = (hh * (1 + scale[:, None]) + shift[:, None]).reshape(m, kk)
            return im.int8_linear(hh, w8, sw, bias)

        chain = cuda_time_ms(unfused)
        bnd = linear_bound(m, kk, n, extra_bytes=2 * g * kk * 2)
        times[f"K5 {name}"] = (kern, plain)
        info[f"K5 {name}"] = (*bnd, None)
        log(f"[time] K5 {name} M={m} K={kk} N={n} groups={g}: kernel "
            f"{kern:.3f} ms ({2 * m * kk * n / kern / 1e9:.1f} TOP/s; its row "
            f"kernel alone {rows:.3f} ms), plain {plain:.3f} ms, the unfused "
            f"chain (PyTorch norm and modulation, then K2) {chain:.3f} ms, "
            f"bound {bnd[0]:.3f} ms ({bnd[1]})")
        del x, scale, shift, w8, sw, bias
    torch.cuda.empty_cache()
    return times, info


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
    reset_kernel_counts()
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
# phase 7b: the LTX-13B image-to-video path
# --------------------------------------------------------------------------

def ltx13b_config():
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf

    return tf.LTXTransformerConfig(
        num_attention_heads=32, attention_head_dim=128, in_channels=128,
        out_channels=128, num_layers=48, cross_attention_dim=4096,
        caption_channels=4096)


def build_ltx13b_models(cfg, vcfg):
    """The 13B DiT built and quantized one block at a time (the dense bf16
    copy of 48 blocks never stands whole), the VAE with its encoder and
    the latent upsampler, random weights from seeds; also the dense bf16
    weights of the first two blocks and of everything outside the blocks,
    on the CPU."""
    import dataclasses

    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    dit = tf.init_params(tf.LTXTransformer3D(
        dataclasses.replace(cfg, num_layers=0), DEFAULT_POLICY, device=dev), g)
    dit.cfg = cfg
    dense_cut = {k: v.cpu() for k, v in dit.state_dict().items()}
    quantize_params(dit)
    kw = dict(device=dev, dtype=DEFAULT_POLICY.param_dtype)
    for i in range(cfg.num_layers):
        blk = tf.init_params(tf.Block(cfg, **kw), g)
        if i < 2:
            dense_cut.update({f"blocks.{i}.{k}": v.cpu()
                              for k, v in blk.state_dict().items()})
        dit.blocks.append(quantize_params(blk))
    vae = vaem.init_params(vaem.CausalVAE(vcfg, DEFAULT_POLICY, device=dev),
                           torch.Generator(device=dev).manual_seed(SEED + 21))
    up = lup.init_params(
        lup.LatentUpsampler(lup.LatentUpsamplerConfig(
            in_channels=128, mid_channels=512, num_blocks_per_stage=4,
            dims=3), DEFAULT_POLICY, device=dev),
        torch.Generator(device=dev).manual_seed(SEED + 22))
    torch.cuda.synchronize()
    n_dit = sum(t.numel() for t in dit.state_dict().values())
    n_up = sum(t.numel() for t in up.state_dict().values())
    log(f"[ltx13b] built DiT ({cfg.num_layers} layers, "
        f"{cfg.num_attention_heads}x{cfg.attention_head_dim} heads, "
        f"{n_dit / 1e9:.3f}e9 values, int8_dynamic, layer by layer), VAE "
        f"with encoder (timestep-conditioned decoder), upsampler "
        f"({n_up / 1e6:.1f}e6 values) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dit, dense_cut, vae, up


def set_score_bound(dit, bound):
    """Switch the DiT (and its blocks, which hold the config too) to
    ``attention_score_bound=bound`` (None = the exact softmax)."""
    import dataclasses

    cfg = dataclasses.replace(dit.cfg, attention_score_bound=bound)
    dit.cfg = cfg
    for blk in dit.blocks:
        blk.cfg = cfg


def set_fused_prologue(on: bool):
    if on:
        os.environ["LTXV_TPU_FUSED_PROLOGUE"] = "1"
    else:
        os.environ.pop("LTXV_TPU_FUSED_PROLOGUE", None)


def kernel_counts():
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr
    from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb

    return {"K1": fa.flash_attention.launches,
            "K2": im.int8_linear.launches,
            "K3": fa.flash_attention.bounded_launches,
            "K4": fa.flash_attention_int8.launches,
            "K5": fp.norm_mod_int8_matmul.launches,
            "K6": fa.flash_attention_hp.launches,
            "K7": rr.ring_attention_rdma.launches,
            "K8": mb.pipelined_attention.launches}


def reset_kernel_counts():
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    fa.flash_attention.launches = 0
    fa.flash_attention.bounded_launches = 0
    fa.flash_attention_int8.launches = 0
    fa.flash_attention_hp.launches = 0
    im.int8_linear.launches = 0
    fp.norm_mod_int8_matmul.launches = 0
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr
    from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb

    rr.ring_attention_rdma.launches = 0
    rr.ring_attention_rdma.launches_tc = 0
    rr.ring_attention_rdma.launches_simple = 0
    mb.pipelined_attention.launches = 0


# the kernels each tier must launch, and those it must not
LTX13B_EXPECT = {"a: auto": (("K4", "K2"),
                             ("K1", "K3", "K5", "K6", "K7", "K8")),
                 "b: pallas_hp + fused prologue": (("K6", "K5", "K1", "K2"),
                                                   ("K3", "K4", "K7", "K8")),
                 "c: score bound": (("K3", "K2"),
                                    ("K1", "K4", "K5", "K6", "K7", "K8"))}


def ltx13b_reference_check(cfg, dense_cut):
    """A 2-layer cut of the 13B DiT (the main model's own first two
    blocks) on the card with the kernels against the same cut on the CPU
    with the plain versions, both int8_dynamic in bf16, in each of the
    three tiers: one stream, 2 latent frames of 4x4 tokens with their own
    timesteps (16 rows a group, so the fused prologue engages), text
    padding. Bar: 30 dB PSNR on the velocity, as for the other paths."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    cut = dataclasses.replace(cfg, num_layers=2)
    models = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        m = tf.LTXTransformer3D(cut, DEFAULT_POLICY, device=d)
        m.load_state_dict(dense_cut)
        models.append(quantize_params(m))
    g = torch.Generator().manual_seed(SEED + 23)
    f, h, w = 2, 4, 4
    lat = torch.randn(1, f * h * w, cfg.in_channels, generator=g)
    grid = torch.stack(torch.meshgrid(torch.arange(f), torch.arange(h),
                                      torch.arange(w), indexing="ij"))
    grid = (grid.reshape(1, 3, -1).float()
            * torch.tensor([8 / 30, 32.0, 32.0])[None, :, None])
    t = torch.tensor([[0.0, 0.9]])        # a conditioned first frame
    cap = torch.randn(1, 256, cfg.caption_channels, generator=g)
    mask = torch.ones(1, 256, dtype=torch.int32)
    mask[:, 77:] = 0
    dbs = []
    for name, mode, fused, bound in LTX13B_TIERS:
        set_fused_prologue(fused)
        for m in models:
            set_score_bound(m, bound)
        with torch.no_grad():
            reset_kernel_counts()
            out = models[0](*(x.cuda() for x in (lat, grid, t, cap, mask)),
                            attn_mode=mode)
            torch.cuda.synchronize()
            counts = kernel_counts()
            ref = models[1](lat, grid, t, cap, mask, attn_mode=mode)
        must, must_not = LTX13B_EXPECT[name]
        assert all(counts[k] > 0 for k in must) and \
            not any(counts[k] for k in must_not), (name, counts)
        o = out.float().cpu().numpy()
        r = ref.float().numpy()
        assert np.isfinite(o).all() and o.shape == r.shape
        peak = max(np.abs(r).max(), np.abs(o).max()) * 2
        mse = float(np.mean((o - r) ** 2))
        db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
        log(f"[ltx13b] reference check, tier ({name}), 2-layer cut at full "
            f"width, kernels on the card vs plain versions on the CPU: PSNR "
            f"{db:.2f} dB (bar 30), launches {counts}")
        assert db >= 30.0, f"13B reference check ({name}) {db:.2f} dB < 30"
        dbs.append(db)
    set_fused_prologue(False)
    return dbs


def synthetic_image(height, width):
    """A seeded uint8 image at the request's size: smooth colour
    gradients with noise on top."""
    import numpy as np

    rng = np.random.default_rng(SEED + 24)
    yy, xx = np.mgrid[0:height, 0:width]
    img = np.stack([128 + 90 * np.sin(xx / 53.0 + yy / 91.0),
                    128 + 90 * np.cos(yy / 37.0),
                    (xx + yy) * 255.0 / (height + width)], axis=-1)
    img = img + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def run_ltx13b_request(gen, t5, name, mode, fused, bound, *, check=True,
                       serve=None):
    """One image-to-video request in one tier: T5 encode, then
    ``generate`` with ``image_start``, or, with ``serve``, whatever
    ``serve(on_stage)`` does to get the frames (the HTTP server's route,
    which picks the tier and the text conditioning itself); returns the
    launch counts of pass 1 (media encode included) and of pass 2."""
    import torch

    height, width, frames = LTX13B_REQUEST
    dit = gen.pipeline.transformer
    if serve is None:
        set_fused_prologue(fused)
    set_score_bound(dit, bound)
    marks, checks, pass1 = {}, {}, {}

    def on_stage(stage, value):
        torch.cuda.synchronize()
        marks[stage] = time.perf_counter()
        if stage == "pass2":
            pass1.update(kernel_counts())
            checks["pass2_shape"] = tuple(value.shape)
        if stage == "upsample":
            checks["pass1_shape"] = tuple(value.shape)
        if stage == "decode":
            checks["latents_finite"] = bool(torch.isfinite(value).all())
            checks["latent_shape"] = tuple(value.shape)
        if stage == "postprocess":
            checks["pixels_finite"] = bool(torch.isfinite(value.float()).all())
            checks["pixel_shape"] = tuple(value.shape)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    if serve is None:
        emb, mask, t5_sec = encode_prompts(t5)
        frames_u8 = gen.generate(
            emb, mask, height=height, width=width, frame_num=frames,
            frame_rate=30.0, seed=SEED,
            image_start=synthetic_image(height, width),
            attn_mode=mode, on_stage=on_stage)
    else:
        t5_sec = 0.0
        frames_u8 = serve(on_stage)
    t_end = time.perf_counter()
    total = kernel_counts()
    pass2 = {k: total[k] - pass1[k] for k in total}
    peak = torch.cuda.max_memory_allocated() / 2**30
    set_fused_prologue(False)
    set_score_bound(dit, None)
    log(f"[ltx13b] request ({name}) {width}x{height}x{frames} i2v: pass 1 "
        f"{checks['pass1_shape'][1:4]} latents, pass 2 "
        f"{checks['pass2_shape'][1:4]}; t5={t5_sec:.3f} s "
        f"pass1={marks['upsample'] - marks['pass1']:.3f} s "
        f"upsample+adain={marks['pass2'] - marks['upsample']:.3f} s "
        f"pass2={marks['decode'] - marks['pass2']:.3f} s "
        f"decode={marks['postprocess'] - marks['decode']:.3f} s "
        f"(pixels {checks['pixel_shape'][1:4]}) "
        f"resize+postprocess={t_end - marks['postprocess']:.3f} s "
        f"total={t_end - t0:.3f} s peak={peak:.2f} GiB "
        f"frames={frames_u8.dtype.name}{list(frames_u8.shape)} "
        f"latents_finite={checks['latents_finite']} "
        f"pixels_finite={checks['pixels_finite']} launches pass 1 {pass1} "
        f"pass 2 {pass2}")
    if check:
        assert frames_u8.dtype.name == "uint8" and \
            frames_u8.shape == (frames, height, width, 3), frames_u8.shape
        assert checks["pass1_shape"][1:4] == (16, 12, 20), checks
        assert checks["latent_shape"][1:4] == (16, 24, 40), checks
        assert checks["latents_finite"] and checks["pixels_finite"]
        assert frames_u8.std() > 0, "constant frames"
        must, must_not = LTX13B_EXPECT[name]
        for counts in (pass1, pass2):
            assert all(counts[k] > 0 for k in must), (name, counts)
            assert not any(counts[k] for k in must_not), (name, counts)
    return pass1, pass2


def phase_ltx13b(t5):
    """Build the 13B models, check a cut in each tier, serve one request
    per tier (tier (b) through the HTTP server, ``phase_server``); returns
    the launch counts per tier (both passes summed) and the generator."""
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import LTXPipeline
    from ltx_video_gpupoor_tpu_torch.pipelines.multiscale import (
        MultiScalePipeline,
    )
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )

    cfg = ltx13b_config()
    dit, dense_cut, vae, up = build_ltx13b_models(cfg, vae_config())
    ltx13b_reference_check(cfg, dense_cut)
    del dense_cut
    pipe = LTXPipeline(dit, vae)
    gen = LTXVideoGenerator(pipe, multiscale=MultiScalePipeline(pipe, up),
                            pipeline_config="ltxv-13b-0.9.7-distilled")
    launches = {}
    for name, mode, fused, bound in LTX13B_TIERS:
        if name == LTX13B_SERVED:
            p1, p2 = phase_server(gen, t5, name, mode, fused, bound)
        else:
            p1, p2 = run_ltx13b_request(gen, t5, name, mode, fused, bound)
        launches[name] = {k: p1[k] + p2[k] for k in p1}
        torch.cuda.empty_cache()
    return launches, gen


# --------------------------------------------------------------------------
# phase 7c: the HTTP server and the CLI
# --------------------------------------------------------------------------

def _http(url, body=None):
    """(status, bytes) of a GET, or of a POST of ``body`` as JSON."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_server(gen, t5, name, mode, fused, bound):
    """The tier-(b) 13B request through ``InferenceService`` and the
    stdlib HTTP server over a real socket, then the error answers and
    ``/metrics``; returns the launch counts of the request's two passes."""
    import base64
    import io
    import threading

    import numpy as np
    from PIL import Image

    from ltx_video_gpupoor_tpu_torch.ops.attention import set_attention_mode
    from ltx_video_gpupoor_tpu_torch.serving import model_zoo, server
    from ltx_video_gpupoor_tpu_torch.utils import media
    from ltx_video_gpupoor_tpu_torch.utils.observability import Metrics

    height, width, frames = LTX13B_REQUEST
    out_dir = os.path.join(ROOT, "outputs")
    # the tier as a server process picks it: process-wide, before start-up
    set_attention_mode(mode)
    set_fused_prologue(fused)
    Metrics.reset()
    reset_kernel_counts()
    t0 = time.perf_counter()
    service = server.InferenceService(
        model=model_zoo.LoadedModel(generator=gen), outputs_dir=out_dir,
        warmup_spec=SERVER_WARMUP)
    service._warmup_thread.join()
    warm = time.perf_counter() - t0
    # a warm-up logs a failed bucket and carries on: the bucket must have
    # run to its end, through the tier's kernels
    warm_counts = kernel_counts()
    counters = Metrics.snapshot()["counters"]
    assert counters.get("warmup_ok") == 1 and not counters.get(
        "warmup_failed"), f"the warm-up bucket did not complete: {counters}"
    assert all(warm_counts[k] > 0 for k in ("K5", "K6", "K2")), warm_counts
    httpd = server.create_stdlib_server(service, host="127.0.0.1", port=0)
    root = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    log(f"[server] InferenceService around the 13B models, warm-up bucket "
        f"{SERVER_WARMUP} completed in {warm:.3f} s (launches "
        f"{warm_counts}); serving on {root}")
    buf = io.BytesIO()
    Image.fromarray(synthetic_image(height, width)).save(buf, format="PNG")
    body = {"image": base64.b64encode(buf.getvalue()).decode(),
            "prompt": "a seeded synthetic gradient comes alive",
            "negative_prompt": "worst quality", "height": height,
            "width": width, "num_frames": frames, "frame_rate": 30,
            "num_inference_steps": 10, "creation_id": "chip_smoke"}
    seen = {}

    def serve(on_stage):
        real = gen.generate
        gen.generate = lambda *a, **k: real(*a, on_stage=on_stage, **k)
        try:
            status, payload = _http(root + "/", body)
        finally:
            del gen.generate
        assert status == 200, (status, payload[:500])
        url = json.loads(payload)[0]["video"]
        assert url.startswith(root + "/download/video_"), url
        t1 = time.perf_counter()
        status, mp4 = _http(url)
        assert status == 200 and len(mp4) > 0, (status, len(mp4))
        path = os.path.join(out_dir, "downloaded.mp4")
        with open(path, "wb") as f:
            f.write(mp4)
        video = media.load_video(path)
        seen.update(url=url, mp4_bytes=len(mp4),
                    download_s=time.perf_counter() - t1)
        return np.clip(np.round((video + 1.0) * 127.5), 0, 255).astype(
            np.uint8)

    try:
        p1, p2 = run_ltx13b_request(gen, t5, name, mode, fused, bound,
                                    serve=serve)
        status, payload = _http(root + "/", {k: v for k, v in body.items()
                                             if k != "prompt"})
        assert status == 400 and b"Missing fields: prompt" in payload, \
            (status, payload)
        status, payload = _http(root + "/download/..%2Fchip_smoke.py")
        assert status == 404, (status, payload[:200])
        status, payload = _http(root + "/metrics")
        metrics = json.loads(payload)
        assert status == 200 and metrics["counters"]["requests_ok"] == 1, \
            metrics
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
        set_attention_mode("auto")
        set_fused_prologue(False)
    g = metrics["gauges"]
    stages = {k.split("/", 1)[1]: v for k, v in g.items()
              if k.startswith("last_stage_s/")}
    assert stages["save_video"] > 0 and stages["generate"] > 0, stages
    log(f"[server] POST / {width}x{height}x{frames} answered 200 in "
        f"{g['last_request_s']:.3f} s: "
        + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
        + f"; GET {seen['url'].rsplit('/', 1)[1]}: {seen['mp4_bytes']} bytes, "
        f"read back to {frames} frames, {seen['download_s']:.3f} s with the "
        "decode; a missing field answers 400, a path out of outputs/ 404, "
        "GET /metrics 200")
    return p1, p2


def phase_cli():
    """One request through the CLI's ``main`` on the demo model."""
    from ltx_video_gpupoor_tpu_torch.serving import cli
    from ltx_video_gpupoor_tpu_torch.utils import media

    height, width, frames = CLI_REQUEST
    path = os.path.join(ROOT, "outputs", "cli_demo.mp4")
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = cli.main(["--demo", "--prompt", "a red fox in the snow",
                    "--height", str(height), "--width", str(width),
                    "--video-length", str(frames), "--seed", str(SEED),
                    "--output-path", path])
    sec = time.perf_counter() - t0
    counts = kernel_counts()
    video = media.load_video(out)
    assert out == path and os.path.getsize(path) > 0
    assert video.shape == (frames, height, width, 3), video.shape
    assert counts["K1"] > 0, counts
    log(f"[cli] main(--demo ... {width}x{height}x{frames}) wrote "
        f"{os.path.relpath(out, ROOT)} ({os.path.getsize(path)} bytes, "
        f"{video.shape[0]} frames) in {sec:.3f} s with the model build; "
        f"launches {counts}")
    return counts


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
    reset_kernel_counts()
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
    ("flash_fwd_kernel<128, true", "K3 bounded-score flash attention"),
    ("flash_fwd_kernel<64, true", "K3 bounded-score flash attention"),
    ("flash_fwd_kernel", "K1 / K6 exact flash attention"),
    ("norm_mod_quantize_rows_kernel", "K5 prologue row kernel"),
    ("flash_int8_kernel", "K4 int8 flash attention"),
    ("int8_gemm_kernel", "K2 / K5 int8 GEMM"),
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


def profile_ltx13b(gen, t5, tier):
    """One more 13B request of ``LTX13B_TIERS[tier]``; the trace must hold
    the kernel groups that only this tier launches."""
    name, mode, fused, bound = LTX13B_TIERS[tier]
    h, w, f = LTX13B_REQUEST
    s = profile_request(
        f"ltx13b_{w}x{h}x{f}_tier_{name[0]}",
        lambda: run_ltx13b_request(gen, t5, name, mode, fused, bound,
                                   check=False))
    want = {1: "K5 prologue row kernel",
            2: "K3 bounded-score flash attention"}[tier]
    assert want in s["groups"], (want, sorted(s["groups"]))
    return s


def kernel_entry(name, source, replaces, launches, err, times, info, key):
    """One entry of the ``kernels`` line, from the timed shape ``key``."""
    bound, bound_by, library = info[key]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times[key][0], "plain_ms": times[key][1],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each path, profile one more headline "
                    "request (LTX-2B 704x480x121, LTX-13B 992x608x121 in "
                    "tiers (b) and (c), Wan 832x480x81) and print the device time by "
                    "kernel group")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    kind, _ = phase_device()
    phase_build(compare=args.profile)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_err = phase_k1(gen)
    k2_err = phase_k2(gen)
    k4_err = phase_k4(gen)
    k3_err = phase_k3(gen)
    k5_err = phase_k5(gen)
    k6_err = phase_k6(gen)
    times, info = phase_timing(gen)
    k8_err, k8_launches = phase_k8(gen, times, info)
    k7_err, k7_launches = phase_k7(gen, times, info)
    log(f"[clock] kernel checks and timings done at "
        f"{time.perf_counter() - t_start:.0f} s")
    ltx_launches, generator, t5 = phase_path()
    if args.profile:
        profile_ltx(generator, t5)
    del generator            # free the LTX-2B DiT; the 13B path keeps T5
    torch.cuda.empty_cache()
    log(f"[clock] LTX-2B path done at {time.perf_counter() - t_start:.0f} s")
    ltx13b_launches, generator13b = phase_ltx13b(t5)
    if args.profile:
        profile_ltx13b(generator13b, t5, 1)
        profile_ltx13b(generator13b, t5, 2)
    del generator13b, t5     # free the LTX models for the Wan path
    torch.cuda.empty_cache()
    log(f"[clock] LTX-13B path done at {time.perf_counter() - t_start:.0f} s")
    phase_cli()
    wan_launches, pipe, umt5 = phase_wan()
    if args.profile:
        profile_wan(pipe, umt5)
    log(f"[clock] Wan path done at {time.perf_counter() - t_start:.0f} s")
    by_tier = dict(zip((m for *_, m in WAN_REQUESTS), wan_launches))
    tier_b, tier_c = LTX13B_TIERS[1][0], LTX13B_TIERS[2][0]
    k2_key = f"K2 {K2_TIMED}"
    k5_key = f"K5 {K5_TIMED}"
    kernels = [
        kernel_entry("flash_attention (exact online softmax)", K1_SOURCE,
                     K1_REPLACES, ltx_launches[-1]["K1"], k1_err, times, info,
                     "K1 self"),
        kernel_entry("int8_linear (dynamic int8)", K2_SOURCE, K2_REPLACES,
                     wan_launches[-1]["K2"], k2_err, times, info, k2_key),
        kernel_entry("flash_attention_int8 (int8 QK + int8 PV)", K4_SOURCE,
                     K4_REPLACES, wan_launches[-1]["K4"], k4_err[0], times,
                     info, "K4 int8pv self"),
        kernel_entry("flash_attention_int8 (int8 QK + bf16 PV)", K4_SOURCE,
                     K4_REPLACES, by_tier["pallas_int8"]["K4"], k4_err[1],
                     times, info, "K4 int8qk self"),
        kernel_entry("flash_attention (bounded scores, no running max)",
                     K1_SOURCE, K3_REPLACES, ltx13b_launches[tier_c]["K3"],
                     k3_err, times, info, "K3 self pass 2"),
        kernel_entry("norm_mod_int8_matmul (fused adaLN prologue + int8 "
                     "linear)", K5_SOURCE, K5_REPLACES,
                     ltx13b_launches[tier_b]["K5"], k5_err, times, info,
                     k5_key),
        kernel_entry("flash_attention_hp (head-packed exact attention)",
                     K1_SOURCE, K6_REPLACES, ltx13b_launches[tier_b]["K6"],
                     k6_err, times, info, "K6 self pass 2"),
        kernel_entry("ring_attention_rdma (ring attention, the whole ring "
                     f"in one cooperative launch, p={RING_TIMED_P})",
                     K7_SOURCE, K7_REPLACES, k7_launches, k7_err, times, info,
                     f"K7 p={RING_TIMED_P}"),
        kernel_entry("pipelined_attention (sub-block-pipelined attention, "
                     f"nsub={K8_JSON_NSUB})", K8_SOURCE, K8_REPLACES,
                     k8_launches, k8_err, times, info,
                     f"K8 nsub {K8_JSON_NSUB}"),
    ]
    kernels[-1]["ms_by_nsub"] = {
        str(n): times[f"K8 nsub {n}"][0] for n in (1, 2, 4, 8)}
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
