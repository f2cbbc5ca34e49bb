#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: LTX-Video 2B
text-to-video (with TeaCache, and under FP32_POLICY), LTX-Video 13B
image-to-video through the two-pass multi-scale pipeline (one request of
it through the HTTP server, one through the CLI from checkpoint files in
the published layout), the CLI (in each quantization tier), Wan 2.1
t2v-1.3B (UniPC, DPM++, TeaCache), Wan 2.1 i2v-14B with CLIP ViT-H/14 and
the Wan VAE encoder, the prompt enhancer (Florence-2-large + Llama-3.2-3B)
on a served request, the Wan prompt extenders (Qwen2.5-VL-7B,
Qwen2.5-3B), U2-Net background removal, the legacy LTX VAE, the
ring-attention kernel and the attention micro-benchmark tool.

    python3 chip_smoke.py              # one card; several minutes on an H100
    python3 chip_smoke.py --profile    # and device-time breakdowns
    python3 chip_smoke.py --kernels-only   # phases 1 to 6, no result line

Phases, one output line each (or a few):

1. device   the card, its power limit, TF32 switched off for matmul/cuDNN.
2. build    nvcc builds csrc/ into the kernel library (seconds, registers
            of every instance, each K1/K6, K2, K4, K7 and K8 instance
            beside its parent's in PARENT_REGISTERS: "MOVED" where it
            differs; K1f, K3q and the row kernels of K2 and K5 listed
            apart); fails if ptxas serialized a wgmma or any kernel on
            wgmma (K1/K3/K6, K7's tensor-core body, K8, K2, K4, K3q,
            K1f) spills.
3. K1       the exact attention kernel (wgmma, TMA tile loads) against its
            plain version at the main path's shapes (self-attention B=3
            H=32 S=5280 D=64; cross-attention to 256 masked text tokens
            with one q row that sees no key; the 13B shapes B=1 H=32
            S=3840 and 15360 D=128 on head-split views, cross-attention to
            256 text tokens with segments and self-attention; ragged S)
            and, at both head dims, at every edge of its 128-row tiles (Sq
            and Skv one under, at and one over a tile; kv_valid inside the
            last tile, at a tile edge, a whole tile short and 0; causal;
            segments over three tiles), so that each mask kind of the
            block runs: every element within two bf16 ulps of the plain
            version plus 2**-9 of its largest output; planted faults (the
            last q tile zeroed, a head scaled by 1 + 2**-5) must fail that
            check.
4. K2       the dynamic-int8 linear (wgmma s8, TMA tile loads) at every
            main-path shape (LTX-2B, Wan-1.3B and LTX-13B at both passes'
            token counts: 4096->4096, 4096->16384, 16384->4096, patchify,
            proj_out, the caption and adaLN projections) and at ragged
            ones (M 1, 17, 129; N off the 256-column tile; K 16, 48,
            8960; K 40 and 1000, off a 16-multiple; K 20000 and 20008,
            past the row kernel's registers, its two-pass form): the
            int8 activations (zero codes past K in the padded rows) and
            int32 accumulators equal the plain version's exactly, the
            outputs agree to 1e-2 relative; planted faults (the last
            16-byte K step dropped from the plain accumulator, codes
            from x * (1 / s) without the IEEE quotient near a half)
            must fail the check.
4b. prologue the int8 attention tiers' quantize prologue on the card (Q
            in every tier and the QK tier's K by K2's row kernel on the
            prologue's contract, one counted launch each) at K3q's, K4's
            and K1f's shapes on head-split views, bf16 and fp32: codes
            and scales equal the plain torch ops bit for bit; a planted
            fault (Q's scale times the unfolded factors) must fail it.
5. K4       the int8 attention kernel, both tiers (QK+PV, QK), against its
            plain version on the same prologue operands at the Wan shapes
            (self-attention B=2 H=12 S=32760 D=128 on head-split views;
            cross-attention to 512 text tokens with padding and a q row
            that sees no key), at the 13B shapes (self-attention B=1 H=32
            S=3840 and 15360 D=128; cross-attention to 256 text tokens
            with segments), and at D=64, ragged, kv_valid and causal
            shapes, so that every mask kind of the block runs (none, tail,
            general). The plain version steps its online softmax by the
            kernel's 128-row tile, the kernel's math: every element within
            int8_tile_bound (a few P codes apart, each worth max|v| /
            (127 * the row's softmax mass), then one bf16 rounding), the
            mean difference under 5e-4 of the mean |output|; planted
            faults at the self-attention shapes (the last q tile zeroed,
            a channel without its v scale) must fail that check. By JAX's
            kv block (P quantized against other running maxima): every
            element within int8_tile_bound plus int8_order_bound (derived
            for the block order: a P code's step times the rescale between
            the two maxima, over |V| in sight), the ratio's root mean
            square under K4_ORDER_RMS = 0.05, the mean under 1e-3, and
            the planted faults must fail it too. Against exact fp32
            attention the kernel's mean abs error is at most 1.1x the
            plain version's.
5b. K3     the bounded-score tier of the exact kernel (K1's block at a
            fixed exponent offset) against its plain version at the 13B
            shapes (self-attention B=1 H=32 S=3840 and 15360 D=128 on
            head-split views; cross-attention to 256 text tokens with
            padding and a q row that sees no key), at the LTX-2B
            self-attention shape (B=3 H=32 S=5280 D=64) and at ragged,
            kv_valid, causal and D=64 shapes, so that every mask kind runs
            at both head dims, with one q row whose scores lie over the
            bound: every element within two bf16 ulps of the plain version
            plus 2**-9 of its largest output; planted faults (the last q
            tile zeroed, a head scaled by 1 + 2**-5) at 13B pass 2 and at
            the LTX-2B shape must fail that check.
5a'. d=80   K1, K3, K4, K3q and K1f (its five variants) at CLIP
            ViT-H/14's head dim of 80 (the D=128 layout, 80 columns loaded
            and stored, the rounded denominator of JAX's ones column; K1f
            on m64n80 TF32 wgmma for P.V) at CLIP's self-attention (B=1
            H=16 S=257 on head-split views, no padding: the tail
            instance), with the planted faults of each kernel's check,
            then tile edges, kv_valid, causal and segments; the prologue's
            row kernel at D=80 in [prologue].
5b'. K3q   the int8 Q.K^T tier under the bounded softmax (a kernel of its
            own: a producer warp, the warpgroups taking turns) against
            its plain version on the same prologue operands (per-row k
            scales, no running max: nothing depends on a kv block) at the
            same shapes and with K3's check and planted faults; each
            launch must move its own counter and no other; then the
            wrapper (prologue + kernel, q's layout).
5c. K5     the fused adaLN prologue + int8 linear at the 13B shapes (M
            3840 and 15360, K 4096, N 12288 and 16384, 16 groups, so a
            group edge lies inside a GEMM tile) and at a ragged one: the
            int8 codes and row scales of the row kernel and the int32
            product equal the plain version's exactly, the outputs agree
            to 1e-2 relative; a planted fault (two groups' modulation rows
            swapped) must fail the check. Its row kernel is timed beside
            its own memory bound, one call and in a CUDA graph.
5d. K6     the head-packed kernel against its plain version at the 13B
            shapes (B=1 S=3840 and 15360, 32 heads of 128), at the LTX-2B
            shape (B=3 S=5280, 32 heads of 64), on slices of a fused q/k/v
            projection, ragged with a kv_valid tail and with an odd head
            count: K3's check and planted faults.
5e. K8     the sub-block-pipelined attention kernel (K1's D=64 block,
            the Q.K^T of the next sub-block issued before this one's
            softmax) against its plain version (the same sub-blocks, the
            same roundings) at B=2 H=32 S=5376 D=64 for nsub 1, 2, 4, 8 and
            at B=1 H=2 S=1344 (a ragged last q tile) with 64-row kv tiles:
            K3's check; a planted fault (two sub-blocks' V rows swapped)
            must fail it. Then the tool's own main() runs
            (ltx_video_gpupoor_tpu_torch.tools.mb_selfattn_pipeline): its
            check against exact attention, K1 and K8 per nsub timed (each
            instance's registers are in the build phase's ptxas lines).
5f. K7     the ring-attention kernel (the whole ring in one cooperative
            launch; its tensor-core body is K1's block) for p = 1, 2, 4, 8
            at B=1 H=12 S=32768 D=128 in bf16 against the same ring in
            plain PyTorch (K3's check) and against one K1 call on the
            joined tensors, twice in a row on one workspace; a planted
            fault (a rank skips a step's math) must fail the check; p = 1
            runs without a workspace; where S/p is an odd multiple of 64
            (the block's tail instance) at D 64 and 128; at the JAX
            tests' shapes (B=1 H=2 S=64 D=32 and S=32 D=16, p = 8) in
            fp32 (atol 2e-5) and bf16 (atol 3e-2) through the CUDA-core
            body; on a dp2 x sp2 x tp2 mesh the rings that the neighbour
            ids spell out. Its time line gives the softmax state it moves
            through device memory.
5g. K1f    the fp32 attention kernel (FP32_POLICY; each product as three
            TF32 wgmma products, split TF32; the build phase refuses a
            spill or a serialized wgmma in any of its instances)
            against its plain versions at atol = rtol = 2e-5 (the JAX
            tests' fp32 tolerance) in each variant: exact at the LTX-2B
            self-attention (B=3 H=32 S=5280 D=64), the cross-attention to
            256 text tokens with segments, the [fp32] request's shapes
            (S=128) and 13B pass 1 (S=3840 D=128); bounded at 40; the int8
            Q.K^T codes with an fp32 V (bounded or not); the int8 QK+PV
            tier against the plain version stepped by K1f's 64-row tile
            within int8_tile_bound; head-packed [B, S, H*D]; every mask
            kind at the edges of its 128-row q tiles and 64- and 32-row kv
            tiles for both head dims; planted faults (the last
            q tile zeroed, a head scaled by 1 + 2**-6) must fail the check;
            then attention() on fp32 operands in every tier must launch the
            variant ops.attention.kernel_route names. K5's fp32 row
            instance beside K5's checks.
6. timing   each kernel and its plain version, CUDA events, median of 5
            (plain versions at the large attention shapes: median of 3),
            and the one PyTorch call that computes the same function where
            there is one (scaled_dot_product_attention for K1 and K6, with
            a boolean key mask for K1's cross-attention, torch._int_mm for
            K2's GEMM alone), timed here and used nowhere in the port;
            K1's, K2's, K4's and K6's times stand beside those of the
            kernels they replaced, K1's beside the same call through the
            tail and the general mask instance, K4's, K3's and K3q's beside
            K1 at the same shape, K2's row quantize (one call and in a
            CUDA graph, beside its bytes bound and its plain version) and
            K3q's prologue (the same, beside the plain prologue) apart;
            each kernel's bound (the larger of its operations over the
            card's peak rate and its bytes over the memory rate; for
            K3, K3q and K4 also their exponentials, one ex2 a score at 16
            a clock an SM at the card's highest SM clock) is computed from
            the timed shapes. K3 and K3q at the 13B shapes and at LTX-2B's
            self-attention. K1, K4, K3q and K1f at CLIP's d=80 shape (one
            call and in a CUDA graph; SDPA beside K1 and, in fp32, K1f).
7. path     LTX-2B at full width (28 layers, 32x64 heads, int8_dynamic),
            the 0.9.7 VAE decoder and T5-XXL, random weights from seeds:
            a 2-layer cut of the DiT on the card against the plain
            versions on the CPU, then two requests through
            a T5 encode of seeded token ids and LTXVideoGenerator.generate
            (256x256x9, 704x480x121; 8 steps, CFG + STG, stochastic
            sampling, decode noise), each with its stage times (T5,
            denoise, decode), peak memory and kernel launch counts.
7a. teacache  LTX-2B at full width, 704x480x121, ltxv-2b-0.9.6-dev at 30
            steps (bench.py's headline) without TeaCache, at --teacache 2.2
            and at 2.2 with attention_score_bound=40: steps computed,
            denoise and total seconds, K1 / K3 / K2 launches (a skipped
            step launches no block: K1 or K3 = 2 x 28 x steps computed),
            frame PSNR against the request without TeaCache.
7a'. fp32  LTX-2B at full width under FP32_POLICY (int8_dynamic weights,
            fp32 activations, fp32 VAE decoder) at 256x256x9, served
            (auto: K1f and K2 on fp32 activations, no bf16 attention
            kernel) and in the xla tier: frames >= 40 dB apart.
7b. ltx13b  the LTX-2B DiT is freed; LTX-13B at full width and depth (48
            layers, 32x128 heads, inner 4096, int8_dynamic, built and
            quantized layer by layer), the 0.9.7 VAE with its encoder, the
            latent upsampler (mid 512, 4 blocks a stage) and the same
            T5-XXL: a 2-layer cut of the DiT on the card against the plain
            versions on the CPU in each tier, then four image-to-video
            requests at 992x608x121 from a seeded synthetic image through
            LTXVideoGenerator.generate with ltxv-13b-0.9.7-distilled (pass
            1 at 640x384, 3840 tokens, 7 steps; latent upsample; AdaIN;
            pass 2 at 1280x768, 15360 tokens, 3 steps; VAE decode in
            temporal tiles; resize back), each tier pinned as
            set_attention_mode / LTXV_TPU_ATTN pins it: (a) auto (K4 + K2),
            (b) pallas_hp with the fused prologue (K6, K5, K1 for the
            cross-attention, K2 for the rest), (c) attention_score_bound=40
            (K3 + K2), (d) pallas_int8 with attention_score_bound=40 (K3q +
            K2 + the prologue's row kernel). The launch counts are read per
            pass; the script fails unless each tier launched its kernels
            in both passes and none of the others (LTX13B_EXPECT).
            Request (b)
            goes through the server:
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
            them).
7c'. enhance inside [server], on the same InferenceService: Llama-3.2-3B-
            Instruct (28 layers, dim 3072, 24/8 heads of 128, vocabulary
            128256, llama3 RoPE) and Florence-2-large (DaViT 256-2048,
            BART 12 + 12 layers of 1024; FLORENCE2_LARGE_HF, pinned from
            the published config.json) built on the card in bf16 from
            seeds; their 2-layer cuts against fp32 copies on the CPU (Llama
            prefill logits, 8 cached decode steps against one full
            forward, Florence's tower features and decoder logits; bar 30
            dB); then the tier-(b) POST / again with "enhance_prompt":
            true, the enhancer set on the service with its models and the
            word-level stand-in tokenizers (WordTokenizer): the caption
            (768x768) and the rewrite run on the card, the text encoding
            gets the rewrite (its embeddings differ from the original
            prompt's), the launches are exactly tier (b)'s
            (ENHANCE_EXPECT); caption s, rewrite s, tokens, stages, peak
            GiB. The enhancer is freed. Then requests through the CLI's
            main() at 256x256x9
            on the demo model: as it is, then with --quantize-transformer
            in each --int8-mode of wo, wo_int4 and mixed_int4 (no K2).
7d. load    synthetic files in the published layout in a temporary
            directory (the 13B-dev quanto int8 transformer at full width
            and 24 of its 48 layers, 6.5 GB, so that the script with
            [wan_i2v] keeps near its former time; the distilled LoRA,
            rank 128; the
            0.9.7 VAE; the spatial upscaler), then one 992x608x121
            image-to-video request through the CLI's real branch
            (--model-mode ltxv_13B_distilled --ckpt-dir, no --demo,
            --quantize-transformer, --save-quantized): seconds to write,
            read (and which reader), move to the card and dequantize there,
            merge the LoRA, save the quantized file (its size), generate,
            and which mp4 writer ran; the mp4 must read back.
8. wan      the LTX models are freed; Wan 2.1 t2v-1.3B at full width (30
            layers, 12x128 heads, ffn 8960, int8_dynamic), UMT5-XXL (24
            layers, d 4096, bf16) and the Wan VAE decoder (dim 96, z 16),
            random weights from seeds: a 2-layer cut of the DiT at
            832x480x17 on the card against the plain versions on the CPU,
            then four requests through a UMT5 encode of seeded token ids
            and WanPipeline.generate_t2v (UniPC, shift 5, guide scale 5,
            CFG-Zero-star, tiled VAE decode; 4 steps, the alpha rescale
            from step 1 as from step 6 of 50): 832x480x17 (7800
            tokens a stream) in the default tier (K4 QK+PV) and in the
            QK tier, and 832x480x81 (32760 tokens) in the exact tier (K1)
            and in the default one; stage times, peak memory, launch
            counts of K1, K2 and K4. Then 832x480x17 with DPM++, and with
            TeaCache 2.0 (t2v_1.3B coefficients) at 10 steps: the steps
            computed, K4 launches = 2 x 30 x steps computed.
8a. wan_variants  the rest of Wan 2.1 on the [wan] DiT, to which it
            attaches the published variants' modules (seeded, dynamic
            tier): 15 VACE hint blocks at layers 0, 2, .., 28 with a
            96-channel context (Wan2.1-VACE-1.3B), a camera encoder and
            projector in every block (ReCamMaster), the fps embedding and
            projection (SkyReels-V2-DF-1.3B-540P); the Wan VAE with its
            encoder. A 2-layer cut with the hints, the cameras, the fps row
            and per-frame timesteps against the CPU plain versions (bar 30
            dB), then requests at 4 UniPC steps: VACE 832x480x81 (a control
            clip with its middle frames masked and a reference image
            through vace_encode_frames / _masks / vace_latent), Phantom
            (three streams over a reference image's latents), ReCamMaster
            (an 81-frame source clip, a preset trajectory: 65520 tokens a
            stream), a sliding window continuing the VACE request
            (overlapped latents, overlap noise 20, return_latent_slice);
            SkyReels-V2 diffusion forcing at 960x544x97 (ar_step 1, causal
            blocks of 5, fps 24) and its continuation from a 17-frame
            prefix (overlap noise 20); XLM-Roberta large (24 layers, 2 x 77
            padded ids; its 2-layer cut against the CPU); CLIP ViT-H/14
            under FP32_POLICY (K1f at d=80). Each request's seconds by
            stage, peak GiB and launches, which must equal variant_expect.
8b. wan_i2v the 1.3B DiT is freed; Wan 2.1 i2v-14B at full width and depth
            (40 layers, dim 5120, 40x128 heads, ffn 13824, in_dim 36),
            built one block at a time and quantized as it goes, in one
            tier at a time (the same weights from the seed in each), CLIP
            ViT-H/14 (32 blocks of 1280, 16x80 heads) and the Wan VAE with
            its encoder, random weights from seeds: a 2-layer cut of the
            DiT against the CPU plain versions in each of dynamic, wo,
            wo_int4 and mixed_int4, CLIP's first two blocks the same way
            (K4 at D=80), then three image-to-video requests through a
            UMT5 encode (the Wan path's), CLIP visual on the seeded image
            resized to 224, and WanPipeline.generate_i2v (the whole clip
            VAE-encoded, 4 frames at a time a layer; UniPC; tiled decode):
            (1) 832x480x81, dynamic, attention auto, 2 steps (K4 at D=128
            and D=80, K2, K2p); the dynamic DiT is freed and the
            mixed_int4 one built; (2) 832x480x81, mixed_int4, auto, 2
            steps (K4 at both head dims, no K2); (3) 832x480x17,
            mixed_int4 with the exact tier pinned, 1 step (K1 at D=128 and
            D=80); seconds by stage (UMT5, CLIP, VAE encode, denoise,
            decode), peak GiB (UMT5-XXL, CLIP, the VAE and the one DiT
            resident), the DiT's resident bytes; the launch counts must
            equal wan_i2v_expect.
8c. aux    on a free card: Qwen2.5-VL-7B-Instruct at full width (tower 32
            blocks of 1280, full attention at 7/15/23/31; LLM 28 layers of
            3584, 28/4 heads, M-RoPE (16, 24, 24)), its 2-layer cut
            against the CPU, one extend_with_img chat on a 448x448 image;
            Qwen2.5-3B-Instruct, one extend (both 128 tokens); U2-Net (U2NET) from a random
            u2net.pth through load_torch_checkpoint: salience_map of 4
            frames at 832x480 against the CPU (30 dB), remove_background
            with the matting at 256x256; the legacy VAE at its default
            widths: encode and decode of 512x320x41, a decode against the
            CPU (30 dB); cli.main from synthetic files whose VAE is a
            legacy one (the 13B transformer at 2 layers) through
            load_ltxv_model's legacy branch, 512x320x41.
9. profile  only with --profile: one more 704x480x121 LTX-2B request, one
            more 13B request of kinds (b), (c) and (d) and one more
            832x480x81 Wan request, each twice under torch.profiler: as it
            is, for the device span, busy time and idle share, then with
            scopes around the port's ops, for the device time by kernel
            group (K1/K6, K3, K3q, K2, its row quantize and its prologue
            instance, K4, K5, ...; PyTorch's own kernels by the op that
            launched them: RoPE, norms, GELU/GEGLU, the int8 prologue's
            torch ops, casts and copies, the rest), read from the exported
            traces; the build
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
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

K1_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_wgmma.cu"
K3_SOURCE = K1_SOURCE        # K1's block at a fixed exponent offset
K1_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:160"
K2_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/int8_linear.cu"
K2_REPLACES = "ltx_video_gpupoor_tpu/ops/int8_matmul.py:40"
K4_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_int8.cu"
K4_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:160"
K3_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:294"
# K3q: the int8 Q.K^T branch (:218-239) under the bounded step (:296)
K3Q_SOURCE = K4_SOURCE
K3Q_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:218"
# the int8 tiers' quantize prologue, which JAX leaves to XLA around the
# Pallas call; K2's row kernel computes it on the card
PROLOGUE_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:484"
K5_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/fused_prologue.cu"
K5_REPLACES = "ltx_video_gpupoor_tpu/ops/fused_prologue.py:104"
K6_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:663"
K7_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/ring_attention.cu"
K7_REPLACES = "ltx_video_gpupoor_tpu/parallel/ring_rdma.py:43"
K1F_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_fp32.cu"
# K1f: the fp32 branches of the same Pallas kernel (it runs in its input
# dtype, :343-352)
K1F_REPLACES = "ltx_video_gpupoor_tpu/ops/flash_attention.py:343"
K8_SOURCE = "ltx_video_gpupoor_tpu_torch/csrc/flash_attention_pipelined.cu"
K8_REPLACES = "tools/mb_selfattn_pipeline.py:32"
# the card's published peaks (H100 SXM, dense): operations per second by
# operand type, and bytes per second of device memory
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# K1 and K6 before their redesign (the mma.sync block with 64-row tiles),
# and K2, K4, K5, K7 and K8 on their mma.sync kernels, ms on an NVIDIA H100 80GB
# HBM3 at 700 W as this script's phase_timing measured them then (PERF.md's
# kernel table), printed beside the new times
ACCEPTED_MS = {
    "K1 self": 6.251, "K1 cross": 0.433, "K6 LTX-2B": 6.160,
    "K1 self pass 1": 3.050, "K1 self pass 2": 39.318,
    "K6 self pass 1": 2.928, "K6 self pass 2": 39.376,
    "K1 cross pass 1": 0.300, "K1 cross pass 2": 0.928,
    "K2 wan ffn_in 1536->8960": 8.047, "K2 ffn_in 2048->8192": 2.229,
    "K2 13B pass 2 qkvo 4096->4096": 2.441,
    "K2 13B pass 2 ffn_in 4096->16384": 10.732,
    "K2 13B pass 2 ffn_out 16384->4096": 10.480,
    "K4 int8pv self": 106.033, "K4 int8qk self": 101.711,
    "K4 int8pv 13B pass 2 self": 31.990, "K4 int8qk 13B pass 2 self": 30.921,
    "K4 int8pv 13B pass 2 cross": 0.812,
    "K5 pass 2 qkv": 7.984, "K5 pass 2 proj_in": 10.756,
    "K5 pass 1 qkv": 2.061, "K5 pass 1 proj_in": 2.789,
    # K7 and K8 on their mma.sync bodies (chip run 4 of PR 4)
    "K7 p=1": 48.614, "K7 p=2": 47.305, "K7 p=4": 48.115, "K7 p=8": 50.555,
    "K8 nsub 1": 2.900, "K8 nsub 2": 3.033, "K8 nsub 4": 3.060,
    "K8 nsub 8": 3.463,
}
# one ex2 a score on the special-function units: 16 a clock on each SM at
# compute capability 9.0 (the CUDA C++ Programming Guide's instruction
# throughput table), at the card's highest SM clock, which phase_device
# reads, so that the floor is one the card could reach
EX2_PER_SM_CLOCK = 16
# the H100 SXM's published highest SM clock, where nvidia-smi gives none
SM_CLOCK_MAX_MHZ = 1980.0
# fp32 fused multiply-adds: 128 lanes on each SM, two operations each, at
# the same highest clock (K1f's second figure, its CUDA-core design's bound)
FP32_LANES_PER_SM = 128
# K1f takes each product as three TF32 products (split TF32)
K1F_TF32_PRODUCTS = 3
# K1f against its plain version: the JAX tests' fp32 tolerance
K1F_ATOL = K1F_RTOL = 2e-5
# K4 against its plain version stepped by JAX's kv block (see _k4_case):
# every element within int8_tile_bound + int8_order_bound, the ratio's
# root mean square under fa.K4_ORDER_RMS, the mean abs difference under
# K4_BLOCK_MEAN (1.4e-4 emulated on the CPU at the cross shape)
K4_BLOCK_MEAN = 1e-3

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
# Wan 2.1 i2v-14B at 832x480x81 (dynamic tier): the blocks' linears over
# both CFG streams, the image k/v and img_emb over 2 x 257 CLIP tokens
K2_I2V_SHAPES = [
    ("i2v-14B qkvo 5120->5120", 2 * 32760, 5120, 5120, "bf16"),
    ("i2v-14B ffn_in 5120->13824", 2 * 32760, 5120, 13824, "bf16"),
    ("i2v-14B ffn_out 13824->5120", 2 * 32760, 13824, 5120, "bf16"),
    ("i2v-14B image k/v 5120->5120 M=514", 2 * 257, 5120, 5120, "bf16"),
    ("i2v-14B img_emb 1280->5120 M=514", 2 * 257, 1280, 5120, "bf16"),
]
K2_TIMED = "wan ffn_in 1536->8960"
K2_ROWS_TIMED = "wan ffn_out 8960->1536"   # the longest rows of the Wan path
# ragged K2 shapes: M 1, 17, 129; N off the 256-column tile (and off a
# multiple of 4, the 16-byte store); K 16, 48, 8960
K2_RAGGED = [
    ("ragged M=1 K=16", 1, 16, 200, "bf16"),
    ("ragged M=17 K=48 N=257", 17, 48, 257, "fp32"),
    ("ragged M=129 K=8960 N=600", 129, 8960, 600, "bf16"),
    ("ragged M=1000 K=4096 N=4100", 1000, 4096, 4100, "bf16"),
    # K that is not a 16-multiple (codes padded to one, the weight padded
    # at the call) and K past the row kernel's registers (its two-pass
    # form), as JAX's chain takes them
    ("ragged K=40 M=33 N=72", 33, 40, 72, "bf16"),
    ("ragged K=1000 M=130 N=256", 130, 1000, 256, "fp32"),
    ("two-pass K=20000 M=64 N=300", 64, 20000, 300, "bf16"),
    ("two-pass ragged K=20008 M=40 N=264", 40, 20008, 264, "fp32"),
]
K2_PLANTED = "13B pass 2 ffn_in 4096->16384"

# Wan 2.1 1.3B attention shapes (B, H, Sq, Skv, D)
WAN_SELF = (2, 12, 32760, 32760, 128)
WAN_CROSS = (2, 12, 32760, 512, 128)
# Wan 2.1 i2v-14B at 832x480x81: 40 heads; the text cross-attention (512
# padded T5 tokens under segments) and the image cross-attention (257 CLIP
# tokens, no mask: the last 128-row kv tile holds one key)
WAN_I2V_TEXT_CROSS = (2, 40, 32760, 512, 128)
WAN_I2V_IMAGE_CROSS = (2, 40, 32760, 257, 128)
# (H, W, F, attention tier); the exact tier at 832x480x81 beside the
# default (int8 QK+PV) one says which a served request should pin; the
# default one comes last (the kernels line reads its launches)
WAN_REQUESTS = [(480, 832, 17, "auto"), (480, 832, 17, "pallas_int8"),
                (480, 832, 81, "pallas"), (480, 832, 81, "auto")]
WAN_STEPS = 4
WAN_EXTRA_SHAPE = (480, 832, 17)    # the DPM++ and TeaCache requests
WAN_TEACACHE_STEPS = 10
WAN_TEACACHE_MULT = 2.0
WAN_CFG_ZERO_STEP = 0    # the default 5 of 50 steps, cut with the steps

REQUESTS = [(256, 256, 9), (480, 704, 121)]  # (H, W, F)

# K7: the Wan-1.3B self-attention width at the nearest length that every p
# times a 64-row tile divides; the JAX tests' shapes for the CUDA-core body
RING_SHAPE = (1, 12, 32768, 128)
RING_RANKS = (2, 4, 8)
RING_TIMED_P = 4
RING_SMALL = [(1, 2, 64, 32), (1, 2, 32, 16)]
RING_MESH = (("dp", 2), ("sp", 2), ("tp", 2))
# the tensor-core body where S/p is an odd multiple of 64 (its tail
# instance: the last kv tile masked, q rows past S/p not stored): (B, H, S,
# D, p)
RING_TAIL = [(1, 3, 8 * 192, 128, 8), (2, 2, 2 * 64, 64, 2),
             (1, 2, 4 * 320, 64, 4), (1, 2, 64, 128, 1)]
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
# LTX-2B's self-attention at 704x480x121: three guidance streams of 5280
LTX2B_SELF = (3, 32, 5280, 5280, 64)
# CLIP ViT-H/14's self-attention in Wan i2v: 16 heads of 80, 257 tokens (a
# class token and 16 x 16 patches), K1 and K4 in their D=128 layout with 80
# columns loaded and stored
CLIP_SELF = (1, 16, 257, 257, 80)
# the [fp32] request: LTX-2B under FP32_POLICY at 256x256x9 (2 x 8 x 8
# latents), against the same request in the xla tier
FP32_REQUEST = (256, 256, 9)
FP32_REQUEST_TOKENS = 128
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
# (name, attention mode, fused prologue on, score bound); a request runs
# with set_attention_mode(mode), as LTXV_TPU_ATTN=mode does for a process
LTX13B_TIERS = [("a: auto", "auto", False, None),
                ("b: pallas_hp + fused prologue", "pallas_hp", True, None),
                ("c: score bound", "auto", False, LTX13B_BOUND),
                ("d: pallas_int8 + score bound", "pallas_int8", False,
                 LTX13B_BOUND)]
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    try:
        mhz, origin = float(clock[0]), "nvidia-smi clocks.max.sm"
    except (IndexError, ValueError):
        mhz, origin = SM_CLOCK_MAX_MHZ, "the published maximum"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ex2_per_s = sms * EX2_PER_SM_CLOCK * mhz * 1e6
    log(f"[device] ex2 floor: {sms} SMs x {EX2_PER_SM_CLOCK} a clock x "
        f"{mhz:.0f} MHz ({origin}) = {ex2_per_s:.4g} /s")
    return name, ex2_per_s


# the kernels on wgmma, by a fragment of their mangled names (K7's
# tensor-core instances are ring_kernel<0, ...>)
WGMMA_KERNELS = ("flash_wgmma_kernel", "int8_gemm_wgmma_kernel",
                 "flash_int8_wgmma_kernel", "ring_kernelILi0E",
                 "flash_pipelined_kernel", "flash_fp32_wgmma_kernel",
                 "k3q_wgmma_kernel")
# Registers a thread of every instance of K1/K6, K2, K4, K7 and K8 as the
# sources built them before K3 and K3q joined K1's and K4's kernels (ptxas
# on the H100's host; the same with the flag), by kernel and mangled
# template arguments; K1/K6's instances carry the BOUNDED flag (false)
# since then, K4's lost it again when K3q took a kernel of its own; both
# carry DV, the head's values (D for these; 80 for CLIP's heads in the
# D=128 layout), as their last argument.
# phase_build prints each instance beside its entry here (the redesigned
# K3q and K2 row-kernel instances at the end): an edit of
# attention_block.cuh or hopper.cuh that moves one shows as MOVED.
# (Printed, not asserted: another nvcc would move them all.)
PARENT_REGISTERS = {
    "flash_int8_wgmma_kernel<Li128ELb0ELi0ELi128E>": 214,
    "flash_int8_wgmma_kernel<Li128ELb0ELi1ELi128E>": 214,
    "flash_int8_wgmma_kernel<Li128ELb0ELi2ELi128E>": 203,
    "flash_int8_wgmma_kernel<Li128ELb1ELi0ELi128E>": 233,
    "flash_int8_wgmma_kernel<Li128ELb1ELi1ELi128E>": 232,
    "flash_int8_wgmma_kernel<Li128ELb1ELi2ELi128E>": 255,
    "flash_int8_wgmma_kernel<Li64ELb0ELi0ELi64E>": 173,
    "flash_int8_wgmma_kernel<Li64ELb0ELi1ELi64E>": 175,
    "flash_int8_wgmma_kernel<Li64ELb0ELi2ELi64E>": 163,
    "flash_int8_wgmma_kernel<Li64ELb1ELi0ELi64E>": 168,
    "flash_int8_wgmma_kernel<Li64ELb1ELi1ELi64E>": 168,
    "flash_int8_wgmma_kernel<Li64ELb1ELi2ELi64E>": 215,
    "flash_pipelined_kernel<Li128ELi128E>": 158,
    "flash_pipelined_kernel<Li128ELi16E>": 78,
    "flash_pipelined_kernel<Li128ELi32E>": 94,
    "flash_pipelined_kernel<Li128ELi64E>": 137,
    "flash_pipelined_kernel<Li64ELi16E>": 78,
    "flash_pipelined_kernel<Li64ELi32E>": 94,
    "flash_pipelined_kernel<Li64ELi64E>": 167,
    "flash_wgmma_kernel<Li128ELi0ELb0ELb0ELi128E>": 186,
    "flash_wgmma_kernel<Li128ELi1ELb0ELb0ELi128E>": 195,
    "flash_wgmma_kernel<Li128ELi2ELb0ELb0ELi128E>": 186,
    "flash_wgmma_kernel<Li64ELi0ELb0ELb0ELi64E>": 154,
    "flash_wgmma_kernel<Li64ELi0ELb1ELb0ELi64E>": 160,
    "flash_wgmma_kernel<Li64ELi1ELb0ELb0ELi64E>": 154,
    "flash_wgmma_kernel<Li64ELi1ELb1ELb0ELi64E>": 160,
    "flash_wgmma_kernel<Li64ELi2ELb0ELb0ELi64E>": 154,
    "flash_wgmma_kernel<Li64ELi2ELb1ELb0ELi64E>": 168,
    "int8_gemm_wgmma_kernel<Li0E>": 154,
    "int8_gemm_wgmma_kernel<Li1E>": 154,
    "int8_gemm_wgmma_kernel<Li2E>": 154,
    "ring_kernel<Li0ELi128ELi0E13__nv_bfloat16>": 196,
    "ring_kernel<Li0ELi128ELi1E13__nv_bfloat16>": 221,
    "ring_kernel<Li0ELi64ELi0E13__nv_bfloat16>": 160,
    "ring_kernel<Li0ELi64ELi1E13__nv_bfloat16>": 168,
    "ring_kernel<Li1ELi0ELi0E13__nv_bfloat16>": 123,
    "ring_kernel<Li1ELi0ELi0Ef>": 123,
    # the instances redesigned since: K3q's own kernel (DV last, as K4's)
    # and K2's row kernel, both instances of its contract (<T, CONTRACT,
    # LANES, SLOTS, VEC>)
    "k3q_wgmma_kernel<Li128ELi0ELi128E>": 156,
    "k3q_wgmma_kernel<Li128ELi1ELi128E>": 157,
    "k3q_wgmma_kernel<Li128ELi2ELi128E>": 160,
    "k3q_wgmma_kernel<Li64ELi0ELi64E>": 160,
    "k3q_wgmma_kernel<Li64ELi1ELi64E>": 160,
    "k3q_wgmma_kernel<Li64ELi2ELi64E>": 168,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi32ELi1ELb1E>": 32,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi64ELi1ELb1E>": 32,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi128ELi1ELb1E>": 32,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi256ELi1ELb1E>": 32,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi256ELi2ELb1E>": 38,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi256ELi4ELb1E>": 53,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi256ELi0ELb1E>": 56,
    "quantize_rows_kernel<13__nv_bfloat16Li0ELi256ELi0ELb0E>": 43,
    "quantize_rows_kernel<13__nv_bfloat16Li1ELi4ELi1ELb1E>": 37,
    "quantize_rows_kernel<13__nv_bfloat16Li1ELi8ELi1ELb1E>": 37,
    "quantize_rows_kernel<fLi0ELi32ELi1ELb1E>": 40,
    "quantize_rows_kernel<fLi0ELi64ELi1ELb1E>": 36,
    "quantize_rows_kernel<fLi0ELi128ELi1ELb1E>": 36,
    "quantize_rows_kernel<fLi0ELi256ELi1ELb1E>": 36,
    "quantize_rows_kernel<fLi0ELi256ELi2ELb1E>": 56,
    "quantize_rows_kernel<fLi0ELi256ELi4ELb1E>": 80,
    "quantize_rows_kernel<fLi0ELi256ELi0ELb1E>": 64,
    "quantize_rows_kernel<fLi0ELi256ELi0ELb0E>": 47,
    "quantize_rows_kernel<fLi1ELi4ELi1ELb1E>": 44,
    "quantize_rows_kernel<fLi1ELi8ELi1ELb1E>": 44,
}


def _instance(entry):
    """``kernel<template arguments>`` of a ptxas entry's mangled name (a
    name is mangled as its length, then itself)."""
    names = [(m.group(2)[:int(m.group(1))], m.start(2))
             for m in re.finditer(r"(?=(\d+)([a-z_]\w*))", entry)]
    names = [(n, at) for n, at in names if n.endswith("_kernel")]
    if not names:
        return entry[:60]
    # digits of the file hash before the length can spell a longer name
    name, at = min(names, key=lambda c: len(c[0]))
    targs = re.match(r"I((?:L[ib]\d+E|\d+__nv_bfloat16|f)+)E+v",
                     entry[at + len(name):])
    return name + (f"<{targs.group(1)}>" if targs else "")


def phase_build(compare=False):
    """Build the kernel library, every source's nvcc started together;
    ``compare``: first once with one source after another, for its time.
    Returns the registers a thread of each instance."""
    from ltx_video_gpupoor_tpu_torch.ops import _lib

    if compare:
        log(f"[build] one source after another: "
            f"{_lib.build(force=True, parallel=False)[1]:.2f} s")
    path, seconds, report = _lib.build(force=True)
    _lib.library()
    lines = [ln.strip() for ln in report.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    log(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.2f} s")
    entry, regs, spills, wgmma_spills = "", {}, {}, []
    for ln in lines:
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        spilled = int(spill.group(1)) + int(spill.group(2)) if spill else 0
        if spilled:
            spills[_instance(entry)] = spilled
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
            # the template arguments (ILi<D>ELi<mask kind>E, and K7's
            # element type) tell the instances of one kernel apart
            log("  " + _instance(entry))
        elif "Used" in ln or spilled:
            note = ""
            used = re.search(r"Used (\d+) registers", ln)
            if used:
                n = regs[_instance(entry)] = int(used.group(1))
                was = PARENT_REGISTERS.get(_instance(entry))
                if was is not None:
                    note = (" (the parent's registers)" if was == n else
                            f" (MOVED: the parent's {was})")
            log("    " + ln.replace("ptxas info    : ", "") + note)
            # every kernel on wgmma (K1/K3/K6, K2, K4/K3q, K7, K8, K1f)
            # keeps wgmma groups in flight or their registers pinned: a
            # spill there is a fault of the design
            if "Used" not in ln and any(k in entry for k in WGMMA_KERNELS):
                wgmma_spills.append(f"{ln} ({_instance(entry)})")
    assert not wgmma_spills, "a wgmma kernel spills:\n" + "\n".join(
        wgmma_spills)
    serialized = [ln.strip() for ln in report.splitlines()
                  if "serializ" in ln.lower()]
    assert not serialized, "ptxas serialized wgmma:\n" + "\n".join(serialized)
    moved = sorted(k for k, n in regs.items()
                   if PARENT_REGISTERS.get(k, n) != n)
    known = sum(k in PARENT_REGISTERS for k in regs)
    log(f"[build] {known} instances of K1/K6, K2 (its GEMM and its row "
        f"kernel), K3q, K4, K7 and K8 beside the parent's registers: "
        + (f"MOVED {moved}" if moved else "every one at its parent's"))
    for what, kernel in (("K1f", "flash_fp32_wgmma_kernel"),
                         ("K5's row kernel", "norm_mod_quantize_rows_kernel"),
                         ("K2's row kernel", "quantize_rows_kernel"),
                         ("K3q", "k3q_wgmma_kernel")):
        found = sorted(k for k in regs if k.startswith(kernel + "<"))
        assert found, f"no {what} instance was built"
        log(f"[build] {what} ({kernel}), {len(found)} instances: " + ", ".join(
            f"{k[len(kernel):]} {regs[k]} registers"
            + (f" SPILLS {spills[k]} bytes" if spills.get(k) else "")
            for k in found))
    return regs


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
             kv_valid=None, plant=False, gen):
    """K1 against its plain version on the same bf16 operands, held to
    ``_exact_check``; returns (max_abs_err, out, args)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    segs = seg(b, sq, skv) if seg else (None, None)
    kind = fa.mask_kind(skv, kv_valid, segments=seg is not None,
                        causal=causal)
    out = fa.flash_attention(q, k, v, *segs, causal=causal,
                             kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), f"K1 {name}: non-finite"
    plain = torch.cat([        # one batch row and a few heads at a time
        _by_heads(lambda a, b_, c: fa.reference_attention(
            a, b_, c, *(s_[i:i + 1] if s_ is not None else None
                        for s_ in segs), causal=causal, kv_valid=kv_valid),
            q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(b)])
    ratio, err = _exact_check(out, plain)
    assert ratio <= 1.0, (f"K1 {name}: max_abs_err {err:.3e}, {ratio:.3f} of "
                          "the bound")
    planted = _exact_planted(f"K1 {name}", out, plain, 1) if plant else ""
    log(f"[K1] {name}: B={b} H={h} Sq={sq} Skv={skv} D={d} mask kind {kind} "
        f"max_abs_err={err:.3e}, {ratio:.3f} of the bound{planted} ok")
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
                             packed=True, plant=i == 1, gen=gen)[0])
        torch.cuda.empty_cache()
    errs.append(_k1_case("ragged S, kv_valid", 2, 4, 1000, 1000, 64,
                         kv_valid=777, gen=gen)[0])
    errs.append(_k1_case("ragged causal", 1, 2, 333, 333, 128, causal=True,
                         gen=gen)[0])
    # every mask kind at every edge of the 128-row tiles, both head dims: Sq
    # and Skv one under, at and one over a tile; kv_valid inside the last
    # tile, at a tile edge, a whole tile short, and 0 (no key at all)
    for d in (64, 128):
        for sq, skv in ((127, 255), (128, 256), (129, 257), (383, 128),
                        (130, 1)):
            errs.append(_k1_case("tile edges", 1, 2, sq, skv, d, gen=gen)[0])
        for kv_valid in (500, 384, 300, 0):
            e, out, _ = _k1_case("kv_valid edges", 1, 2, 512, 512, d,
                                 kv_valid=kv_valid, gen=gen)
            errs.append(e)
        assert float(out.float().abs().max()) == 0.0, \
            "K1: with no key in sight every row must be 0"
        errs.append(_k1_case("causal at a tile edge", 1, 2, 512, 512, d,
                             causal=True, gen=gen)[0])
        e, out, _ = _k1_case("segments over three kv tiles", 3, 4, 700, 300,
                             d, seg=_cross_segments, gen=gen)
        errs.append(e)
        assert float(out[0, :, 17].float().abs().max()) == 0.0, \
            "K1: a row with no valid key must be 0"
    # the i2v-14B path with the exact tier pinned
    errs.append(_k1_case("i2v image cross-attention", *WAN_I2V_IMAGE_CROSS,
                         packed=True, plant=True, gen=gen)[0])
    e, out, _ = _k1_case("i2v text cross-attention", *WAN_I2V_TEXT_CROSS,
                         packed=True, seg=_cross_segments, gen=gen)
    errs.append(e)
    assert float(out[0, :, 17].float().abs().max()) == 0.0, \
        "K1: a row with no valid key must be 0"
    del out
    torch.cuda.empty_cache()
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

    worst = rows_worst = 0.0
    for name, m, k, n, dtype in K2_SHAPES + K2_RAGGED + K2_I2V_SHAPES:
        x, w8, sw, bias = _k2_operands(m, k, n, dtype, gen)
        xq, sx, acc = im.int8_linear_acc(x, w8)
        pq, ps = im.quantize_rows_plain(x)
        rows_worst = max(rows_worst, _max_diff(xq, pq), _max_diff(sx, ps[:, 0]))
        assert torch.equal(xq, pq), f"K2 {name}: int8 activations differ"
        assert torch.equal(sx, ps[:, 0]), f"K2 {name}: row scales differ"
        if k % 16:
            padded = im.quantize_rows(x)[0]
            assert padded.shape[1] == -(-k // 16) * 16 \
                and not padded[:, k:].any(), f"K2 {name}: codes past K"
        pacc = im.int8_gemm_acc_plain(pq, w8)
        assert torch.equal(acc, pacc), f"K2 {name}: int32 accumulators differ"
        planted = ""
        if name == K2_PLANTED:
            # a GEMM that dropped its last 16-byte K step must fail
            short = im.int8_gemm_acc_plain(pq[:, :-16], w8[:, :-16])
            wrong = float((acc != short).float().mean())
            assert wrong > 0, "K2: the check passes a planted fault"
            # and so must codes taken from x * (1 / s) with no IEEE
            # quotient near a half
            xf = x.float()
            fast = torch.clamp(torch.round(xf * (1.0 / ps)), -127, 127)
            flips = int((fast.to(torch.int8) != xq).sum())
            assert flips > 0, "K2: the code check passes a planted fault"
            planted = (f"; planted faults fail it (the last K step dropped: "
                       f"{wrong:.2%} of the elements; codes from x * (1 / "
                       f"s) alone: {flips} codes)")
            del short, xf, fast
        out = im.int8_linear(x, w8, sw, bias)
        ref = im.int8_linear_plain(x, w8, sw, bias)
        torch.cuda.synchronize()
        assert out.dtype == x.dtype and out.shape == (m, n)
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                                   atol=1e-6, msg=lambda s: f"K2 {name}: {s}")
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log(f"[K2] {name}: M={m} K={k} N={n} x={dtype} int8/int32 exact, "
            f"max_abs_err={err:.3e}{planted} ok")
        del x, w8, sw, bias, xq, sx, acc, pq, ps, pacc, out, ref
    return worst, rows_worst


def _max_diff(a, b) -> float:
    """max |a - b| of two int8 or fp32 tensors, in fp64 (0.0 when empty)."""
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# (name, (B, H, Sq, Skv, D), activation dtype, int8 P.V tiers): the shapes
# that the int8 attention tiers' prologue meets, on head-split views of
# [B, S, H*D] projections as the DiT hands them over: K3q's (13B tier d,
# LTX-2B), K4's (Wan, 13B tier a) and K1f's int8 variants (fp32)
PROLOGUE_SHAPES = [
    ("13B pass 1 self", LTX13B_SELF[0], "bf16", (False, True)),
    ("13B pass 2 self", LTX13B_SELF[1], "bf16", (False, True)),
    ("13B pass 2 cross", LTX13B_CROSS[1], "bf16", (False, True)),
    ("LTX-2B self", LTX2B_SELF, "bf16", (False,)),
    ("Wan self", WAN_SELF, "bf16", (True, False)),
    ("Wan cross", WAN_CROSS, "bf16", (True,)),
    ("LTX-2B self fp32", (3, 32, 1024, 1024, 64), "fp32", (False, True)),
    ("CLIP self d=80", CLIP_SELF, "bf16", (True, False)),
]
PROLOGUE_PLANTED = "13B pass 2 self"


def phase_prologue(gen):
    """The int8 tiers' quantize prologue on the card: Q's codes and scales
    in every tier and the QK tier's per-row K codes and scales come from
    K2's row kernel on the prologue's contract, one launch each, and must
    equal the plain torch ops bit for bit (so K4's and K3q's results do
    not move); the QK+PV tier's per-block K and per-channel V stay plain
    torch. A planted fault (Q's scale times the unfolded factors) must
    fail the check. Returns the largest difference of a code or a scale
    from the plain ops."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    worst = 0.0
    for name, (b, h, sq, skv, d), dtype, tiers in PROLOGUE_SHAPES:
        q, k, v = (_heads(b, h, n, d, gen, True) for n in (sq, skv, skv))
        if dtype == "fp32":
            q, k, v = (t.float() for t in (q, k, v))
        q[0, 0, 1] = 0                     # the 1e-6 floor
        for pv in tiers:
            before = fa.int8_prologue.kernel_launches
            ops = fa.int8_prologue(q, k, v, pv_int8=pv)
            launched = fa.int8_prologue.kernel_launches - before
            plain = fa.int8_prologue_plain(q, k, v, pv_int8=pv)
            torch.cuda.synchronize()
            assert launched == (1 if pv else 2), (name, pv, launched)
            for field in ("q8", "q_scale", "k8", "k_scale", "v", "v_scale"):
                a, b_ = getattr(ops, field), getattr(plain, field)
                if a is not None and b_ is not None:
                    worst = max(worst, _max_diff(a, b_))
                assert (a is None and b_ is None) or torch.equal(a, b_), \
                    f"prologue {name} ({'QK+PV' if pv else 'QK'}): {field}"
            planted = ""
            if name == PROLOGUE_PLANTED and not pv:
                amax = q.float().abs().amax(-1).clamp(min=1e-6)
                c = d ** -0.5 * fa.LOG2E
                bad = (amax * fa.INV127_F32) * c
                rows = int((bad != ops.q_scale).sum())
                assert rows > 0, "prologue: the check passes a planted fault"
                planted = (f"; a planted fault (Q's scale times the "
                           f"unfolded factors) fails it in {rows} rows")
            log(f"[prologue] {name} B={b} H={h} Sq={sq} Skv={skv} D={d} "
                f"{dtype} {'QK+PV' if pv else 'QK'} tier: {launched} "
                f"launches, codes and scales equal the plain ops{planted} ok")
            del ops, plain
        del q, k, v
        torch.cuda.empty_cache()
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
    stepping the online softmax by the kernel's 128-row tile, the same
    math, where only fp32 summation order and exp2f's approximation
    differ: every element within int8_tile_bound, the mean within
    K4_TILE_MEAN_REL of the mean |output|; with ``plant``, two planted
    faults (the last q tile zeroed, one channel without its v scale or
    doubled) must fail that check; (b) stepping by JAX's kv block, where
    P is quantized against other running maxima: every element within
    int8_tile_bound (the kernel against the tile-stepped plain version)
    plus int8_order_bound (the tile-stepped against the block-stepped
    one, derived for the P codes' order), the root mean square of the
    ratio within K4_ORDER_RMS (a fault spread inside the bound), the mean
    within K4_BLOCK_MEAN, and the planted faults must fail it too; (c)
    where it is not too costly, both against exact fp32 attention: the
    kernel may not add error to the tier's own. Returns the max abs error
    of (a)."""
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
    faults = []
    if plant:
        zeroed = kern.clone()
        zeroed[:, :, (sq - 1) // 128 * 128:] = 0
        dropped = kern.clone()
        c_scale = ops.v_scale[:, :, 5, None] if pv_int8 else 0.5
        dropped[..., 5] = (kern[..., 5].float() / c_scale).to(kern.dtype)
        faults = [("last q tile zeroed", zeroed),
                  ("channel 5 scale dropped", dropped)]
    planted = []
    for fault, out in faults:
        f_ratio, f_rel = _k4_tile_check(out, tile, bound)
        assert f_ratio > 1.0 and f_rel >= fa.K4_TILE_MEAN_REL, \
            f"K4 {name}: the check passes a planted fault ({fault})"
        planted.append(f"{fault}: {f_ratio:.1f} of the bound, mean "
                       f"{f_rel:.2e}")
    del tile
    plain = fa.int8_attention_plain(ops, *segs, out_dtype=q.dtype, **kw)
    bound += fa.int8_order_bound(ops, plain, *segs, **kw)
    diff = (kern.float() - plain.float()).abs()
    err_j, mean_j = float(diff.max()), float(diff.mean())
    diff /= bound
    ratio_j, rms_j = float(diff.max()), float(diff.square().mean().sqrt())
    del diff
    assert ratio_j <= 1.0 and rms_j <= fa.K4_ORDER_RMS \
        and mean_j < K4_BLOCK_MEAN, \
        (f"K4 {name}: vs plain at JAX's block max {err_j:.3e}, {ratio_j:.3f}"
         f" of the tile + order bounds (root mean square {rms_j:.4f}), "
         f"mean {mean_j:.3e}")
    planted_j = []
    for fault, out in faults:
        f_diff = (out.float() - plain.float()).abs()
        f_ratio, f_mean = float((f_diff / bound).max()), float(f_diff.mean())
        assert f_ratio > 1.0, \
            f"K4 {name}: the block check passes a planted fault ({fault})"
        planted_j.append(f"{fault}: {f_ratio:.1f}")
        del f_diff
    del faults, bound
    if planted:
        planted = ("; planted faults fail it (" + "; ".join(planted)
                   + "), and the block check ("
                   + "; ".join(planted_j) + " of its bound)")
    else:
        planted = ""
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
    kind = fa.mask_kind(skv, kv_valid, segments=seg is not None,
                        causal=causal)
    log(f"[K4] {name} ({tier}): B={b} H={h} Sq={sq} Skv={skv} D={d} "
        f"mask kind {kind} kv_block={ops.kv_block}: vs plain at the "
        f"kernel's tile max "
        f"{err:.3e}, {ratio:.3f} of the bound, mean {rel:.3e} of the mean "
        f"|output|{planted}; at JAX's block max {err_j:.3e}, {ratio_j:.3f} "
        f"of the tile + order bounds (root mean square {rms_j:.4f}), mean "
        f"{mean_j:.3e}{msg} ok")
    return err


def phase_k4(gen):
    """Both tiers at the Wan t2v, Wan i2v and 13B shapes and at the
    edges; returns the worst error per tier."""
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
    # the i2v-14B path under auto
    for pv in (True, False):
        errs[pv].append(_k4_case("i2v image cross-attention",
                                 *WAN_I2V_IMAGE_CROSS, pv_int8=pv,
                                 gen=gen, packed=True, plant=True))
        errs[pv].append(_k4_case("i2v text cross-attention",
                                 *WAN_I2V_TEXT_CROSS, pv_int8=pv,
                                 gen=gen, packed=True,
                                 seg=_cross_segments))
        torch.cuda.empty_cache()
    # the wrapper: prologue + kernel, output in q's head-split layout
    q, k, v = (_heads(2, 12, 4000, 128, gen, True) for _ in range(3))
    out = fa.flash_attention_int8(q, k, v)
    ref = fa.int8_attention_cuda(fa.int8_prologue(q, k, v))
    assert out.stride() == q.stride() and torch.equal(out, ref)
    log("[K4] wrapper: prologue + kernel in q's head-split layout ok")
    return max(errs[True]), max(errs[False])


def phase_d80(gen):
    """K1, K3, K4, K3q and K1f (its five variants) at CLIP's head dim of
    80 (the D=128 layout, 80 columns loaded and stored, the rounded
    denominator of JAX's ones column): CLIP's self-attention B=1 H=16 S=257 on head-split views of a
    [B, S, H*D] projection, as CLIP's call hands them over (no padding:
    the tail instance masks the last tile), with the planted faults, then
    every mask kind at the tile edges. Returns the worst error of K1, K4
    (both tiers), K3q and K1f (every variant)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    k1 = [_k1_case("CLIP d=80 self-attention", *CLIP_SELF, packed=True,
                   plant=True, gen=gen)[0]]
    for sq, skv in ((127, 255), (128, 256), (130, 1)):
        k1.append(_k1_case("d=80 tile edges", 1, 2, sq, skv, 80, gen=gen)[0])
    for kv_valid in (500, 384, 0):
        k1.append(_k1_case("d=80 kv_valid", 1, 2, 512, 512, 80,
                           kv_valid=kv_valid, gen=gen)[0])
    k1.append(_k1_case("d=80 causal", 1, 2, 512, 512, 80, causal=True,
                       gen=gen)[0])
    k1.append(_k1_case("d=80 segments over three kv tiles", 3, 4, 700, 300,
                       80, seg=_cross_segments, gen=gen)[0])
    _k3_case("CLIP d=80 self-attention", *CLIP_SELF, packed=True, plant=True,
             gen=gen)
    _k3_case("d=80 segments", 3, 4, 700, 300, 80, seg=_cross_segments,
             gen=gen)
    k4 = []
    for pv in (True, False):
        k4.append(_k4_case("CLIP d=80 self-attention", *CLIP_SELF,
                           pv_int8=pv, packed=True, plant=True, gen=gen))
        k4.append(_k4_case("d=80 ragged S, kv_valid", 2, 4, 1000, 1000, 80,
                           pv_int8=pv, kv_valid=777, gen=gen))
        k4.append(_k4_case("d=80 text segments", 3, 4, 700, 300, 80,
                           pv_int8=pv, seg=_cross_segments, gen=gen))
        k4.append(_k4_case("d=80 causal", 1, 2, 333, 333, 80, pv_int8=pv,
                           causal=True, gen=gen))
    torch.cuda.empty_cache()
    # K3q and K1f at d=80 (the D=128 layout, since ROADMAP F7's repair)
    k3q = [_k3q_case("CLIP d=80 self-attention", *CLIP_SELF, packed=True,
                     plant=True, gen=gen)]
    for sq, skv in ((127, 255), (128, 256), (130, 1)):
        k3q.append(_k3q_case("d=80 tile edges", 1, 2, sq, skv, 80, gen=gen))
    k3q.append(_k3q_case("d=80 kv_valid", 1, 2, 512, 512, 80, kv_valid=384,
                         gen=gen))
    k3q.append(_k3q_case("d=80 causal", 1, 2, 333, 333, 80, causal=True,
                         gen=gen))
    k3q.append(_k3q_case("d=80 text segments", 3, 4, 700, 300, 80,
                         seg=_cross_segments, gen=gen))
    k1f = []
    for variant in fa.K1F_VARIANTS:
        bound = LTX13B_BOUND if "bounded" in variant else None
        k1f.append(_k1f_case("CLIP d=80 self-attention", *CLIP_SELF,
                             gen=gen, variant=variant, packed=True,
                             bound=bound, plant=True))
        for sq, skv in ((63, 127), (64, 64), (130, 1)):
            k1f.append(_k1f_case("d=80 tile edges", 1, 2, sq, skv, 80,
                                 gen=gen, variant=variant, bound=bound))
        k1f.append(_k1f_case("d=80 kv_valid", 1, 2, 300, 300, 80, gen=gen,
                             variant=variant, kv_valid=200, bound=bound))
        k1f.append(_k1f_case("d=80 causal", 1, 2, 200, 200, 80, gen=gen,
                             variant=variant, causal=True, bound=bound))
        k1f.append(_k1f_case("d=80 text segments", 3, 4, 300, 150, 80,
                             gen=gen, variant=variant, seg=_cross_segments,
                             bound=bound))
    torch.cuda.empty_cache()
    return max(k1), max(k4), max(k3q), max(k1f)


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
    """The exact kernels (K1, K3, K6) against their plain versions on
    the same bf16 operands. The two differ by fp32 summation order,
    exp2f's approximation and the final bf16 rounding, so every element
    must lie within two bf16 ulps of the plain version (2**-7 relative)
    plus 2**-9 of its largest output (for outputs near 0, where the
    summands cancel). Returns (largest |difference| / bound, max abs
    error)."""
    import torch

    diff = (kern.float() - plain.float()).abs()
    bound = plain.float().abs() * 2.0 ** -7 \
        + float(plain.float().abs().max()) * 2.0 ** -9
    # an all-zero plain output (no key in sight) allows no difference
    bound = bound.clamp(min=torch.finfo(torch.float32).tiny)
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
    plain = torch.cat([        # one batch row and a few heads at a time
        _by_heads(lambda a, b_, c: fa.bounded_attention_plain(
            a, b_, c, *(s_[i:i + 1] if s_ is not None else None
                        for s_ in segs), **kw),
            q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(b)])
    ratio, err = _exact_check(kern, plain)
    assert ratio <= 1.0, (f"K3 {name}: max_abs_err {err:.3e}, {ratio:.3f} of "
                          "the bound")
    planted = _exact_planted(f"K3 {name}", kern, plain, 1) if plant else ""
    if seg:
        assert float(kern[0, :, 17].float().abs().max()) == 0.0, \
            f"K3 {name}: a row with no valid key must be 0"
    kind = fa.mask_kind(skv, kv_valid, segments=seg is not None,
                        causal=causal)
    log(f"[K3] {name}: B={b} H={h} Sq={sq} Skv={skv} D={d} mask kind {kind} "
        f"bound={bound} max_abs_err={err:.3e}, {ratio:.3f} of the "
        f"bound{planted} ok")
    return err


def phase_k3(gen):
    """K3 on K1's block at both head dims and every mask kind: the 13B
    shapes, the LTX-2B self-attention shape (D=64, the producer layout and
    its rounded denominator), and ragged, kv_valid, causal and segment
    cases."""
    import torch

    errs = []
    for i, shape in enumerate(LTX13B_SELF):
        errs.append(_k3_case(f"13B self-attention pass {i + 1}", *shape,
                             gen=gen, packed=True, plant=i == 1))
        torch.cuda.empty_cache()
    for i, shape in enumerate(LTX13B_CROSS):
        errs.append(_k3_case(f"13B cross-attention pass {i + 1}", *shape,
                             gen=gen, packed=True, seg=_cross_segments))
    errs.append(_k3_case("LTX-2B self-attention", *LTX2B_SELF, gen=gen,
                         packed=True, plant=True))
    torch.cuda.empty_cache()
    errs.append(_k3_case("D=64 ragged S, kv_valid", 2, 4, 1000, 1000, 64,
                         gen=gen, kv_valid=777, bound=20.0))
    errs.append(_k3_case("D=64 no mask code", 2, 4, 1024, 1024, 64, gen=gen,
                         bound=20.0))
    errs.append(_k3_case("D=64 within the ring", 1, 2, 384, 384, 64,
                         gen=gen, bound=20.0))
    errs.append(_k3_case("D=64 text segments", 3, 4, 700, 300, 64, gen=gen,
                         seg=_cross_segments, bound=20.0))
    errs.append(_k3_case("D=128 ragged S", 1, 4, 1000, 1000, 128, gen=gen,
                         bound=20.0))
    errs.append(_k3_case("ragged causal", 1, 2, 333, 333, 128, gen=gen,
                         causal=True, bound=20.0))
    errs.append(_k3_case("D=64 causal", 1, 2, 700, 700, 64, gen=gen,
                         causal=True, bound=20.0))
    torch.cuda.empty_cache()
    return max(errs)


def _k3q_case(name, b, h, sq, skv, d, *, gen, bound=LTX13B_BOUND,
              packed=False, seg=None, causal=False, kv_valid=None,
              plant=False):
    """K3q against its plain version on the same prologue operands. With
    per-row k scales and no running max nothing depends on a kv block, so
    the two differ only by fp32 summation order, exp2's approximation and
    the bf16 roundings: K3's check (``_exact_check``). One q row is scaled
    so that its scores lie over the bound."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    q[0, 0, min(3, sq - 1)] *= 60
    segs = seg(b, sq, skv) if seg else (None, None)
    kw = dict(causal=causal, kv_valid=kv_valid, score_bound=bound)
    ops = fa.int8_prologue(q, k, v, pv_int8=False)
    before = kernel_counts()
    kern = fa.int8_attention_cuda(ops, *segs, **kw)
    torch.cuda.synchronize()
    after = kernel_counts()
    moved = {k_: after[k_] - before[k_] for k_ in after
             if after[k_] != before[k_]}
    want = {"K3q": 1, "K3qd80": 1} if d == 80 else {"K3q": 1}
    assert moved == want, f"K3q {name}: launch counts moved {moved}"
    assert torch.isfinite(kern.float()).all(), f"K3q {name}: non-finite"
    plain = fa.int8_attention_plain(ops, *segs, out_dtype=q.dtype, **kw)
    ratio, err = _exact_check(kern, plain)
    assert ratio <= 1.0, (f"K3q {name}: max_abs_err {err:.3e}, {ratio:.3f} "
                          "of the bound")
    planted = _exact_planted(f"K3q {name}", kern, plain, 1) if plant else ""
    if seg:
        assert float(kern[0, :, 17].float().abs().max()) == 0.0, \
            f"K3q {name}: a row with no valid key must be 0"
    kind = fa.mask_kind(skv, kv_valid, segments=seg is not None,
                        causal=causal)
    log(f"[K3q] {name}: B={b} H={h} Sq={sq} Skv={skv} D={d} mask kind "
        f"{kind} bound={bound} max_abs_err={err:.3e}, {ratio:.3f} of the "
        f"bound{planted} ok")
    return err


def phase_k3q(gen):
    """K3q at tier (d)'s shapes (the 13B self- and cross-attention of both
    passes), the LTX-2B self-attention shape, and ragged, kv_valid, causal
    and segment cases at both head dims: every mask kind. Then the
    wrapper: prologue + kernel, in q's layout."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    errs = []
    for i, shape in enumerate(LTX13B_SELF):
        errs.append(_k3q_case(f"13B self-attention pass {i + 1}", *shape,
                              gen=gen, packed=True, plant=i == 1))
        torch.cuda.empty_cache()
    for i, shape in enumerate(LTX13B_CROSS):
        errs.append(_k3q_case(f"13B cross-attention pass {i + 1}", *shape,
                              gen=gen, packed=True, seg=_cross_segments))
    errs.append(_k3q_case("LTX-2B self-attention", *LTX2B_SELF, gen=gen,
                          packed=True, plant=True))
    torch.cuda.empty_cache()
    errs.append(_k3q_case("D=64 ragged S, kv_valid", 2, 4, 1000, 1000, 64,
                          gen=gen, kv_valid=777, bound=20.0))
    errs.append(_k3q_case("D=64 no mask code", 2, 4, 1024, 1024, 64,
                          gen=gen, bound=20.0))
    errs.append(_k3q_case("D=64 text segments", 3, 4, 700, 300, 64, gen=gen,
                          seg=_cross_segments, bound=20.0))
    errs.append(_k3q_case("D=128 ragged S", 1, 4, 1000, 1000, 128, gen=gen,
                          bound=20.0))
    errs.append(_k3q_case("ragged causal", 1, 2, 333, 333, 128, gen=gen,
                          causal=True, bound=20.0))
    errs.append(_k3q_case("D=64 causal", 1, 2, 700, 700, 64, gen=gen,
                          causal=True, bound=20.0))
    q, k, v = (_heads(2, 12, 4000, 128, gen, True) for _ in range(3))
    out = fa.flash_attention_int8(q, k, v, pv_int8=False,
                                  score_bound=LTX13B_BOUND)
    ref = fa.int8_attention_cuda(fa.int8_prologue(q, k, v, pv_int8=False),
                                 score_bound=LTX13B_BOUND)
    assert out.stride() == q.stride() and torch.equal(out, ref)
    log("[K3q] wrapper: prologue + kernel in q's head-split layout ok")
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
            f"kernel) {result['production_ms']:.3f} ms "
            f"({ms / result['production_ms']:.3f}x), bound {bnd[0]:.3f} "
            f"ms ({bnd[1]}), scaled_dot_product_attention {lib:.3f} ms; "
            + _vs_accepted(times, f"K8 nsub {nsub}"))
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

    from ltx_video_gpupoor_tpu_torch.ops import _lib
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr

    lib_k = _lib.library()
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

    # the tensor-core body's tail instances
    before = rr.ring_attention_rdma.launches_tc
    for b, h, s_, d, p in RING_TAIL:
        q, k, v = (_heads(b, h, s_, d, gen, True) for _ in range(3))
        shards = [t.chunk(p, dim=2) for t in (q, k, v)]
        plain = torch.cat(rr.ring_attention_plain(*shards), dim=2)
        for call in range(2):
            out = rr.ring_attention_rdma_sharded(q, k, v, p)
            torch.cuda.synchronize()
            ratio, err = _exact_check(out, plain)
            assert ratio <= 1.0, (b, h, s_, d, p, call, err, ratio)
        log(f"[K7] tensor-core body, tail instance B={b} H={h} S={s_} D={d} "
            f"p={p} (S/p={s_ // p}): max_abs_err={err:.3e}, {ratio:.3f} of "
            "the bound against the plain ring, two calls on one workspace ok")
    assert rr.ring_attention_rdma.launches_tc == before + 2 * len(RING_TAIL)

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
        # softmax state through device memory: every rank stores it after
        # each step but the last and loads it before each but the first
        state = 4 * p * 2 * (p - 1) * lib_k.k7_ring_state_floats(
            0, b * h, s_ // p, d)
        log(f"[K7] tensor-core body B={b} H={h} S={s_} D={d} p={p}: "
            f"max_abs_err={err:.3e}, {ratio:.3f} of the bound against the "
            f"plain ring, {ratio_k1:.3f} against one K1 call on the joined "
            f"tensors, two calls on one workspace{planted} ok")
        log(f"[time] K7 ring attention p={p}: kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain ring {pl:.3f} ms, one "
            f"K1 call on the joined tensors {k1_ms:.3f} ms ({ms / k1_ms:.3f}x"
            f"), bound {bnd[0]:.3f} ms ({bnd[1]}), "
            f"scaled_dot_product_attention {lib:.3f} ms; softmax state "
            f"{state / 1e9:.3f} GB through device memory "
            f"({state / PEAK_BYTES * 1e3:.3f} ms at the memory rate); "
            + _vs_accepted(times, f"K7 p={p}"))
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
    cases += [("ragged M=240, N=200, 3 groups, no bias", 240, 4096, 200, 3,
               False),
              ("K=40, off a 16-multiple", 64, 40, 96, 2, True),
              ("K=32784, past the registers", 64, 32784, 256, 2, False)]
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
    worst = max(worst, _k5_fp32_case(gen))
    torch.cuda.empty_cache()
    return worst


def _k5_fp32_case(gen):
    """K5's fp32 row-kernel instance (FP32_POLICY) against its plain
    version at the 13B pass 1 q/k/v shape: row scales and int8 codes
    (rsqrtf may round the norm the other way in a row, which moves a code
    by one: at most 1e-4 of them), the output to 1e-2 relative; a planted
    fault (two groups' rows swapped) must fail it."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.tools._bench_util import graph_ms

    m, k, n, g = 3840, 4096, 12288, 16
    x, scale, shift, w8, sw, b = _k5_operands(m, k, n, g, gen)
    x, scale, shift = x.float(), scale.float(), shift.float()
    kw = dict(rows_per_group=m // g, eps=1e-6)
    before = fp.norm_mod_int8_matmul.launches
    out = fp.norm_mod_int8_matmul(x, scale, shift, w8, sw, b, **kw)
    hq, _ = fp.norm_mod_quantize_rows(x, scale, shift, **kw)
    torch.cuda.synchronize()
    assert fp.norm_mod_int8_matmul.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (m, n)

    def agrees(p_scale, p_shift):
        pq, _ = fp.norm_mod_quantize_plain(x, p_scale, p_shift, **kw)
        flips = float((hq != pq).float().mean())
        ref = fp.norm_mod_int8_matmul_plain(x, p_scale, p_shift, w8, sw, b,
                                            **kw)
        err = float((out - ref).abs().max())
        close = torch.allclose(out, ref, rtol=1e-2, atol=1e-6)
        return flips <= 1e-4 and close, flips, err

    ok, flips, err = agrees(scale, shift)
    assert ok, f"K5 fp32: codes differ in {flips:.2e}, max err {err:.3e}"
    bad, bflips, _ = agrees(scale.roll(1, 0), shift.roll(1, 0))
    assert not bad, "K5 fp32: the check passes a planted fault"
    rows = graph_ms(lambda: fp.norm_mod_quantize_rows(x, scale, shift, **kw))
    rows_bound = (m * k * 5 + 2 * g * k * 4 + 4 * m) / PEAK_BYTES * 1e3
    log(f"[K5] fp32 instance, pass 1 qkv: M={m} K={k} N={n} groups={g}: "
        f"int8 codes differ in {flips:.2e} of the elements, "
        f"max_abs_err={err:.3e}; a planted fault (groups' rows swapped) "
        f"fails it (codes differ in {bflips:.2e}); its row kernel "
        f"{rows:.4f} ms in a CUDA graph, memory bound {rows_bound:.4f} ms "
        f"({rows / rows_bound:.2f}x) ok")
    return err


# --------------------------------------------------------------------------
# phase 5g: K1f, the fp32 attention kernel
# --------------------------------------------------------------------------

def _fp32_heads(b, h, s, d, gen, packed):
    return _heads(b, h, s, d, gen, packed).float()


def _k1f_check(kern, plain):
    """(largest |kern - plain| / (atol + rtol |plain|), max abs error)."""
    diff = (kern - plain).abs()
    return (float((diff / (K1F_ATOL + K1F_RTOL * plain.abs())).max()),
            float(diff.max()))


def _k1f_planted(name, kern, plain):
    """Two planted faults must fail ``_k1f_check``: the last 64-row q tile
    zeroed, one head scaled by 1 + 2**-6."""
    n = kern.shape[2]
    zeroed = kern.clone()
    zeroed[:, :, (n - 1) // 64 * 64:] = 0
    scaled = kern.clone()
    scaled[:, 1] *= 1 + 2.0 ** -6
    found = []
    for fault, out in (("last q tile zeroed", zeroed),
                       ("a head scaled by 1 + 2**-6", scaled)):
        ratio, _ = _k1f_check(out, plain)
        assert ratio > 1.0, f"{name}: the check passes a planted fault ({fault})"
        found.append(f"{fault}: {ratio:.1f} of the tolerance")
    return "; planted faults fail it (" + "; ".join(found) + ")"


def _k1f_case(name, b, h, sq, skv, d, *, gen, variant="exact", packed=False,
              seg=None, causal=False, kv_valid=None, bound=None, plant=False):
    """K1f against its plain version on the same fp32 operands (for the
    int8 variants: the same prologue operands), at atol = rtol = 2e-5;
    the QK+PV variant against the plain version stepped by K1f's 64-row
    kv tile (the same P codes) within int8_tile_bound. Each launch must
    move K1f's counter for its variant and no other kernel's."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    q, k, v = (_fp32_heads(b, h, n, d, gen, packed) for n in (sq, skv, skv))
    if bound is not None:
        q[0, 0, min(3, sq - 1)] *= 60      # a row over the bound
    segs = seg(b, sq, skv) if seg else (None, None)
    kw = dict(causal=causal, kv_valid=kv_valid)
    counts = dict(fa.flash_attention_fp32.by_variant)
    others = (fa.flash_attention.launches, fa.flash_attention.bounded_launches,
              fa.flash_attention_int8.launches,
              fa.flash_attention_int8.bounded_launches)
    ops = None
    if variant in ("exact", "bounded"):
        kern = fa.flash_attention(q, k, v, *segs, score_bound=bound, **kw)
    else:
        ops = fa.int8_prologue(q, k, v, pv_int8=variant == "pv8")
        kern = fa.int8_attention_fp32(ops, *segs, score_bound=bound, **kw)
    torch.cuda.synchronize()
    counts = {key: fa.flash_attention_fp32.by_variant[key] - n
              for key, n in counts.items()}
    assert counts == {key: int(key == variant) for key in counts}, \
        f"K1f {name}: launches by variant {counts}, wanted one {variant}"
    assert others == (fa.flash_attention.launches,
                      fa.flash_attention.bounded_launches,
                      fa.flash_attention_int8.launches,
                      fa.flash_attention_int8.bounded_launches), \
        f"K1f {name}: a bf16 kernel counted the launch"
    assert kern.dtype == torch.float32 and torch.isfinite(kern).all(), \
        f"K1f {name}: not finite fp32"
    if variant == "pv8":
        plain = fa.int8_attention_plain(ops, *segs, block_kv=fa.K1F_TILE_KV,
                                        **kw)
        bnd = fa.int8_tile_bound(ops, plain, *segs, **kw)
        diff = (kern - plain).abs()
        ratio, err = float((diff / bnd).max()), float(diff.max())
        # no key in sight: the plain output is 0 and so must the kernel's be
        rel = float(diff.mean()) / max(float(plain.abs().mean()), 1e-30)
        assert ratio <= 1.0 and rel < fa.K4_TILE_MEAN_REL, \
            (f"K1f {name}: max {err:.3e}, {ratio:.3f} of int8_tile_bound, "
             f"mean {rel:.3e}")
        what = f"{ratio:.3f} of int8_tile_bound, mean {rel:.2e} of |output|"
    else:
        if ops is None:
            fn = (fa.reference_attention if bound is None else
                  lambda *a, **k_: fa.bounded_attention_plain(
                      *a, score_bound=bound, **k_))
            plain = torch.cat([_by_heads(lambda a, b_, c: fn(
                a, b_, c, *(s_[i:i + 1] if s_ is not None else None
                            for s_ in segs), **kw),
                q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(b)])
        else:
            plain = fa.int8_attention_plain(ops, *segs, score_bound=bound,
                                            **kw)
        ratio, err = _k1f_check(kern, plain)
        assert ratio <= 1.0, (f"K1f {name}: max_abs_err {err:.3e}, "
                              f"{ratio:.3f} of atol + rtol |plain|")
        what = f"{ratio:.3f} of atol + rtol |plain| (2e-5 each)"
    planted = _k1f_planted(f"K1f {name}", kern, plain) if plant else ""
    if seg:
        assert float(kern[0, :, 17].abs().max()) == 0.0, \
            f"K1f {name}: a row with no valid key must be 0"
    kind = fa.mask_kind(skv, kv_valid, segments=seg is not None,
                        causal=causal)
    log(f"[k1f] {name} ({variant}): B={b} H={h} Sq={sq} Skv={skv} D={d} "
        f"mask kind {kind}{'' if bound is None else f' bound={bound}'} "
        f"max_abs_err={err:.3e}, {what}{planted} ok")
    return err


def _k1f_hp_case(name, b, s, heads, d, *, gen, kv_valid=None):
    """K1f through flash_attention_hp: fp32 ``[B, S, H*D]`` slices of a
    fused q/k/v projection read in place, against the plain version."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    qkv = torch.randn(b, s, 3 * heads * d, generator=gen, device="cuda")
    q, k, v = qkv.chunk(3, dim=-1)
    before = fa.flash_attention_fp32.by_variant["exact"]
    k6 = fa.flash_attention_hp.launches
    kern = fa.flash_attention_hp(q, k, v, heads=heads, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert fa.flash_attention_fp32.by_variant["exact"] == before + 1
    assert fa.flash_attention_hp.launches == k6, "K6 counted an fp32 call"
    assert kern.shape == q.shape and kern.dtype == torch.float32
    plain = fa.flash_attention_hp_plain(q, k, v, heads=heads,
                                        kv_valid=kv_valid)
    ratio, err = _k1f_check(kern, plain)
    assert ratio <= 1.0, f"K1f hp {name}: {err:.3e}, {ratio:.3f}"
    log(f"[k1f] head-packed {name}: B={b} S={s} H={heads} D={d} "
        f"kv_valid={kv_valid} max_abs_err={err:.3e}, {ratio:.3f} of "
        f"atol + rtol |plain| ok")
    return err


def phase_k1f(gen):
    """K1f at the shapes FP32_POLICY gives it (the [fp32] request's
    LTX-2B 256x256x9 self- and cross-attention; the headline LTX-2B and
    13B shapes), in each variant and mask kind; then attention() in each
    tier on fp32 operands must launch what ops.attention.kernel_route
    names."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import attention as at
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    errs, pv8_errs = [], []
    b, h, s, _, d = LTX2B_SELF
    errs.append(_k1f_case("LTX-2B self-attention", b, h, s, s, d, gen=gen,
                          packed=True, plant=True))
    torch.cuda.empty_cache()
    errs.append(_k1f_case("LTX-2B cross-attention, text segments", b, h, s,
                          256, d, gen=gen, packed=True,
                          seg=_cross_segments))
    sr = FP32_REQUEST_TOKENS
    errs.append(_k1f_case("[fp32] request self-attention", b, h, sr, sr, d,
                          gen=gen, packed=True))
    errs.append(_k1f_case("[fp32] request cross-attention", b, h, sr, 256, d,
                          gen=gen, packed=True, seg=_cross_segments))
    b13, h13, s13, _, d13 = LTX13B_SELF[0]
    errs.append(_k1f_case("13B pass 1 self-attention", b13, h13, s13, s13,
                          d13, gen=gen, packed=True, plant=True))
    errs.append(_k1f_case("13B pass 1 cross-attention", *LTX13B_CROSS[0],
                          gen=gen, packed=True, seg=_cross_segments))
    errs.append(_k1f_case("LTX-2B self-attention", b, h, s, s, d, gen=gen,
                          packed=True, variant="bounded",
                          bound=LTX13B_BOUND, plant=True))
    errs.append(_k1f_case("13B pass 1 self-attention", b13, h13, s13, s13,
                          d13, gen=gen, packed=True, variant="bounded",
                          bound=LTX13B_BOUND))
    for variant, bound in (("qk8", None), ("qk8_bounded", LTX13B_BOUND),
                           ("pv8", None)):
        into = pv8_errs if variant == "pv8" else errs
        into.append(_k1f_case("13B pass 1 self-attention", b13, h13, s13,
                              s13, d13, gen=gen, packed=True,
                              variant=variant, bound=bound,
                              plant=variant == "qk8"))
        into.append(_k1f_case("LTX-2B cross-attention, text segments", b, h,
                              s, 256, d, gen=gen, packed=True,
                              seg=_cross_segments, variant=variant,
                              bound=bound))
        torch.cuda.empty_cache()
    errs.append(_k1f_hp_case("13B pass 1", 1, s13, h13, d13, gen=gen))
    errs.append(_k1f_hp_case("LTX-2B", b, s, h, d, gen=gen))
    errs.append(_k1f_hp_case("ragged, kv_valid", 2, 1000, 4, 64, gen=gen,
                             kv_valid=777))
    # every mask kind at the edges of the tiles (128 q rows a block; kv
    # tiles of 64 rows, 32 at D=128 in the fp32-score variants), both head
    # dims
    for dd in (64, 128):
        for variant, bound in (("exact", None), ("bounded", 20.0),
                               ("qk8", None), ("pv8", None)):
            for sq, skv, kv_valid, causal, seg in (
                    (127, 255, None, False, None), (130, 1, None, False, None),
                    (512, 512, 300, False, None), (512, 512, 384, False, None),
                    (512, 512, 0, False, None), (333, 333, None, True, None),
                    (700, 300, None, False, _cross_segments),
                    (129, 96, None, False, None), (64, 33, None, False, None),
                    (256, 256, 96, False, None), (160, 65, None, True, None),
                    (257, 128, 127, False, None)):
                (pv8_errs if variant == "pv8" else errs).append(_k1f_case(
                    "edges", 3 if seg else 1, 2, sq, skv, dd, gen=gen,
                    variant=variant, bound=bound, kv_valid=kv_valid,
                    causal=causal, seg=seg))
    torch.cuda.empty_cache()
    # the tiers: attention() on fp32 operands launches what kernel_route
    # names, and no bf16 kernel
    routes = []
    for mode in ("auto", "pallas", "pallas_hp", "pallas_int8",
                 "pallas_int8pv"):
        for dd in (64, 128):
            for bound in (None, LTX13B_BOUND):
                q, k, v = (_fp32_heads(1, 2, 256, dd, gen, False)
                           for _ in range(3))
                want = at.kernel_route(mode, dtype=torch.float32,
                                       head_dim=dd, score_bound=bound)
                before = dict(fa.flash_attention_fp32.by_variant)
                at.attention(q, k, v, mode=mode, score_bound=bound)
                torch.cuda.synchronize()
                moved = [key for key, n in
                         fa.flash_attention_fp32.by_variant.items()
                         if n != before[key]]
                assert [f"K1f {key}" for key in moved] == [want], \
                    (mode, dd, bound, moved, want)
                routes.append(f"{mode}/D{dd}/"
                              f"{'bound' if bound else 'none'}={want}")
    log("[k1f] attention() on fp32 operands launches what kernel_route "
        "names in every tier: " + ", ".join(routes))
    log(f"[k1f] max_abs_err {max(errs):.3e} where held to atol = rtol = "
        f"2e-5 (exact, bounded, int8 QK); {max(pv8_errs):.3e} in the int8 "
        f"QK+PV variant (P codes that round the other way, within "
        f"int8_tile_bound)")
    return max(errs)


def time_k1f(gen, times, info, ex2_per_s):
    """K1f's time at the shapes it serves, beside its plain version, its
    bound (the larger of the split-TF32 products, three TF32 products of
    2*B*H*Sq*Skv*D operations each for each of Q.K^T and P.V at 495
    TFLOP/s, the ex2 floor of one exponential a score, and the bytes of q,
    k, v and the output once), the fp32-FMA figure (the CUDA cores' SMs x
    128 lanes x 2 operations at the highest SM clock that phase_device
    read) and scaled_dot_product_attention on the same fp32 operands. Each
    time is of one call as the path makes it (host included) and, for
    both K1f and the library call, device time in a CUDA graph."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.tools._bench_util import graph_ms

    peak = ex2_per_s / EX2_PER_SM_CLOCK * FP32_LANES_PER_SM * 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, s, _, d = LTX2B_SELF
    b13, h13, s13, _, d13 = LTX13B_SELF[0]
    sr = FP32_REQUEST_TOKENS
    cases = [("K1f self", (b, h, s, s, d), None, None),
             ("K1f cross", (b, h, s, 256, d), _cross_segments, None),
             ("K1f request self", (b, h, sr, sr, d), None, None),
             ("K1f request cross", (b, h, sr, 256, d), _cross_segments,
              None),
             ("K1f 13B pass 1 self", (b13, h13, s13, s13, d13), None, None),
             ("K1f bounded self", (b, h, s, s, d), None, LTX13B_BOUND)]
    for key, (bb, hh, sq, skv, dd), seg, bound in cases:
        q, k, v = (_fp32_heads(bb, hh, n, dd, gen, True)
                   for n in (sq, skv, skv))
        segs = seg(bb, sq, skv) if seg else (None, None)

        def kern_fn():
            return fa.flash_attention(q, k, v, *segs, score_bound=bound)

        kern = cuda_time_ms(kern_fn)
        kern_dev = graph_ms(kern_fn, calls=20 if sq <= sr else 3)

        def plain():
            for i in range(bb):
                sl = [t[i:i + 1] if t is not None else None for t in segs]
                _by_heads(lambda a, b_, c: (
                    fa.reference_attention(a, b_, c, *sl) if bound is None
                    else fa.bounded_attention_plain(a, b_, c, *sl,
                                                    score_bound=bound)),
                    q[i:i + 1], k[i:i + 1], v[i:i + 1])

        plain_ms = cuda_time_ms(plain, reps=3, warmup=1)
        keys = bb * skv if seg is None else int((segs[1] > 0).sum())
        ops = 4 * hh * sq * keys * dd
        nbytes = 4 * hh * dd * (bb * sq * 2 + keys * 2)
        t_tf32 = K1F_TF32_PRODUCTS * ops / PEAK_OPS["tf32"] * 1e3
        t_ex2 = _ex2_ms(hh * sq * keys, ex2_per_s)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_fma = ops / peak * 1e3
        bnd = (max(t_tf32, t_ex2, t_bytes),
               "bytes" if t_bytes > max(t_tf32, t_ex2) else "operations")
        lib = lib_dev = None
        if bound is None:      # no PyTorch call clamps scores
            mask = _key_mask(segs[1]) if seg else None
            lib = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
            lib_dev = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask),
                               calls=20 if sq <= sr else 3)
        times[key] = (kern, plain_ms)
        info[key] = (*bnd, lib)
        log(f"[time] {key} B={bb} H={hh} Sq={sq} Skv={skv} D={dd} fp32: "
            f"kernel {kern:.3f} ms, {kern_dev:.4f} ms in a CUDA graph "
            f"({K1F_TF32_PRODUCTS * ops / kern_dev / 1e9:.1f} TF32 TFLOP/s); "
            f"plain {plain_ms:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}: "
            f"split TF32 {t_tf32:.3f}, ex2 floor {t_ex2:.3f}, bytes "
            f"{t_bytes:.4f}; {bnd[0] / kern_dev:.0%} of it), fp32 FMA "
            f"{t_fma:.3f} ms; scaled_dot_product_attention "
            + ("none (no PyTorch call clamps scores)" if lib is None
               else f"in fp32 {lib:.3f} ms, {lib_dev:.4f} ms in a graph "
                    f"(K1f / SDPA {kern / lib:.2f}x one call, "
                    f"{kern_dev / lib_dev:.2f}x in graphs)"))
        del q, k, v
        torch.cuda.empty_cache()


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

def _vs_accepted(times, key):
    """How the redesigned block's time stands to the accepted one."""
    ms = times[key][0]
    return (f"{key}: {ms:.3f} ms, the accepted mma.sync block "
            f"{ACCEPTED_MS[key]:.3f} ms ({ACCEPTED_MS[key] / ms:.2f}x)")


def _mask_kind_times(q, k, v, as_called_ms):
    """What the mask code costs K1 at a self-attention shape: the call as
    it is, with one key fewer in sight (the tail instance) and with segment
    ids that hide nothing (the general instance)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa

    b, _, s, _ = q.shape
    ones = (torch.ones(b, s, dtype=torch.int32, device="cuda"),) * 2
    tail = cuda_time_ms(lambda: fa.flash_attention(q, k, v, kv_valid=s - 1))
    again = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    general = cuda_time_ms(lambda: fa.flash_attention(q, k, v, *ones))
    return (f"by mask kind: as called ({fa.mask_kind(s)}) "
            f"{as_called_ms:.3f} ms, kv_valid = S - 1 "
            f"({fa.mask_kind(s, s - 1)}) {tail:.3f} ms, as called once more "
            f"{again:.3f} ms, segment ids of ones (general) {general:.3f} ms")


def _host_us_a_launch(fn, calls=200):
    """Host microseconds a call of ``fn`` takes to return (the device work
    is tiny and not waited for inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _key_mask(kv_seg):
    """SDPA's boolean mask for the text keys in sight ([B, 1, 1, Skv]):
    every q row sees a key, so its fully masked rows (NaN) do not arise."""
    return (kv_seg > 0)[:, None, None, :]


def _cross_bound(h, sq, d, kv_seg, qk="bf16", pv="bf16", q_bytes=2,
                 kv_bytes=2, v_bytes=2):
    """A cross-attention's bound for the keys this call's data keeps in
    sight (each batch row its own count): the products over those keys,
    q and the bf16 output once, the kept k and v once."""
    keys = int((kv_seg > 0).sum())
    b = kv_seg.shape[0]
    ops = {}
    for kind in (qk, pv):
        ops[kind] = ops.get(kind, 0) + 2 * h * sq * keys * d
    return bound_ms(ops, b * h * sq * d * (q_bytes + 2)
                    + h * keys * d * (kv_bytes + v_bytes))


def _ex2_ms(n_scores, ex2_per_s):
    """The exponent floor: one ex2 a score on the special-function units."""
    return n_scores / ex2_per_s * 1e3


def _bounded_times(times, info, name, q, k, v, segs, ex2_per_s, k1_ms):
    """K3 and K3q on one shape: kernel, plain version (one batch row and a
    few heads at a time), K3q's prologue apart; bounds: the larger of the
    tensor bound (bf16 products for K3; int8 Q.K^T and bf16 P.V for K3q,
    its int8 q and k, bf16 v and fp32 row scales once) and the ex2 floor
    (one a score in sight). No PyTorch call clamps the scores: no library
    time."""
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.tools._bench_util import graph_ms

    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_seg = segs[1]
    keys = b * skv if kv_seg is None else int((kv_seg > 0).sum())
    ex2 = _ex2_ms(h * sq * keys, ex2_per_s)
    kw = dict(score_bound=LTX13B_BOUND)
    reps = dict(reps=3, warmup=1)

    def by_rows(fn):
        for i in range(b):
            _by_heads(lambda a, b_, c: fn(
                a, b_, c, *(s_[i:i + 1] if s_ is not None else None
                            for s_ in segs)),
                q[i:i + 1], k[i:i + 1], v[i:i + 1])

    k3 = cuda_time_ms(lambda: fa.flash_attention(q, k, v, *segs, **kw))
    k3_plain = cuda_time_ms(lambda: by_rows(
        lambda *a: fa.bounded_attention_plain(*a, **kw)), **reps)
    ops = fa.int8_prologue(q, k, v, pv_int8=False)
    k3q = cuda_time_ms(lambda: fa.int8_attention_cuda(ops, *segs, **kw))
    pro = cuda_time_ms(lambda: fa.int8_prologue(q, k, v, pv_int8=False))
    pro_dev = graph_ms(lambda: fa.int8_prologue(q, k, v, pv_int8=False), 5)
    pro_plain = cuda_time_ms(lambda: fa.int8_prologue_plain(
        q, k, v, pv_int8=False))
    # Q and K read once, their codes and (padded) scales written once
    pro_bytes = (q.numel() + k.numel()) * (q.element_size() + 1) \
        + 4 * (ops.q_scale.numel() + ops.k_scale.numel())
    times[f"prologue {name}"] = (pro, pro_plain)
    info[f"prologue {name}"] = (*bound_ms({}, pro_bytes), None)
    k3q_plain = cuda_time_ms(lambda: fa.int8_attention_plain(
        ops, *segs, **kw), **reps)
    scales = 4 * (ops.q_scale.numel() + ops.k_scale.numel())
    q8 = dict(qk="int8", pv="bf16", q_bytes=1, kv_bytes=1, v_bytes=2)
    if kv_seg is None:
        t3 = attention_bound(b, h, sq, skv, d)
        t3q = attention_bound(b, h, sq, skv, d, extra_bytes=scales, **q8)
    else:
        t3 = _cross_bound(h, sq, d, kv_seg)
        t3q = _cross_bound(h, sq, d, kv_seg, **q8)
    for kern, key, plain, tensor in ((k3, "K3", k3_plain, t3),
                                     (k3q, "K3q", k3q_plain, t3q)):
        times[f"{key} {name}"] = (kern, plain)
        info[f"{key} {name}"] = (*max(tensor, (ex2, "operations")), None)
    flops = fa.attention_flops(1, h, sq, keys, d)
    log(f"[time] K3 / K3q {name} B={b} H={h} Sq={sq} Skv={skv} D={d} "
        f"bound={LTX13B_BOUND}: K3 {k3:.3f} ms ({flops / k3 / 1e9:.1f} "
        f"TFLOP/s; plain {k3_plain:.3f} ms; bound {t3[0]:.3f} ms bf16 "
        f"tensor, ex2 floor {ex2:.3f} ms), K3q {k3q:.3f} ms "
        f"({flops / k3q / 1e9:.1f} TOP/s; plain {k3q_plain:.3f} ms; "
        f"prologue {pro:.3f} ms one call, {pro_dev:.4f} ms in a CUDA graph, "
        f"its bytes bound {info[f'prologue {name}'][0]:.4f} ms, the plain "
        f"prologue {pro_plain:.3f} ms; bound {t3q[0]:.3f} ms int8 QK + bf16 "
        f"PV "
        f"tensor ({t3q[1]})), K1 {k1_ms:.3f} ms (K3 {k3 / k1_ms:.2f}x, K3q "
        f"{k3q / k1_ms:.2f}x)")
    del ops


def phase_timing(gen, ex2_per_s):
    import torch

    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im
    from ltx_video_gpupoor_tpu_torch.tools._bench_util import graph_ms

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
    lib_c = cuda_time_ms(lambda: sdpa(q, kc, vc, attn_mask=_key_mask(kv_seg)))
    info["K1 cross"] = (*_cross_bound(h, s, d, kv_seg), lib_c)
    log(f"[time] K1 cross-attention Sq=5280 Skv=256: kernel {kern_c:.3f} ms, "
        f"plain {plain_c:.3f} ms, bound {info['K1 cross'][0]:.3f} ms "
        f"({info['K1 cross'][1]}; the keys in sight), "
        f"scaled_dot_product_attention with a boolean key mask {lib_c:.3f} ms")
    log("[time]   " + "; ".join(_vs_accepted(times, key)
                                for key in ("K1 self", "K1 cross")))
    # what the mask code costs: the same call through the tail instance (one
    # key fewer) and the general one (segment ids that hide nothing)
    log("[time]   " + _mask_kind_times(q, k, v, kern))
    # K3 and K3q at the LTX-2B self-attention shape, where the ex2 floor
    # lies just under the tensor bound
    _bounded_times(times, info, "LTX-2B self", q, k, v, (None, None),
                   ex2_per_s, kern)
    del q, k, v, kc, vc
    torch.cuda.empty_cache()
    # K1 and K3 encode three tensor maps on the host at every launch
    qs, ks, vs = (_heads(1, 2, 128, 64, gen, False) for _ in range(3))
    k1_us = _host_us_a_launch(lambda: fa.flash_attention(qs, ks, vs))
    k3_us = _host_us_a_launch(lambda: fa.flash_attention(qs, ks, vs,
                                                         score_bound=20.0))
    log(f"[time] host time a launch at B=1 H=2 S=128 D=64: K1 {k1_us:.1f} us, "
        f"K3 {k3_us:.1f} us (three tensor maps encoded)")
    del qs, ks, vs

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
        keys = b * skv if seg is None else int((segs[1] > 0).sum())
        ex2 = _ex2_ms(h * sq * keys, ex2_per_s)
        k1 = None
        if seg is None:      # K1 at the same shape, the exact tier
            k1 = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
            k1_lib = cuda_time_ms(lambda: sdpa(q, k, v))
            k1_bnd = attention_bound(b, h, sq, skv, d)
            k1_plain = ""
            if name == "self":    # the Wan shape: 8.6 GB of scores a head
                k1_plain = ", plain {:.3f} ms".format(cuda_time_ms(
                    lambda: _by_heads(fa.reference_attention, q, k, v,
                                      heads_per_call=1), reps=3, warmup=1))
            log(f"[time] K1 {name}-attention B={b} H={h} Sq={sq} Skv={skv} "
                f"D={d}: kernel {k1:.3f} ms{k1_plain}, bound "
                f"{k1_bnd[0]:.3f} ms ({k1_bnd[1]}), "
                f"scaled_dot_product_attention {k1_lib:.3f} ms")
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
            kw = dict(qk="int8", pv="int8" if pv else "bf16", q_bytes=1,
                      kv_bytes=1, v_bytes=1 if pv else 2)
            if seg is None:
                tensor = attention_bound(b, h, sq, skv, d, extra_bytes=scales,
                                         **kw)
            else:
                tensor = _cross_bound(h, sq, d, segs[1], **kw)
            # the larger of the tensor bound and the exponentials' floor
            bnd = max(tensor, (ex2, "operations"))
            info[f"K4 {tier} {name}"] = (*bnd, None)
            key = f"K4 {tier} {name}"
            vs_k1 = f", K1 {k1:.3f} ms ({kern / k1:.2f}x)" if k1 else ""
            accepted = (f", the accepted mma.sync kernel "
                        f"{ACCEPTED_MS[key]:.3f} ms "
                        f"({ACCEPTED_MS[key] / kern:.2f}x)"
                        if key in ACCEPTED_MS else "")
            log(f"[time] K4 {tier} {name}-attention B={b} H={h} Sq={sq} "
                f"Skv={skv} D={d}: kernel {kern:.3f} ms "
                f"({flops / kern / 1e9:.1f} TOP/s), plain {plain:.3f} ms, "
                f"prologue {pro:.3f} ms, bound {bnd[0]:.3f} ms (int8 "
                f"tensor {tensor[0]:.3f} ms, ex2 floor {ex2:.3f} ms)"
                f"{vs_k1}{accepted}")
            del ops
        del q, k, v
        torch.cuda.empty_cache()

    # K1 and K4 at CLIP's head dim of 80 (the D=128 layout): 48 blocks of
    # 128 q rows on 132 SMs, three kv tiles each
    b, h, sq, skv, d = CLIP_SELF
    q, k, v = (_heads(b, h, n, d, gen, True) for n in (sq, skv, skv))
    kern = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(lambda: fa.reference_attention(q, k, v))
    lib = cuda_time_ms(lambda: sdpa(q, k, v))
    dev_ms = graph_ms(lambda: fa.flash_attention(q, k, v))
    times["K1 CLIP d=80"] = (kern, plain)
    info["K1 CLIP d=80"] = (*attention_bound(b, h, sq, skv, d), lib)
    log(f"[time] K1 CLIP self-attention B={b} H={h} S={sq} D={d}: kernel "
        f"{kern:.4f} ms (device {dev_ms:.4f} ms in a CUDA graph), plain "
        f"{plain:.4f} ms, bound {info['K1 CLIP d=80'][0]:.4f} ms "
        f"({info['K1 CLIP d=80'][1]}), scaled_dot_product_attention "
        f"{lib:.4f} ms")
    ops = fa.int8_prologue(q, k, v, pv_int8=True)
    kern = cuda_time_ms(lambda: fa.int8_attention_cuda(ops))
    dev_ms = graph_ms(lambda: fa.int8_attention_cuda(ops))
    whole = cuda_time_ms(lambda: fa.flash_attention_int8(q, k, v))
    plain = cuda_time_ms(lambda: fa.int8_attention_plain(ops))
    scales = 4 * (ops.q_scale.numel() + ops.k_scale.numel()
                  + ops.v_scale.numel())
    tensor = attention_bound(b, h, sq, skv, d, qk="int8", pv="int8",
                             q_bytes=1, kv_bytes=1, v_bytes=1,
                             extra_bytes=scales)
    ex2 = _ex2_ms(b * h * sq * skv, ex2_per_s)
    times["K4 CLIP d=80"] = (kern, plain)
    info["K4 CLIP d=80"] = (*max(tensor, (ex2, "operations")), None)
    log(f"[time] K4 int8pv CLIP self-attention B={b} H={h} S={sq} D={d}: "
        f"kernel {kern:.4f} ms (device {dev_ms:.4f} ms in a CUDA graph), "
        f"with its prologue {whole:.4f} ms, plain {plain:.4f} ms, bound "
        f"{info['K4 CLIP d=80'][0]:.4f} ms (int8 tensor {tensor[0]:.4f} ms, "
        f"{tensor[1]}; ex2 floor {ex2:.4f} ms)")
    # K3q at d=80: the QK tier's operands, bounded scores (no PyTorch call
    # clamps scores)
    ops = fa.int8_prologue(q, k, v, pv_int8=False)
    kw = dict(score_bound=LTX13B_BOUND)
    kern = cuda_time_ms(lambda: fa.int8_attention_cuda(ops, **kw))
    dev_ms = graph_ms(lambda: fa.int8_attention_cuda(ops, **kw))
    plain = cuda_time_ms(lambda: fa.int8_attention_plain(ops, **kw))
    scales = 4 * (ops.q_scale.numel() + ops.k_scale.numel())
    tensor = attention_bound(b, h, sq, skv, d, qk="int8", pv="bf16",
                             q_bytes=1, kv_bytes=1, v_bytes=2,
                             extra_bytes=scales)
    times["K3q CLIP d=80"] = (kern, plain)
    info["K3q CLIP d=80"] = (*max(tensor, (ex2, "operations")), None)
    log(f"[time] K3q CLIP self-attention B={b} H={h} S={sq} D={d} bound "
        f"{LTX13B_BOUND}: kernel {kern:.4f} ms (device {dev_ms:.4f} ms in a "
        f"CUDA graph), plain {plain:.4f} ms, bound "
        f"{info['K3q CLIP d=80'][0]:.4f} ms (tensor {tensor[0]:.4f} ms, "
        f"{tensor[1]}; ex2 floor {ex2:.4f} ms); library call none")
    del q, k, v, ops
    # K1f at d=80 (exact variant): CLIP in FP32_POLICY
    q, k, v = (_fp32_heads(b, h, n, d, gen, True) for n in (sq, skv, skv))
    kern = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    dev_ms = graph_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(lambda: fa.reference_attention(q, k, v))
    lib = cuda_time_ms(lambda: sdpa(q, k, v))
    ops_n = fa.attention_flops(b, h, sq, skv, d)
    t_tf32 = K1F_TF32_PRODUCTS * ops_n / PEAK_OPS["tf32"] * 1e3
    t_bytes = 4 * b * h * d * (2 * sq + 2 * skv) / PEAK_BYTES * 1e3
    bnd = (max(t_tf32, ex2, t_bytes),
           "bytes" if t_bytes > max(t_tf32, ex2) else "operations")
    times["K1f CLIP d=80"] = (kern, plain)
    info["K1f CLIP d=80"] = (*bnd, lib)
    log(f"[time] K1f CLIP self-attention B={b} H={h} S={sq} D={d} fp32: "
        f"kernel {kern:.4f} ms (device {dev_ms:.4f} ms in a CUDA graph), "
        f"plain {plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}: split TF32 "
        f"{t_tf32:.4f}, ex2 floor {ex2:.4f}, bytes {t_bytes:.4f}), "
        f"scaled_dot_product_attention in fp32 {lib:.4f} ms")
    del q, k, v

    from ltx_video_gpupoor_tpu_torch.ops import _lib

    lib_k = _lib.library()
    stream = _lib.stream_ptr(torch.device("cuda"))
    # K2 encodes two tensor maps on the host at every GEMM launch; its row
    # quantize takes plain pointers
    xs, ws, ss, _ = _k2_operands(16, 256, 256, "bf16", gen)
    k2_us = _host_us_a_launch(lambda: im.int8_linear(xs, ws, ss))
    q_us = _host_us_a_launch(lambda: im._quantize_rows_cuda(lib_k, xs, stream))
    log(f"[time] host time a launch at M=16 K=256 N=256: K2 {k2_us:.1f} us "
        f"(row quantize, then the GEMM with two tensor maps encoded), its "
        f"row quantize alone {q_us:.1f} us")
    del xs, ws, ss
    for name, m, kk, n, dtype in K2_SHAPES + K2_I2V_SHAPES:
        if m < 100 and name != "adaln 2048->12288 M=48":
            continue
        x, w8, sw, bias = _k2_operands(m, kk, n, dtype, gen)
        kern = cuda_time_ms(lambda: im.int8_linear(x, w8, sw, bias))
        plain = cuda_time_ms(lambda: im.int8_linear_plain(x, w8, sw, bias),
                             reps=3, warmup=1)
        # its two launches apart: the row quantize, then the GEMM with the
        # scale / bias epilogue
        rows = cuda_time_ms(lambda: im._quantize_rows_cuda(lib_k, x, stream))
        rows_note = ""
        if m >= 3840:
            # the stream read at call time: a graph capture runs on its own
            rows_dev = graph_ms(lambda: im._quantize_rows_cuda(
                lib_k, x, _lib.stream_ptr(x.device)))
            rows_plain = cuda_time_ms(lambda: im.quantize_rows_plain(x),
                                      reps=3, warmup=1)
            rows_bnd = bound_ms({}, m * kk * (x.element_size() + 1) + 4 * m)
            times[f"K2 rows {name}"] = (rows, rows_plain)
            info[f"K2 rows {name}"] = (*rows_bnd, None)
            rows_note = (f", {rows_dev:.4f} ms in a CUDA graph against its "
                         f"bytes bound {rows_bnd[0]:.4f} ms "
                         f"({rows_dev / rows_bnd[0]:.2f}x), plain "
                         f"{rows_plain:.3f} ms")
        xq, sx = im._quantize_rows_cuda(lib_k, x, stream)
        gemm = cuda_time_ms(lambda: im._gemm_cuda(lib_k, xq, sx, w8, sw, bias,
                                                  x.dtype, stream))
        times[f"K2 {name}"] = (kern, plain)
        xb = 2 if dtype == "bf16" else 4
        bnd = linear_bound(m, kk, n, x_bytes=xb, out_bytes=xb)
        lib = None
        if m >= 1024 and n >= 1024:
            # the GEMM alone: int8 [M, K] @ [K, N] -> int32
            lib = cuda_time_ms(lambda: torch._int_mm(xq, w8.t()))
        info[f"K2 {name}"] = (*bnd, lib)
        key = f"K2 {name}"
        log(f"[time] K2 {name} M={m}: kernel {kern:.3f} ms "
            f"({2 * m * kk * n / kern / 1e9:.1f} TOP/s; row quantize "
            f"{rows:.3f} ms one call{rows_note}, GEMM with its epilogue "
            f"{gemm:.3f} ms, "
            f"{2 * m * kk * n / gemm / 1e9:.1f} TOP/s), plain {plain:.3f} ms, "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}), torch._int_mm (GEMM alone) "
            + (f"{lib:.3f} ms (kernel {kern / lib:.2f}x, GEMM "
               f"{gemm / lib:.2f}x)" if lib is not None else "none")
            + (f", the accepted mma.sync kernel {ACCEPTED_MS[key]:.3f} ms "
               f"({ACCEPTED_MS[key] / kern:.2f}x)" if key in ACCEPTED_MS
               else ""))
        del x, w8, sw, bias, xq, sx
    torch.cuda.empty_cache()

    # K3, K3q and K6 at the 13B self-attention shapes (K3 and K3q also at
    # the cross shape), K6 at the LTX-2B shape; the library call is SDPA on
    # the head-split views (exact attention: K6's function, not K3's clamp)
    for i, (b, h, n, _, d) in enumerate(LTX13B_SELF):
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        qp, kp, vp = qkv.chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (qp, kp, vp))
        reps = dict(reps=3, warmup=1)
        k6 = cuda_time_ms(lambda: fa.flash_attention_hp(qp, kp, vp, heads=h))
        k6_plain = cuda_time_ms(lambda: _by_heads(fa.reference_attention,
                                                  q, k, v), **reps)
        k1 = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
        lib = cuda_time_ms(lambda: sdpa(q, k, v))
        bnd = attention_bound(b, h, n, n, d)
        times[f"K6 self pass {i + 1}"] = (k6, k6_plain)
        # K1 on the same views computes K6's function: one plain version
        times[f"K1 self pass {i + 1}"] = (k1, k6_plain)
        info[f"K1 self pass {i + 1}"] = (*bnd, lib)
        info[f"K6 self pass {i + 1}"] = (*bnd, lib)
        flops = fa.attention_flops(b, h, n, n, d)
        log(f"[time] 13B self-attention pass {i + 1} B={b} H={h} S={n} D={d}: "
            f"K6 {k6:.3f} ms ({flops / k6 / 1e9:.1f} "
            f"TFLOP/s, plain {k6_plain:.3f} ms), K1 on the head-split views "
            f"{k1:.3f} ms (K6's plain version), bound {bnd[0]:.3f} ms ({bnd[1]}), "
            f"scaled_dot_product_attention {lib:.3f} ms")
        log("[time]   " + _mask_kind_times(q, k, v, k1))
        _bounded_times(times, info, f"self pass {i + 1}", q, k, v,
                       (None, None), ex2_per_s, k1)
        kc, vc = (_heads(b, h, 256, d, gen, True) for _ in range(2))
        q_seg, kv_seg = _cross_segments(b, n, 256)
        k1c = cuda_time_ms(lambda: fa.flash_attention(q, kc, vc, q_seg,
                                                      kv_seg))
        k1c_plain = cuda_time_ms(lambda: fa.reference_attention(
            q, kc, vc, q_seg, kv_seg), **reps)
        _bounded_times(times, info, f"cross pass {i + 1}", q, kc, vc,
                       (q_seg, kv_seg), ex2_per_s, k1c)
        times[f"K1 cross pass {i + 1}"] = (k1c, k1c_plain)
        # the data's work: 200 of the 256 text tokens are valid
        bnd_c = _cross_bound(h, n, d, kv_seg)
        lib_c = cuda_time_ms(lambda: sdpa(q, kc, vc,
                                          attn_mask=_key_mask(kv_seg)))
        info[f"K1 cross pass {i + 1}"] = (*bnd_c, lib_c)
        log(f"[time] 13B cross-attention pass {i + 1} Sq={n} Skv=256: "
            f"K1 {k1c:.3f} ms (plain "
            f"{k1c_plain:.3f} ms), bound {bnd_c[0]:.3f} ms ({bnd_c[1]}), "
            f"scaled_dot_product_attention with a boolean key mask "
            f"{lib_c:.3f} ms")
        log("[time]   " + "; ".join(
            _vs_accepted(times, f"{key} pass {i + 1}")
            for key in ("K1 self", "K6 self", "K1 cross")))
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
    log("[time]   " + _vs_accepted(times, "K6 LTX-2B"))
    del qp, kp, vp

    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops.norms import rms_norm
    from ltx_video_gpupoor_tpu_torch.tools._bench_util import graph_ms

    for name, m, kk, n, g in K5_SHAPES:
        x, scale, shift, w8, sw, bias = _k5_operands(m, kk, n, g, gen)
        kw = dict(rows_per_group=m // g, eps=1e-6)
        kern = cuda_time_ms(lambda: fp.norm_mod_int8_matmul(
            x, scale, shift, w8, sw, bias, **kw))
        rows = cuda_time_ms(lambda: fp.norm_mod_quantize_rows(
            x, scale, shift, **kw))
        rows_dev = graph_ms(lambda: fp.norm_mod_quantize_rows(
            x, scale, shift, **kw))
        # x read and the codes written once, the group rows, a scale a row
        rows_bound = (m * kk * 3 + 2 * g * kk * 2 + 4 * m) / PEAK_BYTES * 1e3
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
            f"kernel alone {rows:.3f} ms one call, {rows_dev:.4f} ms in a "
            f"CUDA graph, its memory bound {rows_bound:.4f} ms: "
            f"{rows_dev / rows_bound:.2f}x), plain {plain:.3f} ms, the unfused "
            f"chain (PyTorch norm and modulation, then K2) {chain:.3f} ms, "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}), the accepted mma.sync GEMM "
            f"{ACCEPTED_MS['K5 ' + name]:.3f} ms "
            f"({ACCEPTED_MS['K5 ' + name] / kern:.2f}x)")
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
    quantize_params(dit, mode="dynamic")
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
        models.append(quantize_params(m, mode="dynamic"))
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
    launches = kernel_counts()
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


def _psnr_db(a, b):
    """PSNR of uint8 frames (peak 255)."""
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")


def _timed_request(gen, emb, mask, height, width, frames, **kw):
    """One ``generate`` from prompt embeddings: (uint8 frames, seconds by
    stage, launches)."""
    import torch

    marks = {}

    def on_stage(name, value):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = gen.generate(emb, mask, height=height, width=width,
                       frame_num=frames, frame_rate=25.0, seed=SEED,
                       on_stage=on_stage, **kw)
    t_end = time.perf_counter()
    launches = kernel_counts()
    assert out.dtype.name == "uint8" and \
        out.shape == (frames, height, width, 3), out.shape
    sec = {"denoise": marks["decode"] - marks["denoise"],
           "decode": marks["postprocess"] - marks["decode"],
           "total": t_end - t0}
    return out, sec, launches


TEACACHE_CONFIG = "ltxv-2b-0.9.6-dev"
TEACACHE_STEPS = 30          # bench.py's headline step count
TEACACHE_MULT = 2.2


def phase_teacache(gen, t5):
    """LTX-2B at full width, 704x480x121, ltxv-2b-0.9.6-dev at 30 steps,
    three ways: without TeaCache, at --teacache 2.2, and at 2.2 with
    attention_score_bound=40. A skipped step launches no block: K1 (K3)
    launches = 2 x layers x computed steps exactly. Prints the steps
    computed, the seconds, the launches and the frames' PSNR against the
    request without TeaCache."""
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines import ltx_pipeline as lp
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )

    dit = gen.pipeline.transformer
    dev_gen = LTXVideoGenerator(gen.pipeline, pipeline_config=TEACACHE_CONFIG)
    emb, mask, _ = encode_prompts(t5)
    height, width, frames = REQUESTS[-1]
    masks = []
    schedule = lp.ltx_teacache_schedule

    def spy(*args, **kwargs):
        masks.append(schedule(*args, **kwargs))
        return masks[-1]

    lp.ltx_teacache_schedule = spy
    results = {}
    try:
        for name, mult, bound in (("no TeaCache", 0.0, None),
                                  (f"teacache {TEACACHE_MULT}",
                                   TEACACHE_MULT, None),
                                  (f"teacache {TEACACHE_MULT} + bound "
                                   f"{LTX13B_BOUND:g}", TEACACHE_MULT,
                                   LTX13B_BOUND)):
            set_score_bound(dit, bound)
            masks.clear()
            out, sec, launches = _timed_request(
                dev_gen, emb, mask, height, width, frames,
                sampling_steps=TEACACHE_STEPS, teacache_multiplier=mult)
            computed = int(masks[0].sum()) if masks else TEACACHE_STEPS
            attn = launches["K3" if bound else "K1"]
            assert attn == 2 * dit.cfg.num_layers * computed, \
                (name, computed, launches)
            assert launches["K1" if bound else "K3"] == 0, launches
            if mult:
                assert computed < TEACACHE_STEPS, computed
            results[name] = out
            db = _psnr_db(out, results["no TeaCache"])
            log(f"[teacache] {name}: {width}x{height}x{frames} "
                f"{TEACACHE_CONFIG} steps computed {computed}/"
                f"{TEACACHE_STEPS} denoise={sec['denoise']:.3f} s "
                f"decode={sec['decode']:.3f} s total={sec['total']:.3f} s "
                f"launches K1={launches['K1']} K3={launches['K3']} "
                f"K2={launches['K2']} frames PSNR against no TeaCache "
                f"{db:.2f} dB")
            torch.cuda.empty_cache()
    finally:
        lp.ltx_teacache_schedule = schedule
        set_score_bound(dit, None)


def phase_fp32(t5):
    """LTX-2B at full width under FP32_POLICY (fp32 weights quantized
    int8_dynamic, fp32 activations, fp32 VAE decoder) at 256x256x9: once
    as served (auto: K1f, K2 on fp32 activations, no bf16 attention
    kernel) and once in the xla tier (plain fp32 attention); frames >= 40
    dB apart. Returns the first request's launches."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops.attention import set_attention_mode
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import LTXPipeline
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dit = tf.init_params(tf.LTXTransformer3D(ltx2b_config(), FP32_POLICY,
                                             device=dev),
                         torch.Generator(device=dev).manual_seed(SEED + 7))
    quantize_params(dit, mode="dynamic")
    vae = vaem.init_params(vaem.CausalVAEDecoder(vae_config(), FP32_POLICY,
                                                 device=dev),
                           torch.Generator(device=dev).manual_seed(SEED + 8))
    gen = LTXVideoGenerator(LTXPipeline(dit, vae),
                            pipeline_config="ltxv-2b-0.9.6-distilled")
    emb, mask, _ = encode_prompts(t5)
    log(f"[fp32] built LTX-2B (28 layers, fp32 activations, int8_dynamic) "
        f"and the fp32 VAE decoder in {time.perf_counter() - t0:.1f} s")
    height, width, frames = FP32_REQUEST
    outs = {}
    try:
        for mode in ("auto", "xla"):
            set_attention_mode(mode)
            out, sec, launches = _timed_request(gen, emb, mask, height,
                                                width, frames)
            outs[mode] = (out, launches)
            bf16 = {k: n for k, n in launches.items()
                    if k not in ("K1f", "K1fd80", "K2") and n}
            assert not bf16, f"[fp32] a bf16 kernel ran: {bf16}"
            assert launches["K2"] > 0, launches
            assert (launches["K1f"] > 0) == (mode == "auto"), launches
            variants = {k: n for k, n in
                        fa.flash_attention_fp32.by_variant.items() if n}
            log(f"[fp32] {width}x{height}x{frames} attention {mode}: "
                f"denoise={sec['denoise']:.3f} s total={sec['total']:.3f} s "
                f"launches K1f={launches['K1f']} (by variant {variants}) "
                f"K2={launches['K2']} (fp32 activations)")
    finally:
        set_attention_mode("auto")
    db = _psnr_db(outs["auto"][0], outs["xla"][0])
    log(f"[fp32] frames, K1f against the xla tier: PSNR {db:.2f} dB "
        f"(bar 40)")
    assert db >= 40.0, f"[fp32] {db:.2f} dB < 40"
    del gen, dit, vae
    torch.cuda.empty_cache()
    return outs["auto"][1]


# [load]: the 13B stack from files in the published layout. The depth is
# fixed here, never adapted at run time: 24 of the 48 layers at full width
# (the time goes to [wan_i2v])
LOAD_LAYERS = 24
LOAD_LORA_RANK = 128


def phase_load():
    """Write synthetic files in the published layout to a temporary
    directory (the 13B-dev quanto int8 transformer at full width, the
    distilled LoRA, the 0.9.7 VAE, the spatial upscaler), then serve one
    992x608x121 image-to-video request through the CLI's real branch
    (``--model-mode ltxv_13B_distilled --ckpt-dir <tmp>``, no ``--demo``;
    ``--quantize-transformer`` for the int8_dynamic tier, ``--save-
    quantized``). Prints the seconds of each stage, the reader of each
    file, the mp4 writer and the saved file's size; the mp4 must read back
    as 121 frames of 608x992. Returns the request's launches."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from ltx_video_gpupoor_tpu_torch.core import checkpoint as ck
    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem
    from ltx_video_gpupoor_tpu_torch.serving import cli, model_zoo
    from ltx_video_gpupoor_tpu_torch.serving import orchestrator as orch
    from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
    from ltx_video_gpupoor_tpu_torch.utils import media

    cfg = dataclasses.replace(ltx13b_config(), num_layers=LOAD_LAYERS)
    up_cfg = lup.LatentUpsamplerConfig(in_channels=128, mid_channels=512,
                                       num_blocks_per_stage=4, dims=3)
    vae_cfg = {**vaem.LTX_VAE_CONFIG_097, "timestep_conditioning": True}
    height, width, frames = LTX13B_REQUEST
    root = tempfile.mkdtemp(prefix="ltx_ckpt_")
    seen = {}
    real = (model_zoo.load_ltxv_model, ck.save_quantized_model,
            orch.LTXVideoGenerator.generate)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen[name] = time.perf_counter() - t0
            seen[name + " result"] = out
            return out
        return wrapped

    try:
        info = sc.write_ltxv_ckpt_dir(root, cfg, vae_cfg, up_cfg,
                                      lora_rank=LOAD_LORA_RANK,
                                      seed=SEED + 30, device="cuda")
        sizes = ", ".join(f"{k} {v / 1e9:.3f} GB"
                          for k, v in info["bytes"].items())
        log(f"[load] wrote the published layout ({LOAD_LAYERS} of 48 "
            f"layers, hidden {cfg.inner_dim}, {cfg.num_attention_heads}x"
            f"{cfg.attention_head_dim} heads, LoRA rank {LOAD_LORA_RANK}) "
            f"in {info['write_s']:.3f} s (transformer "
            f"{info['transformer_write_s']:.3f} s): {sizes}")
        png = os.path.join(root, "start.png")
        Image.fromarray(synthetic_image(height, width)).save(png)
        out_mp4 = os.path.join(root, "out.mp4")
        model_zoo.load_ltxv_model = timed("load", real[0])
        ck.save_quantized_model = timed("save_quantized", real[1])
        orch.LTXVideoGenerator.generate = timed("generate", real[2])
        torch.cuda.empty_cache()
        reset_kernel_counts()
        t0 = time.perf_counter()
        cli.main(["--prompt", "a red fox runs through fresh snow",
                  "--model-mode", "ltxv_13B_distilled", "--ckpt-dir", root,
                  "--height", str(height), "--width", str(width),
                  "--video-length", str(frames), "--frame-rate", "25",
                  "--image-start", png, "--seed", str(SEED),
                  "--quantize-transformer", "--save-quantized",
                  "--output-path", out_mp4])
        total = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        (model_zoo.load_ltxv_model, ck.save_quantized_model,
         orch.LTXVideoGenerator.generate) = real
    try:
        stats = seen["load result"].load_stats
        saved = seen["save_quantized result"]
        saved_gb = os.path.getsize(saved) / 1e9
        back = media.load_video(out_mp4)
        assert back.shape == (frames, height, width, 3), back.shape
        assert np.isfinite(back).all() and back.std() > 0
        mp4_s = total - seen["load"] - seen["save_quantized"] - seen["generate"]
        log(f"[load] read: transformer {stats['transformer_read_s']:.3f} s "
            f"by the {stats['transformer_reader']} reader "
            f"({stats['transformer_bytes'] / 1e9:.3f} GB), LoRA "
            f"{stats['lora_read_s']:.3f} s ({stats['lora_reader']}), VAE "
            f"{stats['vae_read_s']:.3f} s ({stats['vae_reader']}), upscaler "
            f"{stats['upsampler_read_s']:.3f} s ({stats['upsampler_reader']})"
            f"; to the card + dequantize there "
            f"{stats['to_device_dequantize_s']:.3f} s; convert + assign "
            f"{stats['convert_s']:.3f} s; LoRA merge "
            f"{stats['lora_merge_s']:.3f} s ({stats['lora_layers']} "
            f"layers); VAE to the card {stats['vae_to_device_s']:.3f} s; "
            f"load_ltxv_model {seen['load']:.3f} s in all")
        log(f"[load] --save-quantized {seen['save_quantized']:.3f} s, "
            f"{saved_gb:.3f} GB ({os.path.basename(saved)}); request "
            f"{width}x{height}x{frames} (ltxv-13b-0.9.7-distilled, "
            f"int8_dynamic, auto) generate {seen['generate']:.3f} s, the "
            f"rest of the CLI (quantize, mp4 write by {media.last_writer}) "
            f"{mp4_s:.3f} s, cli.main {total:.3f} s; launches "
            f"{ {k: n for k, n in launches.items() if n} }; the mp4 reads "
            f"back as {back.shape[0]} frames of {back.shape[2]}x"
            f"{back.shape[1]}")
        assert launches["K2"] > 0 and launches["K4"] > 0, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # the loaded stack (held by ``seen``) leaves the card now, not at
        # the cyclic collector's next pass
        seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return launches


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
    quantize_params(dit, mode="dynamic")
    kw = dict(device=dev, dtype=DEFAULT_POLICY.param_dtype)
    for i in range(cfg.num_layers):
        blk = tf.init_params(tf.Block(cfg, **kw), g)
        if i < 2:
            dense_cut.update({f"blocks.{i}.{k}": v.cpu()
                              for k, v in blk.state_dict().items()})
        dit.blocks.append(quantize_params(blk, mode="dynamic"))
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
            # K1's and K4's launches at CLIP's head dim and at the DiTs'
            "K1d80": fa.flash_attention.launches_by_d.get(80, 0),
            "K1d128": fa.flash_attention.launches_by_d.get(128, 0),
            "K4d80": fa.flash_attention_int8.launches_by_d.get(80, 0),
            "K4d128": fa.flash_attention_int8.launches_by_d.get(128, 0),
            # K3q's and K1f's at CLIP's head dim
            "K3qd80": fa.flash_attention_int8.bounded_launches_by_d.get(
                80, 0),
            "K1fd80": fa.flash_attention_fp32.launches_by_d.get(80, 0),
            "K2": im.int8_linear.launches,
            # K2's row kernel on the int8 attention prologue's contract
            "K2p": fa.int8_prologue.kernel_launches,
            "K3": fa.flash_attention.bounded_launches,
            "K3q": fa.flash_attention_int8.bounded_launches,
            "K4": fa.flash_attention_int8.launches,
            "K5": fp.norm_mod_int8_matmul.launches,
            "K6": fa.flash_attention_hp.launches,
            "K7": rr.ring_attention_rdma.launches,
            "K8": mb.pipelined_attention.launches,
            "K1f": fa.flash_attention_fp32.launches}


def reset_kernel_counts():
    from ltx_video_gpupoor_tpu_torch.ops import flash_attention as fa
    from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as fp
    from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as im

    fa.flash_attention.launches = 0
    fa.flash_attention.launches_by_d = {}
    fa.flash_attention.bounded_launches = 0
    fa.flash_attention_int8.launches = 0
    fa.flash_attention_int8.launches_by_d = {}
    fa.flash_attention_int8.bounded_launches = 0
    fa.flash_attention_int8.bounded_launches_by_d = {}
    fa.flash_attention_hp.launches = 0
    fa.flash_attention_fp32.launches = 0
    fa.flash_attention_fp32.by_variant = dict.fromkeys(fa.K1F_VARIANTS, 0)
    fa.flash_attention_fp32.launches_by_d = {}
    im.int8_linear.launches = 0
    fa.int8_prologue.kernel_launches = 0
    fp.norm_mod_int8_matmul.launches = 0
    from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as rr
    from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as mb

    rr.ring_attention_rdma.launches = 0
    rr.ring_attention_rdma.launches_tc = 0
    rr.ring_attention_rdma.launches_simple = 0
    mb.pipelined_attention.launches = 0


# the kernels each tier must launch, and those it must not
LTX13B_EXPECT = {"a: auto": (("K4", "K2", "K2p"),
                             ("K1", "K3", "K3q", "K5", "K6", "K7", "K8",
                              "K1f")),
                 "b: pallas_hp + fused prologue": (
                     ("K6", "K5", "K1", "K2"),
                     ("K2p", "K3", "K3q", "K4", "K7", "K8", "K1f")),
                 "c: score bound": (("K3", "K2"),
                                    ("K1", "K2p", "K3q", "K4", "K5", "K6",
                                     "K7", "K8", "K1f")),
                 "d: pallas_int8 + score bound": (
                     ("K3q", "K2", "K2p"),
                     ("K1", "K3", "K4", "K5", "K6", "K7", "K8", "K1f"))}


def ltx13b_reference_check(cfg, dense_cut):
    """A 2-layer cut of the 13B DiT (the main model's own first two
    blocks) on the card with the kernels against the same cut on the CPU
    with the plain versions, both int8_dynamic in bf16, in each of the
    four tiers: one stream, 2 latent frames of 4x4 tokens with their own
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
        models.append(quantize_params(m, mode="dynamic"))
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
    launch counts of pass 1 (media encode included) and of pass 2. The
    tier is pinned for the request with ``set_attention_mode(mode)``, as
    ``LTXV_TPU_ATTN`` pins it for a process, and ``generate`` asks for
    ``auto``."""
    import torch

    from ltx_video_gpupoor_tpu_torch.ops.attention import set_attention_mode

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
        set_attention_mode(mode)
        try:
            frames_u8 = gen.generate(
                emb, mask, height=height, width=width, frame_num=frames,
                frame_rate=30.0, seed=SEED,
                image_start=synthetic_image(height, width),
                attn_mode="auto", on_stage=on_stage)
        finally:
            set_attention_mode("auto")
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
    per tier (tier (b) through the HTTP server, ``phase_server``, then the
    enhanced request there too); returns the launch counts per tier and of
    the enhanced request (``ENHANCED``; both passes summed) and the
    generator."""
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
            p1, p2, launches[ENHANCED] = phase_server(gen, t5, name, mode,
                                                      fused, bound)
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
    stdlib HTTP server over a real socket, then ``[enhance]`` (the same
    request with ``enhance_prompt``, ``phase_enhance``), the error answers
    and ``/metrics``; returns the launch counts of the first request's two
    passes and the enhanced request's (both passes summed)."""
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

    def make_serve(req_body):
        return lambda on_stage: serve(req_body, on_stage)

    def serve(req_body, on_stage):
        real = gen.generate
        gen.generate = lambda *a, **k: real(*a, on_stage=on_stage, **k)
        try:
            status, payload = _http(root + "/", req_body)
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
                                    serve=make_serve(body))
        first = Metrics.snapshot()["gauges"]
        enhanced = phase_enhance(service, make_serve, body, gen, t5,
                                 (name, mode, fused, bound))
        status, payload = _http(root + "/", {k: v for k, v in body.items()
                                             if k != "prompt"})
        assert status == 400 and b"Missing fields: prompt" in payload, \
            (status, payload)
        status, payload = _http(root + "/download/..%2Fchip_smoke.py")
        assert status == 404, (status, payload[:200])
        status, payload = _http(root + "/metrics")
        metrics = json.loads(payload)
        assert status == 200 and metrics["counters"]["requests_ok"] == 2, \
            metrics
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
        set_attention_mode("auto")
        set_fused_prologue(False)
    g = first
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
    return p1, p2, enhanced


# --------------------------------------------------------------------------
# phase 7c': [enhance], the prompt enhancer on the served 13B stack
# --------------------------------------------------------------------------

# Florence-2-large's published widths (microsoft/Florence-2-large
# config.json, vision_config and text_config): the JAX package has no
# preset for it and config_from_hf reads Florence-2-base's defaults
FLORENCE2_LARGE_HF = {
    "vision_config": {"depths": [1, 1, 9, 1], "patch_size": [7, 3, 3, 3],
                      "patch_stride": [4, 2, 2, 2],
                      "patch_padding": [3, 1, 1, 1],
                      "patch_prenorm": [False, True, True, True],
                      "embed_dim": [256, 512, 1024, 2048],
                      "num_heads": [8, 16, 32, 64],
                      "num_groups": [8, 16, 32, 64], "window_size": 12,
                      "mlp_ratio": 4.0, "projection_dim": 1024,
                      "max_position_embeddings": 50,
                      "max_temporal_embeddings": 100},
    "text_config": {"vocab_size": 51289, "d_model": 1024,
                    "encoder_layers": 12, "decoder_layers": 12,
                    "encoder_attention_heads": 16, "encoder_ffn_dim": 4096,
                    "max_position_embeddings": 1024},
    "image_token_id": 51289,
}
# the enhancer's generation budget: the JAX enhancer's max_new_tokens
ENHANCE_NEW_TOKENS = 256
# the enhanced request launches what tier (b) launches, and nothing more:
# the enhancer's models run on PyTorch's own kernels (JAX's on XLA's)
ENHANCE_EXPECT = LTX13B_EXPECT[LTX13B_SERVED]
ENHANCED = "b: enhanced POST /"      # its entry among the 13B launches


class WordTokenizer:
    """A word-level stand-in for a checkpoint's tokenizer files, which
    are not in the repository: the special tokens by their strings, any
    other word by its CRC32 into the ids below ``special_from``; ``decode``
    writes an id as the word ``w<id>``. It offers what the enhancers call
    (``apply_chat_template``, ``__call__``, ``decode``, ``bos_token``,
    ``eos_token``, ``eos_token_id``), so no tokenizer package is needed."""

    def __init__(self, special: dict, special_from: int, eos_token: str,
                 bos_token: str = "", turn: str = "{content}",
                 prefix: str = "", generation_prompt: str = ""):
        import re

        self.special = dict(special)
        self.special_ids = set(special.values())
        self.special_from = special_from
        self.bos_token, self.eos_token = bos_token, eos_token
        self.eos_token_id = special[eos_token]
        self.turn, self.prefix = turn, prefix
        self.generation_prompt = generation_prompt
        self._split = re.compile("(" + "|".join(
            re.escape(s) for s in sorted(special, key=len, reverse=True))
            + ")")

    def encode(self, text: str) -> list:
        import zlib

        ids = []
        for part in self._split.split(text):
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids.extend(zlib.crc32(w.encode()) % self.special_from
                           for w in part.split())
        return ids

    def __call__(self, text, add_special_tokens=False,
                 return_attention_mask=False):
        return {"input_ids": self.encode(text)}

    def apply_chat_template(self, messages, add_generation_prompt=True):
        text = self.prefix + "".join(
            self.turn.format(role=m["role"], content=m["content"])
            for m in messages)
        if add_generation_prompt:
            text += self.generation_prompt
        return self.encode(text)

    def decode(self, ids, skip_special_tokens=True):
        inverse = {v: k for k, v in self.special.items()}
        return " ".join(
            inverse.get(int(i), f"w{int(i)}") for i in ids
            if not (skip_special_tokens and int(i) in self.special_ids))


def llama3_tokenizer():
    """Llama-3.x Instruct's special tokens and chat layout."""
    return WordTokenizer(
        {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
         "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
         "<|eot_id|>": 128009}, 128000, "<|eot_id|>",
        bos_token="<|begin_of_text|>",
        turn="<|start_header_id|>{role}<|end_header_id|>\n\n"
             "{content}<|eot_id|>",
        prefix="<|begin_of_text|>",
        generation_prompt="<|start_header_id|>assistant<|end_header_id|>"
                          "\n\n")


def qwen_tokenizer():
    """Qwen2.5's (and Qwen2.5-VL's) special tokens and chat layout."""
    return WordTokenizer(
        {"<|endoftext|>": 151643, "<|im_start|>": 151644,
         "<|im_end|>": 151645, "<|vision_start|>": 151652,
         "<|vision_end|>": 151653, "<|image_pad|>": 151655,
         "<|video_pad|>": 151656}, 151643, "<|im_end|>",
        turn="<|im_start|>{role}\n{content}<|im_end|>\n",
        generation_prompt="<|im_start|>assistant\n")


def florence_tokenizer():
    """BART's special tokens (Florence-2's tokenizer)."""
    return WordTokenizer({"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3},
                         51289, "</s>", bos_token="<s>")


def _db(out, ref) -> float:
    """PSNR of ``out`` against ``ref`` with the peak the larger magnitude
    of the two, doubled (the cuts' bar is 30 dB)."""
    import numpy as np

    o = out.float().cpu().numpy() if hasattr(out, "cpu") else out
    r = ref.float().cpu().numpy() if hasattr(ref, "cpu") else ref
    assert o.shape == r.shape and np.isfinite(o).all(), (o.shape, r.shape)
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o.astype(np.float64) - r) ** 2))
    return 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")


def _cut(module_cls, cut_cfg, full, **kw):
    """``module_cls(cut_cfg)`` on the card sharing ``full``'s tensors (its
    first blocks), and an fp32 copy on the CPU."""
    import torch

    card = module_cls(cut_cfg, device="meta", **kw)
    want = card.state_dict()
    sd = {k: v for k, v in full.state_dict().items() if k in want}
    card.load_state_dict(sd, assign=True)
    cpu = module_cls(cut_cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in sd.items()})
    return card, cpu


def build_enhancer():
    """Llama-3.2-3B-Instruct and Florence-2-large at full width on the
    card, bf16, random weights from seeds; returns (lm, captioner) behind
    the stand-in tokenizers, and the seconds of the build."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models import florence2 as fl
    from ltx_video_gpupoor_tpu_torch.models import llm
    from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as pe

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    lm = llm.init_params(llm.LLM(llm.LLAMA_3_2_3B, device="cuda"), gen)
    flo = fl.init_params(fl.Florence2(fl.config_from_hf(FLORENCE2_LARGE_HF),
                                      device="cuda"), gen)
    # JAX's init leaves the logit bias at 0, and a random BART then copies
    # its input token (the forced BOS) at every step, an empty caption: a
    # drawn bias gives the caption words
    bias = flo.text.final_logits_bias
    bias.copy_(torch.randn(bias.shape, generator=gen, device="cuda"))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    n_lm = sum(p.numel() for p in lm.parameters())
    n_flo = sum(p.numel() for p in flo.parameters())
    log(f"[enhance] built Llama-3.2-3B-Instruct ({lm.cfg.num_layers} layers, "
        f"dim {lm.cfg.dim}, {lm.cfg.num_heads}/{lm.cfg.num_kv_heads} heads "
        f"of {lm.cfg.hd}, vocabulary {lm.cfg.vocab_size}, {n_lm / 1e9:.3f} B "
        f"parameters) and Florence-2-large ({n_flo / 1e9:.3f} B) on the "
        f"card in bf16 in {built:.3f} s")
    return (pe.ChatLM(model=lm, tokenizer=llama3_tokenizer(),
                      max_new_tokens=ENHANCE_NEW_TOKENS),
            pe.FlorenceCaptioner(model=flo, tokenizer=florence_tokenizer(),
                                 max_new_tokens=ENHANCE_NEW_TOKENS))


def enhancer_reference_check(lm, captioner):
    """2-layer cuts of the two models (the full models' own first
    blocks) on the card against fp32 copies on the CPU: Llama's prefill
    logits over left-padded ids; its 8 cached decode steps' logits against
    one full forward over the same tokens (both on the card); Florence's
    tower features (its 9-block stage cut to 2) on a 384x384 image and its
    decoder's logits (BART cut to 2 + 2 layers). Bar: 30 dB."""
    import dataclasses

    import torch

    from ltx_video_gpupoor_tpu_torch.models import florence2 as fl
    from ltx_video_gpupoor_tpu_torch.models import llm

    g = torch.Generator().manual_seed(SEED + 41)
    lcfg = dataclasses.replace(lm.model.cfg, num_layers=2)
    card, cpu = _cut(llm.LLM, lcfg, lm.model)
    ids = torch.randint(0, 128000, (1, 48), generator=g)
    mask = torch.ones(1, 48, dtype=torch.int32)
    mask[:, :5] = 0
    dbs = {"llama prefill": _db(llm.forward(card, ids, mask),
                                llm.forward(cpu, ids, mask))}
    toks, seen = llm.generate(card, ids, mask, 8, return_logits=True)
    full = llm.forward(card, torch.cat([ids.to(toks.device), toks], 1),
                       torch.cat([mask, torch.ones(1, 8, dtype=torch.int32)],
                                 1))
    dbs["llama 8 cached steps"] = _db(seen, full[:, 47:-1])
    del card, cpu, full
    cfg = captioner.model.cfg
    fcfg = fl.FlorenceConfig(
        vision=dataclasses.replace(cfg.vision, depths=(1, 1, 2, 1)),
        text=dataclasses.replace(cfg.text, encoder_layers=2,
                                 decoder_layers=2),
        image_token_id=cfg.image_token_id)
    card, cpu = _cut(fl.Florence2, fcfg, captioner.model)
    px = torch.randn(1, 384, 384, 3, generator=g)
    feat = fl.vision_forward(card, px)
    ref = fl.vision_forward(cpu, px)
    dbs["florence tower"] = _db(feat, ref)
    n_img = 12 * 12 + 1
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_id),
                     torch.randint(4, 50000, (1, 15), generator=g)], 1)
    dec = torch.tensor([[2, 0] + list(range(100, 106))])
    dbs["florence decoder"] = _db(fl.forward(card, ids, px, dec),
                                  fl.forward(cpu, ids, px, dec))
    del card, cpu
    log("[enhance] reference check, 2-layer cuts at full width, the card "
        "in bf16 vs fp32 copies on the CPU (cached decode vs a full "
        "forward on the card): " + ", ".join(
            f"{k} {v:.2f} dB" for k, v in dbs.items()) + " (bar 30)")
    assert all(v >= 30.0 for v in dbs.values()), dbs
    return dbs


def phase_enhance(service, make_serve, body, gen, t5, tier):
    """[enhance] on the served 13B stack: build the enhancer's models,
    check their cuts, set the enhancer on the service, then serve one
    POST / with ``"enhance_prompt": true``: the caption and the rewrite
    run on the card, the rewrite is the prompt the text encoding gets
    (its embeddings differ from the original prompt's), and the request
    launches exactly tier (b)'s kernels (``ENHANCE_EXPECT``). Frees the
    enhancer; returns the request's launches (both passes)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.serving import cli
    from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as pe
    from ltx_video_gpupoor_tpu_torch.utils.observability import Metrics

    t_phase = time.perf_counter()
    lm, captioner = build_enhancer()
    enhancer_reference_check(lm, captioner)
    service.enhancer = pe.PromptEnhancer(lm=lm, captioner=captioner)
    marks = {}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks[name] = (time.perf_counter() - t0, out)
            return out
        return wrapped

    captioner.caption = timed("caption", captioner.caption)
    lm.chat = timed("rewrite", lm.chat)
    prompts = []
    real_encode = cli.encode_or_hash
    cli.encode_or_hash = lambda pipe, p, n: (prompts.append(p),
                                             real_encode(pipe, p, n))[1]
    name, mode, fused, bound = tier
    # the first request's end switched the prologue off (the attention
    # mode stays the server process's)
    set_fused_prologue(fused)
    try:
        p1, p2 = run_ltx13b_request(
            gen, t5, name, mode, fused, bound,
            serve=make_serve(dict(body, enhance_prompt=True)))
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        cli.encode_or_hash = real_encode
    counts = {k: p1[k] + p2[k] for k in p1}
    must, must_not = ENHANCE_EXPECT
    assert all(counts[k] > 0 for k in must) and \
        not any(counts[k] for k in must_not), counts
    caption_s, caption = marks["caption"]
    rewrite_s, rewrite = marks["rewrite"]
    assert lm.model.device.type == captioner.model.device.type == "cuda"
    assert caption and rewrite and prompts == [rewrite], (prompts, rewrite)
    assert rewrite != body["prompt"]
    pipe = gen.pipeline
    emb, _ = real_encode(pipe, rewrite, body["negative_prompt"])
    orig, _ = real_encode(pipe, body["prompt"], body["negative_prompt"])
    assert not torch.equal(emb, orig)
    g = Metrics.snapshot()["gauges"]
    stages = {k.split("/", 1)[1]: v for k, v in g.items()
              if k.startswith("last_stage_s/")}
    assert stages["enhance_prompt"] > 0, stages
    height, width, frames = LTX13B_REQUEST
    log(f"[enhance] POST / {width}x{height}x{frames} with enhance_prompt in "
        f"tier ({name}): caption {caption_s:.3f} s "
        f"({captioner.last_new_tokens} tokens, 768x768, {len(caption)} "
        f"characters), rewrite {rewrite_s:.3f} s ({lm.last_new_tokens} "
        f"tokens of {lm.max_new_tokens}), answered in "
        f"{g['last_request_s']:.3f} s: "
        + " ".join(f"{k}={v:.3f}s" for k, v in stages.items())
        + f"; peak {peak:.2f} GiB with the enhancer's models resident; "
        f"the text encoding got the rewrite (embeddings differ from the "
        f"original prompt's); launches {counts}, exactly tier (b)'s kinds; "
        f"the phase {time.perf_counter() - t_phase:.3f} s")
    service.enhancer = None
    del lm, captioner, marks
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the CLI's --int8-mode tiers, each with --quantize-transformer on the demo
CLI_INT8_MODES = (None, "wo", "wo_int4", "mixed_int4")


def phase_cli():
    """Requests through the CLI's ``main`` on the demo model: as it is,
    then quantized in each weight-only ``--int8-mode`` (which launch no
    K2)."""
    from ltx_video_gpupoor_tpu_torch.serving import cli
    from ltx_video_gpupoor_tpu_torch.utils import media

    height, width, frames = CLI_REQUEST
    first = None
    for mode in CLI_INT8_MODES:
        tag = f"_{mode}" if mode else ""
        path = os.path.join(ROOT, "outputs", f"cli_demo{tag}.mp4")
        quant = ["--quantize-transformer", "--int8-mode", mode] if mode \
            else []
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = cli.main(["--demo", "--prompt", "a red fox in the snow",
                        "--height", str(height), "--width", str(width),
                        "--video-length", str(frames), "--seed", str(SEED),
                        "--output-path", path] + quant)
        sec = time.perf_counter() - t0
        counts = kernel_counts()
        video = media.load_video(out)
        assert out == path and os.path.getsize(path) > 0
        assert video.shape == (frames, height, width, 3), video.shape
        assert counts["K1"] > 0, counts
        assert mode is None or counts["K2"] == 0, (mode, counts)
        log(f"[cli] main(--demo ... {width}x{height}x{frames}"
            f"{' ' + ' '.join(quant) if quant else ''}) wrote "
            f"{os.path.relpath(out, ROOT)} ({os.path.getsize(path)} bytes, "
            f"{video.shape[0]} frames) in {sec:.3f} s with the model build; "
            f"launches {counts}")
        first = first or counts
    return first


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
    quantize_params(dit, mode="dynamic")
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
        models.append(quantize_params(m, mode="dynamic"))
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


def run_wan_request(pipe, umt5, height, width, frames, mode,
                    steps=WAN_STEPS, solver="unipc", **gen_kw):
    """One request: a UMT5 encode, then ``generate_t2v`` to pixels
    (``gen_kw``: TeaCache's ``teacache_multiplier`` / ``teacache_model``)."""
    import torch

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
        sampling_steps=steps, shift=5.0, solver=solver, guide_scale=5.0,
        cfg_zero_step=WAN_CFG_ZERO_STEP,
        generator=torch.Generator(device="cuda").manual_seed(SEED),
        output_type="pixels", attn_mode=mode, on_stage=on_stage, **gen_kw)
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixels_finite = bool(torch.isfinite(video.float()).all())
    frames_u8 = torch.clamp((video[0].float() + 1.0) * 127.5, 0, 255)
    frames_u8 = frames_u8.to(torch.uint8).cpu().numpy()
    t_end = time.perf_counter()
    f, h, w = checks["latent_shape"][1:4]
    tokens = f * (h // 2) * (w // 2)
    extra = "".join(f" {k}={v}" for k, v in gen_kw.items())
    log(f"[wan] request {width}x{height}x{frames} tier={mode}: "
        f"tokens={tokens} a stream, steps={steps} solver={solver}{extra} "
        f"umt5={t5_sec:.3f} s "
        f"denoise={marks['decode'] - marks['denoise']:.3f} s "
        f"decode={t_dec - marks['decode']:.3f} s "
        f"postprocess={t_end - t_dec:.3f} s total={t_end - t0:.3f} s "
        f"peak={peak:.2f} GiB frames={frames_u8.dtype.name}"
        f"{list(frames_u8.shape)} latents_finite={checks['latents_finite']} "
        f"pixels_finite={pixels_finite} launches={launches}")
    assert frames_u8.shape == (frames, height, width, 3), frames_u8.shape
    assert checks["latents_finite"] and pixels_finite
    assert launches["K2"] > 0, launches
    # every Wan head dim is 128: auto takes the int8 tier, as JAX does
    exact = mode == "pallas"
    assert (launches["K1"] > 0) == exact and (launches["K4"] > 0) != exact, \
        launches
    # the prologue quantizes Q for every K4 call, and K in the QK tier
    per_call = 0 if exact else 2 if mode == "pallas_int8" else 1
    assert launches["K2p"] == per_call * launches["K4"], launches
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
    # the other solver and TeaCache, each at 832x480x17 in the default tier
    run_wan_request(pipe, umt5, *WAN_EXTRA_SHAPE, "auto", solver="dpm++")
    from ltx_video_gpupoor_tpu_torch.pipelines import wan as wpipe

    sigmas = pipe._solve_schedule("unipc", WAN_TEACACHE_STEPS, 5.0)
    mask = wpipe.teacache_skip_schedule(
        dit, sigmas[:-1].numpy() * pipe.num_train_timesteps,
        wpipe.TEACACHE_COEFFICIENTS["t2v_1.3B"], WAN_TEACACHE_MULT)
    tc = run_wan_request(pipe, umt5, *WAN_EXTRA_SHAPE, "auto",
                         steps=WAN_TEACACHE_STEPS,
                         teacache_multiplier=WAN_TEACACHE_MULT,
                         teacache_model="t2v_1.3B")
    computed = int(mask.sum())
    # a skipped step runs no block: self- and cross-attention a layer for
    # each computed step
    assert tc["K4"] == 2 * dit.cfg.num_layers * computed, (tc, mask)
    log(f"[wan] TeaCache {WAN_TEACACHE_MULT} (t2v_1.3B coefficients): "
        f"{computed} of {WAN_TEACACHE_STEPS} steps computed, mask "
        f"{mask.astype(int).tolist()}; K4 launches {tc['K4']} = 2 x "
        f"{dit.cfg.num_layers} x {computed}")
    torch.cuda.empty_cache()
    return launches, pipe, umt5


# --------------------------------------------------------------------------
# phase 8a': the rest of Wan 2.1 on the t2v-1.3B DiT: VACE, Phantom,
# ReCamMaster, the sliding window, SkyReels-V2 diffusion forcing; the
# XLM-Roberta text tower
# --------------------------------------------------------------------------

# The published configurations of the variants, each the t2v-1.3B widths
# (dim 1536, ffn 8960, 12 heads of 128, 30 layers) with its own modules:
# Wan-AI/Wan2.1-VACE-1.3B (hint blocks at every second layer, 96 context
# channels: 2 x 16 latent + 64 mask phases of the 8x8 stride);
# Phantom-video/Phantom (Phantom-Wan-1.3B: no modules of its own, three
# guidance streams); KwaiVGI/ReCamMaster (on Wan2.1-T2V-1.3B: a camera
# encoder and projector in every block); SkyworkAI/SkyReels-V2-DF-1.3B-540P
# (fps conditioning, 960x544, base_num_frames 97). [wan_variants] attaches
# the modules of all four to the one DiT that [wan] built.
VACE_LAYERS = tuple(range(0, 30, 2))
VACE_IN_DIM = 96
XLMR_IDS = (2, 77)                   # prompts, tokens each (padded)
# (request, (H, W, F), UniPC steps)
VARIANT_REQUESTS = [("vace", (480, 832, 81), 4), ("phantom", (480, 832, 81), 4),
                    ("recammaster", (480, 832, 81), 4),
                    ("window", (480, 832, 81), 4)]
WAN_DF_SHAPE = (544, 960, 97)        # SkyReels-V2-DF-1.3B-540P
WAN_DF_STEPS = 4
WAN_DF_PREFIX_FRAMES = 17
WAN_DF_OVERLAP_NOISE = 20
WAN_WINDOW_OVERLAP = 5               # latent frames carried over, boundary too
WAN_WINDOW_NOISE = 20.0
VARIANT_CUT_GRID = (2, 6, 10)        # latent frames, token rows, columns
# the linears a forward runs through K2 in the dynamic tier: each block's
# ten (q, k, v, o of both attentions, the FFN's two); outside them the text
# embedding's two, the time embedding's two, the time projection and the
# head; a VACE hint block's ten and its after_proj (before_proj on the
# first); ReCamMaster's cam_encoder and projector a block; fps's two
T2V_LINEARS = (10, 6)


def variant_expect(kind, layers, forwards, vace_blocks=0, cam=False,
                   fps=False):
    """The launches ``forwards`` DiT forwards of one request make in the
    dynamic tier under ``auto`` (K4 at head dim 128 for every attention,
    its prologue K2p once a K4 call), exactly, and the kernels it must
    not launch. Guidance streams are batch rows: one forward a step (a
    row of the timestep matrix in diffusion forcing)."""
    attn = 2 * (layers + vace_blocks)
    linears = T2V_LINEARS[0] * layers + T2V_LINEARS[1]
    if vace_blocks:
        linears += (T2V_LINEARS[0] + 1) * vace_blocks + 1
    if cam:
        linears += 2 * layers
    if fps:
        linears += 2
    must = {"K4d128": attn * forwards, "K2p": attn * forwards,
            "K2": linears * forwards}
    return must, ("K1", "K3", "K3q", "K5", "K6", "K1f", "K4d80")


def _check_launches(what, counts, expect):
    must, must_not = expect
    bad = {k: (counts[k], n) for k, n in must.items() if counts[k] != n}
    assert not bad and not any(counts[k] for k in must_not), \
        (what, bad, counts)


def attach_variant_modules(dit):
    """ReCamMaster's, VACE's and the fps conditioning's modules on the
    [wan] DiT (``add_variant_modules``, as ``WanModel`` builds them),
    seeded by ``init_params`` but for the hint projections and the
    projector, drawn as every other linear (trained checkpoints are far
    from JAX's starting zeros and identity), then the dynamic tier;
    returns the dense bf16 state of the new modules (CPU) for the cut
    check."""
    import dataclasses

    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    cfg = dataclasses.replace(dit.cfg, vace_layers=VACE_LAYERS,
                              vace_in_dim=VACE_IN_DIM, recammaster=True,
                              inject_sample_info=True)
    new = wm.init_params(wm.add_variant_modules(
        dit, cfg, device=dev, dtype=DEFAULT_POLICY.param_dtype), g)
    with torch.no_grad():
        for mod in new.modules():
            for name in ("projector", "before_proj", "after_proj"):
                lin = getattr(mod, name, None)
                if lin is not None:
                    lin.weight.copy_(torch.randn(
                        lin.weight.shape, generator=g, device=dev,
                        dtype=lin.weight.dtype) * lin.d_in ** -0.5)
    dense = {k: v.cpu() for k, v in dit.state_dict().items()
             if k.startswith(("vace_blocks.0.", "vace_blocks.1.",
                              "vace_patch_embedding", "fps_"))
             or (k.startswith(("blocks.0.", "blocks.1."))
                 and ("cam_encoder" in k or "projector" in k))}
    quantize_params(dit, mode="dynamic")
    torch.cuda.synchronize()
    return dense


def variant_reference_check(dense):
    """A 2-layer cut of the variant DiT at full width: both blocks with a
    VACE hint, ReCamMaster's camera tokens and projector in both (the
    grid spans the latent and the source frames), the fps row and
    diffusion forcing's per-frame timesteps, two CFG streams, on the card
    with the kernels (K2, K4) against the same cut on the CPU with the
    plain versions, both int8_dynamic in bf16. Bar: 30 dB on the
    velocity, as the t2v cut."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

    cut = dataclasses.replace(wm.WAN_T2V_1_3B, num_layers=2,
                              vace_layers=(0, 1), vace_in_dim=VACE_IN_DIM,
                              recammaster=True, inject_sample_info=True)
    g = torch.Generator().manual_seed(SEED + 41)
    base = wm.init_params(wm.WanModel(dataclasses.replace(
        wm.WAN_T2V_1_3B, num_layers=2), DEFAULT_POLICY), g).state_dict()
    state = {**base, **dense}
    f, h, w = VARIANT_CUT_GRID
    x = torch.randn(2, 2 * f, 2 * h, 2 * w, cut.in_dim, generator=g)
    vctx = torch.randn(2, 2 * f, 2 * h, 2 * w, VACE_IN_DIM, generator=g)
    cam = torch.randn(1, f, wm.CAM_DIM, generator=g)
    t = torch.tensor([[999.0] * f + [0.0] * f, [500.0] * (2 * f)])
    ctx = torch.randn(2, 64, cut.text_dim, generator=g)
    mask = torch.zeros(2, 64, dtype=torch.int32)
    mask[0, :40] = 1
    mask[1, :17] = 1
    models = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        m = wm.WanModel(cut, DEFAULT_POLICY, device=d)
        m.load_state_dict(state)
        models.append(quantize_params(m, mode="dynamic"))
    grid = (2 * f, h, w)
    kw = dict(vace_scale=1.0, fps_idx=1)
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out, _ = models[0](*(a.cuda() for a in (x, t, ctx, mask)),
                           wan_rope_freqs(grid, cut.head_dim, device="cuda"),
                           vace_context=vctx.cuda(), cam_emb=cam.cuda(), **kw)
        torch.cuda.synchronize()
        counts = kernel_counts()
        t1 = time.perf_counter()
        ref, _ = models[1](x, t, ctx, mask,
                           wan_rope_freqs(grid, cut.head_dim),
                           vace_context=vctx, cam_emb=cam, **kw)
    _check_launches("variant cut", counts, variant_expect(
        "cut", 2, 1, vace_blocks=2, cam=True, fps=True))
    o, r = out.float().cpu().numpy(), ref.float().numpy()
    assert np.isfinite(o).all() and o.shape == r.shape
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o - r) ** 2))
    db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
    log(f"[wan_variants] reference check, 2-layer cut at full width with "
        f"the VACE hints, ReCamMaster's cameras over {2 * f} frames, the "
        f"fps row and per-frame timesteps ({2 * f * h * w} tokens a stream, "
        f"2 streams), kernels on the card ({t1 - t0:.2f} s) vs plain "
        f"versions on the CPU ({time.perf_counter() - t1:.1f} s): PSNR "
        f"{db:.2f} dB (bar 30), launches K4 {counts['K4']} K2 "
        f"{counts['K2']} K2p {counts['K2p']}")
    assert db >= 30.0, f"variant reference check {db:.2f} dB < 30"
    return db


def build_xlmr():
    """XLM-Roberta large (24 layers, dim 1024, 16 heads of 64, 514
    positions, the 250002-token vocabulary) from a seed, bf16 on the card;
    also the dense weights of a 2-layer cut on the CPU."""
    import dataclasses

    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import xlm_roberta as xr

    dev = torch.device("cuda")
    cfg = xr.XLMRobertaConfig()
    model = xr.init_params(xr.XLMRoberta(cfg, DEFAULT_POLICY, device=dev),
                           torch.Generator(device=dev).manual_seed(SEED + 42))
    cut = {k: v.cpu() for k, v in model.state_dict().items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    return model, dataclasses.replace(cfg, num_layers=2), cut


def _xlmr_ids(cfg):
    import torch

    g = torch.Generator().manual_seed(SEED + 43)
    ids = torch.randint(3, cfg.vocab_size, XLMR_IDS, generator=g)
    ids[1, 30:] = cfg.pad_id                    # a shorter prompt
    return ids


def xlmr_reference_check(cut_cfg, cut):
    """XLM-R's first two layers at full width on the card (K1 at head dim
    64 with the pad mask's segments) against the same cut on the CPU
    (plain versions), bf16. Bar: 30 dB."""
    import numpy as np

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import xlm_roberta as xr

    ids = _xlmr_ids(cut_cfg)
    outs = []
    for d in ("cuda", "cpu"):
        m = xr.XLMRoberta(cut_cfg, DEFAULT_POLICY, device=d)
        m.load_state_dict(cut)
        reset_kernel_counts()
        outs.append(xr.encode(m, ids).float().cpu().numpy())
        if d == "cuda":
            counts = kernel_counts()
        del m
    assert counts["K1"] == cut_cfg.num_layers, counts
    o, r = outs
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o - r) ** 2))
    db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
    log(f"[wan_variants] reference check, XLM-R 2-layer cut at full width, "
        f"{XLMR_IDS[0]} x {XLMR_IDS[1]} ids with padding: PSNR {db:.2f} dB "
        f"(bar 30), K1 launches {counts['K1']}")
    assert np.isfinite(o).all() and db >= 30.0, f"XLM-R cut {db:.2f} dB"
    return db


def _control_video(frames, height, width):
    """A seeded control clip in [-1, 1]: the synthetic image drifting one
    pixel a frame."""
    import numpy as np
    import torch

    img = synthetic_image(height, width + frames)
    clip = np.stack([img[:, i:i + width] for i in range(frames)])
    return torch.from_numpy(clip).cuda().float()[None] / 127.5 - 1.0


def _finish(what, shape, video, marks, t0, counts, expect, extra=""):
    """Check and log one request: frames finite and not constant, the
    launches against ``expect``."""
    import torch

    torch.cuda.synchronize()
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    height, width, frames = shape
    assert tuple(video.shape) == (1, frames, height, width, 3), video.shape
    assert bool(torch.isfinite(video.float()).all()), what
    assert float(video.float().std()) > 0, f"{what}: constant frames"
    stages = {k: v for k, v in marks.items()}
    stages["total"] = t_end - t0
    log(f"[wan_variants] request {what} {width}x{height}x{frames}: "
        + " ".join(f"{k}={v:.3f} s" for k, v in stages.items())
        + f" peak={peak:.2f} GiB{extra} launches={counts}")
    _check_launches(what, counts, expect)
    return {"stages": stages, "peak": peak, "launches": counts}


def run_variant_request(kind, pipe, umt5, shape, steps, state):
    """One request of VARIANT_REQUESTS through ``generate_t2v`` (VACE,
    the window, ReCamMaster) or ``denoise`` (Phantom, with its reference
    image latents), to pixels."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models.wan import vae as wv
    from ltx_video_gpupoor_tpu_torch.utils import camera, vace

    height, width, frames = shape
    cfg = pipe.model.cfg
    marks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    emb, mask, marks["umt5"] = encode_wan_prompts(umt5)
    gen_kw = dict(width=width, height=height, sampling_steps=steps,
                  shift=5.0, guide_scale=5.0, cfg_zero_step=WAN_CFG_ZERO_STEP,
                  generator=torch.Generator(device="cuda").manual_seed(SEED),
                  output_type="latent")
    t1 = time.perf_counter()
    expect, extra = None, ""
    if kind in ("vace", "window"):
        if kind == "vace":
            # a control clip whose middle frames a mask hides, and one
            # reference image: the context has the reference's latent
            # frame first, so the request has one latent frame more
            video = _control_video(frames, height, width)
            masks = torch.zeros(1, frames, height, width, 1, device="cuda")
            masks[:, frames // 4:3 * frames // 4] = 1.0
            ref = _control_video(1, height, width)[:, 0]
            z = vace.vace_encode_frames(pipe.vae, video, [ref], masks)
            m = vace.vace_encode_masks(masks, pipe.vae_stride, num_refs=1)
            state["vace_context"] = vace.vace_latent(z, m)
            del video, masks, z, m
        vctx = state["vace_context"]
        torch.cuda.synchronize()
        marks["vace_encode"] = time.perf_counter() - t1
        gen_kw.update(frame_num=frames + pipe.vae_stride[0],
                      vace_context=vctx)
        if kind == "window":
            # the continuation of the VACE request: its last latent frames
            # (the boundary frame included) lead the next window, which
            # re-noises the context's matching frames at the floor
            over = state["vace_latents"][:, -WAN_WINDOW_OVERLAP:]
            gen_kw.update(overlapped_latents=over,
                          overlap_noise=WAN_WINDOW_NOISE,
                          return_latent_slice=slice(-WAN_WINDOW_OVERLAP, None))
        t2 = time.perf_counter()
        out = pipe.generate_t2v(emb, mask, **gen_kw)
        if kind == "window":
            tail = out["latent_slice"]
            latents = out["x"]
            assert torch.equal(latents[:, :WAN_WINDOW_OVERLAP], over)
            assert tail.shape[1] == WAN_WINDOW_OVERLAP
            extra = f" latent_slice={list(tail.shape)}"
        else:
            latents = out
            state["vace_latents"] = latents
        expect = variant_expect(kind, cfg.num_layers, steps,
                                vace_blocks=len(cfg.vace_layers))
    elif kind == "phantom":
        # three streams: (text, reference), (reference), (negative
        # reference) over the latents with the reference frame appended
        ref = _control_video(1, height, width)[:, 0]
        ref_lat = wv.encode(pipe.vae, ref[:, None]).float()
        torch.cuda.synchronize()
        marks["ref_encode"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        noise = pipe._noise(None, gen_kw["generator"], height, width, frames)
        sigmas = pipe._solve_schedule("unipc", steps, 5.0)
        latents = pipe.denoise(noise, emb, mask, sigmas, guide_scale=5.0,
                               cfg_zero_step=WAN_CFG_ZERO_STEP,
                               ref_latents=ref_lat,
                               ref_latents_neg=torch.zeros_like(ref_lat))
        expect = variant_expect(kind, cfg.num_layers, steps)
    else:   # ReCamMaster: the source clip's latents and a preset camera
        src = _control_video(frames, height, width)
        src_lat = wv.encode(pipe.vae, src).float()
        del src
        cam = torch.from_numpy(camera.get_camera_embedding(
            2, num_frames=frames))[None].cuda()
        torch.cuda.synchronize()
        marks["source_encode"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        gen_kw.update(frame_num=frames, source_latents=src_lat, cam_emb=cam)
        latents = pipe.generate_t2v(emb, mask, **gen_kw)
        f, h, w = latents.shape[1:4]
        extra = (f" tokens={2 * f * (h // 2) * (w // 2)} a stream (source "
                 f"frames appended)")
        expect = variant_expect(kind, cfg.num_layers, steps, cam=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    marks["denoise"] = t3 - t2
    assert bool(torch.isfinite(latents).all()), kind
    counts = kernel_counts()
    # VACE's reference frame leads the latents: the decode drops it
    drop = 1 if kind in ("vace", "window") else 0
    video = pipe._vae_decode(latents[:, drop:])
    torch.cuda.synchronize()
    marks["decode"] = time.perf_counter() - t3
    return _finish(kind, shape, video, marks, t0, counts, expect, extra)


def run_df_request(pipe, umt5, prefix=None):
    """A SkyReels-V2 diffusion-forcing request at 960x544x97 (``ar_step``
    1, causal blocks of 5, fps 24), or its continuation from a 17-frame
    prefix video with the overlap-noise floor; returns (result, the
    decoded video)."""
    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines import wan_df
    from ltx_video_gpupoor_tpu_torch.schedulers import unipc

    height, width, frames = WAN_DF_SHAPE
    marks = {}

    def on_stage(name, value):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    emb, mask, t5_sec = encode_wan_prompts(umt5)
    video = pipe.generate(
        emb, mask, height=height, width=width, frame_num=frames,
        sampling_steps=WAN_DF_STEPS, guide_scale=5.0, ar_step=1,
        causal_block_size=5, fps=24, prefix_video=prefix,
        overlap_noise=WAN_DF_OVERLAP_NOISE if prefix is not None else 0,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 44),
        output_type="pixels", on_stage=on_stage)
    counts = kernel_counts()
    torch.cuda.synchronize()
    stages = {"umt5": t5_sec}
    if "encode" in marks:
        stages["prefix_encode"] = marks["denoise"] - marks["encode"]
    stages["denoise"] = marks["decode"] - marks["denoise"]
    stages["decode"] = time.perf_counter() - marks["decode"]
    f_lat = (frames - 1) // 4 + 1
    pre = 0 if prefix is None else (prefix.shape[1] - 1) // 4 + 1
    sig = (unipc.unipc_sigmas(WAN_DF_STEPS, shift=1.0)[:-1].numpy()
           * 1000).astype(np.int64)
    rows = wan_df.generate_timestep_matrix(f_lat, sig, f_lat, 1, pre, 5)[0]
    cfg = pipe.model.cfg
    what = "DF" if prefix is None else "DF continuation"
    result = _finish(what, (height, width, frames), video, stages, t0,
                     counts, variant_expect("df", cfg.num_layers,
                                            rows.shape[0], fps=True),
                     f" rows={rows.shape[0]} tokens="
                     f"{f_lat * (height // 16) * (width // 16)} a stream")
    return result, video


def run_xlmr_request(model):
    import torch

    from ltx_video_gpupoor_tpu_torch.models.wan import xlm_roberta as xr

    ids = _xlmr_ids(model.cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    feats = xr.encode(model, ids)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert feats.shape == (*XLMR_IDS, model.cfg.dim)
    assert bool(torch.isfinite(feats.float()).all())
    log(f"[wan_variants] request XLM-R large {XLMR_IDS[0]} x {XLMR_IDS[1]} "
        f"ids (padded): encode={sec:.3f} s peak={peak:.2f} GiB "
        f"launches={counts}")
    _check_launches("XLM-R", counts, ({"K1": model.cfg.num_layers,
                                       "K2": 0, "K4": 0}, ("K1f", "K3")))
    return {"stages": {"encode": sec}, "peak": peak, "launches": counts}


def run_clip_fp32_request():
    """CLIP ViT-H/14 under FP32_POLICY on one image: ``auto`` at head dim
    80 is the int8 QK+PV tier, on fp32 operands K1f's ``pv8`` variant at
    d = 80 (and the prologue's row kernel for Q), in 31 blocks."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as wc

    dev = torch.device("cuda")
    clip = wc.init_params(wc.CLIPVision(wc.CLIPVisionConfig(), FP32_POLICY,
                                        device=dev),
                          torch.Generator(device=dev).manual_seed(SEED + 45))
    image = torch.from_numpy(synthetic_image(480, 832)).cuda()
    image = image.float() / 127.5 - 1.0
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    feats = wc.visual(clip, wc.resize_bicubic(image[None], 224))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = kernel_counts()
    blocks = clip.cfg.num_layers - 1
    log(f"[wan_variants] request CLIP ViT-H/14 fp32 (FP32_POLICY), one "
        f"832x480 image: visual={sec:.3f} s launches={counts}")
    assert feats.dtype == torch.float32 and bool(torch.isfinite(feats).all())
    _check_launches("CLIP fp32", counts, ({"K1f": blocks, "K1fd80": blocks,
                                           "K2p": blocks},
                                          ("K1", "K2", "K3q", "K4")))
    del clip
    torch.cuda.empty_cache()
    return counts


def phase_wan_variants(pipe, umt5):
    """The rest of Wan 2.1 on the [wan] DiT: attach the variants' modules,
    check a cut, serve VARIANT_REQUESTS with the Wan VAE and its encoder,
    then diffusion forcing and its continuation, XLM-Roberta large and
    CLIP in fp32. Returns the launch counts by request."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as wv
    from ltx_video_gpupoor_tpu_torch.pipelines.wan_df import WanDFPipeline

    t0 = time.perf_counter()
    dense = attach_variant_modules(pipe.model)
    # the VAE with its encoder (control videos, references, source and
    # prefix clips), seeded as [wan_i2v]'s
    pipe.vae = wv.init_params(
        wv.WanVAE(wv.WanVAEConfig(), DEFAULT_POLICY, device="cuda"),
        torch.Generator(device="cuda").manual_seed(SEED + 32))
    torch.cuda.synchronize()
    cfg = pipe.model.cfg
    log(f"[wan_variants] attached to the [wan] DiT: {len(cfg.vace_layers)} "
        f"VACE hint blocks (layers {cfg.vace_layers[0]}..{cfg.vace_layers[-1]}"
        f" step 2, context {cfg.vace_in_dim} channels), a camera encoder and "
        f"projector in each of {cfg.num_layers} blocks, the fps embedding "
        f"and projection; dynamic tier; DiT resident "
        f"{_resident_bytes(pipe.model) / 1e9:.3f} GB; the Wan VAE with its "
        f"encoder; {time.perf_counter() - t0:.1f} s")
    variant_reference_check(dense)
    del dense
    results, state = {}, {}
    for kind, shape, steps in VARIANT_REQUESTS:
        results[kind] = run_variant_request(kind, pipe, umt5, shape, steps,
                                            state)
        torch.cuda.empty_cache()
    del state
    df = WanDFPipeline(pipe.model, pipe.vae, vae_tile_size=256)
    results["df"], video = run_df_request(df, umt5)
    prefix = video[:, -WAN_DF_PREFIX_FRAMES:].float()
    del video
    torch.cuda.empty_cache()
    results["df_continuation"], video = run_df_request(df, umt5, prefix)
    del video, prefix, df
    torch.cuda.empty_cache()
    xlmr, cut_cfg, cut = build_xlmr()
    xlmr_reference_check(cut_cfg, cut)
    results["xlmr"] = run_xlmr_request(xlmr)
    del xlmr, cut
    torch.cuda.empty_cache()
    results["clip_fp32"] = {"launches": run_clip_fp32_request()}
    log(f"[wan_variants] done in {time.perf_counter() - t0:.1f} s")
    return {k: v["launches"] for k, v in results.items()}


# --------------------------------------------------------------------------
# phase 8b: Wan 2.1 i2v-14B
# --------------------------------------------------------------------------

# (quantize_params mode, attention tier, UniPC steps, (H, W, F)): the
# default tier, the mixed int4 tier under auto (one DiT resident at a time,
# so each peak is its tier's), then a short request in the mixed int4 tier
# with the exact attention pinned (as a served Wan request pins it on the
# H100), which runs K1 at both head dims. The default tier takes 2 steps
# (4 until [wan_variants] joined the script): the same work a step, about
# 16 s less
WAN_I2V_REQUESTS = [("dynamic", "auto", 2, (480, 832, 81)),
                    ("mixed_int4", "auto", 2, (480, 832, 81)),
                    ("mixed_int4", "pallas", 1, (480, 832, 17))]
WAN_I2V_CUT_TIERS = ("dynamic", "wo", "wo_int4", "mixed_int4")
WAN_I2V_CUT_GRID = (2, 6, 10)      # latent frames, token rows, token columns
CLIP_CUT_BLOCKS = 2
# the blocks' linears (q, k, v, o of both attentions, k_img, v_img, the
# FFN's two) and those outside (text 2, time 2, time projection, img_emb 2,
# head)
WAN_I2V_LINEARS = (12, 8)


def wan_i2v_expect(mode, tier, steps, layers, clip_blocks):
    """The launches an i2v request makes (``must``, exactly) and the
    kernels it must not launch: one forward a step with both CFG streams
    as batch rows; three attentions a layer (self, text, image); CLIP's
    blocks once (K4 at D=80 under ``auto``, K1 under ``pallas``); K2p one
    a K4 call (Q; the QK+PV tier); K2 in the dynamic tier only."""
    attn = 3 * layers * steps
    if tier == "auto":
        must = {"K4d128": attn, "K4d80": clip_blocks,
                "K2p": attn + clip_blocks}
        must_not = ("K1", "K3", "K3q", "K5", "K6", "K1f")
    else:
        must = {"K1d128": attn, "K1d80": clip_blocks}
        must_not = ("K2p", "K3", "K3q", "K4", "K5", "K6", "K1f")
    linears = (WAN_I2V_LINEARS[0] * layers + WAN_I2V_LINEARS[1]) * steps
    if mode == "dynamic":
        must["K2"] = linears
    else:
        must_not += ("K2",)
    return must, must_not


def _resident_bytes(module):
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())


def build_wan_i2v_dit(mode, keep_cut=False):
    """Wan 2.1 i2v-14B at full width and depth, built one block at a time
    from the seed and quantized to ``mode`` as it goes (the same weights
    in every tier); with ``keep_cut`` also the dense bf16 weights of its
    first two blocks and of everything outside the blocks, on the CPU."""
    import dataclasses

    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = wm.WAN_I2V_14B
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    dit = wm.init_params(wm.WanModel(
        dataclasses.replace(cfg, num_layers=0), DEFAULT_POLICY, device=dev),
        g)
    dit.cfg = cfg
    dense_cut = {k: v.cpu() for k, v in dit.state_dict().items()} \
        if keep_cut else None
    n_dense = sum(t.numel() for t in dit.state_dict().values())
    quantize_params(dit, mode=mode)
    kw = dict(device=dev, dtype=DEFAULT_POLICY.param_dtype)
    for i in range(cfg.num_layers):
        blk = wm.init_params(wm.Block(cfg, **kw), g)
        n_dense += sum(t.numel() for t in blk.state_dict().values())
        if keep_cut and i < 2:
            dense_cut.update({f"blocks.{i}.{k}": v.cpu()
                              for k, v in blk.state_dict().items()})
        dit.blocks.append(quantize_params(blk, mode=mode))
    torch.cuda.synchronize()
    log(f"[wan_i2v] built i2v-14B ({cfg.num_layers} layers, dim {cfg.dim}, "
        f"{cfg.num_heads}x{cfg.head_dim} heads, ffn {cfg.ffn_dim}, in_dim "
        f"{cfg.in_dim}; layer by layer) in tier {mode}: resident "
        f"{_resident_bytes(dit) / 1e9:.3f} GB (dense bf16 would be "
        f"{2 * n_dense / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dit, dense_cut


def build_wan_i2v_encoders():
    """CLIP ViT-H/14 (32 blocks of 1280) and the Wan VAE with its encoder
    from seeds; also the dense weights of CLIP's first two blocks and of
    everything outside its blocks, on the CPU."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as wc
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as wv

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    clip = wc.init_params(wc.CLIPVision(wc.CLIPVisionConfig(), DEFAULT_POLICY,
                                        device=dev),
                          torch.Generator(device=dev).manual_seed(SEED + 31))
    clip_cut = {k: v.cpu() for k, v in clip.state_dict().items()
                if not k.startswith("blocks.")
                or int(k.split(".")[1]) < CLIP_CUT_BLOCKS}
    vae = wv.init_params(wv.WanVAE(wv.WanVAEConfig(), DEFAULT_POLICY,
                                   device=dev),
                         torch.Generator(device=dev).manual_seed(SEED + 32))
    torch.cuda.synchronize()
    log(f"[wan_i2v] built CLIP ViT-H/14 ({clip.cfg.num_layers} blocks of "
        f"{clip.cfg.dim}, {clip.cfg.num_heads}x"
        f"{clip.cfg.dim // clip.cfg.num_heads} heads, "
        f"{_resident_bytes(clip) / 1e9:.3f} GB) and the Wan VAE with its "
        f"encoder in {time.perf_counter() - t0:.1f} s")
    return clip, clip_cut, vae


def wan_i2v_reference_check(dense_cut):
    """A 2-layer cut of the i2v-14B DiT at full width (its own first two
    blocks) in each tier of WAN_I2V_CUT_TIERS, on the card with the
    kernels against the same cut on the CPU with the plain versions, both
    in bf16: two CFG streams of 120 tokens, 64 text tokens with padding,
    257 CLIP tokens, the i2v channels. Bar: 30 dB PSNR on the velocity,
    as the t2v cut (an int8 code may round the other way)."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import model as wm
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.ops.rope import wan_rope_freqs

    cut = dataclasses.replace(wm.WAN_I2V_14B, num_layers=2)
    g = torch.Generator().manual_seed(SEED + 33)
    f, h, w = WAN_I2V_CUT_GRID
    x = torch.randn(2, f, 2 * h, 2 * w, cut.in_dim, generator=g)
    t = torch.tensor([900.0, 900.0])
    ctx = torch.randn(2, 64, cut.text_dim, generator=g)
    mask = torch.zeros(2, 64, dtype=torch.int32)
    mask[0, :40] = 1
    mask[1, :17] = 1
    clip = torch.randn(2, 257, wm.CLIP_DIM, generator=g)
    dbs = {}
    for mode in WAN_I2V_CUT_TIERS:
        models = []
        for d in (torch.device("cuda"), torch.device("cpu")):
            m = wm.WanModel(cut, DEFAULT_POLICY, device=d)
            m.load_state_dict(dense_cut)
            models.append(quantize_params(m, mode=mode))
        reset_kernel_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = models[0](*(a.cuda() for a in (x, t, ctx, mask)),
                               wan_rope_freqs((f, h, w), cut.head_dim,
                                              device="cuda"),
                               clip_features=clip.cuda())
            torch.cuda.synchronize()
            counts = kernel_counts()
            t1 = time.perf_counter()
            ref, _ = models[1](x, t, ctx, mask,
                               wan_rope_freqs((f, h, w), cut.head_dim),
                               clip_features=clip)
        assert counts["K4d128"] == 3 * cut.num_layers, (mode, counts)
        assert (counts["K2"] > 0) == (mode == "dynamic"), (mode, counts)
        o = out.float().cpu().numpy()
        r = ref.float().numpy()
        assert np.isfinite(o).all() and o.shape == r.shape
        peak = max(np.abs(r).max(), np.abs(o).max()) * 2
        mse = float(np.mean((o - r) ** 2))
        db = dbs[mode] = 10 * np.log10(peak ** 2 / mse) if mse > 0 \
            else float("inf")
        log(f"[wan_i2v] reference check, tier {mode}, 2-layer cut at full "
            f"width ({f * h * w} tokens a stream, 2 streams, 257 CLIP "
            f"tokens), kernels on the card ({t1 - t0:.2f} s) vs plain "
            f"versions on the CPU ({time.perf_counter() - t1:.1f} s): PSNR "
            f"{db:.2f} dB (bar 30), launches K4 {counts['K4']} K2 "
            f"{counts['K2']} K2p {counts['K2p']}")
        assert db >= 30.0, f"i2v reference check ({mode}) {db:.2f} dB < 30"
        del models
    return dbs


def clip_reference_check(clip_cut):
    """CLIP's first two blocks at full width (16 heads of 80, 257 tokens),
    two images, on the card (attention ``auto``: K4 at D=80) against the
    CPU (the plain K4). Bar: 30 dB."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as wc

    cfg = dataclasses.replace(wc.CLIPVisionConfig(),
                              num_layers=CLIP_CUT_BLOCKS)
    img = torch.rand(2, 224, 224, 3,
                     generator=torch.Generator().manual_seed(SEED + 34)) * 2 - 1
    outs = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        m = wc.CLIPVision(cfg, DEFAULT_POLICY, device=d)
        m.load_state_dict(clip_cut)
        reset_kernel_counts()
        outs.append(wc.visual(m, img.to(d), use_31_block=False))
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = kernel_counts()
    assert counts["K4d80"] == CLIP_CUT_BLOCKS, counts
    o, r = (t.float().cpu().numpy() for t in outs)
    assert np.isfinite(o).all() and o.shape == r.shape == (2, 257, 1280)
    peak = max(np.abs(r).max(), np.abs(o).max()) * 2
    mse = float(np.mean((o - r) ** 2))
    db = 10 * np.log10(peak ** 2 / mse) if mse > 0 else float("inf")
    log(f"[wan_i2v] CLIP reference check, {CLIP_CUT_BLOCKS} blocks at full "
        f"width, 2 images: K4 at D=80 on the card vs the plain versions on "
        f"the CPU: PSNR {db:.2f} dB (bar 30), K4 D=80 launches "
        f"{counts['K4d80']}")
    assert db >= 30.0, f"CLIP reference check {db:.2f} dB < 30"
    return db


def run_wan_i2v_request(pipe, umt5, clip, mode, tier, steps, shape):
    """One image-to-video request: UMT5, CLIP (the first frame resized to
    224 bicubic), then ``generate_i2v`` (the VAE encode of the
    conditioning clip, the denoise, the tiled decode) to pixels."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models.wan import clip as wc
    from ltx_video_gpupoor_tpu_torch.ops.attention import set_attention_mode

    height, width, frames = shape
    marks, checks = {}, {}

    def on_stage(name, value):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()
        if name == "decode":
            checks["latents_finite"] = bool(torch.isfinite(value).all())
            checks["latent_shape"] = tuple(value.shape)

    image = torch.from_numpy(synthetic_image(height, width)).cuda()
    image = image.float() / 127.5 - 1.0
    set_attention_mode(tier)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        emb, mask, t5_sec = encode_wan_prompts(umt5)
        t1 = time.perf_counter()
        feats = wc.visual(clip, wc.resize_bicubic(image[None], 224))
        torch.cuda.synchronize()
        t_clip = time.perf_counter() - t1
        video = pipe.generate_i2v(
            emb, mask, feats, image, width=width, height=height,
            frame_num=frames, sampling_steps=steps, shift=5.0,
            solver="unipc", guide_scale=5.0, cfg_zero_step=WAN_CFG_ZERO_STEP,
            generator=torch.Generator(device="cuda").manual_seed(SEED),
            output_type="pixels", on_stage=on_stage)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        set_attention_mode("auto")
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixels_finite = bool(torch.isfinite(video.float()).all())
    frames_u8 = torch.clamp((video[0].float() + 1.0) * 127.5, 0, 255)
    frames_u8 = frames_u8.to(torch.uint8).cpu().numpy()
    resident = _resident_bytes(pipe.model)
    f, h, w = checks["latent_shape"][1:4]
    stages = {"umt5": t5_sec, "clip": t_clip,
              "vae_encode": marks["denoise"] - marks["encode"],
              "denoise": marks["decode"] - marks["denoise"],
              "decode": t_end - marks["decode"], "total": t_end - t0}
    log(f"[wan_i2v] request {width}x{height}x{frames} i2v-14B tier={mode} "
        f"attention={tier}: tokens={f * (h // 2) * (w // 2)} a stream, "
        f"steps={steps} " + " ".join(f"{k}={v:.3f} s" for k, v in
                                    stages.items())
        + f" peak={peak:.2f} GiB (UMT5-XXL, CLIP, VAE and this DiT "
        f"resident) DiT resident={resident / 1e9:.3f} GB "
        f"frames={list(frames_u8.shape)} latents_finite="
        f"{checks['latents_finite']} pixels_finite={pixels_finite} "
        f"launches={counts}")
    assert frames_u8.shape == (frames, height, width, 3), frames_u8.shape
    assert checks["latents_finite"] and pixels_finite
    assert frames_u8.std() > 0, "constant frames"
    must, must_not = wan_i2v_expect(mode, tier, steps,
                                    pipe.model.cfg.num_layers,
                                    clip.cfg.num_layers - 1)
    bad = {k: (counts[k], n) for k, n in must.items() if counts[k] != n}
    assert not bad and not any(counts[k] for k in must_not), \
        (mode, tier, bad, counts)
    return counts, stages, peak, resident


def phase_wan_i2v(umt5):
    """Build i2v-14B, CLIP and the VAE with its encoder; check the cuts
    against the plain versions; serve WAN_I2V_REQUESTS with the Wan path's
    UMT5, one tier's DiT on the card at a time. Returns the launch counts
    per request."""
    import torch

    from ltx_video_gpupoor_tpu_torch.pipelines.wan import WanPipeline

    mode = WAN_I2V_REQUESTS[0][0]
    dit, dense_cut = build_wan_i2v_dit(mode, keep_cut=True)
    clip, clip_cut, vae = build_wan_i2v_encoders()
    wan_i2v_reference_check(dense_cut)
    clip_reference_check(clip_cut)
    del dense_cut, clip_cut
    launches = []
    for req_mode, tier, steps, shape in WAN_I2V_REQUESTS:
        if req_mode != mode:
            del dit            # free one tier's DiT before the next is built
            gc.collect()
            torch.cuda.empty_cache()
            mode = req_mode
            dit, _ = build_wan_i2v_dit(mode)
        launches.append(run_wan_i2v_request(
            WanPipeline(dit, vae), umt5, clip, mode, tier, steps, shape)[0])
        torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 8c: [aux], the Wan extenders, U2-Net, the legacy VAE
# --------------------------------------------------------------------------

# Qwen2.5-VL-7B-Instruct's published widths (Qwen/Qwen2.5-VL-7B-Instruct
# config.json: vision_config and the text fields)
QWEN25_VL_7B_HF = {
    "vision_config": {"depth": 32, "hidden_size": 1280,
                      "intermediate_size": 3420, "num_heads": 16,
                      "patch_size": 14, "spatial_merge_size": 2,
                      "temporal_patch_size": 2, "window_size": 112,
                      "out_hidden_size": 3584,
                      "fullatt_block_indexes": [7, 15, 23, 31]},
    "vocab_size": 152064, "hidden_size": 3584, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "intermediate_size": 18944, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
}
AUX_IMAGE = 448                       # the VL chat's image, 32x32 patches
AUX_U2NET_FRAMES = (4, 480, 832)      # salience_map's frames
AUX_REMBG = 256                       # remove_background's image side
AUX_VAE_REQUEST = (320, 512, 41)      # the legacy VAE's clip (H, W, F)
# the legacy VAE (LegacyVAEConfig's default widths) as a published file's
# config says it
LEGACY_VAE_CFG = {"_class_name": "VideoAutoencoder", "dims": 3,
                  "latent_channels": 128,
                  "block_out_channels": [128, 256, 512, 512]}
AUX_CLI_LAYERS = 2                    # the 13B transformer cut for the CLI
# the extenders' generation length here (their default is 512): each step
# is host-bound, about 30-40 ms, and the script aims at half its limit
AUX_NEW_TOKENS = 128


def _timed_cuda(fn, *args, **kwargs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def aux_qwen_vl(image):
    """Qwen2.5-VL-7B-Instruct at full width on the card: a 2-layer cut
    (2 tower blocks, the second with full attention, 2 LLM layers) against
    an fp32 copy on the CPU on a 224x224 image's patches, then one
    ``extend_with_img`` chat on the 448x448 image (AUX_NEW_TOKENS)."""
    import dataclasses

    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.models import qwen25_vl as qvl
    from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as pe
    from ltx_video_gpupoor_tpu_torch.utils.qwen_vl import preprocess_image

    cfg = qvl.config_from_hf(QWEN25_VL_7B_HF)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    (model, build_s) = _timed_cuda(lambda: qvl.init_params(
        qvl.QwenVL(cfg, device="cuda"), gen))
    n = sum(p.numel() for p in model.parameters())
    cut_cfg = qvl.QwenVLConfig(
        vision=dataclasses.replace(cfg.vision, depth=2,
                                   fullatt_block_indexes=(1,)),
        text=dataclasses.replace(cfg.text, num_layers=2))
    card, cpu = _cut(qvl.QwenVL, cut_cfg, model)
    small = np.asarray(image[:224, :224])
    patches, grid = preprocess_image(small, min_pixels=224 * 224,
                                     max_pixels=224 * 224)
    tok = qwen_tokenizer()
    ids = tok.encode("<|im_start|>user\n<|vision_start|>") + \
        [cfg.image_token_id] * (int(np.prod(grid)) // 4) + \
        tok.encode("<|vision_end|>a seeded synthetic frame<|im_end|>\n")
    ids = torch.tensor([ids])
    px = torch.from_numpy(patches)
    db = _db(qvl.forward(card, ids, px, np.asarray([grid])),
             qvl.forward(cpu, ids, px, np.asarray([grid])))
    del card, cpu
    assert db >= 30.0, f"Qwen2.5-VL cut {db:.2f} dB < 30"
    torch.cuda.reset_peak_memory_stats()
    exp = pe.QwenVLPromptExpander(vl=pe.VLChat(
        model=model, tokenizer=tok, max_new_tokens=AUX_NEW_TOKENS))
    out, chat_s = _timed_cuda(exp.extend_with_img,
                              "a seeded synthetic frame comes alive",
                              _pil(image), seed=SEED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert out and exp.vl.last_new_tokens > 0
    log(f"[aux] Qwen2.5-VL-7B-Instruct (tower {cfg.vision.depth} blocks of "
        f"{cfg.vision.hidden_size}, LLM {cfg.text.num_layers} layers of "
        f"{cfg.text.dim}, {cfg.text.num_heads}/{cfg.text.num_kv_heads} heads, "
        f"{n / 1e9:.3f} B parameters) built in {build_s:.3f} s; 2-layer cut "
        f"vs the CPU {db:.2f} dB (bar 30); extend_with_img on "
        f"{AUX_IMAGE}x{AUX_IMAGE} ({AUX_IMAGE // 28}x{AUX_IMAGE // 28} merged "
        f"patches) {chat_s:.3f} s, {exp.vl.last_new_tokens} tokens of "
        f"{exp.vl.max_new_tokens}, peak {peak:.2f} GiB")
    return {"vl_cut_db": db, "vl_chat_s": chat_s}


def aux_qwen():
    """Qwen2.5-3B-Instruct (``QWEN_2_5_3B``) on the card: one ``extend``
    (AUX_NEW_TOKENS)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.models import llm
    from ltx_video_gpupoor_tpu_torch.utils import prompt_enhance as pe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    model, build_s = _timed_cuda(lambda: llm.init_params(
        llm.LLM(llm.QWEN_2_5_3B, device="cuda"), gen))
    torch.cuda.reset_peak_memory_stats()
    exp = pe.QwenPromptExpander(lm=pe.ChatLM(
        model=model, tokenizer=qwen_tokenizer(),
        max_new_tokens=AUX_NEW_TOKENS))
    out, s = _timed_cuda(exp.extend, "a red fox runs through fresh snow",
                         seed=SEED)
    assert out and exp.lm.last_new_tokens > 0
    log(f"[aux] Qwen2.5-3B-Instruct ({model.cfg.num_layers} layers of "
        f"{model.cfg.dim}) built in {build_s:.3f} s; extend {s:.3f} s, "
        f"{exp.lm.last_new_tokens} tokens of {AUX_NEW_TOKENS}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"qwen_extend_s": s}


def _pil(image):
    from PIL import Image

    return Image.fromarray(image)


def aux_u2net(root):
    """U2-Net (``U2NET``) from a random ``u2net.pth`` in the official
    naming, loaded by ``load_torch_checkpoint`` on the card and on the CPU:
    ``salience_map`` of 4 frames at 832x480 against the CPU (bar 30 dB),
    then ``remove_background`` with the matting on one 256x256 image."""
    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.models import u2net
    from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
    from ltx_video_gpupoor_tpu_torch.utils import video_ops

    path = os.path.join(root, "u2net.pth")
    torch.save(sc.u2net_tensors(u2net.U2NET, seed=SEED + 52), path)
    card = u2net.load_torch_checkpoint(path)
    cpu = u2net.load_torch_checkpoint(path, device="cpu")
    n, h, w = AUX_U2NET_FRAMES
    frames = [synthetic_image(h, w) for _ in range(n)]
    times, dbs = [], []
    for i, f in enumerate(frames):
        f = np.roll(f, 40 * i, axis=1)
        a, s = _timed_cuda(u2net.salience_map, card, f)
        times.append(s)
        ref = u2net.salience_map(cpu, f)
        dbs.append(_db(a, ref))
    assert min(dbs) >= 30.0, dbs
    os.environ["LTXV_TPU_U2NET_PATH"] = path
    os.environ["LTXV_TPU_REMBG_MATTING"] = "1"
    try:
        img = synthetic_image(AUX_REMBG, AUX_REMBG)
        (out,), rembg_s = _timed_cuda(video_ops.remove_background, [img])
    finally:
        del os.environ["LTXV_TPU_U2NET_PATH"]
        del os.environ["LTXV_TPU_REMBG_MATTING"]
        video_ops._u2net_cache.clear()
    assert out.shape == img.shape and out.dtype == np.uint8
    log(f"[aux] U2-Net ({sum(p.numel() for p in card.parameters()) / 1e6:.1f}"
        f" M parameters, fp32) salience_map of {n} frames at {w}x{h}: "
        + " ".join(f"{s:.3f}" for s in times) + " s; vs the CPU "
        + " ".join(f"{d:.2f}" for d in dbs) + " dB (bar 30); "
        f"remove_background with matting at {AUX_REMBG}x{AUX_REMBG} "
        f"{rembg_s:.3f} s")
    return {"u2net_s": times, "rembg_s": rembg_s}


def aux_legacy_vae():
    """The legacy VAE at LegacyVAEConfig's default widths on the card:
    encode and decode of a 512x320x41 clip; the decode of a small latent
    grid against an fp32 copy on the CPU (bar 30 dB)."""
    import numpy as np
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import (
        DEFAULT_POLICY,
        FP32_POLICY,
    )
    from ltx_video_gpupoor_tpu_torch.models.ltx import video_autoencoder as lv

    cfg = lv.LegacyVAEConfig.from_dict(LEGACY_VAE_CFG)
    vae = lv.init_params(lv.LegacyVAE(cfg, DEFAULT_POLICY, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(SEED + 53))
    h, w, f = AUX_VAE_REQUEST
    clip = np.stack([synthetic_image(h, w)] * f).astype(np.float32)
    media = torch.from_numpy(clip / 127.5 - 1.0)[None].cuda()
    torch.cuda.reset_peak_memory_stats()
    enc, enc_s = _timed_cuda(lv.encode, vae, media)
    z = enc[..., :cfg.latent_channels]
    pix, dec_s = _timed_cuda(lv.decode, vae, z)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert torch.isfinite(pix).all() and torch.isfinite(enc).all()
    cpu = lv.LegacyVAE(cfg, FP32_POLICY, device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in vae.state_dict().items()})
    small = torch.randn(1, 2, 4, 6, cfg.latent_channels,
                        generator=torch.Generator().manual_seed(SEED + 54))
    db = _db(lv.decode(vae, small.cuda()), lv.decode(cpu, small))
    assert db >= 30.0, f"legacy VAE decode {db:.2f} dB < 30"
    log(f"[aux] legacy VAE (dims 3, {list(cfg.block_out_channels)}, latent "
        f"{cfg.latent_channels}, bf16): encode {w}x{h}x{f} -> "
        f"{list(enc.shape[1:4])} latents {enc_s:.3f} s, decode -> "
        f"{list(pix.shape[1:4])} {dec_s:.3f} s, peak {peak:.2f} GiB; "
        f"decode of a {list(small.shape[1:4])} grid vs the CPU {db:.2f} dB "
        f"(bar 30); the headline 704x480x121 not run (predicted peak over "
        f"50 GiB: fp32 group-norm temporaries of 128 channels at full "
        f"resolution)")
    return {"vae_encode_s": enc_s, "vae_decode_s": dec_s, "vae_db": db}


def aux_cli_legacy(root):
    """``cli.main`` from synthetic published-layout files whose VAE is a
    legacy one (the 13B-dev transformer at full width, AUX_CLI_LAYERS
    layers; the distilled LoRA; the upscaler): load_ltxv_model's legacy
    branch, a 512x320x41 text-to-video request; the mp4 must read back.
    Returns the request's launches."""
    import dataclasses

    import numpy as np

    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import video_autoencoder as lv
    from ltx_video_gpupoor_tpu_torch.serving import cli, model_zoo
    from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
    from ltx_video_gpupoor_tpu_torch.utils import media

    cfg = dataclasses.replace(ltx13b_config(), num_layers=AUX_CLI_LAYERS)
    up_cfg = lup.LatentUpsamplerConfig(in_channels=128, mid_channels=512,
                                       num_blocks_per_stage=4, dims=3)
    ckpt = os.path.join(root, "ckpts")
    info = sc.write_ltxv_ckpt_dir(ckpt, cfg, LEGACY_VAE_CFG, up_cfg,
                                  lora_rank=LOAD_LORA_RANK, seed=SEED + 55,
                                  device="cuda")
    h, w, f = AUX_VAE_REQUEST
    out_mp4 = os.path.join(root, "legacy.mp4")
    loaded = {}
    real = model_zoo.load_ltxv_model

    def load(*a, **k):
        loaded["model"] = real(*a, **k)
        return loaded["model"]

    model_zoo.load_ltxv_model = load
    reset_kernel_counts()
    try:
        _, s = _timed_cuda(cli.main, [
            "--prompt", "a red fox runs through fresh snow", "--model-mode",
            "ltxv_13B_distilled", "--ckpt-dir", ckpt, "--height", str(h),
            "--width", str(w), "--video-length", str(f), "--seed", str(SEED),
            "--quantize-transformer", "--output-path", out_mp4])
    finally:
        model_zoo.load_ltxv_model = real
    launches = kernel_counts()
    vae = loaded.pop("model").generator.pipeline.vae
    assert isinstance(vae, lv.LegacyVAE), type(vae)
    back = media.load_video(out_mp4)
    assert back.shape == (f, h, w, 3) and np.isfinite(back).all(), back.shape
    assert launches["K2"] > 0, launches
    log(f"[aux] cli.main on synthetic files ({AUX_CLI_LAYERS} of 48 layers, "
        f"{info['bytes'][sc.VAE_FILE] / 1e9:.3f} GB legacy VAE file) through "
        f"load_ltxv_model's legacy branch: {w}x{h}x{f} text-to-video "
        f"{s:.3f} s with the load; the mp4 reads back as {back.shape[0]} "
        f"frames; launches { {k: n for k, n in launches.items() if n} }")
    del vae
    return launches


def phase_aux():
    """[aux] on a free card: the Wan prompt extenders (Qwen2.5-VL-7B,
    Qwen2.5-3B), U2-Net and background removal, the legacy VAE, and a
    CLI run through the legacy-VAE loader. Returns the CLI's launches."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    image = synthetic_image(AUX_IMAGE, AUX_IMAGE)
    root = tempfile.mkdtemp(prefix="aux_")
    try:
        for step in (lambda: aux_qwen_vl(image), aux_qwen,
                     lambda: aux_u2net(root), aux_legacy_vae):
            step()
            gc.collect()
            torch.cuda.empty_cache()
        launches = aux_cli_legacy(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[aux] the phase {time.perf_counter() - t0:.3f} s")
    return launches


# --------------------------------------------------------------------------
# phase 9 (--profile): where the device time of the headline requests goes
# --------------------------------------------------------------------------

# kernel name fragment -> group, first match wins
# K3 is the instance of K1's kernel whose fourth template argument (BOUNDED)
# is true: "...flash_wgmma_kernel<128, 0, false, true, 128>" (the fifth is
# the head's values, DV)
BOUNDED_GROUPS = [
    # K2's row kernel on the attention prologue's contract (template
    # argument CONTRACT = 1; K5's row kernel shares the name's tail)
    (re.compile(r"(?<!norm_mod_)quantize_rows_kernel<[^,]*, 1,"),
     "int8 attention prologue (K2's row kernel)"),
    (re.compile(r"flash_wgmma_kernel<[^,>]*, [^,>]*, [^,>]*, true\b"),
     "K3 bounded-score flash attention"),
    (re.compile(r"k3q_wgmma_kernel"),
     "K3q int8-QK bounded-score flash attention"),
]
KERNEL_GROUPS = [
    ("flash_wgmma_kernel", "K1 / K6 exact flash attention"),
    ("norm_mod_quantize_rows_kernel", "K5 prologue row kernel"),
    ("flash_int8", "K4 int8 flash attention"),
    ("int8_gemm", "K2 / K5 int8 GEMM"),
    ("quantize_rows_kernel", "K2 row quantize"),
    ("fprop", "cuDNN conv3d (VAE)"),
    ("cudnn", "cuDNN conv3d (VAE)"),
    ("nvjet", "cuBLAS GEMM (T5)"),
    ("gemm", "cuBLAS GEMM (T5)"),
]
ELEMENTWISE = "PyTorch elementwise and copies"
# PyTorch's own kernels, by the port's function that launched them: during a
# profiled request these are wrapped in record_function scopes of these
# names (module, attribute, scope); a kernel takes the innermost scope
# around its launch
PROFILED_OPS = [
    ("models.ltx.transformer3d", "apply_rotary_emb", "RoPE"),
    ("models.wan.model", "apply_rotary_emb_shared_heads", "RoPE"),
    ("models.ltx.transformer3d", "rms_norm", "norms"),
    ("models.ltx.transformer3d", "layer_norm", "norms"),
    ("models.wan.model", "rms_norm", "norms"),
    ("models.wan.model", "layer_norm", "norms"),
    ("models.ltx.transformer3d.F", "gelu", "GELU / GEGLU"),
    ("models.wan.model.F", "gelu", "GELU / GEGLU"),
    ("ops.flash_attention", "int8_prologue",
     "int8 attention prologue (torch ops)"),
]


def _op_group(name):
    """A PyTorch kernel's group by its name alone: casts and copies."""
    name = name.lower()
    if "copy" in name or "cast" in name or "memcpy" in name:
        return "casts and copies"
    return None


def summarize_trace(path):
    """Device time of a torch.profiler chrome trace, from its ``kernel``,
    ``gpu_memcpy`` and ``gpu_memset`` events: the span from the first
    start to the last end, busy time (the union of the intervals, so
    overlap counts once), the idle share 1 - busy/span, and the summed
    durations by kernel group. PyTorch's own kernels are split by the
    ``record_function`` scope (PROFILED_OPS) around the launch that the
    kernel's correlation id names, then casts and copies by name, the rest
    as "other"."""
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    events = [e for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("ph") == "X"]
    if not events:
        raise RuntimeError(f"{path}: the trace holds no device events")
    # the host-side launch of each correlation id, and the scopes by thread
    launch = {}
    scopes = {}
    for e in trace:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e.get("tid"), e["ts"])
        elif e.get("cat") == "user_annotation":
            scopes.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))

    def scope_of(e):
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is None:
            return None
        inner = None
        for t0, t1, name in scopes.get(where[0], ()):
            if t0 <= where[1] <= t1 and (inner is None or t0 >= inner[0]):
                inner = (t0, name)
        return inner[1] if inner else None

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
        group = None
        if e["cat"] == "kernel":
            name = e["name"].lower()
            group = next((g for pat, g in BOUNDED_GROUPS if pat.search(name)),
                         None) or next(
                (g for frag, g in KERNEL_GROUPS if frag in name), None)
        if group is None:
            sub = scope_of(e) or _op_group(e["name"]) or "other"
            group = f"{ELEMENTWISE}: {sub}"
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e["dur"] / 1e3, n + 1)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / span, "groups": groups}


class _ProfiledOps:
    """While open, the port's functions of PROFILED_OPS run inside
    ``record_function`` scopes named by their group; restored on exit."""

    def __enter__(self):
        import importlib
        import types

        import torch

        self.saved = []
        for mod, attr, label in PROFILED_OPS:
            path = mod.split(".")
            functional = path[-1] == "F"
            owner = importlib.import_module(
                "ltx_video_gpupoor_tpu_torch." + ".".join(
                    path[:-1] if functional else path))
            if functional:
                # the module's own torch.nn.functional, a copy: the scope
                # reaches no other module (T5's GELU stays out of it)
                own = types.ModuleType(owner.F.__name__)
                own.__dict__.update(vars(owner.F))
                self.saved.append((owner, "F", owner.F))
                setattr(owner, "F", own)
                owner = own
            fn = getattr(owner, attr)

            def scoped(*a, _fn=fn, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            if hasattr(fn, "__dict__"):
                # one dict: a launch counter kept on the function (the
                # prologue's kernel_launches) counts through either name
                scoped.__dict__ = fn.__dict__

            self.saved.append((owner, attr, fn))
            setattr(owner, attr, scoped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        return False


def _traced(path, run, scoped):
    """``run()`` under torch.profiler, its trace exported to ``path``,
    with PROFILED_OPS's scopes on if ``scoped``; (wall s, summary)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with _ProfiledOps() if scoped else contextlib.nullcontext(), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return wall, summarize_trace(path)


def profile_request(name, run):
    """Run one more request (``run()``) twice under torch.profiler: as it
    is, for its device span, busy time and idle share, then with
    PROFILED_OPS's scopes on (host work at every scoped call, which would
    widen the gaps) for the time by kernel group; the traces go to the
    ignored build directory. Returns the second run's summary."""
    out_dir = os.path.join(ROOT, "ltx_video_gpupoor_tpu_torch", "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{name}.json")
    wall, s = _traced(path, run, scoped=False)
    log(f"[profile] {name} with the profiler on: wall "
        f"{wall:.3f} s; device span {s['span_ms']:.1f} ms, busy "
        f"{s['busy_ms']:.1f} ms, idle {100 * s['idle_share']:.2f} %; "
        f"trace {os.path.relpath(path, ROOT)}")
    path = os.path.join(out_dir, f"trace_{name}_scoped.json")
    wall, g = _traced(path, run, scoped=True)
    log(f"[profile] {name} again with the op scopes on: wall {wall:.3f} s; "
        f"device span {g['span_ms']:.1f} ms, busy {g['busy_ms']:.1f} ms, "
        f"idle {100 * g['idle_share']:.2f} %; by kernel group:")
    for group, (ms, n) in sorted(g["groups"].items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {group}: {ms:.1f} ms "
            f"({100 * ms / g['busy_ms']:.1f} % of busy), {n} events")
    return g


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
            2: "K3 bounded-score flash attention",
            3: "K3q int8-QK bounded-score flash attention"}[tier]
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
                    "tiers (b), (c) and (d), Wan 832x480x81) and print the "
                    "device time by kernel group")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks and timings (phases "
                    "1 to 6): no path is driven, so no result line is "
                    "printed; for work on a kernel")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    kind, ex2_per_s = phase_device()
    phase_build(compare=args.profile)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_err = phase_k1(gen)
    k2_err, rows_err = phase_k2(gen)
    prologue_err = phase_prologue(gen)
    k4_err = phase_k4(gen)
    k3_err = phase_k3(gen)
    k3q_err = phase_k3q(gen)
    k1_d80_err, k4_d80_err, k3q_d80_err, k1f_d80_err = phase_d80(gen)
    k5_err = phase_k5(gen)
    k6_err = phase_k6(gen)
    k1f_err = phase_k1f(gen)
    times, info = phase_timing(gen, ex2_per_s)
    time_k1f(gen, times, info, ex2_per_s)
    k8_err, k8_launches = phase_k8(gen, times, info)
    k7_err, k7_launches = phase_k7(gen, times, info)
    log(f"[clock] kernel checks and timings done at "
        f"{time.perf_counter() - t_start:.0f} s")
    if args.kernels_only:
        return 0
    ltx_launches, generator, t5 = phase_path()
    phase_teacache(generator, t5)
    fp32_launches = phase_fp32(t5)
    if args.profile:
        profile_ltx(generator, t5)
    del generator            # free the LTX-2B DiT; the 13B path keeps T5
    torch.cuda.empty_cache()
    log(f"[clock] LTX-2B path done at {time.perf_counter() - t_start:.0f} s")
    ltx13b_launches, generator13b = phase_ltx13b(t5)
    if args.profile:
        for tier in (1, 2, 3):
            profile_ltx13b(generator13b, t5, tier)
    del generator13b, t5     # free the LTX models for the Wan path
    torch.cuda.empty_cache()
    log(f"[clock] LTX-13B path done at {time.perf_counter() - t_start:.0f} s")
    load_launches = phase_load()
    log(f"[clock] load path done at {time.perf_counter() - t_start:.0f} s")
    cli_launches = phase_cli()
    wan_launches, pipe, umt5 = phase_wan()
    if args.profile:
        profile_wan(pipe, umt5)
    log(f"[clock] Wan path done at {time.perf_counter() - t_start:.0f} s")
    variant_launches = phase_wan_variants(pipe, umt5)
    del pipe                 # free Wan t2v-1.3B; i2v-14B keeps UMT5
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[clock] Wan variants done at {time.perf_counter() - t_start:.0f} s")
    i2v_launches = phase_wan_i2v(umt5)
    del umt5
    torch.cuda.empty_cache()
    log(f"[clock] Wan i2v path done at {time.perf_counter() - t_start:.0f} s")
    aux_launches = phase_aux()
    log(f"[clock] aux models done at {time.perf_counter() - t_start:.0f} s")
    by_tier = dict(zip((m for *_, m in WAN_REQUESTS), wan_launches))
    tier_b, tier_c, tier_d = (t[0] for t in LTX13B_TIERS[1:4])
    k2_key = f"K2 {K2_TIMED}"
    k5_key = f"K5 {K5_TIMED}"
    # tier (b)'s kernels over its two POST / requests, the enhanced one too
    served = {k: ltx13b_launches[tier_b][k] + ltx13b_launches[ENHANCED][k]
              for k in ("K5", "K6")}
    kernels = [
        kernel_entry("flash_attention (exact online softmax)", K1_SOURCE,
                     K1_REPLACES, ltx_launches[-1]["K1"], k1_err, times, info,
                     "K1 self"),
        kernel_entry("int8_linear (dynamic int8)", K2_SOURCE, K2_REPLACES,
                     wan_launches[-1]["K2"], k2_err, times, info, k2_key),
        kernel_entry("quantize_rows (K2's row kernel: per-row absmax, scale "
                     "and int8 codes)", K2_SOURCE, K2_REPLACES,
                     wan_launches[-1]["K2"], rows_err, times, info,
                     f"K2 rows {K2_ROWS_TIMED}"),
        kernel_entry("int8_prologue (K2's row kernel on the int8 attention "
                     "prologue's contract: Q, and K in the QK tier)",
                     K2_SOURCE, PROLOGUE_REPLACES,
                     ltx13b_launches[tier_d]["K2p"], prologue_err, times,
                     info,
                     "prologue self pass 2"),
        kernel_entry("flash_attention_int8 (int8 QK + int8 PV)", K4_SOURCE,
                     K4_REPLACES, wan_launches[-1]["K4"], k4_err[0], times,
                     info, "K4 int8pv self"),
        kernel_entry("flash_attention_int8 (int8 QK + bf16 PV)", K4_SOURCE,
                     K4_REPLACES, by_tier["pallas_int8"]["K4"], k4_err[1],
                     times, info, "K4 int8qk self"),
        kernel_entry("flash_attention (bounded scores, no running max)",
                     K3_SOURCE, K3_REPLACES, ltx13b_launches[tier_c]["K3"],
                     k3_err, times, info, "K3 self pass 2"),
        kernel_entry("flash_attention_int8 (int8 QK, bounded scores, no "
                     "running max)", K3Q_SOURCE, K3Q_REPLACES,
                     ltx13b_launches[tier_d]["K3q"], k3q_err, times, info,
                     "K3q self pass 2"),
        kernel_entry("norm_mod_int8_matmul (fused adaLN prologue + int8 "
                     "linear)", K5_SOURCE, K5_REPLACES, served["K5"], k5_err,
                     times, info, k5_key),
        kernel_entry("flash_attention_hp (head-packed exact attention)",
                     K1_SOURCE, K6_REPLACES, served["K6"], k6_err, times,
                     info, "K6 self pass 2"),
        kernel_entry("ring_attention_rdma (ring attention, the whole ring "
                     f"in one cooperative launch, p={RING_TIMED_P})",
                     K7_SOURCE, K7_REPLACES, k7_launches, k7_err, times, info,
                     f"K7 p={RING_TIMED_P}"),
        kernel_entry("pipelined_attention (sub-block-pipelined attention, "
                     f"nsub={K8_JSON_NSUB})", K8_SOURCE, K8_REPLACES,
                     k8_launches, k8_err, times, info,
                     f"K8 nsub {K8_JSON_NSUB}"),
        kernel_entry("flash_attention_fp32 (fp32 attention on split-TF32 "
                     "wgmma, FP32_POLICY)", K1F_SOURCE, K1F_REPLACES,
                     fp32_launches["K1f"], k1f_err, times, info, "K1f self"),
    ]
    # CLIP's attention at d = 80 in the i2v requests: K4 under auto
    # (requests 1 and 2), K1 with the exact tier pinned (request 3)
    i2v_d80 = {k: sum(c[k] for c in i2v_launches) for k in ("K1d80", "K4d80")}
    # K3q's and K1f's d=80 launches summed over every request's counts
    runs = [*ltx_launches, fp32_launches, *ltx13b_launches.values(),
            load_launches, cli_launches, *wan_launches,
            *variant_launches.values(), *i2v_launches, aux_launches]
    path_d80 = {k: sum(c[k] for c in runs) for k in ("K3qd80", "K1fd80")}
    kernels += [
        kernel_entry("flash_attention (exact online softmax, d=80: CLIP "
                     "ViT-H/14's heads in the D=128 layout)", K1_SOURCE,
                     K1_REPLACES, i2v_d80["K1d80"], k1_d80_err,
                     times, info, "K1 CLIP d=80"),
        kernel_entry("flash_attention_int8 (int8 QK + int8 PV, d=80: CLIP "
                     "ViT-H/14's heads in the D=128 layout)", K4_SOURCE,
                     K4_REPLACES, i2v_d80["K4d80"], k4_d80_err,
                     times, info, "K4 CLIP d=80"),
        # CLIP in FP32_POLICY ([wan_variants]): K1f's pv8 variant at d=80
        kernel_entry("flash_attention_fp32 (fp32 attention on split-TF32 "
                     "wgmma, d=80: CLIP ViT-H/14's heads in the D=128 "
                     "layout)", K1F_SOURCE, K1F_REPLACES, path_d80["K1fd80"],
                     k1f_d80_err, times, info, "K1f CLIP d=80"),
        kernel_entry("flash_attention_int8 (int8 QK, bounded scores, no "
                     "running max, d=80: CLIP ViT-H/14's heads in the "
                     "D=128 layout)", K3Q_SOURCE, K3Q_REPLACES,
                     path_d80["K3qd80"], k3q_d80_err, times, info,
                     "K3q CLIP d=80"),
    ]
    next(k for k in kernels if k["source"] == K8_SOURCE)["ms_by_nsub"] = {
        str(n): times[f"K8 nsub {n}"][0] for n in (1, 2, 4, 8)}
    # every kernel a path runs launched; K3q's d=80 instance runs on none
    # (CLIP passes no score bound), so its measured count may be 0: its
    # checks and time are phase_d80's and phase_timing's
    k3q_d80 = kernels[-1]
    assert all(k["launches"] > 0 for k in kernels if k is not k3q_d80), \
        kernels
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
