"""Inference CLI.

Port of ``ltx_video_gpupoor_tpu/serving/cli.py``: ``parse_args`` (:20, the
same flags and defaults, pinned by ``tests/test_torch_serving.py``),
``encode_or_hash`` (:97), ``hash_prompt_embeds`` (:109), ``infer`` (:125)
and ``main``. Without ``--demo`` the LTX stack is loaded from the files in
``--ckpt-dir`` (``model_zoo.load_ltxv_model``; nothing is downloaded);
``--demo`` runs the full surface with tiny random weights. ``--teacache``
skips steps, ``--save-quantized`` writes the transformer as a quanto int8
file into ``--ckpt-dir``, and the frames go to the native h264 writer as
planar YUV420 where it builds. What needs a module not ported yet raises
``NotImplementedError`` naming its ROADMAP step: ``--enhance-prompt``.
``--quantize-transformer`` quantizes in the tier ``--int8-mode`` names
(``dynamic``, ``wo``, ``wo_int4`` or ``mixed_int4``).

    python3 -m ltx_video_gpupoor_tpu_torch.serving.cli --demo \\
        --prompt "a red fox" --height 256 --width 256 --video-length 9
    python3 -m ltx_video_gpupoor_tpu_torch.serving.cli --prompt "a red fox" \\
        --model-mode ltxv_13B_distilled --ckpt-dir ckpts --quantize-transformer

It runs on the card; ``--device cpu`` runs on the CPU with the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LTXV Video Generation Inference")
    p.add_argument("--prompt", type=str, required=True,
                   help="Input prompt for video generation")
    p.add_argument("--negative-prompt", type=str, default="")
    p.add_argument("--image-start", type=str, default=None,
                   help="Path to start image")
    p.add_argument("--image-end", type=str, default=None,
                   help="Path to end image")
    p.add_argument("--video-source", type=str, default=None,
                   help="Path to input video")
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--image-cond-noise-scale", type=float, default=0.15)
    p.add_argument("--input-media-path", type=str, default=None)
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--video-length", type=int, default=81,
                   help="Number of frames")
    p.add_argument("--frame-rate", type=int, default=30)
    p.add_argument("--fit-into-canvas", action="store_true")
    p.add_argument(
        "--teacache", type=float, default=0.0,
        help="TeaCache speed multiplier (e.g. 1.75); 0 disables. "
        "Step-skip cache over the DiT (the reference ships this for "
        "Wan only)",
    )
    p.add_argument(
        "--bucket-resolution", action="store_true",
        help="snap H/W to the nearest aspect-ratio bin (a bounded set "
        "of shapes; see utils/resolution.py)",
    )
    p.add_argument(
        "--enhance-prompt", action="store_true",
        help="cinematic prompt rewrite before encoding (Florence-2 "
        "caption + LLM rewrite); not ported yet (ROADMAP queue 1 step 14)",
    )
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--VAE-tile-size", type=int, default=None)
    p.add_argument("--model-mode", type=str, default="ltxv_13B")
    p.add_argument("--quantization", type=str, default="int8")
    p.add_argument("--transformer-dtype-policy", type=str, default="")
    p.add_argument("--quantize-transformer", action="store_true")
    p.add_argument(
        "--int8-mode", choices=("dynamic", "wo", "wo_int4", "mixed_int4"),
        default="dynamic",
        help="quantized runtime: dynamic-activation int8, int8 "
        "weight-only dequant, nibble-packed int4 weight-only, or "
        "mixed_int4 (int4, and int8 weight-only where the output is "
        "sensitive)",
    )
    p.add_argument("--mixed-precision-transformer", action="store_true")
    p.add_argument("--save-quantized", action="store_true")
    p.add_argument("--output-path", type=str, default=None)
    p.add_argument("--profile-type-id", type=int, default=2,
                   choices=[1, 2, 3, 4, 5],
                   help="Residency/sharding profile (parity flag; weights "
                        "are resident in device memory)")
    # additions of this stack
    p.add_argument("--ckpt-dir", type=str, default="ckpts")
    # default None = flag not given: leave the process-wide mode alone so
    # an LTXV_TPU_ATTN env pin survives; an explicit flag (incl. an
    # explicit --attention auto) always wins
    p.add_argument("--attention", type=str, default=None,
                   choices=["auto", "pallas", "pallas_hp", "pallas_int8",
                            "pallas_int8pv", "xla"])
    p.add_argument("--demo", action="store_true",
                   help="Run with a tiny random-weight model (offline smoke)")
    return p.parse_args(argv)


def encode_or_hash(pipe, prompt: str, negative: str):
    """The text conditioning of a request: ONE definition shared by the
    CLI and the HTTP server, so the encode path (and its sequence length)
    cannot diverge between the two. The tokenizer files are not in the
    repository and, as in the JAX package's loader, none is loaded (a T5
    checkpoint may be: ``LoadedModel.t5``), so it is always the
    deterministic demo hash embeddings."""
    return hash_prompt_embeds(
        prompt, negative, 128, pipe.transformer.cfg.caption_channels)


def hash_prompt_embeds(prompt: str, negative: str, seq_len: int, dim: int):
    """Deterministic pseudo text embeddings for --demo runs (no T5
    weights): fp32 ``[2, seq_len, dim]`` (negative, positive) and an int32
    mask of ones, on the CPU. The JAX package draws them with
    ``jax.random.key(seed)``; here a ``torch.Generator`` takes the same
    seed, so the values differ between the two packages."""

    def one(text):
        seed = int.from_bytes(
            hashlib.sha256(text.encode()).digest()[:4], "little")
        return torch.randn((seq_len, dim),
                           generator=torch.Generator().manual_seed(seed))

    emb = torch.stack([one("neg:" + negative), one("pos:" + prompt)])
    mask = torch.ones((2, seq_len), dtype=torch.int32)
    return emb, mask


def _not_ported(what: str, step: str):
    raise NotImplementedError(f"{what}: {step}")


def infer(args) -> str:
    from ..ops.attention import set_attention_mode
    from ..utils import media as media_utils
    from . import model_zoo

    if args.attention is not None:
        set_attention_mode(args.attention)
    if args.enhance_prompt:
        _not_ported("--enhance-prompt (prompt enhancers)",
                    "ROADMAP queue 1 step 14")

    if args.demo:
        model = model_zoo.build_demo_model(args.seed, device=args.device)
    else:
        tf_file, te_file = model_zoo.select_model_files(
            args.model_mode, args.quantization, args.transformer_dtype_policy)
        try:
            from . import downloads

            downloads.prepare_models_and_enhancers(te_file,
                                                   ckpt_dir=args.ckpt_dir)
        except Exception as e:
            # a partly provisioned directory goes on to the loader, which
            # names exactly the file that is missing
            print(f"checkpoint download skipped: {e}")
        model = model_zoo.load_ltxv_model(
            tf_file, args.model_mode, args.ckpt_dir, te_file,
            device=args.device)

    gen = model.generator
    pipe = gen.pipeline
    if args.save_quantized:
        from ..core.checkpoint import save_quantized_model

        out = save_quantized_model(
            os.path.join(args.ckpt_dir, f"{args.model_mode}"),
            pipe.transformer)
        print(f"saved quantized transformer: {out}")
    if args.quantize_transformer:
        from ..ops.quant import quantize_params

        quantize_params(pipe.transformer, mode=args.int8_mode)
    if args.VAE_tile_size is not None:
        # 0 disables tiling entirely; otherwise hw tile pixels (+ z tiling)
        pipe.vae_tile_size = (
            (0, 0) if args.VAE_tile_size == 0 else (4, args.VAE_tile_size))
    image_start = image_end = input_video = None
    if args.image_start or args.image_end:
        from PIL import Image

        def _load_rgb(path):
            return np.asarray(Image.open(path).convert("RGB"))

        if args.image_start:
            image_start = _load_rgb(args.image_start)
        if args.image_end:
            image_end = _load_rgb(args.image_end)
    if args.video_source:
        input_video = media_utils.load_video(args.video_source)

    embeds, mask = encode_or_hash(pipe, args.prompt, args.negative_prompt)
    from ..utils import native_codec

    # planar-YUV420 fetch halves the host-transfer bytes when the native
    # writer can take the planes directly (JAX :209-213)
    out_type = "yuv420" if native_codec.available() else "pixels"
    frames = gen.generate(
        embeds, mask,
        height=args.height, width=args.width,
        frame_num=args.video_length, frame_rate=args.frame_rate,
        seed=args.seed,
        image_start=image_start, image_end=image_end,
        input_video=input_video,
        image_cond_noise_scale=args.image_cond_noise_scale,
        fit_into_canvas=args.fit_into_canvas,
        bucket_resolution=args.bucket_resolution,
        teacache_multiplier=args.teacache,
        sampling_steps=args.num_inference_steps,
        strength=args.strength,
        output_type=out_type,
    )

    out_path = args.output_path
    if out_path is None:
        os.makedirs("outputs", exist_ok=True)
        out_path = os.path.join("outputs", f"video_{int(time.time())}.mp4")
    media_utils.save_video(frames, out_path, fps=args.frame_rate)
    print(out_path)
    return out_path


def main(argv=None):
    return infer(parse_args(argv))


if __name__ == "__main__":
    main()
