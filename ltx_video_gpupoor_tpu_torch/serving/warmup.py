"""Serving warm-up: make the first real request as fast as a later one.

Port of ``ltx_video_gpupoor_tpu/serving/warmup.py`` (same spec strings,
same environment variable). On the TPU a warm-up compiles the serving
programs; PyTorch runs eagerly, so what a cold process pays here is the
build of the kernel library (``ops/_lib.py``: nvcc at first use), cuDNN's
choice of convolution algorithms and the allocator's first blocks. At
startup the server runs one 1-step generation per configured bucket in a
background thread, under the generation lock.

Env:
- ``LTXV_TPU_WARMUP``: comma-separated ``WxHxF`` buckets, ``default`` for
  the standard serving shape, or ``off`` (default: ``default``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import numpy as np
import torch

from ..utils.observability import Metrics

logger = logging.getLogger(__name__)

DEFAULT_BUCKET = (704, 480, 121)
HASH_TEXT_LEN = 128     # serving/cli.py::hash_prompt_embeds' length


def warmup_shapes(generator, buckets=None,
                  lock: threading.Lock | None = None) -> float:
    """Run a 1-step image-to-video generation for each ``(W, H, F)``
    bucket, as the live server path requests it (a multi-scale config
    keeps its own timesteps; on the card the kernel library is built
    first). Returns elapsed seconds. A bucket that fails
    is logged and never takes the server down; the counters ``warmup_ok``
    and ``warmup_failed`` of ``Metrics`` (``GET /metrics``) say how each
    bucket ended.

    ``lock``: the server's generation lock, held per bucket, so a warm-up
    never runs beside a live request (two full-size generations do not
    share one card's memory); a request arriving mid-bucket waits for that
    bucket, not for the whole warm-up."""
    buckets = list(buckets or [DEFAULT_BUCKET])
    t0 = time.time()
    pipe = generator.pipeline
    dev = pipe.transformer.proj_out.bias.device
    if dev.type == "cuda":
        from ..ops import _lib

        _lib.library()
    cap = pipe.transformer.cfg.caption_channels
    emb = torch.zeros((2, HASH_TEXT_LEN, cap), dtype=torch.bfloat16)
    mask = torch.ones((2, HASH_TEXT_LEN), dtype=torch.int32)
    ctx = lock if lock is not None else contextlib.nullcontext()
    for w, h, f in buckets:
        img = np.zeros((h, w, 3), np.uint8)
        try:
            with ctx:
                generator.generate(
                    emb, mask, height=h, width=w, frame_num=f,
                    image_start=img, sampling_steps=1, seed=0,
                    output_type="pixels")
            Metrics.inc("warmup_ok")
            logger.info("warmup %dx%dx%df done (%.1f s elapsed)",
                        w, h, f, time.time() - t0)
        except Exception as e:  # a warm-up must never take the server down
            Metrics.inc("warmup_failed")
            logger.warning("warmup %dx%dx%df failed: %s", w, h, f, e)
    return time.time() - t0


def parse_buckets(spec: str):
    """``"704x480x121,512x512x57"`` -> [(704, 480, 121), (512, 512, 57)];
    ``"default"`` -> [DEFAULT_BUCKET]; ``"off"``/empty -> []."""
    spec = (spec or "").strip().lower()
    if not spec or spec in ("off", "0", "false", "none"):
        return []
    out = []
    for part in spec.split(","):
        part = part.strip()
        if part == "default":
            out.append(DEFAULT_BUCKET)
            continue
        w, h, f = (int(x) for x in part.split("x"))
        out.append((w, h, f))
    return out


def start_background_warmup(
    generator, spec: str | None = None,
    lock: threading.Lock | None = None,
) -> threading.Thread | None:
    """Kick off the warm-up per ``spec`` (default: the ``LTXV_TPU_WARMUP``
    environment variable) without blocking startup."""
    if spec is None:
        spec = os.environ.get("LTXV_TPU_WARMUP", "default")
    buckets = parse_buckets(spec)
    if not buckets:
        return None
    th = threading.Thread(
        target=warmup_shapes, args=(generator, buckets),
        kwargs={"lock": lock}, name="ltxv-warmup", daemon=True,
    )
    th.start()
    return th
