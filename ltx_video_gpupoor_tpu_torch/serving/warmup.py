"""Serving warm-up: make the first real request as fast as a later one.

Port of ``ltx_video_gpupoor_tpu/serving/warmup.py`` (same spec strings,
same environment variable). On the TPU a warm-up compiles the serving
programs; PyTorch runs eagerly, so what a cold process pays here is the
build of the kernel library (``ops/_lib.py``: nvcc at first use), cuDNN's
choice of convolution algorithms and the allocator's first blocks. At
startup the server runs one 1-step generation per configured bucket in a
background thread, under the generation lock; on a serving mesh every
rank runs each bucket, so that the ranks' first collectives (NCCL sets a
communicator's connections up at its first calls) are paid before the
first request too.

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

from ..utils.observability import Metrics, locked, request, stage

logger = logging.getLogger(__name__)

DEFAULT_BUCKET = (704, 480, 121)
HASH_TEXT_LEN = 128     # serving/cli.py::hash_prompt_embeds' length


def warm_bucket(generator, bucket, lock: threading.Lock | None = None
                ) -> None:
    """One ``(W, H, F)`` bucket's 1-step image-to-video generation, as the
    live server path requests it (a multi-scale config keeps its own
    timesteps), under ``lock`` where one is given. Every rank of a
    serving mesh runs it for the same bucket (``serving/server.py``). It
    is recorded as a request of kind ``warmup``."""
    w, h, f = bucket
    pipe = generator.pipeline
    cap = pipe.transformer.cfg.caption_channels
    emb = torch.zeros((2, HASH_TEXT_LEN, cap), dtype=torch.bfloat16)
    mask = torch.ones((2, HASH_TEXT_LEN), dtype=torch.int32)
    img = np.zeros((h, w, 3), np.uint8)
    dev = pipe.transformer.proj_out.bias.device
    with request("warmup", bucket=[w, h, f]):
        with locked(lock) if lock is not None else \
                contextlib.nullcontext(), stage("generate", anchor=dev):
            generator.generate(
                emb, mask, height=h, width=w, frame_num=f, image_start=img,
                sampling_steps=1, seed=0, output_type="pixels")


def warmup_shapes(generator, buckets=None,
                  lock: threading.Lock | None = None, run=None) -> float:
    """Run :func:`warm_bucket` for each ``(W, H, F)`` bucket (on the card
    the kernel library is built first). Returns elapsed seconds. A bucket
    that fails is logged and never takes the server down; the counters
    ``warmup_ok`` and ``warmup_failed`` of ``Metrics`` (``GET /metrics``)
    say how each bucket ended.

    ``lock``: the server's generation lock, held per bucket, so a warm-up
    never runs beside a live request (two full-size generations do not
    share one card's memory); a request arriving mid-bucket waits for that
    bucket, not for the whole warm-up. ``run(bucket)``, where given, runs
    a bucket instead (a serving mesh hands it to every rank, and takes the
    lock itself)."""
    buckets = list(buckets or [DEFAULT_BUCKET])
    t0 = time.time()
    dev = generator.pipeline.transformer.proj_out.bias.device
    if dev.type == "cuda":
        from ..ops import _lib

        _lib.library()
    if run is None:
        def run(bucket):
            warm_bucket(generator, bucket, lock)
    for w, h, f in buckets:
        try:
            run((w, h, f))
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
    lock: threading.Lock | None = None, run=None,
) -> threading.Thread | None:
    """Kick off the warm-up per ``spec`` (default: the ``LTXV_TPU_WARMUP``
    environment variable) without blocking startup; ``lock`` and ``run``
    as :func:`warmup_shapes` takes them."""
    if spec is None:
        spec = os.environ.get("LTXV_TPU_WARMUP", "default")
    buckets = parse_buckets(spec)
    if not buckets:
        return None
    th = threading.Thread(
        target=warmup_shapes, args=(generator, buckets),
        kwargs={"lock": lock, "run": run}, name="ltxv-warmup", daemon=True,
    )
    th.start()
    return th
