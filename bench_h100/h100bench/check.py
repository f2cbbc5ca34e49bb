"""The comparison that decides ``correct``.

After the window has closed, ``memory_peak_bytes`` has been read and the
program's state freed, the plain reference (:mod:`h100ref`) computes one
request of the window again from its ``POST /`` body and the seed's
weights, and the numbers below are held to the cell's limits
(``limits/<workload>.json``). The request is drawn from the seed among
those the window finished; every request is the same length.

- ``pass1_rel``, ``upsampled_rel`` (multi-scale pipelines): the pass-1
  latents and the upsampled latents, ``|program - reference| /
  |reference|`` (L2 over the whole grid);
- ``latents_rel``: the last pass's latents, likewise;
- ``frames_rms``: the root mean square difference, in 8-bit codes, of the
  frames ``generate`` returned and the reference's;
- ``mp4_frames_off``, over every request of the window: how many frames
  the delivered mp4 lacks or adds when it is read back, or a whole video's
  count where a frame has the wrong size (an exact comparison: limit 0);
- ``mp4_write_rms``: the delivered mp4 of the sampled request, read back,
  against the frames ``generate`` returned for it put through the same
  writer (OpenCV's ``mp4v`` at the request's frame rate, as
  ``utils/media.py::save_video`` calls it) and read back alike: the root
  mean square difference in 8-bit codes (an exact comparison: limit 0).
  With ``frames_rms`` it holds the mp4's frames to the reference's; the
  reference's own frames through the writer lie too near the control's to
  be compared after the codec's loss.

Each number is printed beside its limit as the last lines of standard
error and under ``checks`` in the result line. A number without a limit in
the file is printed as a reading and decides nothing.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def rel(a, b) -> float:
    import torch

    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def rms_codes(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def read_mp4(path: str):
    """Frames of an mp4 as OpenCV reads them back (RGB uint8), or None."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames) if frames else None


def through_mp4v(frames, fps: int):
    """``frames`` (RGB uint8) written as the served path's OpenCV writer
    writes them, and read back."""
    import cv2

    fd, path = tempfile.mkstemp(prefix="h100bench_ref_", suffix=".mp4")
    os.close(fd)
    try:
        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
        writer.release()
        return read_mp4(path)
    finally:
        os.remove(path)


def mp4_off(path, num_frames: int, height: int, width: int):
    """(frames off, the frames read back)."""
    if path is None:
        return num_frames, None
    video = read_mp4(path)
    if video is None:
        return num_frames, None
    if video.shape[1:3] != (height, width):
        return num_frames, video
    return abs(video.shape[0] - num_frames), video


def sample_index(seed: int, n: int) -> int:
    seed %= 1 << 64
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 1 << 20])
    return int(rng.integers(n))


def reference_stages(config: dict, seed: int, body: dict, device):
    """The reference's stages of one request (see ``h100ref.pipeline``)."""
    import torch

    from h100ref import common, dit, pipeline, upsampler, vae

    common.strict_fp32()
    ref_vae = vae.VAE(config["vae"], seed, device)
    ref_up = None
    if config["pipeline"].get("pipeline_type") == "multi-scale":
        ref_up = upsampler.Upsampler(config["latent_upsampler"], seed, device)
    ref_dit = dit.DiT(config["transformer"], seed, device)
    with torch.no_grad():
        return pipeline.serve(body, config["pipeline"], ref_dit, ref_vae,
                              ref_up, device)


def compare(config, seed, requests, mix, limits, device):
    """``(checks, readings)``: ``{name: {"value", "limit"}}`` for every
    number with a limit, ``{name: value}`` for all."""
    readings = {}
    off = 0
    req = requests[sample_index(seed, len(requests))] if requests else None
    video = None
    for r in requests:
        n, v = mp4_off(r.mp4, mix["num_frames"], mix["height"], mix["width"])
        off += n
        if r is req:
            video = v
    readings["mp4_frames_off"] = off
    if req is not None:
        ref = reference_stages(config, seed, req.body, device)
        for name in ("pass1", "upsampled", "latents"):
            if name in ref and name in req.stages:
                readings[f"{name}_rel"] = rel(req.stages[name], ref[name])
        frames = np.asarray(req.frames)
        if frames.shape == ref["frames"].shape:
            readings["frames_rms"] = rms_codes(frames, ref["frames"])
        else:
            readings["frames_rms"] = float("inf")
        readings["mp4_write_rms"] = float("inf")
        if video is not None and frames.shape == video.shape:
            own = through_mp4v(frames, int(req.body["frame_rate"]))
            if own is not None and own.shape == video.shape:
                readings["mp4_write_rms"] = rms_codes(video, own)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items() if k in limits}
    return checks, readings


def passed(checks: dict, limits: dict) -> bool:
    return bool(checks) and all(k in checks for k in limits) and all(
        c["value"] <= c["limit"] for c in checks.values())


def report(checks: dict, readings: dict, stream=sys.stderr) -> None:
    for k, v in readings.items():
        if k not in checks:
            print(f"reading {k} = {v!r} (no limit)", file=stream)
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {verdict}",
              file=stream)
    stream.flush()
