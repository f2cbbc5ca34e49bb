"""Readings for the limits of ``correct``: the program, its lower-precision
control and planted faults, over several seeds in one process.

    python3 bench_h100/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--as program|control|frozen_step|half_batch|
        altered_frames|swapped_channels|reversed_frames]

Each seed runs the cell as ``run.py`` does (set-up from that seed, a window
of ``--seconds``, the comparison with the reference) and prints one JSON
line of its readings. ``control`` builds the DiT in the program's own
int4 weight-only tier (``quantization="wo_int4"``, the precision below the
configured int8) in place of the configured one; the other names plant a
fault in the timed path: every denoise step returns its state unchanged,
half of each DiT output is the mean of the other half, one frame of
every answer is inverted where ``generate`` produces it, or the server's
mp4 write takes each frame with its red and blue channels swapped, or the
frames in reverse order.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def frozen_step(gen):
    """Every denoise step returns its state unchanged."""
    from ltx_video_gpupoor_tpu_torch.schedulers import rf

    rf.step = lambda schedule, model_output, timestep, sample, **kw: sample


def half_batch(gen):
    """Half of each DiT output's tokens replaced by the mean of the rest."""
    dit = gen.pipeline.transformer
    real = dit.forward

    def forward(*a, **k):
        out = real(*a, **k)
        n = out.shape[1] // 2
        out[:, n:] = out[:, :n].mean(dim=1, keepdim=True)
        return out

    dit.forward = forward


def altered_frames(gen):
    """One frame of every answer inverted where it is produced."""
    real = gen.generate

    def generate(*a, **k):
        frames = real(*a, **k)
        frames[0] = 255 - frames[0]
        return frames

    gen.generate = generate


def _written(change):
    from ltx_video_gpupoor_tpu_torch.utils import media

    real = getattr(media.save_video, "unchanged", media.save_video)

    def save_video(frames, path, *a, **k):
        return real(np.ascontiguousarray(change(frames)), path, *a, **k)

    save_video.unchanged = real     # once, whatever the seeds of a process
    media.save_video = save_video


def swapped_channels(gen):
    """Every mp4 written with its red and blue channels swapped."""
    _written(lambda frames: frames[..., ::-1])


def reversed_frames(gen):
    """Every mp4 written with its frames in reverse order."""
    _written(lambda frames: frames[::-1])


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch,
          "altered_frames": altered_frames,
          "swapped_channels": swapped_channels,
          "reversed_frames": reversed_frames}


def readings(cell, seed, seconds, kind, device="cuda"):
    """One seed's result (``run_cell``'s object) as ``kind`` runs it."""
    from h100bench import cell as cell_run

    return cell_run.run_cell(
        cell, seed, seconds, False, t_process=time.perf_counter(),
        device=device,
        quantization="wo_int4" if kind == "control" else None,
        after_build=FAULTS.get(kind))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--as", dest="kind", default="program",
                   choices=("program", "control", *FAULTS))
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from h100bench import catalog

    cell = catalog.Cell(catalog.load_spec(ROOT), args.workload, ROOT, HERE)
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, args.kind)
        print(json.dumps({"workload": args.workload, "as": args.kind,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "peak_bytes": r["device"]["memory_peak_bytes"],
                          "readings": r["readings"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
