"""Frame padding helpers.

Pinned copies of ``calculate_padding`` and ``crop_padding`` from
``ltx_video_gpupoor_tpu/utils/media.py:45, :72`` (the JAX package cannot
be imported without jax). ``crop_padding`` slices numpy arrays and torch
tensors alike. mp4 writing and the CRF round-trip join with serving
(ROADMAP queue 1 step 11).
"""

from __future__ import annotations


def calculate_padding(
    height: int, width: int, padded_height: int, padded_width: int
) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) pads centering content in the padded frame."""
    pad_h = padded_height - height
    pad_w = padded_width - width
    pad_top = pad_h // 2
    pad_bottom = pad_h - pad_top
    pad_left = pad_w // 2
    pad_right = pad_w - pad_left
    return (pad_left, pad_right, pad_top, pad_bottom)


def crop_padding(frames, padding, num_frames: int):
    left, right, top, bottom = padding
    bottom = frames.shape[1] if bottom == 0 else -bottom
    right = frames.shape[2] if right == 0 else -right
    return frames[:num_frames, top:bottom, left:right]
