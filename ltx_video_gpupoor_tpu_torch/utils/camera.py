"""ReCamMaster's camera-pose embeddings (numpy).

The port's own copy of ``ltx_video_gpupoor_tpu/utils/camera.py`` (:27-169;
``tests/test_torch_wan_variants.py`` holds it equal to the JAX package's):
parse a ``camera_extrinsics.json`` of preset trajectories (10 cameras x 81
frames), take each camera-to-world pose relative to the first frame, and
give the 12-value pose row a latent frame that the ReCamMaster blocks
encode (``models/wan/model.py::_encode_cam``). ``PACKAGED_EXTRINSICS`` is
the port's copy of the ten published trajectories; the presets
(``generate_preset_extrinsics``) synthesize the same ten motions.
"""

from __future__ import annotations

import json
import os

import numpy as np

#: The ten published trajectories ship with the package (ReCamMaster's
#: released ``camera_extrinsics.json``, read by its
#: ``wan/utils/cammmaster_tools.py:40-63``).
PACKAGED_EXTRINSICS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "camera_extrinsics.json",
)


def parse_matrix(matrix_str: str) -> np.ndarray:
    rows = matrix_str.strip().split("] [")
    out = []
    for row in rows:
        row = row.replace("[", "").replace("]", "")
        out.append([float(x) for x in row.split()])
    return np.asarray(out)


def relative_poses(c2w_list: list[np.ndarray]) -> np.ndarray:
    """First camera becomes the identity; later cameras are expressed in its
    frame (``get_relative_pose``, ``cammmaster_tools.py:23-37``)."""
    w2c0 = np.linalg.inv(c2w_list[0])
    target = np.eye(4)
    abs2rel = target @ w2c0
    poses = [target] + [abs2rel @ c2w for c2w in c2w_list[1:]]
    return np.asarray(poses, np.float32)


#: ReCamMaster preset trajectory ids (``cam01`` .. ``cam10``).
PRESET_TRAJECTORIES = {
    1: "pan_right",
    2: "pan_left",
    3: "tilt_up",
    4: "tilt_down",
    5: "zoom_in",
    6: "zoom_out",
    7: "translate_up",
    8: "translate_down",
    9: "arc_left",
    10: "arc_right",
}


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _preset_c2w(kind: str, t: float) -> np.ndarray:
    """Camera-to-world pose at interpolation parameter ``t`` in [0, 1].

    Synthesized (original) trajectories covering the reference's ten
    preset motions; the camera starts 5 m from the subject looking at the
    origin. Translations are in centimeters (the parser divides by 100,
    matching the reference data's unit convention)."""
    dist = 500.0
    pos = np.array([0.0, 0.0, -dist])
    rot = np.eye(3)
    if kind in ("pan_right", "pan_left"):
        sign = 1.0 if kind == "pan_right" else -1.0
        rot = _rot_y(sign * t * np.deg2rad(25.0))
    elif kind in ("tilt_up", "tilt_down"):
        sign = -1.0 if kind == "tilt_up" else 1.0
        rot = _rot_x(sign * t * np.deg2rad(18.0))
    elif kind in ("zoom_in", "zoom_out"):
        sign = 1.0 if kind == "zoom_in" else -1.0
        pos = np.array([0.0, 0.0, -dist + sign * t * 200.0])
    elif kind in ("translate_up", "translate_down"):
        sign = 1.0 if kind == "translate_up" else -1.0
        pos = np.array([0.0, sign * t * 120.0, -dist])
        # keep the subject framed: counter-tilt toward the origin
        rot = _rot_x(-sign * np.arctan2(t * 120.0, dist))
    elif kind in ("arc_left", "arc_right"):
        sign = -1.0 if kind == "arc_left" else 1.0
        ang = sign * t * np.deg2rad(30.0)
        pos = np.array([dist * np.sin(ang), 0.0, -dist * np.cos(ang)])
        rot = _rot_y(ang)
    else:
        raise ValueError(f"unknown preset trajectory {kind!r}")
    c2w = np.eye(4)
    c2w[:3, :3] = rot
    c2w[:3, 3] = pos
    return c2w


def _format_matrix(m: np.ndarray) -> str:
    # The stored matrix is read back transposed (the parser's caller does
    # ``.transpose(0, 2, 1)``), so write the transpose here.
    mt = m.T
    return " ".join(
        "[" + " ".join(f"{x:.6f}" for x in row) + "]" for row in mt
    )


def generate_preset_extrinsics(num_frames: int = 81) -> dict:
    """Build a ``camera_extrinsics.json``-schema dict of the ten preset
    trajectories (``frame{i}`` -> ``cam{01..10}`` -> matrix string), the
    runtime data the reference ships as a static file. Write it with
    ``json.dump`` and point ``get_camera_embedding`` at it."""
    out = {}
    for i in range(num_frames):
        t = i / max(num_frames - 1, 1)
        frame = {}
        for cam_id, kind in PRESET_TRAJECTORIES.items():
            # The parser permutes axes ([:, [1, 2, 0, 3]]) and flips the
            # y column; invert that here so the parsed c2w equals the
            # synthesized one.
            c2w = _preset_c2w(kind, t)
            stored = c2w[:, [2, 0, 1, 3]].copy()
            stored[:3, 2] *= -1.0  # y column (moves to index 2 pre-permute)
            frame[f"cam{cam_id:02d}"] = _format_matrix(stored)
        out[f"frame{i}"] = frame
    return out


def get_camera_embedding(
    cam_type: int | str,
    extrinsics_path: str | None = None,
    num_frames: int = 81,
) -> np.ndarray:
    """Returns [ceil(num_frames/4), 12] float32 pose embeddings.

    ``extrinsics_path`` defaults to the packaged preset data, so
    ``get_camera_embedding(3)`` reproduces the reference's ``cam03``."""
    if extrinsics_path is None:
        extrinsics_path = PACKAGED_EXTRINSICS
    with open(extrinsics_path) as f:
        cam_data = json.load(f)
    cam_idx = list(range(num_frames))[::4]
    traj = [
        parse_matrix(cam_data[f"frame{idx}"][f"cam{int(cam_type):02d}"])
        for idx in cam_idx
    ]
    traj = np.stack(traj).transpose(0, 2, 1)
    c2ws = []
    for c2w in traj:
        c2w = c2w[:, [1, 2, 0, 3]].copy()
        c2w[:3, 1] *= -1.0
        c2w[:3, 3] /= 100.0
        c2ws.append(c2w)
    rel = relative_poses(c2ws)  # [T, 4, 4]
    # per-frame pose relative to frame 0: rows [i] of pairwise (0, i)
    embeds = []
    for i in range(len(c2ws)):
        pair = relative_poses([c2ws[0], c2ws[i]])
        embeds.append(pair[1, :3, :])  # [3, 4]
    return np.stack(embeds).reshape(len(c2ws), 12).astype(np.float32)
