"""The one generator of ``POST /`` bodies, driven by a traffic mix file.

A mix (``traffic/<name>.json``) gives the request's ``height``, ``width``,
``num_frames``, ``frame_rate``, ``num_inference_steps``, the number of
closed-loop ``clients``, and the ranges of prompt words. Request ``i`` of
client ``c`` is drawn from ``(seed, c, i)`` alone: a seeded image at the
request's own size and aspect (smooth colour fields with noise, so that
``fit_into_canvas`` keeps its size), PNG-encoded in base64, and a prompt
and a negative prompt of words from a fixed list. Every seed asks for the
same sizes; only the content differs.
"""

from __future__ import annotations

import base64
import io

import numpy as np

WORDS = (
    "a", "the", "slow", "camera", "pans", "across", "river", "city", "night",
    "light", "forest", "mountain", "woman", "man", "walks", "runs", "smiles",
    "golden", "hour", "rain", "snow", "street", "car", "drives", "ocean",
    "waves", "crash", "cinematic", "close", "up", "wide", "shot", "dog",
    "cat", "jumps", "over", "fence", "bird", "flies", "sky", "clouds",
    "drift", "sunset", "glows", "market", "crowd", "dances", "music",
    "plays", "old", "young", "red", "blue", "green", "window", "door",
    "opens", "smoke", "rises", "fire", "burns", "train", "arrives",
)
NEGATIVE = ("worst", "quality", "blurry", "jittery", "distorted",
            "inconsistent", "motion", "low", "resolution", "artifacts")


def _rng(seed: int, client: int, index: int) -> np.random.Generator:
    seed %= 1 << 64
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, client,
                                  index])


def image(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """uint8 [H, W, 3]: random smooth colour fields plus noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    chans = []
    for _ in range(3):
        fy, fx = rng.uniform(20, 120, 2)
        py, px = rng.uniform(0, 2 * np.pi, 2)
        chans.append(128 + 90 * np.sin(xx / fx + px) * np.cos(yy / fy + py))
    img = np.stack(chans, -1) + rng.normal(0, 6, (height, width, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _words(rng, vocab, lo, hi) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(vocab[i] for i in rng.integers(0, len(vocab), n))


def body(mix: dict, seed: int, client: int, index: int) -> dict:
    rng = _rng(seed, client, index)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image(rng, mix["height"], mix["width"])).save(
        buf, format="PNG")
    return {
        "image": base64.b64encode(buf.getvalue()).decode(),
        "prompt": _words(rng, WORDS, *mix["prompt_words"]),
        "negative_prompt": _words(rng, NEGATIVE, *mix["negative_words"]),
        "height": mix["height"], "width": mix["width"],
        "num_frames": mix["num_frames"], "frame_rate": mix["frame_rate"],
        "num_inference_steps": mix["num_inference_steps"],
        "creation_id": f"c{client}-r{index}",
    }


def bucket(mix: dict) -> str:
    """The service's warm-up spec for the mix's one shape (``WxHxF``)."""
    return f"{mix['width']}x{mix['height']}x{mix['num_frames']}"
