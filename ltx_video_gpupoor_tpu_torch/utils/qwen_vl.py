"""Host-side vision preprocessing for the Qwen-VL prompt extenders.

A copy of ``ltx_video_gpupoor_tpu/utils/qwen_vl.py`` (numpy + PIL, no
JAX), kept in the port so that it imports nothing of the JAX package;
``tests/test_torch_aux_utils.py`` holds the two equal.

Parity target: ``wan/utils/qwen_vl_utils.py`` (the
smart-resize bounds, image fetch/decoding, video frame sampling, and the
conversation-walking ``process_vision_info`` consumed by
``QwenPromptExpander(is_vl=True)`` at ``prompt_extend.py:300-365``).

Everything here runs host-side, outside the model — numpy + PIL,
no torch/torchvision dependency. Videos load through
``utils.media.load_video`` (native libavcodec shim when built, imageio /
OpenCV fallback) instead of decord/torchvision.
"""

from __future__ import annotations

import base64
import math
from io import BytesIO

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number: float, factor: int) -> int:
    """Closest multiple of ``factor``."""
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    """Smallest multiple of ``factor`` >= ``number``."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    """Largest multiple of ``factor`` <= ``number``."""
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> tuple[int, int]:
    """Resize bounds keeping both dims ``factor``-divisible, total pixels
    inside [min_pixels, max_pixels], and the aspect ratio as close as
    possible (``qwen_vl_utils.py:54-83``)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            "absolute aspect ratio must be smaller than "
            f"{MAX_RATIO}, got {max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR):
    """Decode + smart-resize one image element (``qwen_vl_utils.py:86-131``).

    Accepts a PIL image, a local path, ``file://``, or a
    ``data:image/...;base64,`` URI. ``http(s)://`` raises in this
    zero-egress environment (urllib is attempted so the path still works
    when the package runs with network access)."""
    from PIL import Image

    image = ele["image"] if "image" in ele else ele["image_url"]
    if isinstance(image, Image.Image):
        image_obj = image
    elif image.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(image) as resp:
            image_obj = Image.open(BytesIO(resp.read()))
    elif image.startswith("file://"):
        image_obj = Image.open(image[7:])
    elif image.startswith("data:image"):
        if "base64," not in image:
            raise ValueError(f"unsupported data URI (need base64): {image[:40]}")
        _, b64 = image.split("base64,", 1)
        image_obj = Image.open(BytesIO(base64.b64decode(b64)))
    else:
        image_obj = Image.open(image)
    image_obj = image_obj.convert("RGB")
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(
            ele["resized_height"], ele["resized_width"], factor=size_factor
        )
    else:
        w, h = image_obj.size
        rh, rw = smart_resize(
            h, w,
            factor=size_factor,
            min_pixels=ele.get("min_pixels", MIN_PIXELS),
            max_pixels=ele.get("max_pixels", MAX_PIXELS),
        )
    return image_obj.resize((rw, rh))


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Model-input frame count from either ``nframes`` or an ``fps``
    budget with min/max clamps (``qwen_vl_utils.py:133-174``)."""
    assert not ("fps" in ele and "nframes" in ele), \
        "Only accept either `fps` or `nframes`"
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(
            ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR
        )
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR,
        )
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = round_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
            f"but got {nframes}."
        )
    return nframes


def _resize_frames(frames: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """Bicubic per-frame resize via PIL (host-side, uint8)."""
    from PIL import Image

    out = np.empty((frames.shape[0], rh, rw, 3), np.uint8)
    for i, f in enumerate(frames):
        out[i] = np.asarray(
            Image.fromarray(f).resize((rw, rh), Image.BICUBIC)
        )
    return out


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR):
    """Load + sample + smart-resize a video element
    (``qwen_vl_utils.py:275-329``).

    ``ele["video"]`` is a path/URI (returns float32 [T, H, W, 3] in
    [0, 255]) or a list of image elements (returns list of PIL images,
    padded to a FRAME_FACTOR multiple by repeating the last frame).
    ``ele["video_fps"]`` carries the source fps when known (the media
    loader does not probe it; default 30)."""
    if isinstance(ele["video"], str):
        from .media import load_video

        path = ele["video"]
        if path.startswith("file://"):
            path = path[7:]
        arr = load_video(path)                       # [F, H, W, 3] in [-1, 1]
        frames = ((arr + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)
        total_frames = frames.shape[0]
        video_fps = float(ele.get("video_fps", 30.0))
        nframes = smart_nframes(ele, total_frames, video_fps)
        idx = np.linspace(0, total_frames - 1, nframes).round().astype(int)
        frames = frames[idx]
        h, w = frames.shape[1:3]
        min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
        total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
        max_pixels = max(
            min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
            int(min_pixels * 1.05),
        )
        max_pixels = ele.get("max_pixels", max_pixels)
        if "resized_height" in ele and "resized_width" in ele:
            rh, rw = smart_resize(
                ele["resized_height"], ele["resized_width"],
                factor=image_factor,
            )
        else:
            rh, rw = smart_resize(
                h, w, factor=image_factor,
                min_pixels=min_pixels, max_pixels=max_pixels,
            )
        return _resize_frames(frames, rh, rw).astype(np.float32)
    assert isinstance(ele["video"], (list, tuple))
    process_info = {k: v for k, v in ele.items() if k not in ("type", "video")}
    images = [
        fetch_image({"image": el, **process_info}, size_factor=image_factor)
        for el in ele["video"]
    ]
    nframes = ceil_by_factor(len(images), FRAME_FACTOR)
    if len(images) < nframes:
        images.extend([images[-1]] * (nframes - len(images)))
    return images


def extract_vision_info(conversations) -> list[dict]:
    """Collect image/video elements from chat messages
    (``qwen_vl_utils.py:332-346``)."""
    vision_infos = []
    if isinstance(conversations[0], dict):
        conversations = [conversations]
    for conversation in conversations:
        for message in conversation:
            if isinstance(message["content"], list):
                for ele in message["content"]:
                    if ("image" in ele or "image_url" in ele
                            or "video" in ele
                            or ele.get("type") in
                            ("image", "image_url", "video")):
                        vision_infos.append(ele)
    return vision_infos


def process_vision_info(conversations):
    """Returns ``(image_inputs, video_inputs)`` ready for a Qwen-VL
    processor (``qwen_vl_utils.py:349-369``)."""
    image_inputs: list = []
    video_inputs: list = []
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            image_inputs.append(fetch_image(info))
        elif "video" in info:
            video_inputs.append(fetch_video(info))
        else:
            raise ValueError("image, image_url or video should in content.")
    return (image_inputs or None), (video_inputs or None)


# ---------------------------------------------------------------------------
# Native image preprocessing (Qwen2VLImageProcessor parity)
# ---------------------------------------------------------------------------

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_image(
    image,
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
):
    """One image (PIL or [H, W, 3] uint8 array) -> ``(patches, grid_thw)``
    in the layout Qwen2.5-VL's vision tower consumes — the native
    counterpart of transformers' ``Qwen2VLImageProcessor._preprocess``
    (smart-resize, 1/255 rescale, CLIP-stats normalize, then the
    t/h/w/merge patch flattening), so the model path needs no HF processor
    download. Returns float32 ``[t*h*w, 3*tps*ps*ps]`` and ``(t, h, w)``."""
    import numpy as np
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    image = image.convert("RGB")
    w, h = image.size
    rh, rw = smart_resize(h, w, factor=patch_size * merge_size,
                          min_pixels=min_pixels, max_pixels=max_pixels)
    if (rw, rh) != (w, h):
        image = image.resize((rw, rh), Image.Resampling.BICUBIC)
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
    arr = arr.transpose(2, 0, 1)[None]  # [1, C, H, W]
    # temporal repeat to fill one temporal patch
    arr = np.repeat(arr, temporal_patch_size, axis=0)
    c = arr.shape[1]
    gt = arr.shape[0] // temporal_patch_size
    gh, gw = rh // patch_size, rw // patch_size
    arr = arr.reshape(
        gt, temporal_patch_size, c,
        gh // merge_size, merge_size, patch_size,
        gw // merge_size, merge_size, patch_size,
    )
    arr = arr.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = arr.reshape(
        gt * gh * gw, c * temporal_patch_size * patch_size * patch_size)
    return patches.astype(np.float32), (gt, gh, gw)
