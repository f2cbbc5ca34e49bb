"""Prompt enhancement (LTX) and prompt extension (Wan), gated.

Port of ``ltx_video_gpupoor_tpu/utils/prompt_enhance.py``:
``should_enhance`` and the two cinematic system prompts (copied
verbatim, :29-70); ``ChatLM`` (JAX ``JaxChatLM``, :124), ``VLChat``
(``JaxVLChat``, :194) and ``FlorenceCaptioner`` (``JaxFlorenceCaptioner``,
:292) over the port's ``models/llm.py``, ``models/qwen25_vl.py`` and
``models/florence2.py``; ``PromptEnhancer`` (:380) with the Florence-2
caption and the LLM rewrite; the Wan extenders ``QwenPromptExpander``
(:572), ``QwenVLPromptExpander`` (:634) and ``DashScopePromptExpander``
(:741, copied: it needs ``dashscope`` and the network).

The models run on the card (``device``, the card unless told the CPU).
The tokenizers come from each checkpoint directory through
``transformers.AutoTokenizer``, imported inside ``from_dir`` only; any
object with the same methods may be handed over instead. The token
layouts are JAX's: the chat prompt LEFT-padded to a 64-token bucket (so
tokens and positions match), the captioner's encoder input RIGHT-padded
to a 16-token bucket.

One difference from the JAX module, on purpose: no fallback. JAX wraps
its own model in ``try/except`` and falls through a failed caption or
rewrite to a ``transformers`` model from the Hub on the host. Here, when
a model is configured (its ``*_dir`` or environment variable set, or the
model handed over), it runs and any error it raises propagates; when
none is configured, the prompt comes back unchanged with one warning that
names the variable, as JAX behaves offline and under ``native_only``
(JAX's serving switch, which the port needs not: it has no other route).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

# System prompts published with LTX-Video
# (prompt_enhance_utils.py:9-44)
T2V_CINEMATIC_PROMPT = """You are an expert cinematic director with many award winning movies, When writing prompts based on the user input, focus on detailed, chronological descriptions of actions and scenes.
Include specific movements, appearances, camera angles, and environmental details - all in a single flowing paragraph.
Start directly with the action, and keep descriptions literal and precise.
Think like a cinematographer describing a shot list.
Do not change the user input intent, just enhance it.
Keep within 150 words.
For best results, build your prompts using this structure:
Start with main action in a single sentence
Add specific details about movements and gestures
Describe character/object appearances precisely
Include background and environment details
Specify camera angles and movements
Describe lighting and colors
Note any changes or sudden events
Do not exceed the 150 word limit!
Output the enhanced prompt only.
"""

I2V_CINEMATIC_PROMPT = """You are an expert cinematic director with many award winning movies, When writing prompts based on the user input, focus on detailed, chronological descriptions of actions and scenes.
Include specific movements, appearances, camera angles, and environmental details - all in a single flowing paragraph.
Start directly with the action, and keep descriptions literal and precise.
Think like a cinematographer describing a shot list.
Keep within 150 words.
For best results, build your prompts using this structure:
Describe the image first and then add the user input. Image description should be in first priority! Align to the image caption if it contradicts the user text input.
Start with main action in a single sentence
Add specific details about movements and gestures
Describe character/object appearances precisely
Include background and environment details
Specify camera angles and movements
Describe lighting and colors
Note any changes or sudden events
Align to the image caption if it contradicts the user text input.
Do not exceed the 150 word limit!
Output the enhanced prompt only.
"""


def should_enhance(prompt: str, words_threshold: int = 120) -> bool:
    """The reference only enhances short prompts (``pipeline_ltx_video.py``
    enhance path + ``prompt_enhancement_words_threshold``)."""
    return len(prompt.split()) < words_threshold


_warned: set = set()


def _not_configured(var: str, what: str) -> None:
    """One warning a process for each model nobody configured."""
    if var not in _warned:
        _warned.add(var)
        logger.warning("%s: %s is not set; the prompt is returned "
                       "unchanged", what, var)


def _checkpoint_eos_ids(path: str, tokenizer) -> tuple:
    """All stop-token ids for a checkpoint dir: the tokenizer's EOS plus
    ``generation_config.json``'s eos list (Llama-3.x Instruct stops at
    <|eot_id|>, which lives only in the generation config on several
    published exports)."""
    ids = []
    eos = getattr(tokenizer, "eos_token_id", None)
    ids.extend(eos if isinstance(eos, (list, tuple))
               else [] if eos is None else [eos])
    gen_cfg = os.path.join(path, "generation_config.json")
    if os.path.isfile(gen_cfg):
        with open(gen_cfg) as fh:
            ge = json.load(fh).get("eos_token_id")
        ids.extend(ge if isinstance(ge, list) else [] if ge is None else [ge])
    return tuple(dict.fromkeys(int(i) for i in ids))


def _tokenizer_eos(tokenizer, eos_ids: tuple) -> tuple:
    eos = tokenizer.eos_token_id
    return eos_ids or (tuple(eos) if isinstance(eos, (list, tuple))
                       else (eos,) if eos is not None else ())


def _truncate_at_eos(tokens, eos_ids):
    """Cut a generated id row at the first stop token."""
    out = np.asarray(tokens)
    for e in eos_ids:
        hit = np.where(out == e)[0]
        if hit.size:
            out = out[:hit[0]]
    return out


def _auto_tokenizer(path: str):
    """The tokenizer files of a checkpoint directory, never fetched."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


def _left_pad(ids: np.ndarray, bucket: int = 64):
    """``[S]`` -> ``[1, bucket * ceil(S / bucket)]`` ids and mask, padded on
    the left with id 0."""
    n = -(-ids.shape[0] // bucket) * bucket
    mask = np.pad(np.ones_like(ids), (n - ids.shape[0], 0))[None]
    return np.pad(ids, (n - ids.shape[0], 0))[None], mask


@dataclasses.dataclass
class ChatLM:
    """The port's Llama / Qwen2 (``models/llm.py``) behind a chat-template
    interface. ``last_new_tokens`` counts the tokens the last ``chat`` kept
    (up to the first stop token)."""

    model: object
    tokenizer: object
    max_new_tokens: int = 256
    eos_ids: tuple = ()
    last_new_tokens: int = 0

    @classmethod
    def from_dir(cls, path: str, dtype=torch.bfloat16, device=None,
                 **kw) -> "ChatLM":
        from ..models import llm

        model = llm.load_hf_dir(path, device=device, dtype=dtype)
        tok = _auto_tokenizer(path)
        return cls(model=model, tokenizer=tok,
                   eos_ids=_checkpoint_eos_ids(path, tok), **kw)

    def chat(self, system_prompt: str, user_prompt: str,
             temperature: float = 0.7, seed: int = 0,
             gumbel: Optional[torch.Tensor] = None) -> str:
        """One rewrite: greedy at ``temperature`` 0, else sampled with
        noise from a generator seeded by ``seed`` (or ``gumbel [max_new,
        1, vocab]`` handed over)."""
        from ..models import llm

        messages = [{"role": "system", "content": system_prompt},
                    {"role": "user", "content": user_prompt}]
        ids = np.asarray(self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True), np.int64)
        eos_ids = _tokenizer_eos(self.tokenizer, self.eos_ids)
        ids, mask = _left_pad(ids)
        gen = torch.Generator(device=self.model.device).manual_seed(
            max(seed, 0))
        toks = llm.generate(self.model, torch.from_numpy(ids),
                            torch.from_numpy(mask), self.max_new_tokens,
                            eos_ids=eos_ids, temperature=temperature,
                            generator=gen, gumbel=gumbel)
        out = _truncate_at_eos(toks[0].cpu().numpy(), eos_ids)
        self.last_new_tokens = int(out.shape[0])
        return self.tokenizer.decode(out, skip_special_tokens=True).strip()


@dataclasses.dataclass
class VLChat:
    """The port's Qwen2.5-VL (``models/qwen25_vl.py``) behind the
    single-image chat layout: the image through ``utils.qwen_vl.
    preprocess_image``, one placeholder token per merged patch, the text
    left-padded to a 64-token bucket."""

    model: object
    tokenizer: object
    max_new_tokens: int = 512
    min_pixels: int = 256 * 28 * 28
    max_pixels: int = 1280 * 28 * 28
    eos_ids: tuple = ()
    last_new_tokens: int = 0

    @classmethod
    def from_dir(cls, path: str, dtype=torch.bfloat16, device=None,
                 **kw) -> "VLChat":
        from ..models import qwen25_vl

        model = qwen25_vl.load_hf_dir(path, device=device, dtype=dtype)
        tok = _auto_tokenizer(path)
        return cls(model=model, tokenizer=tok,
                   eos_ids=_checkpoint_eos_ids(path, tok), **kw)

    def chat_with_image(self, system_prompt: str, user_prompt: str,
                        image, temperature: float = 0.0,
                        seed: int = 0) -> str:
        from ..models import qwen25_vl
        from .qwen_vl import fetch_image, preprocess_image

        cfg = self.model.cfg
        pil = fetch_image({"image": image, "min_pixels": self.min_pixels,
                           "max_pixels": self.max_pixels})
        v = cfg.vision
        patches, grid = preprocess_image(
            pil, patch_size=v.patch_size, merge_size=v.spatial_merge_size,
            temporal_patch_size=v.temporal_patch_size,
            min_pixels=self.min_pixels, max_pixels=self.max_pixels)
        n_img = int(np.prod(grid)) // v.spatial_merge_size ** 2
        # the official Qwen2.5-VL single-image chat layout; the image pad
        # expands to one token per merged patch
        text = (f"<|im_start|>system\n{system_prompt}<|im_end|>\n"
                f"<|im_start|>user\n<|vision_start|><|image_pad|>"
                f"<|vision_end|>{user_prompt}<|im_end|>\n"
                f"<|im_start|>assistant\n")
        ids = np.asarray(self.tokenizer(
            text, return_attention_mask=False)["input_ids"], np.int64)
        pad_pos = np.where(ids == cfg.image_token_id)[0]
        if pad_pos.size:
            ids = np.concatenate([
                ids[:pad_pos[0]], np.full((n_img,), cfg.image_token_id),
                ids[pad_pos[0] + 1:]])
        eos_ids = _tokenizer_eos(self.tokenizer, self.eos_ids)
        ids, mask = _left_pad(ids)
        gen = torch.Generator(device=self.model.text.device).manual_seed(
            max(seed, 0))
        toks = qwen25_vl.generate(
            self.model, torch.from_numpy(ids), torch.from_numpy(patches),
            np.asarray([grid]), torch.from_numpy(mask), self.max_new_tokens,
            eos_ids=eos_ids, temperature=temperature, generator=gen)
        out = _truncate_at_eos(toks[0].cpu().numpy(), eos_ids)
        self.last_new_tokens = int(out.shape[0])
        return self.tokenizer.decode(out, skip_special_tokens=True).strip()


@dataclasses.dataclass
class FlorenceCaptioner:
    """The port's Florence-2 (``models/florence2.py``): 768x768 bicubic
    ImageNet-stats preprocessing, greedy seq2seq decode."""

    model: object
    tokenizer: object
    max_new_tokens: int = 256
    image_size: int = 768
    # <DETAILED_CAPTION> task prompt (Florence2Processor
    # task_prompts_without_inputs)
    task_prompt: str = "Describe in detail what is shown in the image."
    last_new_tokens: int = 0

    @classmethod
    def from_dir(cls, path: str, dtype=torch.bfloat16, device=None,
                 **kw) -> "FlorenceCaptioner":
        from ..models import florence2

        model = florence2.load_hf_dir(path, device=device, dtype=dtype)
        return cls(model=model, tokenizer=_auto_tokenizer(path), **kw)

    def preprocess(self, image) -> np.ndarray:
        """PIL/array image -> [1, H, W, 3] float32 (resize to the square
        processor size, 1/255 rescale, ImageNet normalize)."""
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        image = image.convert("RGB").resize(
            (self.image_size, self.image_size), Image.Resampling.BICUBIC)
        arr = np.asarray(image, np.float32) / 255.0
        arr = (arr - np.asarray((0.485, 0.456, 0.406), np.float32)) \
            / np.asarray((0.229, 0.224, 0.225), np.float32)
        return arr[None]

    def caption(self, image) -> str:
        from ..models import florence2

        cfg = self.model.cfg
        px = self.preprocess(image)
        # image tokens = tower tokens + 1 (the projector's mean token)
        stride = int(np.prod(cfg.vision.patch_stride))
        n_img = (px.shape[1] // stride) * (px.shape[2] // stride) + 1
        tok = self.tokenizer
        ids = tok(tok.bos_token + self.task_prompt + tok.eos_token,
                  add_special_tokens=False,
                  return_attention_mask=False)["input_ids"]
        ids = np.concatenate([np.full((n_img,), cfg.image_token_id),
                              np.asarray(ids, np.int64)])
        # RIGHT-pad the encoder input to a 16-token bucket (BART's
        # positions are absolute, so right padding keeps them)
        n = -(-len(ids) // 16) * 16
        mask = np.pad(np.ones_like(ids), (0, n - len(ids)))[None]
        ids = np.pad(ids, (0, n - len(ids)),
                     constant_values=cfg.text.pad_token_id)[None]
        toks = florence2.generate(self.model, torch.from_numpy(ids),
                                  torch.from_numpy(px), self.max_new_tokens,
                                  mask=torch.from_numpy(mask))
        out = _truncate_at_eos(toks[0].cpu().numpy(),
                               (cfg.text.eos_token_id,))
        self.last_new_tokens = int(out.shape[0])
        return self.tokenizer.decode(out, skip_special_tokens=True).strip()


@dataclasses.dataclass
class PromptEnhancer:
    """Florence-2 caption + LLM rewrite, with the word-count gate. The
    models load on first use from ``captioner_dir`` / ``llm_dir`` (or
    ``LTXV_TPU_CAPTIONER_DIR`` / ``LTXV_TPU_ENHANCER_LLM_DIR``) onto
    ``device``, or are handed over as ``captioner`` / ``lm``."""

    words_threshold: int = 120
    max_new_tokens: int = 256
    llm_dir: Optional[str] = None
    captioner_dir: Optional[str] = None
    device: object = None
    lm: Optional[ChatLM] = None
    captioner: Optional[FlorenceCaptioner] = None

    def _captioner(self) -> Optional[FlorenceCaptioner]:
        if self.captioner is None:
            path = self.captioner_dir or os.environ.get(
                "LTXV_TPU_CAPTIONER_DIR")
            if not path:
                _not_configured("LTXV_TPU_CAPTIONER_DIR", "image captioner")
                return None
            self.captioner = FlorenceCaptioner.from_dir(path,
                                                        device=self.device)
        return self.captioner

    def _lm(self) -> Optional[ChatLM]:
        if self.lm is None:
            path = self.llm_dir or os.environ.get("LTXV_TPU_ENHANCER_LLM_DIR")
            if not path:
                _not_configured("LTXV_TPU_ENHANCER_LLM_DIR",
                                "prompt enhancer")
                return None
            self.lm = ChatLM.from_dir(path, device=self.device,
                                      max_new_tokens=self.max_new_tokens)
        return self.lm

    def caption_image(self, image: np.ndarray) -> Optional[str]:
        """Florence-2 detailed caption of an ``[H, W, 3]`` uint8 image;
        None without a captioner."""
        cap = self._captioner()
        return None if cap is None else cap.caption(image)

    def _rewrite(self, system_prompt: str, user_prompt: str
                 ) -> Optional[str]:
        lm = self._lm()
        return None if lm is None else lm.chat(system_prompt, user_prompt,
                                               temperature=0.7)

    def enhance(self, prompt: str,
                first_frames: Optional[Sequence[np.ndarray]] = None) -> str:
        """t2v (no frames) or i2v (caption + rewrite) enhancement; the
        prompt unchanged past the word gate, without a caption, or without
        the models."""
        if not should_enhance(prompt, self.words_threshold):
            return prompt
        if first_frames:
            captions = [c for c in (self.caption_image(f)
                                    for f in first_frames) if c]
            if not captions:
                return prompt
            user = (f"user_prompt: {prompt}\n"
                    f"image_caption: {'; '.join(captions)}")
            out = self._rewrite(I2V_CINEMATIC_PROMPT, user)
        else:
            out = self._rewrite(T2V_CINEMATIC_PROMPT,
                                f"user_prompt: {prompt}")
        return out or prompt


# ---------------------------------------------------------------------------
# Wan prompt extenders (prompt_extend.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QwenPromptExpander:
    """Local Qwen2.5 extension (``prompt_extend.py:300-365``): the model
    at ``model_dir`` or ``LTXV_TPU_EXTENDER_LLM_DIR``, or handed over as
    ``lm``."""

    model_dir: Optional[str] = None
    device: object = None
    lm: Optional[ChatLM] = None

    SYSTEM_EN = (
        "You are a prompt engineer for text-to-video models. Rewrite the "
        "user's prompt into a single detailed English paragraph describing "
        "subjects, appearance, actions, scene, lighting, and camera "
        "movement, preserving the user's intent. Output the rewritten "
        "prompt only."
    )

    def extend(self, prompt: str, seed: int = -1) -> str:
        if self.lm is None:
            path = self.model_dir or os.environ.get(
                "LTXV_TPU_EXTENDER_LLM_DIR")
            if not path:
                _not_configured("LTXV_TPU_EXTENDER_LLM_DIR",
                                "Qwen prompt extender")
                return prompt
            self.lm = ChatLM.from_dir(path, device=self.device,
                                      max_new_tokens=512)
        return self.lm.chat(self.SYSTEM_EN, prompt, seed=max(seed, 0)) \
            or prompt


@dataclasses.dataclass
class QwenVLPromptExpander:
    """Image-aware Qwen2.5-VL extension (``prompt_extend.py:398-455``):
    the first frame rides along in the chat. The model at ``model_dir`` or
    ``LTXV_TPU_EXTENDER_VL_DIR``, or handed over as ``vl``."""

    model_dir: Optional[str] = None
    max_new_tokens: int = 512
    device: object = None
    vl: Optional[VLChat] = None

    SYSTEM_EN = (
        "You are a prompt engineer for image-to-video models. Using the "
        "attached image as the first frame, rewrite the user's prompt "
        "into a single detailed English paragraph that stays faithful to "
        "the image's subjects, appearance, style, and composition, then "
        "describes their motion, the scene, lighting, and camera "
        "movement. Output the rewritten prompt only."
    )

    def extend_with_img(self, prompt: str, image, seed: int = -1,
                        system_prompt: str | None = None) -> str:
        """``image``: PIL image, local path, file:// or data: URI
        (the forms ``qwen_vl.fetch_image`` accepts). Returns the rewritten
        prompt, or ``prompt`` unchanged without a model."""
        if self.vl is None:
            path = self.model_dir or os.environ.get(
                "LTXV_TPU_EXTENDER_VL_DIR")
            if not path:
                _not_configured("LTXV_TPU_EXTENDER_VL_DIR",
                                "Qwen-VL prompt extender")
                return prompt
            self.vl = VLChat.from_dir(path, device=self.device,
                                      max_new_tokens=self.max_new_tokens)
        return self.vl.chat_with_image(system_prompt or self.SYSTEM_EN,
                                       prompt, image, seed=max(seed, 0)) \
            or prompt


@dataclasses.dataclass
class DashScopePromptExpander:
    """Remote DashScope extension (``prompt_extend.py:157``): requires
    network + API key; unusable in zero-egress environments."""

    model_name: str = "qwen-plus"
    api_key: Optional[str] = None

    def extend(self, prompt: str, seed: int = -1) -> str:
        try:
            import dashscope  # noqa: F401
        except ImportError:
            logger.warning("dashscope not installed; returning prompt as-is")
            return prompt
        raise RuntimeError(
            "DashScope requires network access (zero-egress environment)"
        )
