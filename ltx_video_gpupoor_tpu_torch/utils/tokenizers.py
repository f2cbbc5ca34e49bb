"""Thin HuggingFace tokenizer wrapper with text cleaning.

A copy of ``ltx_video_gpupoor_tpu/utils/tokenizers.py`` (no JAX; the
``transformers`` import stays inside the constructor).

Parity target: ``HuggingfaceTokenizer`` at
``wan/modules/tokenizers.py`` — whitespace / lower /
canonicalize cleaning, fixed seq-len padding, numpy outputs (the model stack
consumes arrays, not torch tensors). ``ftfy`` is optional (gated)."""

from __future__ import annotations

import html
import re
import string

import numpy as np


def basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string=None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return whitespace_clean(text)


class HuggingfaceTokenizer:
    def __init__(self, name: str, seq_len: int | None = None,
                 clean: str | None = None, **kwargs):
        assert clean in (None, "whitespace", "lower", "canonicalize")
        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence, return_mask: bool = False, **kwargs):
        opts = {"return_tensors": "np"}
        if self.seq_len is not None:
            opts.update(
                padding="max_length", truncation=True, max_length=self.seq_len
            )
        opts.update(kwargs)
        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(s) for s in sequence]
        ids = self.tokenizer(sequence, **opts)
        if return_mask:
            return np.asarray(ids.input_ids), np.asarray(ids.attention_mask)
        return np.asarray(ids.input_ids)
