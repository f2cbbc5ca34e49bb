"""Checkpoint files: which ones a deployment needs, and where they go.

Port of ``ltx_video_gpupoor_tpu/serving/downloads.py`` as path logic
only: the same hub definitions (repositories, folder layout, file
lists), ``compute_list`` and ``process_files_def``, which returns at once
for a provisioned directory. This stack does not download: where a file
is missing, :func:`_hub` raises, naming the directory to provision (the
CLI then lets the loader report exactly which file is missing).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: Hub definitions. repoId + per-source-folder file lists; an empty file
#: list means "snapshot the whole folder".
LTX_TEXT_ENCODER_DEF = {
    "repoId": "DeepBeepMeep/LTX_Video",
    "sourceFolderList": ["T5_xxl_1.1", ""],
    "fileList": [
        [
            "added_tokens.json",
            "special_tokens_map.json",
            "spiece.model",
            "tokenizer_config.json",
        ],
        [
            "ltxv_0.9.7_VAE.safetensors",
            "ltxv_0.9.7_spatial_upscaler.safetensors",
            "ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors",
            "ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors",
            "ltxv_scheduler.json",
        ],
    ],
}

ENHANCER_DEF = {
    "repoId": "DeepBeepMeep/LTX_Video",
    "sourceFolderList": ["Florence2", "Llama3_2"],
    "fileList": [
        [
            "config.json",
            "configuration_florence2.py",
            "model.safetensors",
            "modeling_florence2.py",
            "preprocessor_config.json",
            "processing_florence2.py",
            "tokenizer.json",
            "tokenizer_config.json",
        ],
        [
            "config.json",
            "generation_config.json",
            "Llama3_2_quanto_bf16_int8.safetensors",
            "special_tokens_map.json",
            "tokenizer.json",
            "tokenizer_config.json",
        ],
    ],
}


def compute_list(filename: Optional[str]) -> list[str]:
    """Basename list for an optional extra file (``computeList``,
    ``inference.py:34-38``)."""
    if not filename:
        return []
    return [os.path.basename(filename)]


def process_files_def(
    repoId: str,
    sourceFolderList: list[str],
    fileList: list[list[str]],
    ckpt_dir: str = "ckpts",
) -> list[str]:
    """Check a hub definition against ``ckpt_dir``: returns [] when every
    file is in place; a missing one reaches :func:`_hub`, which raises."""
    root = Path(ckpt_dir)
    fetched: list[str] = []
    for folder, files in zip(sourceFolderList, fileList):
        if not files:
            if not (root / folder).exists():
                _hub().snapshot_download(
                    repo_id=repoId,
                    allow_patterns=folder + "/*",
                    local_dir=str(root),
                )
                fetched.append(folder + "/*")
            continue
        for name in files:
            target = root / folder / name if folder else root / name
            if target.is_file():
                continue
            kwargs = dict(
                repo_id=repoId, filename=name, local_dir=str(root)
            )
            if folder:
                kwargs["subfolder"] = folder
            _hub().hf_hub_download(**kwargs)
            fetched.append(str(target))
    return fetched


def _hub():
    raise RuntimeError(
        "checkpoint files are missing and this stack does not download; "
        "provision the checkpoint directory (see serving/model_zoo.py for "
        "the expected filenames)")


def prepare_models_and_enhancers(
    text_encoder_filename: Optional[str] = None,
    enhancer_enabled: bool = False,
    ckpt_dir: str = "ckpts",
) -> list[str]:
    """Reference ``prepare_models_and_enhancers`` (``inference.py:392-439``):
    text encoder + core LTX files, plus the Florence2/Llama enhancer pair
    when prompt enhancement is on."""
    te_def = {
        "repoId": LTX_TEXT_ENCODER_DEF["repoId"],
        "sourceFolderList": LTX_TEXT_ENCODER_DEF["sourceFolderList"],
        "fileList": [
            LTX_TEXT_ENCODER_DEF["fileList"][0]
            + compute_list(text_encoder_filename),
            LTX_TEXT_ENCODER_DEF["fileList"][1],
        ],
    }
    fetched = []
    if enhancer_enabled:
        fetched += process_files_def(**ENHANCER_DEF, ckpt_dir=ckpt_dir)
    fetched += process_files_def(**te_def, ckpt_dir=ckpt_dir)
    return fetched
