"""Checkpoint volume provisioning (the Beam uploader equivalent).

A copy of ``ltx_video_gpupoor_tpu/serving/upload.py`` on the port's
``downloads`` and ``model_zoo`` (the same file lists; pinned equal by
``tests/test_torch_aux_utils.py``).

Parity target: ``upload.py`` — a remote beam function that
triggers model downloads into the deployment volume (note: the reference
file has a syntax error at ``upload.py:26`` and cannot actually run). Here:
a host-side utility that verifies/loads every checkpoint the selected model
mode needs into ``ckpts/`` so server cold-starts are warm. Downloads
require network (HF hub); in zero-egress environments this only validates
presence.

The file list is DERIVED from the same definitions the server's download
layer uses (``downloads.py``) — the mode's transformer (plus the dev int8
base when the mode's file is a LoRA, ``model_zoo.load_ltxv_model``), the
text encoder with its tokenizer files (hub subfolder ``T5_xxl_1.1``), the
standalone VAE, and the spatial upscaler. A volume this reports fully
"present" boots ``InferenceService`` without touching the network.
"""

from __future__ import annotations

import os

from . import downloads, model_zoo

DEV_INT8_BASE = "ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors"


def required_files(
    model_mode: str = "ltxv_13B_distilled", quantization: str = "int8"
) -> list[tuple[str, str]]:
    """(hub subfolder, filename) pairs a cold server start needs."""
    tf_file, te_file = model_zoo.select_model_files(model_mode, quantization)
    te_folder = downloads.LTX_TEXT_ENCODER_DEF["sourceFolderList"][0]
    tok_files = downloads.LTX_TEXT_ENCODER_DEF["fileList"][0]
    items = [("", os.path.basename(tf_file))]
    if "lora" in os.path.basename(tf_file):
        # the LoRA-distilled mode loads the dev int8 transformer as base
        items.append(("", DEV_INT8_BASE))
    items += [
        ("", "ltxv_0.9.7_VAE.safetensors"),
        ("", "ltxv_0.9.7_spatial_upscaler.safetensors"),
        (te_folder, os.path.basename(te_file)),
    ]
    items += [(te_folder, n) for n in tok_files]
    return items


def provision(
    model_mode: str = "ltxv_13B_distilled",
    quantization: str = "int8",
    ckpt_dir: str = "ckpts",
    download: bool = True,
) -> dict:
    """Ensure all checkpoints for ``model_mode`` exist under ``ckpt_dir``.

    Returns {"[folder/]filename": "present" | "downloaded" | "missing"}."""
    os.makedirs(ckpt_dir, exist_ok=True)
    repo = downloads.LTX_TEXT_ENCODER_DEF["repoId"]
    status = {}
    for folder, name in required_files(model_mode, quantization):
        target = os.path.join(ckpt_dir, folder, name)
        key = f"{folder}/{name}" if folder else name
        if os.path.isfile(target):
            status[key] = "present"
            continue
        if download:
            try:
                # same fetch layer as the server (handles hub subfolders)
                downloads.process_files_def(
                    repoId=repo, sourceFolderList=[folder],
                    fileList=[[name]], ckpt_dir=ckpt_dir,
                )
                status[key] = "downloaded"
                continue
            except Exception:
                pass
        status[key] = "missing"
    return status


if __name__ == "__main__":
    for k, v in provision().items():
        print(f"{v:>10}  {k}")
