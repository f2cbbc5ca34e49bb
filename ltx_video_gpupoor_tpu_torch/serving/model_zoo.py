"""Model catalogue: which files a model mode names, and the demo model.

Port of ``ltx_video_gpupoor_tpu/serving/model_zoo.py``, the part that needs
no file from outside: ``get_model_filename`` (:130), ``get_text_encoder_
filename`` (:156) and ``select_model_files`` (:162) are pure string logic
(pinned equal to JAX's by ``tests/test_torch_serving.py``);
``LoadedModel`` (:173) is the holder whose ``generator`` the server and
the CLI use; ``build_demo_model`` (:594) builds the tiny random-weight
stack that exercises the whole serving surface. ``load_ltxv_model``
(real checkpoints, tokenizers) and the finetune registry that goes with
it (``register_finetune``, :123) are ROADMAP queue 1 step 11.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.dtypes import DEFAULT_POLICY
from ..models.ltx import latent_upsampler as lup
from ..models.ltx import transformer3d as tf
from ..models.ltx import vae as ltx_vae
from ..pipelines.ltx_pipeline import LTXPipeline
from ..pipelines.multiscale import MultiScalePipeline
from .orchestrator import LTXVideoGenerator

TRANSFORMER_CHOICES = [
    "ckpts/ltxv_0.9.7_13B_dev_bf16.safetensors",
    "ckpts/ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors",
    "ckpts/ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors",
]

MODEL_SIGNATURES = {
    "ltxv_13B": "ltxv_0.9.7_13B_dev",
    "ltxv_13B_distilled": "ltxv_0.9.7_13B_distilled",
}

TEXT_ENCODER_CHOICES = [
    "ckpts/T5_xxl_1.1/T5_xxl_1.1_enc_bf16.safetensors",
    "ckpts/T5_xxl_1.1/T5_xxl_1.1_enc_quanto_bf16_int8.safetensors",
]

def get_model_filename(model_type: str, quantization: str = "int8",
                       dtype_policy: str = "") -> str:
    """The transformer file of a model mode under a quantization."""
    signature = MODEL_SIGNATURES[model_type]
    choices = [n for n in TRANSFORMER_CHOICES if signature in n]
    if not quantization:
        quantization = "bf16"
    if len(choices) <= 1:
        return choices[0]
    if quantization in ("int8", "fp8"):
        sub = [n for n in choices if quantization in n]
    else:
        sub = [n for n in choices if "quanto" not in n]
    if sub:
        bf = [n for n in sub if "bf16" in n]
        return (bf or sub)[0]
    return choices[0]


def get_text_encoder_filename(quantization: str = "int8") -> str:
    if quantization == "int8":
        return TEXT_ENCODER_CHOICES[1]
    return TEXT_ENCODER_CHOICES[0]


def select_model_files(model_mode: str, quantization: str = "int8",
                       dtype_policy: str = "") -> tuple[str, str]:
    """(transformer file, text-encoder file)."""
    return (get_model_filename(model_mode, quantization, dtype_policy),
            get_text_encoder_filename(quantization))


@dataclasses.dataclass
class LoadedModel:
    generator: LTXVideoGenerator
    tokenizer: object = None


def load_ltxv_model(*args, **kwargs):
    raise NotImplementedError(
        "loading real checkpoints and tokenizers: ROADMAP queue 1 step 11 "
        "(run with --demo / DEMO_MODEL=1, or inject a model)")


DEMO_VAE = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "latent_channels": 8,
    "blocks": [
        ["res_x", 1], ["compress_all", 1], ["compress_all", 1],
        ["compress_all", 1], ["res_x", 1],
    ],
    "base_channels": 8,
    "norm_num_groups": 4,
    "patch_size": 4,
    "norm_layer": "pixel_norm",
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
}


def build_demo_model(seed: int = 0, device=None) -> LoadedModel:
    """Tiny randomly-initialized stack exercising the full serving surface
    (offline smoke tests; real checkpoints replace it): a 2-layer DiT, a
    VAE with the production compression (32x spatial, 8x temporal, so a
    demo run at a real resolution sees a real token count), a latent
    upsampler, under the two-pass multi-scale config of the production
    image-to-video path. It is built on the card unless ``device="cpu"``
    is passed. The heads are 2 x 64 where the JAX package's demo has 2 x
    16: 64 is the smallest head dim the card's attention kernels take."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_demo_model: no CUDA device (pass "
                           "device='cpu' for the CPU)")
    tcfg = tf.LTXTransformerConfig(
        num_attention_heads=2, attention_head_dim=64, in_channels=8,
        out_channels=8, num_layers=2, cross_attention_dim=128,
        caption_channels=32)
    vcfg = ltx_vae.VAEConfig.from_dict(DEMO_VAE)
    up_cfg = lup.LatentUpsamplerConfig(in_channels=8, mid_channels=32,
                                       num_blocks_per_stage=1)

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(seed * 3 + offset)

    dit = tf.init_params(tf.LTXTransformer3D(tcfg, DEFAULT_POLICY,
                                             device=dev), gen(0))
    vae = ltx_vae.init_params(ltx_vae.CausalVAE(vcfg, DEFAULT_POLICY,
                                                device=dev), gen(1))
    up = lup.init_params(lup.LatentUpsampler(up_cfg, DEFAULT_POLICY,
                                             device=dev), gen(2))
    pipeline = LTXPipeline(dit, vae)
    return LoadedModel(generator=LTXVideoGenerator(
        pipeline=pipeline, multiscale=MultiScalePipeline(pipeline, up),
        # the multi-scale two-pass config: the production i2v path
        pipeline_config="ltxv-13b-0.9.7-distilled"))
