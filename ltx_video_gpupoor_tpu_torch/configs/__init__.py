"""Pipeline configuration registry.

Pinned copies of ``ltx_video_gpupoor_tpu/configs/__init__.py``: the LTX
configs (:17-117: the two 13B multi-scale configs ``LTXV_13B_097_DEV``
and ``LTXV_13B_097_DISTILLED``, ``LTXV_2B_096_DEV``,
``LTXV_2B_096_DISTILLED``) with ``load_ltx_pipeline_config``, and the Wan
configs (:135-163, ``WAN_SHARED``, ``WAN_CONFIGS``,
``WAN_SUPPORTED_SIZES``). They are copies because importing the JAX
package imports jax; ``tests/test_torch_configs.py`` pins them equal to
the originals.
"""

from __future__ import annotations

import copy

LTXV_13B_097_DEV = {
    "pipeline_type": "multi-scale",
    "checkpoint_path": "ltxv-13b-0.9.7-dev.safetensors",
    "downscale_factor": 0.6666666,
    "spatial_upscaler_model_path": "ltxv-spatial-upscaler-0.9.7.safetensors",
    "stg_mode": "attention_values",
    "decode_timestep": 0.05,
    "decode_noise_scale": 0.025,
    "precision": "bfloat16",
    "sampler": "from_checkpoint",
    "prompt_enhancement_words_threshold": 120,
    "stochastic_sampling": False,
    "first_pass": {
        "guidance_scale": [1, 1, 6, 8, 6, 1, 1],
        "stg_scale": [0, 0, 4, 4, 4, 2, 1],
        "rescaling_scale": [1, 1, 0.5, 0.5, 1, 1, 1],
        "guidance_timesteps": [1.0, 0.996, 0.9933, 0.9850, 0.9767, 0.9008,
                               0.6180],
        "skip_block_list": [[], [11, 25, 35, 39], [22, 35, 39], [28], [28],
                            [28], [28]],
        "num_inference_steps": 30,
        "skip_final_inference_steps": 3,
        "cfg_star_rescale": True,
    },
    "second_pass": {
        "guidance_scale": [1],
        "stg_scale": [1],
        "rescaling_scale": [1],
        "guidance_timesteps": [1.0],
        "skip_block_list": [27],
        "num_inference_steps": 30,
        "skip_initial_inference_steps": 17,
        "cfg_star_rescale": True,
    },
}

LTXV_13B_097_DISTILLED = {
    "pipeline_type": "multi-scale",
    "checkpoint_path": "ltxv-13b-0.9.7-distilled.safetensors",
    "downscale_factor": 0.6666666,
    "spatial_upscaler_model_path": "ltxv-spatial-upscaler-0.9.7.safetensors",
    "stg_mode": "attention_values",
    "decode_timestep": 0.05,
    "decode_noise_scale": 0.025,
    "precision": "bfloat16",
    "sampler": "from_checkpoint",
    "prompt_enhancement_words_threshold": 120,
    "stochastic_sampling": False,
    "first_pass": {
        "timesteps": [1.0000, 0.9937, 0.9875, 0.9812, 0.9750, 0.9094, 0.7250],
        "guidance_scale": 1,
        "stg_scale": 0,
        "rescaling_scale": 1,
        "skip_block_list": [42],
    },
    "second_pass": {
        "timesteps": [0.9094, 0.7250, 0.4219],
        "guidance_scale": 1,
        "stg_scale": 0,
        "rescaling_scale": 1,
        "skip_block_list": [42],
    },
}

LTXV_2B_096_DEV = {
    "pipeline_type": "base",
    "checkpoint_path": "ltxv-2b-0.9.6-dev-04-25.safetensors",
    "guidance_scale": 3,
    "stg_scale": 1,
    "rescaling_scale": 0.7,
    "skip_block_list": [19],
    "num_inference_steps": 40,
    "stg_mode": "attention_values",
    "decode_timestep": 0.05,
    "decode_noise_scale": 0.025,
    "precision": "bfloat16",
    "sampler": "from_checkpoint",
    "stochastic_sampling": False,
}

LTXV_2B_096_DISTILLED = {
    "pipeline_type": "base",
    "checkpoint_path": "ltxv-2b-0.9.6-distilled-04-25.safetensors",
    "guidance_scale": 3,
    "stg_scale": 1,
    "rescaling_scale": 0.7,
    "skip_block_list": [19],
    "num_inference_steps": 8,
    "stg_mode": "attention_values",
    "decode_timestep": 0.05,
    "decode_noise_scale": 0.025,
    "precision": "bfloat16",
    "sampler": "from_checkpoint",
    "stochastic_sampling": True,
}

LTX_PIPELINE_CONFIGS = {
    "ltxv-13b-0.9.7-dev": LTXV_13B_097_DEV,
    "ltxv-13b-0.9.7-distilled": LTXV_13B_097_DISTILLED,
    "ltxv-2b-0.9.6-dev": LTXV_2B_096_DEV,
    "ltxv-2b-0.9.6-distilled": LTXV_2B_096_DISTILLED,
}


def load_ltx_pipeline_config(name: str) -> dict:
    """Load a pipeline config by registry name or YAML path."""
    if name in LTX_PIPELINE_CONFIGS:
        return copy.deepcopy(LTX_PIPELINE_CONFIGS[name])
    import yaml

    with open(name) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------------------
# Wan configs (``wan/configs/*.py``)
# ---------------------------------------------------------------------------

WAN_SHARED = {
    "text_len": 512,
    "t5_tokenizer": "google/umt5-xxl",
    "vae_stride": (4, 8, 8),
    "patch_size": (1, 2, 2),
    "sample_neg_prompt": (
        "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
        "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
        "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
    ),
    "num_train_timesteps": 1000,
}

WAN_CONFIGS = {
    "t2v-1.3B": {**WAN_SHARED, "dim": 1536, "ffn_dim": 8960, "freq_dim": 256,
                 "num_heads": 12, "num_layers": 30, "model_type": "t2v"},
    "t2v-14B": {**WAN_SHARED, "dim": 5120, "ffn_dim": 13824, "freq_dim": 256,
                "num_heads": 40, "num_layers": 40, "model_type": "t2v"},
    "i2v-14B": {**WAN_SHARED, "dim": 5120, "ffn_dim": 13824, "freq_dim": 256,
                "num_heads": 40, "num_layers": 40, "model_type": "i2v",
                "in_dim": 36},
}

# supported generation sizes (``wan/configs/__init__.py:34-58``)
WAN_SUPPORTED_SIZES = {
    "t2v-1.3B": ("480*832", "832*480"),
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
}
