"""LTX pipeline configuration registry.

Pinned copies of ``ltx_video_gpupoor_tpu/configs/__init__.py:81-117``
(``LTXV_2B_096_DEV``, ``LTXV_2B_096_DISTILLED``) and its
``load_ltx_pipeline_config``. They are copies because importing the JAX
package imports jax; ``tests/test_torch_configs.py`` pins them equal to
the originals. The 13B multi-scale configs join with the multi-scale
pipeline (ROADMAP queue 1 step 10).
"""

from __future__ import annotations

import copy

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
