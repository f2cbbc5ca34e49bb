"""Diffusers-checkpoint compatibility tables.

A pinned copy of ``ltx_video_gpupoor_tpu/core/diffusers_compat.py``
(framework-free; ``tests/test_torch_checkpoint.py`` holds it equal): a
hashable-config lookup translating Lightricks' diffusers-format
scheduler / transformer / VAE configs into this stack's configs. The key
renames live in ``core/checkpoint.py``, where conversion happens. The
config dictionaries are checkpoint metadata published with the LTX
releases.
"""

from __future__ import annotations


def make_hashable_key(dict_key: dict):
    """Stable hashable form of a (nested) config dict
    (``diffusers_config_mapping.py:1-10``)."""

    def convert(value):
        if isinstance(value, list):
            return tuple(value)
        if isinstance(value, dict):
            return tuple(sorted((k, convert(v)) for k, v in value.items()))
        return value

    return tuple(sorted((k, convert(v)) for k, v in dict_key.items()))


DIFFUSERS_SCHEDULER_CONFIG = {
    "_class_name": "FlowMatchEulerDiscreteScheduler",
    "_diffusers_version": "0.32.0.dev0",
    "base_image_seq_len": 1024,
    "base_shift": 0.95,
    "invert_sigmas": False,
    "max_image_seq_len": 4096,
    "max_shift": 2.05,
    "num_train_timesteps": 1000,
    "shift": 1.0,
    "shift_terminal": 0.1,
    "use_beta_sigmas": False,
    "use_dynamic_shifting": True,
    "use_exponential_sigmas": False,
    "use_karras_sigmas": False,
}

DIFFUSERS_TRANSFORMER_CONFIG = {
    "_class_name": "LTXVideoTransformer3DModel",
    "_diffusers_version": "0.32.0.dev0",
    "activation_fn": "gelu-approximate",
    "attention_bias": True,
    "attention_head_dim": 64,
    "attention_out_bias": True,
    "caption_channels": 4096,
    "cross_attention_dim": 2048,
    "in_channels": 128,
    "norm_elementwise_affine": False,
    "norm_eps": 1e-06,
    "num_attention_heads": 32,
    "num_layers": 28,
    "out_channels": 128,
    "patch_size": 1,
    "patch_size_t": 1,
    "qk_norm": "rms_norm_across_heads",
}

DIFFUSERS_VAE_CONFIG = {
    "_class_name": "AutoencoderKLLTXVideo",
    "_diffusers_version": "0.32.0.dev0",
    "block_out_channels": [128, 256, 512, 512],
    "decoder_causal": False,
    "encoder_causal": True,
    "in_channels": 3,
    "latent_channels": 128,
    "layers_per_block": [4, 3, 3, 3, 4],
    "out_channels": 3,
    "patch_size": 4,
    "patch_size_t": 1,
    "resnet_norm_eps": 1e-06,
    "scaling_factor": 1.0,
    "spatio_temporal_scaling": [True, True, True, False],
}

OURS_SCHEDULER_CONFIG = {
    "_class_name": "RectifiedFlowScheduler",
    "num_train_timesteps": 1000,
    "shifting": "SD3",
    "base_resolution": None,
    "target_shift_terminal": 0.1,
}

OURS_TRANSFORMER_CONFIG = {
    "_class_name": "Transformer3DModel",
    "activation_fn": "gelu-approximate",
    "attention_bias": True,
    "attention_head_dim": 64,
    "caption_channels": 4096,
    "cross_attention_dim": 2048,
    "in_channels": 128,
    "norm_elementwise_affine": False,
    "norm_eps": 1e-06,
    "num_attention_heads": 32,
    "num_layers": 28,
    "out_channels": 128,
    "qk_norm": "rms_norm",
    "standardization_norm": "rms_norm",
    "positional_embedding_type": "rope",
    "positional_embedding_theta": 10000.0,
    "positional_embedding_max_pos": [20, 2048, 2048],
    "timestep_scale_multiplier": 1000,
}

OURS_VAE_CONFIG = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 128,
    "blocks": [
        ["res_x", 4], ["compress_all", 1], ["res_x_y", 1], ["res_x", 3],
        ["compress_all", 1], ["res_x_y", 1], ["res_x", 3],
        ["compress_all", 1], ["res_x", 3], ["res_x", 4],
    ],
    "scaling_factor": 1.0,
    "norm_layer": "pixel_norm",
    "patch_size": 4,
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
}

_MAPPING = {
    make_hashable_key(DIFFUSERS_SCHEDULER_CONFIG): OURS_SCHEDULER_CONFIG,
    make_hashable_key(DIFFUSERS_TRANSFORMER_CONFIG): OURS_TRANSFORMER_CONFIG,
    make_hashable_key(DIFFUSERS_VAE_CONFIG): OURS_VAE_CONFIG,
}


def lookup_config(diffusers_config: dict) -> dict | None:
    """Translate a known diffusers config dict into ours (None if unknown —
    the reference raises later in that case)."""
    # version fields vary between exports; ignore them for matching
    scrub = {
        k: v for k, v in diffusers_config.items()
        if k != "_diffusers_version"
    }
    import copy

    for known, ours in _MAPPING.items():
        known_scrubbed = tuple(
            (k, v) for k, v in known if k != "_diffusers_version"
        )
        if make_hashable_key(scrub) == known_scrubbed:
            # deep copy: a shallow dict() aliases the nested lists
            # ('blocks', max_pos) to the module constants, so caller
            # mutation would corrupt every later lookup
            return copy.deepcopy(ours)
    return None


def maybe_translate_config(cfg_dict: dict | None) -> dict | None:
    """Translate a diffusers-format config dict to ours when recognized;
    pass native configs through unchanged. Diffusers VAE configs carry
    ``_class_name: AutoencoderKL*`` and no ``blocks`` plan — feeding one
    raw into ``VAEConfig.from_dict`` silently builds the wrong
    architecture (group_norm, quant conv, empty block plan)."""
    if not cfg_dict:
        return cfg_dict
    name = str(cfg_dict.get("_class_name", ""))
    if name.startswith("AutoencoderKL") or (
        "down_block_types" in cfg_dict and "blocks" not in cfg_dict
    ):
        translated = lookup_config(cfg_dict)
        if translated is not None:
            return translated
        raise ValueError(
            "unrecognized diffusers-format VAE config (class "
            f"{name!r}); known exports are translated via "
            "core/diffusers_compat.py"
        )
    return cfg_dict
