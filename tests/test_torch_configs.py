"""The port's pinned copies equal the JAX package's originals, and the
port imports without jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu import configs as jcfg
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.utils import media as jmedia
from ltx_video_gpupoor_tpu_torch import configs as tcfg
from ltx_video_gpupoor_tpu_torch.core import dtypes
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(tcfg.LTX_PIPELINE_CONFIGS))
def test_pipeline_configs_equal_jax(name):
    assert tcfg.load_ltx_pipeline_config(name) == \
        jcfg.load_ltx_pipeline_config(name)
    # a loaded config is a copy: editing it leaves the registry alone
    cfg = tcfg.load_ltx_pipeline_config(name)
    cfg["decode_timestep"] = -1
    assert tcfg.LTX_PIPELINE_CONFIGS[name]["decode_timestep"] != -1
    for nested in ("first_pass", "second_pass"):
        if nested in cfg:
            cfg[nested]["skip_block_list"] = None
            assert tcfg.LTX_PIPELINE_CONFIGS[name][nested][
                "skip_block_list"] is not None


def test_wan_configs_equal_jax():
    assert tcfg.WAN_SHARED == jcfg.WAN_SHARED
    assert tcfg.WAN_CONFIGS == jcfg.WAN_CONFIGS
    assert tcfg.WAN_SUPPORTED_SIZES == jcfg.WAN_SUPPORTED_SIZES


def test_wan_model_configs_equal_jax():
    """The Wan DiT, VAE and UMT5 configs; the DiT configs agree with the
    registry."""
    import dataclasses

    from ltx_video_gpupoor_tpu.models import t5 as jt5
    from ltx_video_gpupoor_tpu.models.wan import model as jwm
    from ltx_video_gpupoor_tpu.models.wan import vae as jwv
    from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv

    for t, j in ((twm.WAN_T2V_1_3B, jwm.WAN_T2V_1_3B),
                 (twm.WAN_T2V_14B, jwm.WAN_T2V_14B),
                 (twm.WanConfig(), jwm.WanConfig()),
                 (twv.WanVAEConfig(), jwv.WanVAEConfig()),
                 (tt5.UMT5_XXL, jt5.UMT5_XXL), (tt5.T5_XXL, jt5.T5_XXL)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name, cfg in (("t2v-1.3B", twm.WAN_T2V_1_3B),
                      ("t2v-14B", twm.WAN_T2V_14B)):
        reg = tcfg.WAN_CONFIGS[name]
        assert all(getattr(cfg, f) == reg[f] for f in
                   ("dim", "ffn_dim", "freq_dim", "num_heads", "num_layers",
                    "model_type", "text_len", "patch_size"))
    np.testing.assert_array_equal(twv.WAN_LATENT_MEAN, jwv.WAN_LATENT_MEAN)
    np.testing.assert_array_equal(twv.WAN_LATENT_STD, jwv.WAN_LATENT_STD)


def test_vae_config_equal_jax():
    assert tvae.LTX_VAE_CONFIG_097 == jvae.LTX_VAE_CONFIG_097
    t = tvae.VAEConfig.from_dict(tvae.LTX_VAE_CONFIG_097)
    j = jvae.VAEConfig.from_dict(jvae.LTX_VAE_CONFIG_097)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}
    assert t.spatial_downscale_factor == j.spatial_downscale_factor == 32
    assert t.temporal_downscale_factor == j.temporal_downscale_factor == 8
    assert tvae._decoder_plan(t) == jvae._decoder_plan(j)


@pytest.mark.parametrize("h,w,hp,wp", [(480, 704, 480, 704),
                                       (250, 250, 256, 256),
                                       (300, 500, 320, 512)])
def test_padding_helpers_equal_jax(h, w, hp, wp):
    pad = tmedia.calculate_padding(h, w, hp, wp)
    assert pad == jmedia.calculate_padding(h, w, hp, wp)
    frames = np.arange(10 * hp * wp * 3).reshape(10, hp, wp, 3)
    np.testing.assert_array_equal(tmedia.crop_padding(frames, pad, 9),
                                  jmedia.crop_padding(frames, pad, 9))
    crop = tmedia.crop_padding(torch.from_numpy(frames), pad, 9)
    assert tuple(crop.shape) == (9, h, w, 3)


def test_dtype_policy():
    """bf16 weights and activations by default, fp32 for parity runs; the
    norms keep fp32 math and return the input dtype."""
    from ltx_video_gpupoor_tpu_torch.ops.norms import rms_norm

    assert dtypes.DEFAULT_POLICY.param_dtype == torch.bfloat16
    assert dtypes.DEFAULT_POLICY.compute_dtype == torch.bfloat16
    assert dtypes.FP32_POLICY.compute_dtype == torch.float32
    x = torch.full((2, 8), 300.0, dtype=torch.bfloat16)
    y = rms_norm(x)
    assert y.dtype == torch.bfloat16 and torch.all(y == 1.0)


def test_port_imports_without_jax():
    """Every module of the port (79 since the prompt enhancers, the legacy
    VAE, U2-Net and the helpers) imports without jax, the JAX package or
    ``transformers`` (the enhancers import it inside ``from_dir``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ltx_video_gpupoor_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('ltx_video_gpupoor_tpu.') or "
        "m == 'transformers' or m.startswith('transformers.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 79 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
