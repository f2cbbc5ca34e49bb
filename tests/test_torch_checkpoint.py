"""The loaders against the JAX package, on synthetic files written in the
published layout (the published weights are not in the repository):

- the port's own safetensors reader and writer against the
  ``safetensors`` package (bf16, fp32, int8, fp16, metadata; a strided
  view written by its values);
- the native mmap reader (``runtime/native_loader.py``, built from
  ``runtime/safetensors_loader.cpp``) against the Python reader and the
  JAX package's native reader;
- ``dequantize_quanto`` and ``save_quantized_model`` equal to JAX's;
- random torch-layout dicts: JAX's ``convert_*`` + ``core/from_jax.py``
  equal to the port's converters (transformer, VAE in native and
  diffusers naming, T5 in HF and Wan naming, latent upsampler);
- ``normalize_lora_keys`` and ``merge_lora`` equal;
- the pinned ``diffusers_compat`` and the path logic of ``downloads``;
- ``load_ltxv_model`` on a tiny synthetic checkpoint directory (the
  LoRA-distilled convention, the VAE file, the upscaler) against JAX's
  ``load_ltxv_model``: the same weights, and generated latents and frames
  >= 40 dB apart with injected noise; the CLI without ``--demo`` on that
  directory, ``--save-quantized`` included;
- every new module imports with jax and the JAX package blocked.

Tolerances: exact where both sides do the same integer or fp32 ops; 1e-6
relative where a LoRA delta is summed in another order; the LTX weights
in bf16 (both converters cast to it), 2**-8 relative for the adaLN MLP
that JAX keeps in fp32 and the port's bf16 policy rounds; 40 dB for the
generated video (PARITY.md's bar).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.core import checkpoint as jckpt
from ltx_video_gpupoor_tpu.core import diffusers_compat as jdc
from ltx_video_gpupoor_tpu.core import lora as jlora
from ltx_video_gpupoor_tpu.models import t5 as jt5
from ltx_video_gpupoor_tpu.models.ltx import transformer3d as jtf
from ltx_video_gpupoor_tpu.models.ltx import vae as jvae
from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.runtime import native_loader as jnl
from ltx_video_gpupoor_tpu.serving import downloads as jdl
from ltx_video_gpupoor_tpu.serving import model_zoo as jzoo
from ltx_video_gpupoor_tpu.serving import orchestrator as jorch
from ltx_video_gpupoor_tpu_torch.core import checkpoint as tckpt
from ltx_video_gpupoor_tpu_torch.core import diffusers_compat as tdc
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core import lora as tlora
from ltx_video_gpupoor_tpu_torch.core.dtypes import DtypePolicy
from ltx_video_gpupoor_tpu_torch.models import t5 as tt5
from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as tlup
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.models.ltx import vae as tvae
from ltx_video_gpupoor_tpu_torch.runtime import native_loader as tnl
from ltx_video_gpupoor_tpu_torch.serving import cli as tcli
from ltx_video_gpupoor_tpu_torch.serving import downloads as tdl
from ltx_video_gpupoor_tpu_torch.serving import model_zoo as tzoo
from ltx_video_gpupoor_tpu_torch.tools import synthetic_ckpt as sc
from ltx_video_gpupoor_tpu_torch.utils import media as tmedia

import test_torch_ltx13b as slice13b   # the multi-scale noise injection

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_BAR_DB = 40.0
TF_KW = dict(num_attention_heads=2, attention_head_dim=64, in_channels=16,
             out_channels=16, num_layers=2, cross_attention_dim=128,
             caption_channels=32)
VAE_DICT = {
    "_class_name": "CausalVideoAutoencoder", "dims": 3, "latent_channels": 16,
    "blocks": [["res_x", 1], ["compress_all", 1], ["res_x", 1]],
    "base_channels": 8, "norm_num_groups": 4, "patch_size": 2,
    "norm_layer": "pixel_norm", "latent_log_var": "uniform",
    "use_quant_conv": False, "causal_decoder": False,
    "timestep_conditioning": True,
}
UP_CFG = tlup.LatentUpsamplerConfig(in_channels=16, mid_channels=32,
                                    num_blocks_per_stage=1, dims=3)
LORA_FILE = "ckpts/ltxv_0.9.7_13B_distilled_lora128_bf16.safetensors"
TE_FILE = "ckpts/T5_xxl_1.1/T5_xxl_1.1_enc_quanto_bf16_int8.safetensors"
identity_crf = slice13b.identity_crf   # the CRF round trip as identity
# the port's bf16 policy for the DiT with fp32 activations, as JAX runs it
BF16_PARAMS = DtypePolicy(param_dtype=torch.bfloat16,
                          compute_dtype=torch.float32)


def _np(t):
    """A torch tensor as numpy (bf16 as float32)."""
    t = torch.as_tensor(t)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.f32": torch.randn(7, generator=g),
        "c.i8": torch.randint(-127, 128, (4, 6), generator=g,
                              dtype=torch.int8),
        "d.f16": torch.randn(2, 2, 2, generator=g).half(),
        "e.i64": torch.arange(5),
        "f.empty": torch.zeros(0, 3),
    }


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def test_safetensors_writer_read_by_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    ts = _tensors()
    # a transposed view is written by its values, not its raw buffer
    ts["g.view"] = torch.arange(12.0).reshape(3, 4).T
    path = str(tmp_path / "port.safetensors")
    tckpt.save_safetensors(path, ts, {"transformer": {"num_layers": 2}})
    _equal(load_file(path), {k: v.contiguous() for k, v in ts.items()})
    with safe_open(path, framework="pt") as f:
        assert json.loads(f.metadata()["config"]) == {
            "transformer": {"num_layers": 2}}
    # numpy values too
    tckpt.save_safetensors(path, {"n": np.arange(6, dtype=np.int32)})
    _equal(load_file(path), {"n": torch.arange(6, dtype=torch.int32)})


def test_safetensors_reader_reads_the_package(tmp_path):
    from safetensors.torch import save_file

    ts = _tensors(1)
    path = str(tmp_path / "pkg.safetensors")
    save_file(ts, path, metadata={"config": json.dumps({"vae": {"x": 1}})})
    got, config = tckpt.load_safetensors(path)
    _equal(got, ts)
    assert config == {"vae": {"x": 1}}
    save_file(ts, path)
    assert tckpt.load_safetensors(path)[1] == {}
    # and the JAX reader agrees on what the port writes
    tckpt.save_safetensors(path, ts, {"k": 3})
    jt, jc = jckpt.load_safetensors(path)
    assert jc == {"k": 3}
    for k in ts:
        np.testing.assert_array_equal(_jnp(jt[k]), _np(ts[k]))


def test_native_loader_equal_python_reader_and_jax(tmp_path):
    assert (tnl._get_lib() is None) == (jnl._get_lib() is None)
    if tnl._get_lib() is None:
        pytest.skip("the native loader does not build on this machine")
    ts = {k: v for k, v in _tensors(2).items() if k != "f.empty"}
    path = str(tmp_path / "n.safetensors")
    tckpt.save_safetensors(path, ts, {"transformer": {"num_layers": 4}})
    got, config = tnl.load_safetensors_native(path)
    py, py_config = tckpt.load_safetensors(path)
    _equal(got, py)
    assert config == py_config == {"transformer": {"num_layers": 4}}
    jt, jc = jnl.load_safetensors_native(path)
    assert jc == config
    for k in ts:
        np.testing.assert_array_equal(_jnp(jt[k]), _np(got[k]))
    assert str(tnl._SO_PATH).startswith(
        os.path.join(REPO, "ltx_video_gpupoor_tpu_torch", "build"))
    with pytest.raises(OSError):
        tnl.load_safetensors_native(str(tmp_path / "missing.safetensors"))


# ---------------------------------------------------------------------------
# quanto pairs
# ---------------------------------------------------------------------------

def _quanto_dict(seed=3):
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    return {
        # torch [out, in] with [out, 1] scales (the published files)
        "blocks.0.attn.to_q.weight._data": i8(6, 4),
        "blocks.0.attn.to_q.weight._scale":
            rng.uniform(0.01, 0.1, (6, 1)).astype(np.float32),
        # JAX [in, out] kernels with [out] scales, and a layer stack
        "proj.kernel._data": i8(4, 5),
        "proj.kernel._scale": rng.uniform(0.01, 0.1, 5).astype(np.float32),
        "blocks.ff.kernel._data": i8(3, 4, 5),
        "blocks.ff.kernel._scale":
            rng.uniform(0.01, 0.1, (3, 5)).astype(np.float32),
        # a base without .weight, a lone _data, plain tensors
        "adaln.linear._data": i8(2, 3),
        "adaln.linear._scale": np.full((2, 1), 0.5, np.float32),
        "orphan._data": i8(2, 2),
        "norm.weight": rng.standard_normal(4).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_quanto_equal_jax(dtype):
    src = _quanto_dict()
    ref = jckpt.dequantize_quanto(dict(src))
    tsrc = {k: torch.from_numpy(v) for k, v in src.items()}
    out = tckpt.dequantize_quanto(dict(tsrc), dtype)
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        want = torch.from_numpy(np.asarray(v))
        if want.is_floating_point() and k != "norm.weight":
            want = want.to(dtype)
        assert out[k].dtype == want.dtype, k
        assert torch.equal(out[k], want), k
    consumed = dict(tsrc)
    again = tckpt.dequantize_quanto(consumed, dtype, consume=True)
    assert consumed == {}
    _equal(again, out)


def test_save_quantized_model_equal_jax(tmp_path):
    """fp32 weights: the JAX file's keys and values. (For a bf16 tree
    JAX's ``np.issubdtype(bf16, np.floating)`` is False, so it writes the
    kernels unquantized as fp32; the port quantizes bf16 kernels too, as
    the function says it does.)"""
    jp = jtf.init_params(jax.random.key(5), jtf.LTXTransformerConfig(**TF_KW))
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                 DtypePolicy(torch.float32, torch.float32))
    model.load_state_dict(from_jax.state_dict(jax.tree.map(np.asarray, jp)))
    ref = jckpt.save_quantized_model(str(tmp_path / "jax"), jp)
    out = tckpt.save_quantized_model(str(tmp_path / "port"), model)
    assert out.endswith("port_quanto_bf16_int8.safetensors")
    jt, _ = jckpt.load_safetensors(ref)
    pt, _ = tckpt.load_safetensors(out)
    assert sorted(jt) == sorted(pt)
    assert any(k.endswith(".kernel._data") for k in pt)
    for k in jt:
        assert pt[k].shape == tuple(np.asarray(jt[k]).shape), k
        np.testing.assert_array_equal(_np(pt[k]), _jnp(jt[k]), err_msg=k)
    bf16 = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                BF16_PARAMS)
    bf16.load_state_dict(model.state_dict())
    pt16, _ = tckpt.load_safetensors(tckpt.save_quantized_model(
        str(tmp_path / "bf16.safetensors"), bf16))
    assert sorted(pt16) == sorted(pt)
    assert pt16["blocks.attn1.to_q.kernel._data"].dtype == torch.int8
    assert pt16["blocks.attn1.q_norm.weight"].dtype == torch.float32


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def _random_like(sd: dict, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in sd.items()}


def _same(a, b):
    """Equal values (from_jax gives a 0-d leaf as shape [1])."""
    return a.numel() == b.numel() and torch.equal(a.reshape(b.shape), b)


def _check_converted(ref_tree, out, to_sd=from_jax.state_dict):
    ref = to_sd(jax.tree.map(np.asarray, ref_tree))
    assert sorted(ref) == sorted(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype, k
        assert _same(ref[k], out[k]), k


@pytest.mark.parametrize("naming", ["native", "diffusers"])
def test_convert_ltx_transformer_equal_jax(naming):
    meta = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW),
                                device="meta")
    sd = {sc.published_key(k): v for k, v in
          _random_like(meta.state_dict(), 6).items()}
    if naming == "diffusers":
        sd = {k.replace("patchify_proj", "proj_in")
              .replace("adaln_single", "time_embed")
              .replace("q_norm", "norm_q").replace("k_norm", "norm_k"): v
              for k, v in sd.items()}
    ref = jckpt.convert_ltx_transformer({k: v.numpy() for k, v in sd.items()},
                                        TF_KW["num_layers"])
    out = tckpt.convert_ltx_transformer(sd, TF_KW["num_layers"])
    _check_converted(ref, out)
    ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**TF_KW)).load_state_dict(
        out)


def test_vae_diffusers_renames_equal_jax():
    keys = []
    for a, _ in tckpt._VAE_RENAMES:
        keys += [f"{a}.weight", f"{a}.resnets.1.conv1.conv.weight",
                 f"{a}.resnets.0.norm3.norm.bias",
                 f"{a}.resnets.0.conv_shortcut.conv.weight"]
    for k in keys:
        assert tckpt._apply_vae_renames(k) == jckpt._apply_vae_renames(k), k


@pytest.mark.parametrize("timestep_conditioning", [True, False])
def test_convert_ltx_vae_equal_jax(timestep_conditioning):
    vae_dict = {**VAE_DICT, "timestep_conditioning": timestep_conditioning}
    sd = {k: v.float() for k, v in sc.vae_tensors(vae_dict, seed=7).items()}
    cfg = tvae.VAEConfig.from_dict(vae_dict)
    ref = jckpt.convert_ltx_vae({k: v.numpy() for k, v in sd.items()},
                                jvae.VAEConfig.from_dict(vae_dict))
    out = tckpt.convert_ltx_vae(sd, cfg)
    _check_converted(ref, out, from_jax.vae_state_dict)
    tvae.CausalVAE(cfg).load_state_dict(out)


@pytest.mark.parametrize("hf", [False, True])
@pytest.mark.parametrize("shared_pos", [True, False])
def test_convert_t5_encoder_equal_jax(hf, shared_pos):
    kw = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
              num_layers=2, shared_pos=shared_pos)
    sd = _random_like(tt5.T5Encoder(tt5.T5Config(**kw),
                                    device="meta").state_dict(), 8)
    names = {}
    for k in sd:
        n = k.replace("token_embedding", "token_embedding.weight") \
            .replace("pos_embedding", "pos_embedding.embedding.weight") \
            .replace("ffn.gate.weight", "ffn.gate.0.weight")
        if hf:
            n = (n.replace("token_embedding.weight", "shared.weight")
                 .replace("norm.weight", "encoder.final_layer_norm.weight"))
            parts = n.split(".")
            if parts[0] == "blocks":
                i, rest = parts[1], ".".join(parts[2:])
                rest = {
                    "norm1.weight": "layer.0.layer_norm.weight",
                    "attn.q.weight": "layer.0.SelfAttention.q.weight",
                    "attn.k.weight": "layer.0.SelfAttention.k.weight",
                    "attn.v.weight": "layer.0.SelfAttention.v.weight",
                    "attn.o.weight": "layer.0.SelfAttention.o.weight",
                    "norm2.weight": "layer.1.layer_norm.weight",
                    "ffn.gate.0.weight": "layer.1.DenseReluDense.wi_0.weight",
                    "ffn.fc1.weight": "layer.1.DenseReluDense.wi_1.weight",
                    "ffn.fc2.weight": "layer.1.DenseReluDense.wo.weight",
                    "pos_embedding.embedding.weight":
                        "layer.0.SelfAttention.relative_attention_bias.weight",
                }[rest]
                n = f"encoder.block.{i}.{rest}"
            elif n == "pos_embedding.embedding.weight":
                n = ("encoder.block.0.layer.0.SelfAttention."
                     "relative_attention_bias.weight")
        names[k] = n
    sd = {names[k]: v for k, v in sd.items()}
    if hf and shared_pos:
        assert "encoder.block.0.layer.0.SelfAttention." \
            "relative_attention_bias.weight" in sd
    ref = jckpt.convert_t5_encoder({k: v.numpy() for k, v in sd.items()},
                                   2, shared_pos)
    out = tckpt.convert_t5_encoder(sd, 2, shared_pos)
    _check_converted(ref, out)
    tt5.T5Encoder(tt5.T5Config(**kw)).load_state_dict(out)


@pytest.mark.parametrize("dims", [2, 3])
def test_convert_latent_upsampler_equal_jax(dims):
    cfg = tlup.LatentUpsamplerConfig(in_channels=16, mid_channels=32,
                                     num_blocks_per_stage=2, dims=dims)
    sd = {k: v.float() for k, v in sc.upscaler_tensors(cfg, seed=9).items()}
    ref = jzoo.convert_latent_upsampler({k: v.numpy() for k, v in sd.items()})
    out = tzoo.convert_latent_upsampler(sd)
    _check_converted(ref, out, from_jax.upsampler_state_dict)
    tlup.LatentUpsampler(cfg).load_state_dict(out)


def test_converters_of_later_slices_raise():
    """The legacy VAE's converter still raises naming step 14. The Wan,
    Wan VAE and CLIP converters, which raised here until their models were
    ported, give ``from_jax`` of JAX's converters on the same published
    tensors (synthetic, tools/synthetic_ckpt.py)."""
    with pytest.raises(NotImplementedError, match="step 14"):
        tckpt.convert_legacy_vae({}, None)
    from ltx_video_gpupoor_tpu.models.wan import vae as jwv
    from ltx_video_gpupoor_tpu_torch.models.wan import clip as tclip
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm
    from ltx_video_gpupoor_tpu_torch.models.wan import vae as twv

    wcfg = twm.WanConfig(model_type="i2v", dim=128, ffn_dim=256, freq_dim=32,
                         text_dim=64, num_heads=1, num_layers=2, in_dim=36)
    vkw = dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
               attn_scales=(), temperal_downsample=(True,))
    ccfg = tclip.CLIPVisionConfig(image_size=28, dim=160, num_heads=2,
                                  num_layers=2)
    for sd, port, jax_conv in (
            (sc.wan_transformer_tensors(wcfg),
             lambda t: tckpt.convert_wan_model(t, wcfg),
             lambda t: jckpt.convert_wan_model(t, wcfg)),
            (sc.wan_vae_tensors(twv.WanVAEConfig(**vkw)),
             lambda t: tckpt.convert_wan_vae(t, twv.WanVAEConfig(**vkw)),
             lambda t: jckpt.convert_wan_vae(t, jwv.WanVAEConfig(**vkw))),
            (sc.wan_clip_tensors(ccfg),
             lambda t: tckpt.convert_clip_vision(t, 2),
             lambda t: jckpt.convert_clip_vision(t, 2))):
        sd = tckpt.dequantize_quanto(sd, torch.float32)
        got = port(sd)
        want = from_jax.state_dict(jax.tree.map(np.asarray, jax_conv(
            {k: _np(v) for k, v in sd.items()})))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            torch.testing.assert_close(got[k], v.reshape(got[k].shape),
                                       atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("variant", [
    dict(vace_layers=(0, 2), vace_in_dim=12),
    dict(recammaster=True),
    dict(inject_sample_info=True),
    dict(vace_layers=(1,), vace_in_dim=20, recammaster=True,
         inject_sample_info=True),
], ids=["vace", "recammaster", "fps", "all"])
def test_convert_wan_model_variants_equal_jax(variant):
    """A synthetic Wan file in the published layout with VACE's, the
    camera's and the fps conditioning's keys (tools/synthetic_ckpt.py):
    the port's converter gives ``from_jax`` of JAX's converter on it, and
    its output loads into a ``WanModel`` of that config."""
    from ltx_video_gpupoor_tpu_torch.models.wan import model as twm

    wcfg = twm.WanConfig(model_type="t2v", dim=128, ffn_dim=256, freq_dim=32,
                         text_dim=64, num_heads=1, num_layers=3, **variant)
    sd = sc.wan_transformer_tensors(wcfg)
    if "vace_layers" in variant:
        assert "vace_blocks.0.before_proj.weight" in sd
        assert "vace_patch_embedding.weight" in sd
    if variant.get("recammaster"):
        assert "blocks.2.cam_encoder.weight._data" in sd
    if variant.get("inject_sample_info"):
        assert {"fps_embedding.weight", "fps_projection.2.bias"} <= set(sd)
    sd = tckpt.dequantize_quanto(sd, torch.float32)
    got = tckpt.convert_wan_model(sd, wcfg)
    want = from_jax.state_dict(jax.tree.map(np.asarray, jckpt.convert_wan_model(
        {k: _np(v) for k, v in sd.items()}, wcfg)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v.reshape(got[k].shape), atol=0,
                                   rtol=0, msg=k)
    model = twm.WanModel(wcfg)
    model.load_state_dict(got)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def test_normalize_lora_keys_equal_jax():
    keys = ["lora_unet_blocks_3_attn1_to_q.lora_down.weight",
            "lora_unet_blocks_3_attn1_to_out_0.lora_up.weight",
            "lora_unet_blocks_0_ff_net_0_proj.lora_down.weight",
            "lora_unet_blocks_0_ff_net_2.lora_up.weight",
            "lora_unet_blocks_1_self_attn_q.alpha",
            "lora_unet_blocks_1_cross_attn_k.lora_down.weight",
            "lora_unet_blocks_2_ffn_0.lora_up.weight",
            "diffusion_model.transformer_blocks.4.attn2.to_k.lora_A.weight",
            "transformer.proj_out.lora_B.weight"]
    sd = {k: np.zeros(1, np.float32) for k in keys}
    assert list(tlora.normalize_lora_keys(sd)) == \
        list(jlora.normalize_lora_keys(sd))


@pytest.mark.parametrize("alpha", [None, 4.0])
def test_merge_lora_equal_jax(alpha):
    jp = jtf.init_params(jax.random.key(4), jtf.LTXTransformerConfig(**TF_KW))
    lora = {k: _np(v) for k, v in sc.lora_tensors(
        ttf.LTXTransformerConfig(**TF_KW), 4, seed=11, std=0.1).items()}
    lora["diffusion_model.proj_out.lora_A.weight"] = np.ones((4, 128),
                                                             np.float32)
    lora["diffusion_model.proj_out.lora_B.weight"] = np.full((16, 4), 0.01,
                                                             np.float32)
    lora["diffusion_model.nothing.lora_A.weight"] = np.ones((4, 4),
                                                            np.float32)
    lora["diffusion_model.nothing.lora_B.weight"] = np.ones((4, 4),
                                                            np.float32)
    if alpha is not None:
        for k in list(lora):
            if k.endswith(".lora_A.weight"):
                lora[k[: -len(".lora_A.weight")] + ".alpha"] = np.float32(alpha)
    ref, n_ref = jlora.merge_lora(jp, lora, multiplier=0.7)
    sd = from_jax.state_dict(jax.tree.map(np.asarray, jp))
    q = sd["blocks.0.attn1.to_q.weight"]
    before = q.clone()
    out, n = tlora.merge_lora(sd, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in lora.items()}, multiplier=0.7)
    assert n == n_ref == 10 * TF_KW["num_layers"] + 1
    ref = from_jax.state_dict(jax.tree.map(np.asarray, ref))
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # in place: the given tensors themselves (a model's parameters)
    assert out is sd and out["blocks.0.attn1.to_q.weight"] is q
    assert not torch.equal(q, before)


# ---------------------------------------------------------------------------
# pinned framework-free modules
# ---------------------------------------------------------------------------

def test_diffusers_compat_is_a_pinned_copy():
    for name in ("DIFFUSERS_SCHEDULER_CONFIG", "DIFFUSERS_TRANSFORMER_CONFIG",
                 "DIFFUSERS_VAE_CONFIG", "OURS_SCHEDULER_CONFIG",
                 "OURS_TRANSFORMER_CONFIG", "OURS_VAE_CONFIG"):
        assert getattr(tdc, name) == getattr(jdc, name), name
    for cfg in (jdc.DIFFUSERS_VAE_CONFIG, jdc.DIFFUSERS_TRANSFORMER_CONFIG,
                {**jdc.DIFFUSERS_VAE_CONFIG, "_diffusers_version": "9"},
                {"blocks": [], "_class_name": "CausalVideoAutoencoder"},
                None, {}):
        assert tdc.lookup_config(cfg or {}) == jdc.lookup_config(cfg or {})
        assert tdc.maybe_translate_config(cfg) == \
            jdc.maybe_translate_config(cfg)
    with pytest.raises(ValueError, match="unrecognized"):
        tdc.maybe_translate_config({"_class_name": "AutoencoderKLFoo"})


def test_downloads_path_logic_equal_jax(tmp_path):
    assert tdl.LTX_TEXT_ENCODER_DEF == jdl.LTX_TEXT_ENCODER_DEF
    assert tdl.ENHANCER_DEF == jdl.ENHANCER_DEF
    for f in (None, "", "ckpts/T5_xxl_1.1/x.safetensors"):
        assert tdl.compute_list(f) == jdl.compute_list(f)
    # a provisioned directory: nothing to fetch, in both packages
    for folder, files in zip(tdl.LTX_TEXT_ENCODER_DEF["sourceFolderList"],
                             tdl.LTX_TEXT_ENCODER_DEF["fileList"]):
        for name in files + ["extra.safetensors"]:
            path = tmp_path / folder / name
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(b"")
    (tmp_path / "T5_xxl_1.1" / "extra.safetensors").write_bytes(b"")
    kw = dict(text_encoder_filename="ckpts/T5_xxl_1.1/extra.safetensors",
              ckpt_dir=str(tmp_path))
    assert tdl.prepare_models_and_enhancers(**kw) == \
        jdl.prepare_models_and_enhancers(**kw) == []
    # a missing file: this stack does not download
    with pytest.raises(RuntimeError, match="does not download"):
        tdl.prepare_models_and_enhancers(ckpt_dir=str(tmp_path / "empty"))


def test_maybe_resolves_like_jax(tmp_path):
    (tmp_path / "T5_xxl_1.1").mkdir()
    (tmp_path / "T5_xxl_1.1" / "t5.safetensors").write_bytes(b"")
    (tmp_path / "vae.safetensors").write_bytes(b"")
    for name in ("ckpts/T5_xxl_1.1/t5.safetensors", "ckpts/vae.safetensors",
                 "vae.safetensors", "missing.safetensors", None, ""):
        assert tzoo._maybe(name, str(tmp_path)) == \
            jzoo._maybe(name, str(tmp_path)), name


# ---------------------------------------------------------------------------
# load_ltxv_model and the CLI on a synthetic checkpoint directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpts"))
    info = sc.write_ltxv_ckpt_dir(root, ttf.LTXTransformerConfig(**TF_KW),
                                  VAE_DICT, UP_CFG, lora_rank=4, seed=3)
    assert sorted(info["paths"]) == sorted(
        [sc.TRANSFORMER_FILE, sc.LORA_FILE, sc.VAE_FILE, sc.UPSCALER_FILE])
    return root


@pytest.fixture(scope="module")
def loaded(ckpt_dir):
    port = tzoo.load_ltxv_model(LORA_FILE, "ltxv_13B_distilled", ckpt_dir,
                                TE_FILE, device="cpu", policy=BF16_PARAMS)
    ref = jzoo.load_ltxv_model(LORA_FILE, "ltxv_13B_distilled", ckpt_dir,
                               TE_FILE)
    return port, ref


def test_load_ltxv_model_equal_jax_weights(loaded):
    port, ref = loaded
    stats = port.load_stats
    assert stats["transformer_reader"] in ("native mmap", "python")
    assert stats["lora_layers"] == 10 * TF_KW["num_layers"]
    assert port.t5 is None          # no text-encoder file: hash embeddings
    gen, jgen = port.generator, ref.generator
    assert gen.pipeline_config == jorch.LTXVideoGenerator(
        jgen.pipeline, pipeline_config="ltxv-13b-0.9.7-distilled"
    ).pipeline_config
    assert gen.multiscale is not None and jgen.multiscale is not None
    jdit = from_jax.state_dict(jax.tree.map(
        np.asarray, jgen.pipeline.transformer_params))
    pdit = gen.pipeline.transformer.state_dict()
    assert sorted(jdit) == sorted(pdit)
    for k in jdit:
        want = jdit[k].float()
        # JAX keeps the adaLN MLP in fp32; the port's bf16 policy rounds it
        rtol = 2.0 ** -8 if k.startswith("adaln.") else 0.0
        torch.testing.assert_close(pdit[k].float(), want, rtol=rtol, atol=0.0,
                                   msg=k)
    jv = from_jax.vae_state_dict(jax.tree.map(np.asarray,
                                              jgen.pipeline.vae_params))
    pv = gen.pipeline.vae.state_dict()
    assert sorted(jv) == sorted(pv)
    for k in jv:
        assert _same(jv[k].float(), pv[k].float()), k
    ju = from_jax.upsampler_state_dict(jax.tree.map(
        np.asarray, jgen.multiscale.upsampler_params))
    pu = gen.multiscale.upsampler.state_dict()
    for k in ju:
        assert torch.equal(pu[k].float(), ju[k].float()), k


def test_load_ltxv_model_generates_like_jax(loaded, monkeypatch,
                                            identity_crf):
    """The loaded stacks generate a 64x64x9 image-to-video request (the
    distilled multi-scale config, 7 + 3 steps) with the same injected
    noise, both in the plain fp32 attention tier: >= 40 dB."""
    port, ref = loaded
    monkeypatch.setattr(jattn, "_FORCED_MODE", "xla")
    rng = np.random.default_rng(4)
    h = w = 64
    image = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    n1 = rng.standard_normal((1, 5 * 12 * 12, 16)).astype(np.float32)
    n2 = rng.standard_normal((1, 5 * 24 * 24, 16)).astype(np.float32)
    emb = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    jgen = ref.generator
    jms = slice13b._NoiseMultiScale(jgen.pipeline,
                                    jgen.multiscale.upsampler_params,
                                    jgen.multiscale.upsampler_cfg)
    slice13b._NoiseMultiScale.noise = (n1, n2)
    cfg = dict(slice13b.CONFIG, downscale_factor=0.75)
    ref_frames = np.asarray(jorch.LTXVideoGenerator(
        jgen.pipeline, multiscale=jms, pipeline_config=cfg).generate(
        jnp.asarray(emb), jnp.asarray(mask), height=h, width=w, frame_num=9,
        seed=0, image_start=image, image_cond_noise_scale=0.0))
    gen = port.generator
    gen.pipeline_config = cfg
    frames = gen.generate(
        torch.from_numpy(emb), torch.from_numpy(mask), height=h, width=w,
        frame_num=9, seed=0, image_start=image, image_cond_noise_scale=0.0,
        noise_pass1=torch.from_numpy(n1), noise_pass2=torch.from_numpy(n2),
        attn_mode="xla")
    assert frames.shape == ref_frames.shape == (9, h, w, 3)
    assert frames.std() > 1.0
    db = slice13b._psnr(ref_frames.astype(np.float32) / 127.5 - 1,
                        frames.astype(np.float32) / 127.5 - 1)
    assert db >= PSNR_BAR_DB, f"frames {db:.2f} dB"



def test_cli_without_demo_on_the_checkpoint_dir(ckpt_dir, tmp_path):
    """The CLI's real branch: the distilled LoRA convention loaded from
    ``--ckpt-dir``, ``--save-quantized`` (the file JAX would write for the
    same weights) and ``--quantize-transformer``, an image-to-video
    request, the mp4 read back."""
    from PIL import Image

    png = tmp_path / "start.png"
    Image.fromarray(np.random.default_rng(5).integers(
        0, 255, (64, 64, 3)).astype(np.uint8)).save(png)
    out = tmp_path / "out.mp4"
    before = set(os.listdir(ckpt_dir))
    tcli.main(["--prompt", "a red fox", "--model-mode", "ltxv_13B_distilled",
               "--ckpt-dir", ckpt_dir, "--device", "cpu", "--height", "64",
               "--width", "64", "--video-length", "9", "--image-start",
               str(png), "--quantize-transformer", "--save-quantized",
               "--output-path", str(out)])
    assert tmedia.load_video(str(out)).shape == (9, 64, 64, 3)
    saved = os.path.join(ckpt_dir,
                         "ltxv_13B_distilled_quanto_bf16_int8.safetensors")
    assert set(os.listdir(ckpt_dir)) - before == {os.path.basename(saved)}
    pt, _ = tckpt.load_safetensors(saved)
    os.remove(saved)
    jp = jzoo.load_ltxv_model(LORA_FILE, "ltxv_13B_distilled", ckpt_dir,
                              TE_FILE).generator.pipeline.transformer_params
    # in fp32: JAX quantizes no bf16 kernel (test_save_quantized_model...)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jpath = jckpt.save_quantized_model(str(tmp_path / "jax"), jp)
    jt, _ = jckpt.load_safetensors(jpath)
    assert sorted(pt) == sorted(jt)
    for k in jt:
        if k.endswith("._data"):
            # the same codes but where a bf16 weight rounds the other way
            # (the port's adaLN MLP is bf16, JAX's fp32)
            assert (np.abs(_np(pt[k]).astype(int) - _jnp(jt[k]).astype(int))
                    <= 1).all(), k


def test_legacy_vae_raises_naming_its_step(tmp_path, ckpt_dir):
    import shutil

    root = tmp_path / "legacy"
    shutil.copytree(ckpt_dir, root)
    vae, config = tckpt.load_safetensors(str(root / sc.VAE_FILE))
    vae["encoder.mid_block.res_blocks.0.conv1.weight"] = torch.zeros(1)
    tckpt.save_safetensors(str(root / sc.VAE_FILE), vae, config)
    with pytest.raises(NotImplementedError, match="step 14"):
        tzoo.load_ltxv_model(LORA_FILE, "ltxv_13B_distilled", str(root),
                             device="cpu")


def test_new_modules_import_with_jax_blocked():
    """Every module of this slice imports in an interpreter where jax and
    the JAX package cannot be imported at all."""
    modules = ["core.checkpoint", "core.lora", "core.diffusers_compat",
               "pipelines.teacache", "pipelines.ltx_pipeline",
               "utils.native_codec", "utils.media", "runtime.native_loader",
               "serving.downloads", "serving.model_zoo", "serving.cli",
               "serving.server", "tools.synthetic_ckpt",
               "ops.flash_attention", "ops.attention"]
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name == 'jax' or name.startswith('jax.') or "
        "name == 'ltx_video_gpupoor_tpu' or "
        "name.startswith('ltx_video_gpupoor_tpu.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('ltx_video_gpupoor_tpu_torch.' + m)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
