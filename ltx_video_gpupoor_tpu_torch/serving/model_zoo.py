"""Model catalogue: which files a model mode names, the loader that
assembles the LTX stack from them, and the demo model.

Port of ``ltx_video_gpupoor_tpu/serving/model_zoo.py``:
``get_model_filename`` (:130), ``get_text_encoder_filename`` (:156) and
``select_model_files`` (:162), pure string logic (pinned equal to JAX's
by ``tests/test_torch_serving.py``); ``LoadedModel`` (:173), the holder
whose ``generator`` the server and the CLI use; ``_maybe`` (:178);
``load_ltxv_model`` (:199-383), which builds the LTX stack from
safetensors files in the published layout under a checkpoint directory
(the native mmap reader first, then the Python one; the LoRA-distilled
convention; the VAE file or a combined file; T5 where its file is there,
else JAX's warning and the hash embeddings; the spatial upscaler ->
``MultiScalePipeline``); ``convert_latent_upsampler`` (:384);
``load_wan_model`` (:433), which builds a ``WanPipeline`` (t2v or i2v,
with UMT5 and the CLIP vision tower where named) the same way; and
``build_demo_model`` (:594), the tiny random-weight stack that exercises
the whole serving surface. Weights go to the card unless ``device="cpu"``.
``apply_serving_mesh`` and ``apply_wan_serving_mesh`` (:36-80, :530-591)
engage several ranks where ``LTXV_TPU_MESH`` names a mesh (under
``torchrun``): the DiT (and T5) cut over ``tp``, ``sp_mesh`` set where sp >
1, the whole mesh for the tiled decode; the server and the CLI apply them
after loading (and after any quantization, so that per-channel scales are
those of the whole weights).
A legacy (pre-causal) VAE file loads into ``models/ltx/video_autoencoder.
LegacyVAE`` (JAX :290-304, the same detection rule); the finetune
registry (``register_finetune``, :123) is not ported. The tokenizer files
are not in the repository: as in JAX, no tokenizer is loaded, so prompts
take the hash embeddings (``serving/cli.py::encode_or_hash``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import torch

from ..core import checkpoint as ckpt
from ..core.dtypes import DEFAULT_POLICY, DtypePolicy
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


def apply_serving_mesh(pipeline: LTXPipeline, mesh=None) -> LTXPipeline:
    """Engage multi-rank serving when ``mesh`` (or ``LTXV_TPU_MESH``, e.g.
    ``dp1,sp2,tp1`` under ``torchrun``) names one: the DiT and T5 weights
    are cut in place over ``tp`` (``parallel/sharding.py``), ``sp > 1``
    runs every denoiser evaluation under USP, and the tiled decode spreads
    over every rank. One rank / unset returns the pipeline unchanged. The
    pipeline is changed in place (a multi-scale pipeline holding it sees
    the mesh too) and returned."""
    from ..core.mesh import SEQUENCE_AXIS, TENSOR_AXIS, axis_size, \
        mesh_from_env, mesh_shape
    from ..parallel.sharding import shard_pipeline

    mesh = mesh if mesh is not None else mesh_from_env()
    if mesh is None:
        return pipeline
    logging.getLogger(__name__).info("serving mesh engaged: %s",
                                     mesh_shape(mesh))
    shard_pipeline(pipeline, mesh)
    if axis_size(mesh, TENSOR_AXIS) > 1 and os.environ.get(
            "LTXV_TPU_FUSED_PROLOGUE"):
        # K5 fuses the q/k/v products of the whole row; on tp-cut weights
        # it has no contract (JAX: no partitioning rule for the fused call)
        logging.getLogger(__name__).warning(
            "LTXV_TPU_FUSED_PROLOGUE disabled: no partitioning rule for "
            "the fused kernel on a tp-sharded mesh")
        os.environ.pop("LTXV_TPU_FUSED_PROLOGUE", None)
    if axis_size(mesh, SEQUENCE_AXIS) > 1:
        pipeline.sp_mesh = mesh
    return pipeline


def apply_wan_serving_mesh(pipeline, mesh=None):
    """The Wan pipeline's :func:`apply_serving_mesh`: sp > 1 runs USP with
    the weights whole on every rank (the Ulysses exchange regroups heads),
    tp > 1 cuts the DiT and UMT5 over ``tp``; either way the tiled decode
    spreads over every rank."""
    from ..core.mesh import SEQUENCE_AXIS, axis_size, mesh_from_env, \
        mesh_shape
    from ..parallel.sharding import shard_pipeline

    mesh = mesh if mesh is not None else mesh_from_env()
    if mesh is None:
        return pipeline
    logging.getLogger(__name__).info("wan serving mesh engaged: %s",
                                     mesh_shape(mesh))
    shard_pipeline(pipeline, mesh)
    if axis_size(mesh, SEQUENCE_AXIS) > 1:
        pipeline.sp_mesh = mesh
    return pipeline


@dataclasses.dataclass
class LoadedModel:
    generator: LTXVideoGenerator
    tokenizer: object = None
    # the text encoder, where its file was found (no tokenizer is loaded)
    t5: object = None
    # how the stack was loaded: the reader of each file, seconds by stage
    load_stats: dict = dataclasses.field(default_factory=dict)


def _score_bound_opt_in() -> Optional[float]:
    """Per-deployment opt-in for the bounded-score attention tier: env
    ``LTXV_TPU_SCORE_BOUND=<float>`` (JAX :86-95). Off by default."""
    raw = os.environ.get("LTXV_TPU_SCORE_BOUND", "").strip()
    if not raw or raw.lower() in ("0", "off", "none", "false"):
        return None
    return float(raw)


def _maybe(path: Optional[str], ckpt_dir: str) -> Optional[str]:
    """Resolve a checkpoint name against ``ckpt_dir``: its basename, its
    path below a ``ckpts/`` prefix (the download layout keeps the hub's
    subfolders), or the path itself; None where none is a file."""
    if not path:
        return None
    rel = path[len("ckpts/"):] if path.startswith("ckpts/") else path
    candidates = [
        os.path.join(ckpt_dir, os.path.basename(path)),
        os.path.join(ckpt_dir, rel),
        path,
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    return None


def _read(path: str, stats: dict, what: str, native: bool = False):
    """Read one safetensors file, timing it into ``stats``: with
    ``native`` through the native mmap reader where it builds and reads
    the file, else (or then) the Python reader; ``stats`` names the one
    that ran."""
    t0 = time.perf_counter()
    reader = "python"
    tensors = None
    if native:
        try:
            from ..runtime.native_loader import load_safetensors_native

            tensors, config = load_safetensors_native(path)
            reader = "native mmap"
        # no g++ (RuntimeError), an unreadable file (OSError), a dtype the
        # native reader does not know (KeyError): the Python reader says
        except (RuntimeError, OSError, KeyError, ValueError) as e:
            logging.getLogger(__name__).info(
                "native safetensors reader unavailable (%s)", e)
    if tensors is None:
        tensors, config = ckpt.load_safetensors(path)
    stats[f"{what}_reader"] = reader
    stats[f"{what}_read_s"] = time.perf_counter() - t0
    stats[f"{what}_bytes"] = os.path.getsize(path)
    return tensors, config


def load_ltxv_model(
    model_filename: str,
    model_mode: str = "ltxv_13B_distilled",
    ckpt_dir: str = "ckpts",
    text_encoder_filename: Optional[str] = None,
    upsampler_filename: Optional[str] = None,
    vae_filename: Optional[str] = None,
    *,
    t5_cfg=None,
    device=None,
    policy: DtypePolicy = DEFAULT_POLICY,
) -> LoadedModel:
    """Assemble the LTX stack from local safetensors files in the
    published layout (JAX :199-383), on the card unless ``device="cpu"``.
    A missing file raises ``FileNotFoundError`` naming it (nothing is
    downloaded). ``load_stats`` of the result names each file's reader
    and the seconds of each stage: read, dequantize, convert, to the
    device, LoRA merge."""
    from ..models import t5 as t5m

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_ltxv_model: no CUDA device (pass "
                           "device='cpu' for the CPU)")
    stats: dict = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # LoRA-only checkpoints (the distilled convention): the file named by
    # the policy is a LoRA, merged onto the dev int8 transformer as its
    # base; loading the LoRA file as a whole model would fail
    lora_filename = None
    if "lora" in os.path.basename(model_filename):
        lora_filename = model_filename
        model_filename = "ltxv_0.9.7_13B_dev_quanto_bf16_int8.safetensors"

    tf_path = _maybe(model_filename, ckpt_dir)
    if tf_path is None:
        raise FileNotFoundError(
            f"transformer checkpoint not found: {model_filename}; place it "
            f"under {ckpt_dir}/ (nothing is downloaded)")
    tensors, config = _read(tf_path, stats, "transformer", native=True)
    t0 = time.perf_counter()
    # the int8 codes go to the device and are folded there
    tensors = ckpt.dequantize_quanto(tensors, policy.param_dtype,
                                     consume=True, device=dev)
    sync()
    stats["to_device_dequantize_s"] = time.perf_counter() - t0
    tcfg_dict = config.get("transformer", config) if config else {}
    tcfg = tf.LTXTransformerConfig(
        num_attention_heads=tcfg_dict.get("num_attention_heads", 32),
        attention_head_dim=tcfg_dict.get("attention_head_dim", 64),
        in_channels=tcfg_dict.get("in_channels", 128),
        out_channels=tcfg_dict.get("out_channels", 128),
        num_layers=tcfg_dict.get("num_layers", 48),
        cross_attention_dim=tcfg_dict.get("cross_attention_dim", 4096),
        caption_channels=tcfg_dict.get("caption_channels", 4096),
        attention_score_bound=_score_bound_opt_in(),
    )
    t0 = time.perf_counter()
    sd = ckpt.convert_ltx_transformer(tensors, tcfg.num_layers,
                                      dtype=policy.param_dtype)
    dit = ckpt.build_module(
        tf.LTXTransformer3D(tcfg, policy, device="meta"), sd, "transformer",
        dev)
    sync()
    stats["convert_s"] = time.perf_counter() - t0
    combined = tensors    # a combined file also holds the VAE
    del sd

    if lora_filename is not None:
        lora_path = _maybe(lora_filename, ckpt_dir)
        if lora_path is None:
            raise FileNotFoundError(
                f"LoRA checkpoint not found: {lora_filename}; place it "
                f"under {ckpt_dir}/")
        from ..core.lora import merge_lora

        lora_sd, _ = _read(lora_path, stats, "lora")
        t0 = time.perf_counter()
        _, n = merge_lora(dit.state_dict(), lora_sd, multiplier=1.0)
        sync()
        stats["lora_merge_s"] = time.perf_counter() - t0
        stats["lora_layers"] = n
        if n == 0:
            raise ValueError(f"no LoRA layers matched from {lora_path}")
        del lora_sd

    # the VAE ships as its own file; the transformer file is taken only
    # as a combined single-file checkpoint; an explicit missing name raises
    if vae_filename is None:
        vae_path = _maybe("ltxv_0.9.7_VAE.safetensors", ckpt_dir) or tf_path
    else:
        vae_path = _maybe(vae_filename, ckpt_dir)
        if vae_path is None:
            raise FileNotFoundError(
                f"VAE checkpoint not found: {vae_filename} under {ckpt_dir}/")
    if vae_path == tf_path:
        vae_tensors, vae_config = combined, config
    else:
        vae_tensors, vae_config = _read(vae_path, stats, "vae")
        vae_tensors = ckpt.dequantize_quanto(vae_tensors, torch.float32,
                                             consume=True)
    del combined, tensors
    vcfg_dict = vae_config.get("vae", vae_config) if vae_config else \
        ltx_vae.LTX_VAE_CONFIG_097
    from ..core.diffusers_compat import maybe_translate_config

    vcfg_dict = maybe_translate_config(vcfg_dict)
    t0 = time.perf_counter()
    if ckpt.is_legacy_vae(vcfg_dict, vae_tensors):
        # the pre-causal 2B-era VAE (``video_autoencoder.py`` naming);
        # without latent statistics in the file they are the identity, as
        # JAX skips the (un)normalization then
        from ..models.ltx import video_autoencoder as legacy_vae

        lvcfg = legacy_vae.LegacyVAEConfig.from_dict(vcfg_dict)
        sd = ckpt.convert_legacy_vae(vae_tensors, lvcfg)
        c = lvcfg.latent_channels
        sd.setdefault("per_channel_statistics.std_of_means", torch.ones(c))
        sd.setdefault("per_channel_statistics.mean_of_means", torch.zeros(c))
        vae = ckpt.build_module(
            legacy_vae.LegacyVAE(lvcfg, policy, device="meta"), sd, "VAE",
            dev)
    else:
        vcfg = ltx_vae.VAEConfig.from_dict(vcfg_dict)
        vae = ckpt.build_module(
            ltx_vae.CausalVAE(vcfg, policy, device="meta"),
            ckpt.convert_ltx_vae(vae_tensors, vcfg), "VAE", dev)
    sync()
    stats["vae_to_device_s"] = time.perf_counter() - t0
    del vae_tensors

    t5 = None
    te_path = _maybe(text_encoder_filename, ckpt_dir)
    if te_path:
        te_tensors, _ = _read(te_path, stats, "text_encoder")
        te_tensors = ckpt.dequantize_quanto(te_tensors, torch.bfloat16,
                                            consume=True)
        t5_cfg = t5_cfg or t5m.T5_XXL
        t5 = ckpt.build_module(
            t5m.T5Encoder(t5_cfg, device="meta", dtype=torch.bfloat16),
            ckpt.convert_t5_encoder(te_tensors, t5_cfg.num_layers,
                                    t5_cfg.shared_pos), "text encoder", dev)
        del te_tensors
    elif text_encoder_filename:
        logging.getLogger(__name__).warning(
            "text encoder checkpoint %s not found under %s: prompt "
            "encoding will use the hash-embedding fallback (demo quality, "
            "NOT production)", text_encoder_filename, ckpt_dir)

    pipeline = LTXPipeline(dit, vae)
    multiscale = None
    # the download layout names the upscaler by its hub name; older docs
    # used the dashed LTXV name: both are accepted
    up_candidates = ([upsampler_filename] if upsampler_filename else []) + [
        "ltxv_0.9.7_spatial_upscaler.safetensors",
        "ltxv-spatial-upscaler-0.9.7.safetensors",
    ]
    up_path = next(
        (p for p in (_maybe(c, ckpt_dir) for c in up_candidates) if p), None)
    if up_path:
        up_tensors, up_cfg_dict = _read(up_path, stats, "upsampler")
        up_fields = {f.name for f in dataclasses.fields(
            lup.LatentUpsamplerConfig)}
        up_kwargs = {k: v for k, v in (up_cfg_dict or {}).items()
                     if k in up_fields}
        if "dims" not in up_kwargs:
            # the reference's from_config defaults to dims=2 (2-D convs):
            # infer from the kernel rank when the metadata does not say
            w = up_tensors.get("initial_conv.weight")
            if w is not None:
                up_kwargs["dims"] = 2 if w.dim() == 4 else 3
        up = ckpt.build_module(
            lup.LatentUpsampler(lup.LatentUpsamplerConfig(**up_kwargs),
                                policy, device="meta"),
            convert_latent_upsampler(up_tensors), "latent upsampler", dev)
        multiscale = MultiScalePipeline(pipeline, up)

    config_name = ("ltxv-13b-0.9.7-distilled" if "distilled" in model_mode
                   else "ltxv-13b-0.9.7-dev")
    return LoadedModel(
        generator=LTXVideoGenerator(pipeline=pipeline, multiscale=multiscale,
                                    pipeline_config=config_name),
        t5=t5, load_stats=stats)


def load_wan_model(
    model_filename: str,
    config_name: str = "t2v-1.3B",
    ckpt_dir: str = "ckpts",
    vae_filename: str = "Wan2.1_VAE.safetensors",
    text_encoder_filename: Optional[str] = None,
    clip_filename: Optional[str] = None,
    *,
    spec: Optional[dict] = None,
    vae_cfg=None,
    t5_cfg=None,
    clip_cfg=None,
    device=None,
    policy: DtypePolicy = DEFAULT_POLICY,
):
    """Assemble a ``WanPipeline`` from local safetensors files in the
    published layout (JAX :433-532), on the card unless ``device="cpu"``:
    the transformer (quanto int8 pairs moved to the device and folded
    there), the VAE (with its encoder for i2v), and, where named, UMT5 and
    the CLIP vision tower, which the pipeline carries for callers to run
    (``WanPipeline.t5`` / ``.clip``). ``spec`` / ``vae_cfg`` / ``t5_cfg``
    / ``clip_cfg`` override the catalogue configs. A missing file raises
    ``FileNotFoundError`` naming it (nothing is downloaded); the
    pipeline's ``load_stats`` names each file's reader and the seconds of
    each stage."""
    from ..configs import WAN_CONFIGS
    from ..models import t5 as t5m
    from ..models.wan import clip as wan_clip
    from ..models.wan import model as wan_model
    from ..models.wan import vae as wan_vae
    from ..pipelines.wan import WanPipeline

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_wan_model: no CUDA device (pass "
                           "device='cpu' for the CPU)")
    stats: dict = {}
    if spec is None:
        spec = WAN_CONFIGS[config_name]
    cfg = wan_model.WanConfig(
        model_type=spec["model_type"], dim=spec["dim"],
        ffn_dim=spec["ffn_dim"], freq_dim=spec["freq_dim"],
        num_heads=spec["num_heads"], num_layers=spec["num_layers"],
        in_dim=spec.get("in_dim", 16),
        attention_score_bound=_score_bound_opt_in())

    def need(name, what):
        path = _maybe(name, ckpt_dir)
        if path is None:
            raise FileNotFoundError(
                f"Wan {what} checkpoint not found: {name} (looked in "
                f"{ckpt_dir}/; nothing is downloaded)")
        return path

    tensors, _ = _read(need(model_filename, "transformer"), stats,
                       "transformer", native=True)
    t0 = time.perf_counter()
    tensors = ckpt.dequantize_quanto(tensors, policy.param_dtype,
                                     consume=True, device=dev)
    dit = ckpt.build_module(wan_model.WanModel(cfg, policy, device="meta"),
                            ckpt.convert_wan_model(tensors, cfg),
                            "transformer", dev)
    del tensors
    stats["transformer_to_device_s"] = time.perf_counter() - t0

    vae_cfg = vae_cfg if vae_cfg is not None else wan_vae.WanVAEConfig()
    vae_tensors, _ = _read(need(vae_filename, "VAE"), stats, "vae")
    sd = ckpt.convert_wan_vae(vae_tensors, vae_cfg)
    del vae_tensors
    if cfg.model_type == "i2v":   # i2v encodes its conditioning frames
        vae = wan_vae.WanVAE(vae_cfg, policy, device="meta")
    else:
        vae = wan_vae.WanVAEDecoder(vae_cfg, policy, device="meta")
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("encoder.", "conv1."))}
    vae = ckpt.build_module(vae, sd, "VAE", dev)

    t5 = clip = None
    if text_encoder_filename:
        te_tensors, _ = _read(need(text_encoder_filename, "text encoder"),
                              stats, "text_encoder")
        te_tensors = ckpt.dequantize_quanto(te_tensors, torch.bfloat16,
                                            consume=True)
        t5_cfg = t5_cfg if t5_cfg is not None else t5m.UMT5_XXL
        t5 = ckpt.build_module(
            t5m.T5Encoder(t5_cfg, device="meta", dtype=torch.bfloat16),
            ckpt.convert_t5_encoder(te_tensors, t5_cfg.num_layers,
                                    t5_cfg.shared_pos), "text encoder", dev)
        del te_tensors
    if clip_filename:
        clip_tensors, _ = _read(need(clip_filename, "CLIP"), stats, "clip")
        clip_cfg = clip_cfg if clip_cfg is not None \
            else wan_clip.CLIPVisionConfig()
        clip = ckpt.build_module(
            wan_clip.CLIPVision(clip_cfg, policy, device="meta"),
            ckpt.convert_clip_vision(clip_tensors, clip_cfg.num_layers),
            "CLIP", dev)
        del clip_tensors
    # LTXV_TPU_MESH (under torchrun) engages the ranks, as JAX's loader
    # does (:527)
    return apply_wan_serving_mesh(WanPipeline(
        dit, vae, vae_stride=tuple(spec["vae_stride"]), t5=t5, clip=clip,
        load_stats=stats))


def convert_latent_upsampler(sd: dict, dtype=torch.bfloat16) -> dict:
    """A latent-upsampler state dict (the reference's naming) -> the
    ``state_dict`` of ``models/ltx/latent_upsampler.LatentUpsampler``:
    convs in ``dtype``, group norms in fp32 (JAX :384-433)."""

    def conv(prefix):
        return {"weight": sd[prefix + ".weight"].to(dtype),
                "bias": sd[prefix + ".bias"].to(dtype)}

    def gn(prefix):
        return {"weight": sd[prefix + ".weight"].float(),
                "bias": sd[prefix + ".bias"].float()}

    def res(prefix):
        return {"conv1": conv(prefix + ".conv1"),
                "norm1": gn(prefix + ".norm1"),
                "conv2": conv(prefix + ".conv2"),
                "norm2": gn(prefix + ".norm2")}

    def count(prefix):
        n = 0
        while f"{prefix}.{n}.conv1.weight" in sd:
            n += 1
        return n

    return ckpt._flatten({
        "initial_conv": conv("initial_conv"),
        "initial_norm": gn("initial_norm"),
        "res_blocks": [res(f"res_blocks.{i}")
                       for i in range(count("res_blocks"))],
        "upsampler": conv("upsampler.0"),
        # counted independently: checkpoints may carry different pre/post
        # block counts
        "post_upsample_res_blocks": [
            res(f"post_upsample_res_blocks.{i}")
            for i in range(count("post_upsample_res_blocks"))],
        "final_conv": conv("final_conv"),
    })


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
