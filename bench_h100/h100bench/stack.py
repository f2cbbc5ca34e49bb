"""The system under test, built from a configuration file and a seed.

The port's own modules (``ltx_video_gpupoor_tpu_torch``) are built empty
on the card and filled from :mod:`.weights`: the DiT one block at a time,
each block quantized into the configuration's tier as it is drawn (as
``chip_smoke.py::build_ltx13b_models`` builds the 13B), the VAE with its
encoder, and the latent upsampler where the pipeline is multi-scale. The
generator takes the configuration's own frozen pipeline config, and the
HTTP service (``serving/server.py::InferenceService``) wraps it, warming
the traffic's one shape.
"""

from __future__ import annotations

import copy
import dataclasses
import os

from . import weights

# what a served process runs with these variables unset: the attention
# tier `auto`, no fused prologue, no score bound, no mesh
TIER_ENV = ("LTXV_TPU_ATTN", "LTXV_TPU_FUSED_PROLOGUE", "LTXV_TPU_SCORE_BOUND",
            "LTXV_TPU_MESH", "LTXV_TPU_WARMUP")


def clear_tier_env(config: dict) -> None:
    """The environment of a server process in the configuration's tiers,
    set before the port is imported (it reads some of it then)."""
    if config["attention"] != "auto" or config.get("fused_prologue"):
        raise ValueError("only the served defaults are configured")
    for key in TIER_ENV:
        os.environ.pop(key, None)


def build_generator(config: dict, seed: int, device, quantization=None):
    """The port's ``LTXVideoGenerator`` with random weights from ``seed``;
    ``quantization`` overrides the configuration's tier (the control)."""
    import torch

    from ltx_video_gpupoor_tpu_torch.core.dtypes import DEFAULT_POLICY
    from ltx_video_gpupoor_tpu_torch.models.ltx import latent_upsampler as lup
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as tf
    from ltx_video_gpupoor_tpu_torch.models.ltx import vae as vaem
    from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
    from ltx_video_gpupoor_tpu_torch.pipelines.ltx_pipeline import LTXPipeline
    from ltx_video_gpupoor_tpu_torch.pipelines.multiscale import (
        MultiScalePipeline,
    )
    from ltx_video_gpupoor_tpu_torch.serving.orchestrator import (
        LTXVideoGenerator,
    )

    mode = quantization or config["quantization"]
    dev = torch.device(device)
    tcfg = tf.LTXTransformerConfig(**config["transformer"])
    dit = tf.LTXTransformer3D(dataclasses.replace(tcfg, num_layers=0),
                              DEFAULT_POLICY, device=dev)
    weights.fill(dit, seed, "dit.outer")
    dit.cfg = tcfg
    quantize_params(dit, mode=mode)
    kw = dict(device=dev, dtype=DEFAULT_POLICY.param_dtype)
    for i in range(tcfg.num_layers):
        blk = weights.fill(tf.Block(tcfg, **kw), seed, f"dit.block.{i}")
        dit.blocks.append(quantize_params(blk, mode=mode))
    vae = weights.fill(vaem.CausalVAE(vaem.VAEConfig.from_dict(config["vae"]),
                                      DEFAULT_POLICY, device=dev),
                       seed, "vae")
    pipe = LTXPipeline(dit, vae)
    multiscale = None
    if config["pipeline"].get("pipeline_type") == "multi-scale":
        up = weights.fill(lup.LatentUpsampler(
            lup.LatentUpsamplerConfig(**config["latent_upsampler"]),
            DEFAULT_POLICY, device=dev), seed, "upsampler")
        multiscale = MultiScalePipeline(pipe, up)
    return LTXVideoGenerator(pipe, multiscale=multiscale,
                             pipeline_config=copy.deepcopy(config["pipeline"]))


def build_service(gen, outputs_dir: str, warmup: str):
    """``InferenceService`` around ``gen``, its warm-up of ``warmup``
    (``WxHxF``) run to its end; raises unless the bucket completed."""
    from ltx_video_gpupoor_tpu_torch.serving import model_zoo, server
    from ltx_video_gpupoor_tpu_torch.utils.observability import Metrics

    Metrics.reset()
    service = server.InferenceService(
        model=model_zoo.LoadedModel(generator=gen), outputs_dir=outputs_dir,
        warmup_spec=warmup)
    if service._warmup_thread is not None:
        service._warmup_thread.join()
    counters = Metrics.snapshot()["counters"]
    if counters.get("warmup_ok") != 1 or counters.get("warmup_failed"):
        raise RuntimeError(f"the warm-up of {warmup} did not complete: "
                           f"{counters}")
    return service


def codec_route() -> str:
    """The conditioning image's CRF round trip the served path takes here:
    the reference follows the OpenCV JPEG route only."""
    from ltx_video_gpupoor_tpu_torch.utils import media, native_codec

    if native_codec.available():
        return "native h264"
    if media._ffmpeg() is not None:
        return "ffmpeg"
    return "opencv jpeg"
