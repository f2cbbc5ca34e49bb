"""Dtype policy.

Port of ``ltx_video_gpupoor_tpu/core/dtypes.py`` (``DtypePolicy``):
params and activations in bfloat16; norms, adaLN modulation, timestep
embeddings and softmax statistics always in float32 (the ops compute
those in fp32 whatever the policy, so they need no field here).
``FP32_POLICY`` runs on the card too: its attention takes K1f, the fp32
kernel (``ops/flash_attention.py``), its int8 linears K2 on fp32
activations. (JAX's ``policy_for`` is not ported: neither CLI reads it.)

One difference from the JAX package: its pipelines hand the DiT float32
latents, so its activations follow the latent dtype. The port casts the
DiT and VAE inputs to ``compute_dtype`` instead, so that on the card the
attention and int8 kernels see bfloat16 operands. Under ``FP32_POLICY``
the two are the same program; ``tests/test_torch_pipeline.py`` holds the
``DEFAULT_POLICY`` slice against the JAX package's fp32 activations at
the same 40 dB bar as the fp32 one.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """What dtype each class of tensor uses.

    Attributes:
      param_dtype: storage dtype for the weight matrices.
      compute_dtype: dtype the DiT and VAE activations run in.
    """

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT_POLICY = DtypePolicy()
FP32_POLICY = DtypePolicy(param_dtype=torch.float32,
                          compute_dtype=torch.float32)

