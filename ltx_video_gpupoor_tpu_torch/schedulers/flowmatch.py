"""Flow-match Euler schedule (DiffSynth style).

Port of ``ltx_video_gpupoor_tpu/schedulers/flowmatch.py``:
``FlowMatchSchedule`` and ``make_flowmatch_schedule``, the shift-warped
linear sigmas of the Wan pipeline's Euler solver. Its ``step`` and
``add_noise`` have no caller in either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: torch.Tensor       # [steps] fp32
    timesteps: torch.Tensor    # [steps] = sigmas * num_train_timesteps
    num_train_timesteps: int = 1000


def make_flowmatch_schedule(
    num_inference_steps: int,
    shift: float = 5.0,
    sigma_max: float = 1.0,
    sigma_min: float = 0.003 / 1.002,
    num_train_timesteps: int = 1000,
    denoising_strength: float = 1.0,
    extra_one_step: bool = True,
) -> FlowMatchSchedule:
    start = sigma_min + (sigma_max - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(start, sigma_min, num_inference_steps + 1)[:-1]
    else:
        sigmas = np.linspace(start, sigma_min, num_inference_steps)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    sigmas = torch.from_numpy(sigmas.astype(np.float32))
    return FlowMatchSchedule(sigmas=sigmas,
                             timesteps=sigmas * num_train_timesteps,
                             num_train_timesteps=num_train_timesteps)
