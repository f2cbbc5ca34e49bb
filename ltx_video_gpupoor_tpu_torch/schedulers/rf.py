"""Rectified-flow Euler scheduler with per-token timesteps.

Port of ``ltx_video_gpupoor_tpu/schedulers/rf.py``: the Uniform,
LinearQuadratic and Constant (with its ``shift``) initial schedules, the
SD3 and SimpleDiffusion resolution-dependent shifts, :func:`make_schedule`
(:126), :func:`lower_timestep` and :func:`step` (:176) with scalar or
per-token timesteps and stochastic resampling, and :func:`add_noise`.

Schedules are float32 tensors on the CPU (they are host-side metadata);
``step`` runs on the sample's device. Stochastic sampling draws its noise
from an explicit ``torch.Generator`` or takes it as ``noise=``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

T_EPS = 1e-6


def linear_quadratic_schedule(num_steps: int, threshold_noise: float = 0.025,
                              linear_steps: Optional[int] = None
                              ) -> torch.Tensor:
    if num_steps == 1:
        return torch.tensor([1.0], dtype=torch.float32)
    if linear_steps is None:
        linear_steps = num_steps // 2
    linear = [i * threshold_noise / linear_steps for i in range(linear_steps)]
    diff = linear_steps - threshold_noise * num_steps
    quadratic_steps = num_steps - linear_steps
    a = diff / (linear_steps * quadratic_steps ** 2)
    b = threshold_noise / linear_steps - 2 * diff / (quadratic_steps ** 2)
    c = a * linear_steps ** 2
    quad = [a * i ** 2 + b * i + c for i in range(linear_steps, num_steps)]
    return torch.tensor([1.0 - x for x in (linear + quad)],
                        dtype=torch.float32)


def time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_normal_shift(n_tokens: int, min_tokens: int = 1024,
                     max_tokens: int = 4096, min_shift: float = 0.95,
                     max_shift: float = 2.05) -> float:
    m = (max_shift - min_shift) / (max_tokens - min_tokens)
    b = min_shift - m * min_tokens
    return m * n_tokens + b


def stretch_shifts_to_terminal(shifts: torch.Tensor,
                               terminal: float = 0.1) -> torch.Tensor:
    if not (0.0 < terminal < 1.0):
        raise ValueError("terminal must be in (0, 1)")
    one_minus = 1 - shifts
    scale = one_minus[-1] / (1 - terminal)
    return 1 - one_minus / scale


def sd3_resolution_dependent_shift(
    n_media_tokens: int, timesteps: torch.Tensor,
    target_shift_terminal: Optional[float] = None,
) -> torch.Tensor:
    shifted = time_shift(get_normal_shift(n_media_tokens), 1.0, timesteps)
    if target_shift_terminal is not None:
        shifted = stretch_shifts_to_terminal(shifted, target_shift_terminal)
    return shifted


def simple_diffusion_resolution_dependent_shift(
    n_media_tokens: int, timesteps: torch.Tensor, base_tokens: int = 32 * 32,
) -> torch.Tensor:
    snr = (timesteps / (1 - timesteps)) ** 2
    shift_snr = torch.log(snr) + 2 * math.log(n_media_tokens / base_tokens)
    return torch.sigmoid(0.5 * shift_snr)


@dataclasses.dataclass(frozen=True)
class RectifiedFlowSchedule:
    """Frozen sampling schedule; ``timesteps`` descend from ~1 toward 0."""

    timesteps: torch.Tensor  # [steps] fp32


def initial_timesteps(num_steps: int, sampler: str = "Uniform",
                      shift: Optional[float] = None) -> torch.Tensor:
    """``get_initial_timesteps``: ``Constant`` is the Uniform grid under
    :func:`time_shift` by ``shift``, which it requires."""
    if sampler == "Uniform":
        return torch.linspace(1.0, 1.0 / num_steps, num_steps,
                              dtype=torch.float32)
    if sampler == "LinearQuadratic":
        return linear_quadratic_schedule(num_steps)
    if sampler == "Constant":
        if shift is None:
            raise ValueError("the Constant sampler requires a shift")
        return time_shift(shift, 1.0, torch.linspace(
            1.0, 1.0 / num_steps, num_steps, dtype=torch.float32)).float()
    raise ValueError(f"unknown sampler {sampler!r}")


def make_schedule(
    num_steps: Optional[int] = None,
    *,
    sampler: str = "Uniform",
    shift: Optional[float] = None,
    shifting: Optional[str] = None,
    n_media_tokens: Optional[int] = None,
    target_shift_terminal: Optional[float] = None,
    base_resolution: int = 32 * 32,
    timesteps=None,
    num_train_timesteps: int = 1000,
) -> RectifiedFlowSchedule:
    """An explicit timestep list, or a sampled schedule with optional
    resolution-dependent shifting."""
    if timesteps is not None:
        ts = torch.as_tensor(timesteps, dtype=torch.float32).cpu()
    else:
        num_steps = min(num_train_timesteps, num_steps)
        ts = initial_timesteps(num_steps, sampler, shift)
        if shifting == "SD3":
            ts = sd3_resolution_dependent_shift(n_media_tokens, ts,
                                                target_shift_terminal)
        elif shifting == "SimpleDiffusion":
            ts = simple_diffusion_resolution_dependent_shift(
                n_media_tokens, ts, base_resolution)
        elif shifting not in (None, "", "None"):
            raise ValueError(f"unknown shifting {shifting!r}")
    return RectifiedFlowSchedule(timesteps=ts.float())


def lower_timestep(schedule_ts: torch.Tensor,
                   timestep: torch.Tensor) -> torch.Tensor:
    """Closest schedule timestep strictly below ``timestep`` (0 if none),
    for scalar or per-token timesteps of any shape."""
    ts = schedule_ts.to(device=timestep.device, dtype=timestep.dtype)
    padded = torch.cat([ts, ts.new_zeros(1)])
    padded = padded.reshape((-1,) + (1,) * timestep.dim())
    cand = torch.where(padded < (timestep - T_EPS), padded, 0.0)
    return cand.amax(dim=0)


def step(
    schedule: RectifiedFlowSchedule,
    model_output: torch.Tensor,
    timestep: torch.Tensor,
    sample: torch.Tensor,
    *,
    stochastic_sampling: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler step ``z_prev = z - dt * v`` with per-token ``dt``.

    ``timestep`` is scalar or ``[B, tokens]`` for ``sample [B, tokens, C]``.
    Stochastic sampling re-noises the predicted ``x0`` to the next
    timestep with ``noise`` or, if that is None, with noise drawn from
    ``generator``."""
    timestep = torch.as_tensor(timestep, dtype=torch.float32,
                               device=sample.device)
    lower = lower_timestep(schedule.timesteps, timestep)
    dt = timestep - lower
    t_full = timestep
    if dt.dim() and dt.dim() < sample.dim():
        dt = dt.unsqueeze(-1)
        t_full = timestep.unsqueeze(-1)
    if stochastic_sampling:
        x0 = sample - t_full * model_output
        next_t = t_full - dt
        if noise is None:
            if generator is None:
                raise ValueError("stochastic sampling needs a generator "
                                 "or noise")
            noise = torch.randn(sample.shape, generator=generator,
                                device=sample.device, dtype=sample.dtype)
        return add_noise(x0, noise, next_t).to(sample.dtype)
    return (sample - dt * model_output).to(sample.dtype)


def add_noise(original: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """``z_t = (1 - t) x0 + t eps``."""
    t = torch.as_tensor(timesteps, device=original.device)
    while t.dim() < original.dim():
        t = t.unsqueeze(-1)
    return (1 - t) * original + t * noise
