"""Flow-matching DPM-Solver++ multistep (order <= 2).

Port of ``ltx_video_gpupoor_tpu/schedulers/dpm.py``: ``get_sampling_sigmas``,
``dpm_sigmas_from_custom``, ``DPMState``, ``dpm_init`` and ``dpm_step``
with the Wan defaults (``dpmsolver++``, midpoint, order 2, flow
prediction, ``lower_order_final``). The step index is a Python int here
(the loop runs on the host), so JAX's ``jnp.where`` order masks become
branches; the coefficients are fp32 0-dim tensors computed as JAX
computes them.

Flow parametrization as UniPC's: ``alpha = 1 - sigma``, ``x0 = sample -
sigma * velocity``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """Uniform sigmas from 1 with the flux shift, ``[steps]`` fp32."""
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return (shift * sigma / (1 + (shift - 1) * sigma)).astype(np.float32)


def dpm_sigmas_from_custom(sigmas: np.ndarray) -> torch.Tensor:
    """Append the terminal zero sigma: ``[steps]`` -> ``[steps + 1]``."""
    return torch.from_numpy(np.concatenate(
        [np.asarray(sigmas, np.float32), [0.0]]).astype(np.float32))


class DPMState(NamedTuple):
    m_prev: torch.Tensor       # x0 prediction at step i-1
    lower_order_nums: int


def dpm_init(sample_shape, dtype=torch.float32, device=None) -> DPMState:
    return DPMState(torch.zeros(sample_shape, dtype=dtype, device=device), 0)


def _lam(sigma: torch.Tensor) -> torch.Tensor:
    return torch.log1p(-sigma) - torch.log(torch.clamp(sigma, min=1e-8))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


def dpm_step(state: DPMState, model_output: torch.Tensor,
             sample: torch.Tensor, step_index: int, sigmas: torch.Tensor,
             num_steps: int, order: int = 2
             ) -> tuple[DPMState, torch.Tensor]:
    """One step; returns the new state and the next sample in the
    sample's dtype. The second-order midpoint update runs from the second
    step to the second-to-last; the last step is first order
    (``lower_order_final``)."""
    i = step_index
    x = sample.float()
    v = model_output.float()
    sigmas = sigmas.to(device=x.device, dtype=torch.float32)
    sigma_cur, sigma_next = sigmas[i], sigmas[i + 1]
    sigma_prev = sigmas[max(i - 1, 0)]

    m0 = x - sigma_cur * v                      # x0 prediction
    a_t = 1 - sigma_next
    h = _lam(sigma_next) - _lam(sigma_cur)
    x1 = sigma_next / torch.clamp(sigma_cur, min=1e-8) * x \
        - a_t * torch.expm1(-h) * m0
    this_order = min(order, num_steps - i, state.lower_order_nums + 1)
    if this_order >= 2:
        h_0 = _lam(sigma_cur) - _lam(sigma_prev)
        r0 = h_0 / _nonzero(h)
        d1 = (m0 - state.m_prev) / _nonzero(r0)
        prev_sample = x1 - 0.5 * a_t * torch.expm1(-h) * d1
    else:
        prev_sample = x1
    new_state = DPMState(m_prev=m0, lower_order_nums=min(
        state.lower_order_nums + 1, order))
    return new_state, prev_sample.to(sample.dtype)
