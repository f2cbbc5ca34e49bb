"""Flow-matching UniPC multistep solver (predictor-corrector).

Port of ``ltx_video_gpupoor_tpu/schedulers/unipc.py:27-162``:
``unipc_sigmas``, ``UniPCState``, ``unipc_init`` and ``unipc_step``, with
the Wan defaults (``solver_order=2``, flow prediction, ``bh2``,
``lower_order_final``). The step index is a Python int here (the loop
runs on the host), so JAX's ``jnp.where`` order masks become branches;
the coefficients are fp32 0-dim tensors computed as JAX computes them.

Flow parametrization: ``alpha_t = 1 - sigma``, ``sigma_t = sigma``,
``x0 = sample - sigma * velocity``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def unipc_sigmas(num_steps: int, shift: float = 1.0,
                 num_train_timesteps: int = 1000,
                 final_sigma_zero: bool = True) -> torch.Tensor:
    """``[steps + 1]`` fp32: linspace from ``1 - 1/num_train`` to 0 with
    the flux-style shift, terminal sigma appended."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sigma_max, 0.0, num_steps + 1)[:-1]
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    last = 0.0 if final_sigma_zero else 1.0 / num_train_timesteps
    return torch.from_numpy(
        np.concatenate([sigmas, [last]]).astype(np.float32))


class UniPCState(NamedTuple):
    m_prev: torch.Tensor       # x0 prediction at step i-1
    m_prev2: torch.Tensor      # x0 prediction at step i-2
    last_sample: torch.Tensor  # sample before the last predictor
    lower_order_nums: int


def unipc_init(sample_shape, dtype=torch.float32, device=None) -> UniPCState:
    z = torch.zeros(sample_shape, dtype=dtype, device=device)
    return UniPCState(z, z, z, 0)


def _lam(sigma: torch.Tensor) -> torch.Tensor:
    return torch.log1p(-sigma) - torch.log(torch.clamp(sigma, min=1e-8))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


def unipc_step(state: UniPCState, model_output: torch.Tensor,
               sample: torch.Tensor, step_index: int, sigmas: torch.Tensor,
               num_steps: int, order: int = 2,
               use_corrector: bool = True) -> tuple[UniPCState, torch.Tensor]:
    """One UniPC step: the corrector for the previous step, then the
    predictor. Returns the new state and the next sample in the
    sample's dtype."""
    i = step_index
    x = sample.float()
    v = model_output.float()
    sigmas = sigmas.to(device=x.device, dtype=torch.float32)
    sigma_cur, sigma_next = sigmas[i], sigmas[i + 1]
    sigma_prev, sigma_prev2 = sigmas[max(i - 1, 0)], sigmas[max(i - 2, 0)]

    m_t = x - sigma_cur * v                  # flow velocity -> x0
    this_order_p = min(order, num_steps - i, state.lower_order_nums + 1)

    if use_corrector and order >= 1 and i > 0:
        # UniC at the transition sigma_prev -> sigma_cur; the stored x0
        # prediction (m_t) stays the uncorrected one
        s_t, s_s0 = sigma_cur, sigma_prev
        a_t = 1 - s_t
        h = _lam(s_t) - _lam(s_s0)
        hh = -h
        h_phi_1 = torch.expm1(hh)
        b_h = torch.expm1(hh)  # bh2
        m0 = state.m_prev
        d1_t = m_t - m0
        prev_order = max(min(order, num_steps - (i - 1),
                             state.lower_order_nums), 1)
        x_t_ = s_t / torch.clamp(s_s0, min=1e-8) * state.last_sample \
            - a_t * h_phi_1 * m0
        if prev_order >= 2:
            r0 = (_lam(sigma_prev2) - _lam(s_s0)) / _nonzero(h)
            d1_0 = (state.m_prev2 - m0) / _nonzero(r0)
            h_phi_k1 = h_phi_1 / hh - 1
            b1 = h_phi_k1 * 1 / b_h
            h_phi_k2 = h_phi_k1 / hh - 0.5
            b2 = h_phi_k2 * 2 / b_h
            det = 1 - r0
            det = torch.where(det.abs() < 1e-8, torch.full_like(det, 1e-8),
                              det)
            rho1 = (b1 - b2) / det
            rho2 = (b2 - r0 * b1) / det
            x = x_t_ - a_t * b_h * (rho1 * d1_0 + rho2 * d1_t)
        else:
            x = x_t_ - a_t * b_h * 0.5 * d1_t

    # UniP
    s_t, s_s0 = sigma_next, sigma_cur
    a_t = 1 - s_t
    h = _lam(s_t) - _lam(s_s0)
    hh = -h
    h_phi_1 = torch.expm1(hh)
    b_h = torch.expm1(hh)  # bh2
    x_t_ = s_t / torch.clamp(s_s0, min=1e-8) * x - a_t * h_phi_1 * m_t
    if this_order_p >= 2:
        r0 = (_lam(sigma_prev) - _lam(s_s0)) / _nonzero(h)
        d1_0 = (state.m_prev - m_t) / _nonzero(r0)
        prev_sample = x_t_ - a_t * b_h * 0.5 * d1_0
    else:
        prev_sample = x_t_

    new_state = UniPCState(m_prev=m_t, m_prev2=state.m_prev, last_sample=x,
                           lower_order_nums=min(state.lower_order_nums + 1,
                                                order))
    return new_state, prev_sample.to(sample.dtype)
