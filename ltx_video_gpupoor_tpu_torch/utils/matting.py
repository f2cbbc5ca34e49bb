"""Closed-form alpha matting (Levin, Lischinski, Weiss 2008) — the
edge-refinement step behind rembg's ``alpha_matting=True`` path.

A copy of ``ltx_video_gpupoor_tpu/utils/matting.py`` (numpy + scipy, no
JAX), kept in the port so that it imports nothing of the JAX package;
``tests/test_torch_aux_utils.py`` holds the two equal bit for bit.

Parity target: the reference's background removal calls
``rembg.remove(..., alpha_matting=True, alpha_matting_erode_size=1)``
(``wan/utils/utils.py:74-79``), which builds a trimap
from the U2-Net salience (foreground > 240/255, background < 10/255,
unknown in between) and solves the closed-form matting system over the
unknown band (pymatting ``estimate_alpha_cf``). This module implements
the same algorithm with numpy/scipy — host-side CPU work, exactly where
the reference runs it — so the native U2-Net path produces the same
refined matte without the rembg/pymatting packages.

The matting Laplacian uses 3x3 windows with the standard
``epsilon=1e-7`` regularizer; known pixels are clamped through the
``lambda=100`` data term and the sparse system is solved with
diagonal-preconditioned conjugate gradients.
"""

from __future__ import annotations

import numpy as np


def build_trimap(alpha: np.ndarray, fg_threshold: float = 240 / 255,
                 bg_threshold: float = 10 / 255,
                 erode_size: int = 1) -> np.ndarray:
    """Salience [H, W] in [0, 1] -> trimap (1 fg, 0 bg, 0.5 unknown),
    with the fg/bg regions eroded by ``erode_size`` (rembg's
    ``alpha_matting_erode_size``).

    Matches rembg's ``alpha_matting_cutout`` exactly: the structuring
    element is ``np.ones((erode_size, erode_size))`` (so erode_size=1 is
    the identity), and the background erosion uses ``border_value=1`` so
    border background pixels stay background rather than dropping into
    the unknown band."""
    from scipy import ndimage

    is_fg = alpha > fg_threshold
    is_bg = alpha < bg_threshold
    if erode_size > 1:
        structure = np.ones((erode_size, erode_size), bool)
        is_fg = ndimage.binary_erosion(is_fg, structure)
        is_bg = ndimage.binary_erosion(is_bg, structure, border_value=1)
    tri = np.full(alpha.shape, 0.5, np.float64)
    tri[is_fg] = 1.0
    tri[is_bg] = 0.0
    return tri


def _matting_laplacian(image: np.ndarray, eps: float = 1e-7):
    """Sparse matting Laplacian over 3x3 windows. ``image`` [H, W, 3]
    in [0, 1]. Returns ``scipy.sparse.csr_matrix`` [HW, HW]."""
    from scipy import sparse

    h, w, _ = image.shape
    n = h * w
    win = 3
    wn = win * win
    # indices of every full 3x3 window's pixels: [num_windows, 9]
    idx = np.arange(n).reshape(h, w)
    widx = np.lib.stride_tricks.sliding_window_view(
        idx, (win, win)).reshape(-1, wn)
    # window pixel colors: [num_windows, 9, 3]
    win_i = image.reshape(-1, 3)[widx]
    mu = win_i.mean(axis=1, keepdims=True)                  # [W, 1, 3]
    d = win_i - mu                                          # [W, 9, 3]
    cov = np.einsum("wpc,wpd->wcd", d, d) / wn              # [W, 3, 3]
    inv = np.linalg.inv(cov + (eps / wn) * np.eye(3))
    # G_ij = (1 + d_i^T inv d_j) / 9 ; L_window = I - G
    g = (1.0 + np.einsum("wpc,wcd,wqd->wpq", d, inv, d)) / wn
    vals = (np.eye(wn)[None] - g).reshape(-1)
    rows = np.repeat(widx, wn, axis=1).reshape(-1)
    cols = np.tile(widx, (1, wn)).reshape(-1)
    lap = sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return lap.tocsr()


def estimate_alpha_cf(image: np.ndarray, trimap: np.ndarray,
                      lam: float = 100.0, eps: float = 1e-7,
                      cg_tol: float = 1e-5,
                      cg_maxiter: int = 2000) -> np.ndarray:
    """Closed-form alpha over the trimap's unknown band. ``image``
    [H, W, 3] in [0, 1]; ``trimap`` [H, W] with 0 / 1 / 0.5-unknown.
    Returns alpha [H, W] in [0, 1]."""
    from scipy import sparse
    from scipy.sparse.linalg import LinearOperator, cg

    h, w = trimap.shape
    n = h * w
    known = (trimap < 0.1) | (trimap > 0.9)
    if known.all():
        return trimap.astype(np.float32)
    lap = _matting_laplacian(np.asarray(image, np.float64), eps)
    c = sparse.diags(known.reshape(-1).astype(np.float64) * lam)
    a = (lap + c).tocsr()
    b = lam * (trimap.reshape(-1) * known.reshape(-1))
    # diagonal-preconditioned CG (the standard pymatting configuration
    # is ichol-preconditioned CG; the diagonal preconditioner converges
    # a little slower but needs no factorization)
    diag = a.diagonal()
    diag[diag == 0] = 1.0
    m = LinearOperator(a.shape, matvec=lambda x: x / diag)
    x0 = trimap.reshape(-1).astype(np.float64)
    alpha, _info = cg(a, b, x0=x0, rtol=cg_tol, maxiter=cg_maxiter, M=m)
    return np.clip(alpha.reshape(h, w), 0.0, 1.0).astype(np.float32)


def refine_alpha(image: np.ndarray, alpha: np.ndarray,
                 erode_size: int = 1) -> np.ndarray:
    """Full rembg-style refinement: salience -> trimap -> closed-form
    alpha. ``image`` [H, W, 3] uint8; ``alpha`` [H, W] in [0, 1]."""
    tri = build_trimap(alpha, erode_size=erode_size)
    if not ((tri > 0.1) & (tri < 0.9)).any():
        return alpha.astype(np.float32)  # nothing unknown to solve
    return estimate_alpha_cf(np.asarray(image, np.float64) / 255.0, tri)
