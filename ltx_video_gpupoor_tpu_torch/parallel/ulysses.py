"""Ulysses sequence parallelism: the all-to-all head <-> sequence exchange.

Port of ``ltx_video_gpupoor_tpu/parallel/ulysses.py`` (:25-96). Each rank
of the ``sp`` axis holds ``[B, H, S/p, D]``; one ``all_to_all`` on the
axis's process group gives it ``[B, H/p, S, D]`` (its head group over the
whole sequence), the port's :func:`~..ops.attention.attention` runs there
(kernels K1, K3, K4 or K3q on ``H/p`` heads of the full sequence), and a
second exchange brings the result back to ``[B, H, S/p, D]``. The layout
is JAX's exactly: the received chunks come in rank order, before the local
sequence (or head) axis (``all_to_all(..., tiled=False)``).
"""

from __future__ import annotations

import torch

from ..core import mesh as _mesh
from ..ops.attention import attention
from . import comm


def _heads_to_seq(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """``[B, H, S/p, D]`` (local) -> ``[B, H/p, S, D]``."""
    b, h, s_local, d = x.shape
    # head group j goes to rank j; what arrives from rank j is its
    # sequence chunk, placed before the local sequence axis
    xs = x.reshape(b, p, h // p, s_local, d).transpose(0, 1)
    out = comm.all_to_all(xs, group)              # [p, B, H/p, S/p, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * s_local, d)


def _seq_to_heads(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """``[B, H/p, S, D]`` (local) -> ``[B, H, S/p, D]``."""
    b, h_local, s, d = x.shape
    xs = x.reshape(b, h_local, p, s // p, d).permute(2, 0, 1, 3, 4)
    out = comm.all_to_all(xs, group)              # [p, B, H/p, S/p, D]
    return out.transpose(0, 1).reshape(b, h_local * p, s // p, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", attn_mode: str = "auto",
                      score_bound: float | None = None,
                      mesh=None) -> torch.Tensor:
    """Sequence-parallel attention of one rank: q, k, v ``[B, H, S/p, D]``
    sequence-sharded over ``axis_name`` of ``mesh`` (default: the active
    mesh); the heads must divide over its size."""
    mesh = mesh if mesh is not None else _mesh.active_mesh()
    p = _mesh.axis_size(mesh, axis_name)
    if p == 1:
        return attention(q, k, v, mode=attn_mode, score_bound=score_bound)
    if q.shape[1] % p:
        raise ValueError(f"heads ({q.shape[1]}) must divide over "
                         f"{axis_name}={p}")
    group = _mesh.axis_group(mesh, axis_name)
    out = attention(_heads_to_seq(q, group, p), _heads_to_seq(k, group, p),
                    _heads_to_seq(v, group, p), mode=attn_mode,
                    score_bound=score_bound)
    return _seq_to_heads(out, group, p)


def shard_seq(x: torch.Tensor, mesh, axis_name: str, dim: int
              ) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim``."""
    p = _mesh.axis_size(mesh, axis_name)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"length {n} must divide over {axis_name}={p}")
    r = _mesh.axis_rank(mesh, axis_name)
    return x.narrow(dim, r * (n // p), n // p)


def ulysses_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, axis_name: str = "sp",
                              attn_mode: str = "auto",
                              score_bound: float | None = None
                              ) -> torch.Tensor:
    """Global ``[B, H, S, D]`` in (the same on every rank), global out:
    each rank cuts its sequence chunk, runs :func:`ulysses_attention` and
    the chunks are joined in rank order."""
    parts = [shard_seq(t, mesh, axis_name, 2) for t in (q, k, v)]
    out = ulysses_attention(*parts, axis_name=axis_name, attn_mode=attn_mode,
                            score_bound=score_bound, mesh=mesh)
    if _mesh.axis_size(mesh, axis_name) == 1:
        return out
    return comm.all_gather_cat(out, _mesh.axis_group(mesh, axis_name), 2)
