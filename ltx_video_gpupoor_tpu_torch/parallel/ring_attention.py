"""Ring attention: KV blocks pass rank to rank around the ``sp`` axis while
each rank accumulates its online-softmax partial result.

Port of ``ltx_video_gpupoor_tpu/parallel/ring_attention.py`` (:21-96).
JAX's ``ppermute`` becomes one ``batch_isend_irecv`` to the next rank a
rotation (``parallel/comm.py::ring_shift``): p blocks need p - 1
rotations, the last block consumed after the loop. The fp32 block
statistics and the merge are XLA einsums in JAX, not a Pallas kernel, so
they are ``torch.matmul`` here. No model path calls it, in either package
(the kernel that runs a ring in one launch is K7, ``parallel/ring_rdma.py``).
"""

from __future__ import annotations

import torch

from ..core import mesh as _mesh
from ..ops.flash_attention import NEG_INF
from . import comm
from .ulysses import shard_seq


def _local_attention_stats(q, k, v, scale):
    """(out_unnormalized, m, l) of one KV block, fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.float()), m, l


def _merge(m, l, acc, out, m_cur, l_cur):
    m_new = torch.maximum(m, m_cur)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_cur - m_new)
    return m_new, l * alpha + l_cur * beta, acc * alpha + out * beta


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", scale: float | None = None,
                   mesh=None) -> torch.Tensor:
    """Full (non-causal) attention of one rank with ring-passed KV: q, k,
    v ``[B, H, S/p, D]`` sequence-sharded over ``axis_name`` of ``mesh``
    (default: the active mesh)."""
    mesh = mesh if mesh is not None else _mesh.active_mesh()
    p = _mesh.axis_size(mesh, axis_name)
    group = _mesh.axis_group(mesh, axis_name) if p > 1 else None
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    b, h, s_local, _ = q.shape
    m = torch.full((b, h, s_local, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    k_blk, v_blk = k, v
    for _ in range(p - 1):
        out, m_cur, l_cur = _local_attention_stats(q, k_blk, v_blk, scale)
        m, l, acc = _merge(m, l, acc, out, m_cur, l_cur)
        k_blk, v_blk = comm.ring_shift([k_blk, v_blk], group)
    out, m_cur, l_cur = _local_attention_stats(q, k_blk, v_blk, scale)
    m, l, acc = _merge(m, l, acc, out, m_cur, l_cur)
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


def ring_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, axis_name: str = "sp",
                           scale: float | None = None) -> torch.Tensor:
    """Global ``[B, H, S, D]`` in (the same on every rank), global out."""
    parts = [shard_seq(t, mesh, axis_name, 2) for t in (q, k, v)]
    out = ring_attention(*parts, axis_name=axis_name, scale=scale, mesh=mesh)
    if _mesh.axis_size(mesh, axis_name) == 1:
        return out
    return comm.all_gather_cat(out, _mesh.axis_group(mesh, axis_name), 2)
