"""The collectives of the port, written out, and the shared-card transport.

JAX's ``shard_map`` and SPMD partitioning insert ``all_to_all`` / ``psum``
/ ``all_gather`` / ``ppermute`` for the code; here every one of them is a
call of this module on a process group (``core/mesh.py``), so that each
place where ranks meet can be read and counted:

- :func:`all_to_all` (Ulysses' exchange), :func:`all_reduce` (row-parallel
  linears, the q/k norms over packed heads, the amax of row-parallel int8
  rows), :func:`all_gather_cat` (joining shards), :func:`ring_shift` (ring
  attention's KV pass, ``batch_isend_irecv``), :func:`broadcast_object`
  (the server's requests).

The tensor collectives that the train step meets are
``torch.autograd.Function`` classes over the same calls, so that the
staging below applies in both directions: :func:`all_to_all`'s backward
is the same exchange (chunk j of rank r went to rank j, so its gradient
comes back from there); :func:`reduce_sum` is :func:`all_reduce`'s SUM,
in place, whose backward is the identity where what follows is the same
on every rank (a row-parallel linear's output) or a SUM where each rank
goes on with its own slice (the q/k norms of each rank's heads);
:func:`tp_input` is the identity whose backward sums the partial input
gradients of column-parallel linears; :func:`all_gather_cat`'s backward
takes this rank's slice. Without grad, or on inputs that need none,
autograd records nothing and each is its plain call.

:data:`call_counts` counts every tensor collective by name
(:data:`COLLECTIVES`), under every backend, so that a run can show which
exchanges it made (Ulysses' all-to-alls under sp, tp's all-reduces);
:func:`reset_counts` sets them to 0.

The shared-card transport: NCCL refuses two ranks on one card, so the
ranks that share one H100 run ``gloo``, whose collectives are written for
host memory. :func:`set_staged` names the collectives that copy their
CUDA tensors through pinned host memory and back; it is set by the
caller (``chip_smoke.py``'s ``[mesh]`` phase), never by a failure, and
:data:`staged_counts` counts the staged calls by name. Under NCCL, or on
CPU tensors, nothing is staged.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.distributed as dist

COLLECTIVES = ("all_to_all", "all_reduce", "all_gather", "ring_shift")

_STAGED: set[str] = set()
staged_counts: dict[str, int] = {}
call_counts: dict[str, int] = {}


def reset_counts() -> None:
    """Set :data:`call_counts` and :data:`staged_counts` to 0."""
    call_counts.clear()
    staged_counts.clear()


def set_staged(names: Iterable[str]) -> None:
    """Stage the named collectives (:data:`COLLECTIVES`) through pinned
    host memory from now on; an empty set stages none."""
    names = set(names)
    unknown = names - set(COLLECTIVES)
    if unknown:
        raise ValueError(f"unknown collectives {sorted(unknown)}")
    _STAGED.clear()
    _STAGED.update(names)


def _stages(name: str, tensors: Sequence[torch.Tensor]) -> bool:
    """Count a call of collective ``name``; True where it is staged."""
    call_counts[name] = call_counts.get(name, 0) + 1
    if name in _STAGED and any(t.is_cuda for t in tensors):
        staged_counts[name] = staged_counts.get(name, 0) + 1
        return True
    return False


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        ctx.mark_dirty(x)
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return all_reduce(g.contiguous().clone(), ctx.group), None, None
        return g, None, None


class _TpInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.n
        return g.narrow(ctx.dim, start, ctx.n), None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x [p, ...]``: chunk j goes to rank j of ``group``; returns ``[p,
    ...]`` whose chunk j came from rank j."""
    return _AllToAll.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if _stages("all_to_all", [x]):
        h = _host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place on ``x`` (contiguous); returns it."""
    if _stages("all_reduce", [x]):
        h = _host(x)
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
        return x
    dist.all_reduce(x, op=op, group=group)
    return x


def reduce_sum(x: torch.Tensor, group, sum_grads: bool = False
               ) -> torch.Tensor:
    """The SUM of ``x`` (contiguous, not a leaf that requires grad) over
    ``group``, in place as :func:`all_reduce`; returns it. Its backward
    passes the gradient on as it is (``sum_grads`` False: what follows is
    the same on every rank) or sums it over the group (True: each rank
    goes on with its own slice)."""
    return _ReduceSum.apply(x, group, sum_grads)


def tp_input(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; under autograd its backward sums the gradient over
    ``group``. The input of a column-parallel linear is the same on every
    rank, and each rank's product gives only its part of the input's
    gradient."""
    return _TpInput.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), joined along ``dim`` in rank
    order. Under autograd the backward takes this rank's slice of the
    gradient (what follows is the same on every rank)."""
    return _AllGatherCat.apply(x, group, dim)


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    p = dist.get_world_size(group)
    if _stages("all_gather", [x]):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(p)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim=dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's (one ``batch_isend_irecv``)."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % p)
    prv = dist.get_global_rank(group, (r - 1) % p)
    tensors = [t.contiguous() for t in tensors]
    stage = _stages("ring_shift", tensors)
    src = [_host(t) for t in tensors] if stage else tensors
    dst = [torch.empty_like(t) for t in src]
    ops = []
    for s, d in zip(src, dst):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, d, prv, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if stage:
        return [d.to(t.device) for d, t in zip(dst, tensors)]
    return dst


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of global rank ``src`` on every rank (pickled; a CUDA
    backend carries it on this rank's card, so it is staged only by the
    backend itself)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class TensorParallel:
    """A module's place on the ``tp`` axis: its process group, the axis
    size and this rank's index (set by ``parallel/sharding.py``)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def local(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's contiguous slice of a full-width ``x`` along ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def __repr__(self) -> str:
        return f"TensorParallel(size={self.size}, rank={self.rank})"
