"""Ring attention with the transfer of step ``s+1`` started before the math
of step ``s``: kernel K7 and its plain version.

Port of ``ltx_video_gpupoor_tpu/parallel/ring_rdma.py``. The sequence is
cut into ``p`` shards; rank ``r`` holds ``[B, H, S/p, D]`` of q, k and v;
the kv shards rotate to the right neighbour through two slots per rank,
and every rank folds the block it holds into an fp32 online softmax
(``exp``, the output divided by ``max(l, 1e-20)``). Non-causal, no mask.
Backed by ``csrc/ring_attention.cu`` (K7, which replaces ``_ring_kernel``,
:43): a transfer is plain stores through the neighbour's slot pointer
followed by a release of a counter, and the counters carry a call epoch
(see the source's header). Two bodies do the tile math (:func:`ring_body`
picks one): K1's ``wgmma`` block on the tensor cores (bf16, D 64 or 128,
shards of a multiple of 64 rows) and CUDA cores in fp32 (every other
shape and type; test-sized shapes only). Which one ran is counted in
``.launches_tc`` and ``.launches_simple`` of each entry; their sum is
``.launches``. The kernel is launched in one of two ways:

- :func:`ring_attention_rdma_rank` is JAX's ``ring_attention_rdma`` (:122)
  as ``shard_map`` calls it: this rank's ``[B, H, S/p, D]`` under the
  active mesh (``core/mesh.py``), launched once per card, as the TPU
  kernel runs once per chip. The right neighbour's two k and two v slots
  and its counters are peer pointers: each rank's workspace is one
  ``cudaMalloc``'d allocation whose IPC handle the ring's ranks exchange
  over the group once a shape and map (``ops/_lib.py``). It needs peer
  access between the ranks' cards and raises without it; nothing falls
  back. :func:`ring_attention_rdma_rank_sharded` is
  ``ring_attention_rdma_sharded`` (:179): a global ``[B, H, S, D]`` cut,
  run and joined over the ``sp`` axis of a mesh.
- :func:`ring_attention_rdma` runs the whole ring of ``p`` per-rank
  tensors on one card in one cooperative launch: a rank is a set of
  persistent thread blocks, the slots and the softmax state live in that
  card's memory. :func:`ring_attention_rdma_sharded` cuts a global
  ``[B, H, S, D]`` into ``p`` shards on S for it and joins the result.

- :func:`logical_id` is ``_logical_id`` (:32): the global id of a ring
  neighbour on a multi-axis mesh.
- :func:`ring_attention_plain` is the ring in plain PyTorch over the ``p``
  shards; :func:`ring_attention_rank_plain` the same ring of one rank over
  ``comm.ring_shift``, which CPU tensors take in the per-rank entry.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

NEG_INF = -1e30
LOG2E = 1.4426950408889634
L_FLOOR = 1e-20
MAX_RANKS = 16       # MAXP in csrc/ring_attention.cu
TILE = 64            # the tensor-core body takes S/p in multiples of it
MAX_D_SIMPLE = 128   # the CUDA-core body keeps a row in local memory
MAP_BYTES = 128      # a CUtensorMap; the buffer holds 3 a rank, 4 more a slot
# the plain version holds one [heads, S/p, S/p] fp32 score block at a time
PLAIN_SCORE_ELEMS = 1 << 29


def logical_id(mesh_axes, ring_axis: str, ring_idx: int, coords: dict) -> int:
    """Global logical device id of the device at ``ring_idx`` on the ring
    axis and at ``coords[name]`` on every other axis: row-major over
    ``mesh_axes`` = ((name, size), ...), the mesh's device-array order."""
    lid = 0
    for name, size in mesh_axes:
        idx = ring_idx if name == ring_axis else coords[name]
        lid = lid * size + int(idx)
    return lid


def ring_neighbours(mesh_axes, ring_axis: str, coords: dict) -> tuple[int, int]:
    """``(left, right)`` global ids of the device at ``coords`` on the ring
    along ``ring_axis`` (:52-54)."""
    p = dict(mesh_axes)[ring_axis]
    my = coords[ring_axis]
    return (logical_id(mesh_axes, ring_axis, (my + p - 1) % p, coords),
            logical_id(mesh_axes, ring_axis, (my + 1) % p, coords))


def _check_shards(q_shards, k_shards, v_shards):
    p = len(q_shards)
    if p < 1 or len(k_shards) != p or len(v_shards) != p:
        raise ValueError("q, k and v need one shard per rank each")
    ref = q_shards[0]
    if ref.dim() != 4:
        raise ValueError(f"a shard is [B, H, S/p, D], got {tuple(ref.shape)}")
    for name, shards in (("q", q_shards), ("k", k_shards), ("v", v_shards)):
        for t in shards:
            if t.shape != ref.shape or t.dtype != ref.dtype \
                    or t.device != ref.device:
                raise ValueError(
                    f"every shard must be {ref.dtype} {tuple(ref.shape)} on "
                    f"{ref.device}; a {name} shard is {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return p


def _fold(qf, kb, vb, scale, m, l, acc, heads):
    """Fold one kv block into the running (m, l, acc) of one rank, in
    place, ``heads`` heads at a time: the block's max first, ``exp``
    against the new max, the old sums rescaled (fp32)."""
    h = qf.shape[1]
    for h0 in range(0, h, heads):
        hs = slice(h0, h0 + heads)
        s = (qf[:, hs] @ kb[:, hs].float().transpose(-1, -2)) * scale
        m_prev = m[:, hs]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_prev - m_new)
        pexp = torch.exp(s - m_new)
        del s
        l[:, hs] = l[:, hs] * alpha + pexp.sum(dim=-1, keepdim=True)
        acc[:, hs] = acc[:, hs] * alpha + pexp @ vb[:, hs].float()
        del pexp
        m[:, hs] = m_new


def _plain_state(shape, device):
    b, h, s_loc, d = shape
    return (torch.full((b, h, s_loc, 1), NEG_INF, device=device),
            torch.zeros((b, h, s_loc, 1), device=device),
            torch.zeros((b, h, s_loc, d), device=device),
            max(1, min(h, PLAIN_SCORE_ELEMS // max(1, b * s_loc * s_loc))))


def ring_attention_plain(q_shards, k_shards, v_shards,
                         scale: float | None = None) -> list[torch.Tensor]:
    """The ring in plain PyTorch: two kv slots per rank, slot 0 filled with
    the rank's own k and v; at step ``s`` every rank sends the slot it
    holds to its right neighbour's other slot and folds it into its
    running (m, l, acc) in fp32: the step's max first, ``exp`` against the
    new max, the old sums rescaled. Returns the ``p`` outputs in the
    inputs' dtype."""
    p = _check_shards(q_shards, k_shards, v_shards)
    d = q_shards[0].shape[-1]
    if scale is None:
        scale = d ** -0.5
    kslot = [[k_shards[r], None] for r in range(p)]
    vslot = [[v_shards[r], None] for r in range(p)]
    states = [_plain_state(q.shape, q.device) for q in q_shards]
    for step in range(p):
        slot, nxt = step % 2, (step + 1) % 2
        if step + 1 < p:
            sent = [(kslot[r][slot], vslot[r][slot]) for r in range(p)]
            for r in range(p):
                right = (r + 1) % p
                kslot[right][nxt], vslot[right][nxt] = sent[r]
        for r in range(p):
            _fold(q_shards[r].float(), kslot[r][slot], vslot[r][slot], scale,
                  *states[r])
    return [(acc / torch.clamp(l, min=L_FLOOR)).to(q_shards[r].dtype)
            for r, (_, l, acc, _) in enumerate(states)]


def ring_attention_rank_plain(q, k, v, group,
                              scale: float | None = None) -> torch.Tensor:
    """One rank's ring in plain PyTorch, over the process ``group`` (the
    ring's ranks in ring order): two slots, slot 0 this rank's own k and
    v; at step ``s`` the slot it holds goes to the right neighbour
    (``comm.ring_shift``) and the rank folds it into its running (m, l,
    acc) as :func:`ring_attention_plain` does."""
    from . import comm

    p = dist.get_world_size(group) if group is not None else 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    state = _plain_state(q.shape, q.device)
    qf = q.float()
    slots = [(k, v), None]
    for step in range(p):
        slot, nxt = step % 2, (step + 1) % 2
        if step + 1 < p:
            slots[nxt] = tuple(comm.ring_shift(list(slots[slot]), group))
        _fold(qf, *slots[slot], scale, *state)
    _, l, acc, _ = state
    return (acc / torch.clamp(l, min=L_FLOOR)).to(q.dtype)


def _map_buffer(n_maps, device):
    """Device bytes for ``n_maps`` tensor maps and the 64-byte aligned
    address of the first."""
    buf = torch.empty(n_maps * MAP_BYTES + 64, dtype=torch.uint8,
                      device=device)
    return buf, buf.data_ptr() + (-buf.data_ptr() % 64)


class _Workspace:
    """What a ring of one shape keeps between calls: per rank two kv slots
    and the softmax state, the counters with the epoch they stand at, and
    for the tensor-core body the tensor maps (the slots' are written at the
    first call, the inputs' at every call)."""

    def __init__(self, p, body, b, h, s_loc, d, dtype, device, lib):
        n_state = lib.k7_ring_state_floats(body, b * h, s_loc, d)
        self.kslot = [torch.empty(2, b * h, s_loc, d, dtype=dtype,
                                  device=device) for _ in range(p)]
        self.vslot = [torch.empty_like(t) for t in self.kslot]
        self.state = [torch.empty(n_state, dtype=torch.float32, device=device)
                      for _ in range(p)]
        self.flags = torch.zeros(2, p, p, dtype=torch.int32, device=device)
        self.target = 0
        self.maps, self.maps_ptr = _map_buffer(7 * p, device)
        self.maps_ready = False


_workspaces: dict = {}


def _pointer_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _common_strides(name, shards):
    strides = shards[0].stride()
    for t in shards:
        if t.stride() != strides:
            raise ValueError(f"K7 needs one set of strides for every {name} "
                             "shard")
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"K7 needs {name} shards with a unit last stride "
                             f"and 16-byte aligned rows, got {t.stride()}")
        if max(t.stride()) * max(t.shape[0], 1) >= 2 ** 31:
            raise ValueError(f"{name} strides must fit the kernel's int32")
    return strides[:3]


def ring_body(dtype: torch.dtype, s_loc: int, d: int) -> int:
    """Which body of K7 takes shards of ``S/p = s_loc`` rows and head dim
    ``d``: 0, K1's ``wgmma`` block (bf16, D 64 or 128, ``s_loc`` a multiple
    of 64; a multiple that 128 does not divide takes the block's tail
    instance); 1 or 2, the CUDA-core body in fp32 or bf16 (D up to 128 with
    16-byte rows). Raises ``ValueError`` for what neither takes."""
    if dtype == torch.bfloat16 and d in (64, 128) and s_loc % TILE == 0:
        return 0
    if dtype in (torch.float32, torch.bfloat16) and d <= MAX_D_SIMPLE \
            and d * dtype.itemsize % 16 == 0:
        return 1 if dtype == torch.float32 else 2
    raise ValueError(
        f"K7 takes bf16 at D 64/128 with S/p a multiple of {TILE}, or "
        f"fp32/bf16 at D <= {MAX_D_SIMPLE} with 16-byte rows; got "
        f"{dtype} S/p={s_loc} D={d}")


def ring_attention_rdma(q_shards, k_shards, v_shards,
                        scale: float | None = None, *, out_shards=None,
                        _fault: tuple[int, int] | None = None):
    """Non-causal ring attention over ``p`` per-rank ``[B, H, S/p, D]``
    tensors; returns the ``p`` per-rank outputs (written into
    ``out_shards`` if given).

    CPU tensors take :func:`ring_attention_plain`; CUDA tensors launch K7
    (one cooperative launch for the whole ring) or raise (also under
    autograd: the kernel has no backward). Calls that share
    a shape share a workspace and must be issued on one stream.
    ``_fault=(rank, step)`` makes that rank skip the math of that step: a
    planted fault for the check of the checks."""
    p = _check_shards(q_shards, k_shards, v_shards)
    ref = q_shards[0]
    b, h, s_loc, d = ref.shape
    if scale is None:
        scale = d ** -0.5
    from ..ops import _lib

    _lib.refuse_grad("K7", ref.device, *q_shards, *k_shards, *v_shards)
    if ref.device.type == "cpu":
        outs = ring_attention_plain(q_shards, k_shards, v_shards, scale)
        if out_shards is not None:
            for dst, src in zip(out_shards, outs):
                dst.copy_(src)
            return list(out_shards)
        return outs
    if ref.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or the CPU, not {ref.device}")
    if p > MAX_RANKS:
        raise ValueError(f"K7 takes at most {MAX_RANKS} ranks, got {p}")
    body = ring_body(ref.dtype, s_loc, d)

    lib = _lib.library()
    if out_shards is None:
        out_shards = [torch.empty((b, h, s_loc, d), dtype=ref.dtype,
                                  device=ref.device) for _ in range(p)]
    strides = [_common_strides(name, shards) for name, shards in (
        ("q", q_shards), ("k", k_shards), ("v", v_shards),
        ("out", out_shards))]
    nblk = lib.k7_ring_blocks(body, p, b * h, s_loc, d)
    if nblk < 1:
        raise RuntimeError("K7: the device cannot hold the ring in one "
                           "cooperative launch")
    key = (p, body, b, h, s_loc, d, ref.dtype, ref.device, nblk)
    ws = _workspaces.get(key)
    if ws is None and p > 1:
        ws = _workspaces[key] = _Workspace(p, body, b, h, s_loc, d, ref.dtype,
                                           ref.device, lib)
    if ws is not None:
        ws.target = (ws.target + nblk) % 2 ** 32
    maps_ptr, maps_ready = None, 0
    if body == 0:
        if ws is None:   # one rank: its q, k and v maps, for this call
            _maps, maps_ptr = _map_buffer(3, ref.device)
        else:
            maps_ptr, maps_ready = ws.maps_ptr, int(ws.maps_ready)
    fault_rank, fault_step = _fault if _fault is not None else (-1, -1)
    code = lib.k7_ring_attention(
        _pointer_array(q_shards), _pointer_array(k_shards),
        _pointer_array(v_shards), _pointer_array(out_shards),
        _pointer_array(ws.kslot) if ws else None,
        _pointer_array(ws.vslot) if ws else None,
        _pointer_array(ws.state) if ws else None,
        maps_ptr, maps_ready,
        ws.flags[0].data_ptr() if ws else None,
        ws.flags[1].data_ptr() if ws else None,
        body, p, b, h, s_loc, d, *strides[0], *strides[1], *strides[2],
        *strides[3], nblk, ws.target if ws else 0,
        ctypes.c_float(float(scale) * (LOG2E if body == 0 else 1.0)),
        fault_rank, fault_step, _lib.stream_ptr(ref.device))
    _lib.check(code, "K7 ring_attention_rdma launch")
    if ws is not None and body == 0:
        ws.maps_ready = True
    ring_attention_rdma.launches += 1
    if body == 0:
        ring_attention_rdma.launches_tc += 1
    else:
        ring_attention_rdma.launches_simple += 1
    return list(out_shards)


ring_attention_rdma.launches = 0
ring_attention_rdma.launches_tc = 0
ring_attention_rdma.launches_simple = 0


def ring_attention_rdma_sharded(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, p: int,
                                scale: float | None = None) -> torch.Tensor:
    """Ring attention over a global ``[B, H, S, D]``: cut into ``p`` shards
    on S (views, no copy), run :func:`ring_attention_rdma`, and return the
    joined ``[B, H, S, D]`` (each rank writes its rows of it in place)."""
    if q.dim() != 4 or q.shape[2] % p:
        raise ValueError(f"S={q.shape[2] if q.dim() == 4 else '?'} must "
                         f"split into p={p} shards")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ring_attention_rdma(q.chunk(p, dim=2), k.chunk(p, dim=2),
                        v.chunk(p, dim=2), scale,
                        out_shards=out.chunk(p, dim=2))
    return out


# ---- once per card: the per-rank entry -----------------------------------

# a spin's bound in the launch once per card: far beyond the launch skew
# between processes (tens of milliseconds) and a step's wait for a peer's
# math, so that only a rank that never launches ends it
K7_SPIN_S = 10.0
# why a launch once per card gave up (the status it leaves in its header)
K7_STATUS = {
    1: "a spin outlasted its bound: a neighbour did not launch in time",
    2: "a neighbour gave up",
    3: "the left neighbour is at another call: the ranks called this ring "
       "a different number of times",
}


class _CardWorkspace:
    """One rank's share of a ring of one shape once per card: its own
    allocation (header of counters, two k and two v slots; outside the
    caching allocator, zeroed once), its neighbours' mapped into this
    process, its softmax state and tensor maps, and the call epoch, which
    every rank of the ring advances alike."""

    def __init__(self, key, group, right, left, body, b, h, s_loc, d,
                 device, nblk, lib):
        from ..ops import _lib

        self.device = device
        self.ptr, handle = _lib.device_alloc(
            lib.k7_card_workspace_bytes(body, b * h, s_loc, d), device)
        self.state = torch.empty(lib.k7_ring_state_floats(body, b * h, s_loc,
                                                          d),
                                 dtype=torch.float32, device=device)
        self.maps, self.maps_ptr = _map_buffer(7, device)
        self.maps_ready = False
        self.epoch = 0
        self.peers: dict = {}
        me = dist.get_rank()
        try:
            # every rank of the ring meets here once a shape: the key and
            # the blocks must agree, or the counters could never meet, and
            # each card must map its neighbours' memory
            got = [None] * dist.get_world_size(group)
            dist.all_gather_object(got, (me, key, nblk, handle,
                                         device.index), group=group)
            for rank, their_key, their_nblk, their_handle, card in got:
                if their_key != key or their_nblk != nblk:
                    raise RuntimeError(
                        f"K7 once per card: rank {rank} calls the ring with "
                        f"{their_key} on {their_nblk} blocks, rank {me} with "
                        f"{key} on {nblk}")
                if rank not in (right, left) or rank == me:
                    continue
                if card != device.index and not _lib.can_access_peer(
                        device.index, card):
                    raise RuntimeError(
                        f"K7 once per card: card {device.index} (rank {me}) "
                        f"has no peer access to card {card} (rank {rank}), "
                        f"its neighbour on the ring {key[-1]}")
                self.peers[rank] = _lib.ipc_open(their_handle, device)
            self.right, self.left = self.peers[right], self.peers[left]
            # the ranks start the first call together
            dist.barrier(group=group)
        except BaseException:
            self.release()
            raise

    def release(self):
        from ..ops import _lib

        for ptr in self.peers.values():
            _lib.ipc_close(ptr, self.device)
        self.peers = {}
        if self.ptr:
            _lib.device_free(self.ptr, self.device)
            self.ptr = 0


_card_workspaces: dict = {}
# once per card, the workspaces of rings that gave up: unmapped and freed
# only by release_workspaces, when the caller knows no peer still uses them
_given_up: list = []


def release_workspaces() -> None:
    """Drop every cached workspace (a ring of a new shape allocates its
    own at its first call, and keeps it for the next); once per card,
    unmap the neighbours' and free this rank's, also those of rings that
    gave up (every rank of a ring releases alike, with no launch of it in
    flight on any rank)."""
    _workspaces.clear()
    while _card_workspaces:
        _given_up.append(_card_workspaces.popitem()[1])
    while _given_up:
        _given_up.pop().release()


def _mesh_ring(mesh, axis_size, axis_name, mesh_axes):
    """``(p, my index on the ring, right, left, the ring's group)`` of this
    rank: the neighbours as global ids from ``mesh_axes`` (the mesh's own
    axes by default) and this rank's coordinates."""
    from ..core import mesh as _mesh

    names = tuple(mesh.mesh_dim_names)
    if not mesh_axes:
        mesh_axes = tuple((n, _mesh.axis_size(mesh, n)) for n in names)
    if dict(mesh_axes).get(axis_name) != axis_size \
            or _mesh.axis_size(mesh, axis_name) != axis_size:
        raise ValueError(f"axis {axis_name!r} of size {axis_size} is not "
                         f"the mesh's {dict(mesh_axes)}")
    coords = {n: _mesh.axis_rank(mesh, n) for n in names}
    left, right = ring_neighbours(mesh_axes, axis_name, coords)
    group = _mesh.axis_group(mesh, axis_name) if axis_size > 1 else None
    if group is not None:
        my = coords[axis_name]
        want = (dist.get_global_rank(group, (my + 1) % axis_size),
                dist.get_global_rank(group, (my - 1) % axis_size))
        if want != (right, left):
            raise RuntimeError(f"K7: the ring's neighbours {(right, left)} "
                               f"are not the {axis_name} group's {want}")
    return axis_size, coords[axis_name], right, left, group


def ring_attention_rdma_rank(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, axis_size: int,
                             axis_name: str = "sp", mesh_axes: tuple = (),
                             scale: float | None = None, *,
                             _fault: tuple[int, int] | None = None,
                             _timeout_s: float = K7_SPIN_S) -> torch.Tensor:
    """Non-causal ring attention of this rank: q, k, v ``[B, H, S/p, D]``
    sequence-sharded over ``axis_name`` (of size ``axis_size``) of the
    active mesh, as JAX calls ``ring_attention_rdma`` inside ``shard_map``;
    ``mesh_axes`` ((name, size), ...) in mesh order resolve the neighbours
    on multi-axis meshes (default: the mesh's). Every rank of the ring
    calls it alike.

    CPU tensors take :func:`ring_attention_rank_plain`; CUDA tensors launch
    K7 once on this rank's card (or raise, also under autograd). Calls
    that share a shape share a workspace and must be issued on one stream;
    a call returns after its launch has ended, and raises where it gave up
    (:data:`K7_STATUS`; the workspace is dropped: every rank of the ring
    must then :func:`release_workspaces` once no launch of it is in flight
    on any rank). ``_fault=(rank, step)``: that ring index skips the math
    of that step (a planted fault for the check of the checks);
    ``_timeout_s``: a spin's bound."""
    from ..core import mesh as _mesh
    from ..ops import _lib

    p, my, right, left, group = _mesh_ring(_mesh.active_mesh(), axis_size,
                                           axis_name, mesh_axes)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or k.dtype != q.dtype or v.dtype != q.dtype \
            or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be one [B, H, S/p, D] shape, type "
                         "and device")
    b, h, s_loc, d = q.shape
    if scale is None:
        scale = d ** -0.5
    _lib.refuse_grad("K7", q.device, q, k, v)
    if q.device.type == "cpu":
        return ring_attention_rank_plain(q, k, v, group, scale)
    if q.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or the CPU, not {q.device}")
    if p > MAX_RANKS:
        raise ValueError(f"K7 takes at most {MAX_RANKS} ranks, got {p}")
    body = ring_body(q.dtype, s_loc, d)
    lib = _lib.library()
    out = torch.empty((b, h, s_loc, d), dtype=q.dtype, device=q.device)
    strides = [_common_strides(name, [t]) for name, t in (
        ("q", q), ("k", k), ("v", v), ("out", out))]
    nblk = lib.k7_card_blocks(body, b * h, s_loc, d)
    if nblk < 1:
        raise RuntimeError("K7: the card cannot hold a rank in one "
                           "cooperative launch")
    ws = None
    if p > 1:
        ring = tuple(dist.get_global_rank(group, i) for i in range(p))
        key = (p, body, b, h, s_loc, d, str(q.dtype), ring)
        ws = _card_workspaces.get((key, q.device))
        if ws is None:
            ws = _card_workspaces[(key, q.device)] = _CardWorkspace(
                key, group, right, left, body, b, h, s_loc, d, q.device,
                nblk, lib)
        ws.epoch = (ws.epoch + 1) % 2 ** 32 or 1
    maps_ptr, maps_ready = None, 0
    if body == 0:
        if ws is None:
            _maps, maps_ptr = _map_buffer(3, q.device)
        else:
            maps_ptr, maps_ready = ws.maps_ptr, int(ws.maps_ready)
    fault_rank, fault_step = _fault if _fault is not None else (-1, -1)
    stream = _lib.stream_ptr(q.device)
    code = lib.k7_ring_attention_card(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.ptr if ws else None, ws.right if ws else None,
        ws.left if ws else None, ws.state.data_ptr() if ws else None,
        maps_ptr, maps_ready, body, my, p, b, h, s_loc, d, *strides[0],
        *strides[1], *strides[2], *strides[3], nblk, ws.epoch if ws else 1,
        ctypes.c_float(float(scale) * (LOG2E if body == 0 else 1.0)),
        fault_rank, fault_step, ctypes.c_float(_timeout_s), stream)
    _lib.check(code, "K7 ring_attention_rdma_rank launch")
    ring_attention_rdma_rank.launches += 1
    if body == 0:
        ring_attention_rdma_rank.launches_tc += 1
    else:
        ring_attention_rdma_rank.launches_simple += 1
    if ws is not None:
        if body == 0:
            ws.maps_ready = True
        status = ctypes.c_int()
        _lib.check(lib.k7_card_status(ws.ptr, stream, ctypes.byref(status)),
                   "K7 ring_attention_rdma_rank")
        if status.value:
            _given_up.append(_card_workspaces.pop((key, q.device)))
            raise RuntimeError(
                f"K7 once per card, rank {dist.get_rank()} (ring index {my} "
                f"of {p}): {K7_STATUS.get(status.value, status.value)}")
    return out


ring_attention_rdma_rank.launches = 0
ring_attention_rdma_rank.launches_tc = 0
ring_attention_rdma_rank.launches_simple = 0


def ring_attention_rdma_rank_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, axis_name: str = "sp",
                                     scale: float | None = None
                                     ) -> torch.Tensor:
    """JAX's ``ring_attention_rdma_sharded`` (:179): a global ``[B, H, S,
    D]`` (the same on every rank) cut on S over ``axis_name`` of ``mesh``,
    :func:`ring_attention_rdma_rank` on each rank's chunk, the chunks
    joined in rank order (every axis but ``axis_name`` replicated)."""
    from ..core import mesh as _mesh
    from .ulysses import shard_seq

    p = _mesh.axis_size(mesh, axis_name)
    parts = [shard_seq(t, mesh, axis_name, 2) for t in (q, k, v)]
    with _mesh.use_mesh(mesh):
        out = ring_attention_rdma_rank(*parts, p, axis_name, scale=scale)
    if p == 1:
        return out
    from . import comm

    return comm.all_gather_cat(out, _mesh.axis_group(mesh, axis_name), 2)
