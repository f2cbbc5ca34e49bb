"""Ring attention with the transfer of step ``s+1`` started before the math
of step ``s``: kernel K7 and its plain version.

Port of ``ltx_video_gpupoor_tpu/parallel/ring_rdma.py``. The sequence is
cut into ``p`` shards; rank ``r`` holds ``[B, H, S/p, D]`` of q, k and v;
the kv shards rotate to the right neighbour through two slots per rank,
and every rank folds the block it holds into an fp32 online softmax
(``exp``, the output divided by ``max(l, 1e-20)``). Non-causal, no mask.

- :func:`ring_attention_rdma` is ``ring_attention_rdma`` (:122) over the
  ``p`` per-rank tensors, backed by ``csrc/ring_attention.cu`` (K7, which
  replaces ``_ring_kernel``, :43). On the TPU each rank is a chip and the
  call sits inside ``shard_map``; here the whole ring is one cooperative
  launch on one card: a rank is a set of persistent thread blocks, the
  slots and the softmax state live in device memory, a transfer is plain
  stores through the neighbour's slot pointer followed by a release of a
  counter, and the counters carry a call epoch (see the source's
  header). Two bodies do the tile math (:func:`ring_body` picks one): K1's
  ``wgmma`` block on the tensor cores (bf16, D 64 or 128, shards of a
  multiple of 64 rows; its tensor maps live in a device buffer, the slots'
  written once a workspace) and CUDA cores in fp32 (every other shape and
  type; test-sized shapes only). Which one ran is counted in
  ``ring_attention_rdma.launches_tc`` and ``.launches_simple``; their sum
  is ``.launches``.
- :func:`ring_attention_rdma_sharded` is ``ring_attention_rdma_sharded``
  (:179): it cuts a global ``[B, H, S, D]`` on S and joins the result.
- :func:`logical_id` is ``_logical_id`` (:32): the global id of a ring
  neighbour on a multi-axis mesh.
- :func:`ring_attention_plain` is the same ring in plain PyTorch.

The launch of the same kernel once per device over peer-mapped pointers
(several cards on one host) is not written: the whole ring is verified on
one card.
"""

from __future__ import annotations

import ctypes

import torch

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


def ring_attention_plain(q_shards, k_shards, v_shards,
                         scale: float | None = None) -> list[torch.Tensor]:
    """The ring in plain PyTorch: two kv slots per rank, slot 0 filled with
    the rank's own k and v; at step ``s`` every rank sends the slot it
    holds to its right neighbour's other slot and folds it into its
    running (m, l, acc) in fp32: the step's max first, ``exp`` against the
    new max, the old sums rescaled. Returns the ``p`` outputs in the
    inputs' dtype."""
    p = _check_shards(q_shards, k_shards, v_shards)
    b, h, s_loc, d = q_shards[0].shape
    if scale is None:
        scale = d ** -0.5
    dev = q_shards[0].device
    kslot = [[k_shards[r], None] for r in range(p)]
    vslot = [[v_shards[r], None] for r in range(p)]
    m = [torch.full((b, h, s_loc, 1), NEG_INF, device=dev) for _ in range(p)]
    l = [torch.zeros((b, h, s_loc, 1), device=dev) for _ in range(p)]
    acc = [torch.zeros((b, h, s_loc, d), device=dev) for _ in range(p)]
    heads = max(1, min(h, PLAIN_SCORE_ELEMS // max(1, b * s_loc * s_loc)))
    for step in range(p):
        slot, nxt = step % 2, (step + 1) % 2
        if step + 1 < p:
            sent = [(kslot[r][slot], vslot[r][slot]) for r in range(p)]
            for r in range(p):
                right = (r + 1) % p
                kslot[right][nxt], vslot[right][nxt] = sent[r]
        for r in range(p):
            for h0 in range(0, h, heads):
                hs = slice(h0, h0 + heads)
                qf = q_shards[r][:, hs].float()
                kb = kslot[r][slot][:, hs].float()
                vb = vslot[r][slot][:, hs].float()
                s = (qf @ kb.transpose(-1, -2)) * scale
                m_prev = m[r][:, hs]
                m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m_prev - m_new)
                pexp = torch.exp(s - m_new)
                del s
                l[r][:, hs] = l[r][:, hs] * alpha \
                    + pexp.sum(dim=-1, keepdim=True)
                acc[r][:, hs] = acc[r][:, hs] * alpha + pexp @ vb
                del pexp
                m[r][:, hs] = m_new
    return [(acc[r] / torch.clamp(l[r], min=L_FLOOR)).to(q_shards[r].dtype)
            for r in range(p)]


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


def release_workspaces() -> None:
    """Drop every cached workspace (a ring of a new shape allocates its
    own at its first call, and keeps it for the next)."""
    _workspaces.clear()


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
