"""Tensor parallelism over the ``tp`` axis: each rank keeps its slice of the
weights, and every collective is written out.

Port of ``ltx_video_gpupoor_tpu/parallel/sharding.py`` (:1-191). JAX
declares ``NamedSharding``s by rule tables and lets XLA SPMD derive the
collectives; here the same tables (``_TRANSFORMER_RULES``, ``_WAN_RULES``,
``_T5_RULES``; a rule matches a :class:`~..ops.quant.Linear` by its JAX
kernel path, the first substring that matches wins) cut each rank's
modules in place (:func:`shard_params`), and the collectives sit where
XLA would put them:

- a column-parallel linear (``"col"``: q/k/v, FFN in) keeps its rows of
  the ``[out, in]`` weight, bias and per-channel / per-group scales
  (``_with_quantized``: every tier's leaves split like the dense kernel);
  no collective;
- a row-parallel linear (``"row"``: LTX ``to_out`` and ``ff.proj_out``,
  Wan ``o`` and ``fc2``, T5 ``o`` and ``fc2``) keeps its columns (a
  per-group int4 scale its groups; a per-channel scale stays whole) and
  all-reduces its partial products, a SUM in fp32 with the bias added
  once (``ops/quant.py::row_parallel_matmul``); in the ``int8_dynamic``
  tier each row is quantized by the amax of the whole row, all-reduced
  with MAX, through K2's given-scale entry;
- the q/k RMS norms over packed heads keep their weights' slice and
  all-reduce the sum of squares (``ops/norms.py::rms_norm``);
- T5's relative-position bias keeps its heads' columns.

Attention then runs each rank's own ``H/tp`` heads locally: K6 on the
local packed ``[B, S, (H/tp)·D]``, the others on split heads. That is why
``ops/headpar.py`` (the SPMD partitioning rule of the opaque Pallas call)
has no counterpart. A geglu FFN's ``proj_in`` splits each of its two
halves, so that a rank's value and gate columns stay paired.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import mesh as _mesh
from ..ops.quant import Linear, jax_path
from .comm import TensorParallel

COL, ROW = "col", "row"

# JAX kernel path fragment -> how the linear splits over tp
_TRANSFORMER_RULES = [
    (".to_q.kernel", COL),
    (".to_k.kernel", COL),
    (".to_v.kernel", COL),
    (".to_out.kernel", ROW),
    ("ff.proj_in.kernel", COL),
    ("ff.proj_out.kernel", ROW),
]

_WAN_RULES = [
    ("self_attn.q.kernel", COL),
    ("self_attn.k.kernel", COL),
    ("self_attn.v.kernel", COL),
    ("self_attn.o.kernel", ROW),
    ("cross_attn.q.kernel", COL),
    ("cross_attn.k.kernel", COL),
    ("cross_attn.v.kernel", COL),
    ("cross_attn.o.kernel", ROW),
    ("ffn.fc1.kernel", COL),
    ("ffn.fc2.kernel", ROW),
]

_T5_RULES = [
    ("attn.q.kernel", COL),
    ("attn.k.kernel", COL),
    ("attn.v.kernel", COL),
    ("attn.o.kernel", ROW),
    ("ffn.fc1.kernel", COL),
    ("ffn.gate.kernel", COL),
    ("ffn.fc2.kernel", ROW),
]

# the weight leaves of a Linear (every tier), split like the dense kernel
_WEIGHT_LEAVES = ("weight", "w_int8_dyn", "w_int8", "w_int4")


def _cut(t: torch.Tensor, dim: int, tp: TensorParallel,
         halves: int = 1) -> torch.Tensor:
    """This rank's share of ``t`` along ``dim``: its slice of each of
    ``halves`` equal parts, joined."""
    parts = t.chunk(halves, dim=dim) if halves > 1 else (t,)
    for part in parts:
        if part.shape[dim] % tp.size:
            raise ValueError(f"{tuple(t.shape)} along dim {dim} does not "
                             f"split over tp={tp.size}")
    out = [tp.local(part, dim) for part in parts]
    return (torch.cat(out, dim=dim) if halves > 1 else out[0]).contiguous()


def _set(mod: nn.Module, name: str, value: torch.Tensor) -> None:
    if isinstance(getattr(mod, name), nn.Parameter):
        setattr(mod, name, nn.Parameter(value, requires_grad=False))
    else:
        setattr(mod, name, value)


def shard_linear(lin: Linear, kind: str, tp: TensorParallel,
                 halves: int = 1) -> None:
    """Cut ``lin`` in place to this rank's columns (``"col"``) or rows
    (``"row"``) of the ``tp`` axis."""
    if lin.tp is not None:
        raise ValueError("this Linear is already sharded")
    for leaf in _WEIGHT_LEAVES:
        if hasattr(lin, leaf):
            w = getattr(lin, leaf)
            _set(lin, leaf, _cut(w, 0 if kind == COL else 1, tp, halves))
    if hasattr(lin, "scale"):
        sc = lin.scale
        if kind == COL:
            _set(lin, "scale", _cut(sc, 0, tp, halves))
        elif sc.dim() == 2:
            # per-group int4 scales [out, in/g]: this rank's groups
            _set(lin, "scale", _cut(sc, 1, tp))
    if kind == COL and lin.bias is not None:
        _set(lin, "bias", _cut(lin.bias, 0, tp, halves))
    if kind == COL:
        lin.d_out //= tp.size
    else:
        lin.d_in //= tp.size
    lin.tp, lin.tp_kind, lin.tp_halves = tp, kind, halves


def _shard_norms(model: nn.Module, tp: TensorParallel) -> None:
    """The q/k norm weights of every attention whose q is column-parallel
    (LTX ``q_norm`` / ``k_norm``, Wan ``norm_q`` / ``norm_k``): this rank's
    slice, and the module all-reduces the sum of squares."""
    for mod in model.modules():
        q = getattr(mod, "to_q", None) or getattr(mod, "q", None)
        if not isinstance(q, Linear) or q.tp_kind != COL:
            continue
        for name in ("q_norm", "k_norm", "norm_q", "norm_k"):
            norm = getattr(mod, name, None)
            if norm is not None:
                norm.weight = nn.Parameter(_cut(norm.weight, 0, tp),
                                           requires_grad=False)
        mod.tp = tp


def tp_cuts(model: nn.Module) -> dict[str, tuple[TensorParallel, int, int]]:
    """Every parameter that :func:`shard_params` cut, by its name in
    ``model.named_parameters()``: ``(tp, dim, halves)`` (:func:`_cut`'s
    arguments). The train step counts these leaves' squares over the tp
    group; the train checkpointer gathers and cuts them."""
    out = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Linear) and mod.tp is not None:
            for leaf in _WEIGHT_LEAVES:
                if isinstance(getattr(mod, leaf, None), nn.Parameter):
                    out[pre + leaf] = (mod.tp, 0 if mod.tp_kind == COL else 1,
                                       mod.tp_halves)
            if mod.tp_kind == COL and mod.bias is not None:
                out[pre + "bias"] = (mod.tp, 0, mod.tp_halves)
        elif not isinstance(mod, Linear) and \
                getattr(mod, "tp", None) is not None:
            for n in ("q_norm", "k_norm", "norm_q", "norm_k"):
                if getattr(mod, n, None) is not None:
                    out[f"{pre}{n}.weight"] = (mod.tp, 0, 1)
    return out


def cut_param(t: torch.Tensor, cut) -> torch.Tensor:
    """This rank's share of a whole leaf ``t`` (a :func:`tp_cuts` value)."""
    tp, dim, halves = cut
    return _cut(t, dim, tp, halves)


def gather_param(t: torch.Tensor, cut) -> torch.Tensor:
    """The whole leaf from every tp rank's share ``t`` (the inverse of
    :func:`cut_param`; a collective of the tp group)."""
    from . import comm

    tp, dim, halves = cut
    with torch.no_grad():
        whole = comm.all_gather_cat(t, tp.group, dim)
    if halves == 1:
        return whole
    # rank r holds its slice of each half: put the halves back together
    split = [p.chunk(halves, dim) for p in whole.chunk(tp.size, dim)]
    return torch.cat([s[i] for i in range(halves) for s in split], dim)


def _apply_rules(model: nn.Module, rules, tp: TensorParallel,
                 geglu: bool = False) -> nn.Module:
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        path = jax_path(name)
        for pattern, kind in rules:
            if pattern in path:
                halves = 2 if geglu and pattern == "ff.proj_in.kernel" else 1
                shard_linear(mod, kind, tp, halves)
                break
    _shard_norms(model, tp)
    return model


def tensor_parallel(mesh) -> TensorParallel | None:
    """This rank's place on ``mesh``'s ``tp`` axis, None at size 1."""
    size = _mesh.axis_size(mesh, _mesh.TENSOR_AXIS)
    if size == 1:
        return None
    return TensorParallel(_mesh.axis_group(mesh, _mesh.TENSOR_AXIS), size,
                          _mesh.axis_rank(mesh, _mesh.TENSOR_AXIS))


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """Cut an LTX transformer (bf16 or quantized: quantize before sharding,
    so that per-channel scales are those of the whole weight) to this
    rank's share of ``mesh``'s ``tp`` axis, in place; returns it."""
    tp = tensor_parallel(mesh)
    if tp is None:
        return model
    geglu = getattr(model.cfg, "activation_fn", "") == "geglu"
    return _apply_rules(model, _TRANSFORMER_RULES, tp, geglu)


def shard_wan_params(mesh, model: nn.Module) -> nn.Module:
    """The Wan DiT's :func:`shard_params` (VACE hint blocks included)."""
    tp = tensor_parallel(mesh)
    return model if tp is None else _apply_rules(model, _WAN_RULES, tp)


def shard_t5_params(mesh, model: nn.Module) -> nn.Module:
    """The T5 / UMT5 encoder's: heads and FFN hidden over tp, and the
    relative-position bias tables' columns of this rank's heads."""
    tp = tensor_parallel(mesh)
    if tp is None:
        return model
    _apply_rules(model, _T5_RULES, tp)
    for mod in [model, *model.blocks]:
        if isinstance(getattr(mod, "pos_embedding", None), torch.Tensor):
            mod.pos_embedding = nn.Parameter(
                _cut(mod.pos_embedding, 1, tp), requires_grad=False)
    return model


def shard_pipeline(pipeline, mesh):
    """Cut a pipeline's DiT (and its T5, where it holds one) to this rank's
    share of the ``tp`` axis, and give it the whole ``mesh`` for the
    parallel tiled decode (also when sp == 1), in place; returns it. The
    VAE stays whole."""
    tf = getattr(pipeline, "transformer", None)
    if tf is not None:
        shard_params(mesh, tf)
    wan = getattr(pipeline, "model", None)
    if wan is not None:
        shard_wan_params(mesh, wan)
    t5 = getattr(pipeline, "t5", None)
    if t5 is not None:
        shard_t5_params(mesh, t5)
    if hasattr(pipeline, "mesh"):
        pipeline.mesh = mesh
    return pipeline
