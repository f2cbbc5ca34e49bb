"""Rank bodies for tests/test_torch_training_mesh.py.

Each runs in a gloo process that ``core.mesh.spawn_ranks`` started and
returns numpy arrays; it imports torch and the port only, never jax (the
JAX references are computed by the test in its own process). Weights
arrive as numpy state dicts (``core/from_jax.py`` keys).
"""

from __future__ import annotations

import numpy as np
import torch


def _setup(dims, cfg_kw, sd_np):
    from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
    from ltx_video_gpupoor_tpu_torch.core.mesh import (
        TENSOR_AXIS,
        MeshConfig,
        axis_rank,
        make_mesh,
    )
    from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import shard_params

    mesh = make_mesh(MeshConfig(*dims), "cpu")
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**cfg_kw),
                                 FP32_POLICY)
    if sd_np is None:
        ttf.init_params(model, torch.Generator().manual_seed(5))
    else:
        model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd_np.items()})
    shard_params(mesh, model)
    return mesh, model, axis_rank(mesh, TENSOR_AXIS)


def _local(model, state):
    from ltx_video_gpupoor_tpu_torch.parallel.sharding import tp_cuts

    return {"cuts": {n: c[1:] for n, c in tp_cuts(model).items()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "mu": {n: t.numpy().copy() for n, t in state.mu.items()},
            "nu": {n: t.numpy().copy() for n, t in state.nu.items()},
            "count": int(state.count)}


def train_step(rank, world, dims, cfg_kw, sd_np, batch_np, t, eps, tc_kw):
    """One sharded step of the global batch on mesh ``dims`` (dp, sp, tp):
    the metrics and this rank's params and moments after it."""
    from ltx_video_gpupoor_tpu_torch.training import (
        TrainBatch,
        TrainConfig,
        make_train_step,
    )

    mesh, model, tp_rank = _setup(dims, cfg_kw, sd_np)
    step = make_train_step(model, TrainConfig(**tc_kw), attn_mode="xla",
                           mesh=mesh)
    batch = TrainBatch(*(torch.from_numpy(a) for a in batch_np))
    m = step(batch, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    return dict(_local(model, step.state), tp_rank=tp_rank,
                **{k: float(v) for k, v in m.items()})


def restore_and_save(rank, world, dims, cfg_kw, src, dst):
    """Restore the latest step of ``src`` onto this rank's cut of other
    weights, then save it again into ``dst`` from the mesh."""
    from ltx_video_gpupoor_tpu_torch.training import (
        TrainCheckpointer,
        TrainConfig,
        init_train_state,
    )

    mesh, model, tp_rank = _setup(dims, cfg_kw, None)
    state = init_train_state(model, TrainConfig())
    gen = torch.Generator().manual_seed(rank + 100)
    step = TrainCheckpointer(src).restore(model, state, gen)
    out = dict(_local(model, state), tp_rank=tp_rank, step=step,
               rng=gen.get_state().numpy())
    TrainCheckpointer(dst).save(step, model, state, gen)
    return out


def collective_grads(rank, world):
    """The gradient each autograd collective of ``parallel/comm.py`` gives
    this rank's input, for a loss ``sum(out * c)`` with a rank-distinct
    ``c = rank + 1 + arange`` (numpy, by collective)."""
    import torch.distributed as dist

    from ltx_video_gpupoor_tpu_torch.parallel import comm

    group = dist.group.WORLD
    out = {}

    def grad(fn, shape):
        x = torch.ones(shape, requires_grad=True)
        y = fn(x)
        c = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
            + rank + 1
        (y * c).sum().backward()
        return x.grad.numpy().copy()

    out["all_to_all"] = grad(lambda x: comm.all_to_all(x, group),
                             (world, 3))
    out["all_gather_cat"] = grad(
        lambda x: comm.all_gather_cat(x, group, 0), (2, 3))
    # reduce_sum sums in place, so it takes a copy of the leaf
    out["reduce_sum"] = grad(lambda x: comm.reduce_sum(x.clone(), group),
                             (2, 3))
    out["reduce_sum grads"] = grad(
        lambda x: comm.reduce_sum(x.clone(), group, sum_grads=True), (2, 3))
    out["tp_input"] = grad(lambda x: comm.tp_input(x, group), (2, 3))
    return out


def session(rank, world, runs, restore=None):
    """The autograd collectives' grads, then several ``train_step`` runs
    in one group (each on a mesh of its own), then ``restore_and_save``
    if ``restore`` is given."""
    grads = collective_grads(rank, world)
    steps = [train_step(rank, world, *run) for run in runs]
    return steps, (restore_and_save(rank, world, *restore)
                   if restore is not None else None), grads
