"""K7's per-rank entry (the launch once per card) on the CPU: its plain
path on gloo ranks against the JAX package's Pallas kernel, run through the
Pallas TPU interpreter inside ``shard_map`` on the virtual CPU devices;
what it refuses; the status codes it names; and ``parallel/comm.py``'s
count of every collective by name.

Ranks are gloo processes from ``core.mesh.spawn_ranks`` running
``tests/torch_cards_workers.py`` (no jax there). The same numpy inputs go
through ``ltx_video_gpupoor_tpu.parallel.ring_rdma.
ring_attention_rdma_sharded(mesh, ..., interpret=True)`` and the port's
``ring_attention_rdma_rank_sharded(mesh, ...)``, which on CPU tensors runs
``ring_attention_rank_plain`` over ``comm.ring_shift``. Tolerances are
those of ``tests/test_torch_ring_rdma.py``: fp32 ``atol=2e-5``, bf16
``atol=3e-2``. On every rank the per-rank entry equals the list entry's
plain ring on the same shards bit for bit (the same fold in the same
order).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cards_workers as workers
from ltx_video_gpupoor_tpu.core.mesh import MeshConfig, make_mesh
from ltx_video_gpupoor_tpu.parallel import ring_rdma as jrr
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh
from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as trr

TIMEOUT = 120.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(tmp_path, fn, world, *args):
    return tmesh.spawn_ranks(fn, world, backend="gloo", timeout=TIMEOUT,
                             store_dir=str(tmp_path), args=args)


@pytest.mark.parametrize("dims,dtype,atol", [
    ((1, 2, 1), "float32", 2e-5),
    ((1, 4, 1), "float32", 2e-5),
    ((2, 2, 1), "float32", 2e-5),
    ((1, 4, 1), "bfloat16", 3e-2),
])
def test_rank_entry_matches_jax_kernel(tmp_path, dims, dtype, atol):
    """sp = 2 and 4, and the two rings of a dp2 x sp2 mesh (the neighbours
    from ``ring_neighbours`` on the mesh's axes, held to the sp group's)."""
    n = int(np.prod(dims))
    mesh = make_mesh(MeshConfig(*dims), devices=jax.devices()[:n])
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
               for _ in range(3))
    jdt = getattr(jnp, dtype)
    ref = np.asarray(jrr.ring_attention_rdma_sharded(
        mesh, *(jnp.asarray(t, jdt) for t in (q, k, v)), interpret=True),
        np.float32)
    outs = spawn(tmp_path, workers.ring_rank, n, dims, q, k, v, dtype)
    for out, same_as_list, out_dtype in outs:
        assert out_dtype == f"torch.{dtype}"
        np.testing.assert_allclose(out, ref, atol=atol)
        assert same_as_list


def test_rank_entry_rejects(tmp_path):
    """An axis size that is not the mesh's, q / k / v of different shapes,
    and a call without an active mesh: each raises before any ring."""
    for errors in spawn(tmp_path, workers.ring_rank_rejects, 2):
        assert len(errors) == 3
        assert "is not the mesh's" in errors[0]
        assert "one [B, H, S/p, D] shape" in errors[1]
        assert "no active mesh" in errors[2]


def test_status_codes_are_the_kernels():
    """The codes a launch once per card leaves in its header, as the
    source defines them, each named by the wrapper's message table."""
    src = open(os.path.join(REPO, "ltx_video_gpupoor_tpu_torch", "csrc",
                            "ring_attention.cu")).read()
    codes = {int(v) for v in re.findall(r"constexpr int ST_\w+ = (\d+);",
                                        src)}
    assert codes == set(trr.K7_STATUS) == {1, 2, 3}


def test_collective_counts(tmp_path):
    """``comm.call_counts`` counts every call by collective under every
    backend (here gloo on CPU tensors, where nothing is staged even with
    every collective named); ``reset_counts`` clears both counts."""
    for (calls, staged), after in spawn(tmp_path, workers.collective_counts,
                                        2):
        assert calls == {"all_to_all": 1, "all_reduce": 2, "all_gather": 1,
                         "ring_shift": 1}
        assert staged == {} and after == {}
