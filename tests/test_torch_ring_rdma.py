"""K7, ring attention: the port's plain ring against the JAX package's
Pallas kernel, run through the Pallas TPU interpreter (remote DMAs and
semaphores emulated) on the 8 virtual CPU devices.

The same numpy inputs from a seed go through
``ltx_video_gpupoor_tpu.parallel.ring_rdma.ring_attention_rdma_sharded(mesh,
..., interpret=True)`` and through the port's
``ring_attention_rdma_sharded(q, k, v, p)``, which on CPU tensors is
``ring_attention_plain``. Tolerances are those of ``tests/test_ring_rdma.py``:
fp32 ``atol=2e-5`` (both sum in fp32, in another order), bf16 ``atol=3e-2``
(the output's own rounding). The neighbour ids of a multi-axis mesh are
held digit for digit against ``_logical_id`` evaluated on every device of a
``dp2 x sp2 x tp2`` mesh.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ltx_video_gpupoor_tpu.core.mesh import MeshConfig, make_mesh
from ltx_video_gpupoor_tpu.parallel import ring_rdma as jrr
from ltx_video_gpupoor_tpu_torch.ops.flash_attention import reference_attention
from ltx_video_gpupoor_tpu_torch.parallel import ring_rdma as trr

torch.set_num_threads(2)

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _qkv(seed, shape=(1, 2, 64, 32)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _mesh(kind):
    if kind == "ring8":
        return Mesh(np.array(jax.devices()).reshape(8), ("sp",)), 8
    return make_mesh(MeshConfig(dp=2, sp=2, tp=2)), 2


@needs8
@pytest.mark.parametrize("kind,dtype,atol", [
    ("ring8", "float32", 2e-5),
    ("dp2sp2tp2", "float32", 2e-5),
    ("ring8", "bfloat16", 3e-2),
])
def test_plain_ring_matches_jax_kernel(kind, dtype, atol):
    mesh, p = _mesh(kind)
    q, k, v = _qkv(0)
    jdt = getattr(jnp, dtype)
    ref = jrr.ring_attention_rdma_sharded(
        mesh, *(jnp.asarray(t, jdt) for t in (q, k, v)), interpret=True)
    tdt = getattr(torch, dtype)
    out = trr.ring_attention_rdma_sharded(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), p)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@needs8
def test_neighbour_ids_match_jax_on_a_three_axis_mesh():
    """``logical_id`` against ``_logical_id`` traced on every device."""
    mesh = make_mesh(MeshConfig(dp=2, sp=2, tp=2))
    axes = tuple(mesh.shape.items())

    def ids(_):
        my = jax.lax.axis_index("sp")
        left = jrr._logical_id(axes, "sp", jax.lax.rem(my + 2 - 1, 2))
        right = jrr._logical_id(axes, "sp", jax.lax.rem(my + 1, 2))
        me = jrr._logical_id(axes, "sp", my)
        return jnp.stack([me, left, right]).reshape(1, 1, 1, 3)

    got = np.asarray(jax.shard_map(
        ids, mesh=mesh, in_specs=P("dp", "sp", "tp"),
        out_specs=P("dp", "sp", "tp", None), check_vma=False)(
        jnp.zeros((2, 2, 2))))
    names = [n for n, _ in axes]
    assert names == ["dp", "sp", "tp"]
    for idx in itertools.product(range(2), repeat=3):
        coords = dict(zip(names, idx))
        left, right = trr.ring_neighbours(axes, "sp", coords)
        me = trr.logical_id(axes, "sp", coords["sp"], coords)
        # at p = 2 left and right coincide; all three digit for digit
        assert [me, left, right] == got[idx].tolist(), (idx, got[idx])
    # and the flat mesh order: id = (dp * 2 + sp) * 2 + tp
    assert trr.logical_id(axes, "sp", 1, {"dp": 1, "sp": 0, "tp": 0}) == 6


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_plain_ring_is_exact_attention(p):
    """Every ring size gives what one attention over the whole sequence
    gives (fp32, atol 2e-5), into caller-owned output shards too."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, (2, 3, 32, 16)))
    want = reference_attention(q, k, v)
    got = trr.ring_attention_rdma_sharded(q, k, v, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    outs = [torch.empty(2, 3, 32 // p, 16) for _ in range(p)]
    back = trr.ring_attention_rdma(q.chunk(p, 2), k.chunk(p, 2),
                                   v.chunk(p, 2), out_shards=outs)
    assert all(a is b for a, b in zip(back, outs))
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), want.numpy(),
                               atol=2e-5)


def test_plain_ring_scale_and_floor():
    """``scale`` reaches the scores; a row whose every probability
    underflows is divided by the 1e-20 floor, not by 0."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, (1, 1, 8, 16)))
    got = torch.cat(trr.ring_attention_plain(
        q.chunk(2, 2), k.chunk(2, 2), v.chunk(2, 2), scale=0.05), 2)
    want = reference_attention(q, k, v, scale=0.05)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    assert trr.L_FLOOR == 1e-20 and trr.NEG_INF == -1e30


def test_ring_wrapper_rejects_what_it_does_not_take():
    q, k, v = (torch.from_numpy(t) for t in _qkv(3, (1, 2, 16, 8)))
    with pytest.raises(ValueError, match="one shard per rank"):
        trr.ring_attention_rdma(q.chunk(2, 2), k.chunk(4, 2), v.chunk(2, 2))
    with pytest.raises(ValueError, match="every shard must be"):
        trr.ring_attention_rdma([q[:, :, :8], q[:, :, 8:]],
                                [k[:, :, :8], k[:, :, 8:].double()],
                                [v[:, :, :8], v[:, :, 8:]])
    with pytest.raises(ValueError, match="must split into p=3"):
        trr.ring_attention_rdma_sharded(q, k, v, 3)
    with pytest.raises(ValueError, match=r"\[B, H, S/p, D\]"):
        trr.ring_attention_rdma([q[0]], [k[0]], [v[0]])
    assert trr.ring_attention_rdma.launches == 0   # no kernel on the CPU
