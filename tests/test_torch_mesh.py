"""The port's mesh, its rank launcher and its sequence-parallel attention,
against the JAX package on the CPU.

Ranks are gloo processes from ``core.mesh.spawn_ranks`` (a ``FileStore``
under ``tmp_path``, a group timeout of 120 s, one intra-op thread each);
their bodies live in ``tests/torch_mesh_workers.py``, which imports no
jax. The JAX side runs on the 8 virtual CPU devices of tests/conftest.py.
Inputs come from numpy with a seed; everything is compared in fp32 at
JAX's own tolerances (tests/test_parallel.py): 2e-5 for Ulysses and ring
attention against ``ulysses_attention_sharded`` / ``ring_attention_sharded``.
"""

import time

import jax
import numpy as np
import pytest

import torch_mesh_workers as workers
from ltx_video_gpupoor_tpu.core import mesh as jmesh
from ltx_video_gpupoor_tpu.parallel.ring_attention import (
    ring_attention_sharded,
)
from ltx_video_gpupoor_tpu.parallel.ulysses import ulysses_attention_sharded
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh

TIMEOUT = 120.0


def spawn(tmp_path, fn, world, *args):
    return tmesh.spawn_ranks(fn, world, backend="gloo", timeout=TIMEOUT,
                             store_dir=str(tmp_path), args=args)


def jax_mesh(sp=1, tp=1):
    n = sp * tp
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, sp=sp, tp=tp),
                           devices=jax.devices()[:n])


def _qkv(seed=0, b=1, h=8, s=256, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_matches_jax(tmp_path, sp):
    q, k, v = _qkv()
    ref = np.asarray(ulysses_attention_sharded(jax_mesh(sp=sp), q, k, v,
                                               attn_mode="xla"))
    outs = spawn(tmp_path, workers.seq_attention, sp, "ulysses", q, k, v)
    for out in outs:   # every rank holds the joined result
        np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax(tmp_path, sp):
    q, k, v = _qkv(seed=1)
    ref = np.asarray(ring_attention_sharded(jax_mesh(sp=sp), q, k, v))
    outs = spawn(tmp_path, workers.seq_attention, sp, "ring", q, k, v)
    for out in outs:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_ulysses_local_layout_is_jax_layout():
    """The exchange's reshapes on one process: chunks arrive in rank
    order before the local sequence axis (``tiled=False``), so that
    heads_to_seq then seq_to_heads is the identity and the gathered
    sequence is globally ordered."""
    import torch

    from ltx_video_gpupoor_tpu_torch.parallel import ulysses

    p, b, h, s, d = 2, 1, 4, 6, 3
    x = torch.arange(p * b * h * s * d, dtype=torch.float32).reshape(
        p, b, h, s, d)          # rank r's [B, H, S/p, D]

    def a2a(xs_by_rank):        # all_to_all over a list of [p, ...]
        return [torch.stack([xs_by_rank[j][r] for j in range(p)])
                for r in range(p)]
    sent = [x[r].reshape(b, p, h // p, s, d).transpose(0, 1)
            for r in range(p)]
    got = a2a(sent)
    hs = [g.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * s, d) for g in got]
    whole = torch.cat([x[r] for r in range(p)], dim=2)   # [B, H, S, D]
    for r in range(p):
        assert torch.equal(hs[r], whole[:, r * h // p:(r + 1) * h // p])
    back = a2a([hh.reshape(b, h // p, p, s, d).permute(2, 0, 1, 3, 4)
                for hh in hs])
    for r in range(p):
        assert torch.equal(back[r].transpose(0, 1).reshape(b, h, s, d), x[r])
    assert ulysses._heads_to_seq.__doc__ and ulysses._seq_to_heads.__doc__


@pytest.mark.parametrize("spec,world,want", [
    ("dp1,sp2,tp1", 2, {"dp": 1, "sp": 2, "tp": 1}),
    ("sp=2,tp=2", 4, {"dp": 1, "sp": 2, "tp": 2}),
    ("auto", 2, {"dp": 1, "sp": 1, "tp": 2}),
])
def test_mesh_from_env(tmp_path, spec, world, want):
    outs = spawn(tmp_path, workers.mesh_env, world, spec)
    coords = set()
    for shape, rank_coords in outs:
        assert shape == want
        coords.add(tuple(rank_coords[a] for a in ("dp", "sp", "tp")))
    assert len(coords) == world           # every rank its own place


@pytest.mark.parametrize("spec", ["dp1,sp4,tp1", "sp3", "off", ""])
def test_mesh_from_env_mis_sized_or_off_serves_one_device(tmp_path, spec):
    """A spec the world cannot satisfy logs one warning and returns None
    (serve on one device), as JAX's does; off/unset is None silently."""
    outs = spawn(tmp_path, workers.mesh_env, 2, spec)
    assert outs == [None, None]


def test_mesh_from_env_warns_once_on_mis_sized(monkeypatch, caplog):
    monkeypatch.setenv("LTXV_TPU_MESH", "dp1,sp4,tp1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with caplog.at_level("WARNING"):
        assert tmesh.mesh_from_env() is None
    warned = [r for r in caplog.records if "LTXV_TPU_MESH" in r.getMessage()]
    assert len(warned) == 1 and "single-device" in warned[0].getMessage()


@pytest.mark.parametrize("spec", ["dp2,sp2,tp2", "sp=4,tp=2", "auto", "off",
                                  "", "dp1,sp-1", "tp8"])
def test_parse_mesh_spec_matches_jax(spec):
    got = tmesh.parse_mesh_spec(spec)
    want = jmesh.parse_mesh_spec(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.dp, got.sp, got.tp) == (want.dp, want.sp, want.tp)
        for n in (8, 16):
            try:
                w = want.resolve(n)
            except ValueError:
                with pytest.raises(ValueError):
                    got.resolve(n)
            else:
                assert got.resolve(n) == w


@pytest.mark.parametrize("spec", ["xx2", "sp", "dp1,qq2"])
def test_parse_mesh_spec_rejects_like_jax(spec):
    with pytest.raises(ValueError):
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError):
        tmesh.parse_mesh_spec(spec)


def test_a_failing_rank_fails_within_the_deadline(tmp_path):
    """A rank that raises while the other waits in a collective: the
    launcher kills the group and re-raises the failed rank's traceback
    long before the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(tmesh.RankError, match="planted failure on rank 1"):
        spawn(tmp_path, workers.raise_on, 2, 1)
    assert time.monotonic() - t0 < 60.0


def test_no_mesh_without_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(tmesh.MeshConfig(sp=1, tp=1))
    with pytest.raises(RuntimeError, match="no active mesh"):
        tmesh.active_mesh()


def _request_body():
    import base64
    import io

    from PIL import Image

    image = np.random.default_rng(0).integers(0, 255, (64, 64, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return {"image": base64.b64encode(buf.getvalue()).decode(),
            "prompt": "a fox", "negative_prompt": "blurry", "height": 64,
            "width": 64, "num_frames": 9, "frame_rate": 8,
            "num_inference_steps": 2, "creation_id": "mesh"}


def test_served_request_on_two_ranks(tmp_path):
    """``POST /`` on rank 0 of an sp = 2 mesh: the follower runs the same
    request (the warm-up off: ``test_warmup_on_two_ranks`` has it) and
    the video lands; a
    follower's error in the next request reaches rank 0's answer as a 500
    naming the rank (rank 0 itself gives up in a collective at the group's
    timeout, 20 s here), and the next request is refused with that error
    instead of hanging: the failed follower has left."""
    out = tmp_path / "outputs"
    out.mkdir()
    t0 = time.monotonic()
    rank0, follower = tmesh.spawn_ranks(
        workers.served_request, 2, backend="gloo", timeout=20.0,
        store_dir=str(tmp_path), args=(str(out), _request_body(), 1))
    (first, second, third), landed = rank0
    assert first[0] == 200 and first[1][0]["video"].endswith(".mp4")
    assert landed
    assert second[0] == 500
    assert "rank 1: RuntimeError: planted follower failure on 1" in \
        second[1][0]["error"]
    assert third[0] == 500 and "restart" in third[1][0]["error"]
    assert follower == 2
    assert time.monotonic() - t0 < 90.0


@pytest.mark.parametrize("spec,fail", [("64x64x9", False),
                                       ("64x64x9", True), ("off", False)],
                         ids=["warm", "follower_fails", "off"])
def test_warmup_on_two_ranks(tmp_path, spec, fail):
    """JAX's warm-up on a mesh: rank 0's warm-up thread hands each bucket
    to the follower through the channel, so the follower runs the 1-step
    generation and then the request; a follower that fails its warm-up
    breaks the group (logged, ``warmup_failed``), and the first request
    answers 500 naming the rank instead of hanging; ``off`` starts
    nothing and the follower runs the request alone."""
    out = tmp_path / "outputs"
    out.mkdir()
    t0 = time.monotonic()
    (started, counters, answer), ran = tmesh.spawn_ranks(
        workers.served_warmup, 2, backend="gloo", timeout=20.0,
        store_dir=str(tmp_path), args=(str(out), _request_body(), spec,
                                       fail))
    assert time.monotonic() - t0 < 90.0
    if spec == "off":
        assert not started and counters == {}
        assert answer[0] == 200 and ran == ["request"]
        return
    assert started
    if not fail:
        assert counters == {"warmup_ok": 1.0}
        assert answer[0] == 200 and answer[1][0]["video"].endswith(".mp4")
        assert ran == [("warmup", (64, 64, 9)), "request"]
        return
    assert counters == {"warmup_failed": 1.0}
    assert answer[0] == 500
    assert "rank 1: RuntimeError: planted warm-up failure on 1" in \
        answer[1][0]["error"]
    assert ran == [("warmup", (64, 64, 9))]


def test_cli_on_two_ranks(tmp_path):
    """``cli.main`` under ``LTXV_TPU_MESH`` on 2 ranks (as ``torchrun``
    starts it): every rank takes the mesh and runs the request, rank 0
    writes the video, the other returns None."""
    out = str(tmp_path / "vid.mp4")
    (got0, seen0), (got1, seen1) = spawn(tmp_path, workers.cli_on_ranks, 2,
                                         out)
    assert got0 == out and got1 is None
    assert seen0 == seen1 == [True]
    assert (tmp_path / "vid.mp4").stat().st_size > 0
