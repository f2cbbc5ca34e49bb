"""K8, the sub-block-pipelined attention tool: the port's plain version
against the JAX tool's Pallas kernel run in interpret mode.

``tools/mb_selfattn_pipeline.py`` of the JAX package has no ``interpret``
switch and imports ``_bench_util`` from its own directory, so the test puts
``tools/`` on ``sys.path`` and hands ``pl.pallas_call`` an ``interpret=True``
for the duration of one call. Same numpy inputs from a seed on both sides,
B=1 H=2 S=256 D=64, blocks of 128, ``nsub`` 1 and 4.

Tolerance: both sides round q once, take the running max per sub-block,
round p to bf16 before the product and sum the rounded p; what differs is
the order of the fp32 sums and ``exp2``'s last bit, which can move a bf16
p, and with it the bf16 output, by an ulp. So: every element within two
bf16 ulps of the JAX output (2**-7 relative) plus 2**-9 of the largest
output, the bound ``chip_smoke.py`` holds the CUDA kernel to.
"""

import functools
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ltx_video_gpupoor_tpu_torch.ops.flash_attention import reference_attention
from ltx_video_gpupoor_tpu_torch.tools import _bench_util
from ltx_video_gpupoor_tpu_torch.tools import mb_selfattn_pipeline as tmb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import mb_selfattn_pipeline as jmb  # noqa: E402  (the JAX tool, by its dir)

torch.set_num_threads(2)


def _inputs(seed, shape=(1, 2, 256, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _bound(ref):
    return np.abs(ref) * 2.0 ** -7 + np.abs(ref).max() * 2.0 ** -9


@pytest.mark.parametrize("nsub", [1, 4])
def test_pipelined_plain_matches_jax_kernel_interpreted(monkeypatch, nsub):
    q, k, v = _inputs(0)
    monkeypatch.setattr(jmb.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    ref = np.asarray(jmb.pipelined_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
        block_q=128, block_kv=128, nsub=nsub), np.float32)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    # the wrapper, which on CPU tensors is the plain version
    out = tmb.pipelined_attention(tq, tk, tv, block_kv=128, nsub=nsub)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    diff = np.abs(out.float().numpy() - ref)
    assert (diff <= _bound(ref)).all(), float((diff / _bound(ref)).max())
    # and both are attention: 2e-2 from the exact fp32 one
    exact = reference_attention(tq.float(), tk.float(), tv.float()).numpy()
    assert np.abs(ref - exact).max() < 2e-2
    assert np.abs(out.float().numpy() - exact).max() < 2e-2
    assert tmb.pipelined_attention.launches == 0      # no kernel on the CPU


def test_pipelined_plain_matches_jax_kernel_at_a_ragged_q_tile(monkeypatch):
    """S = 320 with 64-row kv tiles: the card kernel's 128-row q tile is
    ragged there, the wrapper takes it (S a multiple of the kv tile), and
    the plain version agrees with the JAX kernel run on 64-row q blocks."""
    q, k, v = _inputs(3, (1, 2, 320, 64))
    monkeypatch.setattr(jmb.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    ref = np.asarray(jmb.pipelined_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
        block_q=64, block_kv=64, nsub=2), np.float32)
    out = tmb.pipelined_attention(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), block_kv=64,
        nsub=2)
    diff = np.abs(out.float().numpy() - ref)
    assert (diff <= _bound(ref)).all(), float((diff / _bound(ref)).max())


def test_pipelined_plain_steps_by_the_sub_block():
    """The math depends on the sub-block alone: (128, 4) and (64, 2) both
    step by 32 rows and agree bit for bit; (128, 1) takes its max over 128
    rows at once and may round a p the other way."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _inputs(1))
    a = tmb.pipelined_attention_plain(q, k, v, block_kv=128, nsub=4)
    b = tmb.pipelined_attention_plain(q, k, v, block_kv=64, nsub=2)
    assert torch.equal(a, b)
    c = tmb.pipelined_attention_plain(q, k, v, block_kv=128, nsub=1)
    ref = c.float().numpy()
    assert (np.abs(a.float().numpy() - ref) <= _bound(ref)).all()


def test_pipelined_wrapper_rejects_what_it_does_not_take():
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _inputs(2))
    with pytest.raises(ValueError, match="multiple of the kv tile"):
        tmb.pipelined_attention(q[:, :, :200], k[:, :, :200], v[:, :, :200])
    with pytest.raises(ValueError, match="head dim 64"):
        tmb.pipelined_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="built for"):
        tmb.pipelined_attention(q, k, v, block_kv=64, nsub=8)
    with pytest.raises(ValueError, match="share one"):
        tmb.pipelined_attention(q, k[:, :, :128], v)


def test_tool_main_runs_its_check_on_the_cpu(capsys):
    """``main`` on the CPU runs the check at the small shape (the timings
    need the card); the error is that of bf16 attention."""
    result = tmb.main(["--device", "cpu"])
    assert result["production_ms"] is None and result["pipelined_ms"] == {}
    assert 0 < result["err"] < 2e-2
    assert tmb.SMALL == (1, 2, 1344) and (tmb.B, tmb.H, tmb.S, tmb.D) == (
        jmb.B, jmb.H, jmb.S, jmb.D)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmb.main([])
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            _bench_util.cuda_time_ms(lambda: None)


def test_kernel_times_names_the_shapes_it_times_and_needs_the_card():
    """``tools/kernel_times.py`` times K1f and K5's row kernel at the
    served shapes through the wrappers' public entry points only (so that
    it runs in an older checkout too); without a card it refuses."""
    from ltx_video_gpupoor_tpu_torch.tools import kernel_times as kt

    assert [s[0] for s in kt.K1F_SHAPES][:3] == [
        "K1f LTX-2B self", "K1f LTX-2B cross", "K1f request self"]
    assert {s[1:3] for s in kt.K5_SHAPES} == {(3840, 4096), (15360, 4096)}
    q_seg, kv_seg = kt._segments(2, 5, 256, torch.device("cpu"))
    assert q_seg.tolist() == [[1] * 5] * 2
    assert kv_seg.sum().item() == 400
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            kt.main([])


def test_port_and_chip_smoke_name_no_jax_import():
    """No source of the port, nor ``chip_smoke.py``, imports jax or the
    JAX package (``tests/test_torch_configs.py`` also imports every module
    in a fresh interpreter and looks at ``sys.modules``)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ltx_video_gpupoor_tpu)\b(?!_)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "ltx_video_gpupoor_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
