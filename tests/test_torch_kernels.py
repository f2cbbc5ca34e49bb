"""Kernels K1 (attention), K2 (dynamic int8), K3 (bounded-score
attention), K4 (int8 attention), K5 (fused adaLN prologue + int8 linear)
and K6 (head-packed attention) against the JAX package.

On the CPU the wrappers take their plain versions; those are held against
the JAX functions the Pallas kernels are held against in
tests/test_flash_attention.py and tests/test_int8_matmul.py, at the same
tolerances: 2e-5 for fp32 attention, 2e-2 for the int8 linear. K4's plain
version is held against the JAX int8 tiers run in interpret mode at 1e-5
(it computes the same int8 codes and the same exponent, exp(ln2 * x),
but torch's exp and XLA's differ by up to 2 ulps, so a p that lies that
close to a half rounds to the next int8 code on one side: such a row,
about one in 2000 here, moves by one code's weight, under 5e-3), and
against exact attention at the tiers' 3e-2 on the inputs of the JAX tier
tests. That bound is a maximum over samples that the tiers' own math
exceeds on other draws (0.05 at worst in 12 draws of 6 heads), so on
other inputs the check against exact attention is a mean abs error under
3e-3 (the tiers sit near 1.6e-3). K3's and K6's plain versions are held
against the interpreted Pallas kernels at the fp32 attention tolerance.
K5's plain version is held bit for bit (bf16) against the interpreted
Pallas kernel compiled with ``xla_allow_excess_precision`` off: XLA's CPU
default keeps the last bf16 sum of the modulation in fp32, which neither
the JAX kernel's dtypes nor the TPU say; against the default compile the
bar is the JAX package's own 5e-2. The CUDA kernels themselves
are compared with the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.ops import attention as jattn
from ltx_video_gpupoor_tpu.ops import flash_attention as jfa
from ltx_video_gpupoor_tpu.ops import fused_prologue as jfp
from ltx_video_gpupoor_tpu.ops import int8_matmul as jim
from ltx_video_gpupoor_tpu.ops import quant as jq
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn
from ltx_video_gpupoor_tpu_torch.ops import flash_attention as tfa
from ltx_video_gpupoor_tpu_torch.ops import fused_prologue as tfp
from ltx_video_gpupoor_tpu_torch.ops import int8_matmul as tim
from ltx_video_gpupoor_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

ATOL = RTOL = 2e-5          # tests/test_flash_attention.py:26
INT8_TOL = 2e-2             # tests/test_int8_matmul.py:28-47
K4_ATOL = 1e-5              # K4's plain version against the interpreted tier
K4_FLIP_SHARE = 1e-3        # ... except rows where a p code rounds apart:
K4_FLIP_ATOL = 5e-3         # at most this share of elements, by this much
K4_EXACT_TOL = 3e-2         # tests/test_flash_attention.py:144-226
K4_EXACT_MEAN = 3e-3        # mean abs error against exact attention


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain versions here run on the calling thread alone. Under load
    (five more pytest workers), the first ``torch.exp`` that a freshly
    started intra-op worker thread computes can come out about 4e-5
    relative off on that thread's share of the tensor (the second half of
    K1's scores at two threads, seen in 4 of 36 fresh processes; a second
    call, or one thread, is right every time), which moved 29 outputs of
    ``test_k1_plain_matches_pallas_interpret[128-128]`` past 2e-5 when it
    was a worker's first test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv", [(128, 128), (256, 384)])
def test_k1_plain_matches_pallas_interpret(sq, skv):
    q, k, v = _qkv(0, 2, 2, sq, skv, 64)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              interpret=True)
    out = tfa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_k1_plain_segments_and_fully_masked_rows():
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _qkv(1, b, h, s, s, d)
    seg = np.zeros((b, s), np.int32)
    seg[0, :200] = 1
    seg[1, :100] = 1
    seg[1, 100:180] = 2
    ref = jfa.reference_attention(*map(jnp.asarray, (q, k, v, seg, seg)))
    pal = jfa.flash_attention(*map(jnp.asarray, (q, k, v, seg, seg)),
                              interpret=True)
    out = tfa.flash_attention(*_t(q, k, v, seg, seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL,
                               rtol=RTOL)
    # padding rows see no key: exactly zero, not NaN
    np.testing.assert_array_equal(out[0, :, 200:].numpy(), 0.0)


def test_k1_plain_cross_attention_kv_mask():
    """The DiT's cross-attention: q ids all 1, kv ids from the T5 mask."""
    b, h, sq, skv, d = 2, 2, 300, 77, 32
    q, k, v = _qkv(2, b, h, sq, skv, d)
    q_seg = np.ones((b, sq), np.int32)
    q_seg[1, 10] = 3           # a row that matches no key
    kv_seg = np.ones((b, skv), np.int32)
    kv_seg[0, 50:] = 0
    ref = jfa.reference_attention(*map(jnp.asarray,
                                       (q, k, v, q_seg, kv_seg)))
    out = tattn.attention(*_t(q, k, v, q_seg, kv_seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(out[1, :, 10].numpy(), 0.0)


def test_k1_plain_causal_and_kv_valid():
    b, h, s, d = 1, 2, 384, 64
    q, k, v = _qkv(3, b, h, s, s, d)
    jq_, jk, jv = map(jnp.asarray, (q, k, v))
    ref = jfa.flash_attention(jq_, jk, jv, causal=True, interpret=True)
    out = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    ref = jfa.flash_attention(jq_, jk, jv, kv_valid=300, block_q=128,
                              block_kv=128, causal=True, interpret=True)
    out = tfa.flash_attention(*_t(q, k, v), kv_valid=300, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _pad_rows(x, axis, multiple=128, keep=None):
    """Zero rows up to a 128 multiple, as the JAX dispatch pads; ``keep``
    first cuts the rows past the 128 multiple that holds ``keep`` of them
    (the Pallas kernels mask a ``kv_valid`` tail in the last block only;
    rows that no query sees change nothing)."""
    if keep is not None:
        x = np.take(x, range(min(x.shape[axis], -(-keep // multiple)
                                 * multiple)), axis=axis)
    pad = -x.shape[axis] % multiple
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


# (Sq, Skv, kv_valid): each edge of the CUDA block's 128-row tiles
K1_TILE_EDGES = [
    (127, 255, None), (128, 256, None), (129, 257, None), (383, 128, None),
    (130, 1, None),
    (256, 512, 500),       # kv_valid inside the last tile
    (256, 512, 384),       # at a tile edge
    (256, 512, 300),       # a whole tile short
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,kv_valid", K1_TILE_EDGES)
def test_k1_plain_matches_pallas_interpret_at_tile_edges(sq, skv, kv_valid, d):
    """K1's plain version at the shapes that land on each mask kind and
    tile edge of the CUDA block, against the interpreted Pallas kernel fed
    as the JAX dispatch feeds it (zero rows up to a 128 multiple, the real
    length as ``kv_valid``); fp32, atol = rtol = 2e-5."""
    q, k, v = _qkv(40 + sq, 1, 2, sq, skv, d)
    valid = skv if kv_valid is None else min(skv, kv_valid)
    ref = jfa.flash_attention(
        jnp.asarray(_pad_rows(q, 2)),
        *(jnp.asarray(_pad_rows(a, 2, keep=valid)) for a in (k, v)),
        kv_valid=valid, block_q=128, block_kv=128, interpret=True)[:, :, :sq]
    out = tfa.flash_attention(*_t(q, k, v), kv_valid=kv_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_k1_plain_sees_no_key_with_kv_valid_zero():
    q, k, v = _qkv(5, 1, 2, 130, 130, 64)
    out = tfa.flash_attention(*_t(q, k, v), kv_valid=0)
    np.testing.assert_array_equal(out.numpy(), 0.0)


@pytest.mark.parametrize("name,skv,kv_valid,segments,causal,kind", [
    # the three models' calls (tokens of one stream; text of 256 or 512)
    ("LTX-2B self, 704x480x121", 5280, None, False, False, "tail"),
    ("LTX-2B cross", 256, None, True, False, "general"),
    ("LTX-13B pass 1 self", 3840, None, False, False, "none"),
    ("LTX-13B pass 2 self", 15360, None, False, False, "none"),
    ("LTX-13B cross", 256, None, True, False, "general"),
    ("Wan self, 832x480x81", 32760, None, False, False, "tail"),
    ("LTX-2B self, 256x256x9", 128, None, False, False, "none"),
    # K6: no mask but the static tail
    ("K6 without kv_valid", 15360, None, False, False, "none"),
    ("K6 kv_valid inside a tile", 3840, 3800, False, False, "tail"),
    ("K6 kv_valid at a tile edge", 3840, 3712, False, False, "none"),
    ("K6 kv_valid past the end", 3840, 5000, False, False, "none"),
    # edges
    ("ragged", 1000, None, False, False, "tail"),
    ("ragged, kv_valid at a tile edge", 1000, 896, False, False, "none"),
    ("one key", 1, None, False, False, "tail"),
    ("no key in sight", 512, 0, False, False, "none"),
    ("causal", 512, None, False, True, "general"),
    ("causal, ragged", 333, None, False, True, "general"),
    ("segments and kv_valid", 512, 300, True, False, "general"),
])
def test_k1_mask_kind_of_a_call(name, skv, kv_valid, segments, causal, kind):
    """The host-side choice of the block's instance: no mask code, the
    column compare in the last kv tile only, or the general masks."""
    assert tfa.mask_kind(skv, kv_valid, segments=segments,
                         causal=causal) == kind
    assert kind in tfa.MASK_KINDS
    # "none" is only ever chosen where no score needs masking
    if kind == "none":
        end = skv if kv_valid is None else min(skv, kv_valid)
        assert end % tfa.K1_TILE_KV == 0 and not segments and not causal


def test_attention_packed_matches_jax():
    from ltx_video_gpupoor_tpu.ops.attention import attention_packed

    rng = np.random.default_rng(4)
    b, s, heads, d = 2, 200, 4, 64
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
               for _ in range(3))
    ref = attention_packed(*map(jnp.asarray, (q, k, v)), heads, mode="xla")
    out = tattn.attention_packed(*_t(q, k, v), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mode,entry", [
    ("pallas_hp", "K6"), ("ulysses:sp", "step 15"),
    ("xla", "reference_attention")])
def test_unported_attention_tiers_raise(monkeypatch, mode, entry):
    """``ulysses:`` raises with its ROADMAP step. ``xla`` runs the plain
    fp32 attention (``reference_attention``) and no kernel, for head-split
    and head-packed callers alike. ``pallas_hp`` (K6) is ported:
    head-split callers get the exact kernel and packed callers the
    head-packed one; a ``score_bound`` (K3) goes to the exact kernel's
    bounded tier."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, score_bound=None, **k: calls.append(
                            ("K1" if score_bound is None else "K3")))
    monkeypatch.setattr(tattn, "flash_attention_hp",
                        lambda *a, **k: calls.append("K6"))
    monkeypatch.setattr(tattn, "flash_attention_int8",
                        lambda *a, **k: calls.append("K4"))
    monkeypatch.setattr(tattn, "reference_attention",
                        lambda *a, **k: calls.append("reference_attention")
                        or a[0])
    q = torch.zeros(1, 1, 8, 64)
    if mode == "ulysses:sp":
        with pytest.raises(NotImplementedError, match=entry):
            tattn.attention(q, q, q, mode=mode)
    else:
        tattn.attention(q, q, q, mode=mode)
        tattn.attention(q, q, q, mode=mode, score_bound=40.0)
        tattn.attention_packed(torch.zeros(1, 8, 128), torch.zeros(1, 8, 128),
                               torch.zeros(1, 8, 128), 2, mode=mode)
        assert calls == (["K1", "K3", "K6"] if mode == "pallas_hp"
                         else [entry, entry, entry])
    calls.clear()
    tattn.attention(q, q, q, score_bound=40.0)
    assert calls == ["K3"]


@pytest.mark.parametrize("seg,causal,bound", [(False, False, None),
                                              (True, False, 40.0),
                                              (False, True, None)])
def test_xla_tier_matches_jax(monkeypatch, seg, causal, bound):
    """``xla`` is JAX's ``reference_attention`` on either side, through
    ``attention`` (segments, causal; a ``score_bound`` is ignored there),
    ``attention_packed``, ``set_attention_mode`` and ``LTXV_TPU_ATTN``."""
    import importlib

    q, k, v = _qkv(21, 2, 3, 200, 130 if seg else 200, 64)
    segs = ()
    if seg:
        q_seg = np.ones((2, 200), np.int32)
        q_seg[1, 9] = 4                    # a row that matches no key
        kv_seg = np.ones((2, 130), np.int32)
        kv_seg[0, 70:] = 0
        segs = (q_seg, kv_seg)
    kw = dict(causal=causal, score_bound=bound)
    ref = jattn.attention(*map(jnp.asarray, (q, k, v) + segs), mode="xla",
                          **kw)
    out = tattn.attention(*_t(q, k, v, *segs), mode="xla", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if seg:
        np.testing.assert_array_equal(out[1, :, 9].numpy(), 0.0)
    b, s, heads, d = 2, 200, 3, 64
    qp, kp, vp = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
        b, s, heads * d) for x in _qkv(22, b, heads, s, s, d))
    ref = jattn.attention_packed(*map(jnp.asarray, (qp, kp, vp)), heads,
                                 mode="xla")
    try:
        tattn.set_attention_mode("xla")
        assert tattn.resolve_mode("auto", 40.0, head_dim=128) == "xla"
        out = tattn.attention_packed(*_t(qp, kp, vp), heads)
    finally:
        tattn.set_attention_mode("auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    monkeypatch.setenv("LTXV_TPU_ATTN", "xla")
    fresh = importlib.reload(tattn)
    try:
        assert fresh.get_attention_mode() == "xla"
    finally:
        monkeypatch.delenv("LTXV_TPU_ATTN")
        importlib.reload(tattn)
    assert tattn.get_attention_mode() == "auto"


@pytest.mark.parametrize("head_dim", [None, 32, 64, 80, 128, 256])
def test_auto_tier_matches_jax_tpu_policy(monkeypatch, head_dim):
    """``auto`` resolves as the JAX package resolves it on the TPU: exact
    (K1) at head dims up to 64, the int8 QK+PV tier (K4) above and for an
    unknown head dim, the exact kernel (its bounded tier, K3) whenever a
    ``score_bound`` is given; explicit tiers stay as given, bound or not
    (``tests/test_flash_attention.py:308-322``)."""
    monkeypatch.setattr(jattn, "_default_backend_is_tpu", lambda: True)
    monkeypatch.setattr(jattn, "_FORCED_MODE", "auto")
    for bound in (None, 40.0):
        assert tattn.resolve_mode("auto", bound, head_dim) == \
            jattn.resolve_mode("auto", bound, head_dim)
        for mode in ("pallas", "pallas_hp", "pallas_int8", "pallas_int8pv"):
            assert tattn.resolve_mode(mode, bound, head_dim) == \
                jattn.resolve_mode(mode, bound, head_dim) == mode
    assert tattn.resolve_mode("auto", 40.0, head_dim) == "pallas"


@pytest.mark.parametrize("mode,d,tier", [
    ("auto", 64, "K1"), ("auto", 128, "K4pv"), ("pallas", 128, "K1"),
    ("pallas_int8", 64, "K4qk"), ("pallas_int8pv", 64, "K4pv")])
def test_attention_dispatches_by_tier(monkeypatch, mode, d, tier):
    """``attention`` reaches the tier ``resolve_mode`` names; an explicit
    ``pallas_int8pv`` drops a score bound (as in JAX), ``auto`` and
    ``pallas`` with a bound reach the bounded tier (K3), and
    ``pallas_int8`` with a bound the int8 Q.K^T bounded tier (K3q), the
    bound passed through."""
    calls = []
    monkeypatch.setattr(
        tattn, "flash_attention",
        lambda *a, score_bound=None, **k: calls.append(
            "K1" if score_bound is None else f"K3:{score_bound}"))

    def int8(*a, pv_int8, score_bound=None, **k):
        if score_bound is not None:
            assert not pv_int8
            calls.append(f"K3q:{score_bound}")
        else:
            calls.append("K4pv" if pv_int8 else "K4qk")

    monkeypatch.setattr(tattn, "flash_attention_int8", int8)
    q = torch.zeros(1, 1, 8, d)
    tattn.attention(q, q, q, mode=mode)
    assert calls == [tier]
    if mode == "pallas_int8pv":
        tattn.attention(q, q, q, mode=mode, score_bound=40.0)
        assert calls == [tier, tier]
    elif mode == "pallas_int8":
        tattn.attention(q, q, q, mode=mode, score_bound=40.0)
        assert calls == [tier, "K3q:40.0"]
    else:
        tattn.attention(q, q, q, mode=mode, score_bound=40.0)
        assert calls == [tier, "K3:40.0"]


def test_k1_rejects_kv_only_segments():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_attention(q, q, q, None, torch.ones(1, 8, dtype=torch.int32))


# --------------------------------------------------------------------------
# K3: the bounded-score tier
# --------------------------------------------------------------------------

def _bounded_segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[0, :200] = 1
    seg[1, :100] = 1
    seg[1, 100:] = 2
    return seg


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["plain", "kv_valid", "segments"])
def test_k3_plain_matches_pallas_interpret(d, case):
    """``flash_attention(score_bound=32)`` against the interpreted Pallas
    kernel's bounded branch and against exact attention, on the inputs of
    tests/test_flash_attention.py:106-130. At d=64 both denominators sum
    the p that meets V (fp32 here, so the same numbers)."""
    b, h, s = 2, 2, 384
    q, k, v = _qkv(7, b, h, s, s, d)
    seg = _bounded_segments(b, s) if case == "segments" else None
    kv_valid = 300 if case == "kv_valid" else None
    segs = () if seg is None else (seg, seg)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v) + segs),
                              kv_valid=kv_valid, score_bound=32.0,
                              block_q=128, block_kv=128, interpret=True)
    out = tfa.flash_attention(*_t(q, k, v, *segs), kv_valid=kv_valid,
                              score_bound=32.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    exact = tfa.reference_attention(*_t(q, k, v, *segs), kv_valid=kv_valid)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=ATOL,
                               rtol=RTOL)
    if case == "segments":      # rows whose segment id is 0 see no key
        np.testing.assert_array_equal(out[0, :, 200:].numpy(), 0.0)


@pytest.mark.parametrize("d", [64, 128])
def test_k3_plain_bf16_denominator_and_scores_over_the_bound(d):
    """bf16 operands: at d=64 the denominator sums the bf16-rounded p (the
    ones column of the JAX kernel), at d=128 the fp32 p; and logits far
    beyond the bound stay finite, tied at the bound
    (tests/test_flash_attention.py:133). Tolerance: one bf16 ulp of
    outputs below 4."""
    b, h, s = 1, 2, 256
    q, k, v = _qkv(8, b, h, s, s, d)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    ref = jfa.flash_attention(*jb, score_bound=32.0, block_q=128,
                              block_kv=128, interpret=True)
    out = tfa.flash_attention(*tb, score_bound=32.0)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2 ** -7, rtol=2 ** -7)
    big = [a * 100.0 for a in (q, k)] + [v]
    ref = jfa.flash_attention(*map(jnp.asarray, big), score_bound=32.0,
                              block_q=128, block_kv=128, interpret=True)
    out = tfa.flash_attention(*_t(*big), score_bound=32.0)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_k3_int8pv_with_a_bound_keeps_the_running_max():
    """JAX's kernel refuses ``pv_int8`` with a bound
    (ops/flash_attention.py:477-483) and its dispatch drops the bound
    under ``pallas_int8pv``; the port's dispatch does the same."""
    q, k, v = _qkv(9, 1, 2, 128, 128, 128)
    with pytest.raises(ValueError, match="pv_int8"):
        jfa.flash_attention(*map(jnp.asarray, (q, k, v)), score_bound=20.0,
                            qk_int8=True, pv_int8=True, interpret=True)
    a = tattn.attention(*_t(q, k, v), mode="pallas_int8pv", score_bound=20.0)
    b_ = tattn.attention(*_t(q, k, v), mode="pallas_int8pv")
    assert torch.equal(a, b_)


# --------------------------------------------------------------------------
# K3q: int8 Q.K^T under the bounded softmax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["none", "kv_tail", "segments", "causal"])
def test_k3q_plain_matches_pallas_interpret(monkeypatch, d, case):
    """``attention(mode="pallas_int8", score_bound=20)`` against JAX's
    ``attention`` in the same mode, whose Pallas kernel runs its int8
    Q.K^T branch (per-row k scales) into the bounded ``_update`` in
    interpret mode (JAX pads to 128 rows and masks the kv tail with
    ``kv_valid``; the port masks its own edge). One q row is scaled so
    that its scores lie over the bound; with segments one q row sees no
    key and returns 0. Both compute the same int8 codes and the same
    exponent; tolerance 2e-5, the fp32 attention tolerance."""
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))
    sq, skv = (300, 300) if case == "kv_tail" else (256, 384)
    if case == "causal":
        skv = sq
    q, k, v = _qkv(31, 2, 2, sq, skv, d)
    q[0, 1, 7] *= 30.0
    segs = ()
    if case == "segments":
        q_seg = np.ones((2, sq), np.int32)
        q_seg[1, 4] = 3                    # a row that matches no key
        kv_seg = np.ones((2, skv), np.int32)
        kv_seg[0, 200:] = 0                # padded text
        segs = (q_seg, kv_seg)
    kw = dict(mode="pallas_int8", score_bound=20.0, causal=case == "causal")
    ref = jattn.attention(*map(jnp.asarray, (q, k, v) + segs), **kw)
    out = tattn.attention(*_t(q, k, v, *segs), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if segs:
        np.testing.assert_array_equal(out[1, :, 4].numpy(), 0.0)
    # in the rows whose scores stay under the bound it is the int8 QK
    # tier's attention (softmax does not see the offset)
    qk = tattn.attention(*_t(q, k, v, *segs), mode="pallas_int8",
                         causal=case == "causal")
    under = np.ones(out.shape[:3], bool)
    under[0, 1, 7] = False
    np.testing.assert_allclose(out.numpy()[under], qk.numpy()[under],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_k3q_plain_bf16_denominator_and_any_kv_step(d):
    """bf16 operands: at d=64 the denominator sums the bf16-rounded p (JAX
    reads it off a ones column of V), at d=128 the fp32 p; against the
    interpreted kernel at one bf16 ulp of outputs below 4 (as K3's bf16
    test). With per-row k scales and no running max the result does not
    depend on the kv step: stepped by K4's 128-row tile (the kernel's) it
    agrees with JAX's block to fp32 summation order (1e-6)."""
    b, h, s = 1, 2, 384
    q, k, v = _qkv(32, b, h, s, s, d)
    q[0, 0, 3] *= 40.0
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    ref = jfa.flash_attention(*jb, qk_int8=True, score_bound=24.0,
                              block_q=128, block_kv=128, interpret=True)
    out = tfa.flash_attention_int8(*tb, pv_int8=False, score_bound=24.0)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2 ** -7, rtol=2 ** -7)
    ops = tfa.int8_prologue(*_t(q, k, v), pv_int8=False)
    assert ops.kv_block == s and ops.k_block == 1
    whole = tfa.int8_attention_plain(ops, score_bound=24.0)
    tiled = tfa.int8_attention_plain(ops, score_bound=24.0,
                                     block_kv=tfa.K4_TILE_KV)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_k3q_refuses_int8_p_under_a_bound():
    """JAX's kernel refuses ``pv_int8`` with a bound (:477-483); so do the
    port's int8 entry points (the dispatch drops the bound first)."""
    q = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="pv_int8"):
        tfa.flash_attention_int8(q, q, q, score_bound=20.0)
    ops = tfa.int8_prologue(q, q, q)
    with pytest.raises(ValueError, match="pv_int8"):
        tfa.int8_attention_plain(ops, score_bound=20.0)


# --------------------------------------------------------------------------
# K6: the head-packed kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("heads,d,s,valid", [(4, 64, 384, 300),
                                             (3, 128, 256, None)])
def test_k6_plain_matches_pallas_interpret(heads, d, s, valid):
    """``flash_attention_hp`` against the interpreted Pallas kernel, paired
    (d=64, with a kv tail) and single (d=128), on the shapes of
    tests/test_flash_attention.py:397-434."""
    rng = np.random.default_rng(23)
    b = 2
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
               for _ in range(3))
    ref = jfa.flash_attention_hp(*map(jnp.asarray, (q, k, v)), heads=heads,
                                 kv_valid=valid, block_q=128, block_kv=128,
                                 interpret=True)
    out = tfa.flash_attention_hp(*_t(q, k, v), heads=heads, kv_valid=valid)
    assert out.shape == (b, s, heads * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("heads,d,s,valid", [
    (2, 64, 127, None), (2, 64, 256, None), (2, 128, 257, None),
    (3, 128, 384, 256), (2, 64, 384, 255), (2, 128, 512, 300)])
def test_k6_plain_matches_pallas_interpret_at_tile_edges(heads, d, s, valid):
    """K6's plain version at the CUDA block's tile edges against the
    interpreted Pallas kernel on zero rows up to a 128 multiple, the real
    length (or ``valid``) as its ``kv_valid``; fp32, atol = rtol = 2e-5."""
    rng = np.random.default_rng(60 + s)
    q, k, v = (rng.standard_normal((2, s, heads * d)).astype(np.float32)
               for _ in range(3))
    kv_valid = s if valid is None else valid
    ref = jfa.flash_attention_hp(
        jnp.asarray(_pad_rows(q, 1)),
        *(jnp.asarray(_pad_rows(a, 1, keep=kv_valid)) for a in (k, v)),
        heads=heads, kv_valid=kv_valid, block_q=128, block_kv=128,
        interpret=True)[:, :s]
    out = tfa.flash_attention_hp(*_t(q, k, v), heads=heads, kv_valid=valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("heads,d,bound,lengths,tier", [
    (4, 64, None, "equal", "K6"), (2, 128, None, "equal", "K6"),
    (3, 128, None, "equal", "K6"), (3, 64, None, "equal", "split"),
    (4, 32, None, "equal", "split"), (4, 64, 30.0, "equal", "split"),
    (4, 64, None, "unequal", "raise")])
def test_attention_packed_hp_gates_match_jax(monkeypatch, heads, d, bound,
                                             lengths, tier):
    """``attention_packed`` takes K6 for ``pallas_hp`` when d is 64 or 128,
    no bound is set and (d=64) the head count is even; rejects unequal
    q/kv lengths there; else splits the heads. The JAX dispatch with its
    backend patched to the TPU takes the same branch."""
    monkeypatch.setattr(jattn, "_default_backend_is_tpu", lambda: True)
    monkeypatch.setattr(jattn, "_FORCED_MODE", "auto")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jattn, "flash_attention_hp",
                        lambda q, *a, **k: jcalls.append("K6") or q)
    monkeypatch.setattr(jattn, "attention",
                        lambda q, *a, **k: jcalls.append("split") or q)
    monkeypatch.setattr(tattn, "flash_attention_hp",
                        lambda q, *a, **k: tcalls.append("K6") or q)
    monkeypatch.setattr(tattn, "attention",
                        lambda q, *a, **k: tcalls.append("split") or q)
    s, skv = 128, (128 if lengths == "equal" else 256)
    q = np.zeros((1, s, heads * d), np.float32)
    kv = np.zeros((1, skv, heads * d), np.float32)
    kw = dict(mode="pallas_hp", score_bound=bound)
    if tier == "raise":
        with pytest.raises(ValueError, match="equal length"):
            jattn.attention_packed(*map(jnp.asarray, (q, kv, kv)), heads, **kw)
        with pytest.raises(ValueError, match="equal length"):
            tattn.attention_packed(*_t(q, kv, kv), heads, **kw)
        return
    jattn.attention_packed(*map(jnp.asarray, (q, kv, kv)), heads, **kw)
    tattn.attention_packed(*_t(q, kv, kv), heads, **kw)
    assert jcalls == tcalls == [tier]


def test_k6_any_length_and_head_count():
    """The port's kernel masks its own ragged edge and takes any head
    count, so the wrapper needs neither the 128-padding nor the even head
    count of the TPU kernel."""
    rng = np.random.default_rng(24)
    b, s, heads, d = 1, 200, 3, 64
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
               for _ in range(3))
    ref = jattn.attention_packed(*map(jnp.asarray, (q, k, v)), heads,
                                 mode="xla")
    out = tfa.flash_attention_hp(*_t(q, k, v), heads=heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="64, 128"):
        tfa.flash_attention_hp(torch.zeros(1, 8, 96), torch.zeros(1, 8, 96),
                               torch.zeros(1, 8, 96), heads=3)


# --------------------------------------------------------------------------
# K5: the fused adaLN prologue + int8 linear
# --------------------------------------------------------------------------

def _k5_operands(groups, bias, m=64, k=256, n=384, dtype=np.float32):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    jw = jq.quantize_weights(jnp.asarray(w, jnp.bfloat16))
    scale = (rng.standard_normal((groups, k)) * 0.1).astype(np.float32)
    shift = (rng.standard_normal((groups, k)) * 0.1).astype(np.float32)
    b = (np.arange(n, dtype=np.float32) * 1e-3) if bias else None
    return x, scale, shift, jw, b


@pytest.mark.parametrize("groups,bias", [(1, True), (2, False), (4, True)])
def test_k5_plain_matches_pallas_interpret(groups, bias):
    """bf16, the cases of tests/test_fused_prologue.py:30 and one more
    with 4 groups: equal bit for bit to the interpreted kernel compiled
    without excess precision, except in rows whose mean of squares or
    rsqrt XLA and torch round an ulp apart (about a third of the rows;
    in about one of 50 of those a bf16 rounding of h then flips, and
    with it some int8 codes of that row): at most one row in 32 may
    differ, by one bf16 ulp of the outputs (2**-5 below 8); and within
    the JAX package's own 5e-2 of the default compile."""
    x, scale, shift, jw, b = _k5_operands(groups, bias)
    m = x.shape[0]
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16),
             jnp.asarray(shift, jnp.bfloat16), jw.w_int8, jw.scale,
             None if b is None else jnp.asarray(b))
    kw = dict(rows_per_group=m // groups, eps=1e-5, interpret=True)
    strict = jfp.norm_mod_int8_matmul.lower(*jargs, **kw).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jargs)
    default = jfp.norm_mod_int8_matmul(*jargs, **kw)
    out = tfp.norm_mod_int8_matmul(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(scale).to(torch.bfloat16),
        torch.from_numpy(shift).to(torch.bfloat16),
        torch.from_numpy(np.asarray(jw.w_int8).T.copy()),
        torch.from_numpy(np.array(jw.scale)),
        None if b is None else torch.from_numpy(b),
        rows_per_group=m // groups, eps=1e-5)
    assert out.dtype == torch.bfloat16
    o = out.float().numpy()
    s_ = np.asarray(strict.astype(jnp.float32))
    rows = (o != s_).any(axis=1)
    assert rows.mean() <= 1 / 32, np.nonzero(rows)[0]
    np.testing.assert_allclose(o, s_, atol=2 ** -5, rtol=2 ** -7)
    np.testing.assert_allclose(o, np.asarray(default.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


def test_k5_plain_matches_pallas_interpret_fp32():
    """fp32 activations (no bf16 roundings in the chain): the int8 codes
    are the same, so the outputs agree to fp32 rounding of the epilogue."""
    x, scale, shift, jw, b = _k5_operands(2, True)
    m = x.shape[0]
    ref = jfp.norm_mod_int8_matmul(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), jw.w_int8,
        jw.scale, jnp.asarray(b), rows_per_group=m // 2, eps=1e-5,
        interpret=True)
    out = tfp.norm_mod_int8_matmul(
        *_t(x, scale, shift), torch.from_numpy(np.asarray(jw.w_int8).T.copy()),
        torch.from_numpy(np.array(jw.scale)), torch.from_numpy(b),
        rows_per_group=m // 2, eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_k5_group_rows_and_shape_checks():
    """Row r reads group r // rows_per_group: with a group size that has
    no 16-multiple divisor (the TPU kernel refuses it,
    tests/test_fused_prologue.py:52; each row of the row kernel reads its
    own group's rows) the rows of group 1 still get group 1's modulation. Shape errors raise as in
    JAX."""
    m, k, n = 48, 64, 64
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = tq.quantize_weights(torch.from_numpy(
        rng.standard_normal((n, k)).astype(np.float32)))
    scale = torch.zeros(2, k)
    shift = torch.zeros(2, k)
    shift[1] = 3.0
    out = tfp.norm_mod_int8_matmul(x, scale, shift, w.w_int8, w.scale,
                                   rows_per_group=24, eps=1e-5)
    for g in (0, 1):
        ref = tfp.norm_mod_int8_matmul(
            x[24 * g:24 * g + 24], scale[g:g + 1], shift[g:g + 1], w.w_int8,
            w.scale, rows_per_group=24, eps=1e-5)
        assert torch.equal(out[24 * g:24 * g + 24], ref)
    with pytest.raises(ValueError, match="straddle"):
        jfp.norm_mod_int8_matmul(
            jnp.ones((m, k), jnp.bfloat16), jnp.zeros((2, k), jnp.bfloat16),
            jnp.zeros((2, k), jnp.bfloat16), jnp.ones((k, n), jnp.int8),
            jnp.ones((n,)), None, rows_per_group=24, eps=1e-5, interpret=True)
    with pytest.raises(ValueError, match="rows_per_group"):
        tfp.norm_mod_int8_matmul(x, scale, shift, w.w_int8, w.scale,
                                 rows_per_group=36)
    with pytest.raises(ValueError, match="scale shape"):
        tfp.norm_mod_int8_matmul(x, scale[:1], shift[:1], w.w_int8, w.scale,
                                 rows_per_group=24)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_row_kernel_limit_is_named(dtype):
    """The row kernel holds a row in registers, up to K = 32768 (8 warps of
    8 slots of 16 values a lane); the CUDA wrapper's check takes every K
    that is a 16-multiple up to that and names the limit beyond it."""
    def check(k):
        x = torch.zeros(4, k, dtype=dtype)
        tfp._check_cuda(x, x[:1], x[:1], None, None, None)

    for k in (16, 48, 4096, 8960, 32768):
        check(k)
    for k in (40, 32784, 51200):
        with pytest.raises(ValueError, match="K % 16 == 0 and K <= 32768"):
            check(k)


def test_k5_supports_equal_jax_on_a_grid():
    """``supports`` agrees with the JAX gate over tokens x groups, and on
    the linears' tiers and bias layouts
    (tests/test_fused_prologue.py:69)."""
    jw = jq.quantize_weights(jnp.ones((8, 16), jnp.bfloat16))
    jgood = {"w_int8_dyn": jw.w_int8, "scale": jw.scale}
    jbias = dict(jgood, bias=jnp.zeros((16,)))
    jdense = {"kernel": jnp.ones((8, 16))}

    def tlin(bias, quantized=True):
        lin = tq.Linear(8, 16, bias)
        if quantized:
            lin.weight.fill_(1.0)
            lin.quantize_()
        return lin

    for s in (16, 32, 33, 48, 64, 240, 350, 3840):
        for g in (1, 2, 3, 4, 16):
            assert tfp.supports([tlin(False)], s, g) == \
                jfp.supports([jgood], s, g), (s, g)
    assert tfp.supports([tlin(True), tlin(True)], 32, 1) == \
        jfp.supports([jbias, jbias], 32, 1) is True
    assert tfp.supports([tlin(False), tlin(True)], 32, 1) == \
        jfp.supports([jgood, jbias], 32, 1) is False
    assert tfp.supports([tlin(False, quantized=False)], 32, 1) == \
        jfp.supports([jdense], 32, 1) is False


def test_k5_enabled_mode_follows_the_jax_switch(monkeypatch):
    for raw in ("", "0", "off", "1", "interpret", "TRUE"):
        monkeypatch.setenv("LTXV_TPU_FUSED_PROLOGUE", raw)
        assert (tfp.enabled_mode() is None) == (jfp.enabled_mode() is None)
    monkeypatch.delenv("LTXV_TPU_FUSED_PROLOGUE")
    assert tfp.enabled_mode() is None and jfp.enabled_mode() is None


def test_k5_fused_weights_are_views_of_one_buffer():
    """``apply_fused`` runs q, k, v as one product over their weights side
    by side, concatenated at each call as in JAX: the linears' own buffers
    stay as they were (no view of a shared buffer, nothing cached on the
    modules), a single linear's buffers pass through uncopied, and a
    reloaded state dict or a bias changed in place is picked up."""
    rng = np.random.default_rng(6)
    lins = []
    for _ in range(3):
        lin = tq.Linear(64, 32, True)
        lin.weight.copy_(torch.from_numpy(
            rng.standard_normal((32, 64)).astype(np.float32)))
        lin.bias.copy_(torch.from_numpy(
            rng.standard_normal(32).astype(np.float32)))
        lin.quantize_()
        lins.append(lin)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((2, 2, 64)).astype(np.float32))
    ptrs = [(lin.w_int8_dyn.data_ptr(), lin.w_int8_dyn.untyped_storage().size())
            for lin in lins]
    keys = [set(vars(lin)) for lin in lins]
    out = tfp.apply_fused(x, sc * 0.1, sc * 0.2, lins, eps=1e-6)
    assert out.shape == (2, 32, 96)
    assert ptrs == [(lin.w_int8_dyn.data_ptr(),
                     lin.w_int8_dyn.untyped_storage().size()) for lin in lins]
    assert keys == [set(vars(lin)) for lin in lins]
    w, ws, bias = tfp.fused_weights(lins)
    assert w.shape == (96, 64) and torch.equal(w[32:64], lins[1].w_int8_dyn)
    assert torch.equal(ws[64:], lins[2].scale)
    w1, ws1, _ = tfp.fused_weights(lins[:1])
    assert w1 is lins[0].w_int8_dyn and ws1 is lins[0].scale
    # against the unfused chain of the same linears
    from ltx_video_gpupoor_tpu_torch.ops.norms import rms_norm
    h = rms_norm(x, eps=1e-6).reshape(2, 2, 16, 64)
    h = (h * (1 + 0.1 * sc[:, :, None]) + 0.2 * sc[:, :, None]).reshape(x.shape)
    ref = torch.cat([lin(h) for lin in lins], dim=-1)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    state = {k: v.clone() for k, v in lins[2].state_dict().items()}
    state["w_int8_dyn"] = -state["w_int8_dyn"]
    lins[2].load_state_dict(state)
    out2 = tfp.apply_fused(x, sc * 0.1, sc * 0.2, lins, eps=1e-6)
    torch.testing.assert_close(out2[..., 64:], 2 * lins[2].bias - out[..., 64:],
                               atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        lins[0].bias.add_(1.0)             # in place: the same pointer
    out3 = tfp.apply_fused(x, sc * 0.1, sc * 0.2, lins, eps=1e-6)
    torch.testing.assert_close(out3[..., :32], out2[..., :32] + 1.0,
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("d,sq,skv,seg,kv_valid,causal", [
    (64, 256, 384, False, None, False),    # several kv blocks, sum_col
    (128, 256, 384, False, None, False),
    (128, 256, 256, True, None, False),    # segments and a lost q row
    (64, 384, 384, False, 300, False),     # kv_valid tail
    (128, 256, 256, False, None, True),    # causal
])
def test_k4_plain_matches_pallas_interpret(pv_int8, d, sq, skv, seg,
                                           kv_valid, causal):
    q, k, v = _qkv(9, 2, 2, sq, skv, d)
    segs = ()
    if seg:
        q_seg = np.ones((2, sq), np.int32)
        q_seg[1, 3] = 5                    # a row that matches no key
        kv_seg = np.ones((2, skv), np.int32)
        kv_seg[0, skv // 2:] = 0           # padded text
        segs = (q_seg, kv_seg)
    kw = dict(kv_valid=kv_valid, causal=causal)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v) + segs),
                              qk_int8=True, pv_int8=pv_int8, block_q=128,
                              block_kv=128, interpret=True, **kw)
    ops = tfa.int8_prologue(*_t(q, k, v), pv_int8=pv_int8, block_kv=128)
    assert ops.kv_block == 128
    out = tfa.int8_attention_plain(ops, *_t(*segs), **kw)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert np.mean(err > K4_ATOL) < K4_FLIP_SHARE, np.mean(err > K4_ATOL)
    assert err.max() < K4_FLIP_ATOL, err.max()
    exact = tfa.reference_attention(*_t(q, k, v, *segs), **kw)
    assert float((out - exact).abs().mean()) < K4_EXACT_MEAN
    if seg:
        np.testing.assert_array_equal(out[1, :, 3].numpy(), 0.0)


@pytest.mark.parametrize("key,d,s,pv_int8,seg,kv_valid", [
    (6, 64, 256, False, False, None),      # test_int8_qk_tier_close_to_fp
    (7, 128, 256, True, False, None),      # test_int8_pv_tier_close_to_fp
    (17, 64, 256, True, False, None),      # ..._odd_head_dim_close_to_fp
    (9, 64, 256, False, True, None),       # ..._with_segments_matches_ref
    (11, 128, 384, True, False, 300),      # test_int8pv_with_kv_tail_...
])
def test_k4_plain_within_tier_bound_of_exact(key, d, s, pv_int8, seg,
                                             kv_valid):
    """On the inputs of the JAX package's int8 tier tests, K4's plain
    version stays within their 3e-2 of exact attention."""
    k1, k2, k3 = jax.random.split(jax.random.key(key), 3)
    q, k, v = (np.array(jax.random.normal(kk, (1, 2, s, d)))
               for kk in (k1, k2, k3))
    segs = ()
    if seg:
        ids = np.where(np.arange(s) < 200, 1, 0)[None, :].astype(np.int32)
        segs = (ids, ids)
    out = tfa.flash_attention_int8(*_t(q, k, v, *segs), pv_int8=pv_int8,
                                   kv_valid=kv_valid)
    if kv_valid is not None:
        segs = (np.ones((1, s), np.int32),
                np.where(np.arange(s) < kv_valid, 1, 0)[None].astype(np.int32))
    exact = tfa.reference_attention(*_t(q, k, v, *segs))
    assert float((out - exact).abs().max()) < K4_EXACT_TOL


def test_k4_scales_take_masked_rows_and_the_jax_block():
    """The k and v scales' absmax covers segment-masked rows (JAX masks
    scores, not the prologue), and the QK+PV tier's k scales are per
    block of JAX's compiled kv block (fit_blocks on the 128-padded
    lengths: 4096 at the Wan self-attention's S=32760)."""
    from ltx_video_gpupoor_tpu.ops.flash_attention import fit_blocks

    for sq, skv in ((32768, 32768), (32768, 512), (5376, 5376), (384, 256)):
        assert tfa.fit_blocks(sq, skv) == fit_blocks(sq, skv)
        assert tfa.fit_blocks(sq, skv, 128, 128) == \
            fit_blocks(sq, skv, 128, 128)
    assert tfa.fit_blocks(32768, 32768)[1] == 4096
    q, k, v = _t(*_qkv(10, 1, 1, 8, 300, 128))
    k[0, 0, 290, 0] = 50.0                 # in the last kv block only
    v[0, 0, 290, 3] = -60.0
    ops = tfa.int8_prologue(q, k, v, block_kv=128)
    assert ops.kv_block == ops.k_block == 128
    assert ops.k_scale.shape == (1, 1, 3)
    np.testing.assert_allclose(float(ops.k_scale[0, 0, 2]), 50.0 / 127,
                               rtol=1e-6)
    assert float(ops.k_scale[0, 0, 0]) < 10.0 / 127
    np.testing.assert_allclose(float(ops.v_scale[0, 0, 3]), 60.0 / 127,
                               rtol=1e-6)
    qk = tfa.int8_prologue(q, k, v, pv_int8=False)
    # the QK tier: a k scale a row, zero past Skv to a whole K4 tile
    assert qk.k_block == 1 and qk.k_scale.shape == (1, 1, 384)
    assert float(qk.k_scale[..., 300:].abs().max()) == 0.0
    assert qk.v_scale is None and qk.v.dtype == torch.float32
    # JAX's ones column of V (head dims that are not a 128 multiple):
    # scale 1/127, code 127, and its scale times the x127 fold
    one = tfa._absmax_scale(torch.ones(1), 0)
    assert float(torch.round(1.0 / one)) == 127.0
    assert float(one * tfa.INV127_F32 * 127.0) == tfa.SUM_COL_SCALE


@pytest.mark.parametrize("pv_int8", [True, False])
def test_k4_row_mass_matches_softmax(pv_int8):
    """``int8_row_mass``, stepped over kv blocks, is the softmax mass of
    K4's scores taken at once; a row that sees no key has mass 0."""
    q, k, v = _t(*_qkv(12, 2, 2, 200, 300, 64))
    q_seg = torch.ones(2, 200, dtype=torch.int32)
    q_seg[1, 7] = 3
    kv_seg = torch.ones(2, 300, dtype=torch.int32)
    kv_seg[0, 250:] = 0
    ops = tfa.int8_prologue(q, k, v, pv_int8=pv_int8, block_kv=128)
    mass = tfa.int8_row_mass(ops, q_seg, kv_seg, causal=True)
    s = (ops.q8.double() @ ops.k8.double().transpose(-1, -2)) \
        * ops.q_scale[..., None].double() \
        * ops.k_scale.repeat_interleave(ops.k_block, -1)[:, :, None, :300]
    rows, cols = torch.arange(200)[:, None], torch.arange(300)[None, :]
    keep = (q_seg[:, None, :, None] == kv_seg[:, None, None, :]) \
        & (kv_seg[:, None, None, :] > 0) & (rows >= cols)
    s = torch.where(keep, s, -torch.inf)
    ref = torch.exp2(s - s.amax(-1, keepdim=True)).sum(-1)
    ref = torch.nan_to_num(ref, nan=0.0)
    torch.testing.assert_close(mass, ref.float(), rtol=1e-5, atol=0)
    assert float(mass[1, :, 7].abs().max()) == 0.0
    assert float(mass[0, :, 0].min()) == 1.0         # row 0 sees one key


@pytest.mark.parametrize("pv_int8", [True, False])
def test_k4_tile_bound_rejects_planted_faults(pv_int8):
    """The card's check of K4 against its plain version at the kernel's
    tile: an output the plain version gives passes; a q tile written as
    zeros or a channel that lost its v scale fails it, in the largest
    ratio to ``int8_tile_bound`` and in the mean."""
    q, k, v = (x.bfloat16() for x in _t(*_qkv(13, 1, 2, 1000, 1000, 128)))
    ops = tfa.int8_prologue(q, k, v, pv_int8=pv_int8)
    tile = tfa.int8_attention_plain(ops, block_kv=tfa.K4_TILE_KV,
                                    out_dtype=torch.bfloat16)
    bound = tfa.int8_tile_bound(ops, tile)
    assert float(bound.min()) > 0

    def ratios(kern):
        diff = (kern.float() - tile.float()).abs()
        return (float((diff / bound).max()),
                float(diff.mean() / tile.float().abs().mean()))

    assert ratios(tile) == (0.0, 0.0)
    zeroed = tile.clone()
    zeroed[:, :, 896:] = 0                 # the last (ragged) 128-row q tile
    worst, mean = ratios(zeroed)
    assert worst > 10 and mean > tfa.K4_TILE_MEAN_REL
    scale = ops.v_scale[:, :, 5] if pv_int8 else torch.full((1, 2), 0.5)
    dropped = tile.clone()
    dropped[..., 5] = (dropped[..., 5].float() / scale[..., None]).bfloat16()
    worst, mean = ratios(dropped)
    assert worst > 10 and mean > tfa.K4_TILE_MEAN_REL


@pytest.mark.parametrize("s", [256, 333])
def test_k4_v_layout_is_the_kernels_kv_order(s):
    """``k4_v_layout`` against a numpy statement of the permutation:
    V^T[d, 32c + L] = V[32c + order(L), d], order(4t + i (+16)) = 2t +
    (0, 1, 8, 9)[i] (+16), zero columns past S; and P.V over P's columns
    in that order is P.V."""
    rng = np.random.default_rng(23)
    v8 = rng.integers(-127, 128, (2, 3, s, 128)).astype(np.int8)
    vt = tfa.k4_v_layout(torch.from_numpy(v8)).numpy()
    sp = -(-s // 128) * 128
    assert vt.shape == (2, 3, 128, sp)
    order = [half + 2 * t + i for half in (0, 16) for t in range(4)
             for i in (0, 1, 8, 9)]
    assert sorted(order) == list(range(32)) and tuple(order) == \
        tfa.K4_KV_ORDER
    padded = np.zeros((2, 3, sp, 128), np.int8)
    padded[:, :, :s] = v8
    rows = np.array([32 * c + order[l] for c in range(sp // 32)
                     for l in range(32)])
    np.testing.assert_array_equal(vt, padded[:, :, rows].transpose(0, 1, 3, 2))
    p8 = rng.integers(0, 128, (2, 3, 40, sp)).astype(np.int64)
    p8[..., s:] = 0
    np.testing.assert_array_equal(
        p8[..., rows] @ vt.astype(np.int64).transpose(0, 1, 3, 2),
        p8 @ padded.astype(np.int64))
    # k4_v_rows undoes it, and the prologue writes its v codes so laid out
    np.testing.assert_array_equal(
        tfa.k4_v_rows(torch.from_numpy(vt), s).numpy(), v8)
    q = torch.from_numpy(rng.standard_normal((2, 3, 50, 128), np.float32))
    vf = torch.from_numpy(rng.standard_normal((2, 3, s, 128), np.float32))
    ops = tfa.int8_prologue(q, vf, vf)
    codes = torch.round(vf / tfa._absmax_scale(vf, 2)[:, :, None, :])
    np.testing.assert_array_equal(tfa.k4_v_rows(ops.v, s).numpy(),
                                  codes.to(torch.int8).numpy())
    np.testing.assert_array_equal(
        ops.v.numpy(), tfa.k4_v_layout(codes.to(torch.int8)).numpy())


@pytest.mark.parametrize("pv_int8", [True, False])
@pytest.mark.parametrize("d,s,kv_valid", [(128, 1024, 1000),  # Wan-like
                                          (64, 384, 333)])    # ragged
def test_k4_plain_at_the_kernels_tile_matches_pallas_interpret(
        pv_int8, d, s, kv_valid):
    """The plain version stepped as the kernel steps (``K4_TILE_KV`` = 128
    rows) against the interpreted Pallas tier at JAX's default blocks,
    which moves its running max once a kv block (1024 and 384 rows here):
    P is quantized against other maxima, so the two agree to int8 noise
    (chip_smoke's bar for the kernel against JAX's block: max 1e-1, mean
    1e-3). Stepped by JAX's block the plain version is JAX's
    (test_k4_plain_matches_pallas_interpret)."""
    q, k, v = _qkv(24, 1, 2, s, s, d)
    ref = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), qk_int8=True, pv_int8=pv_int8,
        kv_valid=kv_valid, interpret=True))
    ops = tfa.int8_prologue(*_t(q, k, v), pv_int8=pv_int8)
    assert ops.kv_block == s
    tile = tfa.int8_attention_plain(ops, kv_valid=kv_valid,
                                    block_kv=tfa.K4_TILE_KV).numpy()
    diff = np.abs(tile - ref)
    assert diff.max() < 1e-1 and diff.mean() < 1e-3, (diff.max(), diff.mean())
    assert float(np.abs(ref).mean()) > 10 * diff.mean()


def test_k4_rejects_kv_only_segments_and_other_devices():
    q = torch.zeros(1, 1, 8, 128)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_attention_int8(q, q, q, None,
                                 torch.ones(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tfa.flash_attention_int8(q.to("meta"), q.to("meta"), q.to("meta"))


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------

def _w_x(seed, m, k, n, zero_row=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if zero_row:
        x[1] = 0.0             # s_x floors at 1e-8: the row must come out 0
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, b


def test_quantize_weights_bitwise_equal_jax():
    _, w, _ = _w_x(5, 4, 256, 96)
    jql = jq.quantize_weights(jnp.asarray(w))
    tql = tq.quantize_weights(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tql.w_int8.numpy(), np.asarray(jql.w_int8).T)
    np.testing.assert_array_equal(tql.scale.numpy(), np.asarray(jql.scale))


@pytest.mark.parametrize("m,k,n", [(3, 256, 512), (130, 512, 384),
                                   (64, 48, 40)])
def test_k2_plain_matches_jax_dynamic_path(m, k, n):
    x, w, b = _w_x(6, m, k, n)
    ql = jq.quantize_weights(jnp.asarray(w))
    ref = jq.int8_dynamic_matmul(jnp.asarray(x), ql, jnp.asarray(b))
    w8 = torch.from_numpy(np.asarray(ql.w_int8).T.copy())
    sw = torch.from_numpy(np.array(ql.scale))
    out = tim.int8_linear(torch.from_numpy(x), w8, sw, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=INT8_TOL,
                               rtol=INT8_TOL)
    np.testing.assert_allclose(out[1].numpy(), b, atol=1e-6)
    # the int32 accumulator of the plain version is exact
    xq, _ = tim.quantize_rows_plain(torch.from_numpy(x))
    acc = tim.int8_gemm_acc_plain(xq, w8)
    np.testing.assert_array_equal(
        acc.numpy(), xq.numpy().astype(np.int64) @ w8.numpy().T.astype(np.int64))


def test_k2_plain_matches_pallas_interpret_bf16():
    x, w, _ = _w_x(7, 130, 256, 1024, zero_row=False)
    xb = jnp.asarray(x, jnp.bfloat16)
    ql = jq.quantize_weights(jnp.asarray(w, jnp.bfloat16))
    ref = jim.int8_dynamic_matmul_fused(xb, ql.w_int8, ql.scale,
                                        interpret=True, block_m=128,
                                        block_n=256)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    out = tim.int8_linear(xt, torch.from_numpy(np.asarray(ql.w_int8).T.copy()),
                          torch.from_numpy(np.array(ql.scale)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=INT8_TOL, rtol=INT8_TOL)


def test_linear_tiers_dispatch():
    x, w, b = _w_x(8, 5, 64, 32, zero_row=False)
    lin = tq.Linear(64, 32)
    lin.weight.data.copy_(torch.from_numpy(w.T.copy()))
    lin.bias.data.copy_(torch.from_numpy(b))
    dense = lin(torch.from_numpy(x))
    np.testing.assert_allclose(dense.numpy(), x @ w + b, atol=1e-5, rtol=1e-5)
    tq.quantize_params(lin, mode="dynamic")
    assert lin.quantized and not hasattr(lin, "weight")
    ref = jq.maybe_quantized_matmul(
        jq.quantize_params({"l": {"kernel": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}},
                           mode="dynamic")["l"], jnp.asarray(x))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=INT8_TOL, rtol=INT8_TOL)
    with pytest.raises(NotImplementedError, match="step 12"):
        tq.quantize_params(tq.Linear(16, 16), mode="wo")


def test_quantize_params_defaults_to_jax_mode():
    """The default mode is JAX's weight-only ``"wo"``, which is not ported:
    a call without ``mode`` raises and leaves the model dense instead of
    quietly quantizing another tier."""
    default = inspect.signature(tq.quantize_params).parameters["mode"].default
    assert default == inspect.signature(
        jq.quantize_params).parameters["mode"].default == "wo"
    lin = tq.Linear(16, 16)
    with pytest.raises(NotImplementedError, match="mode='wo'.*step 12"):
        tq.quantize_params(lin)
    assert not lin.quantized and hasattr(lin, "weight")


def test_k2_rejects_bad_operands():
    w8 = torch.zeros(32, 40, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 16"):
        tim.int8_linear(torch.zeros(3, 40), w8, torch.ones(32))
    w8 = torch.zeros(32, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tim.int8_linear(torch.zeros(3, 48, dtype=torch.float64), w8,
                        torch.ones(32))
