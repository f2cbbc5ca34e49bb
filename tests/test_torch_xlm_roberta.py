"""XLM-Roberta, the text tower of Wan's CLIP, in the port against the JAX
package on the CPU, at a small width that keeps its head dim of 64 (dim
128, 2 heads, 2 layers, a vocabulary of 300) with padded ids: ``encode``
and ``encode_with_head``, post-norm and pre-norm. Weights are JAX's
``init_params`` carried over by ``core/from_jax.py``. As
``tests/test_torch_clip.py``: the exact tier on both sides (the port's
``xla``, JAX's off-TPU default) to 1e-5; the port's ``auto`` at head dim
64 is the exact kernel's tier (K1 on the card; its plain version here),
held to the same 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu.models.wan import xlm_roberta as jx
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.wan import xlm_roberta as tx
from ltx_video_gpupoor_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

ATOL = 1e-5
CFG_KW = dict(vocab_size=300, max_seq_len=40, dim=128, num_heads=2,
              num_layers=2, head_out_dim=48)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    cfg = jx.XLMRobertaConfig(**{**CFG_KW, **kw})
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx.init_params(k, cfg))(jax.random.key(4)))
    model = tx.XLMRoberta(tx.XLMRobertaConfig(**{**CFG_KW, **kw}),
                          FP32_POLICY)
    model.load_state_dict(from_jax.state_dict(params))
    return cfg, params, model


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 300, (3, 37)).astype(np.int32)
    ids[0, 20:] = 1                 # pad_id 1: a short prompt
    ids[2, 5:] = 1
    return ids


@pytest.mark.parametrize("mode", ["xla", "auto"])
@pytest.mark.parametrize("post_norm", [True, False])
def test_encode_matches_jax(mode, post_norm):
    cfg, params, model = _pair(post_norm=post_norm)
    ids = _ids()
    ref = jx.encode(params, cfg, jnp.asarray(ids))
    assert tattn.kernel_route("auto", dtype=torch.bfloat16,
                              head_dim=64) == "K1"
    try:
        tattn.set_attention_mode(mode)
        out = tx.encode(model, torch.from_numpy(ids))
    finally:
        tattn.set_attention_mode("auto")
    assert tuple(out.shape) == ref.shape == (3, 37, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_encode_with_head_matches_jax():
    cfg, params, model = _pair()
    ids = _ids(1)
    ref = jx.encode_with_head(params, cfg, jnp.asarray(ids))
    out = tx.encode_with_head(model, torch.from_numpy(ids))
    assert tuple(out.shape) == ref.shape == (3, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    _, _, no_head = _pair(head_out_dim=0)
    with pytest.raises(ValueError, match="head_out_dim"):
        tx.encode_with_head(no_head, torch.from_numpy(ids))


def test_weights_match_jax_layout():
    """Every leaf of JAX's tree has its tensor in the port, of the same
    shape; ``init_params`` draws them in JAX's distribution."""
    _, params, model = _pair()
    want = from_jax.state_dict(params)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    fresh = tx.init_params(tx.XLMRoberta(tx.XLMRobertaConfig(**CFG_KW)),
                           torch.Generator().manual_seed(0))
    emb = fresh.token_embedding.float()
    assert abs(float(emb.std()) - 0.02) < 0.002
    assert float(fresh.blocks[0].attn.q.bias.abs().max()) == 0.0
    assert float(fresh.blocks[1].norm2.weight.min()) == 1.0
