"""The port's training checkpointer (``training/checkpoint.py``, no orbax):
JAX's ``tests/test_training_checkpoint.py`` on the port. Save + restore
round-trips bit for bit (params, AdamW state, the ``torch.Generator``),
a resume after 2 of 4 steps equals the uninterrupted run exactly
(``atol = rtol = 0``), retention keeps the newest ``max_to_keep`` steps,
a missing step and an empty directory raise ``FileNotFoundError``, and a
step left half written (``.tmp``) is never listed. The restore onto a
mesh: ``tests/test_torch_training_mesh.py``. JAX's typed-key cases have
no counterpart (one generator type)."""

import os

import numpy as np
import pytest
import torch

from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.training import (
    TrainBatch,
    TrainCheckpointer,
    TrainConfig,
    init_train_state,
    make_train_step,
)

KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8,
          out_channels=8, num_layers=2, cross_attention_dim=32,
          caption_channels=16)
TC = TrainConfig(learning_rate=2e-3, remat=False)


def _model(seed=0):
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**KW), FP32_POLICY)
    return ttf.init_params(model, torch.Generator().manual_seed(seed))


def _batch(seed, b=2, s=16, sc=4):
    rng = np.random.RandomState(seed)
    return TrainBatch(
        torch.from_numpy(rng.randn(b, s, 8).astype(np.float32)),
        torch.from_numpy(np.stack([rng.randint(0, 4, (b, s))
                                   for _ in range(3)], 1).astype(np.float32)),
        torch.from_numpy(rng.randn(b, sc, 16).astype(np.float32)),
        torch.ones(b, sc, dtype=torch.int32))


def _run(step, gen, n, start=0):
    metrics = None
    for i in range(start, start + n):
        metrics = step(_batch(i), generator=gen)
    return metrics


def _state(model, step, gen):
    out = {f"p/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"mu/{n}": t.clone() for n, t in step.state.mu.items()})
    out.update({f"nu/{n}": t.clone() for n, t in step.state.nu.items()})
    out["count"] = step.state.count.clone()
    out["rng"] = gen.get_state()
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_resume_matches_uninterrupted(tmp_path):
    model = _model()
    step = make_train_step(model, TC, attn_mode="xla")
    gen = torch.Generator().manual_seed(1)
    m_ref = _run(step, gen, 4)
    want = _state(model, step, gen)

    model = _model()
    step = make_train_step(model, TC, attn_mode="xla")
    gen = torch.Generator().manual_seed(1)
    _run(step, gen, 2)
    saved = _state(model, step, gen)
    ckpt = TrainCheckpointer(str(tmp_path / "run"))
    ckpt.save(2, model, step.state, gen)
    assert ckpt.latest_step() == 2

    # a fresh process's objects: other weights, zero state, another seed
    model2 = _model(seed=7)
    state2 = init_train_state(model2, TC)
    gen2 = torch.Generator().manual_seed(99)
    assert ckpt.restore(model2, state2, gen2) == 2
    step2 = make_train_step(model2, TC, attn_mode="xla", state=state2)
    _equal(_state(model2, step2, gen2), saved)      # bit for bit

    m_res = _run(step2, gen2, 2, start=2)
    _equal(_state(model2, step2, gen2), want)
    assert float(m_res["loss"]) == float(m_ref["loss"])
    ckpt.close()


def test_retention_prunes_old_steps(tmp_path):
    model = _model()
    state = init_train_state(model, TC)
    gen = torch.Generator().manual_seed(9)
    ckpt = TrainCheckpointer(str(tmp_path / "run"), max_to_keep=2)
    for s in range(4):
        ckpt.save(s, model, state, gen)
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "run")) == ["step_2", "step_3"]
    with pytest.raises(FileNotFoundError, match="no step 0"):
        ckpt.restore(model, state, gen, step=0)
    with pytest.raises(FileExistsError):
        ckpt.save(3, model, state, gen)
    ckpt.close()


def test_restore_without_checkpoint_raises(tmp_path):
    model = _model()
    ckpt = TrainCheckpointer(str(tmp_path / "empty"))
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(model, init_train_state(model, TC),
                     torch.Generator())
    ckpt.close()


def test_half_written_step_is_not_listed(tmp_path):
    """A save commits by renaming ``step_<n>.tmp``: one left behind by a
    crash is never listed or restored, and the next save of that step
    replaces it."""
    model = _model()
    state = init_train_state(model, TC)
    gen = torch.Generator().manual_seed(0)
    ckpt = TrainCheckpointer(str(tmp_path / "run"))
    ckpt.save(1, model, state, gen)
    os.makedirs(tmp_path / "run" / "step_2.tmp")
    (tmp_path / "run" / "step_2.tmp" / "state.safetensors").write_bytes(b"x")
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(model, state, gen, step=2)
    ckpt.save(2, model, state, gen)
    assert ckpt.all_steps() == [1, 2]
    assert not os.path.exists(tmp_path / "run" / "step_2.tmp")
    assert ckpt.restore(model, state, gen) == 2
    ckpt.close()
