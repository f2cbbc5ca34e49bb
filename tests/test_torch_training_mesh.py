"""The port's sharded train step and the checkpointer on a mesh, against
the JAX package on the CPU.

JAX jits its train step over a dp x sp x tp mesh of the 8 virtual devices
(``tests/test_training.py:82-116``: params by
``transformer_param_shardings``, tokens by ``token_sharding``) and XLA
derives the collectives and their VJPs. The port's ranks are gloo
processes (``core.mesh.spawn_ranks``, a ``FileStore`` under
``tmp_path``, a 120 s group timeout and a deadline, one thread each)
running ``tests/torch_train_workers.py``: each takes its dp rows and sp
tokens of the same global batch, JAX's ``t`` and ``eps`` (drawn from its
key as its ``flow_match_loss`` draws them), runs the USP forward on its
tp cut, sums grads over dp and sp and steps. Held after one step: loss,
``t_mean`` and ``grad_norm`` (rtol 1e-5: the sums run in other orders
than XLA's), and each rank's cut of the params (the elementwise Adam
bound of ``tests/test_torch_training.py``) and of ``mu`` / ``nu`` (1e-4
/ 2e-4 of the leaf's largest).

The config is ``tests/test_training.py``'s with 4 heads of 8 (the same
width): at sp = tp = 2 each rank's Ulysses exchange splits its
``H / tp`` heads over sp, which needs 4. At sp = 4 and tp = 4 (one group
of 4 ranks, against JAX on 4 of the virtual devices) each rank holds one
head; ``tp4_d128`` is the tp = 4 step at LTX-13B's head dim (128) and
its cross-attention width equal to the inner width.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_workers as workers
from ltx_video_gpupoor_tpu import training as jtr
from ltx_video_gpupoor_tpu.core import mesh as jmesh
from ltx_video_gpupoor_tpu.models.ltx.transformer3d import (
    LTXTransformerConfig,
    init_params,
)
from ltx_video_gpupoor_tpu.parallel.sharding import (
    replicated,
    token_sharding,
    transformer_param_shardings,
)
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core import mesh as tmesh
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.parallel.comm import TensorParallel
from ltx_video_gpupoor_tpu_torch.parallel.sharding import cut_param
from ltx_video_gpupoor_tpu_torch.training import (
    TrainCheckpointer,
    TrainConfig,
    make_train_step,
)
from ltx_video_gpupoor_tpu_torch.training import TrainBatch as TBatch

KW = dict(num_attention_heads=4, attention_head_dim=8, in_channels=8,
          out_channels=8, num_layers=2, cross_attention_dim=32,
          caption_channels=16)
CFG = LTXTransformerConfig(**KW)
# LTX-13B's layout at a small width: head dim 128, cross_attention_dim
# the inner width (4 x 128)
KW_13B = dict(KW, attention_head_dim=128, cross_attention_dim=512)
TC = dict(learning_rate=1e-3, remat=True)
SCALAR = dict(rtol=1e-5, atol=0)
LEAF = 1e-4


def spawn(tmp_path, fn, world, *args):
    return tmesh.spawn_ranks(fn, world, backend="gloo", timeout=120.0,
                             store_dir=str(tmp_path), args=args)


@pytest.fixture(scope="module")
def params():
    return jax.jit(lambda k: init_params(k, CFG))(jax.random.key(0))


@pytest.fixture(scope="module")
def params_13b():
    cfg = LTXTransformerConfig(**KW_13B)
    return jax.jit(lambda k: init_params(k, cfg))(jax.random.key(0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree):
    return from_jax.state_dict(_np_tree(tree))


def _batch_np(b=2, s=32, sc=4):
    rng = np.random.RandomState(2)
    return (rng.randn(b, s, 8).astype(np.float32),
            np.stack([rng.randint(0, 4, (b, s)) for _ in range(3)],
                     1).astype(np.float32),
            rng.randn(b, sc, 16).astype(np.float32),
            np.ones((b, sc), np.int32))


def _jax_step(params, dims, batch_np, key, cfg=CFG):
    """JAX's step jitted over the mesh ``dims``, as its test runs it."""
    dp, sp, tp = dims
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, sp=sp, tp=tp),
                           devices=jax.devices()[:dp * sp * tp])
    tc = jtr.TrainConfig(**TC)
    p = jax.tree.map(jax.device_put, params,
                     transformer_param_shardings(mesh, params))
    o = jtr.init_train_state(p, tc)
    tok, coords, cap, mask = batch_np
    batch = jtr.TrainBatch(
        tokens=jax.device_put(tok, token_sharding(mesh)),
        coords=jax.device_put(coords, replicated(mesh)),
        caption=jax.device_put(cap, replicated(mesh)),
        caption_mask=jax.device_put(mask, replicated(mesh)))
    p, o, m = jax.jit(jtr.make_train_step(cfg, tc, attn_mode="xla"))(
        p, o, batch, key)
    kt, kn = jax.random.split(key)
    t = np.asarray(jtr.sample_timesteps(kt, tok.shape[0], tc))
    eps = np.asarray(jax.random.normal(kn, tok.shape, jnp.float32))
    return _sd(p), from_jax.adamw_state(_np_tree(o)), m, t, eps


def _cut(whole, name, out, tp):
    """Rank ``out``'s share of a whole leaf, by the cuts it reported."""
    if name not in out["cuts"]:
        return whole
    dim, halves = out["cuts"][name]
    return cut_param(whole, (TensorParallel(None, tp, out["tp_rank"]), dim,
                             halves))


MESHES = {"dp2": (2, 1, 1), "sp2": (1, 2, 1), "tp2": (1, 1, 2),
          "dp2xsp2xtp2": (2, 2, 2), "sp4": (1, 4, 1), "tp4": (1, 1, 4),
          "tp4_d128": (1, 1, 4)}
FOUR = ["sp4", "tp4", "tp4_d128"]


def _kw(name):
    return KW_13B if name == "tp4_d128" else KW


@pytest.fixture(scope="module")
def jax_steps(params, params_13b):
    key = jax.random.key(3)
    cfg_13b = LTXTransformerConfig(**KW_13B)
    return {k: _jax_step(params_13b, dims, _batch_np(), key, cfg_13b)
            if k == "tp4_d128" else _jax_step(params, dims, _batch_np(), key)
            for k, dims in MESHES.items()}


def _runs(params, jax_steps, names, params_13b=None):
    def sd(tree):
        return {k: v.numpy() for k, v in _sd(tree).items()}
    return [(MESHES[k], _kw(k), sd(params_13b if k == "tp4_d128" else params),
             _batch_np(), *jax_steps[k][3:], TC) for k in names]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, params, jax_steps):
    """dp2, sp2 and tp2, one after another in one group of 2 ranks."""
    names = ["dp2", "sp2", "tp2"]
    outs = spawn(tmp_path_factory.mktemp("two"), workers.session, 2,
                 _runs(params, jax_steps, names))
    out = {k: [o[0][i] for o in outs] for i, k in enumerate(names)}
    out["collective grads"] = [o[2] for o in outs]
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, params, params_13b, jax_steps):
    """sp4, tp4 and tp4 at head dim 128, one after another in one group of
    4 ranks."""
    outs = spawn(tmp_path_factory.mktemp("four"), workers.session, 4,
                 _runs(params, jax_steps, FOUR, params_13b))
    return {k: [o[0][i] for o in outs] for i, k in enumerate(FOUR)}


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory, params, jax_steps):
    """dp2 x sp2 x tp2 in one group of 8: the step, then the restore of a
    one-process save and the mesh's own save."""
    tmp = tmp_path_factory.mktemp("eight")
    model = ttf.init_params(ttf.LTXTransformer3D(
        ttf.LTXTransformerConfig(**KW), FP32_POLICY),
        torch.Generator().manual_seed(0))
    step = make_train_step(model, TrainConfig(**TC), attn_mode="xla")
    gen = torch.Generator().manual_seed(4)
    step(TBatch(*(torch.from_numpy(a) for a in _batch_np())), generator=gen)
    src, dst = str(tmp / "one"), str(tmp / "mesh")
    TrainCheckpointer(src).save(1, model, step.state, gen)
    outs = spawn(tmp, workers.session, 8,
                 _runs(params, jax_steps, ["dp2xsp2xtp2"]),
                 (MESHES["dp2xsp2xtp2"], KW, src, dst))
    return ([o[0][0] for o in outs], [o[1] for o in outs],
            (model, step.state, gen, dst))


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_jax(request, jax_steps, name):
    dims = MESHES[name]
    if name == "dp2xsp2xtp2":
        outs = request.getfixturevalue("eight_ranks")[0]
    else:
        outs = request.getfixturevalue(
            "four_ranks" if name in FOUR else "two_ranks")[name]
    want_p, want_o, jm = jax_steps[name][:3]
    b2 = TrainConfig().b2
    for out in outs:
        for k in ("loss", "t_mean", "grad_norm"):
            np.testing.assert_allclose(out[k], float(jm[k]), **SCALAR)
        assert out["count"] == int(want_o.count) == 1
        for n, whole in want_p.items():
            mu = _cut(want_o.mu[n], n, out, dims[2]).numpy()
            nu = _cut(want_o.nu[n], n, out, dims[2]).numpy()
            for what, got, w, rel, leaf in (
                    ("mu", out["mu"][n], mu, LEAF, want_o.mu[n]),
                    ("nu", out["nu"][n], nu, 2 * LEAF, want_o.nu[n])):
                assert got.shape == w.shape, (what, n)
                d = np.abs(got - w).max()
                assert d <= rel * max(float(leaf.abs().max()), 1e-30), (
                    what, n, d)
            # the elementwise Adam bound at count 1: g^2 = nu / (1 - b2)
            gmax = math.sqrt(float(want_o.nu[n].max()) / (1 - b2))
            bound = 2e-7 + TC["learning_rate"] * np.minimum(
                2.0, 8 * LEAF * gmax / (np.sqrt(nu / (1 - b2)) + 1e-8))
            got = out["params"][n]
            w = _cut(whole, n, out, dims[2]).numpy()
            assert got.shape == w.shape, n
            assert (np.abs(got - w) <= bound).all(), (
                n, np.abs(got - w).max())


def test_collectives_carry_their_gradients(two_ranks):
    """The backward of each autograd collective on 2 ranks, for a loss
    ``sum(out * c_r)`` with ``c_r = r + 1 + arange``: the all-to-all sends
    each chunk's gradient back to the rank it came from, the all-gather
    keeps this rank's rows, ``reduce_sum`` passes the gradient on as it
    is (or sums it over the ranks), ``tp_input`` sums it. Exact."""
    grads = two_ranks["collective grads"]
    world = len(grads)

    def c(r, shape):
        return np.arange(math.prod(shape), dtype=np.float32).reshape(shape) \
            + r + 1
    for r, g in enumerate(grads):
        # rank j's out chunk r came from this rank's chunk j
        want = np.stack([c(j, (world, 3))[r] for j in range(world)])
        np.testing.assert_array_equal(g["all_to_all"], want)
        np.testing.assert_array_equal(g["all_gather_cat"],
                                      c(r, (2 * world, 3))[2 * r:2 * r + 2])
        np.testing.assert_array_equal(g["reduce_sum"], c(r, (2, 3)))
        total = sum(c(j, (2, 3)) for j in range(world))
        np.testing.assert_array_equal(g["reduce_sum grads"], total)
        np.testing.assert_array_equal(g["tp_input"], total)


def test_restore_one_rank_save_onto_mesh_and_back(eight_ranks):
    """A one-process save (after a step: non-zero moments) restores onto
    dp2 x sp2 x tp2 with each rank holding ``shard_params``'s cut of every
    leaf and moment, bit for bit; the mesh then saves (gathering the tp
    cuts, rank 0 writing) and one process restores that bit for bit."""
    _, outs, (model, state0, gen, dst) = eight_ranks
    for out in outs:
        assert out["step"] == 1 and out["count"] == 1
        np.testing.assert_array_equal(out["rng"], gen.get_state().numpy())
        for n, p in model.named_parameters():
            for key, whole in (("params", p.detach()),
                               ("mu", state0.mu[n]),
                               ("nu", state0.nu[n])):
                w = _cut(whole, n, out, 2).numpy()
                np.testing.assert_array_equal(out[key][n], w)
    assert {o["tp_rank"] for o in outs} == {0, 1}
    # the q/k/v, FFN and norm leaves of every block are cut
    assert len(outs[0]["cuts"]) == 2 * 21

    back = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**KW), FP32_POLICY)
    state = make_train_step(back, TrainConfig(**TC)).state
    gen2 = torch.Generator().manual_seed(0)
    assert TrainCheckpointer(dst).restore(back, state, gen2) == 1
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert int(state.count) == 1
    for n, p in model.named_parameters():
        assert torch.equal(dict(back.named_parameters())[n], p), n
        assert torch.equal(state.mu[n], state0.mu[n]), n
        assert torch.equal(state.nu[n], state0.nu[n]), n
