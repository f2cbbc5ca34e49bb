"""The port's flow-matching trainer against the JAX package's on the CPU.

``tests/test_training.py``'s config in fp32, weights from JAX's
``init_params`` through ``core/from_jax.py`` (the AdamW state too), JAX's
``t`` and ``eps`` drawn from its key as its ``flow_match_loss`` draws them
(``split`` into kt, kn) and handed to the port. Tolerances, fp32:

- loss, ``t_mean``, ``grad_norm``: rtol 2e-6;
- grads leaf by leaf, ``mu``: within 1e-4 of the leaf's largest |value|
  (``nu``, a square: 2e-4); ``count`` exactly. The largest gap is the
  adaLN MLP's first kernel, 3e-6 to 2.6e-5 over six draws: the
  timestep embedding takes sin and cos of arguments up to 1000, where
  XLA's and torch's fp32 results differ in the last bits;
- params after a step: within ``2e-7 + lr * min(2, 8 * 1e-4 * max|g| /
  (sqrt(nu_hat) + eps))`` elementwise. Adam divides each grad by its own
  running magnitude, so a grad that agrees to 1e-4 of its leaf's largest
  moves its parameter by up to that much relative to ``sqrt(nu_hat)``, and
  a grad within fp32 noise of 0 by up to ``2 * lr`` (two elements of
  ``adaln.linear`` do so at the first step). That perturbation feeds the
  next forward, so each step of a run starts from JAX's params and state
  (the port's step is compared, not the drift of two runs);
- the optimizer alone, on the same grads: 1e-6 of the leaf's largest.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_guard_cases as guard_cases

from ltx_video_gpupoor_tpu import training as jtr
from ltx_video_gpupoor_tpu.models.ltx.transformer3d import (
    LTXTransformerConfig,
    init_params,
)
from ltx_video_gpupoor_tpu_torch.core import from_jax
from ltx_video_gpupoor_tpu_torch.core.dtypes import FP32_POLICY
from ltx_video_gpupoor_tpu_torch.models.ltx import transformer3d as ttf
from ltx_video_gpupoor_tpu_torch.ops import _lib
from ltx_video_gpupoor_tpu_torch.ops.attention import attention
from ltx_video_gpupoor_tpu_torch.ops.quant import quantize_params
from ltx_video_gpupoor_tpu_torch import training as ttr
from ltx_video_gpupoor_tpu_torch.training import trainer as ttrainer

KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8,
          out_channels=8, num_layers=2, cross_attention_dim=32,
          caption_channels=16)
CFG = LTXTransformerConfig(**KW)
SCALAR = dict(rtol=2e-6, atol=0)
LEAF = 1e-4
OPT = 1e-6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.jit(lambda k: init_params(k, CFG))(jax.random.key(0))


def _np_batch(seed=0, b=2, s=16, sc=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, CFG.in_channels).astype(np.float32),
            np.stack([rng.randint(0, 4, (b, s)) for _ in range(3)],
                     1).astype(np.float32),
            rng.randn(b, sc, CFG.caption_channels).astype(np.float32),
            np.ones((b, sc), np.int32))


def _batches(seed=0):
    a = _np_batch(seed)
    return (jtr.TrainBatch(*(jnp.asarray(x) for x in a)),
            ttr.TrainBatch(*(torch.from_numpy(x) for x in a)))


def _sd(tree):
    return from_jax.state_dict(jax.tree.map(np.asarray, tree))


def _model(params):
    model = ttf.LTXTransformer3D(ttf.LTXTransformerConfig(**KW),
                                 FP32_POLICY)
    model.load_state_dict(_sd(params))
    return model


def _draws(key, b, shape, tc):
    """What JAX's ``flow_match_loss`` draws from ``key``."""
    kt, kn = jax.random.split(key)
    t = jtr.sample_timesteps(kt, b, tc)
    eps = jax.random.normal(kn, shape, jnp.float32)
    return torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(eps))


def _close_by_leaf(got: dict, want: dict, rel: float, what: str):
    assert set(got) == set(want), what
    for n, w in want.items():
        w = w.numpy()
        g = got[n].detach().numpy()
        tol = rel * max(np.abs(w).max(), 1e-30)
        d = np.abs(g - w).max()
        assert d <= tol, f"{what} {n}: {d} > {tol}"


def _jax_tc(**kw):
    return jtr.TrainConfig(**kw), ttr.TrainConfig(**kw)


@pytest.mark.parametrize("sampling", ["uniform", "logit_normal"])
def test_loss_and_grads_match_jax(params, sampling):
    jtc, ttc = _jax_tc(timestep_sampling=sampling, remat=False)
    jb, tb = _batches(1)
    key = jax.random.key(2)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jtr.flow_match_loss(p, CFG, jb, key, jtc, "xla"),
        has_aux=True)(params)
    t, eps = _draws(key, 2, jb.tokens.shape, jtc)
    model = _model(params)
    ttrainer.trainable(model)
    tloss, tmetrics = ttr.flow_match_loss(model, tb, ttc, t=t, eps=eps,
                                          attn_mode="xla")
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(loss), **SCALAR)
    np.testing.assert_allclose(float(tmetrics["loss"]), float(loss),
                               **SCALAR)
    np.testing.assert_allclose(float(tmetrics["t_mean"]),
                               float(metrics["t_mean"]), **SCALAR)
    _close_by_leaf({n: p.grad for n, p in model.named_parameters()},
                   _sd(grads), LEAF, "grad")


def test_remat_matches_no_remat(params):
    """Per-block checkpointing gives the same loss and grads bit for bit
    (the recompute runs the same ops), and JAX's whole-forward
    ``jax.checkpoint`` agrees with both (JAX's test: rtol 1e-5)."""
    jb, tb = _batches(1)
    key = jax.random.key(2)
    jtc, _ = _jax_tc(remat=True)
    jloss, _ = jtr.flow_match_loss(params, CFG, jb, key, jtc, "xla")
    t, eps = _draws(key, 2, jb.tokens.shape, jtc)
    out = []
    for remat in (False, True):
        model = _model(params)
        ttrainer.trainable(model)
        loss, _ = ttr.flow_match_loss(model, tb, ttr.TrainConfig(remat=remat),
                                      t=t, eps=eps, attn_mode="xla")
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone()
                                    for n, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n
    np.testing.assert_allclose(float(out[1][0]), float(jloss), rtol=1e-5)


def _adam(opt_state):
    """The ``ScaleByAdamState`` of JAX's chain, by the port's names."""
    return from_jax.adamw_state(jax.tree.map(np.asarray, opt_state))


def _nu_hat_bound(lr, grads, state, b2):
    """Per element: the param bound of the module docstring."""
    c = int(state.count)
    out = {}
    for n, nu in state.nu.items():
        nu_hat = nu.numpy() / (1 - np.float32(b2) ** c)
        gmax = np.abs(grads[n].numpy()).max()
        out[n] = 2e-7 + lr * np.minimum(
            2.0, 8 * LEAF * gmax / (np.sqrt(nu_hat) + 1e-8))
    return out


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("steps", [1, 3])
def test_steps_match_jax(params, steps, clip):
    """JAX's jitted ``make_train_step`` and the port's, step by step from
    JAX's params and state: loss, grad_norm, params, mu, nu and count
    after step 1 (and 2, 3). The grad norm here is 5-7: ``grad_clip`` 1
    clips every step, 1e3 none."""
    jtc, ttc = _jax_tc(learning_rate=2e-3, remat=False, grad_clip=clip)
    jstep = jax.jit(jtr.make_train_step(CFG, jtc, attn_mode="xla"))
    jp, jo = params, jtr.init_train_state(params, jtc)
    key = jax.random.key(1)
    for i in range(steps):
        jb, tb = _batches(i)
        key, sub = jax.random.split(key)
        model = _model(jp)
        step = ttr.make_train_step(model, ttc, attn_mode="xla",
                                   state=_adam(jo))
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jtr.flow_match_loss(p, CFG, jb, sub, jtc, "xla"),
            has_aux=True)(jp)
        jp, jo, jm = jstep(jp, jo, jb, sub)
        t, eps = _draws(sub, 2, jb.tokens.shape, jtc)
        tm = step(tb, t=t, eps=eps)
        for k in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **SCALAR)
        assert (float(jm["grad_norm"]) > clip) == (clip == 1.0)
        want = _adam(jo)
        assert int(step.state.count) == int(want.count) == i + 1
        _close_by_leaf(step.state.mu, want.mu, LEAF, "mu")
        _close_by_leaf(step.state.nu, want.nu, 2 * LEAF, "nu")
        bound = _nu_hat_bound(jtc.learning_rate, _sd(grads), want, jtc.b2)
        for n, w in _sd(jp).items():
            d = np.abs(dict(model.named_parameters())[n].detach().numpy()
                       - w.numpy())
            assert (d <= bound[n]).all(), (n, d.max(), i)


@pytest.mark.parametrize("clip,scale", [(1.0, 0.5), (1e3, 1e-3),
                                        (1e-6, 1e-7)],
                         ids=["clipped", "unclipped", "clipped_tiny"])
def test_optimizer_matches_optax(params, clip, scale):
    """The port's AdamW and optax's chain on the same grads (drawn here),
    three steps: params, mu, nu, count. The decay mask, the clip above
    and below its bound and the bias correction are all in the
    arithmetic; at a global norm near 1e-5 (``clipped_tiny``) a clip that
    divided by ``norm + 1e-6``, as ``clip_grad_norm_`` does, would be 10 %
    off."""
    jtc, ttc = _jax_tc(learning_rate=2e-3, grad_clip=clip)
    update = jax.jit(jtr.make_optimizer(jtc).update)
    jp = params
    jo = jtr.init_train_state(params, jtc)
    model = _model(params)
    tp = ttrainer.trainable(model)
    topt = ttr.make_optimizer(ttc)
    state = topt.init(tp)
    gen = np.random.default_rng(3)
    names = list(_sd(params))
    for _ in range(3):
        g_sd = {n: gen.standard_normal(tp[n].shape).astype(np.float32)
                * scale for n in names}
        # the same grads as a JAX tree: a kernel is the weight transposed,
        # the blocks stacked
        g_tree = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jp))
        for n, g in g_sd.items():
            from_jax_key(g_tree, n, g)
        updates, jo = update(jax.tree.map(jnp.asarray, g_tree), jo, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        grads = {n: torch.from_numpy(g) for n, g in g_sd.items()}
        norm = ttrainer.global_norm(grads)
        assert (float(norm) > clip) == (clip < 1e3)
        topt.update_(tp, grads, state, norm)
    want = _adam(jo)
    assert int(state.count) == int(want.count) == 3
    _close_by_leaf(state.mu, want.mu, OPT, "mu")
    _close_by_leaf(state.nu, want.nu, OPT, "nu")
    _close_by_leaf(tp, _sd(jp), OPT, "param")


def from_jax_key(tree, name, value):
    """Write the port's leaf ``name`` into the JAX tree of numpy arrays."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, parts = int(parts[1]), ["blocks"] + parts[2:]
    else:
        i = None
    node = tree
    for p in parts[:-1]:
        node = node[p]
    leaf = parts[-1]
    if leaf == "weight" and "kernel" in node:
        leaf, value = "kernel", value.T
    if i is None:
        node[leaf] = value
    else:
        node[leaf][i] = value


def test_loss_decreases(params):
    """JAX's ``test_loss_decreases`` on the port: the same batch, fresh
    draws from a ``torch.Generator`` each step."""
    model = _model(params)
    step = ttr.make_train_step(model, ttr.TrainConfig(learning_rate=2e-3,
                                                      remat=False),
                               attn_mode="xla")
    _, tb = _batches(0)
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(tb, generator=gen)["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


# the block leaves JAX's mask decays only because the layer axis stacks
# them (rank 2 there), and the leaves it spares
DECAYED_BLOCK_LEAVES = sorted(
    [f"blocks.{a}.{m}.bias" for a in ("attn1", "attn2")
     for m in ("to_q", "to_k", "to_v", "to_out")]
    + [f"blocks.{a}.{m}.weight" for a in ("attn1", "attn2")
       for m in ("q_norm", "k_norm")]
    + ["blocks.ff.proj_in.bias", "blocks.ff.proj_out.bias"])
SPARED = sorted([
    "patchify_proj.bias", "adaln.emb_linear_1.bias",
    "adaln.emb_linear_2.bias", "adaln.linear.bias",
    "caption_projection.linear_1.bias", "caption_projection.linear_2.bias",
    "proj_out.bias", "scale_shift_table", "blocks.scale_shift_table"])


def test_decay_mask_is_jax_on_stacked_leaves(params):
    """14 block leaves of rank 1 here decay (JAX's mask sees them stacked,
    rank 2), 9 leaves are spared, every other (the linears' weights)
    decays: JAX's rule on JAX's own leaves, leaf by leaf."""
    from ltx_video_gpupoor_tpu.core.params import flatten

    verdict, rank = {}, {}
    for n, p in _model(params).named_parameters():
        key = re.sub(r"^blocks\.\d+\.", "blocks.", n)
        verdict.setdefault(key, set()).add(ttrainer.decays(n, p))
        rank[key] = p.dim()
    assert all(len(v) == 1 for v in verdict.values())
    verdict = {k: v.pop() for k, v in verdict.items()}
    assert sorted(k for k, v in verdict.items() if v and rank[k] == 1) \
        == DECAYED_BLOCK_LEAVES
    assert sorted(k for k, v in verdict.items() if not v) == SPARED
    jax_rule = {re.sub(r"\.kernel$", ".weight", k):
                v.ndim >= 2 and "scale_shift" not in k
                and "modulation" not in k
                for k, v in flatten(params).items()}
    assert jax_rule == verdict


def test_sample_timesteps_modes():
    gen = torch.Generator().manual_seed(0)
    t = ttr.sample_timesteps(gen, 1024,
                             ttr.TrainConfig(timestep_sampling="logit_normal"))
    assert t.dtype == torch.float32 and ((t > 0) & (t < 1)).all()
    tu = ttr.sample_timesteps(gen, 1024, ttr.TrainConfig())
    assert ((tu >= 0) & (tu < 1)).all()
    with pytest.raises(ValueError, match="timestep_sampling"):
        ttr.sample_timesteps(gen, 4, ttr.TrainConfig(timestep_sampling="x"))


@pytest.mark.parametrize("route", sorted(guard_cases.CASES))
def test_guard_refuses_kernel_routes_under_grad(route, monkeypatch):
    """Each kernel wrapper (``ops/attention.py``, ``ops/quant.py``,
    ``ops/fused_prologue.py``, K7's ``parallel/ring_rdma.py``, K8's
    ``tools/mb_selfattn_pipeline.py``) calls ``refuse_grad`` with its route
    and the inputs that require grad before it dispatches: with the guard
    taking every device for CUDA, the call raises, naming the route and
    the ``xla`` tier, and no kernel launches. The same calls on the card:
    ``tests/test_torch_cuda.py::test_guard_refuses_under_grad``."""
    real = _lib.refuse_grad
    monkeypatch.setattr(_lib, "refuse_grad",
                        lambda r, device, *ts: real(r, "cuda", *ts))
    call = guard_cases.CASES[route]("cpu")
    before = guard_cases.launches()
    with pytest.raises(RuntimeError, match=f"route {route} .*attn_mode='xla'"):
        call()
    assert guard_cases.launches() == before


def test_refuse_grad_predicate():
    """``refuse_grad`` raises only for a kernel route (a name, or a function
    that gives it) on a CUDA device with grad enabled and an input that
    requires grad; each missing condition passes."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="K1 .*attn_mode='xla'"):
        _lib.refuse_grad("K1", "cuda", None, x)
    with pytest.raises(RuntimeError, match="K1"):
        _lib.refuse_grad(lambda: "K1", torch.device("cuda", 0), x)
    _lib.refuse_grad("xla", "cuda", x)
    _lib.refuse_grad(lambda: "xla", "cuda", x)
    _lib.refuse_grad("K1", "cpu", x)
    _lib.refuse_grad("K1", "cuda", x.detach())
    with torch.no_grad():
        _lib.refuse_grad("K1", "cuda", x)


def test_guard_leaves_cpu_routes_differentiable(params):
    """On the CPU every tier is plain torch: ``auto`` and ``pallas``
    attention under grad run and give q a gradient, as before."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    for mode in ("auto", "pallas", "pallas_int8pv"):
        q.grad = None
        attention(q, q, q, mode=mode).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()


def test_trainable_refuses_quantized(params):
    model = quantize_params(_model(params), mode="dynamic")
    with pytest.raises(ValueError, match="quantized"):
        ttr.make_train_step(model, ttr.TrainConfig())
