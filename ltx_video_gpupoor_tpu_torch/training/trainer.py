"""Flow-matching trainer for the LTX DiT.

Port of ``ltx_video_gpupoor_tpu/training/trainer.py``: ``TrainBatch``,
``TrainConfig``, ``sample_timesteps`` (:82-91), ``flow_match_loss``
(:94-122), ``make_optimizer`` (:55-79), ``make_train_step`` (:125-158) and
``init_train_state`` (:161-167). The network sees ``z_t = (1 - t) x0 + t
eps`` and must output the velocity ``eps - x0``; the loss is the MSE in
fp32.

What differs in form, not in function:

- The step works in place on a module: the grads follow each parameter's
  dtype and are cast to fp32 leaf by leaf; the update is computed on an
  fp32 copy of one leaf at a time and cast back to the leaf's dtype (no
  fp32 master copy, as in JAX, and never a second fp32 copy of the whole
  model).
- The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written
  out (:class:`AdamW`): the clip divides by the global norm alone, and
  only when the norm is not under the bound (``torch``'s
  ``clip_grad_norm_`` adds 1e-6 and always scales); ``mu`` and ``nu`` in
  fp32, bias correction by ``count``, ``eps_root`` 0. Its decay mask is
  JAX's, evaluated on JAX's leaves: the blocks are stacked there, so a
  block's biases and q/k norm weights have two dims and are decayed
  (:func:`decays`; a JAX caveat copied on purpose, for parity).
- ``remat`` checkpoints each block (``LTXTransformer3D.forward``'s
  ``remat``) where JAX checkpoints the whole forward: the same function
  and grads, with one block's residuals alive at a time.
- JAX draws ``t`` and ``eps`` from a key; here from a ``torch.Generator``
  (t first, then eps), or they are handed over (``t=``, ``eps=``), as the
  parity tests do with JAX's draws.
- No hand-written kernel has a backward: the step runs the ``xla``
  attention tier and dense linears, as the JAX trainer's tests do (JAX's
  grad cannot pass its Pallas attention either). A kernel route under
  autograd on CUDA tensors raises (``ops/_lib.py::refuse_grad``), and
  :func:`trainable` refuses a quantized ``Linear``.

With a ``mesh`` (``core/mesh.py``) the step is the one JAX jits over a dp
x sp x tp mesh, with every collective written out: each rank takes its dp
rows of the global batch and runs ``parallel/usp.py``'s forward on its sp
tokens with its tp-sharded modules (``parallel/sharding.py``); the loss
is the global mean (each rank's sum over the global count); the grads of
every leaf are summed over dp and sp, never over tp; the global norm
counts a replicated leaf once and sums the squares of the tp-cut leaves
over tp.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from ..core import mesh as _mesh
from ..models.ltx.transformer3d import LTXTransformer3D
from ..ops.quant import Linear
from ..schedulers import rf


class TrainBatch(NamedTuple):
    """One training micro-batch of patchified latent tokens."""

    tokens: torch.Tensor        # [B, S, C] clean latents (patchified)
    coords: torch.Tensor        # [B, 3, S] fractional latent coordinates
    caption: torch.Tensor       # [B, Sc, caption_channels]
    caption_mask: torch.Tensor  # [B, Sc] 1 = keep


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # timestep sampling: "uniform" or "logit_normal" (SD3-style)
    timestep_sampling: str = "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    remat: bool = True


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: ``count`` (int32 scalar) and the fp32
    moments ``mu`` / ``nu`` by parameter name (this rank's share of a
    tp-cut leaf)."""

    count: torch.Tensor
    mu: dict
    nu: dict


def decays(name: str, p: torch.Tensor) -> bool:
    """JAX's decay mask (:60-71) on JAX's leaf: rank >= 2 and no
    ``scale_shift`` / ``modulation`` in the key. JAX stacks the blocks
    (``blocks.3.`` is one leaf ``blocks.`` with one more dim), so a block's
    biases and q/k norm weights are rank 2 there and decay; the top-level
    biases and the scale-shift tables do not."""
    ndim = p.dim() + (1 if re.match(r"blocks\.\d+\.", name) else 0)
    return ndim >= 2 and "scale_shift" not in name \
        and "modulation" not in name


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1, b2, weight_decay=weight_decay, mask=decay_mask))`` in optax's
    arithmetic, applied in place one leaf at a time."""

    eps = 1e-8      # optax's adamw default (and eps_root 0)

    def __init__(self, tc: TrainConfig):
        self.tc = tc

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        dev = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros, nu={n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: AdamWState,
                g_norm: torch.Tensor) -> None:
        """One step: clip by ``g_norm`` (the global norm of the fp32
        grads), AdamW, ``p += update`` in fp32, cast back."""
        tc = self.tc
        b1, b2 = tc.b1, tc.b2
        clip = not bool(g_norm < tc.grad_clip)
        state.count = state.count + 1
        c = state.count.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=c.device) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=c.device) ** c
        for name, p in params.items():
            g = grads[name]
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device) \
                if g is None else g.float()
            if clip:
                g = (g / g_norm) * tc.grad_clip
            mu = (1 - b1) * g + b1 * state.mu[name]
            nu = (1 - b2) * (g ** 2) + b2 * state.nu[name]
            state.mu[name], state.nu[name] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p32 = p.float()
            if decays(name, p):
                u = u + tc.weight_decay * p32
            p.copy_((p32 + (-tc.learning_rate) * u).to(p.dtype))


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(tc)


def init_train_state(model: LTXTransformer3D, tc: TrainConfig,
                     optimizer: Optional[AdamW] = None) -> AdamWState:
    """The optimizer state of ``model``'s parameters (zeros, count 0)."""
    opt = optimizer if optimizer is not None else make_optimizer(tc)
    return opt.init(dict(model.named_parameters()))


def sample_timesteps(generator: torch.Generator, batch: int,
                     tc: TrainConfig, device=None) -> torch.Tensor:
    """``[batch]`` fp32: U[0, 1), or ``sigmoid(N(0, 1) * std + mean)``."""
    dev = generator.device
    if tc.timestep_sampling == "logit_normal":
        u = torch.randn(batch, generator=generator, device=dev) \
            * tc.logit_std + tc.logit_mean
        t = torch.sigmoid(u)
    elif tc.timestep_sampling != "uniform":
        raise ValueError(
            f"unknown timestep_sampling {tc.timestep_sampling!r} "
            "(expected 'uniform' or 'logit_normal')")
    else:
        t = torch.rand(batch, generator=generator, device=dev)
    return t if device is None else t.to(device)


def trainable(model: LTXTransformer3D) -> dict[str, torch.nn.Parameter]:
    """Turn ``requires_grad`` on for every parameter of the DiT and return
    them by name. A quantized ``Linear`` holds codes, not a weight to
    train (JAX trains dense ``kernel`` leaves): refused."""
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.quantized:
            raise ValueError(f"{name} is quantized ({mod.mode}): the "
                             "trainer trains dense weights")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def _draws(batch: TrainBatch, tc: TrainConfig, generator, t, eps):
    b = batch.tokens.shape[0]
    dev = batch.tokens.device
    if t is None or eps is None:
        if generator is None:
            raise ValueError("flow_match_loss needs a generator, or t and eps")
    if t is None:
        t = sample_timesteps(generator, b, tc, dev)
    if eps is None:
        eps = torch.randn(batch.tokens.shape, generator=generator,
                          device=generator.device,
                          dtype=torch.float32).to(dev)
    return (torch.as_tensor(t, dtype=torch.float32, device=dev),
            torch.as_tensor(eps, dtype=torch.float32, device=dev))


def _dp_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    from ..parallel.ulysses import shard_seq

    return shard_seq(x, mesh, _mesh.DATA_AXIS, 0)


def _sum_over(x: torch.Tensor, mesh, axes=(_mesh.DATA_AXIS,
                                            _mesh.SEQUENCE_AXIS)):
    from ..parallel import comm

    for axis in axes:
        if _mesh.axis_size(mesh, axis) > 1:
            comm.all_reduce(x, _mesh.axis_group(mesh, axis))
    return x


def flow_match_loss(model: LTXTransformer3D, batch: TrainBatch,
                    tc: TrainConfig, *, generator=None, t=None, eps=None,
                    attn_mode: str = "auto", mesh=None
                    ) -> tuple[torch.Tensor, dict]:
    """``(loss, {"loss", "t_mean"})``: the velocity MSE at ``z_t =
    rf.add_noise(x0, eps, t)`` (cast to the tokens' dtype). ``t`` ``[B]``
    and ``eps`` (x0's shape) are drawn from ``generator`` unless given.
    With a ``mesh``, ``batch``, ``t`` and ``eps`` are global, and the
    returned ``loss`` is this rank's share of the global mean (its grads,
    summed over dp and sp, are the mean's); ``metrics["loss"]`` is the
    global mean."""
    t, eps = _draws(batch, tc, generator, t, eps)
    t_mean = torch.mean(t)
    x0 = batch.tokens.float()
    n = x0.numel()
    tokens, coords, caption, mask = batch
    if mesh is not None:
        t, eps, x0, tokens, coords, caption, mask = (
            _dp_rows(x, mesh) for x in (t, eps, x0, tokens, coords, caption,
                                        mask))
    z_t = rf.add_noise(x0, eps, t).to(tokens.dtype)
    target = eps - x0
    if mesh is None:
        v = model(z_t, coords, t, caption, mask, attn_mode=attn_mode,
                  remat=tc.remat).float()
        loss = torch.mean(torch.square(v - target))
        return loss, {"loss": loss.detach(), "t_mean": t_mean}
    from ..parallel.ulysses import shard_seq
    from ..parallel.usp import usp_ltx_forward

    v = usp_ltx_forward(mesh, model, z_t, coords, t, caption, mask,
                        attn_mode=attn_mode, remat=tc.remat)[0].float()
    target = shard_seq(target, mesh, _mesh.SEQUENCE_AXIS, 1)
    local = torch.sum(torch.square(v - target))
    total = _sum_over(local.detach().clone(), mesh)
    return local / n, {"loss": total / n, "t_mean": t_mean}


def global_norm(grads: Mapping[str, torch.Tensor], cuts=None
                ) -> torch.Tensor:
    """optax's ``global_norm`` of the fp32 grads; a leaf in ``cuts``
    (``parallel.sharding.tp_cuts``) is this rank's share, and those
    leaves' squares are summed over the tp group."""
    from ..parallel import comm

    cuts = cuts or {}
    dev = next(g for g in grads.values() if g is not None).device
    rep = torch.zeros((), dtype=torch.float32, device=dev)
    shd = torch.zeros((), dtype=torch.float32, device=dev)
    for name, g in grads.items():
        if g is None:
            continue
        sq = torch.sum(torch.square(g.float()))
        if name in cuts:
            shd = shd + sq
        else:
            rep = rep + sq
    if cuts:
        tp = next(iter(cuts.values()))[0]
        comm.all_reduce(shd, tp.group)
    return torch.sqrt(rep + shd)


GRAD_BUCKET = 1 << 26   # values a flat bucket of grads holds (fp32)


def _reduce_grads(params: Mapping[str, torch.Tensor], mesh) -> None:
    """Sum every leaf's grad over dp and sp, in fp32, in flat buckets of
    up to :data:`GRAD_BUCKET` values: one all-reduce a bucket and an axis.
    A bf16 leaf's grad is each rank's partial, already rounded to bf16 by
    its backward; the sum in fp32 is rounded to bf16 once more."""
    grads = []
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    while grads:
        n, take = 0, 0
        while take < len(grads) and (
                take == 0 or n + grads[take].numel() <= GRAD_BUCKET):
            n += grads[take].numel()
            take += 1
        group, grads = grads[:take], grads[take:]
        flat = torch.cat([g.reshape(-1).float() for g in group])
        _sum_over(flat, mesh)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_train_step(model: LTXTransformer3D, tc: TrainConfig,
                    optimizer: Optional[AdamW] = None,
                    attn_mode: str = "auto", *, mesh=None,
                    state: Optional[AdamWState] = None) -> Callable:
    """``step(batch, *, generator=None, t=None, eps=None) -> metrics``
    (``loss``, ``t_mean``, ``grad_norm``), which updates ``model``'s
    parameters and ``step.state`` (the :class:`AdamWState`, initialized
    here unless given) in place. Its two halves are ``step.backward``
    (the same arguments: the loss, and each parameter's ``.grad`` in its
    dtype, summed over dp and sp) and ``step.update(metrics)`` (the
    global norm, the clip and AdamW; the grads are freed);
    ``step.params`` are the parameters by name, ``step.cuts`` the tp-cut
    ones (``parallel.sharding.tp_cuts``). With a ``mesh``, ``model`` is
    this rank's (``parallel.sharding.shard_params`` first) and every rank
    passes the same global batch and draws."""
    from ..parallel.sharding import tp_cuts

    opt = optimizer if optimizer is not None else make_optimizer(tc)
    params = trainable(model)
    cuts = tp_cuts(model) if mesh is not None else {}

    def backward(batch: TrainBatch, *, generator=None, t=None, eps=None
                 ) -> dict:
        for p in params.values():
            p.grad = None
        scope = _mesh.use_mesh(mesh) if mesh is not None \
            else contextlib.nullcontext()
        with scope:
            # the backward recomputes remat blocks, whose collectives
            # resolve their axes against the active mesh
            loss, metrics = flow_match_loss(
                model, batch, tc, generator=generator, t=t, eps=eps,
                attn_mode=attn_mode, mesh=mesh)
            loss.backward()
        if mesh is not None:
            _reduce_grads(params, mesh)
        return metrics

    def update(metrics: dict) -> dict:
        grads = {n: p.grad for n, p in params.items()}
        g_norm = global_norm(grads, cuts)
        opt.update_(params, grads, step.state, g_norm)
        for p in params.values():
            p.grad = None
        return dict(metrics, grad_norm=g_norm)

    def step(batch: TrainBatch, *, generator=None, t=None, eps=None
             ) -> dict:
        return update(backward(batch, generator=generator, t=t, eps=eps))

    step.backward, step.update = backward, update
    step.state = state if state is not None else opt.init(params)
    step.params, step.cuts = params, cuts
    return step
