"""Training checkpoint / resume, without orbax.

Port of ``ltx_video_gpupoor_tpu/training/checkpoint.py``:
:class:`TrainCheckpointer` keeps ``save``, ``latest_step``, ``restore``,
``close``, ``max_to_keep`` retention and an atomic commit. Each step is a
directory ``step_<n>`` holding one safetensors file (the port's own
``core/checkpoint.py`` reader and writer) with the parameters
(``params/<name>``), the AdamW state (``count``, ``mu/<name>``,
``nu/<name>``) and the RNG (``rng``). A save writes ``step_<n>.tmp``,
fsyncs it, then renames it: a step that is listed is whole, and a
``.tmp`` left by a crash is never listed.

The RNG is the ``torch.Generator``'s state bytes, restored bit for bit.
JAX stores raw key data and rewraps it under the target key's
implementation (:40-71: threefry, rbg); the port has one generator type,
so those cases have no counterpart.

On a mesh the file holds whole leaves: ``save`` gathers each tp-cut
parameter and its moments over the tp group (``parallel/sharding.py``'s
``tp_cuts``) and global rank 0 writes; ``restore`` gives each rank the
cut of ``shard_params``. So a one-process save restores onto dp x sp x
tp, and a mesh save onto one process (JAX's orbax reshards on read).
Everything here is host work between steps.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from ..core.checkpoint import load_safetensors, save_safetensors
from .trainer import AdamWState

_STEP = re.compile(r"step_(\d+)")
_FILE = "state.safetensors"


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class TrainCheckpointer:
    """Save / restore a model's parameters, its :class:`AdamWState` and a
    ``torch.Generator`` by step::

        ckpt = TrainCheckpointer("/ckpts/run1")
        ckpt.save(step, model, opt_state, generator)
        ...
        step = ckpt.restore(model, opt_state, generator)   # in place
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP.fullmatch,
                                                    os.listdir(self.directory))
                      if m is not None)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    # -- write ---------------------------------------------------------
    def save(self, step: int, model: torch.nn.Module, opt_state: AdamWState,
             generator: torch.Generator) -> None:
        """Commit step ``step`` (a step already saved raises). On a mesh
        every rank calls it: the tp-cut leaves are gathered, rank 0
        writes, and every rank returns once the step is committed."""
        from ..parallel.sharding import gather_param, tp_cuts

        cuts = tp_cuts(model)

        def whole(name, t):
            return gather_param(t, cuts[name]) if name in cuts else t

        tensors = {}
        for name, p in model.named_parameters():
            tensors[f"params/{name}"] = whole(name, p.detach())
            tensors[f"mu/{name}"] = whole(name, opt_state.mu[name])
            tensors[f"nu/{name}"] = whole(name, opt_state.nu[name])
        tensors["count"] = opt_state.count.reshape(1)
        tensors["rng"] = generator.get_state()
        if not _distributed() or dist.get_rank() == 0:
            self._commit(step, tensors)
        if _distributed():
            dist.barrier()

    def _commit(self, step: int, tensors: dict) -> None:
        final = self._path(step)
        if os.path.exists(final):
            raise FileExistsError(f"step {step} is already saved: {final}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_safetensors(os.path.join(tmp, _FILE), tensors)
        _fsync(os.path.join(tmp, _FILE))
        _fsync(tmp)
        os.rename(tmp, final)
        _fsync(self.directory)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    # -- read ----------------------------------------------------------
    @torch.no_grad()
    def restore(self, model: torch.nn.Module, opt_state: AdamWState,
                generator: torch.Generator,
                step: Optional[int] = None) -> int:
        """Load step ``step`` (the latest by default) into ``model``,
        ``opt_state`` and ``generator`` in place, each rank its cut;
        returns the step. No such step: ``FileNotFoundError``."""
        from ..parallel.sharding import cut_param, tp_cuts

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.directory!r}")
        path = os.path.join(self._path(step), _FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no step {step} under {self.directory!r} (steps "
                f"{self.all_steps()})")
        tensors, _ = load_safetensors(path)
        cuts = tp_cuts(model)

        def local(key, name, like):
            t = tensors[f"{key}/{name}"]
            if name in cuts:
                t = cut_param(t, cuts[name])
            if t.shape != like.shape:
                raise ValueError(f"{key}/{name}: {tuple(t.shape)} in the "
                                 f"checkpoint, {tuple(like.shape)} here")
            return t.to(device=like.device, dtype=like.dtype)

        for name, p in model.named_parameters():
            p.copy_(local("params", name, p))
            opt_state.mu[name] = local("mu", name, opt_state.mu[name])
            opt_state.nu[name] = local("nu", name, opt_state.nu[name])
        opt_state.count = tensors["count"].reshape(()).to(
            opt_state.count.device)
        generator.set_state(tensors["rng"])
        return int(step)

    def close(self) -> None:
        """Nothing to release (every save is committed when it returns);
        kept for JAX's interface."""
