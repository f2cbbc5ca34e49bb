"""The device mesh over ``torch.distributed`` ranks, and a rank launcher.

Port of ``ltx_video_gpupoor_tpu/core/mesh.py``: the axis names,
``MeshConfig.resolve`` (:38), ``parse_mesh_spec`` (:77) and
``mesh_from_env`` (:99-121, a mis-sized ``LTXV_TPU_MESH`` logs one warning
and serves on one device) are copied. JAX has one controller over every
device; here every rank is a process of its own (``torchrun`` in serving,
:func:`spawn_ranks` in the tests and ``chip_smoke.py``), and
:func:`make_mesh` builds the three-axis ``DeviceMesh`` (``dp``, ``sp``,
``tp``), one process group an axis. Every collective of the port is
written out (``parallel/comm.py``): nothing is inserted for it.

Ranks and devices: ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from
the environment ``torchrun`` sets; a rank's device is ``cuda:LOCAL_RANK``
(modulo the cards it sees) unless the caller asks for the CPU. Every rank
sees every card of the host: a per-rank ``CUDA_VISIBLE_DEVICES`` would
hide its neighbours' cards from the CUDA IPC that K7 once per card maps
their memory through. The backend is NCCL when each rank has a card of
its own; ``gloo`` only when the caller names it (the CPU tests, and two
ranks sharing one card). A backend that fails to start raises: nothing
switches to another one.

Functions that run a layer of one rank's model under the mesh read it
from :func:`active_mesh`, which :func:`use_mesh` sets (the port's
counterpart of the axis names that JAX's ``shard_map`` binds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import os
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
SEQUENCE_AXIS = "sp"
TENSOR_AXIS = "tp"
AXIS_NAMES = (DATA_AXIS, SEQUENCE_AXIS, TENSOR_AXIS)

DEFAULT_TIMEOUT_S = 600.0

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` on one axis means "use remaining ranks"."""

    dp: int = 1
    sp: int = 1
    tp: int = -1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        dims = [self.dp, self.sp, self.tp]
        if any(d == 0 or d < -1 for d in dims):
            raise ValueError(
                f"mesh dims must be positive or -1, got {dims}"
            )
        free = [i for i, d in enumerate(dims) if d == -1]
        fixed = math.prod(d for d in dims if d != -1)
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed mesh dims {dims}"
            )
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free:
            dims[free[0]] = n_devices // fixed
        elif math.prod(dims) != n_devices:
            raise ValueError(f"mesh {dims} != {n_devices} devices")
        return tuple(dims)


def parse_mesh_spec(spec: str) -> Optional[MeshConfig]:
    """``"dp2,sp2,tp2"`` / ``"sp=4,tp=2"`` -> MeshConfig (unnamed axes
    default to 1); ``"auto"`` -> tensor-parallel over every rank;
    empty/``"off"`` -> None."""
    spec = (spec or "").strip().lower()
    if not spec or spec in ("off", "0", "false", "none", "1x1x1"):
        return None
    if spec == "auto":
        return MeshConfig(dp=1, sp=1, tp=-1)
    dims = {}
    for part in spec.split(","):
        part = part.strip().replace("=", "")
        axis, num = part[:2], part[2:]
        if axis not in AXIS_NAMES or not (num == "-1" or num.isdigit()):
            raise ValueError(
                f"bad mesh spec {spec!r}: want e.g. 'dp1,sp2,tp4' or 'auto'"
            )
        dims[axis] = int(num)
    return MeshConfig(**{a: dims.get(a, 1) for a in AXIS_NAMES})


def dist_env() -> tuple[int, int, int]:
    """``(rank, world, local_rank)`` of this process: the process group's
    when one is up, else ``torchrun``'s environment (one rank without it)."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
    return rank, world, int(os.environ.get("LOCAL_RANK", str(rank)))


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the visible cards,
    so that ranks may share one) unless ``device`` names another."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the CPU")
    local = dist_env()[2]
    return torch.device("cuda", local % torch.cuda.device_count())


def init_ranks(backend: Optional[str] = None, device: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S, store=None) -> None:
    """Start this process's group from ``torchrun``'s environment (or
    ``store``): NCCL on CUDA unless ``backend`` says otherwise, gloo on
    the CPU. A failure to start raises."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank, world, _ = dist_env()
    kw: dict[str, Any] = dict(
        backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world)
    dist.init_process_group(**kw)
    global _GROUP_TIMEOUT_S
    _GROUP_TIMEOUT_S = float(timeout)


_GROUP_TIMEOUT_S = DEFAULT_TIMEOUT_S


def group_timeout() -> float:
    """The seconds a collective of this process's group waits at most."""
    return _GROUP_TIMEOUT_S


def make_mesh(config: MeshConfig | None = None,
              device_type: Optional[str] = None):
    """The three-axis ``DeviceMesh`` over every rank of the (started)
    process group; ``device_type`` defaults to the backend's (``cuda``
    under NCCL, else ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group "
                           "(init_ranks, or torchrun + init_ranks)")
    config = config or MeshConfig()
    shape = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_NAMES)


def mesh_from_env(env_var: str = "LTXV_TPU_MESH",
                  device_type: Optional[str] = None,
                  backend: Optional[str] = None,
                  device: Optional[str] = None):
    """The serving mesh from ``LTXV_TPU_MESH`` (e.g. ``dp1,sp2,tp1`` or
    ``auto``) over ``torchrun``'s ranks, or None when unset, one rank, or
    not satisfiable by the world size (a mis-sized spec must not take the
    server down: it logs and serves on one device). A process group that
    fails to start raises."""
    raw = os.environ.get(env_var, "")
    world = dist_env()[1]
    try:
        cfg = parse_mesh_spec(raw)
        if cfg is None:
            return None
        if math.prod(cfg.resolve(world)) <= 1:
            return None
    except ValueError as e:
        _log.warning("%s=%r not usable on %d ranks (%s) — serving "
                     "single-device", env_var, raw, world, e)
        return None
    init_ranks(backend=backend, device=device)
    return make_mesh(cfg, device_type)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_shape(mesh) -> dict:
    """``{"dp": .., "sp": .., "tp": ..}``."""
    return {a: axis_size(mesh, a) for a in AXIS_NAMES}


_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one that ``ulysses:<axis>`` modes and the other
    in-layer collectives resolve their axis against."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    if not _ACTIVE:
        raise RuntimeError("no active mesh: run under core.mesh.use_mesh "
                           "(the usp_* forwards set it)")
    return _ACTIVE[-1]


# ---- the rank launcher ----------------------------------------------------


class RankError(RuntimeError):
    """A spawned rank failed (its traceback is the message) or the group
    outlived its deadline."""


def _rank_main(fn, rank, world, backend, store_path, timeout, device, args,
               out_dir, threads, env):
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        init_ranks(backend=backend, device=device, timeout=timeout,
                   store=store)
        # every rank has connected before any goes on: a gloo rank whose
        # fn returns at once could otherwise exit, closing its sockets,
        # while a peer is still connecting in init_process_group
        # ("Connection closed by peer" there)
        dist.barrier()
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def spawn_ranks(fn: Callable, world: int, *, backend: str = "gloo",
                timeout: float = 120.0, device: Optional[str] = "cpu",
                store_dir: Optional[str] = None, args: Sequence = (),
                threads: int = 1, env: Optional[dict] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes, each a rank of
    one process group (``backend``; its ``timeout`` in seconds), and return
    each rank's result in rank order. Processes start by ``spawn`` (never
    ``fork`` once CUDA is up); the group meets at a ``FileStore`` in
    ``store_dir`` (a fresh temporary directory by default: no TCP port,
    so concurrent launchers cannot collide). ``device`` None puts rank r
    on ``cuda:r`` (modulo the cards); ``threads``: intra-op threads a rank
    (0 = torch's default). A rank that raises, or a group still running
    ``timeout + 30`` s after its start, kills every rank and raises
    :class:`RankError` with the traceback of the rank that failed first."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    own = store_dir is None
    base = tempfile.mkdtemp(prefix="ranks_") if own else store_dir
    run_dir = os.path.join(base, uuid.uuid4().hex[:12])
    os.makedirs(run_dir)
    store_path = os.path.join(run_dir, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, store_path, timeout,
                               device, tuple(args), run_dir, threads,
                               dict(env or {})))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 30.0
        failed_at = None
        while any(p.is_alive() for p in procs):
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            # the others get a moment to write their own tracebacks
            if failed_at is not None and time.monotonic() - failed_at > 5.0:
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        timed_out = any(p.is_alive() for p in procs) and failed_at is None
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10.0)
        errs = []
        for r in range(world):
            path = os.path.join(run_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as fh:
                    errs.append((os.stat(path).st_mtime_ns, r, fh.read()))
        if errs:
            # the first to fail (the others mostly fail because it did)
            _, r, tb = min(errs)
            raise RankError(f"rank {r} of {world} failed:\n{tb}")
        if timed_out:
            raise RankError(f"{world} ranks outlived their deadline "
                            f"({timeout + 30.0:.0f} s); killed")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RankError(f"ranks exited with codes {bad} and no "
                            "traceback")
        return [torch.load(os.path.join(run_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(base if own else run_dir, ignore_errors=True)
