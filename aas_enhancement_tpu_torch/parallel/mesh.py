"""Data parallelism: one process (rank) per device, ``torch.distributed``
(counterpart of ``aas_enhancement_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``Mesh(('data',))`` over its devices, shards the
batch's rows on the data axis, replicates the state, and lets GSPMD insert
the gradient reduction into the jitted step.  Here each rank is a process
with one device (``torchrun --nproc_per_node N``, or an explicit
``init_method`` for tests):

- every rank builds the same global batch (the data pipeline is
  deterministic), pads it, and moves only its own contiguous row block to
  its device (``shard_batch``), as the JAX package's hosts do;
- rank 0's parameters and buffers are broadcast once at the start
  (``replicate_state``);
- the train step sums each network's gradients over the ranks with one
  all-reduce per network and dtype on a flat buffer, and the metrics with
  one more (``all_reduce_grads``), before clipping and the update, so every
  rank applies the same update.

DDP is not used: the steps take their gradients with
``torch.autograd.grad``, and DDP's reducer hooks only ``.backward()``.

The backend is nccl for CUDA devices and gloo for the CPU unless the caller
names one.  nccl needs a device of its own for each rank; two ranks that
share one card (a check on a one-card machine) take gloo, which reduces
CUDA tensors through host copies (``DataMesh.all_reduce_``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from aas_enhancement_tpu_torch.config import MeshConfig
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device

WEIGHT_KEYS = {"wav": "row_weights", "clean_wav": "clean_row_weights"}


@dataclasses.dataclass
class DataMesh:
    """The data axis as this process sees it.  ``group`` is None for a run
    of one process that made no process group (then every collective is a
    no-op)."""

    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    backend: str | None = None
    group: Any = None
    owns_group: bool = False

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (gloo on a CUDA tensor: through
        a host copy)."""
        if self.group is None:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``src``'s ``t`` into every rank's, in place."""
        if self.group is None:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=self.group)
        return t

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` in every rank (a decision that gates a
        collective, such as a save, must be the same everywhere)."""
        if self.group is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.broadcast_(t).item())

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owns_group = None, False


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def make_mesh(cfg: MeshConfig | None = None, device: torch.device | str = "cuda",
              backend: str | None = None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> DataMesh:
    """This process's place on the data axis, and the process group.

    The ranks come from ``rank`` / ``world_size`` when given (with
    ``init_method``, e.g. ``file:///tmp/store``), else from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); an initialised default group is taken
    as it is.  Without any of these the run is one process and no group is
    made.  ``cfg.num_devices`` 0 means every launched process; any other
    value must equal the world size.  ``backend`` defaults to nccl for a
    CUDA device and gloo for the CPU; nccl refuses (before any init) a rank
    whose card another rank of the host would share.  A CUDA ``device``
    without an index is ``cuda:<local rank>`` in a launched run (the local
    rank is ``LOCAL_RANK``, else the rank).  ``cfg.data_axis`` only names
    the one axis in the JAX package's mesh; the port has no use for the
    name.  More than one host: every rank restores from its own view of a
    checkpoint directory, so ``--continue-from`` needs one that every rank
    sees (``replicate_state`` raises where the ranks restored other steps)."""
    cfg = cfg or MeshConfig()
    device = torch.device(device)
    if dist.is_initialized() and rank is None:
        rank, world_size = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
        launched, owns = True, False
    else:
        launched = rank is not None or init_method is not None or "WORLD_SIZE" in os.environ
        owns = launched
        if rank is None:
            rank = _env_int("RANK") or 0
        if world_size is None:
            world_size = _env_int("WORLD_SIZE") or 1
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank
    n = cfg.num_devices
    if n and n != world_size:
        raise ValueError(
            f"make_mesh: mesh.num_devices = {n} but {world_size} process(es) were "
            f"launched (one a device); launch {n} with `torchrun --nproc_per_node {n}` "
            f"or set mesh.num_devices 0 (every launched process)")
    if device.type == "cuda" and device.index is None and launched:
        device = torch.device("cuda", local_rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and launched:
        if device.type != "cuda":
            raise ValueError(f"make_mesh: backend nccl needs CUDA devices, got {device}; "
                             "use backend gloo")
        on_host = _env_int("LOCAL_WORLD_SIZE") or world_size
        if device.index != local_rank or on_host > torch.cuda.device_count():
            raise ValueError(
                f"make_mesh: backend nccl needs a card for each rank, but rank {rank} "
                f"(local rank {local_rank} of {on_host} on this host) is on {device} "
                f"with {torch.cuda.device_count()} card(s) visible: two ranks would "
                "share one card; use backend gloo for that")
    device = resolve_device(device)
    if not launched:
        return DataMesh(device=device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return DataMesh(rank=rank, world=world_size, device=device, backend=backend,
                    group=dist.group.WORLD, owns_group=owns)


def process_local_rows(v, process_count: int, process_index: int):
    """The rows of a global batch that belong to one process (contiguous
    row-block layout, matching a 1-D data-axis sharding over processes)."""
    g = v.shape[0]
    if g % process_count:
        raise ValueError(f"global batch {g} not divisible by "
                         f"{process_count} processes")
    per = g // process_count
    return v[process_index * per: (process_index + 1) * per]


def pad_batch_to_devices(batch: dict[str, Any], n: int) -> dict[str, Any]:
    """Repeat-pad the batch dim to a multiple of n (shard evenness requirement)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        b = v.shape[0]
        rem = (-b) % n
        if rem:
            # np.resize tiles the batch cyclically, covering rem > b (e.g. b=2,
            # n=8 -> 8 rows), which a single v[:rem] concat would not.
            v = np.resize(np.asarray(v), (b + rem,) + tuple(v.shape[1:]))
        out[k] = v
    return out


def shard_batch(mesh: DataMesh, batch: dict[str, Any], grad_accum: int = 1
                ) -> dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors, the same global batch in
    every rank) -> this rank's row block on its device.

    The batch is padded to a multiple of world x ``grad_accum`` rows
    (``pad_batch_to_devices``), so each rank's block splits into
    ``grad_accum`` microbatches whose rows are the global rows r % k == i,
    the microbatches of a one-process run.  The padded rows weigh 0: each
    stream that gains rows gets its weight array (``row_weights`` for
    ``wav``, ``clean_row_weights`` for ``clean_wav``; all ones where the
    batch has none) zeroed past its real rows."""
    batch = {k: np.asarray(v) for k, v in batch.items() if v is not None}
    padded = pad_batch_to_devices(batch, mesh.world * max(1, grad_accum))
    for k, w_key in WEIGHT_KEYS.items():
        if k not in batch or padded[k].shape[0] == batch[k].shape[0]:
            continue
        rows = batch[k].shape[0]
        w = np.zeros(padded[k].shape[0], np.float32)
        w[:rows] = batch[w_key] if w_key in batch else 1.0
        padded[w_key] = w
    return {k: torch.from_numpy(np.ascontiguousarray(
                process_local_rows(v, mesh.world, mesh.rank))).to(mesh.device)
            for k, v in padded.items()}


def replicate_state(mesh: DataMesh, state: Any) -> Any:
    """Broadcast rank 0's parameters and buffers of every network of
    ``state`` (a ``TrainState``) to all ranks, in place.  The optimizer
    state starts empty or is restored on every rank from the same step:
    ranks that hold other steps (a checkpoint directory that not every rank
    sees) raise in every rank, before any parameter moves."""
    if not mesh.distributed:
        return state
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    first = int(mesh.broadcast_(step.clone()).item())
    off = mesh.all_reduce_(torch.tensor([int(first != state.step)], dtype=torch.int64,
                                        device=mesh.device))
    if off.item():
        raise RuntimeError(
            f"replicate_state: the ranks hold different steps (rank 0 {first}, rank "
            f"{mesh.rank} {state.step}); every rank restores from its own view of the "
            "checkpoint directory, so a resumed run needs one that every rank sees")
    for name in ("g", "d", "am"):
        net = getattr(state, name)
        if net is None:
            continue
        with torch.no_grad():
            for t in (*net.parameters(), *net.buffers()):
                mesh.broadcast_(t.data)
    return state


def all_reduce_grads(mesh: DataMesh, grads: dict[str, dict[str, torch.Tensor]],
                     aux: dict[str, torch.Tensor]
                     ) -> tuple[dict[str, dict[str, torch.Tensor]], dict[str, torch.Tensor]]:
    """Sum ``grads`` ({network: {name: gradient}}) and the metrics ``aux``
    over the ranks: one all-reduce on a flat buffer per network and dtype,
    and one for the metrics (as f32).  Each rank's metric is already its
    rows' share of the global weighted mean, so the sum is the mean."""
    if not mesh.distributed:
        return grads, aux
    out = {}
    for net, named in grads.items():
        names = list(named)
        reduced = dict(named)
        for dtype in {g.dtype for g in named.values()}:
            part = [n for n in names if named[n].dtype == dtype]
            flat = torch.cat([named[n].reshape(-1) for n in part])
            mesh.all_reduce_(flat)
            for n, v in zip(part, flat.split([named[n].numel() for n in part])):
                reduced[n] = v.view_as(named[n])
        out[net] = {n: reduced[n] for n in names}
    keys = list(aux)
    if keys:
        vec = torch.stack([aux[k].detach().to(torch.float32).reshape(()) for k in keys])
        mesh.all_reduce_(vec)
        aux = {k: v.to(aux[k].dtype) for k, v in zip(keys, vec.unbind())}
    return out, aux
