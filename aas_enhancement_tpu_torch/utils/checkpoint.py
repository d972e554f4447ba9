"""Checkpoints of the train state (counterpart of
``aas_enhancement_tpu/utils/checkpoint.py``).

Format: one directory per step, ``<dir>/<step>/state.pt``, a ``torch.save``
dict with ``step`` and the ``state_dict`` of each network and optimizer the
state holds (``g``, ``g_opt``, ``d``, ``d_opt``, ``am``, ``am_opt``).
Tensors are saved as CPU copies, so a checkpoint written on the card opens on
a host with no GPU (what ``restore_rehosted`` gives the JAX package).

A save writes ``<step>.tmp/`` and renames it into place, so a reader never
sees half a checkpoint; it keeps the newest ``max_to_keep`` steps, and, as
Orbax's manager, skips a step at or below the newest one already saved.
Saves are synchronous: the JAX package's asynchronous Orbax save is not
reproduced.  A directory that Orbax wrote (``<step>/default``) is refused,
naming the converter ``scripts/orbax_to_torch.py``.
"""

from __future__ import annotations

import os
import shutil

import torch

from aas_enhancement_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
NETWORKS = ("g", "g_opt", "d", "d_opt", "am", "am_opt")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def latest_step(directory: str) -> int | None:
    """The newest step saved in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save(directory: str, step: int, state: TrainState, max_to_keep: int = 3) -> bool:
    """Write ``state`` as step ``step``; False (nothing written) when a step
    at or above it is already saved."""
    newest = latest_step(directory)
    if newest is not None and newest >= step:
        return False
    os.makedirs(directory, exist_ok=True)
    blob = {"step": int(step)}
    for name in NETWORKS:
        part = getattr(state, name)
        if part is not None:
            blob[name] = _cpu(part.state_dict())
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(blob, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return True


def read(directory: str, step: int, device: torch.device | str = "cpu") -> dict:
    """The saved dict of ``step``, its tensors on ``device``."""
    path = os.path.join(directory, str(step), STATE_FILE)
    if not os.path.exists(path):
        if os.path.isdir(os.path.join(directory, str(step), "default")):
            raise ValueError(
                f"{directory}: an Orbax checkpoint of the JAX package; convert it "
                "with `python scripts/orbax_to_torch.py SRC DST` (where JAX is "
                "installed) and pass DST")
        raise FileNotFoundError(f"no checkpoint of step {step} in {directory}")
    return torch.load(path, map_location=device, weights_only=True)


def restore(directory: str, step: int, state: TrainState) -> TrainState:
    """Load step ``step`` into ``state`` in place (networks, optimizers and
    the step count; exact resume).  The checkpoint must hold the same parts
    as ``state``: a converted checkpoint has no optimizer state and raises."""
    net = next(m for m in (state.g, state.d, state.am) if m is not None)
    blob = read(directory, step, next(net.parameters()).device)
    have = {n for n in NETWORKS if getattr(state, n) is not None}
    saved = set(blob) - {"step"}
    if have != saved:
        missing = sorted(have - saved)
        what = ("no optimizer state" if all(n.endswith("_opt") for n in missing) and missing
                else "other parts than the train state")
        raise ValueError(f"{directory} step {step}: {what} (saved {sorted(saved)}, the "
                         f"state has {sorted(have)}); a converted checkpoint carries the "
                         "networks only and cannot resume training")
    for name in have:
        getattr(state, name).load_state_dict(blob[name])
    state.step = int(blob["step"])
    return state
