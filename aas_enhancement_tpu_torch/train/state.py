"""Train state and the optimizer update (port of
``aas_enhancement_tpu/train/state.py``).

``TrainState`` holds the networks an objective needs (the enhancer G, the
discriminator D, the frozen AM), their optimizers and the step count.  The
JAX package's G and D optimizer is ``optax.chain(clip_by_global_norm(400),
adam(lr_schedule, b1=0.5, b2=0.999))``; here ``apply_update`` clips with
``clip_by_global_norm`` (written out, because ``clip_grad_norm_`` adds 1e-6
to the norm and optax does not) and steps a ``torch.optim.Adam`` (eps 1e-8;
its non-fused update is optax's formula).  The AM pre-training optimizer is
``optax.chain(clip_by_global_norm(400), sgd(lr_schedule, momentum,
nesterov=True))``: trace = g + mu * trace, update = -lr * (g + mu * trace).
``torch.optim.SGD(momentum=mu, nesterov=True)`` with its defaults (dampening
0, no weight decay) computes the same: buf = mu * buf + g, with buf = g at
the first step, and p -= lr * (g + mu * buf); ``tests/test_torch_train.py``
holds three steps of it to optax.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from aas_enhancement_tpu_torch.config import Config


@dataclasses.dataclass
class TrainState:
    """All mutable training state of an objective; networks it does not
    train or read are None."""

    step: int = 0
    g: nn.Module | None = None
    g_opt: torch.optim.Optimizer | None = None
    d: nn.Module | None = None
    d_opt: torch.optim.Optimizer | None = None
    am: nn.Module | None = None        # frozen during AAS / acoustic
    am_opt: torch.optim.Optimizer | None = None    # the "am" objective only


def lr_schedule(cfg: Config, base_lr: float) -> Callable[[int], float]:
    """Per-epoch staircase: lr / lr_anneal ** (count // steps_per_epoch), with
    count the updates done so far; constant when lr_anneal is 1 or the epoch
    length is unknown (0)."""
    t = cfg.train
    spe = t.steps_per_epoch
    if t.lr_anneal == 1.0 or spe <= 0:
        return lambda count: base_lr
    return lambda count: base_lr / (t.lr_anneal ** (count // spe))


def adam(cfg: Config, params, base_lr: float) -> torch.optim.Adam:
    """The G / D optimizer: Adam(b1, b2 of the config, eps 1e-8), not fused
    (torch's default: the multi-tensor loop on CUDA, the per-tensor one on
    the CPU; both are optax's formula)."""
    t = cfg.train
    return torch.optim.Adam(params, lr=base_lr, betas=(t.adam_b1, t.adam_b2), eps=1e-8)


def am_sgd(cfg: Config, params, base_lr: float) -> torch.optim.SGD:
    """The AM pre-training optimizer: SGD with Nesterov momentum (optax's
    ``sgd(momentum, nesterov=True)``, see the module docstring)."""
    mu = cfg.train.momentum          # torch refuses nesterov=True without momentum
    return torch.optim.SGD(params, lr=base_lr, momentum=mu, nesterov=mu > 0)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """optax's rule: g * max_norm / |g| where |g| >= max_norm, else g as is
    (no epsilon).  -> (clipped grads, |g| before clipping).  The choice stays
    on the device (no host sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads], norm


def apply_update(opt: torch.optim.Optimizer, params: list[torch.Tensor],
                 grads: list[torch.Tensor], lr: float, max_norm: float) -> torch.Tensor:
    """Clip ``grads`` to ``max_norm``, take one optimizer step at ``lr``;
    returns the gradient's global norm before clipping."""
    clipped, norm = clip_by_global_norm(grads, max_norm)
    for group in opt.param_groups:
        group["lr"] = lr
    for p, g in zip(params, clipped):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
    return norm
