"""Train steps for the generator objectives and AM pre-training (port of
``aas_enhancement_tpu/train/steps.py``).

One step of ``paired``: the gradient of ``paired_loss`` with respect to G's
parameters, clipped and applied with Adam.  One step of ``aas`` (``adversarial`` and ``acoustic`` are the same code with
one loss term off): the enhancer runs once; the G gradient is that of
``generator_loss`` with respect to G's parameters only (taken with
``torch.autograd.grad``, so the adversarial term leaves nothing on D's
parameters, as in JAX); the D gradient is that of ``discriminator_loss`` on
the detached enhanced batch and the unpaired clean batch.  Both come from
the pre-step parameters; then each is clipped to global norm
``max_grad_norm`` and applied with Adam.

Gradient accumulation (``TrainConfig.grad_accum`` = k > 1): microbatch i
takes the strided rows {r : r % k == i}; each divides by its SHARE of the
batch's real-row weight (W / k, per weight stream), and the k gradients and
metrics are averaged, so the result equals the unaccumulated weighted batch
mean even when real rows spread unevenly.

``am`` (AM pre-training): the gradient of ``am_pretrain_loss`` with respect
to the AM's parameters only, clipped and applied with SGD and Nesterov
momentum at ``lr_am``.  SpecAugment draws its stripes from a generator
seeded from (``train.seed``, ``state.step``) at every microbatch, so a step
mutates no random state and a resumed run repeats it (the JAX step folds the
step count into its key the same way).
"""

from __future__ import annotations

from typing import Callable

import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.train import objectives as obj
from aas_enhancement_tpu_torch.train.state import TrainState, apply_update, lr_schedule

OBJECTIVES = ("paired", "aas", "adversarial", "acoustic", "am")


def _named_grads(loss: torch.Tensor, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """d loss / d (module's parameters), by parameter name; zeros where the
    loss does not reach a parameter (as JAX gives)."""
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def make_train_step(cfg: Config, anchor_am: torch.nn.Module | None = None) -> Callable:
    """-> step(state, batch) -> (state, metrics), updating ``state`` in place.

    ``anchor_am``: the frozen base AM of the ``am`` objective's KL anchor
    (``TrainConfig.distill_lambda``); it is never updated.

    batch: dict of tensors on the networks' device: wav, wav_lengths, labels,
    label_paddings, optional row_weights, and the paired clean_wav (paired)
    or the unpaired clean_wav, clean_wav_lengths and optional
    clean_row_weights (adversarial / aas).
    ``step.batch_grads(state, batch)`` -> ({"g": {name: grad}, "d": ...} or
    {"am": ...}, metrics) is the gradient half of the step, without the
    update."""
    objective = cfg.train.objective
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective: {objective!r}")
    k = max(1, cfg.train.grad_accum)
    if cfg.train.batch_size % k:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by "
                         f"grad_accum {k}")
    use_ac = objective in ("acoustic", "aas")
    use_adv = objective in ("adversarial", "aas")
    lam = cfg.train.lambda_adv
    g_lr = lr_schedule(cfg, cfg.train.lr_g)
    d_lr = lr_schedule(cfg, cfg.train.lr_d)
    am_lr = lr_schedule(cfg, cfg.train.lr_am)

    def micro_grads(state: TrainState, mb: dict, wd=None, cwd=None
                    ) -> tuple[dict, dict]:
        if objective == "am":
            gen = None
            if cfg.train.spec_augment:
                gen = torch.Generator().manual_seed((cfg.train.seed << 32) + state.step)
            loss, aux = obj.am_pretrain_loss(
                cfg, state.am, mb, w_denom=wd, gen=gen,
                enhancer=state.g if cfg.train.am_through_enhancer else None,
                anchor_am=anchor_am)
            return ({"am": _named_grads(loss, state.am)},
                    {key: v.detach() for key, v in aux.items()})
        if objective == "paired":
            loss, aux = obj.paired_loss(cfg, state.g, mb, w_denom=wd)
            return ({"g": _named_grads(loss, state.g)},
                    {key: v.detach() for key, v in aux.items()})
        loss, aux = obj.generator_loss(cfg, state.g, state.d if use_adv else None,
                                       state.am if use_ac else None, mb,
                                       use_acoustic=use_ac, use_adv=use_adv,
                                       lam=lam, w_denom=wd)
        grads = {"g": _named_grads(loss, state.g)}
        enh_log, enh_fl = aux.pop("enh_log"), aux.pop("enh_fl")
        if use_adv:
            # Fake side: the G output of this same forward, detached.
            with torch.no_grad():
                _, clean_log, clean_fl = obj.device_features(
                    cfg, mb["clean_wav"], mb["clean_wav_lengths"])
            loss_d, d_aux = obj.discriminator_loss(
                cfg, state.d, enh_log, enh_fl, clean_log, clean_fl,
                w_fake=mb.get("row_weights"), w_real=mb.get("clean_row_weights"),
                fake_denom=wd, real_denom=cwd)
            grads["d"] = _named_grads(loss_d, state.d)
            aux.update(d_aux)
        return grads, {key: v.detach() for key, v in aux.items()}

    def _share(batch: dict, w_key: str, rows_key: str) -> torch.Tensor | float:
        """A stream's global real-row weight divided by k."""
        w = batch.get(w_key)
        total = w.to(torch.float32).sum() if w is not None else float(batch[rows_key].shape[0])
        return total / k

    def batch_grads(state: TrainState, batch: dict) -> tuple[dict, dict]:
        if k == 1:
            return micro_grads(state, batch)
        wd = _share(batch, "row_weights", "wav")
        cwd = _share(batch, "clean_row_weights", "clean_wav") if "clean_wav" in batch else None
        grads, aux = None, None
        for i in range(k):
            mb = {key: v[i::k] for key, v in batch.items()}     # rows r % k == i
            g, a = micro_grads(state, mb, wd, cwd)
            if grads is None:
                grads, aux = g, a
                continue
            for net in grads:
                grads[net] = {n: grads[net][n] + v for n, v in g[net].items()}
            aux = {key: aux[key] + v for key, v in a.items()}
        grads = {net: {n: v / k for n, v in gs.items()} for net, gs in grads.items()}
        return grads, {key: v / k for key, v in aux.items()}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        grads, aux = batch_grads(state, batch)
        max_norm = cfg.train.max_grad_norm
        for net, opt, lr in (("g", state.g_opt, g_lr), ("d", state.d_opt, d_lr),
                             ("am", state.am_opt, am_lr)):
            if net in grads:
                module = getattr(state, net)
                names = [n for n, _ in module.named_parameters()]
                norm = apply_update(opt, list(module.parameters()),
                                    [grads[net][n] for n in names], lr(state.step),
                                    max_norm)
                if net != "d":
                    aux[f"{net}_grad_norm"] = norm
        state.step += 1
        return state, aux

    step.batch_grads = batch_grads
    return step
