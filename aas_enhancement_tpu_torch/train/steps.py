"""Train steps for the generator objectives (port of
``aas_enhancement_tpu/train/steps.py``).

One step of ``aas`` (``adversarial`` and ``acoustic`` are the same code with
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
mean even when real rows spread unevenly.  The objectives ``paired`` and
``am`` are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Callable

import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.train import objectives as obj
from aas_enhancement_tpu_torch.train.state import TrainState, apply_update, lr_schedule

OBJECTIVES = ("aas", "adversarial", "acoustic")


def _named_grads(loss: torch.Tensor, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """d loss / d (module's parameters), by parameter name; zeros where the
    loss does not reach a parameter (as JAX gives)."""
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def make_train_step(cfg: Config) -> Callable:
    """-> step(state, batch) -> (state, metrics), updating ``state`` in place.

    batch: dict of tensors on the networks' device: wav, wav_lengths, labels,
    label_paddings, optional row_weights, and for adversarial / aas the
    unpaired clean_wav, clean_wav_lengths and optional clean_row_weights.
    ``step.batch_grads(state, batch)`` -> ({"g": {name: grad}, "d": ...},
    metrics) is the gradient half of the step, without the update."""
    objective = cfg.train.objective
    if objective in ("paired", "am"):
        raise NotImplementedError(f"objective {objective!r}: not yet ported "
                                  "(ROADMAP A8)")
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

    def micro_grads(state: TrainState, mb: dict, wd=None, cwd=None
                    ) -> tuple[dict, dict]:
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
        for net, opt, lr in (("g", state.g_opt, g_lr), ("d", state.d_opt, d_lr)):
            if net in grads:
                module = state.g if net == "g" else state.d
                names = [n for n, _ in module.named_parameters()]
                norm = apply_update(opt, list(module.parameters()),
                                    [grads[net][n] for n in names], lr(state.step),
                                    max_norm)
                if net == "g":
                    aux["g_grad_norm"] = norm
        state.step += 1
        return state, aux

    step.batch_grads = batch_grads
    return step
