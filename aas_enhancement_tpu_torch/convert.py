"""Parameters: flax tree -> ``Enhancer`` / ``AcousticModel`` /
``Discriminator`` state_dict, and a flax-like random init.

Layouts:
- conv kernels: flax HWIO -> torch OIHW (``convs.{i}.weight``,
  ``conv{1,2}.weight``; the discriminator's ``conv{i}`` -> ``convs.{i}``);
  biases as is;
- ``Dense`` kernels stay [in, out] (``ops/dense.py`` keeps flax's layout);
- BiRNN ``wh`` [2, H, G*H] and ``bh`` [2, G*H] stay as they are, the layout the
  LSTM and GRU kernels read;
- MaskedGroupNorm ``scale``/``bias`` [C] as is.

The random init draws from the distributions flax uses for the same modules
(lecun-normal conv and Dense kernels, orthogonal ``wh``, zero biases, GN
scale ones), from an explicit ``torch.Generator``.  It does not reproduce
flax's numbers, only their distributions: parity tests convert a flax tree.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.norm import MaskedGroupNorm
from aas_enhancement_tpu_torch.ops.rnn import BiRNN

# flax's lecun_normal: truncated normal on [-2, 2], rescaled to unit variance.
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, prefix: str, sub: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(sub["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd[f"{prefix}.bias"] = _t(sub["bias"])


def _pair(sd: dict, prefix: str, sub: Mapping[str, Any], names: tuple[str, str]) -> None:
    for n in names:
        sd[f"{prefix}.{n}"] = _t(sub[n])


def _birnn(sd: dict, prefix: str, sub: Mapping[str, Any]) -> None:
    _pair(sd, f"{prefix}.wx", sub["wx"], ("kernel", "bias"))
    _pair(sd, prefix, sub, ("wh", "bh"))


def _split(name: str) -> tuple[str, str]:
    kind = name.rstrip("0123456789")
    return kind, name[len(kind):]


def enhancer_params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``Enhancer`` params (nested dict of arrays, with or without the
    top-level "params" key) -> ``Enhancer`` state_dict of f32 CPU tensors."""
    sd: dict[str, torch.Tensor] = {}
    for name, sub in tree.get("params", tree).items():
        kind, idx = _split(name)
        if kind == "conv":
            _conv(sd, f"convs.{idx}", sub)
        elif kind == "gn":
            _pair(sd, f"gns.{idx}", sub, ("scale", "bias"))
        elif kind == "blstm":
            _birnn(sd, f"blstms.{idx}", sub)
        elif name == "proj":
            _pair(sd, "proj", sub, ("kernel", "bias"))
        else:
            raise KeyError(f"unexpected flax parameter group {name!r}")
    return sd


def am_params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``AcousticModel`` params (``conv1``, ``gn1``, ``conv2``, ``gn2``,
    ``rnn{i}``, ``fc``; with or without the top-level "params" key) ->
    ``AcousticModel`` state_dict of f32 CPU tensors."""
    sd: dict[str, torch.Tensor] = {}
    for name, sub in tree.get("params", tree).items():
        kind, idx = _split(name)
        if name in ("conv1", "conv2"):
            _conv(sd, name, sub)
        elif name in ("gn1", "gn2"):
            _pair(sd, name, sub, ("scale", "bias"))
        elif kind == "rnn":
            _birnn(sd, f"rnns.{idx}", sub)
        elif name == "fc":
            _pair(sd, "fc", sub, ("kernel", "bias"))
        else:
            raise KeyError(f"unexpected flax parameter group {name!r}")
    return sd


def disc_params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``Discriminator`` params (``conv0..``, ``head``; with or without
    the top-level "params" key) -> ``Discriminator`` state_dict of f32 CPU
    tensors."""
    sd: dict[str, torch.Tensor] = {}
    for name, sub in tree.get("params", tree).items():
        kind, idx = _split(name)
        if kind == "conv":
            _conv(sd, f"convs.{idx}", sub)
        elif name == "head":
            _pair(sd, "head", sub, ("kernel", "bias"))
        else:
            raise KeyError(f"unexpected flax parameter group {name!r}")
    return sd


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    z = torch.empty(w.shape).normal_(generator=gen)
    while True:                                  # resample outside [-2, 2]
        bad = z.abs() > 2.0
        if not bad.any():
            break
        z[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
    w.copy_(z * std)


def _orthogonal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax ``orthogonal()`` on [..., n_cols]: one orthogonal matrix of shape
    [prod(leading), n_cols], reshaped."""
    n_cols = w.shape[-1]
    n_rows = w.numel() // n_cols
    shape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = torch.empty(shape, dtype=torch.float64).normal_(generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    w.copy_(q.reshape(w.shape).to(w.dtype))


@torch.no_grad()
def init_like_flax(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from flax's default distributions
    (``nn.Conv2d`` covers ``ops/conv.py::SameConv2d``)."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            _lecun_normal_(mod.weight, i * kh * kw, gen)
            mod.bias.zero_()
        elif isinstance(mod, Dense):
            _lecun_normal_(mod.kernel, mod.kernel.shape[0], gen)
            mod.bias.zero_()
        elif isinstance(mod, BiRNN):
            _orthogonal_(mod.wh, gen)
            mod.bh.zero_()
        elif isinstance(mod, MaskedGroupNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
    return model
