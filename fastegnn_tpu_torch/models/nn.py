"""Small NN building blocks with the reference's initialisation
(counterpart of ``fastegnn_tpu/models/nn.py``).

The port keeps the reference PyTorch module layout, so its ``state_dict``
keys are the reference's (``edge_mlp.0.weight``, ``coord_mlp_r.2.weight``,
...).  Initialisation is torch's ``nn.Linear`` default, drawn from an
explicit generator:

- weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming-uniform
  with a = sqrt(5) reduces to that bound);
- coordinate-gate heads ``Linear(H, 1, bias=False)`` xavier-uniform with
  gain 1e-3 (reference ``models/FastEGNN.py:55-57``);
- SchNet's interaction linears (:func:`xavier_linear`) xavier-uniform with
  zero biases (reference ``models/SchNet.py:282-289, 316-319``);
- the TFN radial profiles' and norm layers' linears (:func:`he_linear`)
  He-uniform weights, bound sqrt(6 / fan_in), with torch's default bias
  (the JAX package's ``RadialFunc`` and ``GNormSE3``); a linear with an
  ``init_weight(weight, generator)`` draws its weight with it (DimeNet's
  glorot-orthogonal, uniform and zero weights); a module's own parameters
  are drawn by its ``draw_parameters_(generator)``, where it has one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

HEAD_GAIN = 1e-3


def mlp(in_dim: int, hidden: int, out: int, act_final: bool = False) -> nn.Sequential:
    """``Linear, SiLU, Linear[, SiLU]`` (keys ``.0`` and ``.2``)."""
    layers = [nn.Linear(in_dim, hidden), nn.SiLU(), nn.Linear(hidden, out)]
    if act_final:
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


def coord_mlp(hidden: int) -> nn.Sequential:
    """``Linear(H, H), SiLU, Linear(H, 1, bias=False)`` with the gain-1e-3
    xavier head (reference ``get_coord_mlp``)."""
    head = nn.Linear(hidden, 1, bias=False)
    head.xavier_gain = HEAD_GAIN
    return nn.Sequential(nn.Linear(hidden, hidden), nn.SiLU(), head)


def xavier_linear(in_dim: int, out: int, bias: bool = True) -> nn.Linear:
    """``Linear`` drawn xavier-uniform (gain 1) with a zero bias."""
    m = nn.Linear(in_dim, out, bias=bias)
    m.xavier_gain, m.zero_bias = 1.0, True
    return m


def he_linear(in_dim: int, out: int, bias: bool = True) -> nn.Linear:
    """``Linear`` whose weight is drawn He-uniform."""
    m = nn.Linear(in_dim, out, bias=bias)
    m.he_uniform = True
    return m


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every ``nn.Linear`` of ``module`` with torch's default
    initialisation (or xavier with the layer's ``xavier_gain``, He-uniform
    where it has ``he_uniform``, its own ``init_weight`` where it has one,
    and a zero bias where it has ``zero_bias``) from ``generator``, and the
    parameters of every module with a ``draw_parameters_``."""
    for m in module.modules():
        if hasattr(m, "draw_parameters_"):
            m.draw_parameters_(generator)
        if not isinstance(m, nn.Linear):
            continue
        gain = getattr(m, "xavier_gain", None)
        if hasattr(m, "init_weight"):
            m.init_weight(m.weight, generator)
        elif gain is not None:
            nn.init.xavier_uniform_(m.weight, gain=gain, generator=generator)
        elif getattr(m, "he_uniform", False):
            bound = math.sqrt(6.0 / m.in_features)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
        else:
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
        if m.bias is not None and getattr(m, "zero_bias", False):
            nn.init.zeros_(m.bias)
        elif m.bias is not None:
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def linear(x: torch.Tensor, m: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """``m(x)`` computed in the compute dtype ``cd``."""
    bias = None if m.bias is None else m.bias.to(cd)
    return nn.functional.linear(x.to(cd), m.weight.to(cd), bias)
