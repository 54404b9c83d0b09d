"""Small NN building blocks with the reference's initialisation
(counterpart of ``fastegnn_tpu/models/nn.py``).

The port keeps the reference PyTorch module layout, so its ``state_dict``
keys are the reference's (``edge_mlp.0.weight``, ``coord_mlp_r.2.weight``,
...).  Initialisation is torch's ``nn.Linear`` default, drawn from an
explicit generator:

- weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming-uniform
  with a = sqrt(5) reduces to that bound);
- coordinate-gate heads ``Linear(H, 1, bias=False)`` xavier-uniform with
  gain 1e-3 (reference ``models/FastEGNN.py:55-57``).
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


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every ``nn.Linear`` of ``module`` with torch's default
    initialisation (or xavier with the layer's ``xavier_gain``) from
    ``generator``."""
    for m in module.modules():
        if not isinstance(m, nn.Linear):
            continue
        gain = getattr(m, "xavier_gain", None)
        if gain is not None:
            nn.init.xavier_uniform_(m.weight, gain=gain, generator=generator)
        else:
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
        if m.bias is not None:
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def linear(x: torch.Tensor, m: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """``m(x)`` computed in the compute dtype ``cd``."""
    bias = None if m.bias is None else m.bias.to(cd)
    return nn.functional.linear(x.to(cd), m.weight.to(cd), bias)
