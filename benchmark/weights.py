"""The initial weights of a cell, made by the benchmark on the card from
``--seed`` and handed alike to the program and to the reference.

One uniform draw in [-1, 1) covers every parameter, and one normal draw
those that a rule asks normal for, each made by a ``torch.Generator`` on
the device in one call.  Each parameter takes its slice, scaled by the
first rule of the configuration's ``init`` list whose pattern matches its
name (``re.search``):

- ``["pattern", "fan_in", g]``: bound ``g / sqrt(fan_in)`` (torch's
  ``nn.Linear`` default; a bias takes its weight's fan-in);
- ``["pattern", "xavier", g]``: bound ``g * sqrt(6 / (fan_in + fan_out))``;
- ``["pattern", "he", g]``: bound ``g * sqrt(6 / fan_in)``;
- ``["pattern", "normal", g]``: ``g`` times a standard normal draw;
- ``["pattern", "constant", c]``: every entry ``c`` (LayerNorm's scale and
  shift).

The fan-in of a weight ``[out, in, ...]`` is ``in * ...``.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch


def _rule(name: str, rules):
    for pattern, kind, gain in rules:
        if re.search(pattern, name):
            return kind, float(gain)
    raise ValueError(f"no init rule matches parameter {name!r}")


def _fans(name: str, shape, shapes: Dict[str, torch.Size]):
    if len(shape) >= 2:
        return math.prod(shape[1:]), shape[0]
    if name.endswith("bias"):
        w = shapes.get(name[:-len("bias")] + "weight")
        if w is not None and len(w) >= 2:
            return math.prod(w[1:]), w[0]
    return shape[0] if shape else 1, 1


def make_weights(shapes: Dict[str, torch.Size], rules, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor on device}`` for every parameter in ``shapes``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    uni = torch.rand(total, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind, g = _rule(name, rules)
        fan_in, fan_out = _fans(name, shape, shapes)
        if kind == "normal":
            t = nrm[at:at + n] * g
        elif kind == "constant":
            t = torch.full((n,), g, device=device)
        else:
            bound = {"fan_in": g / math.sqrt(fan_in),
                     "xavier": g * math.sqrt(6.0 / (fan_in + fan_out)),
                     "he": g * math.sqrt(6.0 / fan_in)}[kind]
            t = uni[at:at + n] * bound
        out[name] = t.reshape(shape).clone()
        at += n
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters (every one, by name)."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and parameters differ: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
