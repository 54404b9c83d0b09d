"""Optimizers (counterpart of ``fastegnn_tpu/train/optim.py``).

The reference trains with ``torch.optim.Adam(lr=5e-4, weight_decay=1e-12)``
(``main_nbody.py:137``): coupled L2, added to the gradient before the
moments.  That is exactly what the JAX package's ``torch_adam`` reproduces
with optax, so the port uses torch's own Adam.
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
