"""Seeding (counterpart of ``fastegnn_tpu/utils/seed.py``; reference
``utils/seed.py:7-15``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_seed(seed: int = 43) -> torch.Generator:
    """Seed python, numpy and torch (every device) and return a CPU
    generator seeded with ``seed``, for drawing initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
