"""Checkpoints (counterpart of ``fastegnn_tpu/train/checkpoint.py``, with
``torch.save`` in place of orbax).

The training loop saves ``{"model": state_dict, "optimizer": state_dict,
"step": int, "epoch": int}``, which is enough to resume a run where it
stopped.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, tree: Any) -> None:
    """Save ``tree`` to the file ``path``, replacing what is there; the file
    is written whole or not at all."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location=None) -> Any:
    """Load a checkpoint saved by :func:`save_checkpoint`, its tensors on
    ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
