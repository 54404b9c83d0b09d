"""fastegnn_tpu_torch: the PyTorch / CUDA port of ``fastegnn_tpu``.

The JAX package stays the reference; this package re-implements its main
path (graph batching, the FastEGNN model, the MSE + MMD loss and the
torch-style Adam train step) in plain PyTorch, with the fused real-edge
block's forward and backward as hand-written CUDA kernels for Hopper
(``csrc/edge_block.cu``).

It imports torch, numpy and scipy only — never jax, flax, optax or anything
under ``fastegnn_tpu``.

Entry points take an explicit ``device``.  They run on CUDA unless the caller
passes ``device="cpu"`` (as the CPU tests do); without a GPU and without an
explicit ``"cpu"`` they raise instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card, and raises when there is none: the CPU is
    used only when the caller asks for it by name.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
