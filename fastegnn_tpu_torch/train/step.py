"""Train and eval steps (counterpart of ``fastegnn_tpu/train/step.py``).

One step = forward -> loss (MSE + weight * MMD) -> backward -> optimizer
step.  The MMD sample's random draw comes from a ``torch.Generator`` on the
batch's device, or from the caller (``draw=``), which is how a test hands
the port the JAX package's draw.  Steps return detached scalars
``{"loss", "mse", "mmd"}`` and do not synchronise with the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.train.loss import masked_mse, mmd_loss


def draw_sample(graph: GraphBatch, per_graph_sampling: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """The MMD draw: uniform scores [B, n_max] (per-graph sampling) or a
    permutation of n_max (shared sampling), on the batch's device."""
    B = graph.n_graphs
    n_max = graph.num_nodes // B
    if per_graph_sampling:
        return torch.rand((B, n_max), generator=generator, device=graph.device)
    return torch.randperm(n_max, generator=generator, device=graph.device)


def make_loss_fn(model, sigma: float, weight: float, sample: int,
                 per_graph_sampling: bool = False, use_mmd: bool = True) -> Callable:
    """``loss_fn(graph, draw) -> (total, mse, mmd)``; ``mse`` is the logged
    loss, before the MMD term is added (reference ``utils/train.py:104-108``)."""

    def loss_fn(graph: GraphBatch, draw: Optional[torch.Tensor]):
        pred, vloc = model(graph)
        mse = masked_mse(pred, graph.coord_target, graph.node_mask)
        if not use_mmd:
            return mse, mse, torch.zeros_like(mse)
        kw = {"scores": draw} if per_graph_sampling else {"perm": draw}
        mmd = mmd_loss(pred, vloc, graph.node_mask, graph.n_graphs, sigma, sample, **kw)
        return mse + weight * mmd, mse, mmd

    return loss_fn


def make_train_step(model, optimizer: torch.optim.Optimizer, sigma: float = 1.5,
                    weight: float = 0.01, sample: int = 3,
                    per_graph_sampling: bool = False, use_mmd: bool = True,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``step(graph, draw=None) -> {"loss", "mse", "mmd"}``: one forward,
    backward and optimizer step; the MMD draw comes from ``generator`` unless
    ``draw`` is given."""
    loss_fn = make_loss_fn(model, sigma, weight, sample, per_graph_sampling, use_mmd)

    def step(graph: GraphBatch, draw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.train()
        if draw is None and use_mmd:
            draw = draw_sample(graph, per_graph_sampling, generator)
        optimizer.zero_grad(set_to_none=True)
        total, mse, mmd = loss_fn(graph, draw)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "mse": mse.detach(), "mmd": mmd.detach()}

    return step


def make_eval_step(model, sigma: float = 1.5, weight: float = 0.01, sample: int = 3,
                   per_graph_sampling: bool = False, use_mmd: bool = True,
                   generator: Optional[torch.Generator] = None) -> Callable:
    """``step(graph, draw=None) -> {"loss", "mse", "mmd"}`` without gradients."""
    loss_fn = make_loss_fn(model, sigma, weight, sample, per_graph_sampling, use_mmd)

    @torch.no_grad()
    def step(graph: GraphBatch, draw: Optional[torch.Tensor] = None):
        model.eval()
        if draw is None and use_mmd:
            draw = draw_sample(graph, per_graph_sampling, generator)
        total, mse, mmd = loss_fn(graph, draw)
        return {"loss": total, "mse": mse, "mmd": mmd}

    return step
