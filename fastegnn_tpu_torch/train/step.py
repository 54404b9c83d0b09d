"""Train and eval steps (counterpart of ``fastegnn_tpu/train/step.py``).

One step = forward -> loss (MSE + weight * MMD) -> backward -> optimizer
step.  The MMD sample's random draw comes, in this order of precedence,
from the caller (``draw=``, which is how a test hands the port the JAX
package's draw), from a generator on the batch's device seeded by the
training loop's host key (``key=``, a numpy uint32[2] made from ``(seed,
tag, epoch, i)``, so that a resumed run draws what an uninterrupted run
drew), or from the step's own ``generator``.  Steps return detached
scalars ``{"loss", "mse", "mmd"}`` and do not synchronise with the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
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


def key_generator(key, device) -> torch.Generator:
    """A generator on ``device`` seeded from a host key (uint32[2])."""
    hi, lo = (int(k) for k in np.asarray(key, np.uint32))
    return torch.Generator(device=device).manual_seed(hi << 32 | lo)


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
    """``step(graph, key=None, draw=None) -> {"loss", "mse", "mmd"}``: one
    forward, backward and optimizer step; the MMD draw as the module says."""
    loss_fn = make_loss_fn(model, sigma, weight, sample, per_graph_sampling, use_mmd)

    def step(graph: GraphBatch, key=None,
             draw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.train()
        if draw is None and use_mmd:
            draw = draw_sample(graph, per_graph_sampling, generator if key is None
                               else key_generator(key, graph.device))
        optimizer.zero_grad(set_to_none=True)
        total, mse, mmd = loss_fn(graph, draw)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "mse": mse.detach(), "mmd": mmd.detach()}

    return step


def make_eval_step(model, sigma: float = 1.5, weight: float = 0.01, sample: int = 3,
                   per_graph_sampling: bool = False, use_mmd: bool = True,
                   generator: Optional[torch.Generator] = None) -> Callable:
    """``step(graph, key=None, draw=None) -> {"loss", "mse", "mmd"}`` without
    gradients."""
    loss_fn = make_loss_fn(model, sigma, weight, sample, per_graph_sampling, use_mmd)

    @torch.no_grad()
    def step(graph: GraphBatch, key=None, draw: Optional[torch.Tensor] = None):
        model.eval()
        if draw is None and use_mmd:
            draw = draw_sample(graph, per_graph_sampling, generator if key is None
                               else key_generator(key, graph.device))
        total, mse, mmd = loss_fn(graph, draw)
        return {"loss": total, "mse": mse, "mmd": mmd}

    return step
