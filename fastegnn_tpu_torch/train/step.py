"""Train and eval steps (counterpart of ``fastegnn_tpu/train/step.py``).

One step = forward -> loss (MSE + weight * MMD) -> backward -> optimizer
step.  The MMD sample's random draw comes, in this order of precedence,
from the caller (``draw=``, which is how a test hands the port the JAX
package's draw), from a generator on the batch's device seeded by the
training loop's host key (``key=``, a numpy uint32[2] made from ``(seed,
tag, epoch, i)``, so that a resumed run draws what an uninterrupted run
drew), or from the step's own ``generator``.  Steps return detached
scalars ``{"loss", "mse", "mmd"}`` and do not synchronise with the device.

Under a profiler a train step records the spans ``train.step`` around its
body, and inside it ``step.draw`` (the MMD draw), ``step.forward`` (the
model), ``step.loss``, ``step.backward`` and ``step.optimizer``
(``utils/profiling.py::span``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastegnn_tpu_torch.graph import GraphBatch
from fastegnn_tpu_torch.train.loss import masked_mse, mmd_loss
from fastegnn_tpu_torch.utils.profiling import span


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


def prediction(out) -> torch.Tensor:
    """The predicted positions of a model's output: the output itself, or
    the first entry of a tuple (as the JAX ``loss_fn`` takes them)."""
    return out[0] if isinstance(out, tuple) else out


def make_loss_fn(model, sigma: float, weight: float, sample: int,
                 per_graph_sampling: bool = False, use_mmd: bool = True) -> Callable:
    """``loss_fn(graph, draw) -> (total, mse, mmd)``; ``mse`` is the logged
    loss, before the MMD term is added (reference ``utils/train.py:104-108``).
    The prediction is a tensor or a tuple's first entry; the MMD term, where
    ``use_mmd``, reads the virtual positions from the tuple's second entry
    and is 0 for a model without one (``fastegnn_tpu/train/step.py:94-104``)."""

    def loss_fn(graph: GraphBatch, draw: Optional[torch.Tensor]):
        with span("step.forward"):
            out = model(graph)
        with span("step.loss"):
            pred = prediction(out)
            mse = masked_mse(pred, graph.coord_target, graph.node_mask)
            vloc = out[1] if use_mmd and isinstance(out, tuple) and len(out) > 1 else None
            if vloc is None:
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
        with span("train.step"):
            model.train()
            if draw is None and use_mmd:
                with span("step.draw"):
                    draw = draw_sample(graph, per_graph_sampling, generator if key is None
                                       else key_generator(key, graph.device))
            optimizer.zero_grad(set_to_none=True)
            total, mse, mmd = loss_fn(graph, draw)
            with span("step.backward"):
                total.backward()
            with span("step.optimizer"):
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
