"""Multi-step rollout, the forward-only serving path (counterpart of
``fastegnn_tpu/train/rollout.py``).

Per step the model maps ``(x_k, v_k) -> x_{k+1}`` (the reference's
delta-frame prediction).  The edge set is frozen at the initial frame,
which is right for fixed-connectivity systems and an approximation for
flowing ones (Water-3D); :func:`rollout_rebuild` rebuilds the radius graph
from the host every ``rebuild_every`` steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from fastegnn_tpu_torch.graph import GraphBatch, batch_graphs, pad_graph
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np


def make_rollout(model: torch.nn.Module, n_steps: int, vel_mode: str = "difference",
                 ) -> Callable[[GraphBatch], Tuple[torch.Tensor, torch.Tensor]]:
    """``roll(batch) -> (traj [T, N, 3], vel [N, 3])``, without gradients and
    with the model in eval mode.  The next velocity is

    - ``"difference"``: ``v_{k+1} = x_{k+1} - x_k`` (Water-3D's finite
      difference convention);
    - ``"hold"``: ``v_{k+1} = v_k``.
    """
    if vel_mode not in ("difference", "hold"):
        raise ValueError(f"unknown vel_mode {vel_mode!r}")

    @torch.no_grad()
    def roll(batch: GraphBatch):
        model.eval()
        x, v = batch.coord, batch.vel
        frames = []
        for _ in range(n_steps):
            x_new = model(dataclasses.replace(batch, coord=x, vel=v))[0]
            if vel_mode == "difference":
                v = x_new - x
            x = x_new
            frames.append(x)
        return torch.stack(frames), v

    return roll


def rollout_rebuild(model: torch.nn.Module, graphs, spec, n_steps: int, rebuild_every: int,
                    radius: float, vel_mode: str = "difference") -> np.ndarray:
    """Long-horizon rollout of one padded graph with the radius graph rebuilt
    on the host (scipy) from the last predicted frame every
    ``rebuild_every`` steps; returns the frames ``[n_steps, N, 3]``."""
    if spec.n_graphs != 1 or len(graphs) != 1:
        raise ValueError("rollout_rebuild takes one graph")
    device = next(model.parameters()).device
    g = dict(graphs[0])
    n = g["n_nodes"]
    roll = make_rollout(model, rebuild_every, vel_mode)
    frames = []
    done = 0
    while done < n_steps:
        coord = g["coord"][:n]
        dst, src = radius_graph_np(coord, radius)
        gp = pad_graph(spec, node_feat=g["node_feat"][:n], coord=coord, vel=g["vel"][:n],
                       dst=dst, src=src,
                       edge_attr=np.zeros((dst.shape[0], spec.edge_attr_dim), np.float32),
                       coord_target=coord)
        traj, v_fin = roll(batch_graphs([gp], spec, device=device))
        take = min(rebuild_every, n_steps - done)
        frames.append(traj[:take].cpu().numpy())
        g["coord"] = traj[take - 1].cpu().numpy()
        g["vel"] = v_fin.cpu().numpy()
        done += take
    return np.concatenate(frames, axis=0)
