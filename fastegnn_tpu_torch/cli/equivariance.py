"""Standalone SE(3)-equivariance check (counterpart of
``fastegnn_tpu/cli/equivariance.py``; reference ``equivariant_test.py``).

Builds ``--model`` (a model of ``models/__init__.py::MODEL_REGISTRY`` that
takes a graph without bond edges: not EGHN or MLP; H=64, C=3, L=4 by
default: the reference configuration, ``equivariant_test.py:12-20``) with
weights from ``--seed``, the JAX CLI's
random graph (complete, ``[d0, d0]`` edge attributes), and checks
``|f(xR + t) - f(x)R - t| <= atol`` under a random integer-degree rotation
and a random translation per trial (``equivariant_test.py:38-62``); the
graph and the rotations come from the same numpy stream as the JAX CLI's.
:func:`errors` gives each trial's error; :func:`main` prints them and
returns 0 when every trial passes, else 1 (GNN, which is not equivariant,
fails, and so does GVP, which reads absolute positions: rotation- but not
translation-equivariant).  DimeNet and DimeNet++ raise: they read a
triplet table, which this graph does not carry, as the JAX CLI cannot
feed them either.  ``--model TFN`` is ``OurDynamics`` at ``nf=32``,
``--num_layer`` layers.  The prediction is the model's output or its
tuple's first entry, as in the JAX CLI.  It runs on the card (the f32 edge
kernels for FastEGNN, FastRF and VNEGNN, the segment-sum kernel for the
others) unless ``--platform cpu`` is given; TF32 stays off.

Usage: python -m fastegnn_tpu_torch.cli.equivariance [--nodes 10] [--platform cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SE(3) equivariance check")
    p.add_argument("--model", type=str, default="FastEGNN")
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--dim_hidden", type=int, default=64)
    p.add_argument("--num_layer", type=int, default=4)
    p.add_argument("--virtual_channel", type=int, default=3)
    p.add_argument("--atol", type=float, default=1e-4)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default=None,
                   help="the device: absent for the CUDA card, 'cpu' for the CPU")
    return p


def errors(args) -> list:
    """Each trial's max ``|f(xR + t) - f(x)R - t|`` for parsed ``args``."""
    import torch

    from fastegnn_tpu_torch import resolve_device
    from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
    from fastegnn_tpu_torch.models import get_model
    from fastegnn_tpu_torch.ops.neighbors import cutoff_edges_np
    from fastegnn_tpu_torch.ops.rotation import random_rotation
    from fastegnn_tpu_torch.train.step import prediction

    device = resolve_device(args.platform)
    rng = np.random.default_rng(args.seed)
    n = args.nodes
    loc = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.choice([-1.0, 1.0], size=(n, 1)).astype(np.float32)
    dst, src = cutoff_edges_np(loc, 0.0)
    d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
    spec = GraphSpec(max_nodes=n, max_edges=len(dst), n_graphs=1, edge_attr_dim=2)
    graph = batch_graphs([pad_graph(
        spec,
        node_feat=np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True), q / q.max()],
                                 axis=1),
        coord=loc, vel=vel, dst=dst, src=src, edge_attr=np.concatenate([d0, d0], axis=1),
        coord_target=loc + vel, node_attr=q)], spec, device=device)

    model = get_model(args.model, spec.node_feat_dim, spec.edge_attr_dim,
                      hidden=args.dim_hidden, virtual_channels=args.virtual_channel,
                      n_layers=args.num_layer, device=device,
                      generator=torch.Generator().manual_seed(args.seed))
    model.eval()

    @torch.no_grad()
    def fwd(g):
        return prediction(model(g))

    errs = []
    for _ in range(args.trials):
        R = torch.as_tensor(random_rotation(rng), dtype=torch.float32, device=device)
        t = torch.as_tensor(rng.normal(size=3), dtype=torch.float32, device=device)
        g_rt = dataclasses.replace(
            graph,
            coord=graph.coord @ R + t,
            vel=graph.vel @ R,
            coord_target=graph.coord_target @ R + t,
            loc_mean=torch.einsum("ji,bjc->bic", R, graph.loc_mean) + t[None, :, None])
        errs.append(float((fwd(g_rt) - (fwd(graph) @ R + t)).abs().max()))
    return errs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ok = True
    for trial, err in enumerate(errors(args)):
        passed = err <= args.atol
        ok &= passed
        print(f"trial {trial}: max |f(xR+t) - f(x)R - t| = {err:.3e} "
              f"{'PASS' if passed else 'FAIL'}")
    print("Equivariance test:", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
