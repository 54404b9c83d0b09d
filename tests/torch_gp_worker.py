"""Rank side of ``tests/test_torch_port_owner_graph.py``: one rank of a
4-process gloo group runs the port's owner-sharded forward and steps and
writes what the test asserts on.  A spawned child imports this module
without ``conftest.py``, so it imports no JAX: the test hands it numpy
inputs in a file and holds its results against the JAX package."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

N_RANKS = 4


def _model(inputs, state_dict):
    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN

    m = FastEGNN(2, 2, hidden=inputs["hidden"], virtual_channels=3,
                 n_layers=inputs["n_layers"], gravity=inputs["gravity"], device="cpu")
    m.load_state_dict(state_dict)
    return m


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def _params(model):
    return {k: _numpy(v) for k, v in model.state_dict().items()}


def _grads(model):
    return {k: _numpy(p.grad) for k, p in model.named_parameters() if p.grad is not None}


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _batch(raws, spec):
    from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph

    s = GraphSpec(**spec, n_graphs=len(raws))
    return batch_graphs([pad_graph(s, **r) for r in raws], s, edge_align=256, device="cpu")


def run(rank: int, store: str, inputs_path: str, out_dir: str) -> None:
    from fastegnn_tpu_torch.data.batcher import GraphDataset
    from fastegnn_tpu_torch.graph import GraphSpec, pad_graph
    from fastegnn_tpu_torch.parallel import (
        OwnerBatchFactory,
        halo_exchange,
        initialize_distributed,
        iter_owner_sharded_batches,
        make_mesh,
        make_owner_gp_eval_step,
        make_owner_gp_forward,
        make_owner_gp_train_step,
        make_owner_sharded_batch,
    )
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_eval_step

    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    initialize_distributed("cpu", init_method=f"file://{store}", world_size=N_RANKS,
                           rank=rank, timeout_s=120)
    out = {}
    try:
        mesh = make_mesh((N_RANKS,), ("graph",))
        out["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
        group = mesh.get_group("graph")

        # the halo exchange: each table row is the row its owner holds
        g = _batch(inputs["forward"]["raws"], inputs["forward"]["spec"])
        shard = make_owner_sharded_batch(g, N_RANKS, shard=rank)
        owned = torch.arange(g.num_nodes, dtype=torch.float32)[:, None].expand(-1, 2)
        Nl = shard.n_owned
        table = halo_exchange(owned[rank * Nl:(rank + 1) * Nl].contiguous(), shard.send_idx, group)
        ends = shard.src[:shard.n_real_edges].long()
        out["halo_src"] = _numpy(table[ends, 0])

        # G = 4 forward, fused branch and CSR branch, on both inputs
        out["forward"] = {}
        for name in ("forward", "padded"):
            case = inputs[name]
            g = _batch(case["raws"], case["spec"])
            shard = make_owner_sharded_batch(g, N_RANKS, shard=rank)
            model = _model(inputs, inputs["state_dict"])
            got = {}
            for csr in (False, True):
                x, vloc = make_owner_gp_forward(model, mesh, csr=csr)(shard)
                got["csr" if csr else "fused"] = (_numpy(x), _numpy(vloc))
            out["forward"][name] = got

        # G = 4: two train steps on the JAX draws, then the eval step
        # against the one-process eval step on the same draw
        case = inputs["train"]
        g = _batch(case["raws"], case["spec"])
        shard = make_owner_sharded_batch(g, N_RANKS, shard=rank)
        model = _model(inputs, case["state_dict"])
        step = make_owner_gp_train_step(model, torch_adam(model.parameters(), *case["adam"]),
                                        mesh, per_graph_sampling=True)
        out["train"], out["train_grads"] = [], []
        for draw in case["draws"]:
            out["train"].append(_metrics(step(shard, draw=torch.as_tensor(draw))))
            out["train_grads"].append(_grads(model))
        out["train_params"] = _params(model)
        draw = torch.as_tensor(case["draws"][0])
        out["eval"] = _metrics(make_owner_gp_eval_step(model, mesh, per_graph_sampling=True)(
            shard, draw=draw))
        out["eval_one"] = _metrics(make_eval_step(model, per_graph_sampling=True)(g, draw=draw))

        # data = 2 x graph = 2, weight 0: each rank's replica takes its graph
        # of the 2-graph batch through iter_owner_sharded_batches
        case = inputs["data_graph"]
        mesh2 = make_mesh((2, 2), ("data", "graph"))
        out["mesh2"] = (tuple(mesh2.shape), tuple(mesh2.mesh_dim_names))
        spec = GraphSpec(**case["spec"], n_graphs=1)
        ds = GraphDataset([pad_graph(spec, **r) for r in case["raws"]], spec, device="cpu")
        (shard,) = iter_owner_sharded_batches(ds, len(ds), mesh2, OwnerBatchFactory(2))
        out["dg_shard"] = dict(n_graphs=shard.n_graphs, shard=shard.shard,
                               coord=_numpy(shard.coord), el=shard.dst.shape[0],
                               halo=shard.send_idx.shape[1])
        model = _model(inputs, case["state_dict"])
        step = make_owner_gp_train_step(model, torch_adam(model.parameters(), *case["adam"]),
                                        mesh2, weight=0.0)
        out["dg"], out["dg_grads"] = [], []
        for key in case["keys"]:
            out["dg"].append(_metrics(step(shard, key)))
            out["dg_grads"].append(_grads(model))
        out["dg_params"] = _params(model)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")
