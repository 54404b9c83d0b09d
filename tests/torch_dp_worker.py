"""Rank side of ``tests/test_torch_port_parallel.py``: one rank of a
2-process gloo group runs the port's data-parallel steps and writes what
the test asserts on.  A spawned child imports this module without
``conftest.py``, so it imports no JAX: the test hands it numpy inputs in a
file and holds its results against the JAX package."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

N_RANKS = 2


def _model(inputs):
    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN

    m = FastEGNN(2, 2, hidden=inputs["hidden"], virtual_channels=3,
                 n_layers=inputs["n_layers"], device="cpu")
    m.load_state_dict(inputs["state_dict"])
    return m


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def run(rank: int, store: str, inputs_path: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    from fastegnn_tpu_torch.data.batcher import GraphDataset
    from fastegnn_tpu_torch.graph import GraphSpec, pad_graph
    from fastegnn_tpu_torch.parallel import (
        initialize_distributed,
        iter_dp_batches,
        make_dp_agree,
        make_dp_eval_step,
        make_dp_train_step,
        make_hybrid_mesh,
        make_mesh,
    )
    from fastegnn_tpu_torch.train.loop import step_key, train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    initialize_distributed("cpu", init_method=f"file://{store}", world_size=N_RANKS,
                           rank=rank, timeout_s=120)
    out = {"meshes": {}}
    try:
        mesh = make_mesh((-1,), ("data",))
        for name, m in (("data", mesh), ("hybrid", make_hybrid_mesh()),
                        ("hybrid n_outer=2", make_hybrid_mesh(n_outer=2))):
            out["meshes"][name] = (tuple(m.shape), tuple(m.mesh_dim_names))

        spec = GraphSpec(**inputs["spec"], n_graphs=1)
        ds = GraphDataset([pad_graph(spec, **r) for r in inputs["raws"]], spec, device="cpu")
        batches = list(iter_dp_batches(ds, len(ds), mesh))
        out["sub_batches"] = [(b.n_graphs, b.coord.numpy().copy()) for b in batches]
        g = batches[0]
        lr = inputs["lr"]

        # D = 2, MMD off: one step and the eval step, held against JAX
        model = _model(inputs)
        out["eval"] = _metrics(make_dp_eval_step(model, mesh, use_mmd=False)(g))
        step = make_dp_train_step(model, torch_adam(model.parameters(), lr), mesh,
                                  use_mmd=False)
        out["train"] = _metrics(step(g))
        out["params"] = _params(model)
        out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                        if p.grad is not None}

        # D = 2, MMD on: finite, the MMD term not 0
        model = _model(inputs)
        step = make_dp_train_step(model, torch_adam(model.parameters(), lr), mesh)
        out["train_mmd"] = [_metrics(step(g, step_key(43, 0, 1, i))) for i in range(2)]
        out["params_mmd"] = _params(model)

        # D = 1, MMD on: a mesh of this rank alone against the plain step
        groups = [dist.new_group([r]) for r in range(N_RANKS)]
        solo = DeviceMesh.from_group(groups[rank], "cpu", mesh_dim_names=("data",))
        a, b = _model(inputs), _model(inputs)
        dp1 = make_dp_train_step(a, torch_adam(a.parameters(), lr), solo)
        plain = make_train_step(b, torch_adam(b.parameters(), lr))
        keys = [step_key(43, 0, 1, i) for i in range(2)]
        out["d1"] = [_metrics(dp1(g, k)) for k in keys]
        out["plain"] = [_metrics(plain(g, k)) for k in keys]
        out["d1_params"], out["plain_params"] = _params(a), _params(b)

        # the loop's early stop: rank 1's valid loss of epoch 2 one ulp below
        # rank 0's, as the card's float atomics can leave it; on rank 0's
        # losses (make_dp_agree) both ranks stop at epoch 2
        valid = [1.0, 1.0 if rank == 0 else float(np.nextafter(1.0, 0.0)), 0.5]
        losses = iter(v for pair in zip(valid, [2.0] * len(valid)) for v in pair)

        def eval_stub(graph, key):
            return {"mse": torch.tensor(next(losses), dtype=torch.float64)}

        def train_stub(graph, key):
            return {"mse": torch.zeros((), dtype=torch.float64)}

        model = _model(inputs)
        best, _, _ = train(model, torch_adam(model.parameters(), lr), ds, ds, ds,
                           batch_size=len(ds), sigma=1.5, weight=0.0, test_interval=1,
                           early_stop=1, max_epochs=len(valid), train_step_fn=train_stub,
                           eval_step_fn=eval_stub, agree_fn=make_dp_agree(mesh),
                           shuffle=False, verbose=False)
        out["early_stop"] = {k: best.get(k) for k in ("early_stop", "epoch_index", "loss_valid")}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")
