#!/usr/bin/env python3
"""Weak-scaling sweep of the port's owner-sharded graph parallelism.

The port's ``bench_scaling.py``: FastEGNN (H 64, C 3, ``--layers``, f32)
trained with torch-style Adam (5e-4, 1e-12) and the MSE + MMD loss (sigma
1.5, weight 0.01) through ``parallel/owner_graph.py::
make_owner_gp_train_step`` on the fused edge kernels, one process per
device.  Each of G shards owns ``--nodes-per-shard`` nodes of one random,
Morton-ordered unit-cube radius graph (:func:`build_batch`, the JAX
script's graph array for array), so the graph grows with G.  One warm-up
step, then ``--iters`` timed steps, each with its own key; a world's step
time is the slowest rank's.

Prints per G, in order, a line of the f32 edge kernels' launches per rank
step on every rank, then one JSON line with the JAX script's keys in its
order (``metric``, ``devices``, ``nodes``, ``edges``, ``step_ms``,
``medges_per_s`` = real edges x layers / step time, ``efficiency`` = the
rate over G x the rate at G = 1, ``halo_rows_max_pair`` = S,
``halo_rows_total`` = the real boundary rows over all ordered shard pairs,
``halo_kb_per_layer`` and ``halo_kb_padded`` = those rows and the ``G·G·S``
rows the equal ``all_to_all`` blocks move, in 268-byte ``[h | x]`` f32
rows), then ``backend``, ``ranks_per_card``, ``device`` (the card's name)
and ``mse`` (the last step's).  Times and rates are not rounded; the halo
kilobytes are rounded as the JAX script rounds them.

Usage, from the repository root::

    # CPU, gloo (the tests)
    python scripts/torch_bench_scaling.py --platform cpu --devices 1,2 --nodes-per-shard 64
    # one card: G = 1 over NCCL, and two gloo ranks sharing the card as a
    # harness check (not a scaling number)
    python scripts/torch_bench_scaling.py --devices 1
    python scripts/torch_bench_scaling.py --devices 1,2 --ranks-per-card 2
    # several cards: one rank per card over NCCL (the scaling numbers)
    python scripts/torch_bench_scaling.py --devices 1,2,4,8

Run without a world, the script starts ``torchrun --standalone
--nproc_per_node G`` for each G in turn (a mesh spans every process of its
group, so one world cannot take its first G ranks as the JAX script takes
its first G devices) and computes ``efficiency`` against the G = 1 line.
Under ``torchrun`` it measures its own world and prints that world's lines
(``efficiency`` is 1.0 at G = 1 and null otherwise).  Each rank takes card
``LOCAL_RANK // --ranks-per-card``; a sweep that needs more cards than the
machine has raises, as does a run on the card without one.  A world that
fails fails the sweep.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

HIDDEN, CHANNELS = 64, 3
ROW_BYTES = (HIDDEN + 3) * 4     # one halo row [h | x] in f32
LR, WEIGHT_DECAY, SIGMA, MMD_WEIGHT = 5e-4, 1e-12, 1.5, 0.01
INIT_SEED, SEED = 0, 1   # the JAX script's jax.random.key(0) (init) and key(1) (steps)
KEYS = ("metric", "devices", "nodes", "edges", "step_ms", "medges_per_s", "efficiency",
        "halo_rows_max_pair", "halo_rows_total", "halo_kb_per_layer", "halo_kb_padded")
TIMEOUT_S = 600.0   # how long a collective waits for a rank that died


def build_batch(n_nodes: int, seed: int = 0):
    """``(batch, real edges)``: ``bench_scaling.py::build_batch`` on the
    port.  ``n_nodes`` uniform points in the unit cube in Morton order, a
    radius graph of ~26 mean degree at any size (radius ``(20 / n)^(1/3) x
    0.7``), node features ``[|v|, 1]``, edge attributes ``[d0, d0]``, one
    graph padded to 256 edges, on the CPU."""
    from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, morton_order, pad_graph
    from fastegnn_tpu_torch.ops.neighbors import radius_graph_np

    rng = np.random.default_rng(seed)
    loc = rng.random((n_nodes, 3)).astype(np.float32)
    loc = loc[morton_order(loc)]
    vel = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 0.1
    r = (20.0 / n_nodes) ** (1 / 3) * 0.7
    dst, src = radius_graph_np(loc, r)
    o = np.argsort(dst, kind="stable")
    dst, src = dst[o].astype(np.int32), src[o].astype(np.int32)
    d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True)
    spec = GraphSpec(max_nodes=n_nodes, max_edges=dst.size, n_graphs=1,
                     edge_attr_dim=2, virtual_channels=CHANNELS)
    g = pad_graph(
        spec,
        node_feat=np.concatenate(
            [np.linalg.norm(vel, axis=1, keepdims=True),
             np.ones((n_nodes, 1), np.float32)], axis=1),
        coord=loc, vel=vel, dst=dst, src=src,
        edge_attr=np.concatenate([d0, d0], 1).astype(np.float32),
        coord_target=loc + vel,
    )
    return batch_graphs([g], spec, edge_align=256, device="cpu"), int(dst.size)


def halo_fields(n_shards: int, halo: int, halo_total: int) -> dict:
    """The JAX script's halo accounting: S (``send_idx``'s last axis), the
    real boundary rows over all ordered shard pairs
    (``owner_graph.halo_pair_rows``), and both in kilobytes per layer, the
    padded figure being the ``G·G·S`` rows of the equal blocks."""
    return dict(halo_rows_max_pair=halo, halo_rows_total=halo_total,
                halo_kb_per_layer=round(halo_total * ROW_BYTES / 1024, 1),
                halo_kb_padded=round(n_shards * n_shards * halo * ROW_BYTES / 1024, 1))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cpu",), default=None,
                    help="cpu: run over gloo on the CPU; default: the card, which must be there")
    ap.add_argument("--nodes-per-shard", type=int, default=512)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--devices", type=lambda s: sorted({int(g) for g in s.split(",")}),
                    default=[1, 2, 4, 8], help="world sizes G to sweep, e.g. 1,2,4,8")
    ap.add_argument("--ranks-per-card", type=int, default=1,
                    help="ranks sharing one card over gloo (a harness check, not a "
                         "scaling number); 1: one card per rank over NCCL")
    args = ap.parse_args(argv)
    if args.ranks_per_card < 1 or min(args.devices) < 1:
        ap.error("--ranks-per-card and every G must be at least 1")
    return args


def plan(args: argparse.Namespace, sizes) -> tuple:
    """``(device type, backend)`` of worlds of ``sizes`` ranks: the CPU over
    gloo only with ``--platform cpu``; else the card, one per rank over NCCL
    or ``--ranks-per-card`` ranks per card over gloo.  Raises without a
    card, or when a world needs more cards than there are."""
    if args.platform == "cpu":
        return "cpu", "gloo"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform cpu to run the "
                           "sweep on the CPU")
    cards = torch.cuda.device_count()
    for G in sizes:
        need = -(-G // args.ranks_per_card)
        if need > cards:
            raise ValueError(f"G = {G} at {args.ranks_per_card} rank(s) per card needs {need} "
                             f"cards, this machine has {cards}; --ranks-per-card lets ranks "
                             "share a card (over gloo, as a harness check)")
    return "cuda", "nccl" if args.ranks_per_card == 1 else "gloo"


def make_step(mesh, layers: int, device):
    """``(model, step)``: FastEGNN (H 64, C 3, ``layers``, f32) from seed
    ``INIT_SEED`` and its owner-sharded train step on ``mesh``, torch-style
    Adam (``LR``, ``WEIGHT_DECAY``) and the MSE + MMD loss (``SIGMA``,
    ``MMD_WEIGHT``) on the fused edge kernels."""
    import torch

    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
    from fastegnn_tpu_torch.parallel import make_owner_gp_train_step
    from fastegnn_tpu_torch.train.optim import torch_adam

    model = FastEGNN(2, 2, hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=layers,
                     device=device, generator=torch.Generator().manual_seed(INIT_SEED))
    step = make_owner_gp_train_step(model, torch_adam(model.parameters(), LR, WEIGHT_DECAY),
                                    mesh, sigma=SIGMA, weight=MMD_WEIGHT)
    return model, step


def step_keys(iters: int) -> tuple:
    """``(warm-up key, [timed step i's key])``: host keys in the training
    loop's form, the JAX script's ``key(SEED)`` and ``fold_in(key, i)``."""
    from fastegnn_tpu_torch.train.loop import step_key

    return step_key(SEED, 0, 0, 0), [step_key(SEED, 0, 1, i) for i in range(iters)]


def measure(args: argparse.Namespace) -> None:
    """One world's measurement, under ``torchrun``.  Rank 0 prints the
    launches line and the result line."""
    import torch
    import torch.distributed as dist

    from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm
    from fastegnn_tpu_torch.parallel import (
        halo_pair_rows,
        initialize_distributed,
        make_mesh,
        make_owner_sharded_batch,
    )

    G, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device_type, backend = plan(args, [G])
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) // args.ranks_per_card)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sync = torch.cuda.synchronize
    else:
        device, sync = torch.device("cpu"), (lambda: None)
    if backend == "gloo" and device_type == "cuda":
        dist.init_process_group("gloo", init_method="env://", world_size=G, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    else:
        initialize_distributed(device_type, timeout_s=TIMEOUT_S)
    try:
        mesh = make_mesh((G,), ("graph",), device_type)
        n = args.nodes_per_shard * G
        batch, n_edges = build_batch(n)
        shard = make_owner_sharded_batch(batch, G, shard=rank, device=device)
        _, step = make_step(mesh, args.layers, device)
        warm, keys = step_keys(args.iters)
        float(step(shard, key=warm)["mse"])
        sync()
        dist.barrier()
        ek.FWD_LAUNCHES = ek.BWD_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0
        t0 = time.perf_counter()
        for key in keys:
            m = step(shard, key=key)
        mse = float(m["mse"])
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        launches = {"edge_block_fwd": ek.FWD_LAUNCHES, "edge_block_bwd": ek.BWD_LAUNCHES,
                    "segment_sum": spmm.SEGSUM_LAUNCHES}
        slowest = torch.tensor([dt], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest)
        every = [None] * G
        dist.all_gather_object(every, launches)
        halo = int(shard.send_idx.shape[-1])
    finally:
        dist.destroy_process_group()
    if rank:
        return
    rate = n_edges * args.layers / dt
    print(json.dumps({"metric": "gp_launches_per_rank_step", "devices": G, "steps": args.iters,
                      "ranks": [{k: v / args.iters for k, v in c.items()} for c in every]}),
          flush=True)
    line = dict(metric="gp_weak_scaling", devices=G, nodes=n, edges=n_edges, step_ms=dt * 1e3,
                medges_per_s=rate / 1e6, efficiency=1.0 if G == 1 else None,
                **halo_fields(G, halo, halo_pair_rows(batch, G)), backend=backend,
                ranks_per_card=args.ranks_per_card if device_type == "cuda" else None,
                device=torch.cuda.get_device_name(device) if device_type == "cuda" else "cpu",
                mse=mse)
    print(json.dumps(line), flush=True)


def run_world(G: int, argv, timeout=None) -> list:
    """The JSON lines rank 0 of a ``torchrun`` world of G processes printed."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(G), os.path.abspath(__file__), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"the world of {G} rank(s) failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]


def sweep(argv=None, timeout=None) -> list:
    """Every G of ``--devices`` in its own ``torchrun`` world, in turn:
    prints and returns each world's launches and result lines, the result's
    ``efficiency`` against the G = 1 line (null without one).  ``timeout``
    bounds each world's seconds."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device_type, _ = plan(args, args.devices)
    from fastegnn_tpu_torch.ops import _cuda_build

    # built once here, so that the ranks only load them
    _cuda_build.build(("graphcore",) + (_cuda_build.SOURCES if device_type == "cuda" else ()))
    out, base = [], None
    for G in args.devices:
        lines = run_world(G, argv, timeout)
        result = [s for s in lines if s["metric"] == "gp_weak_scaling"]
        if len(result) != 1:
            raise RuntimeError(f"the world of {G} rank(s) printed {lines}")
        line = result[0]
        if G == 1:
            base = line["medges_per_s"]
        line["efficiency"] = None if base is None else line["medges_per_s"] / (G * base)
        for s in lines:
            print(json.dumps(s), flush=True)
        out += lines
    return out


def main(argv=None) -> int:
    if "WORLD_SIZE" in os.environ:
        measure(parse_args(argv))
    else:
        sweep(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
