"""Shared CLI plumbing (counterpart of ``fastegnn_tpu/cli/common.py``).

The flags and their defaults are the JAX package's.  ``--model`` takes the
models of ``models/__init__.py::MODEL_REGISTRY`` that train on a graph
batch; those of ``MMD_MODELS`` train with the MMD loss, the others on the
MSE alone, as in the JAX CLI.  ``--model TFN`` is ``OurDynamics`` at the
JAX CLI's widths (``nf=32``, ``num_degrees=2``; ``--num_layer`` layers).
EGHN needs a dataset with bond edges (the protein CLI's); its cut loss is
not added to the loss.  DimeNet and DimeNet++ train on the splits wrapped
in ``TripletDataset``, whose batches carry their triplet tables, as the JAX
CLI wraps them.  ``--model MLP`` raises, as the JAX CLI fails on it:
``FullMLP`` takes an array, not a graph batch.  ``--compute_dtype
bfloat16`` with a model that has no bf16 path (all but FastEGNN) trains it
in float32, as the JAX CLI does, and prints a line that says so.
``--platform`` names the port's device: absent means the CUDA card,
``cpu`` asks for the CPU.

``--mesh data=D`` trains data-parallel over D processes, one per device,
started by ``torchrun``::

    torchrun --standalone --nproc_per_node D -m fastegnn_tpu_torch.cli.nbody \
        ... --mesh data=D

Each rank takes ``batch_size / D`` graphs of every global batch
(``parallel/data_parallel.py``); evaluation runs the one-process eval step
on whole batches on every rank, as the JAX CLI's does, and the checkpoints
are the one-process ones.

``--mesh graph=G`` and ``--mesh data=D,graph=G`` train FastEGNN
owner-sharded over D x G processes (``parallel/owner_graph.py``): each of
the G processes of a data replica holds 1/G of the replica's node rows and
the edges into them, runs the fused edge kernels on its rows plus the halo
rows one ``all_to_all`` per layer brings it, and sums the per-graph pools
over the replica.  Evaluation runs owner-sharded too, on batches
partitioned once and kept.  The ``--compute_dtype`` default stays
float32 (the JAX CLI's bf16 default for it holds on a TPU only)::

    torchrun --standalone --nproc_per_node 2 -m fastegnn_tpu_torch.cli.nbody \
        ... --mesh graph=2

The mesh raises, before any process group, where the JAX CLI raises
(DimeNet, DimeNet++ and EGHN, whose JAX steps are custom; a batch size that
D does not divide; for G > 1, a model other than FastEGNN and
attention, tanh or normalize), and when the processes are not D x G.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.parallel.mesh import initialize_distributed, local_device, process_rank


def add_common_args(p: argparse.ArgumentParser, *, sigma: float, weight: float,
                    batch_size: int, cutoff_rate: float) -> None:
    p.add_argument("--exp_name", type=str, default="simple-exp")
    p.add_argument("--model", type=str, default="FastEGNN")
    p.add_argument("--dim_hidden", type=int, default=64)
    p.add_argument("--num_layer", type=int, default=4)
    p.add_argument("--attention_required", action="store_true")
    p.add_argument("--direction_vector_normalize_required", action="store_true")
    p.add_argument("--tanh_required", action="store_true")
    p.add_argument("--sigma", type=float, default=sigma)
    p.add_argument("--weight", type=float, default=weight)
    p.add_argument("--max_train_samples", type=int, default=int(1e8))
    p.add_argument("--max_test_samples", type=int, default=int(1e8))
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-12)
    p.add_argument("--early_stop", type=int, default=100)
    p.add_argument("--sample", type=int, default=3)
    p.add_argument("--max_epochs", type=int, default=1_000_000)
    p.add_argument("--ckpt_directory", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume from")
    p.add_argument("--test_interval", type=int, default=5)
    p.add_argument("--cutoff_rate", type=float, default=cutoff_rate)
    p.add_argument("--virtual_channel", type=int, required=True)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--platform", type=str, default=None,
                   help="the device: absent for the CUDA card, 'cpu' for the CPU")
    p.add_argument("--profile_trace", type=str, default=None,
                   help="write a torch.profiler trace of one training epoch "
                        "(the second) to this directory")
    p.add_argument("--mesh", type=str, default=None,
                   help="distributed training mesh, e.g. 'data=2', 'graph=2' or "
                        "'data=2,graph=2': data-parallel over graphs x "
                        "owner-sharded graph parallelism (FastEGNN) within each "
                        "replica, one process per device (torchrun "
                        "--nproc_per_node D*G); global batch semantics match "
                        "one-device training, checkpoints are interchangeable, "
                        "and eval runs under the same mesh")


# the models whose JAX CLI steps are custom (``apply_fn``), which the JAX
# ``--mesh`` refuses (fastegnn_tpu/cli/common.py:178-181)
CUSTOM_STEP_MODELS = ("DimeNet", "DimeNet++", "EGHN")


def parse_mesh(spec):
    """``'data=2,graph=4'`` -> ``(2, 4)``; missing axes default to 1."""
    sizes = {"data": 1, "graph": 1}
    if spec:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in sizes:
                raise ValueError(
                    f"unknown mesh axis {k!r} (have: data, graph)")
            sizes[k] = int(v)
            if sizes[k] < 1:
                raise ValueError(f"mesh axis {k} must be >= 1")
    return sizes["data"], sizes["graph"]


def training_device(platform):
    """The CLI's device: ``resolve_device(platform)``; under ``torchrun`` on
    the card, the rank's own card (``parallel/mesh.py::local_device``), made
    current before the datasets and the model are built on it."""
    return local_device(resolve_device(platform))


def check_mesh(args, device):
    """``(D, G)`` of ``args.mesh``, after the checks that come before any
    process group: what the JAX CLI refuses, and (for D x G > 1) D x G
    processes (``WORLD_SIZE``) on as many devices."""
    mesh_d, mesh_g = parse_mesh(args.mesh)
    n = mesh_d * mesh_g
    if mesh_g > 1:
        if args.model != "FastEGNN":
            raise ValueError(f"--mesh graph={mesh_g} is only supported for FastEGNN "
                             f"(got {args.model}); use --mesh data=D for other models")
        if (args.attention_required or args.tanh_required
                or args.direction_vector_normalize_required):
            raise ValueError("--mesh graph=G supports the paper FastEGNN configuration "
                             "only (no attention/tanh/normalize)")
    if n == 1:
        return 1, 1
    if args.model in CUSTOM_STEP_MODELS:
        raise ValueError(f"--mesh is not supported for {args.model} (custom step)")
    if args.batch_size % mesh_d:
        raise ValueError(f"--batch_size {args.batch_size} must divide by the data "
                         f"axis {mesh_d}")
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != n:
        raise ValueError(
            f"--mesh {args.mesh} trains on {n} processes, one per device "
            f"(WORLD_SIZE is {world}): start it with torchrun --standalone "
            f"--nproc_per_node {n} -m fastegnn_tpu_torch.cli.<name> ... "
            f"--mesh {args.mesh}")
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"--mesh {args.mesh} needs {n} devices, have "
                         f"{torch.cuda.device_count()}")
    return mesh_d, mesh_g


@dataclasses.dataclass
class Training:
    """What :func:`run_training` leaves: the best and per-epoch logs, the
    trained model and optimizer, and the train steps taken."""

    best: dict
    log: dict
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def run_training(args, dataset_train, dataset_valid, dataset_test,
                 per_graph_sampling: bool, gravity=None) -> Training:
    mesh_d, mesh_g = check_mesh(args, dataset_train.device)
    # a group the caller made is the caller's to end
    own_group = mesh_d * mesh_g > 1 and not torch.distributed.is_initialized()
    if own_group:
        initialize_distributed(dataset_train.device.type)
    try:
        return _run_training(args, dataset_train, dataset_valid, dataset_test,
                             per_graph_sampling, gravity, mesh_d, mesh_g)
    finally:
        if own_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run_training(args, dataset_train, dataset_valid, dataset_test, per_graph_sampling,
                  gravity, mesh_d: int, mesh_g: int) -> Training:
    from fastegnn_tpu_torch.models import (
        MMD_MODELS, TRIPLET_MODELS, TripletDataset, computes_in_float32_only, get_model)
    from fastegnn_tpu_torch.train.loop import train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.utils.seed import fix_seed

    # rank 0 alone prints, logs, checkpoints and traces
    main = process_rank() == 0
    say = print if main else (lambda *a, **k: None)
    say(f"train/valid/test sizes: {len(dataset_train)}/"
        f"{len(dataset_valid)}/{len(dataset_test)}")
    spec = dataset_train.spec
    if args.model == "MLP":
        raise ValueError("--model MLP: FullMLP takes an array, not a graph batch, so no "
                         "training CLI can feed it (the JAX CLI fails on it too)")
    if args.model == "EGHN" and spec.max_local_edges == 0:
        raise ValueError("EGHN needs local bond edges: construct the dataset with "
                         "with_local_edges=True")
    if args.model in TRIPLET_MODELS:
        dataset_train, dataset_valid, dataset_test = (
            TripletDataset(d) for d in (dataset_train, dataset_valid, dataset_test))
    compute_dtype = getattr(torch, args.compute_dtype)
    if computes_in_float32_only(args.model, compute_dtype):
        say(f"--compute_dtype {args.compute_dtype}: {args.model} has no {args.compute_dtype} "
            f"path and computes in float32")
    model = get_model(
        args.model, spec.node_feat_dim, spec.edge_attr_dim, hidden=args.dim_hidden,
        virtual_channels=args.virtual_channel, n_layers=args.num_layer,
        num_blocks=args.num_layer,
        attention=args.attention_required,
        normalize=args.direction_vector_normalize_required, tanh=args.tanh_required,
        gravity=gravity, compute_dtype=compute_dtype,
        device=dataset_train.device, generator=fix_seed(args.seed))
    say(f"Number of parameters: {sum(p.numel() for p in model.parameters())}")
    optimizer = torch_adam(model.parameters(), args.learning_rate, args.weight_decay)
    use_mmd = args.model in MMD_MODELS
    dp = {}
    if mesh_g > 1:
        # every rank built the same weights from the seed; train and eval
        # run owner-sharded, the eval batches partitioned once and kept, and
        # the ranks decide on rank 0's eval losses
        from fastegnn_tpu_torch.parallel import (
            OwnerBatchFactory,
            iter_owner_sharded_batches,
            make_dp_agree,
            make_mesh,
            make_owner_gp_eval_step,
            make_owner_gp_train_step,
        )

        mesh = make_mesh((mesh_d, mesh_g), ("data", "graph"), dataset_train.device.type)
        kw = dict(sigma=args.sigma, weight=args.weight, sample=args.sample,
                  per_graph_sampling=per_graph_sampling, use_mmd=use_mmd)
        factory = OwnerBatchFactory(mesh_g)
        eval_cache = {}

        def eval_batch_iter_fn(dataset, batch_size):
            k = (id(dataset), batch_size)
            if k not in eval_cache:
                eval_cache[k] = list(iter_owner_sharded_batches(dataset, batch_size, mesh,
                                                                factory))
            return iter(eval_cache[k])

        dp = dict(
            train_step_fn=make_owner_gp_train_step(model, optimizer, mesh, **kw),
            eval_step_fn=make_owner_gp_eval_step(model, mesh, **kw),
            batch_iter_fn=lambda ds, bs, rng: iter_owner_sharded_batches(
                ds, bs, mesh, factory, rng=rng),
            eval_batch_iter_fn=eval_batch_iter_fn, agree_fn=make_dp_agree(mesh))
        say(f"mesh training: data={mesh_d} x graph={mesh_g} over {mesh_d * mesh_g} processes")
    elif mesh_d > 1:
        # every rank built the same weights from the seed; eval stays the
        # one-process step on whole batches (the loop's default), and the
        # ranks decide on rank 0's eval losses
        from fastegnn_tpu_torch.parallel import (
            iter_dp_batches,
            make_dp_agree,
            make_dp_train_step,
            make_mesh,
        )

        mesh = make_mesh((mesh_d,), ("data",), dataset_train.device.type)
        dp = dict(
            train_step_fn=make_dp_train_step(
                model, optimizer, mesh, sigma=args.sigma, weight=args.weight,
                sample=args.sample, per_graph_sampling=per_graph_sampling, use_mmd=use_mmd),
            batch_iter_fn=lambda ds, bs, rng: iter_dp_batches(ds, bs, mesh, rng=rng),
            agree_fn=make_dp_agree(mesh))
        say(f"mesh training: data={mesh_d} over {mesh_d} processes")

    log_name = f"{args.exp_name}_loss_{time.strftime('%Y-%m-%d_%H-%M-%S')}.json"
    best, log, step = train(
        model, optimizer, dataset_train, dataset_valid, dataset_test,
        batch_size=args.batch_size, sigma=args.sigma, weight=args.weight,
        sample=args.sample, per_graph_sampling=per_graph_sampling,
        use_mmd=use_mmd,
        test_interval=args.test_interval, early_stop=args.early_stop,
        max_epochs=args.max_epochs, seed=args.seed,
        log_directory=args.log_directory if main else None, log_name=log_name,
        ckpt_directory=args.ckpt_directory if main else None, resume_from=args.resume,
        verbose=main, profile_trace_dir=args.profile_trace if main else None, **dp)
    say(json.dumps(best, indent=2))
    return Training(best=best, log=log, model=model, optimizer=optimizer, step=step)
