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
``FullMLP`` takes an array, not a graph batch.  What the port does not have
raises instead of falling back: a ``--compute_dtype bfloat16`` for a model
without a bf16 path (the JAX CLI drops it quietly), and a ``--mesh`` over
more than one device.
``--platform`` names the port's device: absent means the CUDA card,
``cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch


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
                   help="distributed training mesh; the port runs on one "
                        "device only (data=1,graph=1)")


def parse_mesh(spec):
    """``(data, graph)`` mesh sizes: the port trains on one device, so only
    no mesh or ``data=1,graph=1`` is accepted."""
    if spec not in (None, "data=1,graph=1"):
        raise ValueError(
            f"--mesh {spec}: the port trains on one device; data and graph "
            "parallelism are queued in ROADMAP.md (item 13)")
    return 1, 1


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
    from fastegnn_tpu_torch.models import MMD_MODELS, TRIPLET_MODELS, TripletDataset, get_model
    from fastegnn_tpu_torch.train.loop import train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.utils.seed import fix_seed

    print(f"train/valid/test sizes: {len(dataset_train)}/"
          f"{len(dataset_valid)}/{len(dataset_test)}")
    parse_mesh(args.mesh)
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
    model = get_model(
        args.model, spec.node_feat_dim, spec.edge_attr_dim, hidden=args.dim_hidden,
        virtual_channels=args.virtual_channel, n_layers=args.num_layer,
        num_blocks=args.num_layer,
        attention=args.attention_required,
        normalize=args.direction_vector_normalize_required, tanh=args.tanh_required,
        gravity=gravity, compute_dtype=getattr(torch, args.compute_dtype),
        device=dataset_train.device, generator=fix_seed(args.seed))
    print(f"Number of parameters: {sum(p.numel() for p in model.parameters())}")
    optimizer = torch_adam(model.parameters(), args.learning_rate, args.weight_decay)

    log_name = f"{args.exp_name}_loss_{time.strftime('%Y-%m-%d_%H-%M-%S')}.json"
    best, log, step = train(
        model, optimizer, dataset_train, dataset_valid, dataset_test,
        batch_size=args.batch_size, sigma=args.sigma, weight=args.weight,
        sample=args.sample, per_graph_sampling=per_graph_sampling,
        use_mmd=args.model in MMD_MODELS,
        test_interval=args.test_interval, early_stop=args.early_stop,
        max_epochs=args.max_epochs, seed=args.seed,
        log_directory=args.log_directory, log_name=log_name,
        ckpt_directory=args.ckpt_directory, resume_from=args.resume,
        profile_trace_dir=args.profile_trace)
    print(json.dumps(best, indent=2))
    return Training(best=best, log=log, model=model, optimizer=optimizer, step=step)
