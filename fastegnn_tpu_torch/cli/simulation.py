"""Water-3D training CLI (counterpart of ``fastegnn_tpu/cli/simulation.py``).

Usage:
    python -m fastegnn_tpu_torch.cli.simulation --data_directory DATA \
        --dataset_name Water-3D --virtual_channel 3 ... [--platform cpu]

Defaults are the reference's: sigma 1.0, weight 0.01, batch 20, delta_t 15,
FastEGNN built with gravity [0, -1, 0] and per-graph MMD sampling.  The
datasets are read from ``{data_directory}/{dataset_name}/{split}.h5``,
which needs ``h5py``.
"""

from __future__ import annotations

import argparse

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.cli.common import add_common_args, run_training


def build_parser():
    p = argparse.ArgumentParser(description="FastEGNN (PyTorch / CUDA) Water-3D training")
    add_common_args(p, sigma=1.0, weight=0.01, batch_size=20, cutoff_rate=0.25)
    p.add_argument("--data_directory", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="Water-3D")
    p.add_argument("--delta_t", type=int, default=15)
    p.add_argument("--radius", type=float, default=0.035)
    p.add_argument("--log_directory", type=str, default="./logs/simulation")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)

    from fastegnn_tpu_torch.data.simulation import SimulationDataset

    def split(part, max_samples):
        return SimulationDataset(
            args.data_directory, args.dataset_name, partition=part, device=device,
            virtual_channels=args.virtual_channel, cutoff_rate=args.cutoff_rate,
            max_samples=max_samples, delta_t=args.delta_t, radius=args.radius,
            seed=args.seed)

    run = run_training(args, split("train", args.max_train_samples),
                       split("valid", args.max_test_samples),
                       split("test", args.max_test_samples),
                       per_graph_sampling=True, gravity=(0.0, -1.0, 0.0))
    return run.best


if __name__ == "__main__":
    main()
