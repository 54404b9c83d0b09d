"""N-body training CLI (counterpart of ``fastegnn_tpu/cli/nbody.py``;
reference ``main_nbody.py``).

Usage:
    python -m fastegnn_tpu_torch.cli.nbody --data_directory DATA \
        --dataset_name 100_0_0 --virtual_channel 3 ... [--platform cpu]

Defaults are the reference's (``main_nbody.py:22-68``): sigma 1.5, weight
0.01, batch 100, lr 5e-4, wd 1e-12, H=64, L=4, seed 43, early_stop 100,
test_interval 5, sample 3, cutoff_rate 0.25; FastEGNN without gravity,
one MMD draw shared by the batch's graphs.  The files are the generator's
(``python -m fastegnn_tpu_torch.cli.generate_nbody``).
"""

from __future__ import annotations

import argparse

from fastegnn_tpu_torch.cli.common import add_common_args, run_training, training_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FastEGNN (PyTorch / CUDA) N-body training")
    add_common_args(p, sigma=1.5, weight=0.01, batch_size=100, cutoff_rate=0.25)
    p.add_argument("--data_directory", type=str, required=True)
    p.add_argument("--dataset_name", type=str, required=True)
    p.add_argument("--log_directory", type=str, default="./logs/nbody")
    return p


def datasets(args, device):
    """The train, valid and test splits the CLI trains on."""
    from fastegnn_tpu_torch.data.nbody import NBodyDataset

    def split(part, max_samples):
        return NBodyDataset(args.data_directory, args.dataset_name, partition=part,
                            device=device, virtual_channels=args.virtual_channel,
                            cutoff_rate=args.cutoff_rate, max_samples=max_samples,
                            rotation_seed=args.seed)

    return (split("train", args.max_train_samples), split("valid", args.max_test_samples),
            split("test", args.max_test_samples))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = training_device(args.platform)
    run = run_training(args, *datasets(args, device), per_graph_sampling=False)
    return run.best


if __name__ == "__main__":
    main()
