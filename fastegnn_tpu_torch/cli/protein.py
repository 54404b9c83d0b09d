"""Protein MD training CLI (counterpart of ``fastegnn_tpu/cli/protein.py``;
reference ``main_protein.py``).

Two steps:
    # once, on a host with MDAnalysis(+Data):
    python -m fastegnn_tpu_torch.cli.protein --preprocess --data_directory D --npz adk.npz
    # training (reads the npz only):
    python -m fastegnn_tpu_torch.cli.protein --npz adk.npz --virtual_channel 3 ... \
        [--platform cpu]

Defaults are the reference's (``main_protein.py:26-72``): sigma 1.0, weight
0.5, batch 50, delta_frame 15, backbone selection, the test split randomly
rotated and translated; FastEGNN without gravity, one MMD draw shared by
the batch's graphs.
"""

from __future__ import annotations

import argparse

from fastegnn_tpu_torch.cli.common import add_common_args, run_training, training_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FastEGNN (PyTorch / CUDA) protein MD training")
    add_common_args(p, sigma=1.0, weight=0.5, batch_size=50, cutoff_rate=0.25)
    p.add_argument("--npz", type=str, required=True,
                   help="preprocessed trajectory arrays (see --preprocess)")
    p.add_argument("--preprocess", action="store_true",
                   help="fetch AdK via MDAnalysisData and write --npz")
    p.add_argument("--data_directory", type=str, default="./data")
    p.add_argument("--backbone", action="store_true", default=True)
    p.add_argument("--delta_frame", type=int, default=15)
    p.add_argument("--log_directory", type=str, default="./logs/protein")
    return p


def datasets(args, device):
    """The train, valid and test splits the CLI trains on."""
    from fastegnn_tpu_torch.data.protein import ProteinDataset

    def split(part, max_samples):
        return ProteinDataset(args.npz, partition=part, device=device,
                              virtual_channels=args.virtual_channel,
                              cutoff_rate=args.cutoff_rate, max_samples=max_samples,
                              delta_frame=args.delta_frame, seed=args.seed,
                              with_local_edges=args.model == "EGHN")

    return (split("train", args.max_train_samples), split("valid", args.max_test_samples),
            split("test", args.max_test_samples))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.preprocess:
        from fastegnn_tpu_torch.data.protein import preprocess_adk

        preprocess_adk(args.data_directory, args.npz, backbone=args.backbone)
        print(f"wrote {args.npz}")
        return None
    device = training_device(args.platform)
    run = run_training(args, *datasets(args, device), per_graph_sampling=False)
    return run.best


if __name__ == "__main__":
    main()
