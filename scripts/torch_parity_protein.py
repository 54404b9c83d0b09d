#!/usr/bin/env python3
"""Converged protein MSE parity of the PyTorch / CUDA port.

The port's side of ``scripts/parity_protein.py --side jax``: :func:`run_port`
is that script's ``run_jax`` on ``fastegnn_tpu_torch``, with its
hyperparameters (``HP``: batch 50, sigma 1.0, weight 0.5, lr 5e-4, wd
1e-12, H 64, C 3, L 4, cutoff 0.0, MMD sample 3, ``delta_frame`` 15, an
eval every 5 epochs, early stop after 100, contact cutoff 10 Angstrom),
FastEGNN without gravity in f32, one MMD draw shared by the batch's graphs,
and ``shuffle=False``.  Its splits are the JAX script's: the synthetic AdK
chain ``data/protein_parity/synthetic_adk.npz`` (60 atoms, 4187 frames,
seed 11; written with the port's generator where it is absent) with
dataset seeds 43 / 44 / 45 for train, valid and test, the test split
randomly rotated and translated.  It writes the reference's ``[best, log]``
JSON, with the run's device, wall seconds and seconds per epoch in
``best``; ``scripts/torch_parity_report.py`` sets the JSONs of seeds 43-47
beside the JAX seeds' (``scripts/parity_protein_jax.py``).

Usage, from the repository root (the card unless ``--platform cpu``)::

    python scripts/torch_parity_protein.py --seed 43 --epochs 150 \\
        --out docs/parity_port/protein_fastegnn_s43.json

Beside ``--out`` the run keeps its live log (``*_live.json``) and the
loop's checkpoint of its last epoch (``*_ckpt/last``); ``--resume`` goes
on from that checkpoint as the uninterrupted run would have.
``scripts/torch_parity_protein_runs.sh`` starts the five seeds together on
one card.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from torch_parity_nbody import draw_steps, paths, write_result  # noqa: E402

NPZ = os.path.join(REPO, "data", "protein_parity", "synthetic_adk.npz")
# scripts/parity_protein.py's HP
HP = dict(sigma=1.0, weight=0.5, batch_size=50, lr=5e-4, wd=1e-12,
          hidden=64, channels=3, layers=4, cutoff=0.0, sample=3,
          delta_frame=15, test_interval=5, early_stop=100,
          n_atoms=60, n_frames=4187, contact_cutoff=10.0)
NPZ_SEED = 11   # the JAX script's make_synthetic_protein_npz seed
SPLIT_SEEDS = dict(train=43, valid=44, test=45)


def ensure_npz(npz: str = NPZ, hp: dict = HP) -> str:
    """``npz``, written with the port's generator where it is absent (the
    JAX script's ``ensure_data``)."""
    from fastegnn_tpu_torch.data.protein import make_synthetic_protein_npz

    if not os.path.exists(npz):
        os.makedirs(os.path.dirname(npz) or ".", exist_ok=True)
        tmp = npz[:-4] + f".tmp{os.getpid()}.npz"
        make_synthetic_protein_npz(tmp, n_atoms=hp["n_atoms"], n_frames=hp["n_frames"],
                                   seed=NPZ_SEED)
        os.replace(tmp, npz)
    return npz


def load_datasets(device, hp: dict = HP, npz: str = NPZ):
    """The train, valid and test splits the JAX harness trains on, and the
    npz's sha256 prefix."""
    from fastegnn_tpu_torch.data.protein import ProteinDataset

    ensure_npz(npz, hp)
    with open(npz, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:16]
    sets = [ProteinDataset(npz, partition=part, device=device,
                           virtual_channels=hp["channels"], cutoff_rate=hp["cutoff"],
                           delta_frame=hp["delta_frame"], contact_cutoff=hp["contact_cutoff"],
                           test_rot=True, test_trans=True, seed=SPLIT_SEEDS[part])
            for part in ("train", "valid", "test")]
    return sets, sha


def run_port(epochs: int, out_json: str, platform=None, seed: int = 43, *, hp: dict = HP,
             npz: str = NPZ, state_dict=None, draw_fn=None, resume: bool = False):
    """Train FastEGNN to early stop or ``epochs`` and write ``[best, log]``
    to ``out_json``; returns them.  ``state_dict``: initial weights in place
    of the seeded init; ``draw_fn(key, graph)``: each step's shared MMD
    draw (a permutation of the graphs' node slots) in place of the one the
    step makes from its key; ``resume``: go on from the run's last
    checkpoint."""
    import torch

    from fastegnn_tpu_torch.cli.common import training_device
    from fastegnn_tpu_torch.models import get_model
    from fastegnn_tpu_torch.train.loop import train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.utils.seed import fix_seed

    device = training_device(platform)
    (dtr, dva, dte), npz_sha = load_datasets(device, hp, npz)
    net = get_model("FastEGNN", dtr.spec.node_feat_dim, dtr.spec.edge_attr_dim,
                    hidden=hp["hidden"], virtual_channels=hp["channels"],
                    n_layers=hp["layers"], compute_dtype=torch.float32, device=device,
                    generator=fix_seed(seed))
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    opt = torch_adam(net.parameters(), hp["lr"], hp["wd"])
    mmd = dict(sigma=hp["sigma"], weight=hp["weight"], sample=hp["sample"],
               per_graph_sampling=False)
    log_dir, log_name, ckpt_dir = paths(out_json)
    last = os.path.join(ckpt_dir, "last")
    if resume and not os.path.exists(last):
        raise FileNotFoundError(f"--resume: no checkpoint {last}")
    best, log, _ = train(
        net, opt, dtr, dva, dte, batch_size=hp["batch_size"], **mmd,
        test_interval=hp["test_interval"], early_stop=hp["early_stop"], max_epochs=epochs,
        seed=seed, shuffle=False, log_directory=log_dir, log_name=log_name,
        ckpt_directory=ckpt_dir, resume_from=last if resume else None, verbose=True,
        **draw_steps(net, opt, mmd, draw_fn))
    return write_result(best, log, out_json, device, max_epochs=epochs, model="FastEGNN",
                        seed=seed, npz_sha256=npz_sha)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--out", type=str, default=None,
                   help="the [best, log] JSON (default logs/parity_port/protein_fastegnn_s<seed>.json)")
    p.add_argument("--platform", type=str, default=None,
                   help="the device: absent for the CUDA card, 'cpu' for the CPU")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--resume", action="store_true",
                   help="go on from the last checkpoint beside --out")
    a = p.parse_args(argv)
    out = a.out or os.path.join(REPO, "logs", "parity_port", f"protein_fastegnn_s{a.seed}.json")
    run_port(a.epochs, out, a.platform, a.seed, resume=a.resume)


if __name__ == "__main__":
    main()
